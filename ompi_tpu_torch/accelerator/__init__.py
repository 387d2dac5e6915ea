"""Accelerator framework: device-memory interrogation + staging contract.

≙ the reference's ``accelerator`` MCA framework (opal/mca/accelerator/
accelerator.h:171-557) with components cuda/rocm/ze/null; here the components
are ``torch`` (CUDA tensors, torchacc.py) and ``null`` (host-only).
Selection is the standard priority query through the component registry —
``torch`` wins; ``--mca accelerator null`` forces the host-only path exactly
like ``--mca accelerator null`` does in the reference.

Consumers (pml, coll/nccl) call :func:`current` / :func:`check_addr` instead
of type-sniffing tensors at the call site.

The port's copy of ``ompi_tpu/accelerator/__init__.py``.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..core.component import Component, component, frameworks
from .base import AcceleratorModule, AddrInfo

__all__ = ["AcceleratorModule", "AddrInfo", "current", "check_addr"]


class NullAccelerator(AcceleratorModule):
    """Host-only module (≙ accelerator/null): check_addr always says host."""

    name = "null"

    def check_addr(self, buf) -> Optional[AddrInfo]:
        return None


@component("accelerator", "null", priority=1)
class NullComponent(Component):
    def query(self, scope):
        return self.priority, NullAccelerator()


@component("accelerator", "torch", priority=50)
class TorchComponent(Component):
    def query(self, scope):
        from .torchacc import TorchAccelerator

        return self.priority, TorchAccelerator()


_lock = threading.Lock()
_current: Optional[AcceleratorModule] = None


def current() -> AcceleratorModule:
    """The selected accelerator module (process-wide, selected once)."""
    global _current
    if _current is None:
        with _lock:
            if _current is None:
                try:
                    _, mod = frameworks.framework("accelerator").select(None)
                except RuntimeError:
                    mod = NullAccelerator()
                _current = mod
    return _current


def check_addr(buf) -> Optional[AddrInfo]:
    # Fast path: only a tensor can be device-resident; numpy buffers and
    # the rest never reach the module (the reference's check_addr is
    # likewise a cheap pointer interrogation, accelerator.h:171).
    if not isinstance(buf, torch.Tensor):
        return None
    return current().check_addr(buf)
