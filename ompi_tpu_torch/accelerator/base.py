"""Accelerator framework contract.

Re-design of the reference's accelerator framework interface
(opal/mca/accelerator/accelerator.h):
  * ``check_addr`` — buffer-type interrogation (accelerator.h:171): is this
    memory device-resident, and on which device?  The unit is a
    ``torch.Tensor``, not a raw pointer.
  * memcpy (accelerator.h:265) — ``memcpy_d2h`` copies a tensor to a host
    array, ``memcpy_h2d`` a host array onto the device, each blocking; the
    streams, events and chunked asynchronous copies (accelerator.h:184-243)
    wait until something can overlap with them (ROADMAP P7, with shm).
  * IPC handles (accelerator.h:395-481) are absent: device memory moves
    between processes through NCCL collectives (the device plane).

Device-side non-contiguous pack/unpack (the reference packs on host,
opal_convertor.c:245) is an index gather/scatter over a cached
element-index map — see ``TorchAccelerator.pack_device``.

The port's copy of ``ompi_tpu/accelerator/base.py``, less ``DeviceBuffer``:
torch tensors are mutable, so a receive writes into the caller's tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class AddrInfo:
    """Result of check_addr for device-resident memory (accelerator.h:171
    flags + device id out-params)."""

    platform: str                 # "cuda" | "cpu" (torch device type)
    device_ids: List[int]         # device index holding the tensor
    nbytes: int
    dtype: np.dtype
    shape: Tuple[int, ...]
    sharded: bool = False         # True when the array spans >1 device


class AcceleratorModule:
    """Component module contract. ``null`` declines everything (host-only);
    ``torch`` implements the device paths."""

    name = "base"

    # -- interrogation ------------------------------------------------------
    def check_addr(self, buf) -> Optional[AddrInfo]:
        return None

    # -- transfers ----------------------------------------------------------
    def memcpy_d2h(self, arr) -> np.ndarray:
        raise NotImplementedError

    def memcpy_h2d(self, host: np.ndarray, like=None):
        raise NotImplementedError

    # -- datatype staging (pml entry points) --------------------------------
    def stage_out(self, buf, datatype, count) -> bytes:
        """Device buffer → packed host bytes (send side)."""
        raise NotImplementedError

    def stage_in(self, data: bytes, template, datatype, count):
        """Packed host bytes → into the device tensor ``template`` (recv
        side), which is returned; gap bytes of non-contiguous datatypes keep
        the template's values, matching receive semantics on host
        buffers."""
        raise NotImplementedError

