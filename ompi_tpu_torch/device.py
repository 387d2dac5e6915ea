"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``None`` means ``cuda``, and with no CUDA device that is an error, never a
quiet fall back to the CPU.  ``"cpu"`` runs the plain PyTorch versions of
the kernels, which the CPU tests hold against the JAX package.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` only when the caller passes it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ompi_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev


def check_on(tensors, device: torch.device, what: str) -> None:
    """Raise unless every tensor lies on ``device``: nothing is moved
    between devices behind the caller's back."""
    for t in tensors:
        if t.device.type != device.type or (
                device.index is not None and t.device != device):
            raise ValueError(f"{what}: tensor on {t.device}, expected "
                             f"{device}")


__all__ = ["DeviceLike", "resolve_device", "check_on"]
