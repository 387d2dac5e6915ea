"""The device plane: one process per rank, wired by ``torch.distributed``.

Counterpart of ``ompi_tpu/parallel/device_plane.py``.  The JAX package
wires ``jax.distributed`` from its own bootstrap control plane; the port
has no bootstrap plane yet (ROADMAP P7), so ``init_device_plane`` takes the
rank, the world size and a rendezvous (a ``torch.distributed`` store or an
``init_method`` URL) from its caller, or reads them from the usual
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment.

``device=None`` means the card: the NCCL backend, with this process bound
to its local GPU.  The gloo backend on CPU tensors runs only when the
caller passes ``device="cpu"``, as the CPU tests do.  Without CUDA or
NCCL, ``device=None`` raises; it never carries on with gloo by itself.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def init_device_plane(rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      store: Optional[dist.Store] = None,
                      init_method: Optional[str] = None,
                      device: DeviceLike = None,
                      timeout_s: int = 60) -> torch.device:
    """Join this process to the world and return its device.

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE``; with neither
    ``store`` nor ``init_method`` the rendezvous is ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``).  Idempotent per process, as the
    reference is: a second call joins nothing and returns the device the
    first call chose."""
    if dist.is_initialized():
        return _plane_device()
    dev = resolve_device(device)
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("the device plane on CUDA needs the NCCL backend, "
                           "and this torch has none")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    kwargs = {"rank": rank, "world_size": world_size,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if dev.type == "cuda":
        dev = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(dev)
        # device_id binds the communicator to this card and creates it now,
        # so a first point-to-point batch needs no warm-up collective
        dist.init_process_group("nccl", device_id=dev, **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)
    return dev


def _plane_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_plane_active() -> bool:
    return dist.is_initialized()


__all__ = ["init_device_plane", "device_plane_active"]
