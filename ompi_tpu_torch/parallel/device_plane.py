"""The device plane: one process per rank, wired by ``torch.distributed``.

Counterpart of ``ompi_tpu/parallel/device_plane.py``.  The JAX package
wires ``jax.distributed`` from its own bootstrap control plane; so does the
port: ``init_device_plane(ctx)`` takes the rank and the world size from a
runtime ``Context`` (``runtime.init()``), and rank 0 opens the rendezvous —
a ``torch.distributed`` TCP store on a port the kernel picks — whose
``host:port`` travels to the other ranks through the bootstrap's modex
(``ctx.bootstrap.put``/``get``), as the JAX package sends its coordinator
address.  Without a context, the caller hands over the rank, the world
size and a rendezvous (a store or an ``init_method`` URL), or they come
from the usual ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
environment.

``device=None`` means the card: the NCCL backend, with this process bound
to its card (the launcher's ``--gpus-per-rank`` binding, else its local
rank).  The gloo backend on CPU tensors runs only when the caller passes
``device="cpu"`` or the launcher's ``--device-plane cpu`` asked for it, as
the CPU tests do.  Without CUDA or NCCL, ``device=None`` raises; it never
carries on with gloo by itself.

One process has one ``torch.distributed`` world, so a threaded rank
(``runtime.run_ranks``), which shares its process with its job's other
ranks, cannot join: ``init_device_plane(ctx)`` refuses it, naming the
one-process-per-rank model of ``tpurun``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def _local_rank(rank: int) -> int:
    """This process's card: the first visible one when the launcher bound
    the rank's cards (``CUDA_VISIBLE_DEVICES``), else its local rank."""
    if os.environ.get("OMPI_TPU_BOUND_CARDS"):
        return 0
    for var in ("LOCAL_RANK", "OMPI_TPU_LOCAL_RANK"):
        if var in os.environ:
            index = int(os.environ[var])
            if index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"{var}={index} but this process sees "
                    f"{torch.cuda.device_count()} card(s); bind one card a "
                    f"rank with tpurun --gpus-per-rank 1")
            return index
    return rank % torch.cuda.device_count()


def _ctx_rendezvous(ctx, timeout_s: int):
    """(rank, world size, store) for a runtime Context: world-relative
    identity, and a TCP store that rank 0 opens on a kernel-picked port
    and publishes through the modex.  The process group keeps the store
    (and rank 0's server) alive."""
    if getattr(ctx, "shares_process", False):
        raise RuntimeError(
            "a threaded rank (runtime.run_ranks) shares its process with "
            "its job's other ranks, and torch.distributed has one world a "
            "process: the device plane runs one process per rank (tpurun)")
    members = list(getattr(ctx, "world_ranks", range(ctx.size)))
    pos = members.index(ctx.rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    if pos == 0:
        host = os.environ.get("OMPI_TPU_COORD", "127.0.0.1:0"
                              ).rpartition(":")[0] or "127.0.0.1"
        store = dist.TCPStore(host, 0, ctx.size, True, timeout=timeout,
                              wait_for_workers=False)
        ctx.bootstrap.put("torch_store", f"{host}:{store.port}")
    else:
        addr = str(ctx.bootstrap.get(members[0], "torch_store",
                                     timeout=timeout_s))
        host, _, port = addr.rpartition(":")
        store = dist.TCPStore(host, int(port), ctx.size, False,
                              timeout=timeout)
    return pos, ctx.size, store


def init_device_plane(ctx=None, rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      store: Optional[dist.Store] = None,
                      init_method: Optional[str] = None,
                      device: DeviceLike = None,
                      timeout_s: int = 60) -> torch.device:
    """Join this process to the world and return its device.

    With a runtime ``ctx`` the identity and the rendezvous come from its
    bootstrap (see the module docstring), and ``device=None`` follows the
    launcher's ``--device-plane``.  Without one, ``rank``/``world_size``
    default to ``RANK``/``WORLD_SIZE``; with neither ``store`` nor
    ``init_method`` the rendezvous is ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``).  Idempotent per process, as the
    reference is: a second call joins nothing and returns the device the
    first call chose."""
    if dist.is_initialized():
        return _plane_device()
    if ctx is not None and device is None \
            and os.environ.get("OMPI_TPU_DEVICE_PLANE") == "cpu":
        device = "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("the device plane on CUDA needs the NCCL backend, "
                           "and this torch has none")
    if ctx is not None:
        rank, world_size, store = _ctx_rendezvous(ctx, timeout_s)
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
