"""Gloo worlds for the port's device-collective tests.

``Pool(world)`` spawns ``world`` processes that join one gloo world through
the port's ``init_device_plane(device="cpu")`` and build a
``DeviceComm`` over a one-axis mesh; ``pool.run(name, ...)`` runs the
function ``name`` of this module, or ``"module:function"`` of another
test helper module, in every process (each gets the comm as its first
argument) and returns their results in rank order.  The module
imports torch, numpy and the port only, so the spawned children never
load JAX; the pytest process that drives them has it loaded, so they are
started with ``spawn``, never ``fork``.
"""

from __future__ import annotations

import importlib
import os
import shutil
import tempfile
import traceback
import warnings

import numpy as np
import torch

from ompi_tpu_torch import op as ops
from ompi_tpu_torch import topo as topos
from ompi_tpu_torch.parallel.collectives import DeviceComm


class WorkerError(RuntimeError):
    pass


def _serve(rank: int, world: int, init_method: str, conn) -> None:
    # torch 2.13 names all_gather_into_tensor deprecated; the port keeps
    # the name the card's torch has
    warnings.filterwarnings("ignore", category=FutureWarning)
    warnings.filterwarnings("ignore", category=UserWarning)
    torch.set_num_threads(1)
    from ompi_tpu_torch.parallel.device_plane import init_device_plane
    from ompi_tpu_torch.parallel.mesh import make_mesh
    init_device_plane(rank=rank, world_size=world, init_method=init_method,
                      device="cpu")
    dc = DeviceComm(make_mesh({"x": world}), "x")
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            conn.send(("ok", _function(name)(dc, *args, **kwargs)))
        except Exception:                     # reported to the parent
            conn.send(("err", traceback.format_exc()))
    torch.distributed.destroy_process_group()


def _function(name: str):
    if ":" not in name:
        return globals()[name]
    module, attr = name.split(":")
    return getattr(importlib.import_module(module), attr)


class Pool:
    """``world`` gloo processes, reused across the tests of a module."""

    def __init__(self, world: int, timeout: float = 120.0) -> None:
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.timeout = timeout
        self._tmp = tempfile.mkdtemp(prefix="torch_coll_")
        init = "file://" + os.path.join(self._tmp, "store")
        self._conns, self._procs = [], []
        for rank in range(world):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(rank, world, init, there),
                            daemon=True)
            p.start()
            self._conns.append(here)
            self._procs.append(p)

    def run(self, name: str, *args, **kwargs) -> list:
        for c in self._conns:
            c.send((name, args, kwargs))
        out, errs = [], []
        for rank, c in enumerate(self._conns):
            if not c.poll(self.timeout):
                self.close()
                raise TimeoutError(f"rank {rank} gave no answer to {name} "
                                   f"in {self.timeout} s")
            status, val = c.recv()
            (out if status == "ok" else errs).append(val)
        if errs:
            raise WorkerError(errs[0])
        return out

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        shutil.rmtree(self._tmp, ignore_errors=True)


# -- what the workers run ----------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rows(dc, x, dtype=None):
    t = dc.from_ranks(list(x))
    return t.to(getattr(torch, dtype)) if dtype else t


class _Lists:
    """A directed topology from explicit in- and out-neighbour lists."""

    def __init__(self, ins, outs):
        self.ins, self.outs, self.size = ins, outs, len(ins)

    def in_neighbors(self, rank):
        return self.ins[rank]

    def out_neighbors(self, rank):
        return self.outs[rank]


def _topo(spec):
    kind, a, b = spec
    return {"cart": topos.CartTopo, "graph": topos.GraphTopo,
            "lists": _Lists}[kind](a, b)


def call(dc, method, x, *args, dtype=None, op=None, topo=None, **kwargs):
    """dc.<method>(this process's rows of the global x, *args): the
    process's rows of the result as numpy (bf16 as float32), and the
    second element when the method returns a pair."""
    if op is not None:
        kwargs["op"] = getattr(ops, op.upper())
    if topo is not None:
        args = (_topo(topo),) + args
    out = getattr(dc, method)(_rows(dc, x, dtype), *args, **kwargs)
    if isinstance(out, tuple):
        return _host(out[0]), out[1]
    return _host(out)


def call_ragged(dc, method, arrays, *args, **kwargs):
    """pad_ragged(arrays), then dc.<method>(padded, counts, *args): the
    counts pad_ragged reports, the local padded rows and the result's."""
    x, counts = dc.pad_ragged(arrays)
    out = getattr(dc, method)(x, counts, *args, **kwargs)
    return counts, _host(x), _host(out)


def call_user_op(dc, method, x, **kwargs):
    """dc.<method> with a user op NCCL has no reduction for: a + b + 1
    (associative, as MPI requires of an op: the rows fold per process,
    then across processes)."""
    op = ops.Op.create(lambda a, b: a + b + 1, name="sum_plus_one")
    return _host(getattr(dc, method)(_rows(dc, x), op=op, **kwargs))


def host_views(dc, method, x, *args):
    """to_ranks / unpad_ragged / dedup_to_ranks: every rank's host buffer,
    as this process sees them."""
    if method == "to_ranks":
        got = dc.to_ranks(_rows(dc, x))
    elif method == "unpad_ragged":
        got = dc.unpad_ragged(*dc.pad_ragged(x))
    else:
        got = dc.dedup_to_ranks(dc.allgather_dedup(_rows(dc, x)), *args)
    return [_host(g) for g in got]


def canonical(dc, full, dim):
    """dc.canonicalize of this process's shard of ``full`` on ``dim``."""
    shard = np.split(np.asarray(full), dc.n, axis=dim)[dc.pos]
    return _host(dc.canonicalize(torch.from_numpy(shard.copy()), dim))


def cache_entries(dc, method, x, counts_list):
    """Index-map cache entries after each call of dc.<method> over a list
    of counts patterns."""
    seen = []
    for C in counts_list:
        getattr(dc, method)(_rows(dc, x), C)
        seen.append(dc.cache_info()["entries"])
    return seen


def a2av_plan(dc, shape, C, slice_cap=None):
    return dc.a2av_plan(shape, C, slice_cap)


def barrier(dc):
    dc.barrier()
    return dc.pos


def raises(dc, method, x, *args, topo=None, **kwargs):
    """The exception type and message dc.<method> raises, or None."""
    if topo is not None:
        args = (_topo(topo),) + args
    try:
        getattr(dc, method)(_rows(dc, x), *args, **kwargs)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def primitive(dc, name, x, *args, **kwargs):
    """A named-axis primitive on this process's x[rank], over the comm's
    axis of its mesh."""
    from ompi_tpu_torch.parallel import collectives as coll
    if "op" in kwargs:
        kwargs["op"] = getattr(ops, kwargs["op"].upper())
    t = torch.as_tensor(np.array(x[dc.pos]))
    return _host(getattr(coll, name)(t, "x", *args, mesh=dc.mesh, **kwargs))


def classify(dc, axes, sim=""):
    """classify_axes of a mesh of ``axes``, with ``sim`` as the simulated
    DCN axes."""
    from ompi_tpu_torch.parallel.mesh import (SIM_DCN_ENV, classify_axes,
                                              make_mesh)
    os.environ[SIM_DCN_ENV] = sim
    try:
        return classify_axes(make_mesh(axes))
    finally:
        del os.environ[SIM_DCN_ENV]


def mesh_errors(dc, axes):
    from ompi_tpu_torch.parallel.mesh import make_mesh
    try:
        m = make_mesh(axes)
    except ValueError as e:
        return "ValueError", str(e)
    return "ok", dict(zip(m.mesh_dim_names, m.mesh.shape))


def plane(dc):
    """A second init_device_plane call joins nothing: the same world."""
    from ompi_tpu_torch.parallel.device_plane import (device_plane_active,
                                                      init_device_plane)
    dev = init_device_plane(rank=99, world_size=99, device="cpu")
    return (str(dev), device_plane_active(),
            torch.distributed.get_world_size())
