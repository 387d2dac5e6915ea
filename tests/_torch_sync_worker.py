"""What the gloo workers of the port's quant, overlap and collective-matmul
tests run.

``_torch_coll_worker.Pool`` runs these by ``"_torch_sync_worker:<name>"``
in every process of its world (each gets the pool's one-axis DeviceComm
first).  Like the pool's own module this imports torch, numpy and the port
only, never JAX: inputs arrive as numpy arrays, results leave as numpy
arrays (bf16 as float32).
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch import op as ops
from ompi_tpu_torch import optim
from ompi_tpu_torch.coll import quant
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.ops import collective_matmul as cm
from ompi_tpu_torch.parallel import overlap
from ompi_tpu_torch.parallel.mesh import make_mesh
from ompi_tpu_torch.spc import Counters

_MESHES = {}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(axes):
    """One mesh per axes dict in each worker: its groups are made once."""
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes))
    return _MESHES[key]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- coll/quant ----------------------------------------------------------------

def quant_call(dc, method, x, dtype="float32", op=None, **kwargs):
    """dc.quant.<method> on this process's rows of the global x (R rows
    over the world): this process's rows of the result."""
    if op is not None:
        kwargs["op"] = getattr(ops, op.upper())
    rows = dc.from_ranks(list(x)).to(_DTYPES[dtype])
    dc.spc = Counters()
    out = getattr(dc.quant, method)(rows, **kwargs)
    return _host(out), dc.spc.get("device_quant_collectives")


def quant_raises(dc, method, x, dtype="float32", op=None):
    kwargs = {} if op is None else {"op": getattr(ops, op.upper())}
    rows = dc.from_ranks(list(x)).to(getattr(torch, dtype))
    try:
        getattr(dc.quant, method)(rows, **kwargs)
    except ValueError as e:
        return str(e)
    return None


def psum_quant(dc, x, avg, block):
    """psum_quant of this process's x[rank] over the pool's axis."""
    t = torch.from_numpy(np.array(x[dc.pos]))
    return _host(quant.psum_quant(t, "x", dc.n, avg=avg, block=block,
                                  mesh=dc.mesh))


# -- the grad-sync modes ---------------------------------------------------------

def _config(cfg_kw):
    kw = dict(cfg_kw)
    kw["dtype"] = _DTYPES[kw.get("dtype", "float32")]
    return tfm.Config(**kw)


def grad_sync(dc, axes, cfg_kw, tree, tokens, force=None):
    """make_value_and_grad on a dp mesh: the loss and this rank's
    gradients (tree_leaves order), and the bucket pvars.  ``force`` sets
    the bucket arm (``coll_nccl_grad_sync_mode``) for this call."""
    from ompi_tpu_torch.core import var
    cfg = _config(cfg_kw)
    mesh = _mesh(axes)
    params = tfm.params_from_numpy(tree, device="cpu")
    if force is not None:
        var.registry.set_override("coll_nccl_grad_sync_mode", force)
    try:
        loss, grads = tfm.make_value_and_grad(cfg, mesh, "cpu")(params,
                                                                tokens)
    finally:
        var.registry.reset_cache()
    return (float(loss), [_host(g) for g in grads],
            {k: overlap.pvar_value(k) for k in ("grad_bucket_count",
                                                "grad_bucket_bytes")})


def train(dc, axes, cfg_kw, tree, batches, learning_rate):
    """make_train_step over ``batches``: the losses, and the parameters
    (gathered over tp when the mesh has it) after the last step."""
    cfg = _config(cfg_kw)
    mesh = _mesh(axes)
    params = tfm.shard_params(tfm.params_from_numpy(tree, device="cpu"),
                              mesh, cfg)
    init_opt, step = tfm.make_train_step(cfg, mesh, learning_rate,
                                         device="cpu")
    state, losses = init_opt(params), []
    for b in batches:
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    full = tfm.gather_params(params, mesh, cfg)
    return losses, [_host(x) for x in optim.tree_leaves(full)]


def refusals(dc, cfg_kw):
    """make_grad_sync's and make_train_step's refusals on layout-only
    meshes (no process group behind them): (type, message) each."""
    from torch.distributed.device_mesh import DeviceMesh

    def layout(shape, names):
        return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
            shape), mesh_dim_names=names, _init_backend=False)

    loss = lambda p, t: 0.0
    cases = {
        "dp_tp": lambda: overlap.make_grad_sync(
            "bucketed", layout((2, 4), ("dp", "tp")), loss),
        "tp_only": lambda: overlap.make_grad_sync(
            "bucketed", layout((8,), ("tp",)), loss),
        "banana": lambda: overlap.make_grad_sync(
            "banana", _mesh({"dp": dc.n}), loss),
        "no_mesh": lambda: tfm.make_train_step(
            tfm.Config(**{**cfg_kw, "dtype": torch.float32,
                          "grad_sync": "bucketed"}), None, device="cpu"),
        "unknown": lambda: tfm.make_train_step(
            tfm.Config(**{**cfg_kw, "dtype": torch.float32,
                          "grad_sync": "nope"}), _mesh({"dp": dc.n}),
            device="cpu"),
        # a two-tier dpo×dp domain: the bucketed sync builds over it, the
        # per-leaf quant sync refuses its dpo axis as the reference does
        "dpo": lambda: overlap.make_grad_sync(
            "bucketed", _mesh({"dpo": 2, "dp": dc.n // 2}), loss),
        "quant_dpo": lambda: tfm.make_train_step(
            tfm.Config(**{**cfg_kw, "dtype": torch.float32,
                          "grad_sync": "quant"}),
            _mesh({"dpo": 2, "dp": dc.n // 2}), device="cpu"),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# -- collective matmuls and the fused layer ------------------------------------

def _block(x, n, pos, dim):
    return np.ascontiguousarray(np.split(x, n, axis=dim)[pos])


def collmm(dc, kind, x, w, bidir=False, reverse=False, cot=None,
           w_cut=True):
    """allgather_matmul (x cut by rows over the pool's axis; w cut by
    columns, the column-parallel layout, unless not ``w_cut``) or
    matmul_reduce_scatter (x and w cut on the contraction): this rank's
    output, and with ``cot`` (the whole output's cotangent) the gradients
    of sum(out · cot) over this rank's block of the output, for this
    rank's x and w blocks."""
    n, pos = dc.n, dc.pos
    if kind == "ag":
        xs, ws = _block(x, n, pos, -2), (_block(w, n, pos, 1) if w_cut
                                         else w)
    else:
        xs, ws = _block(x, n, pos, -1), _block(w, n, pos, 0)
    xs = torch.from_numpy(xs).requires_grad_(cot is not None)
    ws = torch.from_numpy(np.ascontiguousarray(ws)).requires_grad_(
        cot is not None)
    with torch.set_grad_enabled(cot is not None):
        if kind == "ag":
            out = cm.allgather_matmul(xs, ws, "x", dc.mesh, reverse=reverse,
                                      bidirectional=bidir)
        else:
            out = cm.matmul_reduce_scatter(xs, ws, "x", dc.mesh,
                                           bidirectional=bidir)
    if cot is None:
        return _host(out)
    c = _block(cot, n, pos, -1 if kind == "ag" else -2)
    gx, gw = torch.autograd.grad(out, (xs, ws), torch.from_numpy(c))
    return _host(out), _host(gx), _host(gw)


def collmm_raises(dc, kind, x, w):
    n, pos = dc.n, dc.pos
    xs = torch.from_numpy(_block(x, n, pos, -2 if kind == "ag" else -1))
    ws = torch.from_numpy(np.ascontiguousarray(
        w if kind == "ag" else _block(w, n, pos, 0)))
    fn = cm.allgather_matmul if kind == "ag" else cm.matmul_reduce_scatter
    try:
        fn(xs, ws, "x", dc.mesh, bidirectional=True)
    except ValueError as e:
        return str(e)
    return None


def fused_value_and_grad(dc, axes, cfg_kw, tree, tokens):
    """The mesh loss and the gathered gradients (tree_leaves order)."""
    cfg = _config(cfg_kw)
    mesh = _mesh(axes)
    shards = tfm.shard_params(tfm.params_from_numpy(tree, device="cpu"),
                              mesh, cfg)
    loss, grads = tfm.value_and_grad(shards, tokens, cfg, device="cpu",
                                     mesh=mesh)
    of = dict(zip(map(id, optim.tree_leaves(shards)), grads))
    full = tfm.gather_params(optim.tree_map(lambda p: of[id(p)], shards),
                             mesh, cfg)
    return float(loss), [_host(g) for g in optim.tree_leaves(full)]
