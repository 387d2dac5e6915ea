"""What the gloo workers of the port's mesh tests run (the dense and the
MoE mesh step).

``_torch_coll_worker.Pool`` runs these by ``"_torch_mesh_worker:<name>"``
in every process of its world; each function builds (once) the named mesh
over that world and works on this process's shard.  Like the pool's own
module it imports torch, numpy and the port only, never JAX: the inputs
arrive as numpy arrays and the results leave as numpy arrays (bf16 as
float32).
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch import optim
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel.mesh import axis_rank, axis_size, make_mesh
from ompi_tpu_torch.parallel.ring import ring_attention

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


def _block(x: np.ndarray, mesh, dims) -> np.ndarray:
    """This process's block of x: dim i cut over the axis dims[i] names."""
    for dim, axis in enumerate(dims):
        if axis is None or axis not in mesh.mesh_dim_names:
            continue
        n = axis_size(mesh, axis)
        x = np.split(x, n, axis=dim)[axis_rank(mesh, axis)]
    return x


def coords(dc, axes):
    mesh = _mesh(axes)
    return {a: axis_rank(mesh, a) for a in mesh.mesh_dim_names}


def ring(dc, axes, q, k, v, causal, block_impl="jnp", dtype="float32",
         cot=None, batch_axis=None):
    """ring_attention on this process's (b, s, h, d) block of the whole
    q, k, v (batch over ``batch_axis``, sequence over sp); with ``cot``,
    also the gradients of sum(out · cot) for this block's q, k and v."""
    mesh = _mesh(axes)
    dims = (batch_axis, "sp")
    t = lambda x: torch.from_numpy(_block(x, mesh, dims).copy()).to(
        _DTYPES[dtype])
    qs, ks, vs = (t(x).requires_grad_(cot is not None) for x in (q, k, v))
    with torch.set_grad_enabled(cot is not None):
        out = ring_attention(qs, ks, vs, mesh, "sp", causal=causal,
                             batch_axis=batch_axis, block_impl=block_impl)
    if cot is None:
        return _host(out)
    grads = torch.autograd.grad(out, (qs, ks, vs), t(cot))
    return [_host(out)] + [_host(g) for g in grads]


def ring_pallas_grad_refused(dc, axes, q):
    mesh = _mesh(axes)
    qs = torch.from_numpy(_block(q, mesh, (None, "sp")).copy())
    qs.requires_grad_(True)
    try:
        ring_attention(qs, qs, qs, mesh, "sp", block_impl="pallas")
    except RuntimeError as e:
        return str(e)
    return None


def _config(cfg_kw):
    kw = dict(cfg_kw)
    kw["dtype"] = _DTYPES[kw.get("dtype", "float32")]
    return tfm.Config(**kw)


def _unflatten(params, leaves):
    """A tree shaped like ``params`` from leaves in ``tree_leaves`` order
    (dict keys sorted)."""
    it = iter(leaves)

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for key in sorted(tree):
                out[key] = walk(tree[key])
            return out
        if isinstance(tree, list):
            return [walk(x) for x in tree]
        return next(it)

    return walk(params)


def _leaves(tree):
    return [_host(x) for x in optim.tree_leaves(tree)]


def _shards(axes, cfg, tree):
    mesh = _mesh(axes)
    full = tfm.params_from_numpy(tree, device="cpu")
    return mesh, full, tfm.shard_params(full, mesh, cfg)


def shard_roundtrip(dc, axes, cfg_kw, tree):
    """shard_params then gather_params: whether every leaf comes back
    bitwise, and this rank's wqkv shard of layer 0 with its tp rank."""
    cfg = _config(cfg_kw)
    mesh, full, shards = _shards(axes, cfg, tree)
    back = tfm.gather_params(shards, mesh, cfg)
    same = all(torch.equal(a, b) for a, b in zip(
        optim.tree_leaves(full), optim.tree_leaves(back)))
    return (same, axis_rank(mesh, "tp"),
            _host(shards["layers"][0]["wqkv"]),
            [tuple(x.shape) for x in optim.tree_leaves(shards)])


def value_and_grad(dc, axes, cfg_kw, tree, tokens):
    """The mesh loss and the gathered gradients, in tree_leaves order."""
    cfg = _config(cfg_kw)
    mesh, _, shards = _shards(axes, cfg, tree)
    loss, grads = tfm.value_and_grad(shards, tokens, cfg, device="cpu",
                                     mesh=mesh)
    full = tfm.gather_params(_unflatten(shards, grads), mesh, cfg)
    return float(loss), _leaves(full)


def train(dc, axes, cfg_kw, tree, batches, learning_rate):
    """make_train_step on the mesh over ``batches``: the losses, and the
    gathered parameters after the last step."""
    cfg = _config(cfg_kw)
    mesh, _, params = _shards(axes, cfg, tree)
    init_opt, step = tfm.make_train_step(cfg, mesh, learning_rate,
                                         device="cpu")
    state, losses = init_opt(params), []
    for b in batches:
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return losses, _leaves(tfm.gather_params(params, mesh, cfg))


# -- the MoE mesh step (models/moe.moe_block_mesh) ----------------------------

def moe_roundtrip(dc, axes, cfg_kw, tree):
    """shard_params then gather_params on a MoE tree: whether every leaf
    comes back bitwise, this rank's mesh coordinates and its layer-0
    expert shards (w_gate, w_down)."""
    cfg = _config(cfg_kw)
    mesh, full, shards = _shards(axes, cfg, tree)
    back = tfm.gather_params(shards, mesh, cfg)
    same = all(torch.equal(a, b) for a, b in zip(
        optim.tree_leaves(full), optim.tree_leaves(back)))
    moe = shards["layers"][0]["moe"]
    return (same, coords(dc, axes), _host(moe["w_gate"]),
            _host(moe["w_down"]))


def _local_ids(expert_idx, plan):
    """A planted fault: the routing over this rank's own tokens (its ids
    alone, so the capacity and the positions are taken over them)."""
    k = expert_idx.shape[-1]
    return expert_idx.reshape(-1, k), torch.arange(expert_idx[..., 0].numel())


def moe_value_and_grad(dc, axes, cfg_kw, tree, tokens, fault=None):
    """The MoE mesh loss and gathered gradients (tree_leaves order), this
    rank's own router gradient of each layer (the router is replicated:
    every rank holds the whole), its coordinates and the expert ids each
    layer routed this rank's (b, s) tokens to.  ``fault="local_capacity"``
    plants the routing over the rank's own tokens."""
    from ompi_tpu_torch.models import moe as moe_mod
    cfg = _config(cfg_kw)
    mesh, _, shards = _shards(axes, cfg, tree)
    ids, real, real_ids = [], moe_mod._route, moe_mod._global_ids

    def rec(probs, top_k):
        gate_vals, expert_idx = real(probs, top_k)
        ids.append(expert_idx.clone())
        return gate_vals, expert_idx

    moe_mod._route = rec
    if fault == "local_capacity":
        moe_mod._global_ids = _local_ids
    try:
        loss, grads = tfm.value_and_grad(shards, tokens, cfg, device="cpu",
                                         mesh=mesh)
    finally:
        moe_mod._route, moe_mod._global_ids = real, real_ids
    local = _unflatten(shards, grads)
    full = tfm.gather_params(local, mesh, cfg)
    return (float(loss), _leaves(full),
            [_host(layer["moe"]["router"]) for layer in local["layers"]],
            coords(dc, axes), [i.numpy() for i in ids])


def moe_mesh_refused(dc, axes, cfg_kw):
    """The error the MoE mesh step raises on ``axes``: (type, message)."""
    cfg = _config(cfg_kw)
    try:
        tfm.make_train_step(cfg, _mesh(axes), device="cpu")
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None
