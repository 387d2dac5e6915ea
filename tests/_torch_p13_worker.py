"""What the gloo workers of the port's hierarchy, Ulysses, pipeline and
two-tier grad-sync tests run.

``_torch_coll_worker.Pool`` runs these by ``"_torch_p13_worker:<name>"``
in every process of its world (each gets the pool's one-axis DeviceComm
first, unused here).  Each function builds (once) the named mesh over the
world and works on this process's part.  Like the pool's own module it
imports torch, numpy and the port only, never JAX: inputs arrive as numpy
arrays, results leave as numpy arrays (bf16 as float32).  ``sim`` names
the axes the simulated-DCN override (``OMPI_TPU_topo_sim_dcn_axes``)
classifies as slow for the call.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import _torch_coll_worker as W
from ompi_tpu_torch import op as ops
from ompi_tpu_torch import optim
from ompi_tpu_torch.coll.nccl import NcclModule
from ompi_tpu_torch.core import var
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.ops.attention import flash_mha
from ompi_tpu_torch.parallel import hierarchy, simdcn
from ompi_tpu_torch.parallel.collectives import DeviceComm
from ompi_tpu_torch.parallel.mesh import (SIM_DCN_ENV, axis_rank,
                                          classify_axes, make_mesh)
from ompi_tpu_torch.parallel.pipeline import (pipeline, shard_stage_params,
                                              stack_stage_params)
from ompi_tpu_torch.parallel.ulysses import ulysses_attention
from ompi_tpu_torch.spc import Counters

_MESHES, _COMMS = {}, {}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(axes):
    """One mesh per axes dict in each worker: its groups are made once."""
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes))
    return _MESHES[key]


def _sim(sim):
    if sim:
        os.environ[SIM_DCN_ENV] = sim
    else:
        os.environ.pop(SIM_DCN_ENV, None)
    simdcn.clear_cache()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pos(mesh, axes):
    return tuple(axis_rank(mesh, a) for a in axes)


# -- classification and the hierarchical psum ---------------------------------

def levels(dc, axes, sim, comm_axes):
    """classify_axes (whole mesh and the comm's own axes), hier_axes and
    auto_levels under the override ``sim``."""
    mesh = _mesh(axes)
    _sim(sim)
    try:
        return {"classify": classify_axes(mesh),
                "own": classify_axes(mesh, comm_axes),
                "hier_axes": list(hierarchy.hier_axes(mesh, comm_axes)),
                "auto_levels": list(hierarchy.auto_levels(mesh))}
    finally:
        _sim(None)


def hier_psum(dc, axes, x, quant=False, block=None, dtype="float32"):
    """hierarchical_allreduce (or hierarchical_psum_quant of the flat
    buffer) of this rank's row x[outer, inner] over the mesh's "inner" and
    "outer" axes."""
    mesh = _mesh(axes)
    t = torch.from_numpy(np.array(x[_pos(mesh, ("outer", "inner"))]))
    t = t.to(_DTYPES[dtype])
    if quant:
        n_outer = dict(axes)["outer"]
        out = hierarchy.hierarchical_psum_quant(
            t.reshape(-1), "inner", "outer", n_outer, block=block,
            mesh=mesh).reshape(t.shape)
    else:
        out = hierarchy.hierarchical_allreduce(t, mesh, "inner", "outer")
    return _host(out)


def _dc(axes, comm_axes):
    key = (tuple(axes.items()), tuple(comm_axes))
    if key not in _COMMS:
        _COMMS[key] = DeviceComm(_mesh(axes), tuple(comm_axes))
    return _COMMS[key]


def comm_call(dc, axes, comm_axes, method, x, *args, **kwargs):
    """A tuple-axis DeviceComm's ``method`` on this process's rows of the
    global x (``_torch_coll_worker.call``), and the comm's n and pos."""
    tdc = _dc(axes, comm_axes)
    return W.call(tdc, method, x, *args, **kwargs), tdc.n, tdc.pos


def comm_refusals(dc, axes):
    """DeviceComm's refusals of tuples: one out of the mesh's order, one
    naming an axis the mesh lacks, a cart exchange on a tuple."""
    from ompi_tpu_torch import topo as topos
    mesh = _mesh(axes)
    names = list(axes)
    out = {}
    for name, fn in {
            "reversed": lambda: DeviceComm(mesh, tuple(reversed(names))),
            "unknown": lambda: DeviceComm(mesh, (names[0], "zz")),
            "cart": lambda: _dc(axes, names).neighbor_allgather_cart(
                torch.zeros(1, 2), topos.CartTopo([dc.n], [True]))}.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


class _Ctx:
    def __init__(self):
        self.spc = Counters()


class _FakeComm:
    """Just enough communicator for coll/nccl's module, as attach_mesh
    leaves one: the tuple-axis DeviceComm, its axes' classification and
    plane, and a context with counters."""

    def __init__(self, tdc, kinds):
        self.device_comm, self.device_kinds = tdc, kinds
        self.device_plane = "dcn" if "dcn" in kinds.values() else "ici"
        self.ctx = _Ctx()
        self.size, self.rank, self.name = tdc.n, tdc.pos, "p13"


def nccl_allreduce(dc, axes, sim, comm_axes, x, force=None, op="sum",
                   dtype="float32", rules=None, us_per_mib=0.0):
    """coll/nccl's allreduce on this process's rows of x over a comm on
    ``comm_axes``: (rows out, the module's hier levels and plane, the arm
    counts and wire bytes it audited, the bytes it charged the simulated
    DCN), or the refusal's (type, message)."""
    mesh = _mesh(axes)
    _sim(sim)
    charged = []
    real_charge = simdcn.charge
    simdcn.charge = lambda nbytes: charged.append(int(nbytes))
    try:
        if force:
            var.registry.set_override("coll_nccl_allreduce_mode", force)
        if rules:
            var.registry.set_override("coll_nccl_dynamic_rules", rules)
        if us_per_mib:
            var.registry.set_override("topo_sim_dcn_us_per_mib",
                                      float(us_per_mib))
        tdc = DeviceComm(mesh, tuple(comm_axes)) if len(comm_axes) > 1 \
            else DeviceComm(mesh, comm_axes[0])
        comm = _FakeComm(tdc, classify_axes(mesh, tuple(comm_axes)))
        mod = NcclModule(comm)
        rows = tdc.from_ranks(list(x)).to(_DTYPES[dtype])
        try:
            out = mod.allreduce(comm, rows, op=getattr(ops, op.upper()))
        except ValueError as e:
            return ("ValueError", str(e))
        spc = comm.ctx.spc
        return (_host(out), [mod._hier_inner, mod._hier_outer, mod._plane],
                {k: spc.get(k) for k in (
                    "coll_arm_native_count", "coll_arm_quant_count",
                    "coll_arm_hier_count", "coll_arm_hier+quant_count",
                    "coll_wire_bytes")}, charged)
    finally:
        simdcn.charge = real_charge
        var.registry.reset_cache()            # drops the overrides
        _sim(None)


# -- Ulysses ------------------------------------------------------------------

def ulysses(dc, axes, q, k, v, causal, cot=None, flash=False,
            dtype="float32"):
    """ulysses_attention on this process's (b, s/n, h, d) sequence shard
    of q, k, v (sequence cut over "sp"; ``flash``: flash_mha as the
    attention); with ``cot``, also the gradients of sum(out · cot) of its
    shards."""
    mesh = _mesh(axes)
    n, i = mesh.mesh.shape[mesh.mesh_dim_names.index("sp")], \
        axis_rank(mesh, "sp")

    def shard(x):
        x = np.split(x, n, axis=1)[i]
        return torch.from_numpy(np.ascontiguousarray(x)).to(_DTYPES[dtype])

    qs, ks, vs = (shard(t).requires_grad_(cot is not None)
                  for t in (q, k, v))
    attn_fn = None
    if flash:
        attn_fn = lambda a, b, c: flash_mha(a, b, c, causal)
    with torch.set_grad_enabled(cot is not None):
        out = ulysses_attention(qs, ks, vs, mesh, "sp", causal=causal,
                                attn_fn=attn_fn)
    if cot is None:
        return _host(out)
    grads = torch.autograd.grad(out, (qs, ks, vs), shard(cot))
    return [_host(out)] + [_host(g) for g in grads]


def ulysses_bad_heads(dc, axes, q):
    mesh = _mesh(axes)
    t = torch.from_numpy(q)
    try:
        ulysses_attention(t, t, t, mesh, "sp")
    except ValueError as e:
        return str(e)
    return None


# -- the pipeline -------------------------------------------------------------

def _toy_stage(stage_params, x):
    """tests/test_pipeline_moe.py's toy stage: tanh(x @ w + b) per layer."""
    for w, b in zip(stage_params["w"], stage_params["b"]):
        x = torch.tanh(x @ w + b)
    return x


def pipe(dc, axes, layers, mbs, cot, checkpoint=True):
    """pipeline of the toy stage over "pp": the outputs, the loss
    sum(out · cot) and this stage's parameter and input gradients."""
    mesh = _mesh(axes)
    n = mesh.mesh.shape[mesh.mesh_dim_names.index("pp")]
    tree = [{k: torch.from_numpy(v) for k, v in lay.items()}
            for lay in layers]
    mine = shard_stage_params(stack_stage_params(tree, n), mesh, "pp")
    leaves = [mine["w"], mine["b"]]
    for p in leaves:
        p.requires_grad_(True)
    x = torch.from_numpy(mbs).requires_grad_(True)
    out = pipeline(_toy_stage, mine, x, mesh, "pp", checkpoint=checkpoint)
    loss = (out * torch.from_numpy(cot)).sum()
    # only stage 0 reads the microbatches
    gw, gb, gx = torch.autograd.grad(loss, leaves + [x], allow_unused=True)
    gx = torch.zeros_like(x) if gx is None else gx
    return (_host(out), float(loss), axis_rank(mesh, "pp"), _host(gw),
            _host(gb), _host(gx))


def pipe_bad_split(dc, n_layers, n_stages):
    try:
        stack_stage_params([{"w": torch.zeros(2)}] * n_layers, n_stages)
    except ValueError as e:
        return str(e)
    return None


# -- the flagship's mesh step and the two-tier grad sync ----------------------

def grad_sync(dc, axes, sim, cfg_kw, tree, tokens, force=None, rules=None):
    """make_value_and_grad on a dpo×dp mesh under the override ``sim``
    (``force``: the bucket arm; ``rules``: a rules file): the loss, this
    rank's gradients (tree_leaves order), and the arms its buckets took;
    or the refusal's (type, message)."""
    from ompi_tpu_torch.parallel import overlap
    cfg = tfm.Config(**{**cfg_kw, "dtype": _DTYPES[cfg_kw["dtype"]]})
    mesh = _mesh(axes)
    _sim(sim)
    params = tfm.params_from_numpy(tree, device="cpu")
    arms = []
    real = overlap._decide_buckets

    def spy(*args, **kwargs):
        arms.extend(real(*args, **kwargs))
        return tuple(arms)
    overlap._decide_buckets = spy
    if force is not None:
        var.registry.set_override("coll_nccl_grad_sync_mode", force)
    if rules is not None:
        var.registry.set_override("coll_nccl_dynamic_rules", rules)
    try:
        loss, grads = tfm.make_value_and_grad(cfg, mesh, "cpu")(params,
                                                                tokens)
    except ValueError as e:
        return ("ValueError", str(e))
    finally:
        overlap._decide_buckets = real
        var.registry.reset_cache()
        _sim(None)
    return float(loss), [_host(g) for g in grads], arms


def leaves_of(dc, tree):
    return [np.asarray(x) for x in optim.tree_leaves(
        tfm.params_from_numpy(tree, device="cpu"))]


# -- the audit seams ------------------------------------------------------------

def _planes_on():
    from ompi_tpu_torch import perf, trace, traffic
    trace.clear()
    trace.enable()
    traffic.reset()
    traffic.enable()
    perf.reset()
    perf.enable()


def _planes_off():
    from ompi_tpu_torch import perf, trace, traffic
    trace.disable()
    trace.clear()
    traffic.disable()
    traffic.reset()
    perf.disable()
    perf.reset()


def ulysses_charge(dc, axes, q, k, v):
    """ulysses_attention on this process's sequence shards with the
    traffic plane on: the traffic edges and the charge by coll."""
    from ompi_tpu_torch import traffic
    mesh = _mesh(axes)
    n, i = mesh.mesh.shape[mesh.mesh_dim_names.index("sp")], \
        axis_rank(mesh, "sp")
    qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(
        np.split(t, n, axis=1)[i])) for t in (q, k, v))
    _planes_on()
    try:
        ulysses_attention(qs, ks, vs, mesh, "sp")
        return {"edges": traffic.matrix.rows(),
                "per_coll": traffic.matrix.per_coll(),
                "unattributed": traffic.matrix.unattributed_bytes}
    finally:
        _planes_off()


def pipe_trace(dc, axes, layers, mbs, fail=False):
    """pipeline of the toy stage over "pp" with tracing on (``fail``: a
    stage that raises): this process's ``pipeline:*`` spans."""
    from ompi_tpu_torch import trace
    mesh = _mesh(axes)
    n = mesh.mesh.shape[mesh.mesh_dim_names.index("pp")]
    tree = [{k: torch.from_numpy(v) for k, v in lay.items()}
            for lay in layers]
    mine = shard_stage_params(stack_stage_params(tree, n), mesh, "pp")

    def bad(p, x):
        raise ValueError("a stage that fails")

    _planes_on()
    try:
        try:
            pipeline(bad if fail else _toy_stage, mine,
                     torch.from_numpy(mbs), mesh, "pp")
        except ValueError:
            pass
        return [{"name": e["name"], "cat": e["cat"], "rank": e["rank"],
                 "dur": e["dur"], "args": dict(e["args"])}
                for e in trace.events() if e["name"].startswith("pipeline:")]
    finally:
        _planes_off()


def quant_spans(dc, axes, x):
    """The three quantized collectives of ``dc.quant`` on this process's
    row of the canonical ``x`` with tracing on: their ``quant:*`` spans'
    names and args."""
    from ompi_tpu_torch import trace
    comm = DeviceComm(_mesh(axes), tuple(axes)[0])
    row = torch.from_numpy(np.ascontiguousarray(x[comm.pos:comm.pos + 1]))
    _planes_on()
    try:
        comm.quant.allreduce(row)
        comm.quant.reduce_scatter(row)
        comm.quant.allgather(row)
        return [(e["name"], e["rank"], dict(e["args"]))
                for e in trace.events() if e["name"].startswith("quant:")]
    finally:
        _planes_off()
