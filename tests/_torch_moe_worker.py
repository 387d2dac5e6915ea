"""What the processes of the port's expert-parallel MoE tests run.

``_torch_coll_worker.Pool`` runs these by ``"_torch_moe_worker:<name>"`` in
every process of its world; the tests also call them in the test process,
in a gloo world of one that holds every row.  ``axes`` names a mesh made
once for the world (``None``: the caller's own comm).  Like the pool's
module it imports torch, numpy and the port only, never JAX: inputs arrive
as numpy arrays and results leave as numpy arrays and plain numbers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ompi_tpu_torch import spc as spc_mod
from ompi_tpu_torch.core import var
from ompi_tpu_torch.models import moe
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel import simdcn
from ompi_tpu_torch.parallel.collectives import DeviceComm
from ompi_tpu_torch.parallel.mesh import SIM_DCN_ENV, make_mesh

_COMMS = {}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _comm(dc, axes):
    """A comm over every axis of the mesh ``axes`` (made once a world)."""
    if axes is None:
        return dc
    key = tuple(axes.items())
    if key not in _COMMS:
        names = tuple(axes)
        _COMMS[key] = DeviceComm(make_mesh(dict(axes)),
                                 names if len(names) > 1 else names[0])
    return _COMMS[key]


def block_ep(dc, axes, h, params, n_experts, top_k, cf, sim=None,
             force=None, dtype="float32"):
    """``moe_block_ep`` on this process's rows of the whole (R, t, d)
    ``h``, with this process's experts cut from the full stacks; ``sim``
    sets the simulated-DCN axes and ``force`` the moe arms' force
    variables for the call.  Returns this process's rows of the mixture,
    the aux, the info, the spc counts and the last exchange's plan."""
    comm = _comm(dc, axes)
    if sim:
        os.environ[SIM_DCN_ENV] = sim
    for name, value in (force or {}).items():
        var.registry.set_cli(name, value)
    try:
        comm.spc = spc_mod.Counters()
        r = h.shape[0] // comm.n
        rows = torch.tensor(h[comm.pos * r:(comm.pos + 1) * r],
                            dtype=_DTYPES[dtype])
        local = moe.local_experts(
            {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
            comm)
        out, aux, info = moe.moe_block_ep(comm, rows, local, n_experts,
                                          top_k, cf)
        return {"out": out.float().numpy(), "aux": float(aux), "info": info,
                "wire": comm.spc.get("coll_wire_bytes"),
                "arms": {a: comm.spc.get(f"coll_arm_{a}_count")
                         for a in ("native", "hier", "hier+quant")},
                "a2av": dict(comm._last_a2av)}
    finally:
        for name in force or {}:
            var.registry.clear_cli(name)
        os.environ.pop(SIM_DCN_ENV, None)
        simdcn.clear_cache()


def route_roundtrip(dc, tokens, owner):
    """``ragged_ep_route`` then ``ragged_ep_combine`` on this process's
    rows of ``tokens`` (R, T, d): the received rows, the counts and the
    tokens back."""
    r = tokens.shape[0] // dc.n
    mine = torch.tensor(tokens[dc.pos * r:(dc.pos + 1) * r])
    recv, counts, ctx = moe.ragged_ep_route(dc, mine, owner)
    back = moe.ragged_ep_combine(dc, recv, ctx)
    return {"recv": recv.numpy(), "counts": counts, "C": ctx["C"],
            "back": back.numpy(), "a2av": dict(dc._last_a2av)}


def eval_loss(dc, axes, cfg_kw, tree, tokens, rows=None):
    """``moe_eval_loss`` of the JAX package's tree (as numpy) on the
    comm, each process holding its rows' experts."""
    comm = _comm(dc, axes)
    kw = dict(cfg_kw)
    kw["dtype"] = _DTYPES[kw.get("dtype", "float32")]
    cfg = tfm.Config(**kw)
    params = tfm.params_from_numpy(tree, device="cpu")
    for layer in params["layers"]:
        layer["moe"] = moe.local_experts(layer["moe"], comm)
    return float(tfm.moe_eval_loss(comm, params, tokens, cfg, rows=rows))


def block_ep_audit(dc, axes, h, params, n_experts, top_k, cf, sim=None,
                   force=None):
    """``block_ep`` with the trace, perf and traffic planes on: besides
    its result, this process's ``decide:moe_*`` events, the traffic edges,
    the attributed and unattributed bytes and the perf cells."""
    from ompi_tpu_torch import perf, trace, traffic
    trace.clear()
    trace.enable()
    traffic.reset()
    traffic.enable()
    perf.reset()
    perf.enable()
    try:
        got = block_ep(dc, axes, h, params, n_experts, top_k, cf, sim=sim,
                       force=force)
        got.update(
            decisions=[(e["name"], e["rank"], dict(e["args"]))
                       for e in trace.events()
                       if e["name"].startswith("decide:moe")],
            edges=traffic.matrix.rows(),
            attributed=traffic.matrix.placed_bytes,
            unattributed=traffic.matrix.unattributed_bytes,
            perf_cells=sorted({(r["coll"], r["arm"])
                               for r in perf.model.table()}))
        return got
    finally:
        trace.disable()
        trace.clear()
        traffic.disable()
        traffic.reset()
        perf.disable()
        perf.reset()
