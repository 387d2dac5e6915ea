"""What the gloo workers of the port's fleet tests run.

``_torch_coll_worker.Pool`` runs these by ``"_torch_fleet_worker:<name>"``
in every process of its world; each builds what it needs over the whole
world (a ``ServingFleet`` makes its own ``{"fleet": R, "tp": tp}`` mesh)
and returns numpy arrays and plain data.  Like the pool's own module it
imports torch, numpy and the port only, never JAX.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch
import torch.distributed as dist

from ompi_tpu_torch import serving
from ompi_tpu_torch import spc as spc_mod
from ompi_tpu_torch.core import var
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel import reshard, simdcn
from ompi_tpu_torch.parallel.mesh import SIM_DCN_ENV
from ompi_tpu_torch.serving import fleet as fleet_mod
from ompi_tpu_torch.serving import scheduler as sched

from _torch_serve_worker import _StepClock, _config


def _fleet(cfg_kw, tree, topo, spc=None):
    """A fleet of ``topo`` = (replicas, tp, prefill_replicas) from the
    whole tree, on the CPU."""
    replicas, tp, pre = topo
    return fleet_mod.ServingFleet(
        tfm.params_from_numpy(tree, device="cpu"), _config(cfg_kw),
        replicas=replicas, tp=tp, prefill_replicas=pre,
        spc=spc if spc is not None else spc_mod.Counters())


def _requests(stream):
    """``stream`` as (rid, prompt, max_new, arrival) rows."""
    return [sched.Request(rid=r, prompt=np.asarray(p, np.int32),
                          max_new=int(m), arrival=float(a))
            for r, p, m, a in stream]


def cross_cases(dc, cases, dtype="float32"):
    """Each case (host, src_spec, dst_spec, (src axes, src ranks), (dst
    axes, dst ranks)): this rank's destination block of ``host`` moved by
    ``cross_reshard`` from its source block (cut here by the port's own
    index map), the spc deltas and ``report()["last"]``."""
    out = []
    for host, src_spec, dst_spec, (sa, sr), (da, dr) in cases:
        host = np.asarray(host)
        src = reshard.RankMesh.make(sa, sr)
        dst = reshard.RankMesh.make(da, dr)
        me = dist.get_rank()
        x = None
        if me in src.ranks:
            reg = reshard._index_map(host.shape, reshard._norm(
                src_spec, host.ndim), src)[src.ranks.index(me)]
            x = torch.from_numpy(np.ascontiguousarray(
                host[tuple(slice(a, b) for a, b in reg)])).to(
                getattr(torch, dtype))
        c = spc_mod.Counters()
        y = reshard.cross_reshard(x, host.shape, x.dtype if x is not None
                                  else getattr(torch, dtype), src_spec,
                                  dst_spec, src, dst, spc=c)
        plan = reshard.compile_cross_plan(host.shape,
                                          getattr(torch, dtype), src_spec,
                                          dst_spec, src, dst)
        out.append({"out": None if y is None else y.float().numpy(),
                    "alias": y is not None and y is x,
                    "arms": c.get("coll_arm_native_count"),
                    "wire": c.get("coll_wire_bytes"),
                    "plan_wire": plan.wire_bytes,
                    "last": (reshard.report()["last"]
                             if me in src.ranks else None)})
    return out


def cross_refusals(dc, host):
    """cross_reshard's refusals on a {"x": n} → {"x": n/2} move: a dead
    position whose block has no live copy (P14), and a plan that fell
    back (an axis move no whole source block tiles)."""
    n = dist.get_world_size()
    src = reshard.RankMesh.make({"x": n}, range(n))
    dst = reshard.RankMesh.make({"x": n // 2}, range(0, n, 2))
    out = {}
    for name, spec_in, spec_out, dead in (
            ("shadow", ("x", None), ("x", None), (1,)),
            ("fallback", (None, "x"), ("x", None), ())):
        try:
            reg = reshard._index_map(host.shape, reshard._norm(
                spec_in, 2), src)[dist.get_rank()]
            x = torch.from_numpy(np.ascontiguousarray(
                host[tuple(slice(a, b) for a, b in reg)]))
            reshard.cross_reshard(x, host.shape, x.dtype, spec_in,
                                  spec_out, src, dst, dead=dead)
        except reshard.ReshardError as e:
            out[name] = str(e)
    return out


def migration(dc, cfg_kw, tree, prompt, max_new, tp):
    """A 1 + 1 fleet at ``tp``: the prompt prefilled on the prefill
    replica, its pages migrated.  Each rank returns its side, its slot's
    pages per layer (k, v), its slot's seq_len, the ledger, the spc's
    deltas over the migration and the reshard audit."""
    serving.reset()
    serving.enable()
    c = spc_mod.Counters()
    fl = _fleet(cfg_kw, tree, (2, tp, 1), spc=c)
    pre, dec = fl.replicas
    cache = fl.engine.cache
    prompt = np.asarray(prompt, np.int32)
    slot = None
    if fl.me == 0:
        slot = cache.admit(len(prompt), max_new)
        fl.engine.prefill(slot, prompt)
    arms, wire = c.get("coll_arm_native_count"), c.get("coll_wire_bytes")
    try:
        dslot = fl.migrate(pre, dec, slot, len(prompt), max_new, rid="r0")
        rep = serving.fleet_report()
    finally:
        serving.disable()
    slot = slot if fl.me == 0 else dslot
    pages = cache._slot_pages[slot]
    return {"side": "prefill" if fl.me == 0 else "decode",
            "pos": fl.engine.dc.pos,
            "k": [p[:, pages].numpy() for p in cache.k],
            "v": [p[:, pages].numpy() for p in cache.v],
            "seq_len": int(cache.seq_lens[slot]),
            "report": rep,
            "arms": c.get("coll_arm_native_count") - arms,
            "wire": c.get("coll_wire_bytes") - wire,
            "last": reshard.report()["last"]}


def migration_simdcn(dc, cfg_kw, tree, prompt, us_per_mib):
    """The migration of a 1 + 1 fleet at tp 1 with the fleet axis a
    simulated DCN axis: the arguments ``time.sleep`` got, and the wire."""
    os.environ[SIM_DCN_ENV] = "fleet"
    var.registry.set_override("topo_sim_dcn_us_per_mib", us_per_mib)
    slept = []
    real = simdcn.time
    simdcn.time = types.SimpleNamespace(sleep=slept.append)
    try:
        fl = _fleet(cfg_kw, tree, (2, 1, 1))
        pre, dec = fl.replicas
        prompt = np.asarray(prompt, np.int32)
        slot = None
        if fl.me == 0:
            slot = fl.engine.cache.admit(len(prompt), 4)
            fl.engine.prefill(slot, prompt)
        fl.migrate(pre, dec, slot, len(prompt), 4)
        wire = reshard.report()["last"]["wire_bytes"]
        return {"plane": fl._plane, "slept": slept, "wire": wire,
                "penalty_us": simdcn.penalty_us(wire)}
    finally:
        simdcn.time = real
        var.registry.set_override("topo_sim_dcn_us_per_mib", 0.0)
        del os.environ[SIM_DCN_ENV]


def fleet_runs(dc, cfg_kw, tree, topo, stream, runs=1, clock=None,
               skew=True, cli=None):
    """``runs`` runs of one fleet of ``topo`` over ``stream``: per run the
    router's assignments, the streams, the decode steps, the migrations
    and the router's weights after the run.  With ``clock`` the fleet
    and its schedulers read a ``_StepClock`` of ``clock·(1 + world
    rank)`` seconds a reading (``clock`` on every rank without ``skew``):
    the ranks' clocks run apart, and only the agreements keep their
    decisions, and so their collectives, in step.  ``cli`` holds
    variables set for the runs (name → string)."""
    fl = _fleet(cfg_kw, tree, topo)
    real = sched.time, fleet_mod.time
    if clock is not None:
        sched.time = fleet_mod.time = _StepClock(
            clock * (1 + dist.get_rank() if skew else 1))
    for name, value in (cli or {}).items():
        var.registry.set_cli(name, value)
    out = []
    try:
        for _ in range(runs):
            serving.reset()
            serving.enable()
            res = fl.run(_requests(stream))
            rep = serving.fleet_report()
            serving.disable()
            out.append({"assign": [(r["rid"], r["replica"])
                                   for r in rep["routes"]],
                        "streams": {rid: r["tokens"]
                                    for rid, r in res["results"].items()},
                        "completed": res["completed"],
                        "tokens": res["tokens"],
                        "decode_steps": res["decode_steps"],
                        "clock_s": res["clock_s"],
                        "migrations": rep["migrations"],
                        "migration_log": rep["migration_log"],
                        "per_replica": res["per_replica"],
                        "weights": list(fl.router.weights),
                        "pages_used": fl.engine.cache.pages_used})
    finally:
        sched.time, fleet_mod.time = real
        for name in cli or {}:
            var.registry.clear_cli(name)
        serving.disable()
    return out


def fleet_layouts(dc, cfg_kw, tree, topo, stream):
    """Two fleets of ``topo`` built and run in a row: the process groups
    the world holds after each, and each run's streams (the second fleet
    finds the first's mesh and pair groups)."""
    groups = dist.distributed_c10d._world.pg_map
    out = []
    for _ in range(2):
        res = _fleet(cfg_kw, tree, topo).run(_requests(stream))
        out.append({"groups": len(groups),
                    "streams": {rid: r["tokens"]
                                for rid, r in res["results"].items()}})
    return out


def fleet_refusals(dc, cfg_kw, tree):
    """The fleet's refusals in a world of 2: a layout the world does not
    fill, a split with no decode replica, and the hot_replica sentry
    (P16)."""
    out = {}
    for name, topo in (("world", (3, 1, 0)), ("split", (2, 1, 2))):
        try:
            _fleet(cfg_kw, tree, topo)
        except ValueError as e:
            out[name] = str(e)
    try:
        _fleet(cfg_kw, tree, (2, 1, 0)).check_hot_replicas()
    except NotImplementedError as e:
        out["hot"] = str(e)
    return out


def fleet_requests(dc, cfg_kw, tree, topo, stream, clock, planes=True,
                   cli=None):
    """One run of a fleet of ``topo`` over ``stream`` on a uniform
    ``_StepClock`` of ``clock`` seconds a reading, with the serve plane
    and (``planes``) the trace and request planes on: this process's
    shipped trace payload (``trace.merge._payload``, the request lanes
    it holds included), the request plane's report and pvars, the
    streams and the spc's request pvars.  ``cli`` holds variables set for
    the run (name → string); a run the request plane refuses (an SLO
    breach: P16b) returns the refusal's message."""
    import json

    from ompi_tpu_torch import trace
    from ompi_tpu_torch.serving import requests
    from ompi_tpu_torch.trace import merge
    c = spc_mod.Counters()
    fl = _fleet(cfg_kw, tree, topo, spc=c)
    real = sched.time, fleet_mod.time
    sched.time = fleet_mod.time = _StepClock(clock)
    for name, value in (cli or {}).items():
        var.registry.set_cli(name, value)
    serving.reset()
    serving.enable()
    requests.reset()
    trace.clear()
    if planes:
        requests.enable()
        trace.enable()
    refused = res = None
    try:
        res = fl.run(_requests(stream))
    except NotImplementedError as e:
        refused = str(e)
    finally:
        sched.time, fleet_mod.time = real
        for name in cli or {}:
            var.registry.clear_cli(name)
        serving.disable()
        requests.disable()
        trace.disable()
    out = {"rank": dist.get_rank(), "refused": refused,
           "payload": json.loads(merge._payload(dist.get_rank())),
           "report": requests.report(),
           "pvars": {n: c.get(n) for n in requests.PVARS},
           "events": len(trace.events()),
           "streams": (None if res is None else
                       {rid: r["tokens"]
                        for rid, r in res["results"].items()})}
    requests.reset()
    trace.clear()
    return out


def cross_audit(dc, cases, dtype="float32"):
    """``cross_cases`` with the trace, perf and traffic planes on: per case
    this rank's decision events, compile marks, the traffic edges and
    the attributed and unattributed bytes, beside the spc's wire."""
    from ompi_tpu_torch import perf, trace, traffic
    out = []
    try:
        for case in cases:
            trace.clear()
            trace.enable()
            traffic.reset()
            traffic.enable()
            perf.reset()
            perf.enable()
            got = cross_cases(dc, [case], dtype)[0]
            evs = trace.events()
            got.update(
                decisions=[dict(e["args"]) for e in evs
                           if e["name"] == "decide:reshard"],
                marks=[e["name"] for e in evs
                       if e["name"].startswith(("reshard:", "cache_hit:"))],
                edges=traffic.matrix.rows(),
                attributed=traffic.matrix.placed_bytes,
                unattributed=traffic.matrix.unattributed_bytes)
            got.pop("out")
            out.append(got)
    finally:
        trace.disable()
        trace.clear()
        traffic.disable()
        traffic.reset()
        perf.disable()
        perf.reset()
    return out
