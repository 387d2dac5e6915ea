"""The port's audit planes under ``tpurun``: the rank program of
``test_torch_trace``, ``test_torch_perf`` and ``test_torch_traffic``.

Run as ``python -m ompi_tpu_torch.tools.tpurun -np N --device-plane cpu
_torch_audit_prog.py OUT PHASES [R_PER]``: every rank joins the device
plane, runs the comma-separated phases and writes what it saw to
``OUT/rank<r>.json`` (plus per-rank Chrome dumps for the ``skew`` phase).
The inputs come from the numpy makers here, which the tests feed to the
JAX package's single controller as well.  Imports torch, numpy and the
port only.
"""

import json
import os
import sys
import time

import numpy as np

ENTRIES = ("allreduce", "bcast", "allgather", "alltoall",
           "reduce_scatter_block", "reduce", "scan", "exscan", "gather",
           "scatter", "reduce_scatter", "allgatherv")
# the decision-event fields computed by the decision layer, held equal to
# the reference's (``shape`` is each process's own rows)
FIELDS = ("op", "arm", "reason", "chain", "nbytes", "wire_bytes",
          "quant_ratio", "shape_bucket", "reduce_op", "dtype", "ndev",
          "verdict", "hier_inner", "hier_outer", "hier_inner_bytes",
          "hier_outer_bytes")
# (name, variable settings, rules-file text or None, payload seed)
REGIMES = (("force", {"allreduce_mode": "quant"}, None, 1),
           ("blanket", {"COLL_QUANT": "on"}, None, 2),
           ("rules", {}, "allreduce 1 0 staged\n", 3),
           ("floor", {}, "allreduce 1 0 quant\n", 4))


def entry_data(R: int, seed: int = 5) -> dict:
    """The inputs of the twelve entries as canonical (R, ...) arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    return {"x": f32(R, 64), "x2": f32(R, R), "x3": f32(R, R, 4),
            "xa": f32(R, R, 8)}


def run_entries(comm, d, R: int) -> None:
    """The twelve ``comm.coll`` entries of the decision audit, ``d(key)``
    giving this process's rows of ``entry_data``."""
    c, cc = comm, comm.coll
    cc.allreduce(c, d("x"))
    cc.bcast(c, d("x"))
    cc.allgather(c, d("x"))
    cc.alltoall(c, d("xa"))
    cc.reduce_scatter_block(c, d("x"))
    cc.reduce(c, d("x"))
    cc.scan(c, d("x"))
    cc.exscan(c, d("x"))
    cc.gather(c, d("x"))
    cc.scatter(c, d("x3"))
    cc.reduce_scatter(c, d("x"), None, [64 // R] * R)
    cc.allgatherv(c, d("x2"), counts=[R] * R)


def regime_rows(R: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (R, 512)).astype(np.float32)


def conservation_rows(R: int) -> dict:
    return {"x": np.ones((R, 256), np.float32),
            "xa": np.ones((R, R, 16), np.float32)}


def jsonable(v):
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return None if not np.isfinite(v) else float(v)
    return v


def decisions(trace, rank: int) -> list:
    return [{k: e["args"].get(k) for k in FIELDS if k in e["args"]}
            for e in trace.events(rank) if e["cat"] == "decision"]


def matrix_view(traffic) -> dict:
    m = traffic.matrix
    return {"rows": m.rows(), "per_coll": m.per_coll(),
            "planes": m.plane_totals(), "ops": m.ops,
            "placed": m.placed_bytes, "unattributed": m.unattributed_bytes,
            "edge_count": m.edge_count()}


def main(argv) -> int:
    import torch

    from ompi_tpu_torch import perf, runtime, trace, traffic
    from ompi_tpu_torch.core import var
    from ompi_tpu_torch.parallel import attach_mesh, init_device_plane
    from ompi_tpu_torch.parallel.mesh import make_mesh

    out_dir, phases = argv[0], argv[1].split(",")
    r_per = int(argv[2]) if len(argv) > 2 else 1
    ctx = runtime.init()
    init_device_plane(ctx)
    comm = ctx.comm_world
    n = comm.size
    R = n * r_per
    lo, hi = ctx.rank * r_per, (ctx.rank + 1) * r_per
    mesh = make_mesh({"x": n})
    attach_mesh(comm, mesh, "x")
    rows = lambda a: torch.from_numpy(np.ascontiguousarray(a[lo:hi]))  # noqa
    res = {}

    def reattach(**settings):
        """Override port variables (none given: drop every override), then
        attach again so the decision layer rereads its rules file."""
        for k, v in settings.items():
            var.registry.set_override(k, v)
        if not settings:
            var.registry.reset_cache()
        attach_mesh(comm, mesh, "x")

    def spc(*names):
        return {k: ctx.spc.get(k) for k in names}

    for phase in phases:
        trace.clear()
        traffic.reset()
        perf.reset()
        if phase == "decisions":
            trace.enable()
            data = entry_data(R)
            run_entries(comm, lambda k: rows(data[k]), R)
            res["decisions"] = decisions(trace, ctx.rank)
            res["enter"] = sum(e["cat"] == "coll-enter"
                               for e in trace.events(ctx.rank))
            res["arms"] = spc("coll_arm_native_count",
                              "coll_arm_staged_count",
                              "coll_arm_quant_count")
            res["decide_ranks"] = sorted({e["rank"] for e in trace.events()
                                          if e["cat"] == "decision"})
            trace.disable()
        elif phase == "regimes":
            trace.enable()
            got = {}
            for name, settings, rules, seed in REGIMES:
                over = {("COLL_QUANT" if k == "COLL_QUANT"
                         else f"coll_nccl_{k}"): v
                        for k, v in settings.items()}
                if rules is not None:
                    path = os.path.join(out_dir, f"rules_{name}_{ctx.rank}")
                    with open(path, "w") as fh:
                        fh.write(rules)
                    over["coll_nccl_dynamic_rules"] = path
                reattach(**over)
                trace.clear()
                before = dict(ctx.spc.snapshot())
                comm.coll.allreduce(comm, rows(regime_rows(R, seed)))
                after = ctx.spc.snapshot()
                got[name] = {
                    "rec": trace.explain_last("allreduce"),
                    "events": len(decisions(trace, ctx.rank)),
                    "delta": {k: after[k] - before.get(k, 0)
                              for k in ("coll_wire_bytes",
                                        "coll_arm_native_count",
                                        "coll_arm_staged_count",
                                        "coll_arm_quant_count",
                                        "coll_staged_fallbacks")}}
                reattach()
            res["regimes"] = got
            trace.disable()
        elif phase == "disabled":
            trace.disable()
            traffic.disable()
            perf.disable()
            x = rows(entry_data(R)["x"])
            comm.coll.allreduce(comm, x)
            comm.device_comm.push_row(x, 0, R - 1)
            res["disabled"] = {
                "events": len(trace.events()), "ops": traffic.matrix.ops,
                "asked": traffic.matrix.asked_bytes,
                "cells": perf.model.bucket_count(),
                "steps": perf.ledger.steps,
                "explain": trace.explain_last("allreduce")}
        elif phase == "toggle":
            got = {}
            for plane_name, mod in (("trace", trace), ("perf", perf),
                                    ("traffic", traffic)):
                var.registry.set_override(f"{plane_name}_enabled", True)
                on = mod.enabled
                var.registry.set_override(f"{plane_name}_enabled", False)
                got[plane_name] = [on, mod.enabled]
                var.registry.reset_cache()
            res["toggle"] = got
        elif phase == "skew":
            from ompi_tpu_torch.tools import mpisync
            from ompi_tpu_torch.trace import analyze, merge
            trace.enable()
            x = rows(entry_data(R)["x"])
            for _ in range(20):
                if ctx.rank == 2:
                    time.sleep(5e-3)
                comm.coll.allreduce(comm, x)
            offsets, rtt = mpisync.clock_sync_ex(comm, rounds=8)
            path = os.path.join(out_dir, f"trace_{ctx.rank}.json")
            trace.save_chrome(path, rank=ctx.rank)
            tl = merge.gather(comm)
            res["offsets"] = [float(o) for o in offsets]
            res["rtt"] = [float(t) for t in rtt]
            if ctx.rank == 0:
                sk = analyze.entry_skew(tl, z_thresh=2.0)
                merged = os.path.join(out_dir, "merged.json")
                tl.save_chrome(merged)
                res["flagged"] = sk["flagged"]
                res["ranks"] = tl.ranks
                per = {}
                for e in tl.events:
                    if e["cat"] == "decision":
                        per[e["rank"]] = per.get(e["rank"], 0) + 1
                res["decisions_per_rank"] = per
            trace.disable()
        elif phase == "traffic":
            # allreduce, allgather, alltoall (native forced) and one
            # push_row (with several rows a process, a ring_shift too),
            # then the staged alltoall of the CPU default alone
            traffic.enable()
            reattach(coll_nccl_mode="native")
            data = conservation_rows(R)
            dc = comm.device_comm
            before = dict(ctx.spc.snapshot())
            x = rows(data["x"])
            comm.coll.allreduce(comm, x)
            comm.coll.allgather(comm, x)
            comm.coll.alltoall(comm, rows(data["xa"]))
            if r_per == 1:
                dc.push_row(x, 1, R - 1)
            else:
                dc.push_row(x, 2, 5)
                dc.ring_shift(x, 3)
            snap = ctx.spc.snapshot()
            res["conservation"] = {
                "spc": {k: snap[k] - before.get(k, 0) for k in (
                    "coll_wire_bytes", "traffic_attributed_bytes",
                    "traffic_unattributed_bytes")}
                | {"traffic_edge_count": snap["traffic_edge_count"]},
                "matrix": matrix_view(traffic)}
            from ompi_tpu_torch import spc as spc_mod
            res["prometheus"] = spc_mod.export_prometheus(ctx)
            reattach()
            traffic.reset()
            comm.coll.alltoall(comm, rows(data["xa"]))      # staged (cpu)
            res["staged"] = matrix_view(traffic)
            traffic.disable()
        elif phase == "geometry":
            res["geometry"] = geometry(ctx, traffic, n)
        elif phase == "perf":
            perf.enable()
            traffic.enable()
            for size in (256, 4096, 65536):
                for _ in range(3):
                    xs = torch.ones((r_per, size), dtype=torch.float32)
                    comm.coll.allreduce(comm, xs)
                    comm.coll.allgather(comm, xs)
                comm.coll.barrier(comm)
            res["perf_table"] = perf.model.table()
            res["perf_pvars"] = {k: ctx.spc.get(k) for k in perf.PVARS}
            perf.disable()
            traffic.disable()
        else:
            raise SystemExit(f"unknown phase {phase!r}")
    with open(os.path.join(out_dir, f"rank{ctx.rank}.json"), "w") as fh:
        json.dump(jsonable(res), fh)
    runtime.finalize()
    return 0


def geometry(ctx, traffic, n: int) -> dict:
    """The host wrappers' charges on a world of ``n`` (= 4): collective
    matmul in each direction, ring attention, the hierarchical allreduce
    and the grad sync, each from a reset matrix."""
    import torch

    from ompi_tpu_torch.ops.collective_matmul import (allgather_matmul,
                                                      matmul_reduce_scatter)
    from ompi_tpu_torch.parallel.hierarchy import hierarchical_allreduce
    from ompi_tpu_torch.parallel.mesh import make_mesh
    from ompi_tpu_torch.parallel.overlap import make_grad_sync
    from ompi_tpu_torch.parallel.ring import ring_attention

    traffic.enable()
    out = {}
    mesh = make_mesh({"x": n})
    x = torch.ones((16 // n, 8))
    w = torch.ones((8, 4))
    for name, kw in (("fwd", {}), ("rev", {"reverse": True}),
                     ("bidir", {"bidirectional": True})):
        traffic.reset()
        allgather_matmul(x, w, "x", mesh, **kw)
        out[f"collmm_{name}"] = traffic.matrix.to_json()
    traffic.reset()
    matmul_reduce_scatter(torch.ones((16, 8 // n)), torch.ones((8 // n, 4)),
                          "x", mesh)
    out["collmm_rs"] = traffic.matrix.to_json()
    sp = make_mesh({"sp": n})
    q = torch.ones((1, 16 // n, 2, 4))
    traffic.reset()
    ring_attention(q, q.clone(), q.clone(), sp, axis="sp")
    out["ring_attention"] = traffic.matrix.to_json()
    two = make_mesh({"dp": 2, "tp": n // 2})
    traffic.reset()
    hierarchical_allreduce(torch.ones((64,)), two, inner="tp", outer="dp")
    out["hier"] = traffic.report()
    dp = make_mesh({"dp": n})
    params = {"w": torch.ones((n, 4))}

    def local_loss(p, t):
        return torch.sum(p["w"]) * torch.mean(t)

    batch = torch.ones((n, 2))
    for mode in ("perleaf", "unsynced", "bucketed"):
        traffic.reset()
        make_grad_sync(mode, dp, local_loss)(params, batch)
        out[f"grad_sync_{mode}"] = traffic.matrix.to_json()
    traffic.disable()
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
