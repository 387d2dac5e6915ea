"""Critical-path analysis over the request plane's span trees.

The port's copy of ``ompi_tpu/trace/critical.py``, over the port's
``trace.merge.FleetTimeline``.

``serving.requests`` emits rid-tagged ``req:*`` events (queue /
prefill / migrate / join / decode stage spans, admit/token instants,
the enclosing ``req:e2e`` span and the hand-off flow arrows) from
every replica a request touched.  After ``trace.merge`` aligns the
per-rank clocks, this module re-derives the per-request story FROM THE
TRACE ALONE — no ledger access — which is exactly what makes its
conservation check meaningful:

* :func:`request_trees` — group the merged timeline's rid-tagged
  events into one globally ordered span tree per request, even when
  its stages ran on disjoint tp submeshes (the bridge-mesh case).
* :func:`conservation` — the request-plane conservation law: the sum
  of a request's stage spans must equal its measured ``req:e2e`` wall
  within clock confidence (±best_rtt/2 per involved rank), the same
  discipline as the traffic plane's edge-sum == wire-bytes check.
* :func:`tail_attribution` — decompose the slowest requests (at a
  quantile) into named stages and blame the stage with the largest
  excess over the population median — "why is THIS request's tail
  bad", answered by the system.
* :func:`analyze_requests` — the combined report comm_doctor
  --requests renders and bench --slo gates on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .merge import FleetTimeline

#: stage-span names, lifecycle order (mirrors serving.requests.STAGES)
STAGE_NAMES = ("req:queue", "req:prefill", "req:migrate", "req:join",
               "req:decode")


def _stage(name: str) -> str:
    return name.split(":", 1)[1]


def request_trees(tl: FleetTimeline) -> Dict[Any, Dict[str, Any]]:
    """One span tree per rid: every ``req:*`` / route-decision event in
    the merged timeline carrying that rid, globally ordered.  Returns
    ``{rid: {"rid", "events", "spans", "stages", "e2e", "ranks",
    "tokens", "flows"}}`` where ``stages`` sums aligned stage-span
    durations and ``e2e`` is the ``req:e2e`` span (None when the
    request never finished inside the captured window)."""
    trees: Dict[Any, Dict[str, Any]] = {}
    for e in tl.events:
        rid = e.get("args", {}).get("rid")
        if rid is None or not (e["name"].startswith("req:")
                               or e["name"] == "decide:route"):
            continue
        tree = trees.get(rid)
        if tree is None:
            tree = trees[rid] = {"rid": rid, "events": [], "spans": [],
                                 "stages": {}, "e2e": None, "ranks": [],
                                 "tokens": 0, "flows": []}
        tree["events"].append(e)
        if e["rank"] not in tree["ranks"]:
            tree["ranks"].append(e["rank"])
        if e["ph"] == "X":
            if e["name"] == "req:e2e":
                tree["e2e"] = e
            else:
                tree["spans"].append(e)
                st = _stage(e["name"])
                tree["stages"][st] = (tree["stages"].get(st, 0.0)
                                      + float(e.get("dur", 0.0)))
        elif e["ph"] in ("s", "t", "f"):
            tree["flows"].append(e)
        elif e["name"] == "req:token":
            tree["tokens"] += 1
    for tree in trees.values():
        tree["ranks"].sort()
        # tl.events is globally sorted, so each tree inherits the order;
        # make it explicit for spans (ties broken by lifecycle order)
        order = {n: i for i, n in enumerate(STAGE_NAMES)}
        tree["spans"].sort(key=lambda s: (s["t"],
                                          order.get(s["name"], 99)))
    return trees


def _tolerance(tl: FleetTimeline, ranks: List[int]) -> float:
    """Clock-confidence bound for a cross-rank sum: ±best_rtt/2 per
    involved aligned rank (an unaligned rank gets no bound — its
    residual is alignment artifact and the check refuses to pass it
    silently, mirroring the merge's loud-degrade contract)."""
    tol = 1e-6
    for r in ranks:
        tol += float(tl.best_rtt.get(r, 0.0)) / 2.0
    return tol


def conservation(tl: FleetTimeline,
                 trees: Optional[Dict[Any, Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
    """Stage-sum == e2e-wall conservation over every finished request
    in the timeline.  A request whose residual exceeds the clock
    confidence of its involved ranks fails — either a stage went
    unrecorded (instrumentation hole) or the clock alignment is off."""
    trees = request_trees(tl) if trees is None else trees
    rows: List[Dict[str, Any]] = []
    for rid in sorted(trees, key=str):
        tree = trees[rid]
        e2e = tree["e2e"]
        if e2e is None:
            continue
        stage_sum = sum(tree["stages"].values())
        wall = float(e2e.get("dur", 0.0))
        tol = _tolerance(tl, tree["ranks"])
        unaligned = [r for r in tree["ranks"]
                     if r in set(tl.unaligned_ranks)]
        resid = abs(stage_sum - wall)
        rows.append({"rid": rid, "e2e_s": round(wall, 9),
                     "stage_sum_s": round(stage_sum, 9),
                     "resid_s": round(resid, 9),
                     "tol_s": round(tol, 9),
                     "ranks": tree["ranks"],
                     "ok": resid <= tol and not unaligned,
                     "unaligned": unaligned})
    return {"requests": rows, "checked": len(rows),
            "failed": sum(1 for r in rows if not r["ok"]),
            "all_ok": all(r["ok"] for r in rows) if rows else True}


def tail_attribution(tl: FleetTimeline, q: float = 0.99,
                     trees: Optional[Dict[Any, Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
    """Critical-path attribution for the slowest requests: every
    finished request at or above the ``q`` e2e quantile is blamed on
    the stage with the largest excess over that stage's population
    median (argmax duration when a stage has no peers) — a degraded
    migration lane shows up as ``migrate``, a slowed prefill replica
    as ``prefill``, regardless of which stage is nominally largest."""
    trees = request_trees(tl) if trees is None else trees
    done = [t for t in trees.values() if t["e2e"] is not None]
    if not done:
        return {"quantile": q, "threshold_s": 0.0, "tail": [],
                "rollup": {}, "requests": 0}
    walls = [float(t["e2e"]["dur"]) for t in done]
    thresh = float(np.percentile(np.asarray(walls), 100.0 * q))
    medians: Dict[str, float] = {}
    for t in done:
        for st, dur in t["stages"].items():
            medians.setdefault(st, 0.0)
    for st in medians:
        samples = [t["stages"][st] for t in done if st in t["stages"]]
        medians[st] = float(np.median(np.asarray(samples)))
    tail: List[Dict[str, Any]] = []
    rollup: Dict[str, int] = {}
    for t in sorted(done, key=lambda t: (-float(t["e2e"]["dur"]),
                                         str(t["rid"]))):
        wall = float(t["e2e"]["dur"])
        if wall < thresh:
            break
        best, best_excess = None, float("-inf")
        for st, dur in t["stages"].items():
            excess = float(dur) - medians.get(st, 0.0)
            if excess > best_excess:
                best, best_excess = st, excess
        tail.append({"rid": t["rid"], "e2e_s": round(wall, 9),
                     "stage": best,
                     "excess_s": round(best_excess, 9),
                     "stages_s": {k: round(v, 9)
                                  for k, v in t["stages"].items()}})
        if best is not None:
            rollup[best] = rollup.get(best, 0) + 1
    return {"quantile": q, "threshold_s": round(thresh, 9),
            "tail": tail, "rollup": rollup, "requests": len(done)}


def analyze_requests(tl: FleetTimeline, q: float = 0.99) -> Dict[str, Any]:
    """The combined request-plane analysis: per-request summaries,
    the conservation check and the tail attribution — what
    ``comm_doctor --requests`` renders from a merged timeline."""
    trees = request_trees(tl)
    summaries = []
    for rid in sorted(trees, key=str):
        t = trees[rid]
        summaries.append({
            "rid": rid,
            "ranks": t["ranks"],
            "tokens": t["tokens"],
            "spans": len(t["spans"]),
            "flows": len(t["flows"]),
            "e2e_s": (round(float(t["e2e"]["dur"]), 9)
                      if t["e2e"] is not None else None),
            "stages_s": {k: round(v, 9) for k, v in t["stages"].items()},
        })
    return {
        "requests": len(trees),
        "finished": sum(1 for t in trees.values() if t["e2e"] is not None),
        "trees": summaries,
        "conservation": conservation(tl, trees=trees),
        "tail": tail_attribution(tl, q=q, trees=trees),
    }
