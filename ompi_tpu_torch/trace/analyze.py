"""Fleet timeline analytics: stragglers, skew, bubbles, decision drift.

The port's copy of ``ompi_tpu/trace/analyze.py``.  Operates on a
``FleetTimeline`` (trace/merge.py).  Averages hide fabric problems —
the IPU microbenchmarking paper's lesson (PAPERS.md) is that per-link
latency HISTOGRAMS and entry-skew DISTRIBUTIONS are what localize
them — so everything here reports distributions (p50/p99/max) and
log-bucketed histograms, never a lone mean.

  * ``entry_skew``      — per coll-name skew distributions: for each
    collective *instance* (per-rank dispatch sequences of op X,
    tail-aligned across the fleet — see ``_instances``),
    skew = max−min arrival; the latest rank is attributed, and ranks
    whose mean lateness z-scores above a configurable threshold are
    flagged as stragglers (lateness inside the clock-sync ±rtt/2
    confidence bound is never flagged — it may be alignment error).
  * ``latency_histograms`` — per-(span-name, arm) log2-bucketed duration
    histograms plus busbw attribution where a span carries its bytes.
  * ``bubble_fraction`` — pipeline fill/drain bubble share from the
    ``pipeline:run`` spans ((P−1)/ticks per run) and the grad-sync runs.
  * ``decision_drift``  — cross-references every audited arm against a
    DEVICE_RULES file: a decision whose matching rule names a different
    arm WITHOUT a sanctioned veto (force:/blanket:/floor:/off:/
    ineligible: reasons outrank rules by design) is drift — the rules
    file no longer matches what the fleet executes.
  * ``analyze``         — the whole report as one dict (the doctor CLI
    and ``bench.py --doctor`` render it).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .merge import FleetTimeline

# reasons that legitimately override a matching rules row — seeing one of
# these with a non-rule arm is policy, not drift (the decision layer's
# precedence chain, ported as coll/nccl.decide_mode)
_VETO_PREFIXES = ("force:", "blanket:", "floor:", "off:", "ineligible:",
                  "learned:")


def _percentiles(xs: Sequence[float]) -> Dict[str, float]:
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()), "count": int(a.size)}


# -- entry skew + straggler attribution --------------------------------------

def _instances(tl: FleetTimeline, op: Optional[str] = None
               ) -> Dict[str, List[Dict[int, float]]]:
    """Group arrival markers into collective instances: the fleet enters
    the same collective in the same program order on every rank (the MPI
    matching assumption), so per-rank arrival sequences align positionally
    — at the TAIL: a rank with fewer recorded arrivals lost its OLDEST
    ones (overwrite-oldest rings, or capture started later on that rank),
    so its j-th arrival is instance ``depth - len + j``, never instance j.
    Instances that end up with fewer than two ranks carry no skew and are
    dropped."""
    # per-op, prefer the per-rank coll-enter markers; decision-audit
    # instants are emitted ONCE per collective by the driving rank, so
    # mixing them in would double-count that rank and shear the
    # positional alignment — they serve only as a fallback for ops whose
    # traces predate the enter markers
    enter: Dict[str, Dict[int, List[float]]] = {}
    decide: Dict[str, Dict[int, List[float]]] = {}
    for e in tl.arrivals(op):
        o = e["args"].get("op")
        if o is None:
            continue
        dst = enter if e["cat"] == "coll-enter" else decide
        dst.setdefault(o, {}).setdefault(e["rank"], []).append(e["t"])
    per_op_rank = dict(decide)
    per_op_rank.update(enter)
    out: Dict[str, List[Dict[int, float]]] = {}
    for o, by_rank in per_op_rank.items():
        depth = max(len(ts) for ts in by_rank.values())
        inst: List[Dict[int, float]] = [{} for _ in range(depth)]
        for r, ts in by_rank.items():
            base = depth - len(ts)
            for j, t in enumerate(ts):
                inst[base + j][r] = t
        keep = [arr for arr in inst if len(arr) >= 2]
        if keep:
            out[o] = keep
    return out


def entry_skew(tl: FleetTimeline, z_thresh: float = 2.5
               ) -> Dict[str, Any]:
    """Per coll-name entry-skew distributions and straggler attribution.

    Returns ``per_coll`` (skew p50/p99/max µs, instance count, and the
    rank most often last in), ``rank_lateness_us`` (each rank's mean
    arrival minus the instance mean), ``z_scores``, and ``flagged`` —
    ranks whose lateness z-scores ≥ ``z_thresh`` AND exceeds the
    clock-sync confidence bound for that rank."""
    inst = _instances(tl)
    per_coll: Dict[str, Any] = {}
    lateness: Dict[int, List[float]] = {}
    last_counts_all: Dict[int, int] = {}
    for op, instances in inst.items():
        skews: List[float] = []
        last_counts: Dict[int, int] = {}
        for arr in instances:
            ts = list(arr.values())
            skews.append((max(ts) - min(ts)) * 1e6)
            worst = max(arr, key=arr.get)
            last_counts[worst] = last_counts.get(worst, 0) + 1
            last_counts_all[worst] = last_counts_all.get(worst, 0) + 1
            mean = sum(ts) / len(ts)
            for r, t in arr.items():
                lateness.setdefault(r, []).append((t - mean) * 1e6)
        row = _percentiles(skews)
        row["unit"] = "us"
        row["worst_rank"] = max(last_counts, key=last_counts.get)
        row["worst_rank_last_count"] = last_counts[row["worst_rank"]]
        per_coll[op] = row
    mean_late = {r: float(np.mean(v)) for r, v in lateness.items()}
    z_scores: Dict[int, float] = {}
    flagged: List[int] = []
    if len(mean_late) >= 2:
        # robust z (median/MAD): a straggler in a small fleet inflates a
        # plain std enough to mask itself; the median absolute deviation
        # is immune to the outlier it exists to find
        vals = np.asarray(list(mean_late.values()))
        med = float(np.median(vals))
        scale = 1.4826 * float(np.median(np.abs(vals - med)))
        if scale == 0.0:
            scale = float(vals.std())
        for r, m in sorted(mean_late.items()):
            z = (m - med) / scale if scale > 0 else 0.0
            z_scores[r] = round(z, 3)
            # alignment-confidence gate: lateness within ±rtt/2 could be
            # clock-sync residual, not a straggler; a rank the merge
            # could not align at all is never flagged — its "lateness"
            # is its unshifted clock
            conf_us = tl.best_rtt.get(r, 0.0) / 2 * 1e6
            if (z >= z_thresh and m > conf_us
                    and r not in getattr(tl, "unaligned_ranks", ())):
                flagged.append(r)
    # the reference publishes each flagged rank to the policy plane when
    # policy.enabled; the port has no policy plane until ROADMAP P16b
    return {"per_coll": per_coll,
            "rank_lateness_us": {r: round(v, 3)
                                 for r, v in sorted(mean_late.items())},
            "z_scores": z_scores, "z_thresh": z_thresh,
            "flagged": flagged, "last_in_counts": last_counts_all}


# -- latency histograms + busbw attribution ----------------------------------

def _log2_bucket(us: float) -> str:
    if us <= 0:
        return "<1us"
    k = max(0, math.floor(math.log2(us)))
    return f"[{2 ** k},{2 ** (k + 1)})us"


# allreduce-family busbw factor: 2(R-1)/R of the buffer crosses the
# bisection (the standard nccl-tests accounting the bench rows use)
_BUSBW_FACTOR = {"allreduce": lambda r: 2 * (r - 1) / r,
                 "grad_sync": lambda r: 2 * (r - 1) / r,
                 "reduce_scatter": lambda r: (r - 1) / r,
                 "allgather": lambda r: (r - 1) / r}


def latency_histograms(tl: FleetTimeline) -> Dict[str, Any]:
    """Per-(span name, arm) log2-bucketed latency histograms; spans that
    carry byte counts in their args additionally contribute busbw
    attribution (GB/s per histogram key, allreduce-family factors)."""
    hists: Dict[str, Dict[str, int]] = {}
    durs: Dict[str, List[float]] = {}
    bw: Dict[str, List[float]] = {}
    for e in tl.spans():
        arm = e["args"].get("arm")
        key = f"{e['name']}|{arm}" if arm else e["name"]
        us = e.get("dur", 0.0) * 1e6
        hists.setdefault(key, {})
        b = _log2_bucket(us)
        hists[key][b] = hists[key].get(b, 0) + 1
        durs.setdefault(key, []).append(us)
        nbytes = e["args"].get("wire_bytes") or e["args"].get("nbytes")
        ndev = e["args"].get("ndev") or len(tl.ranks) or 1
        if nbytes and e["dur"] > 0:
            # "quant:allreduce" keys on allreduce; "grad_sync:bucket"
            # on grad_sync — first known op name anywhere in the span name
            parts = e["name"].split(":")
            fn = next((_BUSBW_FACTOR[p] for p in reversed(parts)
                       if p in _BUSBW_FACTOR), lambda r: 1.0)
            factor = fn(max(ndev, 2))
            bw.setdefault(key, []).append(
                factor * nbytes / e["dur"] / 1e9)
    out: Dict[str, Any] = {}
    for key, h in sorted(hists.items()):
        row: Dict[str, Any] = {
            "histogram": dict(sorted(
                h.items(), key=lambda kv: (len(kv[0]), kv[0]))),
            **_percentiles(durs[key]), "unit": "us"}
        if key in bw:
            row["busbw_GBps"] = {
                "p50": round(float(np.percentile(bw[key], 50)), 3),
                "max": round(max(bw[key]), 3)}
        out[key] = row
    return out


# -- pipeline bubble fraction ------------------------------------------------

def bubble_fraction(tl: FleetTimeline) -> Dict[str, Any]:
    """Fill/drain bubble share of the pipeline runs: with P stages and M
    microbatches the schedule needs M+P−1 ticks of which P−1 are bubble
    ((P−1)/(M+P−1) — GPipe's fraction), taken from each ``pipeline:run``
    span's recorded geometry.  Also surfaces grad-sync run spans (their
    bucket structure is the overlap analog of ticks)."""
    runs = []
    for e in tl.spans("pipeline:run"):
        stages = e["args"].get("stages")
        ticks = e["args"].get("ticks")
        if not stages or not ticks:
            continue
        runs.append({"stages": stages,
                     "microbatches": e["args"].get("microbatches"),
                     "ticks": ticks, "run_us": round(e["dur"] * 1e6, 1),
                     "bubble_fraction": round((stages - 1) / ticks, 4)})
    gs = [round(e["dur"] * 1e6, 1) for e in tl.spans("grad_sync:run")]
    out: Dict[str, Any] = {"runs": runs, "grad_sync_run_us": gs}
    if runs:
        out["bubble_fraction_mean"] = round(
            sum(r["bubble_fraction"] for r in runs) / len(runs), 4)
    return out


# -- decision drift vs DEVICE_RULES ------------------------------------------

def load_rules(path: str) -> List[Tuple[str, int, int, str]]:
    from ..coll.nccl import _load_device_rules

    return _load_device_rules(path)


def decision_drift(tl: FleetTimeline,
                   rules: "str | List[Tuple[str, int, int, str]]"
                   ) -> Dict[str, Any]:
    """Cross-reference audited arms against a rules table: for every
    decision event whose (coll, ndev, nbytes) matches a rule (last
    matching row wins, the dispatch-time convention), the executed arm
    must be the rule's arm unless the recorded reason is a sanctioned
    veto.  Anything else is drift — evidence the rules file and the
    fleet's behavior have diverged (stale file, unmeasured platform,
    or a bug in the decision layer)."""
    if isinstance(rules, str):
        rules = load_rules(rules)
    checked = 0
    drift: List[Dict[str, Any]] = []
    for e in tl.events:
        if e["cat"] != "decision":
            continue
        a = e["args"]
        op, arm = a.get("op"), a.get("arm")
        nbytes = int(a.get("nbytes", 0))
        ndev = int(a.get("ndev", len(tl.ranks) or 1))
        expected = None
        for c, mn, mb, mode in rules:
            if c == op and ndev >= mn and nbytes >= mb:
                expected = mode
        if expected is None:
            continue
        checked += 1
        reason = str(a.get("reason", ""))
        if arm != expected and not reason.startswith(_VETO_PREFIXES):
            drift.append({"op": op, "rank": e["rank"], "nbytes": nbytes,
                          "ndev": ndev, "expected": expected,
                          "actual": arm, "reason": reason})
    return {"checked": checked, "drift_count": len(drift),
            "drift": drift}


# -- ring health -------------------------------------------------------------

def ring_health(tl: FleetTimeline) -> Dict[str, Any]:
    """Overflow accounting: a rank whose ring dropped events mid-capture
    lost its OLDEST events, so instance alignment (and therefore skew)
    for early collectives is untrustworthy on that rank."""
    overflowed = {r: n for r, n in tl.dropped.items() if n}
    return {"dropped_by_rank": dict(tl.dropped),
            "overflowed_ranks": sorted(overflowed),
            "skew_trustworthy": not overflowed}


# -- the full report ---------------------------------------------------------

def analyze(tl: FleetTimeline, rules: Optional[str] = None,
            z_thresh: float = 2.5) -> Dict[str, Any]:
    report = {
        "ranks": tl.ranks,
        "events": len(tl.events),
        "alignment": {
            "offsets_s": {str(r): v for r, v in tl.offsets.items()},
            "confidence_us": {str(r): round(v / 2 * 1e6, 3)
                              for r, v in tl.best_rtt.items()},
            "unaligned_ranks": list(getattr(tl, "unaligned_ranks", [])),
        },
        "entry_skew": entry_skew(tl, z_thresh=z_thresh),
        "latency": latency_histograms(tl),
        "pipeline": bubble_fraction(tl),
        "ring_health": ring_health(tl),
    }
    if rules:
        report["decision_drift"] = decision_drift(tl, rules)
    return report
