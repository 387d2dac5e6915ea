"""Request plane — end-to-end per-request lifecycle observability.

The port's copy of ``ompi_tpu/serving/requests.py``.

Every existing plane observes *components* (ranks, collectives,
replicas); this one follows the REQUEST.  A request-scoped trace
context (rid) is threaded through every stage of the fleet path —
admit → route decision (with the router's effective weight snapshot as
structured evidence) → queue wait → prefill span → KV-migration span →
decode-join wait → per-token emit instants — and every emitted event
carries a ``rid=`` tag (comm-lint rule CL008), so ``trace.merge``'s
clock alignment stitches one globally ordered span tree per request
even when its stages ran on disjoint tp submeshes.

The ledger keeps three things, all bounded:

* **stage histograms** — per-stage duration samples (queue / prefill /
  migrate / join / decode), the p50/p99 table and the
  ``ompi_tpu_request_stage_seconds{stage,quantile}`` Prometheus family.
* **tail exemplars** — full span trees kept only for the slowest-k
  reservoir plus every SLO breach; everything else collapses into the
  histograms so the ring survives production QPS.  The reservoir is
  deterministic: identical request streams keep identical exemplars.
* **SLO judge** — declarative TTFT / per-request ITL p99 / e2e targets
  (0 = disabled).  A breach attributes the request's critical path to
  the stage with the largest excess over its own histogram median, and
  publishes ONE ``slo_breach`` verdict per excursion episode onto the
  policy bus with the attributed stage + decode replica as evidence —
  the pre-verified ``route_weight`` action then fires on the stage
  that is actually hot (re-armed when a request meets SLO again).

Stage durations run on the scheduler's VIRTUAL clock (the same clock
the serving ledger's queue-wait and ITL numbers use), so the
conservation law ``sum(stages) == e2e`` holds exactly in-process and
within clock confidence (±best_rtt/2) after a merge across ranks —
``trace.critical`` re-derives and checks it from the trace alone.

Every producer call site is gated on ONE ``requests.enabled`` attribute
read.  In the port every tp rank of a replica runs the replica's
scheduler, so the schedulers record a request's events on one process
only, the first rank of the replica that owns the request (the rank
whose row the fleet shares), each event's ``rank`` the replica lane, as
in the reference (``trace.merge.gather`` ships those lanes with the
process's own).

The ``slo_breach`` verdict rides the policy plane's bus, which comes with
ROADMAP slice P16b: a breach that opens an episode is recorded (the
breach and episode counters, the exemplar, the ``req:e2e`` span's
``breach`` flag), then ``note_finish`` raises ``NotImplementedError``.
The chaos variables (``serve_req_chaos_migrate_ms``,
``serve_req_chaos_prefill_scale``) are registered by ``serving.fleet``,
their only reader.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, List, Optional

from .. import trace as _trace
from ..core import var as _var

_var.register("serve", "req", "enabled", False, type=bool, level=3,
              help="Master switch for the request plane (per-request "
                   "stage spans, tail exemplars, SLO judge). Off by "
                   "default; the disabled path is one attribute read "
                   "per scheduler/fleet event.")
_var.register("serve", "req", "exemplar_k", 8, type=int, level=3,
              help="Slowest-k reservoir size for full request span "
                   "trees; SLO-breach exemplars are always kept on top "
                   "of the k slowest (both bounded by serve_table_cap).")
_var.register("serve", "req", "slo_ttft_ms", 0.0, type=float, level=3,
              help="Time-to-first-token SLO target in ms (0 disables). "
                   "A finished request exceeding it counts as a breach "
                   "and is judged for stage attribution.")
_var.register("serve", "req", "slo_itl_ms", 0.0, type=float, level=3,
              help="Per-request inter-token-latency p99 SLO target in "
                   "ms (0 disables).")
_var.register("serve", "req", "slo_e2e_ms", 0.0, type=float, level=3,
              help="End-to-end (arrival to finish) SLO target in ms "
                   "(0 disables).")
enabled: bool = bool(_var.get("serve_req_enabled", False))

PVARS = ("req_active", "req_completed", "req_slo_breaches",
         "req_exemplars_kept")

#: canonical stage vocabulary, in lifecycle order
STAGES = ("queue", "prefill", "migrate", "join", "decode")

_lock = threading.Lock()

_reqs: Dict[Any, Dict[str, Any]] = {}            # in-flight rid -> rec
_pending_routes: Dict[Any, Dict[str, Any]] = {}  # routed, not yet admitted
_stage_hist: Dict[str, List[float]] = {}         # stage -> dur samples (s)
_e2e: List[float] = []                           # completed e2e walls (s)
_exemplars: List[Dict[str, Any]] = []            # kept span trees
_completed = 0
_breaches = 0
_episodes = 0
_episode_open = False


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def _on_enabled_var(v: Any) -> None:
    # mid-run OMPI_TPU_SERVE_REQ_ENABLED / set_cli writes take effect
    global enabled
    enabled = bool(v)


_var.watch("serve_req_enabled", _on_enabled_var)


def reset() -> None:
    global _completed, _breaches, _episodes, _episode_open
    with _lock:
        _reqs.clear()
        _pending_routes.clear()
        _stage_hist.clear()
        _e2e.clear()
        _exemplars.clear()
        _completed = 0
        _breaches = 0
        _episodes = 0
        _episode_open = False


def flow_id(rid: Any) -> int:
    """Stable Chrome-trace flow id for a request (the arrow chain that
    links its prefill → migration → decode hand-offs across lanes)."""
    try:
        return int(rid)
    except (TypeError, ValueError):
        return zlib.crc32(str(rid).encode())


# -- lifecycle (scheduler/fleet call these behind `requests.enabled`) -------

def note_route(rid: Any, replica: int, weights: List[float],
               t: Optional[float] = None) -> None:
    """One router admission decision, recorded as a DECISION event with
    the effective weight snapshot as structured evidence — "why this
    replica" is answerable from the trace alone, not just the doctor
    table."""
    snap = {"replica": int(replica),
            "weights": [round(float(w), 6) for w in weights]}
    with _lock:
        _pending_routes[rid] = snap
        if len(_pending_routes) > 4 * int(_var.get("serve_table_cap", 64)):
            _pending_routes.pop(next(iter(_pending_routes)))
    if _trace.enabled:
        _trace.decision("route", arm=f"replica={int(replica)}",
                        reason="learned:dwrr-goodput", nbytes=0,
                        rank=int(replica), t=t, verdict=None, rid=rid,
                        weights=snap["weights"])


def note_admit(rid: Any, arrival: float, now: float, prompt_len: int,
               max_new: int, replica: int = 0,
               rank: Optional[int] = None) -> None:
    """Request admitted at virtual time ``now``; the elapsed
    ``now - arrival`` is its queue-wait stage.  ``replica`` is the
    owning (decode) replica; ``rank`` the lane the queue span renders
    on (defaults to ``replica``)."""
    rank = int(replica if rank is None else rank)
    with _lock:
        route = _pending_routes.pop(rid, None)
        _reqs[rid] = {
            "rid": rid, "arrival": float(arrival),
            "admitted": float(now), "prompt_len": int(prompt_len),
            "max_new": int(max_new), "replica": int(replica),
            "route": route, "stages": {}, "spans": [], "tokens": 0,
            "first_token": None, "_last_token": None, "itl": [],
        }
    note_stage(rid, "queue", arrival, now, rank=rank)
    if _trace.enabled:
        _trace.instant("req:admit", "req", rank=rank,
                       args={"rid": rid, "prompt_len": int(prompt_len),
                             "max_new": int(max_new)}, t=now)


def note_stage(rid: Any, stage: str, t0: float, t1: float,
               rank: Optional[int] = None, **extra: Any) -> None:
    """One completed lifecycle stage on the virtual clock.  Emits the
    rid-tagged ``req:<stage>`` span and, for the migration hand-off,
    the Chrome-trace flow arrows (prefill → migration on the source
    lane, migration → decode closed by the join stage)."""
    dur = max(0.0, float(t1) - float(t0))
    with _lock:
        rec = _reqs.get(rid)
        if rec is None:
            return
        if rank is None:
            rank = rec["replica"]
        rec["stages"][stage] = rec["stages"].get(stage, 0.0) + dur
        rec["spans"].append({"stage": stage, "t0": float(t0),
                             "t1": float(t1), "rank": int(rank),
                             **{k: v for k, v in extra.items()}})
    if _trace.enabled:
        _trace.record_span(f"req:{stage}", "req", float(t0), float(t1),
                           rank=int(rank),
                           args={"rid": rid, **extra})
        fid = flow_id(rid)
        if stage == "migrate":
            src = int(extra.get("src", rank))
            _trace.flow("req:handoff", "req", fid, "s", rank=src,
                        t=float(t0), args={"rid": rid})
            _trace.flow("req:handoff", "req", fid, "t", rank=src,
                        t=float(t1), args={"rid": rid})
        elif stage == "join":
            _trace.flow("req:handoff", "req", fid, "f", rank=int(rank),
                        t=float(t1), args={"rid": rid})


def note_token(rid: Any, t: float, rank: Optional[int] = None) -> None:
    with _lock:
        rec = _reqs.get(rid)
        if rec is None:
            return
        rec["tokens"] += 1
        if rec["first_token"] is None:
            rec["first_token"] = float(t)
        last = rec["_last_token"]
        if last is not None:
            rec["itl"].append(float(t) - last)
        rec["_last_token"] = float(t)
        if rank is None:
            rank = rec["replica"]
        n = rec["tokens"]
    if _trace.enabled:
        _trace.instant("req:token", "req", rank=int(rank),
                       args={"rid": rid, "n": n}, t=float(t))


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(int(round(q * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[k]


def _attribute(stages: Dict[str, float]) -> Optional[str]:
    """Critical-path attribution: the stage with the largest excess
    over its own histogram median (argmax duration when no history) —
    a uniformly slow request blames its genuinely dominant stage, a
    degraded lane blames the degraded stage."""
    best, best_excess = None, float("-inf")
    for name, dur in stages.items():
        hist = _stage_hist.get(name)
        med = _percentile(sorted(hist), 0.50) if hist else 0.0
        excess = float(dur) - med
        if excess > best_excess:
            best, best_excess = name, excess
    return best


def _judge(ttft_ms: float, itl_p99_ms: float,
           e2e_ms: float) -> List[Dict[str, float]]:
    out = []
    for metric, value, vname in (
            ("ttft", ttft_ms, "serve_req_slo_ttft_ms"),
            ("itl_p99", itl_p99_ms, "serve_req_slo_itl_ms"),
            ("e2e", e2e_ms, "serve_req_slo_e2e_ms")):
        target = float(_var.get(vname, 0.0))
        if target > 0.0 and value > target:
            out.append({"metric": metric, "value_ms": round(value, 6),
                        "target_ms": target})
    return out


def _prune_exemplars_locked() -> None:
    k = max(0, int(_var.get("serve_req_exemplar_k", 8)))
    cap = max(k, int(_var.get("serve_table_cap", 64)))
    clean = [e for e in _exemplars if not e["breach"]]
    clean.sort(key=lambda e: (-e["e2e_ms"], str(e["rid"])))
    keep = [e for e in _exemplars if e["breach"]] + clean[:k]
    if len(keep) > cap:
        keep.sort(key=lambda e: (-e["e2e_ms"], str(e["rid"])))
        keep = keep[:cap]
    keep_ids = {id(e) for e in keep}
    _exemplars[:] = [e for e in _exemplars if id(e) in keep_ids]


def note_finish(rid: Any, t: float, reason: str = "eos") -> None:
    """Request finished at virtual time ``t``: close the decode stage
    (the remainder after the last explicit stage), run the SLO judge,
    fold the stages into the histograms, update the exemplar reservoir
    and — on the first breach of an excursion — publish the
    ``slo_breach`` verdict with the attributed stage as evidence."""
    global _completed, _breaches, _episodes, _episode_open
    with _lock:
        rec = _reqs.pop(rid, None)
    if rec is None:
        return
    arrival = rec["arrival"]
    decode_t0 = arrival + sum(rec["stages"].values())
    rank = int(rec["replica"])
    note_decode = max(0.0, float(t) - decode_t0)
    rec["stages"]["decode"] = note_decode
    rec["spans"].append({"stage": "decode", "t0": decode_t0,
                         "t1": float(t), "rank": rank})
    e2e = max(0.0, float(t) - arrival)
    ttft_ms = 1e3 * ((rec["first_token"] - arrival)
                     if rec["first_token"] is not None else e2e)
    itl_ms = 1e3 * _percentile(sorted(rec["itl"]), 0.99)
    breach = _judge(ttft_ms, itl_ms, 1e3 * e2e)
    with _lock:
        attributed = _attribute(rec["stages"])
        stage_sum = sum(rec["stages"].values())
        summary = {
            "rid": rid, "replica": rank, "reason": str(reason),
            "prompt_len": rec["prompt_len"], "max_new": rec["max_new"],
            "tokens": rec["tokens"], "arrival": arrival,
            "finished": float(t), "e2e_ms": round(1e3 * e2e, 6),
            "ttft_ms": round(ttft_ms, 6),
            "itl_p99_ms": round(itl_ms, 6),
            "breach": breach, "attributed_stage": attributed,
            "stages_ms": {k: round(1e3 * v, 6)
                          for k, v in rec["stages"].items()},
            "spans": list(rec["spans"]), "route": rec["route"],
            "conservation": {
                "stage_sum_ms": round(1e3 * stage_sum, 6),
                "e2e_ms": round(1e3 * e2e, 6),
                "resid_ms": round(1e3 * abs(stage_sum - e2e), 9),
            },
        }
        cap = int(_var.get("serve_latency_window", 4096))
        for name, dur in rec["stages"].items():
            hist = _stage_hist.setdefault(name, [])
            hist.append(float(dur))
            if len(hist) > cap:
                del hist[: len(hist) - cap]
        _e2e.append(e2e)
        if len(_e2e) > cap:
            del _e2e[: len(_e2e) - cap]
        _completed += 1
        publish = False
        if breach:
            _breaches += 1
            if not _episode_open:
                _episode_open = True
                _episodes += 1
                publish = True
        else:
            _episode_open = False          # re-arm the episode
        _exemplars.append(summary)
        _prune_exemplars_locked()
    if _trace.enabled:
        # comm-lint: disable=CL002 virtual-time remainder span (decode_t0..t are scheduler clocks, not a wall-clock timed region)
        _trace.record_span("req:decode", "req", decode_t0, float(t),
                           rank=rank, args={"rid": rid})
        # comm-lint: disable=CL002 virtual-time envelope (arrival..t are scheduler clocks, not a wall-clock region timed around _judge)
        _trace.record_span("req:e2e", "req", arrival, float(t), rank=rank,
                           args={"rid": rid, "reason": str(reason),
                                 "tokens": rec["tokens"],
                                 "breach": bool(breach)})
    if publish:
        worst = breach[0]
        raise NotImplementedError(
            f"requests.note_finish: request {rid!r} breached its "
            f"{worst['metric']} SLO ({worst['value_ms']} ms > "
            f"{worst['target_ms']} ms, stage {attributed}); the "
            "slo_breach verdict rides the policy plane's bus, which comes "
            "with ROADMAP slice P16b")


# -- pvar read-through + exporters ------------------------------------------

def pvar_value(name: str) -> float:
    with _lock:
        if name == "req_active":
            return float(len(_reqs))
        if name == "req_completed":
            return float(_completed)
        if name == "req_slo_breaches":
            return float(_breaches)
        if name == "req_exemplars_kept":
            return float(len(_exemplars))
    raise KeyError(name)


def prometheus_rows(rank: int = 0, comm: str = "world",
                    prefix: str = "ompi_tpu") -> List[str]:
    """Per-stage latency quantile family for the Prometheus exporter:
    ``<prefix>_request_stage_seconds{stage,quantile}`` (seconds, the
    exporter's base unit)."""
    with _lock:
        stages = {k: sorted(v) for k, v in _stage_hist.items() if v}
    if not stages:
        return []
    name = f"{prefix}_request_stage_seconds"
    rows = [f"# HELP {name} Per-stage request latency quantiles "
            "(request plane).",
            f"# TYPE {name} gauge"]
    for stage in sorted(stages):
        for q in (0.5, 0.99):
            val = _percentile(stages[stage], q)
            rows.append(f'{name}{{rank="{int(rank)}",comm="{comm}",'
                        f'stage="{stage}",quantile="{q:g}"}} {val:.9g}')
    return rows


def report() -> Dict[str, Any]:
    """Structured plane state for comm_doctor --requests / bench --slo."""
    with _lock:
        e2e = sorted(_e2e)
        stage_rows = {}
        for stage in STAGES:
            hist = _stage_hist.get(stage)
            if not hist:
                continue
            s = sorted(hist)
            stage_rows[stage] = {
                "count": len(s),
                "p50_ms": round(1e3 * _percentile(s, 0.50), 6),
                "p99_ms": round(1e3 * _percentile(s, 0.99), 6),
            }
        rollup: Dict[str, int] = {}
        for e in _exemplars:
            st = e.get("attributed_stage")
            if st is not None:
                rollup[st] = rollup.get(st, 0) + 1
        breach_rollup: Dict[str, int] = {}
        for e in _exemplars:
            if e["breach"] and e.get("attributed_stage") is not None:
                st = e["attributed_stage"]
                breach_rollup[st] = breach_rollup.get(st, 0) + 1
        return {
            "enabled": enabled,
            "active": len(_reqs),
            "completed": _completed,
            "slo_breaches": _breaches,
            "episodes": _episodes,
            "exemplars_kept": len(_exemplars),
            "slo": {
                "ttft_ms": float(_var.get("serve_req_slo_ttft_ms", 0.0)),
                "itl_p99_ms": float(_var.get("serve_req_slo_itl_ms", 0.0)),
                "e2e_ms": float(_var.get("serve_req_slo_e2e_ms", 0.0)),
            },
            "e2e": {
                "count": len(e2e),
                "p50_ms": round(1e3 * _percentile(e2e, 0.50), 6),
                "p99_ms": round(1e3 * _percentile(e2e, 0.99), 6),
            },
            "stages": stage_rows,
            "tail_attribution": rollup,
            "breach_attribution": breach_rollup,
            "exemplars": [dict(e) for e in _exemplars],
        }
