"""Serving plane — continuous-batching decode observability.

Counterpart of ``ompi_tpu/serving/__init__.py``.  The serving tier is a
continuous-batching inference engine over the decode weight layout
(``models/transformer.decode_param_specs``), with the decode matmul
combines dispatched as the audited coll names ``decode_ag`` /
``decode_rs`` so the decision layer's native|quant arms apply.  This
module is the plane's ledger:

* **counters** — ``serve_tokens`` / ``serve_active_seqs`` /
  ``serve_evictions`` / ``serve_kv_pages_used`` (``pvar_value``).
* **goodput split** — wall time attributed to prefill / decode / host
  (scheduler bookkeeping), plus decode tokens/s.
* **inter-token latency** — per-request deltas between consecutive
  emitted tokens (a bounded sample window), p50/p99 in ``report()``.
* **request table** — admit → prefill → decode → evict lifecycle rows
  (EOS vs max-len), bounded to the most recent requests.
* **speculative ledger** — verify windows, drafted and accepted tokens
  (``note_spec``): the MEASURED acceptance rate.
* **dispatch split** — eager decode collectives against fused-program
  rings (``note_dispatch``).
* **fleet ledger** — the replica table, the KV-page migration log and the
  router's decisions (``note_migration``, ``note_route``,
  ``update_replica``, ``fleet_report``; ``FLEET_PVARS``), and the
  per-replica admission bias the router reads on every assignment
  (``apply_route_weight``; the policy plane that sets it from the
  ``hot_replica`` sentry is ROADMAP P16).  The ledger is per process:
  the fleet feeds every process the same rows, so each holds the same
  table.

The compute pieces live in the submodules: ``cache`` (the paged KV
cache), ``engine`` (prefill/decode_step/decode_window and the decode_ag/rs
dispatch), ``fused`` (the fused decode program), ``scheduler``
(continuous vs static batching, speculative windows, the Poisson request
stream and the fleet router), ``fleet`` (replicas, prefill/decode
disaggregation and the KV-page migration), loaded lazily.  Every entry
point is behind one ``serving.enabled`` attribute read.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..core import var as _var

_var.register("serve", "", "enabled", False, type=bool, level=3,
              help="Master switch for the serving plane (request table, "
                   "goodput split, inter-token latency ledger). Off by "
                   "default; the disabled path is one attribute read "
                   "per engine/scheduler event.")
_var.register("serve", "", "latency_window", 4096, type=int, level=3,
              help="Inter-token latency samples kept for the p50/p99 "
                   "ledger (bounded ring; oldest samples drop first).")
_var.register("serve", "", "table_cap", 64, type=int, level=3,
              help="Request-lifecycle rows kept for the per-request "
                   "table (oldest finished rows drop first).")
_var.register("serve", "fleet", "table_cap", 64, type=int, level=3,
              help="Router-decision and migration-ledger rows kept "
                   "(oldest rows drop first).")

enabled: bool = bool(_var.get("serve_enabled", False))

PVARS = ("serve_tokens", "serve_active_seqs", "serve_evictions",
         "serve_kv_pages_used")
FLEET_PVARS = ("fleet_replicas", "fleet_migrations",
               "fleet_migrated_bytes", "fleet_rebalances")

_lock = threading.Lock()

# cumulative counters (pvars + report)
_tokens = 0                  # tokens emitted (prefill's first counts)
_evictions = 0
_active = 0                  # current in-flight sequences
_pages_used = 0              # current KV pages held (cache mirrors in)
_prefills = 0
_decode_steps = 0
_prefill_s = 0.0
_decode_s = 0.0
_host_s = 0.0
_occ_sum = 0.0               # sum over decode steps of active/slots
_spec_drafted = 0            # speculative: draft tokens proposed
_spec_accepted = 0           # speculative: draft tokens accepted
_spec_windows = 0            # speculative: verify windows run
_itl: List[float] = []       # inter-token deltas, seconds
_requests: "dict[Any, Dict[str, Any]]" = {}
_finished_order: List[Any] = []
_dispatches: Dict[str, int] = {"eager": 0}

# fleet ledger (multi-replica tier)
_fleet_replicas = 0          # replicas in the most recent fleet
_fleet_migrations = 0        # KV-page migrations (cross_reshard hops)
_fleet_migrated_bytes = 0    # wire bytes those migrations moved
_fleet_rebalances = 0        # route_weight applications (policy action)
_fleet_rows: Dict[int, Dict[str, Any]] = {}      # replica -> stats row
_fleet_migration_log: List[Dict[str, Any]] = []  # bounded ledger
_fleet_routes: List[Dict[str, Any]] = []         # bounded decision table
_fleet_route_bias: Dict[int, float] = {}         # replica -> multiplier


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def _on_enabled_var(v: Any) -> None:
    # mid-run OMPI_TPU_SERVE_ENABLED / set_cli writes take effect
    global enabled
    enabled = bool(v)


_var.watch("serve_enabled", _on_enabled_var)


def reset() -> None:
    global _tokens, _evictions, _active, _pages_used, _prefills, \
        _decode_steps, _prefill_s, _decode_s, _host_s, _occ_sum, \
        _spec_drafted, _spec_accepted, _spec_windows, \
        _fleet_replicas, _fleet_migrations, _fleet_migrated_bytes, \
        _fleet_rebalances
    with _lock:
        _fleet_replicas = 0
        _fleet_migrations = 0
        _fleet_migrated_bytes = 0
        _fleet_rebalances = 0
        _fleet_rows.clear()
        _fleet_migration_log.clear()
        _fleet_routes.clear()
        _fleet_route_bias.clear()
        _tokens = 0
        _evictions = 0
        _active = 0
        _pages_used = 0
        _prefills = 0
        _decode_steps = 0
        _prefill_s = 0.0
        _decode_s = 0.0
        _host_s = 0.0
        _occ_sum = 0.0
        _spec_drafted = 0
        _spec_accepted = 0
        _spec_windows = 0
        _dispatches.clear()
        _dispatches["eager"] = 0
        _itl.clear()
        _requests.clear()
        _finished_order.clear()


# -- lifecycle events (the engine/scheduler call these when enabled) --------

def note_admit(rid: Any, prompt_len: int, max_new: int,
               arrival: float, now: float) -> None:
    global _active
    with _lock:
        _active += 1
        _requests[rid] = {"rid": rid, "state": "prefill",
                          "prompt_len": int(prompt_len),
                          "max_new": int(max_new), "generated": 0,
                          "arrival": float(arrival),
                          "admitted": float(now),
                          "queue_wait_s": float(now - arrival),
                          "finished": None, "evict_reason": None,
                          "_last_token_t": None}
        if len(_requests) > int(_var.get("serve_table_cap", 64)):
            # drop the OLDEST finished row; live rows are never dropped
            for old in list(_finished_order):
                if old in _requests:
                    del _requests[old]
                    _finished_order.remove(old)
                    break


def note_prefill(dur_s: float, n_tokens: int) -> None:
    global _prefills, _prefill_s
    with _lock:
        _prefills += 1
        _prefill_s += float(dur_s)


def note_decode_step(dur_s: float, active: int, slots: int) -> None:
    global _decode_steps, _decode_s, _occ_sum
    with _lock:
        _decode_steps += 1
        _decode_s += float(dur_s)
        _occ_sum += active / max(slots, 1)


def note_host(dur_s: float) -> None:
    global _host_s
    with _lock:
        _host_s += float(dur_s)


def note_token(rid: Any, now: float) -> None:
    global _tokens
    with _lock:
        _tokens += 1
        row = _requests.get(rid)
        if row is None:
            return
        row["generated"] += 1
        row["state"] = "decode"
        last = row["_last_token_t"]
        if last is not None:
            _itl.append(float(now - last))
            cap = int(_var.get("serve_latency_window", 4096))
            if len(_itl) > cap:
                del _itl[: len(_itl) - cap]
        row["_last_token_t"] = float(now)


def note_evict(rid: Any, reason: str, now: float) -> None:
    global _active, _evictions
    with _lock:
        _active = max(_active - 1, 0)
        _evictions += 1
        row = _requests.get(rid)
        if row is not None:
            row["state"] = "done"
            row["finished"] = float(now)
            row["evict_reason"] = str(reason)
            _finished_order.append(rid)


def set_pages_used(n: int) -> None:
    global _pages_used
    with _lock:
        _pages_used = int(n)


def note_spec(drafted: int, accepted: int) -> None:
    """One speculative verify window: ``drafted`` tokens proposed by the
    draft source, ``accepted`` of them matched the target model's greedy
    choice (0 ≤ accepted ≤ drafted).  The MEASURED acceptance rate —
    accepted/drafted over the run — is never assumed."""
    global _spec_drafted, _spec_accepted, _spec_windows
    with _lock:
        _spec_drafted += int(drafted)
        _spec_accepted += int(accepted)
        _spec_windows += 1


def note_dispatch(mode: str, n: int = 1) -> None:
    """Count an eagerly dispatched decode collective (``mode="eager"``:
    decode_ag/decode_rs between the pieces) or a fused-program ring
    (``mode="fused"``: a decode_collmm site inside the fused program)."""
    with _lock:
        _dispatches[mode] = _dispatches.get(mode, 0) + int(n)


# -- fleet ledger (multi-replica tier) --------------------------------------

def set_fleet_replicas(n: int) -> None:
    global _fleet_replicas
    with _lock:
        _fleet_replicas = int(n)


def note_migration(rid: Any, src: int, dst: int, pages: int,
                   nbytes: int, peak_bytes: int, bound_bytes: int,
                   dur_s: float) -> None:
    """One KV-page migration: prefill replica ``src`` handed ``pages``
    finished pages (``nbytes`` on the wire through cross_reshard) to
    decode replica ``dst``; peak/bound come from the reshard plan, so the
    ledger shows every migration's standing under the
    ``reshard_peak_factor`` contract."""
    global _fleet_migrations, _fleet_migrated_bytes
    with _lock:
        _fleet_migrations += 1
        _fleet_migrated_bytes += int(nbytes)
        _fleet_migration_log.append({
            "rid": rid, "src": int(src), "dst": int(dst),
            "pages": int(pages), "bytes": int(nbytes),
            "peak_bytes": int(peak_bytes),
            "bound_bytes": int(bound_bytes),
            "within_bound": int(peak_bytes) <= int(bound_bytes),
            "dur_ms": 1e3 * float(dur_s),
        })
        cap = int(_var.get("serve_fleet_table_cap", 64))
        if len(_fleet_migration_log) > cap:
            del _fleet_migration_log[: len(_fleet_migration_log) - cap]


def note_route(rid: Any, replica: int, weights: List[float]) -> None:
    """One router admission decision: request ``rid`` assigned to
    ``replica`` under the effective (bias-adjusted) weight vector."""
    with _lock:
        _fleet_routes.append({"rid": rid, "replica": int(replica),
                              "weights": [round(float(w), 6)
                                          for w in weights]})
        cap = int(_var.get("serve_fleet_table_cap", 64))
        if len(_fleet_routes) > cap:
            del _fleet_routes[: len(_fleet_routes) - cap]


def update_replica(replica: int, row: Dict[str, Any]) -> None:
    """Merge a per-replica stats row (role, requests, tokens, goodput,
    ITL percentiles, occupancy) into the fleet table."""
    with _lock:
        cur = _fleet_rows.setdefault(int(replica),
                                     {"replica": int(replica)})
        cur.update(row)


def fleet_route_bias(replica: int) -> float:
    """Admission-weight multiplier for ``replica`` (1.0 until a
    route_weight action downweights it)."""
    with _lock:
        return float(_fleet_route_bias.get(int(replica), 1.0))


def apply_route_weight(replica: int, scale: float) -> Optional[float]:
    """The ``route_weight`` action: scale ``replica``'s admission bias by
    ``scale`` (the router reads the bias on every assignment).  Returns
    the new bias, or None when the replica is unknown to the fleet table
    (a no-op).  Every process of a fleet applies it, so that their
    routers stay the same."""
    global _fleet_rebalances
    with _lock:
        if _fleet_rows and int(replica) not in _fleet_rows:
            return None
        new = _fleet_route_bias.get(int(replica), 1.0) * float(scale)
        _fleet_route_bias[int(replica)] = new
        _fleet_rebalances += 1
        return new


def fleet_pvar_value(name: str) -> float:
    with _lock:
        if name == "fleet_replicas":
            return float(_fleet_replicas)
        if name == "fleet_migrations":
            return float(_fleet_migrations)
        if name == "fleet_migrated_bytes":
            return float(_fleet_migrated_bytes)
        if name == "fleet_rebalances":
            return float(_fleet_rebalances)
    raise KeyError(name)


def fleet_report() -> Dict[str, Any]:
    """Structured fleet state: the replica table (with each replica's
    route bias), the migration ledger and the router's decisions."""
    with _lock:
        rows = [dict(_fleet_rows[r]) for r in sorted(_fleet_rows)]
        for row in rows:
            row["route_bias"] = float(
                _fleet_route_bias.get(int(row["replica"]), 1.0))
        return {
            "replicas": _fleet_replicas,
            "migrations": _fleet_migrations,
            "migrated_bytes": _fleet_migrated_bytes,
            "rebalances": _fleet_rebalances,
            "replica_rows": rows,
            "migration_log": [dict(m) for m in _fleet_migration_log],
            "routes": [dict(r) for r in _fleet_routes],
        }


# -- pvar read-through + report ---------------------------------------------

def pvar_value(name: str) -> float:
    if name in FLEET_PVARS:
        return fleet_pvar_value(name)
    with _lock:
        if name == "serve_tokens":
            return float(_tokens)
        if name == "serve_active_seqs":
            return float(_active)
        if name == "serve_evictions":
            return float(_evictions)
        if name == "serve_kv_pages_used":
            return float(_pages_used)
    raise KeyError(name)


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(int(round(q * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[k]


def report() -> Dict[str, Any]:
    """Structured plane state."""
    with _lock:
        itl = sorted(_itl)
        total = _prefill_s + _decode_s + _host_s
        rows = [{k: v for k, v in row.items() if not k.startswith("_")}
                for row in _requests.values()]
        return {
            "tokens": _tokens,
            "active_seqs": _active,
            "evictions": _evictions,
            "kv_pages_used": _pages_used,
            "prefills": _prefills,
            "decode_steps": _decode_steps,
            "batch_occupancy": _occ_sum / max(_decode_steps, 1),
            "goodput": {
                "prefill_s": round(_prefill_s, 6),
                "decode_s": round(_decode_s, 6),
                "host_s": round(_host_s, 6),
                "total_s": round(total, 6),
                "prefill_pct": 100.0 * _prefill_s / total if total else 0.0,
                "decode_pct": 100.0 * _decode_s / total if total else 0.0,
                "host_pct": 100.0 * _host_s / total if total else 0.0,
                "decode_tokens_per_s": (_tokens / _decode_s
                                        if _decode_s else 0.0),
            },
            "itl": {
                "count": len(itl),
                "p50_ms": 1e3 * _percentile(itl, 0.50),
                "p99_ms": 1e3 * _percentile(itl, 0.99),
                "mean_ms": (1e3 * sum(itl) / len(itl)) if itl else 0.0,
            },
            "speculative": {
                "windows": _spec_windows,
                "drafted": _spec_drafted,
                "accepted": _spec_accepted,
                "acceptance_rate": (_spec_accepted / _spec_drafted
                                    if _spec_drafted else 0.0),
            },
            "dispatches": dict(_dispatches),
            "requests": rows,
        }


# the engine/scheduler/cache modules import torch — load them lazily
def __getattr__(name: str):
    if name == "ServingEngine":
        from .engine import ServingEngine
        return ServingEngine
    if name == "PagedKVCache":
        from .cache import PagedKVCache
        return PagedKVCache
    if name in ("ContinuousBatchingScheduler", "Request", "poisson_stream",
                "FleetRouter"):
        from . import scheduler as _sched
        return getattr(_sched, name)
    if name == "ServingFleet":
        from .fleet import ServingFleet
        return ServingFleet
    raise AttributeError(name)
