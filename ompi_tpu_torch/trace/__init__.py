"""ompi_tpu_torch.trace — unified tracing + decision audit.

The port's copy of ``ompi_tpu/trace/__init__.py``.  One event schema
shared by every instrumented layer:

  * ``coll/framework``        — one ``enter:<coll>`` arrival instant per
    rank per collective (category ``coll-enter``), the timestamp the fleet
    skew analysis keys on.
  * ``coll/nccl``             — one DECISION instant per device-dispatched
    collective: op, shape bucket, per-rank bytes, the arm chosen
    (native | staged | quant | hier | hier+quant) and the precedence link
    that chose it (force var > blanket switch > rules row > byte floor >
    platform default).  ``explain_last(op)`` returns the most recent one.
    The port runs one process per rank, so each process records its own
    decision (``rank`` = its world rank) where the reference's single
    controller records one for the whole mesh.
  * ``parallel/overlap``      — one DECISION instant per grad-sync
    bucket (``explain_last("grad_sync")``) and per collective-matmul call
    (``explain_last("collmm")``); a measured ``grad_sync:run`` span with
    per-bucket spans (their even subdivision, marked ``synthetic``).
  * the perf and traffic sentries — ``perf_regression``,
    ``traffic_hotlink`` and ``traffic_plane_imbalance`` instants.

Cost contract: every instrumented call site is gated on the module-level
``trace.enabled`` flag — ONE attribute read on the disabled path, no
argument construction, no locking.  Recording goes into a fixed-capacity
per-rank ring buffer; overflow overwrites the oldest event and counts
``trace_dropped_events`` (read through by ``spc``).

Exporters: ``save_chrome(path)`` writes Chrome-trace JSON (object form,
perfetto-loadable; pid = rank, tid = one lane per category so nested
spans from different layers never collide), ``stats()``/``format_stats()``
aggregate counts and span time per (category, name).

Fleet view: ``trace.merge`` assembles every rank's ring into one
clock-aligned ``FleetTimeline`` (in-band ``gather(comm)`` or
post-mortem ``load_chrome``) and ``trace.analyze`` computes entry-skew /
straggler / bubble / decision-drift reports over it.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, List, Optional

from ..core import var as _var

_var.register("trace", "", "enabled", False, type=bool, level=3,
              help="Record trace events (spans, instants, collective "
                   "decision audits) into the per-rank ring buffers; "
                   "off = one flag check per instrumented call site.")
_var.register("trace", "", "buffer_events", 65536, type=int, level=4,
              help="Per-rank trace ring-buffer capacity in events; "
                   "overflow overwrites the oldest event and counts "
                   "the trace_dropped_events pvar.")

# THE gate.  Call sites do `if trace.enabled:` and nothing else on the
# disabled path — keep this a plain module attribute, not a function.
enabled: bool = bool(_var.get("trace_enabled", False))

_lock = threading.Lock()
_capacity: int = max(1, int(_var.get("trace_buffer_events", 65536)))
_rings: Dict[int, "_Ring"] = {}
_dropped: int = 0
_last: Dict[str, Dict[str, Any]] = {}      # op -> most recent decision
_t0: float = time.perf_counter()           # trace epoch (ts origin)


class _Ring:
    """Fixed-capacity overwrite-oldest event buffer (one per rank)."""

    __slots__ = ("buf", "cap", "idx", "n", "dropped")

    def __init__(self, cap: int) -> None:
        self.cap = max(1, int(cap))
        self.buf: List[Optional[dict]] = [None] * self.cap
        self.idx = 0
        self.n = 0
        self.dropped = 0          # events THIS rank lost to overflow

    def append(self, ev: dict) -> bool:
        """Store ``ev``; True when an old event was overwritten."""
        overwrote = self.n == self.cap
        self.buf[self.idx] = ev
        self.idx = (self.idx + 1) % self.cap
        if not overwrote:
            self.n += 1
        else:
            self.dropped += 1
        return overwrote

    def events(self) -> List[dict]:
        if self.n < self.cap:
            return list(self.buf[:self.n])
        return self.buf[self.idx:] + self.buf[:self.idx]


# -- recording ---------------------------------------------------------------

def _set_capacity(cap: int) -> None:
    global _capacity
    cap = max(1, int(cap))
    with _lock:
        if cap != _capacity:
            _capacity = cap
            _rings.clear()


def enable(capacity: Optional[int] = None) -> None:
    """Switch tracing on.  ``capacity`` resizes the per-rank rings; with
    no argument the current ``trace_buffer_events`` variable is re-read
    (so an env/CLI/cvar write between calls takes effect).  Resizing
    drops already-recorded events."""
    global enabled
    _set_capacity(capacity if capacity is not None
                  else _var.get("trace_buffer_events", 65536))
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


# A cvar write to trace_enabled/trace_buffer_events must take effect even
# though the hot-path gate is a snapshotted module attribute: the registry
# notifies on CHANGE only, so the disabled path stays one attribute read
# and enable()/disable() calls (which bypass the vars) are not clobbered
# by unrelated reset_cache() passes.
def _on_enabled_var(v: Any) -> None:
    global enabled
    enabled = bool(v)


_var.watch("trace_enabled", _on_enabled_var)
_var.watch("trace_buffer_events", _set_capacity)


def clear() -> None:
    """Drop all recorded events, decisions and the dropped counter."""
    global _dropped
    with _lock:
        _rings.clear()
        _last.clear()
        _dropped = 0


def _emit(ev: dict) -> None:
    global _dropped
    with _lock:
        ring = _rings.get(ev["rank"])
        if ring is None:
            ring = _rings[ev["rank"]] = _Ring(_capacity)
        if ring.append(ev):
            _dropped += 1


def instant(name: str, cat: str = "event", rank: int = 0,
            args: Optional[dict] = None, t: Optional[float] = None) -> None:
    _emit({"name": name, "cat": cat, "ph": "i",
           "t": time.perf_counter() if t is None else t,
           "rank": int(rank), "args": args or {}})


_FLOW_PHASES = ("s", "t", "f")


def flow(name: str, cat: str, fid: int, ph: str, rank: int = 0,
         t: Optional[float] = None, args: Optional[dict] = None) -> None:
    """Record one Chrome-trace flow event — the arrow primitive that links
    work across (pid, tid) lanes.  ``ph`` is "s" (start), "t" (step) or
    "f" (finish); events sharing (cat, fid) render as one arrow chain in
    Perfetto.  Flow events are zero-duration, so the per-lane span
    non-overlap invariant is untouched."""
    if ph not in _FLOW_PHASES:
        raise ValueError(f"flow phase must be one of {_FLOW_PHASES}: {ph!r}")
    _emit({"name": name, "cat": cat, "ph": ph, "id": int(fid),
           "t": time.perf_counter() if t is None else t,
           "rank": int(rank), "args": args or {}})


# One downstream consumer may register for span completions (the perf
# cost model ingests grad_sync bucket spans this way).  A sink failure
# must never take down the traced operation itself.
_span_sink = None


def set_span_sink(fn) -> None:
    """Register ``fn(name, cat, t_begin, t_end, args)`` to observe every
    recorded span (None unregisters)."""
    global _span_sink
    _span_sink = fn


def record_span(name: str, cat: str, t_begin: float, t_end: float,
                rank: int = 0, args: Optional[dict] = None) -> None:
    """Record an already-timed complete span (perf_counter() endpoints)."""
    _emit({"name": name, "cat": cat, "ph": "X", "t": t_begin,
           "dur": max(0.0, t_end - t_begin), "rank": int(rank),
           "args": args or {}})
    if _span_sink is not None:
        try:
            _span_sink(name, cat, t_begin, t_end, args)
        except Exception:
            pass


class span:
    """Context manager recording one complete span on exit.  Construct it
    only behind a ``trace.enabled`` check — building ``args`` is the cost.
    A body that raises still closes the span, tagged ``status=error`` —
    downstream consumers (the perf cost model) must never mistake a
    stalled-then-raised collective (e.g. WatchdogTimeoutError) for a
    latency sample."""

    __slots__ = ("name", "cat", "rank", "args", "_begin")

    def __init__(self, name: str, cat: str = "span", rank: int = 0,
                 args: Optional[dict] = None) -> None:
        self.name, self.cat, self.rank, self.args = name, cat, rank, args

    def __enter__(self) -> "span":
        self._begin = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        args = self.args
        if exc and exc[0] is not None:
            args = dict(args or {})
            args["status"] = "error"
        record_span(self.name, self.cat, self._begin, time.perf_counter(),
                    self.rank, args)
        return False


def decision(op: str, arm: str, reason: str, nbytes: int, rank: int = 0,
             t: Optional[float] = None, **details: Any) -> None:
    """Record one collective decision-audit event and remember it for
    ``explain_last(op)``."""
    rec = {"op": op, "arm": arm, "reason": reason, "nbytes": int(nbytes),
           "rank": int(rank)}
    rec.update(details)
    with _lock:
        _last[op] = rec
    _emit({"name": f"decide:{op}", "cat": "decision", "ph": "i",
           "t": time.perf_counter() if t is None else t,
           "rank": int(rank), "args": rec})


def explain_last(op: str) -> Optional[Dict[str, Any]]:
    """Full precedence evaluation of the most recent decision for ``op``:
    arm, reason (the link that chose it) and ``chain`` (every vetoed or
    skipped link on the way).  None when no decision has been recorded
    (e.g. tracing was off when the collective ran)."""
    with _lock:
        rec = _last.get(op)
    return dict(rec) if rec is not None else None


def last_decisions() -> Dict[str, Dict[str, Any]]:
    """Every op's most recent decision-audit record (the explain_last
    table in one read) — what the health watchdog folds into its
    flight-recorder dump."""
    with _lock:
        return {op: dict(rec) for op, rec in _last.items()}


# -- accessors ---------------------------------------------------------------

def events(rank: Optional[int] = None) -> List[dict]:
    with _lock:
        if rank is not None:
            ring = _rings.get(int(rank))
            return ring.events() if ring is not None else []
        out: List[dict] = []
        for r in sorted(_rings):
            out.extend(_rings[r].events())
    out.sort(key=lambda e: e["t"])
    return out


def dropped_events(rank: Optional[int] = None) -> int:
    """Events lost to ring overflow since the last clear().  With no
    ``rank``: process-wide total (the ``trace_dropped_events`` pvar);
    with a rank: that rank's ring alone — the per-rank split the fleet
    doctor needs to tell WHOSE skew numbers an overflow poisoned."""
    if rank is None:
        return _dropped
    with _lock:
        ring = _rings.get(int(rank))
        return ring.dropped if ring is not None else 0


def dropped_by_rank() -> Dict[int, int]:
    """Per-rank dropped-event counts (ranks with a ring only)."""
    with _lock:
        return {r: ring.dropped for r, ring in sorted(_rings.items())}


# -- exporters ---------------------------------------------------------------

def _jsonable(d: Optional[dict]) -> dict:
    out: Dict[str, Any] = {}
    for k, v in (d or {}).items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
        elif isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool))
                      or x is None else repr(x) for x in v]
        else:
            out[k] = repr(v)
    return out


def _us(dt: float) -> int:
    """Whole µs of ``dt`` seconds: rounded to integer ns, then floored."""
    return int(round(dt * 1e9)) // 1000


def chrome_doc(evs: List[dict], t0: float) -> dict:
    """Build a Chrome-trace document (object form with a ``traceEvents``
    list — loadable in perfetto / chrome://tracing) from event dicts.

    pid = rank; tid = one lane per event category, so spans from
    different layers never overlap within a (pid, tid) lane.  Timestamps
    are µs since ``t0``: each time is first rounded to whole nanoseconds,
    then floored to µs, so a span that ends where the next one starts
    keeps ending there after a file round trip and any clock offsets (the
    float noise of ``ts / 1e6 - offset`` stays far below a nanosecond,
    where one floor straight to µs could split the two by 1 µs).
    Shared by :func:`save_chrome` (this process's rings, trace epoch
    origin) and ``trace.merge`` (offset-aligned fleet timeline, earliest
    event origin)."""
    tids: Dict[str, int] = {}
    pids = set()
    rows: List[dict] = []
    for e in evs:
        tid = tids.get(e["cat"])
        if tid is None:
            tid = tids[e["cat"]] = len(tids) + 1
        pids.add(e["rank"])
        ts = _us(e["t"] - t0)
        row = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
               "ts": ts, "pid": e["rank"], "tid": tid,
               "args": _jsonable(e["args"])}
        if e["ph"] == "X":
            # both endpoints through _us: ordered spans stay
            # non-overlapping after the rounding
            row["dur"] = max(0, _us(e["t"] + e["dur"] - t0) - ts)
        elif e["ph"] == "i":
            row["s"] = "t"
        elif e["ph"] in _FLOW_PHASES:
            # flow arrows bind by (cat, id); "bp":"e" attaches the
            # finish end to the enclosing slice rather than the lane
            row["id"] = int(e.get("id", 0))
            if e["ph"] == "f":
                row["bp"] = "e"
        rows.append(row)
    meta: List[dict] = []
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"rank {pid}"}})
        for cat, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": cat}})
    return {"traceEvents": meta + rows, "displayTimeUnit": "ms"}


def save_chrome(path: str, rank: Optional[int] = None) -> str:
    """Write the buffered events as Chrome-trace JSON (see
    :func:`chrome_doc` for the lane/rounding contract)."""
    with open(path, "w") as fh:
        json.dump(chrome_doc(events(rank), _t0), fh)
    return path


def stats(rank: Optional[int] = None) -> Dict[str, Any]:
    """Aggregate table: event count + total span µs per (cat, name),
    decision-arm totals, and the dropped-event count."""
    agg: Dict[str, Dict[str, float]] = {}
    arms: Dict[str, int] = {}
    for e in events(rank):
        row = agg.setdefault(f"{e['cat']}:{e['name']}",
                             {"count": 0, "total_us": 0.0})
        row["count"] += 1
        if e["ph"] == "X":
            row["total_us"] += e["dur"] * 1e6
        if e["cat"] == "decision":
            arm = e["args"].get("arm", "?")
            arms[arm] = arms.get(arm, 0) + 1
    return {"events": dict(sorted(agg.items())), "decision_arms": arms,
            "dropped_events": _dropped,
            "dropped_by_rank": ({int(rank): dropped_events(rank)}
                                if rank is not None else dropped_by_rank())}


def format_stats(rank: Optional[int] = None) -> str:
    s = stats(rank)
    lines = [f"{'cat:name':40s} {'count':>7s} {'total_us':>12s}"]
    for key, row in s["events"].items():
        lines.append(f"{key:40s} {row['count']:7.0f} "
                     f"{row['total_us']:12.1f}")
    if s["decision_arms"]:
        lines.append("decision arms: " + ", ".join(
            f"{a}={n}" for a, n in sorted(s["decision_arms"].items())))
    lines.append(f"dropped events: {s['dropped_events']}")
    per = {r: n for r, n in s["dropped_by_rank"].items() if n}
    if per:
        lines.append("dropped by rank: " + ", ".join(
            f"{r}={n}" for r, n in sorted(per.items())))
    return "\n".join(lines)
