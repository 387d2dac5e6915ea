"""Cross-rank trace merge: one global timeline from per-rank rings.

The port's copy of ``ompi_tpu/trace/merge.py``.  The flight recorder
(``trace``) is strictly per-rank; a fleet is diagnosed
*across* ranks — stragglers, skewed collective entry times and pipeline
bubbles are invisible in any single rank's timeline.  This module builds
the global view two ways:

  * **in-band** — ``gather(comm)``: every rank ships its ring buffer to
    rank 0 over the comm (length-probed pickle-free JSON payloads), with
    ``tools/mpisync.clock_sync_ex`` offsets measured on the same comm so
    the per-rank monotonic clocks align onto rank 0's;
  * **post-mortem** — ``load_chrome(paths)``: N per-rank Chrome/JSON
    dumps written by ``trace.save_chrome`` are parsed back into event
    dicts (pid → rank), then ``merge`` aligns them with an offsets table
    the caller saved alongside (each dump's timestamps are relative to
    its own process's trace epoch, so the offsets must cover the epoch
    delta too — mpisync offsets do when the epochs coincide with init).

Alignment convention: ``offsets[r]`` is rank r's clock minus rank 0's
(the mpisync sign), so mapping an event onto the global (rank-0)
timeline is ``t_global = t_r - offsets[r]``.  ``best_rtt[r]`` bounds the
residual error at ±rtt/2 and is carried into the ``FleetTimeline`` as
per-rank alignment confidence; the analyzer refuses to flag stragglers
whose lateness is inside that bound.

The merged timeline keeps pid = rank in the Chrome export
(``save_chrome``), so one perfetto load shows every rank's lanes
side by side with globally monotonic timestamps.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import chrome_doc, dropped_events, events as _local_events
from ..tools.mpisync import DEFAULT_ROUNDS, clock_sync_ex

MERGE_TAG = 737           # user-tag space, distinct from SYNC_TAG


@dataclass
class FleetTimeline:
    """The structured merged view: offset-aligned events from every rank,
    sorted by global time, plus the per-rank merge metadata the analyzer
    needs (alignment confidence, overflow counts)."""

    events: List[dict]                                  # aligned, sorted
    offsets: Dict[int, float] = field(default_factory=dict)
    best_rtt: Dict[int, float] = field(default_factory=dict)
    dropped: Dict[int, int] = field(default_factory=dict)
    # ranks whose events are on their LOCAL clock because the (non-empty)
    # offsets table had no entry for them — cross-rank skew touching one
    # of these is alignment artifact, not evidence
    unaligned_ranks: List[int] = field(default_factory=list)

    @property
    def ranks(self) -> List[int]:
        return sorted({e["rank"] for e in self.events} | set(self.offsets))

    def by_rank(self, rank: int) -> List[dict]:
        return [e for e in self.events if e["rank"] == rank]

    def arrivals(self, op: Optional[str] = None) -> List[dict]:
        """Collective-arrival markers: decision-audit instants and
        host-dispatch ``enter:<op>`` instants, oldest first.  These are
        the per-rank entry timestamps the skew analysis keys on."""
        out = [e for e in self.events
               if e["cat"] in ("decision", "coll-enter")
               and (op is None or e["args"].get("op") == op)]
        return out

    def spans(self, name: Optional[str] = None) -> List[dict]:
        return [e for e in self.events if e["ph"] == "X"
                and (name is None or e["name"] == name)]

    def save_chrome(self, path: str) -> str:
        """One global Chrome trace, pid = rank preserved, timestamps µs
        since the earliest aligned event (globally monotonic)."""
        t0 = min((e["t"] for e in self.events), default=0.0)
        doc = chrome_doc(self.events, t0)
        doc["otherData"] = {
            "merged_ranks": self.ranks,
            "clock_offsets_s": {str(r): v for r, v in self.offsets.items()},
            "best_rtt_s": {str(r): v for r, v in self.best_rtt.items()},
            "dropped_events": {str(r): v for r, v in self.dropped.items()},
            "unaligned_ranks": list(self.unaligned_ranks),
        }
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return path


def merge(per_rank: Dict[int, List[dict]],
          offsets: Optional[Dict[int, float]] = None,
          best_rtt: Optional[Dict[int, float]] = None,
          dropped: Optional[Dict[int, int]] = None) -> FleetTimeline:
    """Pure merge: shift every rank's events onto the rank-0 clock
    (``t - offsets[rank]``) and interleave into one sorted timeline.
    Events are copied — the caller's (and the live tracer's) dicts are
    never mutated.

    A PARTIAL offsets table degrades loudly: ranks present in
    ``per_rank`` but absent from a non-empty ``offsets`` stay on their
    local clocks, are recorded in ``unaligned_ranks``, and an error is
    printed — silently merging half-aligned clocks manufactures
    stragglers out of alignment error.  An empty/absent table means "no
    alignment attempted" (single-clock runs) and stays quiet."""
    offsets = dict(offsets or {})
    unaligned = (sorted(r for r in per_rank if r not in offsets)
                 if offsets else [])
    if unaligned:
        from ..core.output import output
        output.error(
            "trace",
            f"merge: offsets table covers rank(s) {sorted(offsets)} but "
            f"not {unaligned}; unaligned rank(s) stay on their local "
            "clocks — cross-rank skew involving them is untrustworthy")
    aligned: List[dict] = []
    for rank, evs in per_rank.items():
        off = float(offsets.get(rank, 0.0))
        for e in evs:
            e = dict(e)
            e["t"] = e["t"] - off
            e["rank"] = rank
            aligned.append(e)
    aligned.sort(key=lambda e: e["t"])
    return FleetTimeline(events=aligned, offsets=offsets,
                         best_rtt=dict(best_rtt or {}),
                         dropped=dict(dropped or {}),
                         unaligned_ranks=unaligned)


# -- in-band gather over the comm --------------------------------------------

def _is_request_event(e: dict) -> bool:
    """The request plane's events (``req:*`` and the route decision),
    whose ``rank`` is a replica lane rather than the recording process."""
    return e["cat"] == "req" or e["name"] == "decide:route"


def _payload(rank: int, t_cut: Optional[float] = None) -> bytes:
    from . import _jsonable

    def ship(e: dict) -> dict:
        return {k: (_jsonable(v) if k == "args" else v) for k, v in e.items()}

    evs = []
    for e in _local_events(rank):
        if t_cut is not None and e["t"] > t_cut:
            continue            # gather's own instrumentation (clock-sync
            # bcast arrivals, p2p ship spans) must not pollute the skew
        evs.append(ship(e))
    # the request plane records on one process a replica, each event on
    # its replica's lane: ship the lanes this process holds besides its own
    lanes: Dict[str, List[dict]] = {}
    for e in _local_events():
        if e["rank"] != rank and _is_request_event(e) and (
                t_cut is None or e["t"] <= t_cut):
            lanes.setdefault(str(e["rank"]), []).append(ship(e))
    return json.dumps({"events": evs, "dropped": dropped_events(rank),
                       "lanes": lanes}).encode()


def gather(comm, rounds: int = DEFAULT_ROUNDS,
           sync: bool = True) -> Optional[FleetTimeline]:
    """Collective: clock-sync the comm, then gather every rank's ring
    buffer to rank 0 and return the merged ``FleetTimeline`` there
    (``None`` on every other rank).

    Each rank contributes the ring keyed by its WORLD rank (what the
    instrumented layers record under ``ctx.rank``); pid = world rank in
    the merged timeline.  The request plane's events are the exception:
    a replica's first rank records them under the replica's lane, so each
    rank also ships the request events of the other lanes it holds, and
    they join that lane aligned by the SENDER's offset (the clock they
    were read on).  ``sync=False`` skips the ping-pong and merges
    on raw clocks (single-process thread ranks share one clock).
    """
    import time

    my_world = comm.ctx.rank
    t_cut = time.perf_counter()   # events after this are gather machinery
    if sync:
        offsets, rtts = clock_sync_ex(comm, rounds)
    else:
        offsets = rtts = np.zeros(comm.size, np.float64)
    if comm.rank != 0:
        blob = np.frombuffer(bytearray(_payload(my_world, t_cut)), np.uint8)
        comm.send(np.array([len(blob)], np.int64), 0, MERGE_TAG)
        comm.send(blob, 0, MERGE_TAG)
        return None
    docs: Dict[int, dict] = {}
    off_w: Dict[int, float] = {}
    rtt_w: Dict[int, float] = {}
    for src in range(comm.size):
        world = comm.group.world_of_rank(src)
        if src == 0:
            doc = json.loads(_payload(my_world, t_cut))
            world = my_world
        else:
            n = np.zeros(1, np.int64)
            comm.recv(n, src, MERGE_TAG)
            blob = np.zeros(int(n[0]), np.uint8)
            comm.recv(blob, src, MERGE_TAG)
            doc = json.loads(blob.tobytes())
        docs[world] = doc
        off_w[world] = float(offsets[src])
        rtt_w[world] = float(rtts[src])
    return merge_payloads(docs, off_w, rtt_w)


def merge_payloads(docs: Dict[int, dict], offsets: Dict[int, float],
                   best_rtt: Dict[int, float]) -> FleetTimeline:
    """The root's half of ``gather``: each world rank's shipped ring
    (``docs[rank]``, the payload a rank sends) and the request-plane
    lanes it held, merged onto rank 0's clock."""
    per_rank: Dict[int, List[dict]] = {}
    dropped: Dict[int, int] = {}
    lanes: List[tuple] = []          # (lane, sender's offset, events)
    for world, doc in docs.items():
        per_rank[world] = list(doc["events"])
        dropped[world] = int(doc["dropped"])
        lanes += [(int(lane), float(offsets.get(world, 0.0)), evs)
                  for lane, evs in doc.get("lanes", {}).items()]
    for lane, off_src, evs in lanes:
        # merge subtracts the lane's own offset: pre-shift so the events
        # land on the sender's alignment instead
        shift = offsets.get(lane, 0.0) - off_src
        per_rank.setdefault(lane, []).extend(
            dict(e, t=e["t"] + shift) for e in evs)
    return merge(per_rank, offsets=offsets, best_rtt=best_rtt,
                 dropped=dropped)


# -- post-mortem: N per-rank Chrome dumps from disk --------------------------

def load_chrome(paths: Sequence[str],
                ranks: Optional[Sequence[int]] = None
                ) -> Dict[int, List[dict]]:
    """Parse per-rank Chrome dumps (``trace.save_chrome`` output) back
    into the internal event schema, keyed by rank.

    Each file may itself hold several pids (a single-process multi-rank
    run dumps every ring into one file); ``ranks`` optionally REMAPS the
    file order to rank ids for single-pid dumps from a multi-process
    fleet whose pid happens to repeat (every process recorded rank 0 of
    its own world).  Timestamps come back as seconds relative to each
    dump's own trace epoch — align them via ``merge(offsets=...)``.
    """
    out: Dict[int, List[dict]] = {}
    for i, path in enumerate(paths):
        with open(path) as fh:
            doc = json.load(fh)
        rows = doc["traceEvents"] if isinstance(doc, dict) else doc
        pids = {r["pid"] for r in rows if r.get("ph") != "M"}
        remap = (ranks is not None and len(pids) == 1)
        for r in rows:
            if r.get("ph") not in ("X", "i", "s", "t", "f"):
                continue
            rank = int(ranks[i]) if remap else int(r["pid"])
            ev = {"name": r["name"], "cat": r.get("cat", "event"),
                  "ph": r["ph"], "t": r["ts"] / 1e6, "rank": rank,
                  "args": r.get("args", {})}
            if r["ph"] == "X":
                ev["dur"] = r.get("dur", 0) / 1e6
            elif r["ph"] in ("s", "t", "f"):
                # flow arrows (request hand-offs) bind by id — keep it
                ev["id"] = int(r.get("id", 0))
            out.setdefault(rank, []).append(ev)
    return out


def _offset_table(raw) -> Dict[int, float]:
    if isinstance(raw, list):
        return {i: float(v) for i, v in enumerate(raw)}
    return {int(k): float(v) for k, v in raw.items()}


def load_offsets(path: str) -> Dict[int, float]:
    """Read a ``{rank: offset_seconds}`` JSON table (what a fleet run
    saves next to its dumps after an mpisync pass).  Also accepts the
    combined ``{"offsets": {...}, "best_rtt": {...}}`` form — use
    :func:`load_offsets_ex` to keep the RTT half."""
    return load_offsets_ex(path)[0]


def load_offsets_ex(path: str):
    """Like :func:`load_offsets` but returns ``(offsets, best_rtt)``;
    ``best_rtt`` is ``{}`` when the file carries only the flat table
    (the analyzer then has no clock-confidence bound to gate on)."""
    with open(path) as fh:
        raw = json.load(fh)
    if isinstance(raw, dict) and "offsets" in raw:
        return (_offset_table(raw["offsets"]),
                _offset_table(raw.get("best_rtt", {})))
    return _offset_table(raw), {}
