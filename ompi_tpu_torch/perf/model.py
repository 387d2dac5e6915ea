"""Online collective cost model — per-(coll, arm, log2-size-bucket)
streaming stats (the port's copy of ``ompi_tpu/perf/model.py``).

Every completed collective dispatch (coll/framework's counted wrapper,
arm-annotated by coll/nccl's audit) and every grad_sync bucket span folds
into one cell keyed ``(coll, arm, floor(log2(nbytes)))``: sample count,
bounded latency/busbw windows (median + p95), and an EWMA of effective
busbw. busbw uses the same algorithmic-bandwidth factors as
trace/analyze._BUSBW_FACTOR (nccl-tests convention: allreduce/grad_sync
2(R-1)/R, reduce_scatter/allgather (R-1)/R, else 1) so model numbers
line up with the flight recorder's histograms.

The model round-trips through a JSON ledger (``PERF_LEDGER_<platform>.
json``) — the banked windows are what the regression sentry compares
live samples against, and what ``best_arm`` consults to pick the arm
with best modeled busbw at an observed size.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

# algorithmic busbw factor f(ndev) — MUST agree with
# trace/analyze._BUSBW_FACTOR so ledger and histogram numbers compare
_FACTOR = {
    "allreduce": lambda r: 2 * (r - 1) / r,
    "grad_sync": lambda r: 2 * (r - 1) / r,
    "reduce_scatter": lambda r: (r - 1) / r,
    "reduce_scatter_block": lambda r: (r - 1) / r,
    "allgather": lambda r: (r - 1) / r,
    "allgatherv": lambda r: (r - 1) / r,
}


def busbw_GBps(coll: str, nbytes: int, dur_s: float, ndev: int) -> float:
    """Effective bus bandwidth for one sample (0.0 when unmeasurable)."""
    if dur_s <= 0 or nbytes <= 0 or ndev < 2:
        return 0.0
    # plane-keyed cells ("allreduce@ici") use the base coll's factor
    f = _FACTOR.get(coll.split("@", 1)[0], lambda r: 1.0)(ndev)
    return f * nbytes / dur_s / 1e9


def size_bucket(nbytes: int) -> int:
    """floor(log2(nbytes)) — the ledger's size-bucket key (0 for <=1B)."""
    return max(int(nbytes).bit_length() - 1, 0)


def _pct(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[i]


class _Cell:
    """One (coll, arm, bucket) cell: count + bounded sample windows."""

    __slots__ = ("count", "ewma_bw", "bw", "lat_us")

    def __init__(self) -> None:
        self.count = 0
        self.ewma_bw = 0.0
        self.bw: List[float] = []        # busbw GB/s window
        self.lat_us: List[float] = []    # latency us window

    def fold(self, bw: float, lat_us: float, window: int,
             alpha: float) -> None:
        self.count += 1
        self.ewma_bw = bw if self.count == 1 else (
            alpha * bw + (1 - alpha) * self.ewma_bw)
        self.bw.append(bw)
        self.lat_us.append(lat_us)
        if len(self.bw) > window:
            del self.bw[: len(self.bw) - window]
            del self.lat_us[: len(self.lat_us) - window]


class CostModel:
    """Thread-safe streaming cost model over (coll, arm, size-bucket)."""

    def __init__(self, window: int = 128, alpha: float = 0.2) -> None:
        self.window = int(window)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, str, int], _Cell] = {}

    # ---- ingestion -------------------------------------------------

    def record(self, coll: str, arm: str, nbytes: int, dur_s: float,
               ndev: int) -> Optional[float]:
        """Fold one completed-collective sample; returns the busbw folded
        (None when the sample carried no signal and was dropped)."""
        if dur_s <= 0 or nbytes <= 0:
            return None
        bw = busbw_GBps(coll, nbytes, dur_s, ndev)
        if bw <= 0:
            return None
        key = (coll, arm, size_bucket(nbytes))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _Cell()
            cell.fold(bw, dur_s * 1e6, self.window, self.alpha)
        return bw

    # ---- queries ---------------------------------------------------

    def bucket_count(self) -> int:
        return len(self._cells)

    def best_arm(self, coll: str, nbytes: int,
                 allowed: Tuple[str, ...], min_count: int = 1,
                 widen: int = 2) -> Optional[Tuple[str, Dict[str, float]]]:
        """(best arm, {arm: modeled busbw}) at the observed size, or None
        on a model miss. Searches the exact log2 bucket first, then
        nearest neighbours out to ±``widen`` buckets (the closest bucket
        with any modeled allowed arm wins — a sparse ledger still
        decides near its measured crossovers)."""
        k = size_bucket(nbytes)
        with self._lock:
            for d in range(widen + 1):
                scores: Dict[str, float] = {}
                for kk in ({k} if d == 0 else {k - d, k + d}):
                    if kk < 0:
                        continue
                    for arm in allowed:
                        cell = self._cells.get((coll, arm, kk))
                        if cell is None or cell.count < min_count:
                            continue
                        # same arm in both neighbours: keep the better
                        if cell.ewma_bw > scores.get(arm, 0.0):
                            scores[arm] = cell.ewma_bw
                if scores:
                    best = max(scores, key=lambda a: scores[a])
                    return best, scores
        return None

    def stats(self, coll: str, arm: str,
              nbytes: int) -> Optional[Dict[str, Any]]:
        """Banked distribution for one cell (sentry baseline lookups)."""
        cell = self._cells.get((coll, arm, size_bucket(nbytes)))
        if cell is None:
            return None
        bw = cell.bw
        n = len(bw)
        mean = sum(bw) / n if n else 0.0
        var = sum((b - mean) ** 2 for b in bw) / n if n else 0.0
        return {"count": cell.count, "ewma_bw": cell.ewma_bw,
                "bw_p50": _pct(bw, 50), "bw_mean": mean,
                "bw_std": var ** 0.5}

    def table(self) -> List[Dict[str, Any]]:
        """Sorted rows for comm_doctor / coll_tune rendering."""
        rows = []
        with self._lock:
            items = sorted(self._cells.items())
        for (coll, arm, k), cell in items:
            rows.append({
                "coll": coll, "arm": arm, "bucket_bytes": 1 << k,
                "count": cell.count,
                "busbw_GBps_ewma": round(cell.ewma_bw, 3),
                "busbw_GBps_p50": round(_pct(cell.bw, 50), 3),
                "busbw_GBps_p95": round(_pct(cell.bw, 95), 3),
                "lat_us_p50": round(_pct(cell.lat_us, 50), 1),
                "lat_us_p95": round(_pct(cell.lat_us, 95), 1),
            })
        return rows

    def crossovers(self, min_count: int = 1) -> Dict[str, List[
            Tuple[int, str]]]:
        """Per coll: [(bucket_min_bytes, best arm)] walking buckets
        ascending — the raw material for DEVICE_RULES rows."""
        per: Dict[str, Dict[int, Dict[str, float]]] = {}
        with self._lock:
            for (coll, arm, k), cell in self._cells.items():
                if cell.count < min_count:
                    continue
                per.setdefault(coll, {}).setdefault(k, {})[arm] = \
                    cell.ewma_bw
        out: Dict[str, List[Tuple[int, str]]] = {}
        for coll, buckets in per.items():
            rows = []
            for k in sorted(buckets):
                scores = buckets[k]
                rows.append((1 << k, max(scores, key=lambda a: scores[a])))
            out[coll] = rows
        return out

    # ---- persistence -----------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                f"{coll}|{arm}|{k}": {
                    "count": cell.count,
                    "ewma_bw_GBps": cell.ewma_bw,
                    "bw_GBps": list(cell.bw),
                    "lat_us": list(cell.lat_us),
                }
                for (coll, arm, k), cell in sorted(self._cells.items())
            }

    def load_json(self, buckets: Dict[str, Any]) -> int:
        """Merge a ledger's bucket dict into the model (banked windows
        replace emptier local ones); returns cells loaded."""
        n = 0
        for key, rec in (buckets or {}).items():
            try:
                coll, arm, k = key.rsplit("|", 2)
                cell = _Cell()
                cell.count = int(rec["count"])
                cell.ewma_bw = float(rec["ewma_bw_GBps"])
                cell.bw = [float(b) for b in rec["bw_GBps"]][-self.window:]
                cell.lat_us = [float(u)
                               for u in rec["lat_us"]][-self.window:]
            except (KeyError, ValueError, TypeError):
                continue       # tolerate a hand-edited / older ledger row
            with self._lock:
                old = self._cells.get((coll, arm, int(k)))
                if old is None or old.count < cell.count:
                    self._cells[(coll, arm, int(k))] = cell
                    n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._cells.clear()


def load_ledger_doc(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a ledger object")
    return doc
