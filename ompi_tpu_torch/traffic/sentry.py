"""Hot-link + plane-imbalance sentry over the live traffic matrix (the
port's copy of ``ompi_tpu/traffic/sentry.py``; the reference also
publishes each trip to its policy plane, which the port lacks until
ROADMAP P16b).

Judged after every attributed collective (one cheap pass over the edge
aggregate, gated by minimum edge count/bytes so cold matrices never
trip). Two verdict families:

* **hotlink** — one directed edge carries disproportionate bytes:
  ``max > traffic_sentry_ratio x median`` AND the excess clears a MAD
  gate (``max - median > traffic_sentry_z x MAD``) so a naturally wide
  spread never flags its own tail. One trip per episode, per edge — the
  perf sentry's discipline: the edge re-arms only when it stops being
  hot. A trip emits a ``traffic_hotlink`` trace instant naming the
  guilty (src, dst) and increments the ``traffic_hotlink_trips`` pvar.
* **plane imbalance** — mean per-edge bytes of one plane dwarf the
  other's (ICI vs DCN) by the same ratio; one trip per episode,
  ``traffic_plane_imbalance`` trace instant, verdict in the report.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core import var as _var

_var.register("traffic", "sentry", "ratio", 4.0, type=float, level=3,
              help="Hot-link trip: max edge bytes above this multiple "
                   "of the median edge (and past the MAD gate).")
_var.register("traffic", "sentry", "z", 3.0, type=float, level=3,
              help="MAD gate: (max - median) must exceed z x MAD of "
                   "the edge-byte distribution before a trip.")
_var.register("traffic", "sentry", "min_edges", 4, type=int, level=3,
              help="Edges required in the matrix before the sentry "
                   "judges at all (cold matrices never trip).")
_var.register("traffic", "sentry", "min_bytes", 4096, type=int, level=3,
              help="The hot edge must carry at least this many bytes "
                   "(startup noise floor).")


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    m = n // 2
    return s[m] if n % 2 else (s[m - 1] + s[m]) / 2.0


class HotlinkSentry:
    """Streaming judge over TrafficMatrix.snapshot_edges()."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hot: Dict[Tuple[int, int], bool] = {}
        self._plane_tripped = False
        self._verdicts: List[Dict[str, Any]] = []
        self._trips = 0

    def check(self, edges: List[Tuple[Tuple[int, int], int, str]]
              ) -> Optional[Dict[str, Any]]:
        """One pass over (edge, bytes, plane) triples; returns the new
        hotlink verdict when this call tripped, else None."""
        min_edges = int(_var.get("traffic_sentry_min_edges", 4))
        min_bytes = int(_var.get("traffic_sentry_min_bytes", 4096))
        ratio = float(_var.get("traffic_sentry_ratio", 4.0))
        z_thr = float(_var.get("traffic_sentry_z", 3.0))
        if len(edges) < max(min_edges, 1):
            return None
        vals = [float(b) for _, b, _ in edges]
        med = _median(vals)
        mad = _median([abs(v - med) for v in vals])
        (hs, hd), hb, hplane = max(edges, key=lambda t: t[1])
        hot = (hb >= min_bytes
               and hb > ratio * max(med, 1.0)
               and (hb - med) > z_thr * mad)
        verdict = None
        with self._lock:
            key = (hs, hd)
            # re-arm every edge that is no longer the hot one / no
            # longer hot at all — one trip per degradation episode
            for k in list(self._hot):
                if k != key or not hot:
                    del self._hot[k]
            if hot and not self._hot.get(key):
                self._hot[key] = True
                self._trips += 1
                verdict = {"kind": "hotlink", "src": hs, "dst": hd,
                           "bytes": int(hb), "plane": hplane,
                           "severity": "warn",
                           "median_bytes": int(med),
                           "ratio": round(hb / max(med, 1.0), 2),
                           "mad_bytes": int(mad)}
                self._bank(verdict)
            pv = self._check_planes(edges, ratio, min_bytes)
        self._emit(verdict, "traffic_hotlink")
        self._emit(pv, "traffic_plane_imbalance")
        return verdict

    def _check_planes(self, edges, ratio: float,
                      min_bytes: int) -> Optional[Dict[str, Any]]:
        """Caller holds the lock. Mean per-edge bytes of ICI vs DCN."""
        sums: Dict[str, List[float]] = {}
        for _, b, plane in edges:
            sums.setdefault(plane, []).append(float(b))
        if not ("ici" in sums and "dcn" in sums):
            self._plane_tripped = False
            return None
        means = {p: sum(v) / len(v) for p, v in sums.items()}
        hi = max(means, key=lambda p: means[p])
        lo = "ici" if hi == "dcn" else "dcn"
        imb = (means[hi] >= min_bytes
               and means[hi] > ratio * max(means[lo], 1.0))
        if not imb:
            self._plane_tripped = False     # episode over; re-arm
            return None
        if self._plane_tripped:
            return None
        self._plane_tripped = True
        verdict = {"kind": "plane_imbalance", "plane": "traffic",
                   "severity": "warn", "hot_plane": hi,
                   "mean_bytes": {p: int(m) for p, m in means.items()},
                   "ratio": round(means[hi] / max(means[lo], 1.0), 2)}
        self._bank(verdict)
        return verdict

    def _bank(self, verdict: Dict[str, Any]) -> None:
        self._verdicts.append(verdict)
        if len(self._verdicts) > 64:
            del self._verdicts[:len(self._verdicts) - 64]

    @staticmethod
    def _emit(verdict: Optional[Dict[str, Any]], name: str) -> None:
        # trace emission outside the lock (the ring has its own)
        if verdict is None:
            return
        from .. import trace
        if trace.enabled:
            trace.instant(name, "traffic", args=verdict)

    # ---- queries ---------------------------------------------------

    def trips(self) -> int:
        return self._trips

    def verdicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._verdicts)

    def reset(self) -> None:
        with self._lock:
            self._hot.clear()
            self._plane_tripped = False
            self._verdicts.clear()
            self._trips = 0
