"""Perf-regression sentry — live samples vs the ledger's banked
distributions (the port's copy of ``ompi_tpu/perf/sentry.py``; the
reference also publishes each trip to its policy plane, which the port
lacks until ROADMAP P16b).

On ``perf.load_ledger`` the sentry snapshots a baseline per
(coll, arm, size-bucket) cell (busbw mean/std/p50 over the banked
window) plus the banked step-goodput distribution. Every live sample
then gets two tests:

* **ratio**: busbw below ``perf_sentry_ratio`` x baseline p50
* **z-score**: (baseline mean - busbw) / baseline std above
  ``perf_sentry_z``

A single bad sample is noise; only ``perf_sentry_sustain`` CONSECUTIVE
bad samples on the same key trip the sentry (one trip per degradation
episode — a good sample re-arms the key). A trip emits a
``perf_regression`` trace instant, increments the ``perf_regressions``
pvar (spc -> Prometheus), and banks a verdict ``report()`` returns.
Baselines with fewer than ``perf_sentry_min_samples`` samples never
judge — a two-sample ledger cannot define "regression".
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core import var as _var
from . import model as _model

_var.register("perf", "sentry", "ratio", 0.5, type=float, level=3,
              help="Trip when live busbw/goodput falls below this "
                   "fraction of the ledger baseline p50 (sustained).")
_var.register("perf", "sentry", "z", 3.0, type=float, level=3,
              help="Trip when the baseline z-score of the shortfall "
                   "exceeds this (sustained).")
_var.register("perf", "sentry", "sustain", 3, type=int, level=3,
              help="Consecutive bad samples on one key required to "
                   "trip (single outliers are noise).")
_var.register("perf", "sentry", "min_samples", 4, type=int, level=3,
              help="Baseline cells with fewer banked samples than this "
                   "never judge live traffic.")


def _dist(samples: List[float]) -> Optional[Dict[str, float]]:
    n = len(samples)
    if not n:
        return None
    mean = sum(samples) / n
    var = sum((s - mean) ** 2 for s in samples) / n
    return {"count": n, "mean": mean, "std": var ** 0.5,
            "p50": _model._pct(samples, 50)}


class Sentry:
    """Streaming comparator; keys are ledger cells plus 'goodput'."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._base: Dict[Any, Dict[str, float]] = {}
        self._streak: Dict[Any, int] = {}
        self._tripped: Dict[Any, bool] = {}
        self._verdicts: List[Dict[str, Any]] = []
        self._trips = 0

    # ---- baseline --------------------------------------------------

    def load_baseline(self, buckets: Dict[str, Any],
                      goodput_samples: List[float]) -> int:
        """Bank baselines from a ledger doc; returns keys banked."""
        n = 0
        with self._lock:
            for key, rec in (buckets or {}).items():
                try:
                    coll, arm, k = key.rsplit("|", 2)
                    d = _dist([float(b) for b in rec["bw_GBps"]])
                except (KeyError, ValueError, TypeError):
                    continue
                if d:
                    self._base[(coll, arm, int(k))] = d
                    n += 1
            d = _dist([float(g) for g in goodput_samples or []])
            if d:
                self._base["goodput"] = d
                n += 1
        return n

    # ---- live samples ----------------------------------------------

    def observe_coll(self, coll: str, arm: str, nbytes: int,
                     dur_s: float, ndev: int) -> Optional[Dict[str, Any]]:
        bw = _model.busbw_GBps(coll, nbytes, dur_s, ndev)
        if bw <= 0:
            return None
        key = (coll, arm, _model.size_bucket(nbytes))
        return self._judge(key, bw, lower_is_bad=True,
                           detail={"coll": coll, "arm": arm,
                                   "bucket_bytes": 1 << key[2],
                                   "busbw_GBps": round(bw, 3)})

    def observe_goodput(self, goodput_pct: float) -> Optional[
            Dict[str, Any]]:
        return self._judge("goodput", float(goodput_pct),
                           lower_is_bad=True,
                           detail={"metric": "goodput_pct",
                                   "goodput_pct": round(goodput_pct, 2)})

    def _judge(self, key: Any, value: float, lower_is_bad: bool,
               detail: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        min_n = int(_var.get("perf_sentry_min_samples", 4))
        ratio = float(_var.get("perf_sentry_ratio", 0.5))
        z_thr = float(_var.get("perf_sentry_z", 3.0))
        sustain = max(int(_var.get("perf_sentry_sustain", 3)), 1)
        with self._lock:
            base = self._base.get(key)
            if base is None or base["count"] < min_n:
                return None
            z = ((base["mean"] - value) / base["std"]
                 if base["std"] > 0 else 0.0)
            bad = value < ratio * base["p50"] or z > z_thr
            if not bad:
                self._streak[key] = 0
                self._tripped[key] = False      # episode over; re-arm
                return None
            self._streak[key] = self._streak.get(key, 0) + 1
            if self._streak[key] < sustain or self._tripped.get(key):
                return None
            self._tripped[key] = True
            self._trips += 1
            verdict = dict(detail, kind="perf_regression", plane="perf",
                           severity="warn",
                           baseline_p50=round(base["p50"], 3),
                           baseline_mean=round(base["mean"], 3),
                           z=round(z, 2), sustained=self._streak[key])
            self._verdicts.append(verdict)
            if len(self._verdicts) > 64:
                del self._verdicts[:len(self._verdicts) - 64]
        # trace emission outside the lock (the ring has its own)
        from .. import trace
        if trace.enabled:
            trace.instant("perf_regression", "perf", args=verdict)
        return verdict

    # ---- queries ---------------------------------------------------

    def trips(self) -> int:
        return self._trips

    def verdicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._verdicts)

    def baseline_keys(self) -> int:
        return len(self._base)

    def reset(self) -> None:
        with self._lock:
            self._base.clear()
            self._streak.clear()
            self._tripped.clear()
            self._verdicts.clear()
            self._trips = 0
