"""Goodput / MFU ledger — per-train-step wall-time accounting (the
port's copy of ``ompi_tpu/perf/goodput.py``).

One step's wall time splits into three buckets:

* **compute** — wall minus everything below (the part that moves loss)
* **exposed comm** — gradient-sync time NOT hidden behind backward
  compute (the overlap spans measure it: t_arm - t_unsynced_floor)
* **host/blocked** — pipeline bubble + host stalls (bubble geometry from
  trace/analyze: (P-1)/(M+P-1) of a pipeline:run span)

from which:

* ``goodput_pct``       = compute / wall x 100
* ``overlap_efficiency``= 1 - exposed / total_comm  (1.0 = fully hidden)
* ``mfu_pct``           = tokens x flops_per_token / wall / peak x 100

``account`` is the pure arithmetic (unit-tested against hand timelines);
``GoodputLedger`` is the streaming per-step store behind the
``perf_goodput_pct`` / ``perf_mfu_pct`` pvars and the ledger file's
banked goodput distribution (what the regression sentry compares
against). Steps that arrive without a comm split (the flagship wrapper
can only measure wall on a single blocked call) update wall/MFU only —
goodput is never fabricated from a missing split.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def account(wall_s: float, comm_total_s: Optional[float] = None,
            comm_exposed_s: Optional[float] = None, host_s: float = 0.0,
            tokens: int = 0, flops_per_token: float = 0.0,
            peak_tflops: float = 0.0) -> Dict[str, Any]:
    """Split one step's wall time; None marks a metric as unmeasured
    (missing split / no peak spec), never silently 0 or 100."""
    out: Dict[str, Any] = {"wall_s": float(wall_s)}
    exposed = float(comm_exposed_s or 0.0)
    host = float(host_s or 0.0)
    compute = max(wall_s - exposed - host, 0.0)
    out["compute_s"] = compute
    out["comm_exposed_s"] = comm_exposed_s
    out["comm_total_s"] = comm_total_s
    out["host_s"] = host
    out["goodput_pct"] = (
        round(100.0 * compute / wall_s, 2)
        if wall_s > 0 and comm_exposed_s is not None else None)
    out["overlap_efficiency"] = (
        round(1.0 - exposed / comm_total_s, 3)
        if comm_total_s and comm_total_s > 0
        and comm_exposed_s is not None else None)
    out["mfu_pct"] = (
        round(100.0 * tokens * flops_per_token / wall_s
              / (peak_tflops * 1e12), 3)
        if wall_s > 0 and tokens and flops_per_token and peak_tflops
        else None)
    out["tokens"] = int(tokens)
    return out


def pipeline_bubble_s(stages: int, microbatches: int,
                      run_s: float) -> float:
    """Host/blocked seconds charged to GPipe bubble geometry for one
    pipeline:run span — the (P-1)/(M+P-1) fraction trace/analyze
    reports, as absolute time."""
    p, m = int(stages), int(microbatches)
    if p <= 1 or m <= 0 or run_s <= 0:
        return 0.0
    return run_s * (p - 1) / (m + p - 1)


class GoodputLedger:
    """Streaming per-step goodput/MFU store (EWMA + bounded windows)."""

    def __init__(self, window: int = 256, alpha: float = 0.2) -> None:
        self.window = int(window)
        self.alpha = float(alpha)
        self.steps = 0
        self._ewma: Dict[str, float] = {}
        self._win: Dict[str, List[float]] = {"goodput_pct": [],
                                             "mfu_pct": [],
                                             "wall_s": []}

    def record_step(self, wall_s: float, **kw: Any) -> Dict[str, Any]:
        """account() one step and fold every measured metric."""
        row = account(wall_s, **kw)
        self.steps += 1
        for key in ("goodput_pct", "mfu_pct", "overlap_efficiency"):
            v = row.get(key)
            if v is None:
                continue
            prev = self._ewma.get(key)
            self._ewma[key] = (float(v) if prev is None
                               else self.alpha * float(v)
                               + (1 - self.alpha) * prev)
        for key in ("goodput_pct", "mfu_pct", "wall_s"):
            v = row.get(key)
            if v is None:
                continue
            win = self._win[key]
            win.append(float(v))
            if len(win) > self.window:
                del win[: len(win) - self.window]
        return row

    def ewma(self, key: str) -> float:
        return float(self._ewma.get(key, 0.0))

    def snapshot(self) -> Dict[str, Any]:
        return {"steps": self.steps,
                "goodput_pct": round(self.ewma("goodput_pct"), 2),
                "mfu_pct": round(self.ewma("mfu_pct"), 3),
                "overlap_efficiency":
                    round(self.ewma("overlap_efficiency"), 3),
                "samples": {k: len(v) for k, v in self._win.items()}}

    # ---- persistence (banked distributions for the sentry) ---------

    def to_json(self) -> Dict[str, Any]:
        return {"steps": self.steps,
                "goodput_pct_samples": list(self._win["goodput_pct"]),
                "mfu_pct_samples": list(self._win["mfu_pct"])}

    def load_json(self, doc: Dict[str, Any]) -> None:
        try:
            gp = [float(v) for v in doc.get("goodput_pct_samples", [])]
            mf = [float(v) for v in doc.get("mfu_pct_samples", [])]
        except (TypeError, ValueError):
            return
        if gp:
            self._win["goodput_pct"] = gp[-self.window:]
            self._ewma.setdefault("goodput_pct", gp[-1])
        if mf:
            self._win["mfu_pct"] = mf[-self.window:]
            self._ewma.setdefault("mfu_pct", mf[-1])
        self.steps = max(self.steps, int(doc.get("steps", 0) or 0))

    def baseline_goodput(self) -> List[float]:
        return list(self._win["goodput_pct"])

    def clear(self) -> None:
        self.steps = 0
        self._ewma.clear()
        for win in self._win.values():
            win.clear()
