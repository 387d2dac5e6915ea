"""Continuous performance plane — cost model + goodput ledger + sentry.

The port's copy of ``ompi_tpu/perf/__init__.py``.  Three coupled pieces:

* ``model``   — online collective cost model: every arm-annotated
  collective completion folds into (coll, arm, log2-size-bucket)
  streaming stats; ``best_arm`` reads it.  (The JAX package's decision
  layer consults it under ``coll_xla_rules="learned"``; the port's
  ``coll_nccl_rules=learned`` still refuses until ROADMAP P18 wires it.)
* ``ledger``  — per-train-step goodput/MFU accounting (perf/goodput).
* ``sentry``  — live samples vs the banked ledger distributions; a
  sustained shortfall emits a ``perf_regression`` trace event and
  increments the ``perf_regressions`` pvar (perf/sentry).

Sample sources:

1. coll/framework's counted dispatch wrapper times every collective
   when ``perf.enabled`` (``timed_coll``); coll/nccl's audit annotates
   the in-flight entry with the executed arm + per-rank wire bytes
   (``note_arm``) — only arm-annotated samples fold, so host-path and
   barrier dispatches never pollute the model.  Device dispatch is
   asynchronous: an NCCL collective returns once it is queued on the
   stream, so a native sample measures host dispatch latency unless the
   caller synchronizes — no synchronize is added here, on the enabled
   path or the disabled one.  The staged arm blocks on its D2H copy, so
   its samples cover the work.
2. ``grad_sync:bucket`` overlap spans through the trace span sink
   (``trace.set_span_sink``) — spans tagged ``status=error`` (a raising
   collective) are NEVER ingested: a stall is not a latency sample.

Disabled path (the default): ONE module attribute read
(``perf.enabled``) per instrumented call site.

The whole plane round-trips through ``PERF_LEDGER_<platform>.json``
(``save_ledger``/``load_ledger``; ``default_ledger_path`` puts it in the
current directory): model cells + banked goodput distribution; loading
also arms the sentry's baselines.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..core import var as _var
from .. import trace as _trace
from .goodput import GoodputLedger, account, pipeline_bubble_s  # noqa: F401
from .model import CostModel, busbw_GBps, size_bucket  # noqa: F401
from .sentry import Sentry

_var.register("perf", "", "enabled", False, type=bool, level=3,
              help="Master switch for the continuous performance plane "
                   "(cost-model ingestion, goodput ledger, sentry). Off "
                   "by default; the disabled path is one attribute "
                   "read per call site.")
_var.register("perf", "", "ledger", "", type=str, level=3,
              help="Path of the PERF_LEDGER JSON to load at enable() "
                   "time (empty: no autoload; load_ledger() is "
                   "explicit).")
_var.register("perf", "model", "window", 128, type=int, level=4,
              help="Bounded per-cell sample window (p50/p95 + the "
                   "banked distribution the sentry compares against).")
_var.register("perf", "model", "alpha", 0.2, type=float, level=4,
              help="EWMA smoothing factor for modeled busbw and the "
                   "goodput/MFU pvars.")
_var.register("perf", "", "peak_tflops", 0.0, type=float, level=3,
              help="Accelerator peak TFLOP/s for MFU accounting in the "
                   "flagship step wrapper (0: unknown -> mfu "
                   "unmeasured; bench probes pass their own peak).")

enabled: bool = bool(_var.get("perf_enabled", False))

model = CostModel(window=int(_var.get("perf_model_window", 128)),
                  alpha=float(_var.get("perf_model_alpha", 0.2)))
ledger = GoodputLedger(alpha=float(_var.get("perf_model_alpha", 0.2)))
sentry = Sentry()

PVARS = ("perf_regressions", "perf_goodput_pct", "perf_mfu_pct",
         "perf_ledger_buckets")


def enable() -> None:
    global enabled
    path = str(_var.get("perf_ledger", "") or "")
    if path and os.path.exists(path):
        load_ledger(path)
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def _on_enabled_var(v: Any) -> None:
    # mid-run OMPI_TPU_PERF_ENABLED / set_cli writes take effect; the
    # watcher fires on CHANGE only so enable()/disable() stay in charge
    global enabled
    enabled = bool(v)


_var.watch("perf_enabled", _on_enabled_var)


# ---- sample source 1: the coll dispatch wrapper ----------------------

_tls = threading.local()


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def timed_coll(fn, comm, name: str, a: tuple, kw: dict):
    """Invoke one collective under timing; coll/nccl's audit annotates
    the entry (note_arm) with the executed arm + per-rank wire bytes.
    Un-annotated dispatches (host-path colls, barriers) are dropped —
    the model only learns arms it can attribute. A raising collective
    contributes nothing: a stall is not a latency sample."""
    buf = a[0] if a else None
    ent = {"op": name, "nbytes": int(getattr(buf, "nbytes", 0) or 0),
           "arm": None, "ndev": 0}
    st = _stack()
    st.append(ent)
    t0 = time.perf_counter()
    try:
        out = fn(comm, *a, **kw)
    except BaseException:
        st.pop()
        raise
    dur = time.perf_counter() - t0
    st.pop()
    if ent["arm"] is not None and ent["ndev"] >= 2:
        model.record(name, ent["arm"], ent["nbytes"], dur, ent["ndev"])
        sentry.observe_coll(name, ent["arm"], ent["nbytes"], dur,
                            ent["ndev"])
        # plane-keyed cells next to the flat one (traffic plane's
        # note_planes stash): best_arm("allreduce@ici", ...) and
        # coll_tune --from-ledger answer per-plane for free
        for plane, pb in (ent.get("planes") or {}).items():
            model.record(f"{name}@{plane}", ent["arm"], int(pb), dur,
                         ent["ndev"])
    return out


def note_arm(arm: str, nbytes: Optional[int] = None,
             ndev: int = 0) -> None:
    """Called by coll/nccl._audit post-decision: fold the executed arm
    (and the audited per-rank byte count, which reflects the real wire
    layout better than the full host buffer) into the innermost
    in-flight timing entry. No entry -> no-op (direct DeviceComm use,
    tests poking _mode)."""
    st = getattr(_tls, "stack", None)
    if not st:
        return
    ent = st[-1]
    ent["arm"] = arm
    if nbytes:
        ent["nbytes"] = int(nbytes)
    if ndev:
        ent["ndev"] = int(ndev)


def note_planes(planes: Dict[str, int]) -> None:
    """Called by the traffic plane right after note_arm: stash this
    collective's per-plane byte split (ici/dcn) into the in-flight
    timing entry so timed_coll can bank ``<coll>@<plane>`` cells with
    the measured duration. The 'host' pseudo-plane never reaches here
    (staged bytes cross no mesh link)."""
    st = getattr(_tls, "stack", None)
    if not st:
        return
    split = {p: int(b) for p, b in planes.items()
             if p != "host" and int(b) > 0}
    if split:
        st[-1]["planes"] = split


def note_sample(coll: str, arm: str, nbytes: int, dur_s: float,
                ndev: int, planes: Optional[Dict[str, int]] = None) -> None:
    """Bank one already-measured collective sample from outside the
    dispatch wrapper — the reshard executor times each plan step itself
    (plan steps never pass through timed_coll).  Grows the same flat
    and ``<coll>@<plane>`` cells the dispatch path feeds, so ``best_arm``
    reads reshard history like any other coll's."""
    if not enabled or not arm or int(ndev) < 2 or not nbytes:
        return
    dur = max(float(dur_s), 0.0)
    model.record(coll, str(arm), int(nbytes), dur, int(ndev))
    sentry.observe_coll(coll, str(arm), int(nbytes), dur, int(ndev))
    for plane, pb in (planes or {}).items():
        if plane != "host" and int(pb) > 0:
            model.record(f"{coll}@{plane}", str(arm), int(pb), dur,
                         int(ndev))


# ---- sample source 2: the trace span sink ----------------------------

def _ingest_span(name: str, cat: str, t_begin: float, t_end: float,
                 args: Optional[Dict[str, Any]]) -> None:
    if not enabled:
        return
    if name != "grad_sync:bucket":     # whitelist: everything else is
        return                         # already counted at dispatch
    a = args or {}
    if a.get("status") == "error":     # never ingest a
        return                         # stall/raise as a latency sample
    arm, nbytes = a.get("arm"), a.get("nbytes")
    ndev = int(a.get("ndev") or 0)
    if not arm or not nbytes or ndev < 2:
        return
    dur = max(t_end - t_begin, 0.0)
    model.record("grad_sync", str(arm), int(nbytes), dur, ndev)
    sentry.observe_coll("grad_sync", str(arm), int(nbytes), dur, ndev)


_trace.set_span_sink(_ingest_span)


# ---- learned arm selection (the decision layer's learned source, P18) --

def best_arm(coll: str, nbytes: int,
             allowed: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
    """(arm, reason) with the best modeled busbw at this size, or None
    on a model miss. The reason keeps the audit grammar:
    ``learned:<arm>=<bw>GBps-vs-<runner-up>=<bw>GBps``."""
    got = model.best_arm(coll, nbytes, allowed)
    if got is None:
        return None
    arm, scores = got
    ranked = sorted(scores.items(), key=lambda kv: -kv[1])
    parts = [f"{a}={bw:.2f}GBps" for a, bw in ranked[:2]]
    if len(parts) == 1:
        parts.append("unmodeled")
    return arm, "learned:" + "-vs-".join(parts)


# ---- goodput -----------------------------------------------------------

def record_step(wall_s: float, **kw: Any) -> Dict[str, Any]:
    """Fold one train step into the goodput ledger (and judge its
    goodput against the banked baseline when a comm split was given)."""
    row = ledger.record_step(wall_s, **kw)
    if row.get("goodput_pct") is not None:
        sentry.observe_goodput(row["goodput_pct"])
    return row


def peak_tflops() -> float:
    """The configured accelerator peak for MFU (0.0 = unknown)."""
    return float(_var.get("perf_peak_tflops", 0.0) or 0.0)


# ---- ledger persistence ----------------------------------------------

def default_ledger_path(platform: str, root: Optional[str] = None) -> str:
    return os.path.join(root or os.getcwd(),
                        f"PERF_LEDGER_{platform}.json")


def save_ledger(path: str, platform: str = "") -> Dict[str, Any]:
    doc = {"version": 1, "platform": platform,
           "buckets": model.to_json(), "goodput": ledger.to_json()}
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)
    return doc


def load_ledger(path: str) -> Dict[str, int]:
    """Load a PERF_LEDGER json: model cells merge in, the goodput
    window banks, and the sentry arms its baselines from BOTH."""
    from .model import load_ledger_doc
    doc = load_ledger_doc(path)
    cells = model.load_json(doc.get("buckets", {}))
    ledger.load_json(doc.get("goodput", {}) or {})
    keys = sentry.load_baseline(
        doc.get("buckets", {}),
        (doc.get("goodput", {}) or {}).get("goodput_pct_samples", []))
    return {"cells": cells, "baseline_keys": keys}


# ---- pvars + report --------------------------------------------------

def pvar_value(name: str) -> float:
    if name == "perf_regressions":
        return float(sentry.trips())
    if name == "perf_goodput_pct":
        return float(ledger.ewma("goodput_pct"))
    if name == "perf_mfu_pct":
        return float(ledger.ewma("mfu_pct"))
    if name == "perf_ledger_buckets":
        return float(model.bucket_count())
    raise KeyError(name)


def report() -> Dict[str, Any]:
    """Structured snapshot (the reference's comm_doctor --perf reads
    it)."""
    return {"model": model.table(),
            "goodput": ledger.snapshot(),
            "verdicts": sentry.verdicts(),
            "regressions": sentry.trips(),
            "baseline_keys": sentry.baseline_keys()}


def reset() -> None:
    model.clear()
    ledger.clear()
    sentry.reset()
