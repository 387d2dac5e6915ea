"""MoE routing plane — per-expert load observability + live adaptation.

The port's copy of ``ompi_tpu/moe.py``.  Hot-expert skew is a hot-link
verdict: a router that collapses onto one expert gives one edge of the
dispatch exchange most of the bytes, so this plane judges the per-expert
token loads with the hot-link sentry's statistics (max against median with
a MAD gate, one trip per episode) and then acts: a capacity-factor and
aux-weight adaptation with a cooldown, so routing cannot flap.

Three pieces, as in the reference:

* **counters** — ``moe_routed_tokens`` / ``moe_dropped_tokens`` /
  ``moe_hot_expert_trips`` (read through ``spc.Counters``) and a
  cumulative per-expert load ledger (``report``).
* **HotExpertSentry** — trips when the hottest expert's load exceeds
  ``moe_sentry_ratio`` × the median and clears the MAD gate, once per skew
  episode (it re-arms when the expert cools or the hot spot moves).
* **adaptation** — :func:`apply_adaptation` grows the live capacity-factor
  scale by ``moe_adapt_growth`` and the aux-weight scale by
  ``moe_adapt_aux_boost``, at most once per ``moe_adapt_cooldown`` steps;
  ``moe_block_ep`` and the losses read the scales through
  :func:`capacity_factor` / :func:`aux_weight`.

In the reference a trip's verdict rides the policy plane's bus, whose
engine calls :func:`apply_adaptation` back, and the sentry emits a trace
instant.  Both come with ROADMAP slice P16b: a trip with the plane enabled
raises ``NotImplementedError`` naming it, after the counters and the
sentry have taken the step.  With the plane disabled (the default)
:func:`note_routing` returns ``None`` and both scales are the identity,
as in the reference.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from .core import var as _var

_var.register("moe", "", "enabled", False, type=bool, level=3,
              help="Master switch for the MoE routing plane (per-expert "
                   "load ledger, hot-expert sentry, live capacity/aux "
                   "adaptation). Off by default; the disabled path is "
                   "one attribute read per routing step.")
_var.register("moe", "sentry", "ratio", 2.0, type=float, level=3,
              help="Hot-expert trip: max per-expert token load above "
                   "this multiple of the median expert (and past the "
                   "MAD gate).")
_var.register("moe", "sentry", "z", 3.0, type=float, level=3,
              help="MAD gate: (max - median) must exceed z x MAD of "
                   "the per-expert load distribution before a trip.")
_var.register("moe", "sentry", "min_tokens", 64, type=int, level=3,
              help="The hot expert must hold at least this many tokens "
                   "in the step before the sentry judges.")
_var.register("moe", "adapt", "growth", 1.25, type=float, level=3,
              help="Capacity-factor scale multiplier applied per "
                   "hot-expert adaptation (compounding across trips, "
                   "capped by moe_adapt_max_cf).")
_var.register("moe", "adapt", "max_cf", 4.0, type=float, level=3,
              help="Ceiling on the ADAPTED effective capacity factor "
                   "(base x scale).")
_var.register("moe", "adapt", "aux_boost", 2.0, type=float, level=3,
              help="Load-balance aux-weight multiplier applied per "
                   "adaptation (capped at 16x base).")
_var.register("moe", "adapt", "cooldown", 4, type=int, level=3,
              help="Minimum routing steps between adaptations "
                   "(hysteresis): a persistent skew episode adapts "
                   "once per window, not once per step.")

enabled: bool = bool(_var.get("moe_enabled", False))

PVARS = ("moe_routed_tokens", "moe_dropped_tokens",
         "moe_hot_expert_trips")

_AUX_SCALE_CAP = 16.0


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def _on_enabled_var(v: Any) -> None:
    # mid-run OMPI_TPU_moe_enabled / set_cli writes take effect
    global enabled
    enabled = bool(v)


_var.watch("moe_enabled", _on_enabled_var)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    m = n // 2
    return s[m] if n % 2 else (s[m - 1] + s[m]) / 2.0


class HotExpertSentry:
    """Streaming judge over per-step per-expert token loads — the
    hot-link sentry's statistics applied to the expert axis."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hot: Dict[int, bool] = {}
        self._verdicts: List[Dict[str, Any]] = []
        self._trips = 0

    def check(self, loads: Sequence[int],
              step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """One pass over this step's per-expert token loads; returns the
        new hot-expert verdict when this call tripped, else None."""
        vals = [float(v) for v in loads]
        if len(vals) < 2:
            return None
        min_tokens = int(_var.get("moe_sentry_min_tokens", 64))
        ratio = float(_var.get("moe_sentry_ratio", 2.0))
        z_thr = float(_var.get("moe_sentry_z", 3.0))
        med = _median(vals)
        mad = _median([abs(v - med) for v in vals])
        he = max(range(len(vals)), key=lambda i: vals[i])
        hb = vals[he]
        hot = (hb >= min_tokens
               and hb > ratio * max(med, 1.0)
               and (hb - med) > z_thr * mad)
        verdict = None
        with self._lock:
            # re-arm every expert that is no longer the hot one, or no
            # longer hot at all: one trip per skew episode
            for k in list(self._hot):
                if k != he or not hot:
                    del self._hot[k]
            if hot and not self._hot.get(he):
                self._hot[he] = True
                self._trips += 1
                verdict = {"kind": "hot_expert", "plane": "moe",
                           "severity": "warn", "expert": he,
                           "tokens": int(hb), "median_tokens": int(med),
                           "ratio": round(hb / max(med, 1.0), 2),
                           "mad_tokens": int(mad),
                           "n_experts": len(vals)}
                if step is not None:
                    verdict["step"] = int(step)
                self._verdicts.append(verdict)
                if len(self._verdicts) > 64:
                    del self._verdicts[:len(self._verdicts) - 64]
        return verdict

    def hot(self) -> bool:
        with self._lock:
            return bool(self._hot)

    def trips(self) -> int:
        return self._trips

    def verdicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._verdicts)

    def reset(self) -> None:
        with self._lock:
            self._hot.clear()
            self._verdicts.clear()
            self._trips = 0


sentry = HotExpertSentry()

_lock = threading.Lock()
_routed = 0
_dropped = 0
_steps = 0
_expert_load: Dict[int, int] = {}
_cf_scale = 1.0
_aux_scale = 1.0
_last_adapt_step: Optional[int] = None
_adaptations: List[Dict[str, Any]] = []


def note_routing(expert_load: Sequence[int], routed: Optional[int] = None,
                 dropped: int = 0,
                 step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Feed one routing step's per-expert dispatched-token loads (global
    across ranks) and judge the skew.  Returns None: with the plane
    disabled nothing is recorded, and a step that trips the sentry
    raises (the bus hop, ROADMAP P16b) once it is recorded."""
    global _routed, _dropped, _steps
    if not enabled:
        return None
    loads = [int(v) for v in expert_load]
    r = int(sum(loads) if routed is None else routed)
    with _lock:
        _steps += 1
        this_step = _steps if step is None else int(step)
        _routed += r
        _dropped += int(dropped)
        for e, v in enumerate(loads):
            _expert_load[e] = _expert_load.get(e, 0) + v
    verdict = sentry.check(loads, step=this_step)
    if verdict is not None:
        raise NotImplementedError(
            f"moe.note_routing: expert {verdict['expert']} tripped the "
            f"hot-expert sentry at step {this_step}; the verdict rides the "
            f"policy plane's bus, which comes with ROADMAP slice P16b")
    return None


def apply_adaptation(verdict: Dict[str, Any],
                     step: int) -> Optional[Dict[str, Any]]:
    """The act half of the hot-expert loop: grows the live capacity/aux
    scales and banks the adaptation event, or returns None inside the
    cooldown window (the hysteresis half of 'can't flap'; the sentry's
    episode re-arm is the other half)."""
    global _cf_scale, _aux_scale, _last_adapt_step
    growth = float(_var.get("moe_adapt_growth", 1.25))
    max_cf = float(_var.get("moe_adapt_max_cf", 4.0))
    boost = float(_var.get("moe_adapt_aux_boost", 2.0))
    cooldown = int(_var.get("moe_adapt_cooldown", 4))
    with _lock:
        if (_last_adapt_step is not None
                and step - _last_adapt_step < max(cooldown, 1)):
            return None                 # inside the hysteresis window
        _last_adapt_step = int(step)
        _cf_scale = _cf_scale * max(growth, 1.0)
        _aux_scale = min(_aux_scale * max(boost, 1.0), _AUX_SCALE_CAP)
        event = {"step": int(step), "expert": verdict["expert"],
                 "cf_scale": round(_cf_scale, 4),
                 "aux_scale": round(_aux_scale, 4),
                 "max_cf": max_cf,
                 "reason": (f"sentry:moe_hot_expert:e{verdict['expert']}"
                            f":ratio={verdict['ratio']}")}
        _adaptations.append(event)
        if len(_adaptations) > 64:
            del _adaptations[:len(_adaptations) - 64]
    return event


def capacity_factor(base: float) -> float:
    """The LIVE effective capacity factor: base x adapted scale, capped
    at moe_adapt_max_cf. The identity when the plane is disabled."""
    if not enabled:
        return float(base)
    with _lock:
        return min(float(base) * _cf_scale,
                   float(_var.get("moe_adapt_max_cf", 4.0)))


def aux_weight(base: float) -> float:
    """The LIVE load-balance aux weight: base x adapted scale."""
    if not enabled:
        return float(base)
    with _lock:
        return float(base) * _aux_scale


def adaptations() -> List[Dict[str, Any]]:
    with _lock:
        return list(_adaptations)


def pvar_value(name: str) -> float:
    if name == "moe_routed_tokens":
        return float(_routed)
    if name == "moe_dropped_tokens":
        return float(_dropped)
    if name == "moe_hot_expert_trips":
        return float(sentry.trips())
    raise KeyError(name)


def report() -> Dict[str, Any]:
    """Structured snapshot of the plane (the reference's comm_doctor
    --moe source)."""
    with _lock:
        return {
            "steps": _steps,
            "routed_tokens": _routed,
            "dropped_tokens": _dropped,
            "drop_rate": round(_dropped / max(_routed + _dropped, 1), 6),
            "expert_load": {str(e): v
                            for e, v in sorted(_expert_load.items())},
            "cf_scale": round(_cf_scale, 4),
            "aux_scale": round(_aux_scale, 4),
            "hot_expert_trips": sentry.trips(),
            "hot_now": sentry.hot(),
            "verdicts": sentry.verdicts(),
            "adaptations": list(_adaptations),
        }


def reset() -> None:
    global _routed, _dropped, _steps, _cf_scale, _aux_scale
    global _last_adapt_step
    sentry.reset()
    with _lock:
        _routed = _dropped = _steps = 0
        _expert_load.clear()
        _cf_scale = _aux_scale = 1.0
        _last_adapt_step = None
        _adaptations.clear()
