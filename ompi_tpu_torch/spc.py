"""Software performance counters (SPC).

≙ ompi/runtime/ompi_spc.c (≈100 counters exported as MPI_T pvars, dumped at
finalize). One Counters instance per Context; the p2p engine and coll
framework increment them; ``dump()`` prints at finalize when
``spc_dump_enabled`` is set.

The port's copy of ``ompi_tpu/spc.py``: ``Counters`` and the counters the
MPI surface and the device component feed.  The reads of the later planes
(trace, health, perf, traffic, numerics, reshard, elastic, policy,
serving, history) come with their slices (ROADMAP P16), as do the MPI_T
and Prometheus export and the per-peer monitoring matrices; the MoE
routing plane's three counters read through to ``ompi_tpu_torch.moe``.
"""

from __future__ import annotations

from typing import Dict

from .core import var as _var

_var.register("spc", "", "dump_enabled", False, type=bool, level=3,
              help="Print the SPC counter table at finalize "
                   "(≙ mpi_spc_dump_enabled).")

COUNTERS = [
    ("sends", "point-to-point sends posted"),
    ("isends", "nonblocking sends posted"),
    ("recvs", "receives posted"),
    ("bytes_sent", "payload bytes sent"),
    ("bytes_recvd", "payload bytes received"),
    ("eager_sends", "sends using the eager protocol"),
    ("rndv_sends", "sends using the rendezvous protocol"),
    ("matches_posted", "messages matched against posted receives"),
    ("matches_unexpected", "messages matched from the unexpected queue"),
    ("unexpected_arrivals", "frames arriving with no posted receive"),
    ("probes", "probe/iprobe calls"),
    ("collectives", "collective operations started"),
    ("device_stage_out_bytes", "device bytes staged to the host (D2H)"),
    ("device_stage_in_bytes", "host bytes staged onto the device (H2D)"),
    ("coll_staged_fallbacks", "device collectives run on the staged arm"),
    ("barriers", "barrier operations"),
    ("comm_splits", "communicators created by split/dup"),
    ("progress_polls", "progress engine passes"),
    ("time_in_wait", "seconds spent waiting for completions"),
    # decision-audit pvars (fed by the coll/nccl audit)
    ("coll_arm_native_count", "device collectives decided onto the native arm"),
    ("coll_arm_staged_count", "device collectives decided onto the staged arm"),
    ("coll_arm_quant_count", "device collectives decided onto the quant arm"),
    ("coll_wire_bytes", "modeled per-rank wire bytes for device collectives"),
    ("device_quant_collectives", "device collectives run block-quantized"),
    ("grad_bucket_count", "bucket exchanges in the last grad-sync plan"),
    ("grad_bucket_bytes", "total gradient bytes in the last grad-sync plan"),
    # MoE routing plane (fed by ompi_tpu_torch.moe; process-wide)
    ("moe_routed_tokens",
     "tokens dispatched to experts by the MoE routing plane"),
    ("moe_dropped_tokens",
     "tokens dropped at expert capacity by the MoE routing plane"),
    ("moe_hot_expert_trips",
     "hot-expert sentry trips (one expert carrying disproportionate "
     "token load)"),
]
# the grad_bucket_* pair lives in the overlap scheduler and the moe_*
# counters in the MoE plane (one state per process, not per Context):
# every read goes through to them
_READ_THROUGH = ("grad_bucket_count", "grad_bucket_bytes",
                 "moe_routed_tokens", "moe_dropped_tokens",
                 "moe_hot_expert_trips")


class Counters:
    def __init__(self) -> None:
        self._v: Dict[str, float] = {name: 0 for name, _ in COUNTERS}

    def inc(self, name: str, delta: float = 1) -> None:
        self._v[name] = self._v.get(name, 0) + delta

    def get(self, name: str) -> float:
        if name in _READ_THROUGH:
            if name.startswith("moe_"):
                from . import moe
                return moe.pvar_value(name)
            from .parallel import overlap
            return overlap.pvar_value(name)
        return self._v.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        out = dict(self._v)
        for name in _READ_THROUGH:
            out[name] = self.get(name)
        return out

    def dump(self, rank: int) -> str:
        lines = [f"SPC counters (rank {rank}):"]
        for name, help_ in COUNTERS:
            val = self.get(name)
            if val:
                lines.append(f"  {name:24s} {val:>14.6g}  {help_}")
        text = "\n".join(lines)
        print(text, flush=True)
        return text

