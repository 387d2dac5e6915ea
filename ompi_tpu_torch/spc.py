"""Software performance counters (SPC).

≙ ompi/runtime/ompi_spc.c (≈100 counters exported as MPI_T pvars, dumped at
finalize). One Counters instance per Context; the p2p engine and coll
framework increment them; ``dump()`` prints at finalize when
``spc_dump_enabled`` is set.

The port's copy of ``ompi_tpu/spc.py``: ``Counters``, the counters the
MPI surface and the device component feed, and the reads of the audit
planes (``trace_dropped_events``, ``perf.PVARS``, ``traffic.PVARS``),
the overlap scheduler's bucket pair and the MoE routing plane's three
counters, all read through to their (process-wide) planes; the
Prometheus text exposition (``export_prometheus``) with the traffic
plane's per-edge and per-plane rows.  The reads of the later planes
(health, numerics, reshard, elastic, policy, serving, history) come with
their slices (ROADMAP P16a-2, P16b), as do the MPI_T pvar surface and
the per-peer monitoring matrices.
"""

from __future__ import annotations

from typing import Dict, List

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
    ("trace_dropped_events", "trace events lost to ring-buffer overflow"),
    ("grad_bucket_count", "bucket exchanges in the last grad-sync plan"),
    ("grad_bucket_bytes", "total gradient bytes in the last grad-sync plan"),
    # continuous performance plane (fed by ompi_tpu_torch.perf;
    # process-wide)
    ("perf_regressions",
     "sentry trips: sustained busbw/goodput shortfall vs the ledger"),
    ("perf_goodput_pct",
     "EWMA step goodput (compute share of wall time, percent)"),
    ("perf_mfu_pct", "EWMA model-FLOPs utilization, percent"),
    ("perf_ledger_buckets",
     "(coll, arm, size-bucket) cells held by the learned cost model"),
    # topology traffic plane (fed by ompi_tpu_torch.traffic; process-wide)
    ("traffic_attributed_bytes",
     "wire bytes placed on mesh edges / the host plane by the traffic "
     "matrix"),
    ("traffic_unattributed_bytes",
     "wire bytes the traffic matrix could not place on any edge "
     "(attribution bugs; 0 when the conservation invariant holds)"),
    ("traffic_hotlink_trips",
     "hot-link sentry trips (one directed edge carrying "
     "disproportionate bytes)"),
    ("traffic_edge_count", "directed mesh edges holding attributed bytes"),
    # MoE routing plane (fed by ompi_tpu_torch.moe; process-wide)
    ("moe_routed_tokens",
     "tokens dispatched to experts by the MoE routing plane"),
    ("moe_dropped_tokens",
     "tokens dropped at expert capacity by the MoE routing plane"),
    ("moe_hot_expert_trips",
     "hot-expert sentry trips (one expert carrying disproportionate "
     "token load)"),
]
# trace_dropped_events lives in the tracer, the grad_bucket_* pair in the
# overlap scheduler, the perf_*/traffic_* pvars in their planes and the
# moe_* counters in the MoE plane (one state per process, not per
# Context): every read goes through to them
_READ_THROUGH = ("trace_dropped_events", "grad_bucket_count",
                 "grad_bucket_bytes", "moe_routed_tokens",
                 "moe_dropped_tokens", "moe_hot_expert_trips")


def _read_through(name: str):
    """The plane-held value of ``name``, or None when no plane holds it."""
    if name == "trace_dropped_events":
        from . import trace
        return trace.dropped_events()
    if name in ("grad_bucket_count", "grad_bucket_bytes"):
        from .parallel import overlap
        return overlap.pvar_value(name)
    if name.startswith("perf_"):
        from . import perf
        if name in perf.PVARS:
            return perf.pvar_value(name)
    if name.startswith("traffic_"):
        from . import traffic
        if name in traffic.PVARS:
            return traffic.pvar_value(name)
    if name in _READ_THROUGH:       # the MoE routing plane's three
        from . import moe
        return moe.pvar_value(name)
    return None


class Counters:
    def __init__(self) -> None:
        self._v: Dict[str, float] = {name: 0 for name, _ in COUNTERS}

    def inc(self, name: str, delta: float = 1) -> None:
        self._v[name] = self._v.get(name, 0) + delta

    def get(self, name: str) -> float:
        got = _read_through(name)
        return self._v.get(name, 0) if got is None else got

    def snapshot(self) -> Dict[str, float]:
        out = dict(self._v)
        from . import perf, traffic
        for name in _READ_THROUGH + perf.PVARS + traffic.PVARS:
            out[name] = self.get(name)
        return out

    def export_prometheus(self, rank: int = 0, comm: str = "world",
                          prefix: str = "ompi_tpu") -> str:
        """This rank's pvars as Prometheus text exposition (counter
        families labeled by rank); module-level :func:`export_prometheus`
        adds the traffic plane's rows."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, help_ in COUNTERS:
            lines.append(f"# HELP {prefix}_{name} {_prom_escape(help_)}")
            lines.append(f"# TYPE {prefix}_{name} counter")
            lines.append(f'{prefix}_{name}{{rank="{rank}",'
                         f'comm="{comm}"}} {snap.get(name, 0):.10g}')
        return "\n".join(lines) + "\n"

    def dump(self, rank: int) -> str:
        lines = [f"SPC counters (rank {rank}):"]
        for name, help_ in COUNTERS:
            val = self.get(name)
            if val:
                lines.append(f"  {name:24s} {val:>14.6g}  {help_}")
        text = "\n".join(lines)
        print(text, flush=True)
        return text


# -- Prometheus text exposition ----------------------------------------------

def _prom_escape(s: str) -> str:
    """HELP-text escaping per the Prometheus text format (backslash and
    newline)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def export_prometheus(ctx, comm=None, prefix: str = "ompi_tpu") -> str:
    """One rank's metrics surface in the Prometheus text exposition format:
    every counter as a ``<prefix>_<name>{rank,comm}`` counter family plus,
    once the traffic plane holds bytes, its per-edge and per-plane gauge
    families (``traffic.prometheus_rows``).

        open(f"metrics.{ctx.rank}.prom", "w").write(
            spc.export_prometheus(ctx))

    ``ctx`` is a Context (anything with ``.spc``; ``.rank`` is honored
    when present).  ``comm`` optionally names the communicator label on
    every sample (default ``world``)."""
    rank = int(getattr(ctx, "rank", 0))
    label = comm if isinstance(comm, str) else (
        getattr(comm, "name", None) or "world")
    counters = getattr(ctx, "spc", ctx)
    text = counters.export_prometheus(rank=rank, comm=label, prefix=prefix)
    from . import traffic
    trows = traffic.prometheus_rows(rank, comm=label, prefix=prefix)
    if trows:
        text += "\n".join(trows) + "\n"
    return text
