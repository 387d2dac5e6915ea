"""Topology traffic plane — per-link byte attribution over the mesh.

The port's copy of ``ompi_tpu/traffic/__init__.py``: every audited
collective completion is attributed to the directed mesh edges its
algorithm geometry uses, classified into ICI vs DCN planes, and judged
by a hot-link sentry.  Three coupled pieces:

* ``matrix``  — per-edge byte aggregate; ring collectives spread the
  audited per-rank wire bytes over the axis ring (honoring the decided
  ring direction: native = forward, bidir = both half-rings),
  all-to-all fills the bipartite block (alltoallv weighted by its
  counts matrix), ppermute charges its explicit perm, hierarchical ops
  split inner/outer, the staged arm rolls into the ``host`` plane.
* ``planes``  — ICI/DCN edge classification (host boundaries, the same
  inference as ``parallel.mesh.classify_axes``) + the per-plane byte
  split handed to the perf cost model as plane-keyed ``<coll>@<plane>``
  cells.
* ``sentry``  — hot links and plane imbalance, max/median with MAD
  gating, one trip per episode; ``traffic_hotlink`` trace instant +
  pvar.

Each process keeps its own matrix of its own per-rank wire figure, so on
a mesh of one process per card every rank's matrix is the reference's
single-controller matrix.  The port has no jit: where the reference
charges only calls made outside a trace, every port call is eager and
charges.

Ingestion sources (all behind ONE ``traffic.enabled`` attribute read):

1. ``coll/nccl._audit`` post-decision (``note_coll``) — the same call
   that feeds ``coll_wire_bytes``, so the conservation invariant
   ``sum(edge bytes) == coll_wire_bytes`` holds per attributed
   collective; any residue lands in ``traffic_unattributed_bytes``
   instead of vanishing.
2. DeviceComm point-to-point primitives (``ring_shift``/``push_row``)
   via ``note_ppermute`` — these also increment ``coll_wire_bytes`` so
   the invariant spans p2p-style device traffic.
3. Host wrappers with known ring schedules: collective-matmul call sites
   (direction from the ``collmm`` decision), ring attention,
   bucketed/perleaf grad sync, hierarchical allreduce (inner/outer
   split).  They have no Context — they feed the matrix and its
   internal ledger only.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import var as _var
from .matrix import (TrafficMatrix, a2a_weights, bipartite_edges,  # noqa: F401
                     perm_edges, ring_edges, spread)
from .matrix import grid
from .planes import plane_fn, plane_split  # noqa: F401
from .sentry import HotlinkSentry

_var.register("traffic", "", "enabled", False, type=bool, level=3,
              help="Master switch for the topology traffic plane "
                   "(per-edge attribution, ICI/DCN rollup, hot-link "
                   "sentry). Off by default; the disabled path is one "
                   "attribute read per call site.")

enabled: bool = bool(_var.get("traffic_enabled", False))

matrix = TrafficMatrix()
sentry = HotlinkSentry()

PVARS = ("traffic_hotlink_trips", "traffic_unattributed_bytes",
         "traffic_attributed_bytes", "traffic_edge_count")

# colls whose XLA lowering we model as the axis ring schedule (the
# busbw-factor convention: every rank forwards its wire share to its
# ring successor, so the per-rank wire figure spreads over ring edges)
_RING_COLLS = frozenset({
    "allreduce", "reduce", "bcast", "allgather", "allgatherv",
    "reduce_scatter", "reduce_scatter_block", "scan", "exscan",
    "gather", "gatherv", "scatter", "scatterv",
    # serving decode combines are plain ring allgather/reduce-scatter
    # under audited names — same geometry, so conservation (edge-sum ==
    # coll_wire_bytes) holds for the decode stream too
    "decode_ag", "decode_rs",
})
# bipartite block fills (uniform unless a counts matrix rode along)
_A2A_COLLS = frozenset({
    "alltoall", "alltoallv", "alltoallw",
    "neighbor_alltoall", "neighbor_alltoallv", "neighbor_alltoallw",
    # MoE token dispatch/combine ride the same ragged a2a geometry; the
    # router's counts matrix arrives as the audit's weights, so edges
    # carry the real per-(src, dst) token bytes, not a uniform fill
    "moe_dispatch", "moe_combine",
})


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def _on_enabled_var(v: Any) -> None:
    # mid-run OMPI_TPU_TRAFFIC_ENABLED / set_cli writes take effect;
    # the watcher fires on CHANGE only so enable()/disable() stay in
    # charge
    global enabled
    enabled = bool(v)


_var.watch("traffic_enabled", _on_enabled_var)


_lock = threading.Lock()


def _charge(mesh, coll: str, wire: int, edges, weights=None,
            feed_perf: bool = False) -> None:
    pf = plane_fn(mesh)
    parts = spread(wire, edges, weights)
    matrix.charge(coll, wire, parts, pf)
    if feed_perf:
        from .. import perf
        if perf.enabled:
            planes = plane_split(parts, pf)
            perf.note_planes(planes)
    sentry.check(matrix.snapshot_edges())


# ---- source 1: the coll/nccl decision audit --------------------------

def note_coll(dc, coll: str, arm: str, wire: int,
              weights: Optional[Any] = None,
              hier: Optional[Tuple] = None) -> None:
    """Attribute one audited device collective. ``dc`` is the
    DeviceComm the audit ran on (mesh + axis + size); ``wire`` is the
    exact per-rank wire-byte figure the audit added to
    ``coll_wire_bytes``; ``weights`` is the alltoallv counts matrix
    when one rode along; ``hier`` is the audit's hierarchical stage
    split ``(inner, outer, inner_stage_bytes, outer_bytes)`` when the
    hier/hier+quant arm carried the call — the stages charge the inner
    and outer rings separately so the per-plane rollup shows the HAN
    shape AND the conservation invariant still holds (2*inner_stage +
    outer == wire by construction, hierarchy.hier_wire_bytes)."""
    wire = int(wire)
    if wire <= 0:
        return
    mesh, axis = dc.mesh, dc.axis
    if arm in ("hier", "hier+quant") and hier is not None:
        inner, outer, inner_stage, outer_bytes, outer_native = hier
        note_hier_split(mesh, inner, outer, int(inner_stage),
                        int(outer_bytes),
                        expected_outer=int(outer_native))
        return
    if arm == "staged":
        # host round-trip: no mesh links carried these bytes
        matrix.charge_host(coll, wire)
        return
    if coll in _A2A_COLLS:
        edges = bipartite_edges(mesh, axis)
        w = None
        if weights is not None:
            import numpy as np
            C = np.asarray(weights)
            n = len(edges) // max(C.shape[0] * (C.shape[0] - 1), 1)
            w = a2a_weights(C, n_lines=n)
        _charge(mesh, coll, wire, edges, w, feed_perf=True)
        return
    if coll in _RING_COLLS:
        direction = "bidir" if arm == "bidir" else "fwd"
        _charge(mesh, coll, wire, ring_edges(mesh, axis, direction),
                feed_perf=True)
        return
    # unknown geometry: never silently dropped
    matrix.charge_unattributed(coll, wire)


# ---- source 2: eager DeviceComm ppermute primitives ------------------

def note_ppermute(mesh, axis: str, pairs: Sequence[Tuple[int, int]],
                  nbytes: int, spc=None, coll: str = "ppermute") -> None:
    """Charge an explicit perm's (src_pos, dst_pos) pairs along
    ``axis``. ``nbytes`` is the per-rank wire figure; when an SPC table
    is given it is also added to ``coll_wire_bytes`` so the
    conservation invariant covers eager ppermute traffic."""
    nbytes = int(nbytes)
    edges = perm_edges(mesh, axis, pairs)
    if nbytes <= 0 or not edges:
        return
    if spc is not None:
        spc.inc("coll_wire_bytes", nbytes)
    _charge(mesh, coll, nbytes, edges)


# ---- source 3: eager host wrappers with known ring schedules ---------

def note_ring(mesh, axis: str, nbytes: int, coll: str,
              direction: str = "fwd") -> None:
    """Charge ``nbytes`` per-rank wire bytes over the axis ring:
    direction 'fwd' | 'rev' | 'bidir' (the collmm arms map native ->
    fwd/rev by the call site's ``reverse`` flag, bidir -> both)."""
    nbytes = int(nbytes)
    if nbytes <= 0:
        return
    _charge(mesh, coll, nbytes, ring_edges(mesh, axis, direction))


def note_a2a(mesh, axis: str, nbytes: int, coll: str) -> None:
    """Charge ``nbytes`` per-rank all_to_all wire bytes over the axis'
    full bipartite edge set (the audited dispatch convention: wire =
    the per-rank shard payload, factor 1 — the (n-1)/n on-wire
    discount lives in the busbw factor table, not the byte ledger).
    The ulysses wrapper is its caller (ROADMAP P16a-2)."""
    nbytes = int(nbytes)
    if nbytes <= 0:
        return
    _charge(mesh, coll, nbytes, bipartite_edges(mesh, axis))


def note_reshard_step(mesh, kind: str, axes, wire: int,
                      pairs: Optional[Sequence[Tuple[int, int]]] = None,
                      coll: str = "reshard") -> Dict[str, int]:
    """Attribute one reshard plan step's wire bytes to its real edge
    set and return the per-plane split (plan steps carry their own
    timing, so the reshard executor banks the split into the perf
    ledger itself instead of riding timed_coll's in-flight entry).

    kind: 'ring' — all_gather's forward chunk ring over the axis;
    'a2a' — all_to_all / device_put full bipartite exchange over the
    (possibly joint) axis group; 'perm' — ppermute's explicit
    (src, dst) pairs over the joint axis space.  ``spread`` is exact
    (largest-remainder), so edge sums equal ``wire`` byte-for-byte and
    the conservation invariant covers resharding traffic."""
    wire = int(wire)
    ax = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    axis: Any = ax[0] if len(ax) == 1 else ax
    if wire <= 0:
        return {}
    if kind == "ring":
        edges = ring_edges(mesh, axis, "fwd")
    elif kind == "a2a":
        edges = bipartite_edges(mesh, axis)
    elif kind == "perm":
        edges = perm_edges(mesh, axis, pairs or ())
    else:
        raise ValueError(f"note_reshard_step: unknown kind {kind!r} "
                         "(want ring|a2a|perm)")
    if not edges:
        matrix.charge_unattributed(coll, wire)
        return {}
    pf = plane_fn(mesh)
    parts = spread(wire, edges)
    matrix.charge(coll, wire, parts, pf)
    sentry.check(matrix.snapshot_edges())
    return plane_split(parts, pf)


# hierarchical split ledger (the report's "hier" row): the
# accumulated inner (ICI RS+AG) vs outer (DCN allreduce) attribution
# plus the native-outer expectation — outer bytes above the expectation
# mean the 1/n_inner slow-plane cut is NOT happening
_hier_ledger = {"count": 0, "inner_bytes": 0, "outer_bytes": 0,
                "expected_outer_bytes": 0, "n_inner": 0}


def note_hier_split(mesh, inner: str, outer: str, inner_stage: int,
                    outer_bytes: int,
                    expected_outer: Optional[int] = None) -> None:
    """Charge one hierarchical collective's exact stage bytes: the
    inner RS and AG rings carry ``inner_stage`` each, the outer ring
    ``outer_bytes`` (already quantized for hier+quant — the audit's
    figures ARE what travels, so conservation holds).  The three
    stages' plane splits merge into ONE perf.note_planes call (the
    in-flight entry keeps a single split) and fold into the hier
    ledger ``report()`` carries."""
    pf = plane_fn(mesh)
    merged: Dict[str, int] = {}

    def _stage(coll: str, nbytes: int, axis: str) -> None:
        if nbytes <= 0:
            return
        parts = spread(nbytes, ring_edges(mesh, axis, "fwd"))
        matrix.charge(coll, nbytes, parts, pf)
        for p, b in plane_split(parts, pf).items():
            merged[p] = merged.get(p, 0) + b

    inner_stage, outer_bytes = int(inner_stage), int(outer_bytes)
    _stage("hier_reduce_scatter", inner_stage, inner)
    _stage("hier_allgather", inner_stage, inner)
    _stage("hier_allreduce", outer_bytes, outer)
    from .. import perf
    if perf.enabled and merged:
        perf.note_planes(merged)
    sentry.check(matrix.snapshot_edges())
    shape, names = grid(mesh)
    with _lock:
        _hier_ledger["count"] += 1
        _hier_ledger["inner_bytes"] += 2 * inner_stage
        _hier_ledger["outer_bytes"] += outer_bytes
        _hier_ledger["expected_outer_bytes"] += int(
            expected_outer if expected_outer is not None else outer_bytes)
        _hier_ledger["n_inner"] = int(shape[names.index(inner)])


def note_hierarchical(mesh, inner: str, outer: str,
                      nbytes: int) -> None:
    """The HAN split for one hierarchical allreduce of ``nbytes``
    per-rank bytes: reduce-scatter inner ((ni-1)/ni), allreduce outer
    on the scattered 1/ni fraction (2(no-1)/no), allgather inner —
    the outer (DCN) plane carries ni-fold fewer bytes, which is the
    entire point of the algorithm and exactly what the per-plane
    rollup should show."""
    shape, names = grid(mesh)
    ni = shape[names.index(inner)]
    no = shape[names.index(outer)]
    nbytes = int(nbytes)
    if nbytes <= 0:
        return
    stage = int((ni - 1) / ni * nbytes) if ni > 1 else 0
    outer_b = int(2 * (no - 1) / no * (nbytes // max(ni, 1))) \
        if no > 1 else 0
    note_hier_split(mesh, inner, outer, stage, outer_b)


# ---- pvars + report --------------------------------------------------

def pvar_value(name: str) -> float:
    if name == "traffic_hotlink_trips":
        return float(sentry.trips())
    if name == "traffic_unattributed_bytes":
        return float(matrix.unattributed_bytes)
    if name == "traffic_attributed_bytes":
        return float(matrix.placed_bytes)
    if name == "traffic_edge_count":
        return float(matrix.edge_count())
    raise KeyError(name)


def report() -> Dict[str, Any]:
    """Structured snapshot (the reference's comm_doctor --traffic reads
    it)."""
    doc = matrix.to_json()
    doc["hotlink_trips"] = sentry.trips()
    doc["verdicts"] = sentry.verdicts()
    with _lock:
        if _hier_ledger["count"]:
            doc["hier"] = dict(_hier_ledger)
    return doc


def prometheus_rows(rank: int = 0, comm: str = "world",
                    prefix: str = "ompi_tpu") -> List[str]:
    """Per-edge + per-plane gauge families for spc.export_prometheus
    (empty when the matrix is: families only appear once there is
    traffic to label)."""
    rows = matrix.rows()
    planes = matrix.plane_totals()
    if not rows and not planes:
        return []
    out: List[str] = []
    if rows:
        out.append(f"# HELP {prefix}_traffic_edge_bytes per-link "
                   "attributed wire bytes (topology traffic plane)")
        out.append(f"# TYPE {prefix}_traffic_edge_bytes gauge")
        for r in rows:
            out.append(
                f'{prefix}_traffic_edge_bytes{{rank="{rank}",'
                f'comm="{comm}",src="{r["src"]}",dst="{r["dst"]}",'
                f'plane="{r["plane"]}"}} {r["bytes"]:.10g}')
    if planes:
        out.append(f"# HELP {prefix}_traffic_plane_bytes attributed "
                   "wire bytes per plane (ici/dcn/host)")
        out.append(f"# TYPE {prefix}_traffic_plane_bytes gauge")
        for p, b in sorted(planes.items()):
            out.append(
                f'{prefix}_traffic_plane_bytes{{rank="{rank}",'
                f'comm="{comm}",plane="{p}"}} {b:.10g}')
    return out


def reset() -> None:
    matrix.clear()
    sentry.reset()
    with _lock:
        for k in _hier_ledger:
            _hier_ledger[k] = 0
