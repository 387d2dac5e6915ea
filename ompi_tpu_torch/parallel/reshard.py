"""Array redistribution on a mesh: compiled minimal-collective ``reshard``.

Counterpart of the intra-mesh part of ``ompi_tpu/parallel/reshard.py``
(``:1-700``).  A layout transition between two shardings of one array on
one mesh decomposes into a short sequence of the device collectives the
port already has, with bounded peak memory ("Memory-efficient array
redistribution through portable collective communication", arXiv
2112.01075):

  plan grammar (one collective per step):
    all_to_all[a:d->e]   move axis ``a`` from array dim d to dim e
                         (flat memory: in == out == shard bytes)
    all_gather[a@d]      unshard dim d over axis ``a`` (grow)
    slice[a@d]           shard a replicated dim d over axis ``a``
                         (shrink, zero wire bytes — a local slice)
    ppermute[g~b@..]     exchange same-sized axes g and b (flat memory,
                         one hop per rank)
    device_put           the fallback for ragged specs the step grammar
                         cannot express and for plans whose step sequence
                         would breach the peak-memory bound

  ordering discipline: shrinking slices fire as soon as their dim's
  prefix is ready, moves/swaps run flat, gathers are deferred to last —
  so intermediate shards never exceed max(src_shard, dst_shard) and the
  per-step live set (input + output) stays within
  ``reshard_peak_factor × max(src_shard, dst_shard)``.

The plan compiler (``compile_plan``) is the reference's, over the port's
specs — tuples of axis names or None per dim, as in
``models/transformer.param_specs`` — and gives the same steps,
``describe()`` strings, shard bytes and bound.  One step differs:
``device_put``.  The reference hands the whole array to XLA's resharding
transfer, whose live set is src + dst.  Here each process holds its own
block, so the port's ``device_put`` all-gathers the source's sharded dims
over their axes (a ragged dim's blocks padded to the ceiling and cut back
after the gather) and then slices this rank's block of the destination,
in one step.  Its wire bytes are those gathers' ring bytes, and its peak
is the whole (padded) array beside the larger of the shards it grew from
and was cut to: above the bound by construction, where the reference's
is within it.

Execution: each process holds this rank's shard; ``Resharder.run`` takes
it and returns this rank's shard under the destination spec, as fresh
tensors.  Every step runs on ``parallel.collectives`` over the mesh
axis's process group (NCCL on the card, gloo on CPU tensors):
``all_to_all_axis``, ``all_gather_axis``, a local slice, ``ppermute``.
Each step is decided under the coll name ``reshard`` through
``coll/nccl.decide_mode`` (force var ``coll_nccl_reshard_mode``; native
is the only arm a layout step has) and audited as the reference audits
it: the module's ``reshard_steps``/``reshard_bytes`` counters, with an
spc table attached ``coll_arm_<arm>_count`` and ``coll_wire_bytes``, the
traffic edges of the step's wire (``all_to_all`` and ``device_put`` the
axes' bipartite exchange, ``all_gather`` their ring, ``ppermute`` its
pairs), a perf sample of each step with wire on two or more devices
(timed to completion, with a synchronize on the card taken under
``perf.enabled`` only) and one ``decide:reshard`` event a step, under
this process's world rank.  ``run`` keeps the steps' rows in
``report()["last"]``; a compiled plan enters the plan log once, with a
``reshard:compile_plan`` span (a cache hit: a ``cache_hit:reshard_plan``
instant).  The reference's ``build:*`` spans time its per-step program
compiles; the port compiles nothing and has none (ROADMAP, Departures).
A dim sharded over a tuple of axes is cut in row-major blocks over their
product, and a step over several axes runs on their product group
(``mesh.axes_group``); such a dim must divide over the product.

Cross-mesh mode (reference ``:736-1170``): ``compile_cross_plan`` cuts a
move from a source mesh onto a destination mesh whose ranks are a subset
of the source's into per-destination pieces, each a whole source block
(or a crop of a replica), and ``cross_reshard`` runs it.  A mesh there is
a ``RankMesh``: axis names and sizes and the world ranks in row-major
order, the reference's ``mesh.devices``, so a plan needs no process group
and a mesh may cover any subset of the world (the fleet's KV-page
migration moves pages between two rows of its mesh).  Each piece whose
source rank is not its destination rank is one send and one receive on
the world group, in one ``batch_isend_irecv``; local pieces are copies;
every piece lands in place in the destination block.  A cross plan is
audited once, as in the reference: one decision (``cross=True``), the
counters, a perf sample, and one traffic charge a (source, destination)
pair of the plan's moving pieces, placed on the WORLD ranks the pair
joins (``RankMesh.ranks``), so a migration's edges sum to its wire on
the same edge space as every other collective of the world; its compile
records ``reshard:compile_cross_plan`` (a hit:
``cache_hit:reshard_cross_plan``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import perf, trace, traffic
from ..core import var as _var
from .collectives import (_p2p, _wire, all_gather_axis, all_to_all_axis,
                          ppermute)
from .mesh import (axes_group, axes_position, axis_rank, classify_axes,
                   group_order, sim_dcn_axes)

_var.register("reshard", "", "peak_factor", 2.0, type=float, level=3,
              help="Peak-live-bytes bound for compiled reshard plans, "
                   "as a multiple of max(src_shard, dst_shard) per "
                   "device (arXiv 2112.01075).  A plan whose step "
                   "accounting would breach the bound is replaced by "
                   "the single-step device_put plan.")

_lock = threading.Lock()
_counts: Dict[str, int] = {"reshard_plans": 0, "reshard_steps": 0,
                           "reshard_bytes": 0}
# compiled plan summaries (intra-mesh and cross) + the last executed
# plan's audit (bounded: a cache view, not a history)
_plan_log: "deque" = deque(maxlen=32)
_last_run: Optional[Dict[str, Any]] = None


class ReshardError(ValueError):
    """A (src, dst, mesh, shape) tuple the plan compiler rejects loudly
    (unknown/repeated mesh axes — never a silent host fallback)."""


# ---------------------------------------------------------------------------
# plan representation
# ---------------------------------------------------------------------------

Placement = Tuple[Tuple[str, ...], ...]     # per-dim axis groups
Spec = Tuple[Any, ...]                      # per-dim axis name, tuple, None


@dataclass(frozen=True)
class PlanStep:
    op: str                       # a grammar step (module docstring)
    axes: Tuple[str, ...]         # mesh axes driving the step
    dim: int                      # array dim acted on / move target dim
    src_dim: int                  # move/exchange source dim (== dim otherwise)
    in_spec: Spec
    out_spec: Spec
    in_bytes: int                 # per-device live bytes entering the step
    out_bytes: int                # per-device live bytes leaving the step
    wire_bytes: int               # modeled per-rank wire bytes
    perm: Tuple[Tuple[int, int], ...] = ()   # ppermute pairs (flat positions)

    def describe(self) -> str:
        if self.op == "all_to_all":
            return (f"all_to_all[{'+'.join(self.axes)}:"
                    f"{self.src_dim}->{self.dim}]")
        if self.op == "all_gather":
            return f"all_gather[{self.axes[0]}@{self.dim}]"
        if self.op == "slice":
            return f"slice[{self.axes[0]}@{self.dim}]"
        if self.op == "ppermute":
            g, b = self.axes
            if self.src_dim == self.dim:
                return f"ppermute[{g}~{b}@{self.dim}]"
            return f"ppermute[{g}@{self.src_dim}~{b}@{self.dim}]"
        return self.op


@dataclass(frozen=True)
class ReshardPlan:
    key: tuple
    shape: Tuple[int, ...]
    dtype: str
    src: Placement
    dst: Placement
    steps: Tuple[PlanStep, ...]
    src_shard_bytes: int
    dst_shard_bytes: int
    peak_bytes: int               # max per-step (in + out) live bytes
    wire_bytes: int               # sum of step wire figures
    bound_bytes: int              # factor * max(src_shard, dst_shard)
    fallback_reason: str = ""     # non-empty when device_put replaced steps

    def describe(self) -> List[str]:
        return [s.describe() for s in self.steps]

    @property
    def label(self) -> str:
        return (f"{_fmt_placement(self.src)}->{_fmt_placement(self.dst)}"
                f"/{self.dtype}{list(self.shape)}")


def _fmt_placement(pl: Placement) -> str:
    parts = []
    for grp in pl:
        if not grp:
            parts.append("_")
        elif len(grp) == 1:
            parts.append(grp[0])
        else:
            parts.append("(" + "+".join(grp) + ")")
    return "[" + ",".join(parts) + "]"


def _norm(spec, ndim: int) -> Placement:
    """Spec (a sequence, or None) → per-dim tuples of axis names."""
    parts: Sequence = tuple(spec) if spec is not None else ()
    out: List[Tuple[str, ...]] = []
    for d in range(ndim):
        e = parts[d] if d < len(parts) else None
        if e is None:
            out.append(())
        elif isinstance(e, (tuple, list)):
            out.append(tuple(str(a) for a in e))
        else:
            out.append((str(e),))
    return tuple(out)


def _spec_of(pl: Placement) -> Spec:
    ents = []
    for grp in pl:
        if not grp:
            ents.append(None)
        elif len(grp) == 1:
            ents.append(grp[0])
        else:
            ents.append(tuple(grp))
    return tuple(ents)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, or of a mapping given as one (the
    plan is host math over the sizes alone)."""
    if isinstance(mesh, dict):
        return {str(a): int(n) for a, n in mesh.items()}
    names = mesh.mesh_dim_names
    return {a: int(mesh.mesh.shape[i]) for i, a in enumerate(names)}


def _dtype_of(dtype) -> Tuple[str, int]:
    """(name, itemsize) of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch."), dtype.itemsize
    dt = np.dtype(dtype)
    return dt.name, dt.itemsize


# ---------------------------------------------------------------------------
# plan compiler
# ---------------------------------------------------------------------------

def compile_plan(shape: Sequence[int], dtype, src_spec, dst_spec,
                 mesh, peak_factor: Optional[float] = None) -> ReshardPlan:
    """Compile a (src, dst, mesh) triple into a minimal collective
    sequence.  Pure host math — no device work, no caches, no audit;
    the Resharder wraps this with caching and per-step dispatch.  ``mesh``
    is a DeviceMesh or a {axis: size} mapping."""
    shape = tuple(int(s) for s in shape)
    dt_name, itemsize = _dtype_of(dtype)
    src = _norm(src_spec, len(shape))
    dst = _norm(dst_spec, len(shape))
    sizes = _axis_sizes(mesh)
    for pl, which in ((src, "src"), (dst, "dst")):
        seen = set()
        for grp in pl:
            for a in grp:
                if a not in sizes:
                    raise ReshardError(
                        f"reshard: {which} spec names axis {a!r} not on "
                        f"mesh {tuple(sizes)}")
                if a in seen:
                    raise ReshardError(
                        f"reshard: {which} spec uses axis {a!r} on more "
                        "than one dim")
                seen.add(a)
    factor = float(peak_factor if peak_factor is not None
                   else _var.get("reshard_peak_factor", 2.0))
    total = itemsize * int(np.prod(shape)) if shape else itemsize

    def nshards(grp: Tuple[str, ...]) -> int:
        n = 1
        for a in grp:
            n *= sizes[a]
        return n

    def shard_bytes(pl: Placement) -> int:
        b = total
        for d, grp in enumerate(pl):
            n = nshards(grp)
            b = b // n if b % n == 0 else int(math.ceil(b / n))
        return max(b, itemsize)

    src_b, dst_b = shard_bytes(src), shard_bytes(dst)
    bound = int(factor * max(src_b, dst_b))
    key = (src, dst, shape, dt_name)

    def _plan(steps, peak, wire, why=""):
        return ReshardPlan(key=key, shape=shape, dtype=dt_name,
                           src=src, dst=dst, steps=tuple(steps),
                           src_shard_bytes=src_b, dst_shard_bytes=dst_b,
                           peak_bytes=peak, wire_bytes=wire,
                           bound_bytes=bound, fallback_reason=why)

    if src == dst:
        return _plan((), 0, 0)

    def _device_put_plan(why: str) -> ReshardPlan:
        # gather the source's sharded dims, then slice the destination's
        # block: see the module docstring for its bytes
        wire, peak = _device_put_cost(shape, itemsize, src, dst, nshards)
        step = PlanStep(op="device_put", axes=tuple(sizes),
                        dim=0, src_dim=0, in_spec=_spec_of(src),
                        out_spec=_spec_of(dst), in_bytes=src_b,
                        out_bytes=dst_b, wire_bytes=wire)
        return _plan((step,), peak, wire, why)

    divisible = all(
        shape[d] % nshards(src[d]) == 0 and shape[d] % nshards(dst[d]) == 0
        for d in range(len(shape)))
    if not divisible:
        return _device_put_plan(
            "ragged: a dim does not divide by its sharding axes "
            "(shard_map steps need even shards)")

    placement: List[Tuple[str, ...]] = list(src)
    ndim = len(shape)
    dst_dim_of: Dict[str, int] = {a: d for d, grp in enumerate(dst)
                                  for a in grp}
    steps: List[PlanStep] = []
    cur_b = src_b
    peak = 0
    wire_total = 0

    def placed_anywhere(a: str) -> bool:
        return any(a in grp for grp in placement)

    def emit(op: str, axes: Tuple[str, ...], dim: int, src_dim: int,
             before: Placement, after: Placement, wire: int,
             perm: Tuple = ()) -> None:
        nonlocal cur_b, peak, wire_total
        in_b, out_b = shard_bytes(before), shard_bytes(after)
        steps.append(PlanStep(op=op, axes=axes, dim=dim, src_dim=src_dim,
                              in_spec=_spec_of(before),
                              out_spec=_spec_of(after), in_bytes=in_b,
                              out_bytes=out_b, wire_bytes=int(wire),
                              perm=perm))
        cur_b = out_b
        peak = max(peak, in_b + out_b)
        wire_total += int(wire)

    def _transpose_perm(n: int) -> Tuple[Tuple[int, int], ...]:
        # device (i, j) over the joint (g, b) space receives from (j, i)
        return tuple((j * n + i, i * n + j)
                     for i in range(n) for j in range(n))

    guard = 0
    while tuple(placement) != dst:
        guard += 1
        if guard > 8 * ndim * (len(sizes) + 1):
            return _device_put_plan("scheduler found no step sequence")
        progress = False

        # 1) ppermute: same-dim axis substitution g -> b (equal sizes,
        #    g leaving the layout entirely, b entering it) — flat memory
        #    where gather+slice would blow up n-fold
        for d in range(ndim):
            cur, want = placement[d], dst[d]
            if (cur and want and len(cur) == len(want)
                    and cur[:-1] == want[:-1] and cur[-1] != want[-1]):
                g, b = cur[-1], want[-1]
                if (sizes[g] == sizes[b] and g not in dst_dim_of
                        and not placed_anywhere(b)):
                    after = list(placement)
                    after[d] = want
                    n = sizes[g]
                    w = cur_b * (n * n - n) // (n * n)
                    emit("ppermute", (g, b), d, d, tuple(placement),
                         tuple(after), w, _transpose_perm(n))
                    placement[d] = want
                    progress = True

        # 2) ppermute: dim-pair exchange g@d <-> b@e (equal sizes) —
        #    the cyclic-move deadlock resolved in one flat hop
        for d in range(ndim):
            for e in range(ndim):
                if d == e:
                    continue
                cd, wd = placement[d], dst[d]
                ce, we = placement[e], dst[e]
                if not (cd and ce and wd and we):
                    continue
                g, b = cd[-1], ce[-1]
                if (g != b and sizes[g] == sizes[b]
                        and wd == cd[:-1] + (b,) and we == ce[:-1] + (g,)):
                    after = list(placement)
                    after[d], after[e] = wd, we
                    n = sizes[g]
                    w = cur_b * (n * n - n) // (n * n)
                    emit("ppermute", (g, b), e, d, tuple(placement),
                         tuple(after), w, _transpose_perm(n))
                    placement[d], placement[e] = wd, we
                    progress = True

        # 3) moves: an innermost suffix of dim d's axes belongs — in
        #    order — on dim e whose prefix is ready: one all_to_all
        #    over the (joint) axis group, flat memory.  Longest suffix
        #    first, so a whole group like ("x","y") moves in a single
        #    step instead of two.
        for d in range(ndim):
            cur = placement[d]
            for k in range(len(cur), 0, -1):
                grp = cur[-k:]
                e = dst_dim_of.get(grp[0])
                if e is None or e == d:
                    continue
                q = len(placement[e])
                if (placement[e] == dst[e][:q]
                        and dst[e][q:q + k] == grp):
                    after = list(placement)
                    after[d] = cur[:-k]
                    after[e] = placement[e] + grp
                    m = nshards(grp)
                    w = cur_b * (m - 1) // m
                    emit("all_to_all", grp, e, d, tuple(placement),
                         tuple(after), w)
                    placement[d], placement[e] = after[d], after[e]
                    progress = True
                    break

        # 4) slices: the next wanted axis of a ready dim is currently
        #    unplaced — shard it locally (shrinks, zero wire)
        for d in range(ndim):
            cur, want = placement[d], dst[d]
            if cur == want[:len(cur)] and len(want) > len(cur):
                b = want[len(cur)]
                if not placed_anywhere(b):
                    after = list(placement)
                    after[d] = cur + (b,)
                    emit("slice", (b,), d, d, tuple(placement),
                         tuple(after), 0)
                    placement[d] = after[d]
                    progress = True

        if progress:
            continue

        # 5) gathers, last: remove the innermost axis past some dim's
        #    common prefix (also breaks move deadlocks — a gathered
        #    axis becomes re-addable by slice, since the data is then
        #    replicated over it)
        for d in range(ndim):
            cur, want = placement[d], dst[d]
            p = 0
            while p < min(len(cur), len(want)) and cur[p] == want[p]:
                p += 1
            if len(cur) > p:
                g = cur[-1]
                after = list(placement)
                after[d] = cur[:-1]
                m = sizes[g]
                w = cur_b * (m - 1)
                emit("all_gather", (g,), d, d, tuple(placement),
                     tuple(after), w)
                placement[d] = after[d]
                progress = True
                break
        if not progress:
            return _device_put_plan("scheduler found no step sequence")

    if peak > bound:
        return _device_put_plan(
            f"peak {peak}B over bound {bound}B "
            f"(reshard_peak_factor={factor:g})")
    return _plan(steps, peak, wire_total)


def _device_put_cost(shape, itemsize: int, src: Placement, dst: Placement,
                     nshards) -> Tuple[int, int]:
    """(wire bytes a rank, peak live bytes) of the port's device_put: each
    source-sharded dim, its blocks padded to the ceiling, all-gathered in
    dim order ((m − 1) blocks over the wire a rank), then this rank's
    destination block cut from the whole array.  Peak: the largest
    gather's input + output, or the gathered array beside the block cut
    from it."""
    local = [-(-s // nshards(src[d])) for d, s in enumerate(shape)]
    cur = itemsize * int(np.prod(local))
    wire = peak = 0
    for d, grp in enumerate(src):
        if not grp:
            continue
        m = nshards(grp)
        wire += cur * (m - 1)
        peak = max(peak, cur + cur * m)
        cur *= m
    dst_b = itemsize * int(np.prod([-(-s // nshards(dst[d]))
                                    for d, s in enumerate(shape)]))
    return wire, max(peak, cur + dst_b)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _block(n: int, i: int, extent: int) -> Tuple[int, int]:
    """(start, size) of member i's block when ``extent`` is cut over n
    members: ceiling-sized blocks, the last ones short or empty (how a
    NamedSharding lays out a dim the axis does not divide)."""
    c = -(-extent // n)
    start = min(i * c, extent)
    return start, min(c, extent - start)


def _grp_block(mesh, grp: Tuple[str, ...], extent: int) -> Tuple[int, int]:
    """(start, size) of this rank's block of a dim of ``extent`` laid out
    over the axes ``grp``: blocks over their row-major product."""
    if not grp:
        return 0, int(extent)
    sizes = _axis_sizes(mesh)
    n = int(np.prod([sizes[a] for a in grp]))
    return _block(n, axes_position(mesh, grp), int(extent))


def _local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """This rank's block shape of a ``shape`` array laid out by ``spec``
    (one axis name, a tuple of them, or None per dim) on ``mesh``."""
    return tuple(_grp_block(mesh, grp, int(shape[d]))[1]
                 for d, grp in enumerate(_norm(spec, len(shape))))


def _check_tuple_dims(plan: "ReshardPlan", sizes: Dict[str, int]) -> None:
    """A dim laid out over a tuple of axes at any point of the plan must
    divide over their product: the steps then cut it in nested blocks
    equal to the product's blocks (a ragged dim's nested and flat
    ceiling blocks differ)."""
    ndim = len(plan.shape)
    placements = [plan.src, plan.dst] + [
        _norm(sp, ndim) for st in plan.steps
        for sp in (st.in_spec, st.out_spec)]
    for pl in placements:
        for d, grp in enumerate(pl):
            n = int(np.prod([sizes[a] for a in grp])) if grp else 1
            if len(grp) > 1 and plan.shape[d] % n:
                raise ValueError(
                    f"reshard: dim {d} ({plan.shape[d]}) laid out over the "
                    f"tuple of axes {grp} must divide over their {n} "
                    f"members")


class Resharder:
    """Per-mesh plan cache + step executor.  Making one is collective (it
    classifies the mesh's axes, ``mesh.classify_axes``); so is ``run``."""

    def __init__(self, mesh, spc=None) -> None:
        if mesh.device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("reshard on a cuda mesh and no CUDA device "
                               "is available")
        self.mesh = mesh
        self.spc = spc
        self._plans: Dict[tuple, ReshardPlan] = {}
        self._plan_hits = 0
        self._sizes = _axis_sizes(mesh)
        self._axis_plane = classify_axes(mesh)
        self._platform = mesh.device_type

    def cache_info(self) -> Dict[str, int]:
        return {"plans": len(self._plans), "plan_hits": self._plan_hits}

    def plan(self, shape, dtype, src_spec, dst_spec) -> ReshardPlan:
        dt = _dtype_of(dtype)[0]
        key = (_norm(src_spec, len(shape)), _norm(dst_spec, len(shape)),
               tuple(int(s) for s in shape), dt)
        hit = self._plans.get(key)
        if hit is not None:
            self._plan_hits += 1
            if trace.enabled:
                trace.instant("cache_hit:reshard_plan", "cache",
                              rank=dist.get_rank(),
                              args={"plan": hit.label})
            return hit
        t0 = time.perf_counter()
        try:
            plan = compile_plan(shape, dtype, src_spec, dst_spec, self.mesh)
        except BaseException:
            if trace.enabled:
                trace.record_span("reshard:compile_plan", "compile", t0,
                                  time.perf_counter(), rank=dist.get_rank(),
                                  args={"status": "error"})
            raise
        self._plans[key] = plan
        with _lock:
            _counts["reshard_plans"] += 1
            _plan_log.append({
                "plan": plan.label, "steps": plan.describe(),
                "wire_bytes": plan.wire_bytes,
                "peak_bytes": plan.peak_bytes,
                "bound_bytes": plan.bound_bytes,
                "src_shard_bytes": plan.src_shard_bytes,
                "dst_shard_bytes": plan.dst_shard_bytes,
                "fallback_reason": plan.fallback_reason,
                "mesh": dict(self._sizes)})
        if trace.enabled:
            trace.record_span("reshard:compile_plan", "compile", t0,
                              time.perf_counter(), rank=dist.get_rank(),
                              args={"plan": plan.label,
                                    "steps": plan.describe(),
                                    "peak_bytes": plan.peak_bytes,
                                    "wire_bytes": plan.wire_bytes})
        return plan

    # -- per-step execution -------------------------------------------------

    def _gather_dim(self, x: torch.Tensor, axis: str, d: int,
                    extent: int) -> torch.Tensor:
        """All-gather dim d over ``axis``: each member's block padded to
        the ceiling, the result cut back to ``extent``."""
        n = self._sizes[axis]
        c = -(-extent // n)
        moved = x.movedim(d, 0)
        if moved.shape[0] != c:
            moved = torch.nn.functional.pad(
                moved, [0, 0] * (moved.dim() - 1) + [0, c - moved.shape[0]])
        full = all_gather_axis(moved.contiguous(), axis, mesh=self.mesh)
        return full[:extent].movedim(0, d)

    def _slice_dim(self, x: torch.Tensor, axis: str, d: int) -> torch.Tensor:
        start, size = _block(self._sizes[axis], axis_rank(self.mesh, axis),
                             x.shape[d])
        return x.narrow(d, start, size)

    def _tuple_group(self, grp: Tuple[str, ...]):
        """The product group of ``grp`` and ``perm`` (``perm[j]``: the
        group rank of the member at row-major index j over ``grp``)."""
        return axes_group(self.mesh, grp), group_order(self.mesh, grp)

    def _gather_grp(self, x: torch.Tensor, grp: Tuple[str, ...], d: int,
                    extent: int) -> torch.Tensor:
        """All-gather dim d over the axes ``grp`` (row-major blocks)."""
        if len(grp) == 1:
            return self._gather_dim(x, grp[0], d, extent)
        group, perm = self._tuple_group(grp)
        full = all_gather_axis(x.movedim(d, 0).contiguous(), group,
                               tiled=False)
        full = full[torch.as_tensor(perm, device=x.device)]
        return full.reshape((-1,) + tuple(full.shape[2:]))[:extent].movedim(
            0, d)

    def _slice_grp(self, x: torch.Tensor, grp: Tuple[str, ...],
                   d: int) -> torch.Tensor:
        start, size = _grp_block(self.mesh, grp, x.shape[d])
        return x.narrow(d, start, size)

    def _a2a_grp(self, x: torch.Tensor, grp: Tuple[str, ...], split_dim: int,
                 concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all over the axes ``grp``: block j of
        ``split_dim`` to the member at row-major index j over ``grp``,
        the blocks received concatenated on ``concat_dim`` in that
        order."""
        if len(grp) == 1:
            return all_to_all_axis(x, grp[0], split_dim=split_dim,
                                   concat_dim=concat_dim, mesh=self.mesh)
        group, perm = self._tuple_group(grp)
        m = len(perm)
        moved = x.movedim(split_dim, 0)
        blocks = moved.reshape((m, moved.shape[0] // m)
                               + tuple(moved.shape[1:]))
        # send to group rank g the block of its index: blocks[argsort(perm)]
        idx = torch.as_tensor(np.argsort(perm), device=x.device)
        send = blocks[idx].contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(_wire(recv), _wire(send), group=group)
        got = recv[torch.as_tensor(perm, device=x.device)]
        return torch.cat([b.movedim(0, split_dim) for b in got.unbind(0)],
                         dim=concat_dim)

    def _step(self, plan: ReshardPlan, step: PlanStep,
              x: torch.Tensor) -> torch.Tensor:
        if step.op == "all_to_all":
            return self._a2a_grp(x, step.axes, step.dim, step.src_dim)
        if step.op == "all_gather":
            # the dim's extent once gathered: its block under the axes left
            after = _norm(step.out_spec, len(plan.shape))[step.dim]
            extent = _grp_block(self.mesh, after, plan.shape[step.dim])[1]
            return self._gather_dim(x, step.axes[0], step.dim, extent)
        if step.op == "slice":
            return self._slice_dim(x, step.axes[0], step.dim)
        if step.op == "ppermute":
            # the group over both axes orders its ranks in the mesh's
            # axis order; the plan's pairs are a transposition of two
            # equal axes, the same set in either order
            return ppermute(x, axes_group(self.mesh, step.axes),
                            step.perm)
        if step.op == "device_put":
            for d, grp in enumerate(plan.src):
                if grp:
                    x = self._gather_grp(x, grp, d, plan.shape[d])
            for d, grp in enumerate(plan.dst):
                if grp:
                    x = self._slice_grp(x, grp, d)
            return x
        raise ReshardError(f"unknown plan op {step.op!r}")   # closed grammar

    # -- decision + audit ---------------------------------------------------

    def _decide(self, step: PlanStep, ndev: int) -> Tuple[str, str, list]:
        from ..coll import nccl as _nccl
        plane = ("dcn" if any(self._axis_plane.get(a) == "dcn"
                              for a in step.axes) else "ici")
        return _nccl.decide_mode(
            "reshard", step.wire_bytes, ndev, self._platform,
            _nccl._load_device_rules(), allowed=("native",),
            quant_ok=False, dtype=None, op=None, plane=plane,
            hier_ok=False,
            hier_why="reshard steps are single layout-pure collectives")

    def _audit_step(self, plan: ReshardPlan, i: int, arm: str,
                    reason: str, chain: list, ndev: int,
                    dur_s: Optional[float]) -> Dict[str, int]:
        """The reference's audit of one plan step: the counters, the spc
        pvars, the traffic edges of the step's wire (returning their plane
        split), the perf sample and one ``decide:reshard`` event."""
        step = plan.steps[i]
        wire = int(step.wire_bytes)
        with _lock:
            _counts["reshard_steps"] += 1
            _counts["reshard_bytes"] += wire
        if self.spc is not None:
            self.spc.inc(f"coll_arm_{arm}_count")
            if wire:
                self.spc.inc("coll_wire_bytes", wire)
        planes: Dict[str, int] = {}
        if traffic.enabled and wire:
            kind = _TRAFFIC_KIND.get(step.op)
            if kind is not None:
                planes = traffic.note_reshard_step(
                    self.mesh, kind, step.axes, wire,
                    pairs=step.perm or None)
        if perf.enabled and dur_s is not None and wire and ndev >= 2:
            perf.note_sample("reshard", arm, wire, dur_s, ndev,
                             planes=planes)
        if trace.enabled:
            trace.decision(
                "reshard", arm=arm, reason=reason, verdict=None,
                nbytes=wire, rank=dist.get_rank(),
                step=i, step_op=step.describe(), plan=plan.label,
                plan_steps=len(plan.steps), peak_bytes=plan.peak_bytes,
                bound_bytes=plan.bound_bytes, ndev=ndev,
                wire_bytes=wire, chain=chain)
        return planes

    # -- execution ----------------------------------------------------------

    def run(self, x: torch.Tensor, src_spec, dst_spec,
            global_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """This rank's shard ``x`` under ``src_spec`` → its shard under
        ``dst_spec``, a fresh tensor.  ``global_shape`` defaults to the
        shard's extents times the sizes of the axes that cut them (give it
        for a dim its axis does not divide).  Collective over the mesh."""
        global _last_run
        if x.device.type != self._platform:
            raise ValueError(f"reshard: tensor on {x.device}, mesh on "
                             f"{self._platform}")
        src = _norm(src_spec, x.dim())
        dst = _norm(dst_spec, x.dim())
        if global_shape is None:
            global_shape = [s * int(np.prod([self._sizes[a] for a in g]))
                            for s, g in zip(x.shape, src)]
        shape = tuple(int(s) for s in global_shape)
        want = _local_shape(shape, src, self.mesh)
        if tuple(x.shape) != want:
            raise ValueError(f"reshard: shard {tuple(x.shape)} is not this "
                             f"rank's block {want} of {shape} under "
                             f"{_spec_of(src)}")
        plan = self.plan(shape, x.dtype, src, dst)
        _check_tuple_dims(plan, self._sizes)
        audit: List[Dict[str, Any]] = []
        for i, step in enumerate(plan.steps):
            ndev = 1
            for a in step.axes:
                ndev *= self._sizes[a]
            arm, reason, chain = self._decide(step, ndev)
            t0 = time.perf_counter()
            x = self._step(plan, step, x)
            dur = None
            if perf.enabled:
                # to completion, as the reference's block_until_ready
                _sync(x)
                dur = time.perf_counter() - t0
            self._audit_step(plan, i, arm, reason, chain, ndev, dur)
            audit.append({"step": i, "op": step.describe(), "arm": arm,
                          "reason": reason, "wire_bytes": step.wire_bytes,
                          "dur_us": (round(dur * 1e6, 1)
                                     if dur is not None else None)})
        if plan.steps:
            with _lock:
                _last_run = {"plan": plan.label, "steps": audit,
                             "wire_bytes": plan.wire_bytes,
                             "peak_bytes": plan.peak_bytes,
                             "bound_bytes": plan.bound_bytes,
                             "fallback_reason": plan.fallback_reason}
        return x.clone(memory_format=torch.contiguous_format)


_TRAFFIC_KIND = {"all_to_all": "a2a", "all_gather": "ring",
                 "ppermute": "perm", "device_put": "a2a"}


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


# ---------------------------------------------------------------------------
# module-level face
# ---------------------------------------------------------------------------

_resharders: Dict[Any, Resharder] = {}
_RESHARDER_CAP = 8


def resharder(mesh, spc=None) -> Resharder:
    """The per-mesh Resharder (bounded registry; the newest SPC table
    attaches — the latest Context wins, like DeviceComm.spc).  Its first
    call for a mesh is collective."""
    with _lock:
        r = _resharders.get(mesh)
        if r is None:
            if len(_resharders) >= _RESHARDER_CAP:
                _resharders.pop(next(iter(_resharders)))
            r = _resharders[mesh] = Resharder(mesh, spc=spc)
        if spc is not None:
            r.spc = spc
    return r


def reshard(x: torch.Tensor, src_spec, dst_spec, mesh,
            global_shape: Optional[Sequence[int]] = None,
            spc=None) -> torch.Tensor:
    """Redistribute this rank's shard ``x`` from ``src_spec`` to
    ``dst_spec`` on ``mesh`` through a compiled minimal-collective plan
    (``Resharder.run``); every rank of the mesh calls it."""
    return resharder(mesh, spc=spc).run(x, src_spec, dst_spec, global_shape)


# ---------------------------------------------------------------------------
# cross-mesh planning mode (source mesh ⊃ dest mesh)
# ---------------------------------------------------------------------------
#
# The reference's cross plan (``reshard.py:714-735``): the array lives on
# the source mesh and must land on a mesh whose ranks are a subset of the
# source's.  Each destination shard is tiled by whole source blocks (or
# crops of replicas), moved point to point and assembled in place, so the
# live set a rank holds stays within the single-mesh planner's contract:
# resident src shard + assembled dst shard + one in-flight piece <=
# reshard_peak_factor * max(src_shard, dst_shard) at the default factor 2.
# Pieces whose source rank is dead are marked ``from_shadow``: the
# reference sources them from ft/elastic's peer shadows, which come with
# P14, so the port plans them and refuses to run them.

Region = Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class RankMesh:
    """A mesh as plain data: ``axes`` ((name, size), …) and the world
    ``ranks`` that fill it in row-major order — what the reference's
    ``mesh.devices`` is to its cross planner."""
    axes: Tuple[Tuple[str, int], ...]
    ranks: Tuple[int, ...]

    def __post_init__(self) -> None:
        n = int(np.prod([s for _, s in self.axes])) if self.axes else 1
        if n != len(self.ranks) or len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"RankMesh: axes {dict(self.axes)} need {n} "
                             f"distinct ranks, got {list(self.ranks)}")

    @classmethod
    def make(cls, axes: Dict[str, int], ranks: Sequence[int]) -> "RankMesh":
        return cls(tuple((str(a), int(n)) for a, n in axes.items()),
                   tuple(int(r) for r in ranks))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)


@dataclass(frozen=True)
class CrossPiece:
    """One source block of a destination shard."""
    dst_pos: int                  # flat position in the SOURCE mesh
    src_pos: int                  # flat position in the SOURCE mesh
    start: Tuple[int, ...]        # piece origin in global index space
    sizes: Tuple[int, ...]        # piece extent per dim
    nbytes: int
    from_shadow: bool             # sourced from a replacement, not x


@dataclass(frozen=True)
class CrossMeshPlan:
    key: tuple
    shape: Tuple[int, ...]
    dtype: str
    src: Placement
    dst: Placement
    pieces: Tuple[CrossPiece, ...]
    src_shard_bytes: int
    dst_shard_bytes: int
    peak_bytes: int               # modeled per-rank live-set maximum
    wire_bytes: int               # modeled cross-rank piece bytes
    bound_bytes: int
    n_src: int
    n_dst: int
    fallback_reason: str = ""     # non-empty: no piece plan (see below)

    @property
    def label(self) -> str:
        return (f"{_fmt_placement(self.src)}x{self.n_src}->"
                f"{_fmt_placement(self.dst)}x{self.n_dst}"
                f"/{self.dtype}{list(self.shape)}")

    def describe(self) -> List[str]:
        if self.fallback_reason:
            return ["device_put"]
        return [f"cross_migrate[{len(self.pieces)} piece(s), "
                f"{sum(1 for p in self.pieces if p.from_shadow)} shadow]"]


def _index_map(shape: Tuple[int, ...], pl: Placement,
               mesh: RankMesh) -> Dict[int, Region]:
    """{flat position: region} of a layout on ``mesh``: the reference's
    ``devices_indices_map`` through ``_region``.  A dim over a tuple of
    axes is cut over their row-major product; a dim its axes do not
    divide gets ceiling-sized blocks (``_block``)."""
    sizes = mesh.shape
    for grp in pl:
        for a in grp:
            if a not in sizes:
                raise ReshardError(f"cross_reshard: spec names axis {a!r} "
                                   f"not on mesh {tuple(sizes)}")
    dims = [s for _, s in mesh.axes]
    names = [a for a, _ in mesh.axes]
    out = {}
    for p in range(len(mesh.ranks)):
        coord = dict(zip(names, np.unravel_index(p, dims))) if dims else {}
        reg = []
        for d, grp in enumerate(pl):
            n, i = 1, 0
            for a in grp:
                n *= sizes[a]
                i = i * sizes[a] + int(coord[a])
            start, size = _block(n, i, shape[d])
            reg.append((start, start + size))
        out[p] = tuple(reg)
    return out


def _contains(outer, inner) -> bool:
    return all(o0 <= i0 and i1 <= o1
               for (o0, o1), (i0, i1) in zip(outer, inner))


def _rsize(reg) -> int:
    n = 1
    for a, b in reg:
        n *= max(b - a, 0)
    return n


def compile_cross_plan(shape: Sequence[int], dtype, src_spec, dst_spec,
                       src_mesh: RankMesh, dst_mesh: RankMesh,
                       dead: Sequence[int] = (),
                       peak_factor: Optional[float] = None
                       ) -> CrossMeshPlan:
    """Compile a source-mesh ⊃ dest-mesh move into per-rank piece moves.
    ``dead`` holds flat positions (into ``src_mesh.ranks``) whose shards
    must never be read — those pieces are marked ``from_shadow``.  Pure
    host math, like :func:`compile_plan`; the reference's plan for the
    same meshes, field for field."""
    shape = tuple(int(s) for s in shape)
    dt_name, itemsize = _dtype_of(dtype)
    src = _norm(src_spec, len(shape))
    dst = _norm(dst_spec, len(shape))
    pos_of = {r: i for i, r in enumerate(src_mesh.ranks)}
    dead_set = frozenset(int(p) for p in dead)
    missing = [r for r in dst_mesh.ranks if r not in pos_of]
    if missing:
        raise ReshardError(
            "cross_reshard: dest mesh is not a subset of the source mesh "
            f"(ranks {missing} not on the source mesh)")
    bad = [pos_of[r] for r in dst_mesh.ranks if pos_of[r] in dead_set]
    if bad:
        raise ReshardError(
            f"cross_reshard: dest mesh includes dead device position(s) "
            f"{sorted(bad)} — shrink to survivors first")
    src_map = _index_map(shape, src, src_mesh)
    dst_map = {pos_of[dst_mesh.ranks[p]]: reg for p, reg in
               _index_map(shape, dst, dst_mesh).items()}
    src_b = max(max((_rsize(r) for r in src_map.values()), default=1)
                * itemsize, itemsize)
    dst_b = max(max((_rsize(r) for r in dst_map.values()), default=1)
                * itemsize, itemsize)
    factor = float(peak_factor if peak_factor is not None
                   else _var.get("reshard_peak_factor", 2.0))
    bound = int(factor * max(src_b, dst_b))
    key = (src, dst, shape, dt_name, src_mesh, dst_mesh, dead_set)

    def _fallback(why: str) -> CrossMeshPlan:
        if dead_set:
            raise ReshardError(
                f"cross_reshard: {why} — and dead position(s) "
                f"{sorted(dead_set)} rule out the whole-array device_put "
                "fallback (it would read their shards)")
        return CrossMeshPlan(
            key=key, shape=shape, dtype=dt_name, src=src, dst=dst,
            pieces=(), src_shard_bytes=src_b, dst_shard_bytes=dst_b,
            peak_bytes=src_b + dst_b, wire_bytes=dst_b, bound_bytes=bound,
            n_src=len(src_mesh.ranks), n_dst=len(dst_mesh.ranks),
            fallback_reason=why)

    # group source holders by region (partial replication: several ranks
    # may hold identical blocks)
    holders: Dict[Region, List[int]] = {}
    for p, reg in src_map.items():
        holders.setdefault(reg, []).append(p)

    pieces: List[CrossPiece] = []
    peak = 0
    wire = 0
    for dpos, R in sorted(dst_map.items()):
        cand = [(reg, ps) for reg, ps in holders.items()
                if _contains(R, reg)]
        if sum(_rsize(reg) for reg, _ in cand) != _rsize(R):
            return _fallback(
                "irregular tiling: a source shard straddles a dest shard "
                "boundary (cross plans need dest shards tiled by whole "
                "source blocks)")
        dev_pieces: List[CrossPiece] = []
        for reg, ps in sorted(cand):
            alive = [p for p in sorted(ps) if p not in dead_set]
            shadow = not alive
            if shadow:
                p = min(ps)                     # replacement keyed here
            elif dpos in alive:
                p = dpos                        # local copy: zero wire
            else:
                p = alive[0]
            nb = _rsize(reg) * itemsize
            dev_pieces.append(CrossPiece(
                dst_pos=dpos, src_pos=p,
                start=tuple(a for a, _ in reg),
                sizes=tuple(b - a for a, b in reg),
                nbytes=nb, from_shadow=shadow))
            if shadow or p != dpos:
                wire += nb
        pieces.extend(dev_pieces)
        # live-set model per dest rank: resident src shard + the
        # assembled dst shard + one in-flight piece
        max_piece = max((pc.nbytes for pc in dev_pieces), default=0)
        if len(dev_pieces) == 1 and dev_pieces[0].src_pos == dpos \
                and not dev_pieces[0].from_shadow \
                and dev_pieces[0].nbytes == _rsize(src_map[dpos]) * itemsize:
            live = src_b                        # pure alias, no assembly
        else:
            live = src_b + _rsize(R) * itemsize + max_piece
        peak = max(peak, live)
    if peak > bound:
        return _fallback(
            f"peak {peak}B over bound {bound}B "
            f"(reshard_peak_factor={factor:g})")
    return CrossMeshPlan(
        key=key, shape=shape, dtype=dt_name, src=src, dst=dst,
        pieces=tuple(pieces), src_shard_bytes=src_b, dst_shard_bytes=dst_b,
        peak_bytes=peak, wire_bytes=wire, bound_bytes=bound,
        n_src=len(src_mesh.ranks), n_dst=len(dst_mesh.ranks))


_cross_plans: Dict[tuple, CrossMeshPlan] = {}
_CROSS_CAP = 256


def _cross_plan(shape, dtype, src_spec, dst_spec, src_mesh: RankMesh,
                dst_mesh: RankMesh, dead) -> CrossMeshPlan:
    """The plan cache: one compile per (specs, shape, dtype, meshes,
    dead), each logged once with ``cross: True``."""
    key = (_norm(src_spec, len(shape)), _norm(dst_spec, len(shape)),
           tuple(int(s) for s in shape), _dtype_of(dtype)[0],
           src_mesh, dst_mesh, frozenset(int(p) for p in dead))
    hit = _cross_plans.get(key)
    if hit is not None:
        if trace.enabled:
            trace.instant("cache_hit:reshard_cross_plan", "cache",
                          rank=dist.get_rank(), args={"plan": hit.label})
        return hit
    if len(_cross_plans) >= _CROSS_CAP:
        _cross_plans.pop(next(iter(_cross_plans)))
    t0 = time.perf_counter()
    try:
        plan = compile_cross_plan(shape, dtype, src_spec, dst_spec,
                                  src_mesh, dst_mesh, dead=dead)
    except BaseException:
        if trace.enabled:
            trace.record_span("reshard:compile_cross_plan", "compile", t0,
                              time.perf_counter(), rank=dist.get_rank(),
                              args={"status": "error"})
        raise
    if trace.enabled:
        trace.record_span("reshard:compile_cross_plan", "compile", t0,
                          time.perf_counter(), rank=dist.get_rank(),
                          args={"plan": plan.label,
                                "pieces": len(plan.pieces),
                                "peak_bytes": plan.peak_bytes,
                                "wire_bytes": plan.wire_bytes})
    _cross_plans[key] = plan
    with _lock:
        _counts["reshard_plans"] += 1
        _plan_log.append({
            "plan": plan.label, "steps": plan.describe(),
            "wire_bytes": plan.wire_bytes, "peak_bytes": plan.peak_bytes,
            "bound_bytes": plan.bound_bytes,
            "src_shard_bytes": plan.src_shard_bytes,
            "dst_shard_bytes": plan.dst_shard_bytes,
            "fallback_reason": plan.fallback_reason,
            "cross": True, "dead": sorted(int(p) for p in dead),
            "mesh": {"src": src_mesh.shape, "dst": dst_mesh.shape}})
    return plan


def _crop(x: torch.Tensor, pc: CrossPiece, base: Region) -> torch.Tensor:
    """The piece's block of the shard ``x`` whose region is ``base``."""
    for d, (st, sz, (b0, _b1)) in enumerate(zip(pc.start, pc.sizes, base)):
        if st != b0 or sz != x.shape[d]:
            x = x.narrow(d, st - b0, sz)
    return x


def cross_reshard(x: Optional[torch.Tensor], shape: Sequence[int], dtype,
                  src_spec, dst_spec, src_mesh: RankMesh,
                  dst_mesh: RankMesh, *, dead: Sequence[int] = (),
                  spc=None, plane: Optional[str] = None
                  ) -> Optional[torch.Tensor]:
    """Move a ``shape`` array from ``src_spec`` on ``src_mesh`` onto
    ``dst_spec`` on ``dst_mesh`` (its ranks a subset of the source's).
    Each rank of the source mesh passes its shard ``x`` and gets back its
    destination shard, or None when it holds none; a rank off the source
    mesh may call it and gets None.  Audited like the reference: one
    ``decide_mode("reshard")`` with native the only arm (``plane``, 'ici'
    or 'dcn', keys its rules rows; default 'dcn' when a source axis is a
    simulated DCN axis), ``coll_arm_<arm>_count`` and the plan's wire
    bytes into ``spc``, the counters and ``report()["last"]``.  CUDA
    shards move over NCCL, CPU shards over gloo: the world's backend.

    A plan with ``from_shadow`` pieces raises: their replacement holders
    are ft/elastic's peer shadows (ROADMAP P14).  A plan that fell back
    (``fallback_reason``) raises too, naming its reason: the port runs
    piece plans only."""
    global _last_run
    shape = tuple(int(s) for s in shape)
    plan = _cross_plan(shape, dtype, src_spec, dst_spec, src_mesh,
                       dst_mesh, dead)
    if plan.fallback_reason:
        raise ReshardError(
            f"cross_reshard: plan {plan.label} fell back to device_put "
            f"({plan.fallback_reason}); the port runs cross plans of "
            "whole source blocks only")
    shadow = sorted({pc.src_pos for pc in plan.pieces if pc.from_shadow})
    if shadow:
        raise ReshardError(
            f"cross_reshard: dead position(s) {shadow} hold the only copy "
            "of their blocks; their peer-shadow replacements come with "
            "ft/elastic (ROADMAP P14)")
    me = dist.get_rank()
    ranks = src_mesh.ranks
    if me not in ranks:
        return None
    my_src = ranks.index(me)
    src_map = _index_map(shape, plan.src, src_mesh)
    want = tuple(b - a for a, b in src_map[my_src])
    if x is None or tuple(x.shape) != want:
        raise ValueError(
            f"cross_reshard: rank {me} holds source position {my_src}, "
            f"whose block is {want}; got "
            f"{None if x is None else tuple(x.shape)}")
    if _dtype_of(x.dtype)[0] != plan.dtype:
        raise ValueError(f"cross_reshard: shard of {x.dtype}, plan of "
                         f"{plan.dtype}")
    out = region = None
    if me in dst_mesh.ranks:
        region = _index_map(shape, plan.dst,
                            dst_mesh)[dst_mesh.ranks.index(me)]
        mine = [pc for pc in plan.pieces if pc.dst_pos == my_src]
        if len(mine) == 1 and mine[0].src_pos == my_src \
                and mine[0].sizes == want:
            out = x                             # pure alias
        else:
            out = torch.empty(tuple(b - a for a, b in region),
                              dtype=x.dtype, device=x.device)
    # one decision for the move, before it runs
    from ..coll import nccl as _nccl
    wire = plan.wire_bytes
    if plane is None:
        plane = ("dcn" if any(a in sim_dcn_axes() for a in src_mesh.shape)
                 else "ici")
    arm, reason, chain = _nccl.decide_mode(
        "reshard", wire, plan.n_src, x.device.type,
        _nccl._load_device_rules(), allowed=("native",), quant_ok=False,
        dtype=None, op=None, plane=plane, hier_ok=False,
        hier_why="cross-mesh migrate is a fixed point-to-point schedule")
    sends, recvs, later = [], [], []
    for pc in plan.pieces:
        if pc.src_pos == my_src and pc.dst_pos != my_src:
            sends.append((_crop(x, pc, src_map[my_src]),
                          ranks[pc.dst_pos], 0))
        if pc.dst_pos == my_src and out is not x:
            view = out
            for d, (st, sz, (a, _b)) in enumerate(zip(pc.start, pc.sizes,
                                                      region)):
                view = view.narrow(d, st - a, sz)
            if pc.src_pos == my_src:
                view.copy_(_crop(x, pc, src_map[my_src]))
            elif view.is_contiguous():
                recvs.append((view, ranks[pc.src_pos], 0))
            else:
                tmp = torch.empty_like(view,
                                       memory_format=torch.contiguous_format)
                recvs.append((tmp, ranks[pc.src_pos], 0))
                later.append((view, tmp))
    t0 = time.perf_counter()
    _p2p(dist.group.WORLD, sends, recvs)
    for view, tmp in later:
        view.copy_(tmp)
    dur = None
    if perf.enabled:
        # to completion, as the reference's block_until_ready
        _sync(x)
        dur = time.perf_counter() - t0
    # -- audit: one decision, the counters, the per-pair traffic -----------
    with _lock:
        _counts["reshard_steps"] += 1
        _counts["reshard_bytes"] += int(wire)
    if spc is not None:
        spc.inc(f"coll_arm_{arm}_count")
        if wire:
            spc.inc("coll_wire_bytes", int(wire))
    planes: Dict[str, int] = {}
    if traffic.enabled and wire:
        planes = _charge_pairs(plan, ranks)
    if perf.enabled and dur is not None and wire and plan.n_src >= 2:
        perf.note_sample("reshard", arm, int(wire), dur, plan.n_src,
                         planes=planes)
    step_op = plan.describe()[0]
    if trace.enabled:
        trace.decision(
            "reshard", arm=arm, reason=reason, verdict=None,
            nbytes=int(wire), rank=me,
            step=0, step_op=step_op, plan=plan.label, plan_steps=1,
            peak_bytes=plan.peak_bytes, bound_bytes=plan.bound_bytes,
            ndev=plan.n_src, wire_bytes=int(wire), chain=chain,
            cross=True, dead=sorted(int(p) for p in dead))
    with _lock:
        _last_run = {"plan": plan.label,
                     "steps": [{"step": 0, "op": step_op, "arm": arm,
                                "reason": reason, "wire_bytes": int(wire),
                                "dur_us": (round(dur * 1e6, 1)
                                           if dur is not None else None)}],
                     "wire_bytes": int(wire),
                     "peak_bytes": plan.peak_bytes,
                     "bound_bytes": plan.bound_bytes,
                     "fallback_reason": plan.fallback_reason}
    return out


class _WorldGrid:
    """The world as a one-axis grid (flat position = world rank): the edge
    space the traffic matrix uses for a cross plan's pairs, which join
    ranks of two meshes."""
    mesh_dim_names = ("world",)

    def __init__(self, n: int) -> None:
        self.mesh = np.arange(n)


_world_grids: Dict[int, _WorldGrid] = {}


def _charge_pairs(plan: CrossMeshPlan, ranks: Tuple[int, ...]
                  ) -> Dict[str, int]:
    """One ``note_reshard_step("perm")`` a (source, destination) pair of
    the plan's moving pieces, on the world ranks the pair joins; the
    pairs' bytes sum to the plan's wire.  Returns the plane split."""
    n = dist.get_world_size()
    grid = _world_grids.get(n)
    if grid is None:
        grid = _world_grids[n] = _WorldGrid(n)
    pair_bytes: Dict[Tuple[int, int], int] = {}
    for pc in plan.pieces:
        if pc.src_pos != pc.dst_pos:
            key = (ranks[pc.src_pos], ranks[pc.dst_pos])
            pair_bytes[key] = pair_bytes.get(key, 0) + int(pc.nbytes)
    planes: Dict[str, int] = {}
    for pair, nb in sorted(pair_bytes.items()):
        part = traffic.note_reshard_step(grid, "perm", ("world",), nb,
                                         pairs=[pair])
        for k, v in part.items():
            planes[k] = planes.get(k, 0) + v
    return planes


def report() -> Dict[str, Any]:
    """The plans compiled (``plans``: the intra-mesh ``Resharder``'s and
    the cross plans, each ``cross: True``), the counters and the last
    executed plan's audit (``last``)."""
    with _lock:
        return {"counters": dict(_counts),
                "plans": list(_plan_log),
                "last": dict(_last_run) if _last_run else None}


__all__ = ["ReshardError", "PlanStep", "ReshardPlan", "compile_plan",
           "Resharder", "resharder", "reshard", "RankMesh", "CrossPiece",
           "CrossMeshPlan", "compile_cross_plan", "cross_reshard",
           "report"]
