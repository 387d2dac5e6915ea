"""Static collective-program extraction + SPMD verification.

The port's copy of ``ompi_tpu/analysis/commgraph.py``.  MPI's static
collective-matching verifiers (MPI-Checker, MUST) prove a communication
program well-formed before it runs: every rank issues the same (op,
communicator, dtype, count) sequence, point-to-point patterns pair up,
nothing escapes the accounted path.  The reference reads that program from
a jaxpr.  The port has no trace: its program is the sequence of ``c10d``
ops a callable issues, so ``extract`` runs the callable once under a
``TorchDispatchMode`` that records every ``c10d.*`` op (and every
device-to-host read) with its process group, dtype and payload.

Three consumers, as in the reference:

* ``extract(fn, *args)`` — run ``fn`` once and record its collective
  program into a ``CommGraph`` of ``CollRecord``s.  Given a ``comm`` (a
  process group), every rank's signature list is gathered after the run,
  outside the recording: ranks whose sequences differ are ``mismatch``
  issues (MPI-Checker's matching property, which the reference checks
  between the branches of a ``cond``), and each point-to-point batch's
  pairs from all ranks join into one perm, so the bijection check sees
  the whole permutation.
* ``from_reshard_plan(plan)`` — the reshard plan compiler's step list,
  lifted into the same representation.
* ``verify(fn, args, mesh)`` — checks + static wire prediction + a live
  run under the traffic plane, comparing the static figure with the
  runtime per-coll attribution byte for byte.

What eager extraction changes (ROADMAP, Departures): every hop is its own
record, so ``trips`` stays 1 and ``bounded`` stays True; the divergence
check runs between ranks, not between branches; and ``broadcast_`` has
a record (``broadcast``) the reference's vocabulary lacks.  Collectives
issued in the backward (grad-sync hooks, the Megatron *f*/*g* backward
collectives) are recorded too: the mode's state follows autograd onto
its worker threads.
"""

from __future__ import annotations

import os
import sys
import threading
import weakref
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# c10d op (the name after ``c10d.``, overload dropped) -> canonical op;
# ``allreduce_`` maps by its reduce op (``_REDUCE_OPS``).  Any other c10d
# op keeps its own name (``c10d.<op>``), so nothing is dropped
_C10D_OPS = {
    "allreduce_": "psum",
    "allgather_": "all_gather",
    "_allgather_base_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "alltoall_base_": "all_to_all",
    "alltoall_": "all_to_all",
    "send": "ppermute",
    "recv_": "ppermute",
    "broadcast_": "broadcast",
    "scatter_": "scatter",
}
# the op argument whose tensors are the per-call payload: the input of
# every gather/scatter/exchange (the reference's per-shard operand), the
# buffer of the in-place ones
_PAYLOAD_ARG = {
    "allgather_": 1, "_allgather_base_": 1, "reduce_scatter_": 1,
    "_reduce_scatter_base_": 1, "alltoall_base_": 1, "alltoall_": 1,
}
# c10d ReduceOp codes -> canonical reduce names (SUM 0, MIN 3, MAX 4)
_REDUCE_OPS = {0: "psum", 3: "pmin", 4: "pmax"}

# aten ops that bring device data to the host: a scalar read (``item()``,
# ``float()``, a Python branch on a tensor) and a copy off the card
_SCALAR_READ = "aten._local_scalar_dense"
_COPIES = ("aten._to_copy", "aten.copy_")
# ``torch.tensor(<python data>)`` lifts a host constant into the program;
# reading one back (a dtype-rounded scale, say) moves no device data
_LIFT = "aten.lift_fresh"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.abspath(__file__)


@dataclass(frozen=True)
class CollRecord:
    """One collective operand in program order."""
    op: str                          # canonical op name
    axes: Tuple[str, ...]            # mesh axis names the op runs over
    dtype: str
    shape: Tuple[int, ...]           # per-rank payload shape
    nbytes: int                      # payload bytes per executed call
    trips: int = 1                   # always 1 in eager extraction
    perm: Tuple[Tuple[int, int], ...] = ()   # ppermute (src, dst) pairs
    path: str = ""                   # innermost port function issuing it
    bounded: bool = True             # always True in eager extraction

    @property
    def total_bytes(self) -> int:
        return self.nbytes * self.trips

    @property
    def control(self) -> bool:
        """Scalar payloads are control-plane figures (loss means, flags):
        the runtime note models exclude them from wire attribution, so
        the static wire models do too (they ride the same wire in O(1)
        bytes).  The scheduler's and the fleet's MAX agreements are
        one-element rows, not scalars, but they are ``pmax`` records,
        which no wire model prices and no traffic note charges."""
        return self.shape == ()

    def signature(self) -> Tuple[str, Tuple[str, ...], str, int]:
        """The MPI-Checker matching tuple: (op, axes, dtype, count)."""
        count = int(np.prod(self.shape)) if self.shape else 1
        return (self.op, self.axes, self.dtype, count * self.trips)


@dataclass(frozen=True)
class Issue:
    kind: str        # bijection|mismatch|hier-cover|host-transfer|
    #                  unknown-axis|unbounded
    msg: str
    severity: str = "error"          # error | warn


@dataclass
class CommGraph:
    """The extracted collective program."""
    records: List[CollRecord] = field(default_factory=list)
    host_transfers: List[str] = field(default_factory=list)
    divergent_ranks: List[str] = field(default_factory=list)
    source: str = ""

    # -- extraction helpers -------------------------------------------

    def signatures(self) -> List[Tuple]:
        return [r.signature() for r in self.records]

    def by_op(self) -> Dict[str, List[CollRecord]]:
        out: Dict[str, List[CollRecord]] = {}
        for r in self.records:
            out.setdefault(r.op, []).append(r)
        return out

    # -- SPMD well-formedness checks ----------------------------------

    def check(self, mesh=None) -> List[Issue]:
        """All static checks; ``mesh`` (a DeviceMesh or {axis: size}
        mapping) enables the axis-existence / permutation-range /
        hier-cover checks."""
        sizes = _axis_sizes(mesh)
        issues: List[Issue] = []
        issues += self._check_bijections(sizes)
        issues += self._check_axes(sizes)
        issues += self._check_hier_cover(sizes)
        for p in self.divergent_ranks:
            issues.append(Issue(
                "mismatch",
                f"collective sequence differs between ranks: {p} (ranks "
                "issuing different (op, axes, dtype, count) sequences is "
                "MPI-Checker's matching violation)"))
        for p in self.host_transfers:
            issues.append(Issue(
                "host-transfer",
                f"device->host transfer inside a device path at {p}: "
                "a host read serializes the program against the host "
                "and escapes every plane's accounting"))
        for r in self.records:
            if not r.bounded:
                issues.append(Issue(
                    "unbounded",
                    f"{r.op} over {r.axes} at {r.path} executes under "
                    "a data-dependent while: trip count (and wire "
                    "bytes) are not statically bounded", "warn"))
        return issues

    def _check_bijections(self, sizes) -> List[Issue]:
        issues = []
        for r in self.records:
            if r.op != "ppermute" or not r.perm:
                continue
            srcs = [s for s, _ in r.perm]
            dsts = [d for _, d in r.perm]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                issues.append(Issue(
                    "bijection",
                    f"ppermute over {r.axes} at {r.path} is not a "
                    f"bijection: perm {r.perm} repeats a "
                    f"{'source' if len(set(srcs)) != len(srcs) else 'destination'}"
                    " (two ranks would send to / receive from the same "
                    "peer in one step)"))
                continue
            if sizes and all(a in sizes for a in r.axes):
                dom = int(np.prod([sizes[a] for a in r.axes]))
                bad = [p for p in r.perm
                       if not (0 <= p[0] < dom and 0 <= p[1] < dom)]
                if bad:
                    issues.append(Issue(
                        "bijection",
                        f"ppermute over {r.axes} at {r.path}: pairs "
                        f"{bad} fall outside the axis domain [0, {dom})"))
        return issues

    def _check_axes(self, sizes) -> List[Issue]:
        if not sizes:
            return []
        issues = []
        for r in self.records:
            missing = [a for a in r.axes if a not in sizes]
            if missing:
                issues.append(Issue(
                    "unknown-axis",
                    f"{r.op} at {r.path} names axis "
                    f"{missing[0]!r} not on the mesh "
                    f"({tuple(sizes)})"))
        return issues

    def _check_hier_cover(self, sizes) -> List[Issue]:
        """The hier arm's shape is reduce_scatter(inner) ->
        reduce(outer) -> all_gather(inner); the two stages must cover
        the comm's axis product — an outer stage reusing an inner axis
        reduces twice over one plane and never over the other."""
        issues = []
        recs = [r for r in self.records if not r.control]
        for i, r in enumerate(recs):
            if r.op != "reduce_scatter":
                continue
            outer = next((x for x in recs[i + 1:]
                          if x.op in ("psum", "pmin", "pmax")), None)
            gather = next((x for x in recs[i + 1:]
                           if x.op == "all_gather"), None)
            if outer is None or gather is None:
                continue
            if gather.axes != r.axes:
                continue          # not the hier shape
            if set(outer.axes) & set(r.axes):
                issues.append(Issue(
                    "hier-cover",
                    f"hier split at {r.path}: outer stage reduces over "
                    f"{outer.axes} which reuses inner axis(es) "
                    f"{tuple(set(outer.axes) & set(r.axes))} — the "
                    "split does not cover the axis product (one plane "
                    "reduced twice, the other never)"))
            elif sizes:
                uncovered = [a for a in sizes
                             if a not in r.axes and a not in outer.axes
                             and sizes[a] > 1]
                # axes genuinely outside the comm (e.g. tp during a dp
                # sync) are legitimate; only warn so two-tier meshes
                # with a typo'd outer axis surface
                if uncovered:
                    issues.append(Issue(
                        "hier-cover",
                        f"hier split at {r.path} covers "
                        f"{r.axes + outer.axes}; mesh axes "
                        f"{tuple(uncovered)} are outside the split "
                        "(fine for a partial-mesh comm, wrong for a "
                        "full allreduce)", "warn"))
        return issues

    def match(self, other: "CommGraph") -> List[Issue]:
        """Cross-program matching: the first differing signature, or the
        count difference.  ``extract`` runs it between ranks."""
        a, b = self.signatures(), other.signatures()
        issues = []
        for i, (sa, sb) in enumerate(zip(a, b)):
            if sa != sb:
                issues.append(Issue(
                    "mismatch",
                    f"collective #{i} differs: {sa} vs {sb}"))
                break
        if not issues and len(a) != len(b):
            issues.append(Issue(
                "mismatch",
                f"collective count differs: {len(a)} vs {len(b)} "
                f"(first extra: "
                f"{(a + b)[min(len(a), len(b))]})"))
        return issues

    # -- static wire prediction ---------------------------------------

    def psum_ring_bytes(self, mesh, axes: Optional[Tuple[str, ...]] = None
                        ) -> int:
        """Ring-allreduce wire model over the non-control psum records:
        2(n-1)/n x payload bytes per rank — the same expression
        ``perf/model._FACTOR['allreduce']`` prices and the grad sync's
        ``note_traffic`` charges (one floor-division over the summed
        payload, so the figures agree byte for byte)."""
        sizes = _axis_sizes(mesh)
        groups: Dict[Tuple[str, ...], int] = {}
        for r in self.records:
            if r.op == "psum" and not r.control:
                if axes is None or r.axes == tuple(axes):
                    groups[r.axes] = groups.get(r.axes, 0) + r.total_bytes
        total = 0
        for ax, payload in groups.items():
            n = int(np.prod([sizes.get(a, 1) for a in ax])) if sizes else 1
            if n > 1:
                total += 2 * (n - 1) * payload // n
        return total

    def ppermute_bytes(self) -> int:
        """ppermute moves the full payload once per hop (factor 1 — the
        traffic plane's note_ring/note_ppermute convention)."""
        return sum(r.total_bytes for r in self.records
                   if r.op == "ppermute" and not r.control)

    def all_to_all_bytes(self) -> int:
        """all_to_all wire = the per-rank shard payload (factor 1 — the
        audited dispatch convention: the (n-1)/n on-wire discount lives
        in the busbw factor table, not the byte ledger)."""
        return sum(r.total_bytes for r in self.records
                   if r.op == "all_to_all" and not r.control)

    def gather_scatter_bytes(self, mesh) -> int:
        """all_gather / reduce_scatter: (n-1)/n x the gathered (full)
        buffer == (n-1) x the per-shard payload for all_gather, and
        (n-1)/n x the per-rank buffer for reduce_scatter — the
        ``perf/model._FACTOR`` (r-1)/r family."""
        sizes = _axis_sizes(mesh)
        total = 0
        for r in self.records:
            if r.control:
                continue
            n = int(np.prod([sizes.get(a, 1) for a in r.axes])) \
                if sizes else 1
            if n <= 1:
                continue
            if r.op == "all_gather":
                total += (n - 1) * r.total_bytes
            elif r.op == "reduce_scatter":
                total += (n - 1) * r.total_bytes // n
        return total

    def reshard_bytes(self) -> int:
        """Plan-lifted graphs: the step wire figures the plan compiler
        modeled (and the reshard executor charges verbatim)."""
        return sum(r.total_bytes for r in self.records
                   if r.path.startswith("reshard-plan"))


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _axis_sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(a): int(s) for a, s in zip(mesh.mesh_dim_names,
                                          mesh.mesh.shape)}


def _group_axes(mesh) -> Dict[int, Tuple[str, ...]]:
    """id(process group) -> the mesh axes it runs over: each axis's own
    group, every product group ``mesh.axes_group`` made, and the world
    (every axis of the mesh)."""
    import torch.distributed as dist

    out: Dict[int, Tuple[str, ...]] = {}
    if mesh is None or isinstance(mesh, dict):
        return out
    from ..parallel.mesh import _AXES_GROUPS
    names = tuple(mesh.mesh_dim_names)
    out[id(dist.group.WORLD)] = names
    for key, group in _AXES_GROUPS.get(mesh, {}).items():
        out[id(group)] = tuple(key)
    for a in names:
        out[id(mesh.get_group(a))] = (a,)
    return out


def _tensors(x) -> List[Any]:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _port_path() -> str:
    """The innermost port function on the Python stack, outside this
    module (used in messages only)."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG_DIR + os.sep) and fn != _THIS:
            mod = os.path.relpath(fn, _PKG_DIR)[:-3].replace(os.sep, ".")
            return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return "<top>"


class _Recorder:
    """The dispatch mode's state: this rank's records in issue order, the
    point-to-point batch being assembled, and the host reads."""

    def __init__(self, mesh, device: str) -> None:
        self.axes_of = _group_axes(mesh)
        self.device = device
        self.records: List[CollRecord] = []
        self.sends: List[List[Tuple[int, int]]] = []   # per p2p record
        self.recvs: List[List[Tuple[int, int]]] = []
        self.host: List[str] = []
        self.consts: "weakref.WeakSet" = weakref.WeakSet()
        self.batch: Optional[dict] = None    # open batch_isend_irecv
        self.lock = threading.Lock()

    def _group(self, args):
        import torch.distributed as dist

        for a in args:
            if type(a).__name__ != "ScriptObject":
                continue
            try:
                pg = dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue                 # the ReduceOp
            axes = self.axes_of.get(id(pg))
            if axes is None:
                axes = ("world",) if pg is dist.group.WORLD else (
                    "group" + str(dist.get_process_group_ranks(pg)),)
            return pg, axes
        return None, ("world",)

    @staticmethod
    def _reduce_name(args) -> str:
        for a in args:
            if type(a).__name__ == "ScriptObject":
                try:
                    code = int(a.op())
                except (AttributeError, RuntimeError, TypeError):
                    continue
                return _REDUCE_OPS.get(code, f"allreduce:{code}")
        return "psum"

    def c10d(self, name: str, args) -> None:
        import torch.distributed as dist

        base = name.split(".")[1]
        op = _C10D_OPS.get(base, f"c10d.{base}")
        pg, axes = self._group(args)
        if op == "psum":
            op = self._reduce_name(args)
        ts = _tensors(args[_PAYLOAD_ARG.get(base, 0)]) if args else []
        nbytes = sum(t.numel() * t.element_size() for t in ts)
        shape = (tuple(ts[0].shape) if len(ts) == 1
                 else (sum(t.numel() for t in ts),) if ts else ())
        dtype = str(ts[0].dtype).replace("torch.", "") if ts else "none"
        path = _port_path()
        with self.lock:
            if op != "ppermute":
                self.records.append(CollRecord(
                    op=op, axes=axes, dtype=dtype, shape=shape,
                    nbytes=nbytes, path=path))
                return
            b = self.batch
            if b is None or not (b["sends"] or b["recvs"]):
                b = {"axes": axes, "dtype": dtype, "path": path,
                     "nbytes": 0, "count": 0, "sends": [], "recvs": []}
                if self.batch is not None:
                    self.batch = b
            me = dist.get_rank(pg) if pg is not None else dist.get_rank()
            peer = int(args[2])
            if base == "send":
                b["nbytes"] += nbytes
                b["sends"].append((me, peer))
            else:
                b["recvs"].append((peer, me))
            b["count"] = max(b["count"], int(np.prod(shape)))
            if self.batch is None:        # a lone send or recv
                self.close(b)

    def close(self, b: Optional[dict]) -> None:
        """One ppermute record for a batch's sends and receives: the bytes
        this rank sends, the element count it moves either way."""
        if b is None or not (b["sends"] or b["recvs"]):
            return
        self.records.append(CollRecord(
            op="ppermute", axes=b["axes"], dtype=b["dtype"],
            shape=(b["count"],), nbytes=b["nbytes"],
            perm=tuple(b["sends"]), path=b["path"]))
        self.sends.append(list(b["sends"]))
        self.recvs.append(list(b["recvs"]))

    def host_read(self, name: str, args, kwargs) -> None:
        """A scalar read of a tensor on the program's device, or a copy
        from that device to the host.  On a CPU program (a gloo world)
        the CPU is the device, so its scalar reads count and no copy
        does; a read of a constant the program lifted from Python data
        (``torch.tensor(x)``) is no transfer on either."""
        import torch

        short = name.rsplit(".", 1)[0]
        src = args[1] if short == "aten.copy_" else args[0] if args else None
        if (not isinstance(src, torch.Tensor)
                or src.device.type != self.device or src in self.consts):
            return
        if short == "aten._to_copy":
            dev = (kwargs or {}).get("device")
            if dev is None or torch.device(dev).type != "cpu":
                return
        elif short == "aten.copy_":
            if args[0].device.type != "cpu":
                return
        if short != _SCALAR_READ and self.device == "cpu":
            return
        with self.lock:
            self.host.append(f"{_port_path()}/{short.split('.')[1]}")


class _Recording:
    """The recording context: a ``TorchDispatchMode`` that sees every
    ``c10d.*`` op and host read, and ``dist.batch_isend_irecv`` wrapped to
    mark batch boundaries, so a batch's sends and receives make one
    ppermute record (as one ``lax.ppermute`` eqn does in the reference)."""

    def __init__(self, rec: _Recorder) -> None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                name = str(func)
                if name.startswith("c10d."):
                    rec.c10d(name, args)
                elif name.startswith(_COPIES + (_SCALAR_READ,)):
                    rec.host_read(name, args, kwargs)
                out = func(*args, **(kwargs or {}))
                if name.startswith(_LIFT):
                    rec.consts.add(out)
                return out

        self.rec, self.mode = rec, _Mode()

    def __enter__(self) -> "_Recording":
        import torch.distributed as dist

        rec, orig = self.rec, dist.batch_isend_irecv
        self.orig = orig

        def batch_isend_irecv(p2p_op_list):
            with rec.lock:
                rec.batch = {"sends": [], "recvs": []}
            try:
                return orig(p2p_op_list)
            finally:
                with rec.lock:
                    b, rec.batch = rec.batch, None
                    rec.close(b)

        dist.batch_isend_irecv = batch_isend_irecv
        self.mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        try:
            self.mode.__exit__(*exc)
        finally:
            dist.batch_isend_irecv = self.orig


def _cross_rank(g: CommGraph, rec: _Recorder, comm) -> None:
    """Gather every rank's signature list and point-to-point pairs over
    ``comm`` (outside the recording), name the ranks whose sequence
    differs from the most common one (the lowest rank's on a tie), and
    give each ppermute record the perm assembled from every rank's
    sends, checked against every rank's receives."""
    import torch.distributed as dist

    n = dist.get_world_size(comm)
    got: List[Any] = [None] * n
    # comm-lint: disable=CL001 the verifier's own exchange: every rank's signature list, gathered after the recording has ended; not part of the extracted program
    dist.all_gather_object(
        got, (dist.get_rank(), g.signatures(), rec.sends, rec.recvs),
        group=comm)
    sigs = [[tuple(s) for s in x[1]] for x in got]
    common = sigs[max(range(n), key=lambda i: (sigs.count(sigs[i]), -i))]

    def graph(ss):
        return CommGraph(records=[CollRecord(
            op=s[0], axes=tuple(s[1]), dtype=s[2], shape=(s[3],),
            nbytes=0) for s in ss])

    for (rank, _, _, _), sig in zip(got, sigs):
        if sig != common:
            for issue in graph(common).match(graph(sig)):
                g.divergent_ranks.append(f"rank {rank}: {issue.msg}")
    pp = [i for i, r in enumerate(g.records) if r.op == "ppermute"]
    if any(len(x[2]) != len(pp) for x in got):
        return                    # the batches do not line up: mismatch
    for k, i in enumerate(pp):
        sends = sorted(p for x in got for p in x[2][k])
        recvs = sorted(p for x in got for p in x[3][k])
        if sends != recvs:
            g.divergent_ranks.append(
                f"ppermute #{k} at {g.records[i].path}: sends {sends} "
                f"are not matched by receives {recvs}")
        g.records[i] = replace(g.records[i], perm=tuple(sends))


def _program_device(mesh, args, kwargs) -> str:
    """The device type the program runs on: the mesh's, else that of the
    first tensor among its arguments, else ``"cuda"``."""
    import torch
    from torch.utils._pytree import tree_leaves

    if mesh is not None:
        return mesh.device_type
    for leaf in tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return "cuda"


def extract(fn: Callable, *args, source: str = "", mesh=None, comm=None,
            **kwargs) -> CommGraph:
    """Run ``fn(*args, **kwargs)`` once and extract its collective
    program.  ``mesh`` (a DeviceMesh) names each record's axes from its
    process group; ``comm`` (a process group every rank of which calls
    ``extract``) turns on the between-ranks matching and the whole-perm
    assembly.  Reads from the program's device (the mesh's, else its
    arguments') to the host are host transfers.  The function's own
    result is discarded."""
    rec = _Recorder(mesh, _program_device(mesh, args, kwargs))
    with _Recording(rec):
        fn(*args, **kwargs)
    g = CommGraph(records=list(rec.records),
                  host_transfers=list(rec.host),
                  source=source or getattr(fn, "__name__", "<fn>"))
    if comm is not None:
        _cross_rank(g, rec, comm)
    return g


def from_reshard_plan(plan) -> CommGraph:
    """Lift a compiled ``ReshardPlan`` into a CommGraph: the plan's
    step list is a static collective program whose wire figures the
    executor charges verbatim, so the plan-side record carries
    ``step.wire_bytes`` and the usual checks (bijection, axis
    existence) apply to its ppermute steps."""
    g = CommGraph(source=f"reshard-plan:{plan.label}")
    step_ops = {"all_to_all": "all_to_all", "all_gather": "all_gather",
                "ppermute": "ppermute", "device_put": "device_put",
                "slice": "slice"}
    for i, step in enumerate(plan.steps):
        op = step_ops.get(step.op, step.op)
        if op == "slice":
            continue              # local, no wire
        g.records.append(CollRecord(
            op=op, axes=tuple(step.axes), dtype=plan.dtype,
            shape=(), nbytes=int(step.wire_bytes), trips=1,
            perm=tuple(tuple(int(x) for x in p) for p in step.perm),
            path=f"reshard-plan/step{i}:{step.describe()}"))
    return g


# ---------------------------------------------------------------------------
# verify: static prediction vs runtime attribution
# ---------------------------------------------------------------------------

# runtime per-coll ledger key -> static wire model.  The traffic plane
# files its charges under wrapper-chosen coll names; each maps to the
# static model that reproduces the wrapper's byte expression exactly.
_DEFAULT_COLL_MAP = {
    "grad_sync": "psum_ring",
    "ring_attention": "ppermute",
    "ulysses": "all_to_all",
    "reshard": "reshard",
    # the fused decode program's collective-matmul rings: n−1 ppermute
    # hops per ring, charged per-ring by the serving engine — the
    # ppermute hop model reproduces the schedule's wire column exactly
    "decode_collmm": "ppermute",
}


@dataclass
class VerifyReport:
    """``verify()``'s typed result."""
    source: str
    n_records: int
    issues: List[Issue]
    rows: List[Dict[str, Any]]       # coll / static / runtime / ok
    host_transfers: List[str]

    @property
    def ok(self) -> bool:
        return (all(r["ok"] for r in self.rows)
                and not any(i.severity == "error" for i in self.issues))

    def to_json(self) -> Dict[str, Any]:
        return {
            "source": self.source, "ok": self.ok,
            "n_records": self.n_records,
            "issues": [{"kind": i.kind, "msg": i.msg,
                        "severity": i.severity} for i in self.issues],
            "rows": self.rows,
            "host_transfers": list(self.host_transfers),
        }

    def summary(self) -> str:
        lines = [f"commgraph: {self.source}: {self.n_records} collective "
                 f"record(s), {len(self.issues)} issue(s), "
                 f"{'OK' if self.ok else 'FAIL'}"]
        for r in self.rows:
            lines.append(
                f"  {r['coll']}: static {r['static']} B vs runtime "
                f"{r['runtime']} B {'==' if r['ok'] else '!='}")
        for i in self.issues:
            lines.append(f"  [{i.severity}] {i.kind}: {i.msg}")
        return "\n".join(lines)


def _static_bytes(g: CommGraph, mesh, model: str) -> int:
    if model == "psum_ring":
        return g.psum_ring_bytes(mesh)
    if model == "ppermute":
        return g.ppermute_bytes()
    if model == "all_to_all":
        return g.all_to_all_bytes()
    if model == "gather_scatter":
        return g.gather_scatter_bytes(mesh)
    if model == "reshard":
        return g.reshard_bytes()
    raise ValueError(f"unknown static wire model {model!r}")


def verify(fn: Callable, args: Sequence[Any], mesh,
           coll_map: Optional[Dict[str, str]] = None,
           graph: Optional[CommGraph] = None,
           runner: Optional[Callable[[], Any]] = None,
           source: str = "", comm=None) -> VerifyReport:
    """Static checks + byte-for-byte static-vs-runtime wire agreement.

    Extracts ``fn``'s collective program (or takes a pre-built
    ``graph``, e.g. a plan-lifted one), runs the well-formedness
    checks, then executes ``runner()`` (default: ``fn(*args)``, the
    card synchronized before the second read) under the traffic plane
    and compares the runtime per-coll byte deltas against the static
    models named by ``coll_map`` (default ``_DEFAULT_COLL_MAP``).  The
    static side never reads the traffic plane.  ``comm`` turns on the
    between-ranks matching of ``extract``.  The traffic plane's prior
    enabled state is restored."""
    import torch

    from .. import traffic

    g = graph if graph is not None else extract(
        fn, *args, source=source or getattr(fn, "__name__", "<fn>"),
        mesh=mesh, comm=comm)
    issues = g.check(mesh)
    cmap = dict(_DEFAULT_COLL_MAP if coll_map is None else coll_map)

    was_enabled = traffic.enabled
    if not was_enabled:
        traffic.enable()
    try:
        before = traffic.matrix.per_coll()
        runner() if runner is not None else fn(*args)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        after = traffic.matrix.per_coll()
    finally:
        if not was_enabled:
            traffic.disable()

    rows: List[Dict[str, Any]] = []
    for coll, model in cmap.items():
        static = _static_bytes(g, mesh, model)
        runtime = int(after.get(coll, 0)) - int(before.get(coll, 0))
        if static == 0 and runtime == 0:
            continue
        rows.append({"coll": coll, "model": model, "static": int(static),
                     "runtime": runtime, "ok": static == runtime})
    return VerifyReport(source=g.source, n_records=len(g.records),
                        issues=issues, rows=rows,
                        host_transfers=list(g.host_transfers))


# -- policy action verification ----------------------------------------------

# the decided-dispatch vocabulary a policy action may retarget, with the
# flat native arm's per-device hop factor (fraction of the payload, the
# same 2(n-1)/n-family expressions as perf/model._FACTOR and the
# runtime note models)
_ACTION_COLL_FACTORS: Dict[str, Callable[[int], float]] = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "grad_sync": lambda n: 2.0 * (n - 1) / n,        # bucketed allreduce
    "reduce_scatter": lambda n: (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "alltoall": lambda n: (n - 1) / n,
    "broadcast": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
    "collmm": lambda n: (n - 1) / n,
    "moe_dispatch": lambda n: (n - 1) / n,
    "moe_combine": lambda n: (n - 1) / n,
    "decode_ag": lambda n: (n - 1) / n,
    "decode_rs": lambda n: (n - 1) / n,
}

# ops with a quantized wire format (coll/quant.wire_bytes vocabulary,
# plus the bucketed-allreduce alias)
_QUANTIZABLE = {"allreduce": "allreduce", "grad_sync": "allreduce",
                "reduce_scatter": "reduce_scatter",
                "allgather": "allgather"}


def verify_action(coll: str, arm: str, nbytes: int = 1 << 20,
                  ndev: int = 8, dtype: str = "float32"
                  ) -> Dict[str, Any]:
    """Statically verify one policy-reachable ``(coll, arm)`` retarget.

    A policy engine calls this at construction for every arm its rules
    can reach, so an action that cannot be verified is rejected at
    registration, not at run time.  Checks the arm against the
    DEVICE_RULES mode vocabulary, the op against the decided dispatch
    vocabulary, and that the arm has a wire format for the op (``quant``
    on an op with no quantized codec is structurally impossible).
    Returns the wire-byte prediction for a ``nbytes`` payload over
    ``ndev`` devices — the figure a decision ledger records next to the
    measured effect.

    Raises ``ValueError`` with the full (coll, arm) context on any
    unverifiable action.
    """
    from . import rules as _rules

    if arm not in _rules.MODES:
        raise ValueError(
            f"policy action retargets {coll!r} to unknown arm {arm!r} "
            f"— not in the DEVICE_RULES mode vocabulary {_rules.MODES}")
    if coll not in _ACTION_COLL_FACTORS:
        raise ValueError(
            f"policy action retargets unknown op {coll!r} (arm {arm!r}) "
            f"— not in the decided dispatch vocabulary "
            f"{tuple(sorted(_ACTION_COLL_FACTORS))}")
    n = max(int(ndev), 2)
    esize = int(np.dtype(dtype).itemsize)
    native = int(round(_ACTION_COLL_FACTORS[coll](n) * int(nbytes)))
    wire = native
    quant_ratio = None
    if arm in ("quant", "hier+quant"):
        qcoll = _QUANTIZABLE.get(coll)
        if qcoll is None:
            raise ValueError(
                f"policy action retargets {coll!r} to arm {arm!r} but "
                f"{coll!r} has no quantized wire format "
                f"(quantizable: {tuple(sorted(_QUANTIZABLE))})")
        from ..coll.quant import wire_bytes
        wb = wire_bytes(qcoll, max(int(nbytes) // esize, 1), n, dtype)
        wire, native = int(wb["quant_bytes"]), int(wb["native_bytes"])
        quant_ratio = round(float(wb["ratio"]), 4)
    return {"coll": coll, "arm": arm, "ndev": n, "nbytes": int(nbytes),
            "predicted_wire_bytes": wire, "native_wire_bytes": native,
            "quant_ratio": quant_ratio, "ok": True}


__all__ = ["CollRecord", "CommGraph", "Issue", "VerifyReport", "extract",
           "from_reshard_plan", "verify", "verify_action"]
