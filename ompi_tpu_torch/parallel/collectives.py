"""Device collectives: named-axis primitives and the DeviceComm engine.

Counterpart of ``ompi_tpu/parallel/collectives.py``.  The JAX package runs
its collectives as XLA programs over ICI (``lax.psum``, ``all_gather``,
``psum_scatter``, ``all_to_all``, ``ppermute`` inside ``shard_map``); the
port hands the same collectives to NCCL through ``torch.distributed`` (gloo
on CPU tensors, in the CPU tests).  Nothing here is a kernel: what the JAX
package left to XLA goes to NCCL, and the local work (folds, gathers by
index maps) is PyTorch.

Two levels, as in the reference:
  * free functions (``psum``, ``all_gather_axis``, ``ppermute``, ...) on
    this process's tensor, over a process group or a mesh axis — where the
    reference names an axis inside ``shard_map``; ``ring_hop``,
    ``reduce_from`` and ``copy_to`` are the differentiable ones the mesh
    train step needs (a ring hop, Megatron's *g* and *f*);
  * ``DeviceComm`` — MPI-shaped collectives over one mesh axis, or over
    the product of a tuple of axes.

Layout of DeviceComm.  The reference holds one global (R, *elem) array,
row i being rank i's buffer, with each device owning r = R/n rows.  Here
each process is one of the n positions on the axis and holds its own rows,
an (r, *elem) tensor on its device; every method takes this process's rows
of the reference's input and returns this process's rows of the
reference's result, as fresh tensors (never views of the input).
``from_ranks``/``to_ranks`` convert between the full list of R per-rank
host buffers and this process's rows; ``to_ranks`` all-gathers, so every
caller sees what the single controller saw.  Rows may outnumber processes:
the single-card regime runs all R rows in one process (r = R) and folds
them locally before the (one-rank) NCCL collective, as the reference's
single-chip bench does.

Every method is collective: each process of the axis's group calls it with
the same arguments (apart from its own rows).  A CUDA tensor needs an NCCL
group and a CPU tensor a gloo group; anything else raises.
"""

from __future__ import annotations

import collections
import functools
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..op import MAX, MIN, SUM, Op

# The capacity slice of the ragged dense-rows exchange, read from the JAX
# package's variable (elements; 0 = auto, ~1M elements per device row).
SLICE_CAP_ENV = "OMPI_TPU_coll_a2av_slice_cap"

# ---------------------------------------------------------------------------
# process-group plumbing
# ---------------------------------------------------------------------------


def _check_backend(device_type: str, backend: str) -> None:
    """CUDA tensors travel over NCCL only and CPU tensors over gloo only:
    nothing is staged to the host or moved between devices quietly."""
    if device_type == "cuda" and backend != "nccl":
        raise RuntimeError(f"a CUDA tensor on a {backend!r} group: device "
                           f"collectives on the card need NCCL")
    if device_type != "cuda" and backend == "nccl":
        raise RuntimeError(f"a {device_type} tensor on an NCCL group")


def _group_of(axis, mesh=None):
    """A process group, or a mesh axis name (or a tuple of them, the
    product group ``mesh.axes_group`` makes) resolved on ``mesh``."""
    if isinstance(axis, str):
        if mesh is None:
            raise ValueError(f"axis {axis!r} named without its mesh")
        return mesh.get_group(axis)
    if isinstance(axis, tuple):
        if mesh is None:
            raise ValueError(f"axes {axis!r} named without their mesh")
        from .mesh import axes_group
        return axes_group(mesh, axis)
    return axis


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (NCCL has no bool type); same bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(*s) → (n, *s): every member's tensor, in group rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if x.numel():
        dist.all_gather_into_tensor(_wire(out).view(-1),
                                    _wire(x).view(-1), group=group)
    return out


_BITWISE = ("land", "lor", "band", "bor", "lxor", "bxor")


def _fold_rows(g: torch.Tensor, op: Op, like_dtype) -> torch.Tensor:
    """Reduce the stacked contributions g (n, *s) → (*s) for an op NCCL
    lacks, as the reference folds its all-gather (collectives.py:102-122)."""
    if op.name == "land":
        return g.bool().all(dim=0).to(like_dtype)
    if op.name == "lor":
        return g.bool().any(dim=0).to(like_dtype)
    if op.name in ("band", "bor"):
        f = torch.bitwise_and if op.name == "band" else torch.bitwise_or
        return functools.reduce(f, list(g.unbind(0)))
    if op.name in ("lxor", "bxor"):
        return functools.reduce(
            torch.bitwise_xor,
            [row.to(torch.int32) for row in g.unbind(0)]).to(like_dtype)
    acc = g[0]
    for i in range(1, g.shape[0]):
        acc = op.fn(acc, g[i])
    return acc


def _reduce(t: torch.Tensor, op: Op, group) -> torch.Tensor:
    """op over the group of a fresh tensor t (reused in place where NCCL
    has the op; else all-gather and fold)."""
    if op.dist_op is not None:
        dist.all_reduce(_wire(t), op=op.dist_op, group=group)
        return t
    return _fold_rows(_all_gather(t, group), op, t.dtype)


def _p2p(group, sends, recvs) -> None:
    """One batch of point-to-point transfers on ``group``.  ``sends`` and
    ``recvs`` are (tensor, group rank, tag) triples; a transfer with this
    process itself is a copy.  Every member of the group calls it, with or
    without transfers of its own: NCCL's communicators exist from the
    group's creation (``init_device_plane`` binds the card), so no batch
    needs every member."""
    me = dist.get_rank(group)
    ops = []
    own = {}
    for t, peer, tag in sends:
        if peer == me:
            own.setdefault(tag, []).append(t)
        else:
            ops.append(dist.P2POp(dist.isend, _wire(t.contiguous()),
                                  dist.get_global_rank(group, peer),
                                  group, tag))
    for t, peer, tag in recvs:
        if peer == me:
            t.copy_(own[tag].pop(0))
        else:
            ops.append(dist.P2POp(dist.irecv, _wire(t),
                                  dist.get_global_rank(group, peer),
                                  group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


# ---------------------------------------------------------------------------
# named-axis primitives, on this process's tensor
# ---------------------------------------------------------------------------


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    return preduce(x, axis, SUM, mesh)


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    return preduce(x, axis, MAX, mesh)


def pmin(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    return preduce(x, axis, MIN, mesh)


def _op_identity(op: Op, like: torch.Tensor) -> torch.Tensor:
    """Identity element of the named op, shaped like ``like``."""
    if op.name in ("sum", "lor", "bor", "bxor"):
        return torch.zeros_like(like)
    if op.name == "prod":
        return torch.ones_like(like)
    if op.name == "land":
        return torch.ones_like(like, dtype=torch.bool).to(like.dtype)
    if op.name == "band":
        if like.dtype.is_floating_point:
            return torch.ones_like(like)
        return ~torch.zeros_like(like)
    if op.name in ("max", "min"):
        if like.dtype.is_floating_point:
            v = -float("inf") if op.name == "max" else float("inf")
        elif like.dtype == torch.bool:
            v = op.name == "min"
        else:
            info = torch.iinfo(like.dtype)
            v = info.min if op.name == "max" else info.max
        return torch.full_like(like, v)
    raise ValueError(f"no identity for op {op.name}")


def preduce(x: torch.Tensor, axis, op: Op, mesh=None) -> torch.Tensor:
    """Reduce over a group with any Op.  Sum, product, max and min go to
    the backend's native all-reduce; the logical, bitwise and user ops
    all-gather and fold (NCCL has no bitwise reduction)."""
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    return _reduce(x.clone(memory_format=torch.contiguous_format), op, group)


def all_gather_axis(x: torch.Tensor, axis, tiled: bool = True,
                    mesh=None) -> torch.Tensor:
    """Every member's tensor, stacked (n, *s), or concatenated on dim 0
    when ``tiled``."""
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    g = _all_gather(x, group)
    return g.reshape((-1,) + tuple(x.shape[1:])) if tiled else g


def reduce_scatter_axis(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Sum over the group, scattered over dim 0 (divisible by n)."""
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not divisible by the "
                         f"{n}-member group")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def all_to_all_axis(x: torch.Tensor, axis, split_dim: int = 0,
                    concat_dim: int = 0, mesh=None) -> torch.Tensor:
    """Tiled all-to-all: ``split_dim`` is cut into n blocks, block p goes to
    member p, and the blocks received concatenate along ``concat_dim`` in
    member order.  A ``split_dim`` that n does not divide is zero-padded to
    the next multiple, as the reference pads it: member p holds rows
    [p*ceil, (p+1)*ceil) of the true extent, zeros past the end."""
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    n = dist.get_world_size(group)
    L = x.shape[split_dim]
    if L % n:
        pad = [0, 0] * x.dim()
        pad[2 * (x.dim() - 1 - split_dim) + 1] = -(-L // n) * n - L
        x = torch.nn.functional.pad(x, pad)
    moved = x.movedim(split_dim, 0)
    send = moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(_wire(recv), _wire(send), group=group)
    blocks = [b.movedim(0, split_dim) for b in recv.unbind(0)]
    return torch.cat(blocks, dim=concat_dim)


def ppermute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]],
             mesh=None) -> torch.Tensor:
    """Each (src, dst) pair sends src's tensor to dst; a member that no
    pair sends to gets zeros, as in ``lax.ppermute``."""
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    me = dist.get_rank(group)
    perm = [(int(s), int(d)) for s, d in perm]
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    sends = [(x, d, 0) for s, d in perm if s == me]
    recvs = [(out, s, 0) for s, d in perm if d == me]
    _p2p(group, sends, recvs)
    return out


def ring_shift(x: torch.Tensor, axis, n: int, shift: int = 1,
               steps: int = 1, mesh=None) -> torch.Tensor:
    """Neighbour exchange on a ring of n members: member i's tensor moves
    to member (i + shift) % n.  ``steps > 1`` takes ``steps`` hops of
    stride ``shift/steps`` (which must divide), the segmented ring."""
    steps = int(steps)
    if steps <= 1:
        return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)],
                        mesh)
    if shift % steps:
        raise ValueError(
            f"ring_shift: shift {shift} does not decompose into "
            f"{steps} equal strides (shift % steps must be 0)")
    stride = shift // steps
    perm = [(i, (i + stride) % n) for i in range(n)]
    for _ in range(steps):
        x = ppermute(x, axis, perm, mesh)
    return x


def pbcast(x: torch.Tensor, axis, root: int = 0, mesh=None) -> torch.Tensor:
    """Broadcast member ``root``'s tensor to every member."""
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(_wire(out), src=dist.get_global_rank(group, int(root)),
                   group=group)
    return out


# ---------------------------------------------------------------------------
# differentiable collectives: the transposes lax gives the reference for
# free, written out for the mesh train step.  Each takes the trivial path
# (no collective) on a group of one member.
# ---------------------------------------------------------------------------


def _ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ppermute(x, group, _ring_perm(dist.get_world_size(group), 1))

    @staticmethod
    def backward(ctx, g):
        # the inverse permutation carries each cotangent home
        n = dist.get_world_size(ctx.group)
        return ppermute(g, ctx.group, _ring_perm(n, -1)), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, me = dist.get_world_size(group), dist.get_rank(group)
        size = x.shape[dim] // n
        return x.narrow(dim, me * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = all_gather_axis(g.movedim(ctx.dim, 0).contiguous(), ctx.group)
        return full.movedim(0, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        full = all_gather_axis(x.movedim(dim, 0).contiguous(), group)
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        n, me = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        size = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, me * size, size), None, None


def ring_hop(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Member i's tensor moves to member (i + 1) % n; the backward moves
    each cotangent back by the inverse permutation (the transpose of
    ``lax.ppermute``)."""
    group = _group_of(axis, mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _RingHop.apply(x, group)


def reduce_from(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Megatron's *g*: sum over the group forward, identity backward.  It
    follows a row-parallel product (partial sums in, the replicated total
    out) and the vocab-parallel lookup and loss terms."""
    group = _group_of(axis, mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Megatron's *f*: identity forward, sum over the group backward.  It
    precedes a column-parallel product, whose members each send back a
    partial cotangent of their common input."""
    group = _group_of(axis, mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def split_to(x: torch.Tensor, dim: int, axis, mesh=None) -> torch.Tensor:
    """Megatron sequence parallelism's scatter: this member's block of a
    value replicated over the group, cut on ``dim``; backward, the
    members' cotangent blocks all-gathered (the value's cotangent is
    replicated again)."""
    group = _group_of(axis, mesh)
    if dist.get_world_size(group) == 1:
        return x
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not divide over "
                         f"the {dist.get_world_size(group)}-member group")
    return _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, dim: int, axis, mesh=None) -> torch.Tensor:
    """``split_to``'s inverse: the members' blocks all-gathered on ``dim``,
    a value replicated over the group whose cotangent is replicated too;
    backward, this member's block of it."""
    group = _group_of(axis, mesh)
    if dist.get_world_size(group) == 1:
        return x
    return _GatherFrom.apply(x, group, dim)


# ---------------------------------------------------------------------------
# DeviceComm: MPI-shaped collectives over one mesh axis
# ---------------------------------------------------------------------------


def _host(a) -> torch.Tensor:
    """A host buffer (numpy array or tensor) as a CPU tensor; numpy arrays
    are copied (they may be read-only)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.array(a))


def _repeat_rows(row: torch.Tensor, r: int) -> torch.Tensor:
    """(*s) → (r, *s), r materialised copies (a view would alias rows).
    Contiguous copies that double the filled rows: on the card they run as
    device-to-device copies, where ``repeat`` goes through PyTorch's
    strided elementwise copy and measured about half as fast."""
    out = torch.empty((r,) + tuple(row.shape), dtype=row.dtype,
                      device=row.device)
    out[0].copy_(row)
    k = 1
    while k < r:
        m = min(k, r - k)
        out[k:k + m].copy_(out[:m])
        k += m
    return out


def _ragged_arange(starts, counts, device) -> torch.Tensor:
    """concat(arange(s, s + c) for s, c in zip(starts, counts)), built on
    the device from the two small tables."""
    counts = np.asarray(counts, np.int64).reshape(-1)
    starts = np.asarray(starts, np.int64).reshape(-1)
    total = int(counts.sum())
    ct = torch.as_tensor(counts, device=device)
    st = torch.as_tensor(starts, device=device)
    begin = torch.cumsum(ct, 0) - ct
    return (torch.repeat_interleave(st - begin, ct, output_size=total)
            + torch.arange(total, device=device))


class DeviceComm:
    """Collectives over one axis of a mesh (see the module docstring for
    the layout).  ``n`` = processes along ``axis``; ``pos`` = this
    process's position on it.

    ``axis`` may also be a TUPLE of axis names: the comm then spans the
    row-major product of those axes (outer to inner), which is how a
    two-tier comm presents one flat rank space while the hierarchical arm
    of ``coll/nccl`` still addresses the levels by name.  Every flat
    collective runs on the product group (``mesh.axes_group``), whose
    ranks follow the mesh's order, so the tuple must name its axes in the
    mesh's order.  The cartesian neighbourhood exchange, which needs one
    line's geometry, keeps requiring one named axis, as in the reference
    (whose ``mesh.shape[axis]`` cannot read a tuple)."""

    def __init__(self, mesh, axis) -> None:
        if mesh.device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceComm on a cuda mesh and no CUDA device "
                               "is available")
        if isinstance(axis, (tuple, list)):
            axis = tuple(axis)
            names = tuple(mesh.mesh_dim_names)
            missing = [a for a in axis if a not in names]
            if missing or len(set(axis)) != len(axis):
                raise ValueError(f"axes {axis} are not distinct axes of the "
                                 f"mesh's {names}")
            if list(axis) != [a for a in names if a in axis]:
                raise ValueError(
                    f"axes {axis} must follow the mesh's axis order {names}: "
                    f"the product group ranks its members row-major in "
                    f"that order")
        self.mesh = mesh
        self.axis = axis
        self.group = _group_of(axis, mesh)
        self.backend = dist.get_backend(self.group)
        _check_backend(mesh.device_type, self.backend)
        self.n = dist.get_world_size(self.group)
        self.pos = dist.get_rank(self.group)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))
        # counts → device index maps, LRU-bounded as in the reference:
        # repeated patterns hit, per-step routings churn through
        self._idx_cache: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self._idx_cache_cap = 64
        self.spc = None          # the context's counters, set by coll/nccl
        self._quant = None
        self._last_a2av = None   # last a2av_plan taken (audit breadcrumb)
        self._kinds = None       # (sim override, axis_kinds()), made once

    def _idx_cached(self, key: tuple, build: Callable) -> Any:
        hit = self._idx_cache.get(key)
        if hit is not None:
            self._idx_cache.move_to_end(key)
            return hit
        val = build()
        self._idx_cache[key] = val
        if len(self._idx_cache) > self._idx_cache_cap:
            self._idx_cache.popitem(last=False)
        return val

    def cache_info(self) -> Dict[str, int]:
        return {"entries": len(self._idx_cache)}

    def axis_kinds(self) -> Dict[str, str]:
        """The comm's axes classified 'ici' or 'dcn'
        (``mesh.classify_axes`` over the comm's own groups), made once per
        value of the ``topo_sim_dcn_axes`` override.  Collective over the
        comm the first time for each value."""
        from .mesh import classify_axes, sim_dcn_axes
        key = sim_dcn_axes()
        if self._kinds is None or self._kinds[0] != key:
            self._kinds = (key, classify_axes(self.mesh, self.axis))
        return dict(self._kinds[1])

    def _one_axis(self, what: str) -> str:
        if isinstance(self.axis, tuple):
            raise ValueError(f"{what} needs a single named axis (one "
                             f"line's geometry), not the tuple {self.axis}")
        return self.axis

    @property
    def quant(self):
        """The block-quantized tier over the same axis (coll/quant)."""
        if self._quant is None:
            from ..coll.quant import QuantDeviceComm
            self._quant = QuantDeviceComm(self)
        return self._quant

    def _rows(self, x: torch.Tensor) -> int:
        """Check x lies on this comm's device; return its local rows r."""
        if x.device.type != self.device.type:
            raise ValueError(f"tensor on {x.device}, comm on {self.device}")
        _check_backend(x.device.type, self.backend)
        return x.shape[0]

    def _mine(self, seq, r: int):
        return seq[self.pos * r:(self.pos + 1) * r]

    # -- layout helpers -----------------------------------------------------

    def from_ranks(self, arrays: Sequence) -> torch.Tensor:
        """The R per-rank host buffers → this process's rows (r, *e) on its
        device."""
        R = len(arrays)
        if R % self.n:
            raise ValueError(f"{R} ranks do not divide over {self.n} "
                             f"processes")
        mine = self._mine(list(arrays), R // self.n)
        return torch.stack([_host(a) for a in mine]).to(self.device)

    def to_ranks(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's row of the global result, as host (CPU) tensors —
        numpy has no bfloat16.  All-gathers: every process gets all R."""
        self._rows(x)
        full = _all_gather(x, self.group)
        return list(full.reshape((-1,) + tuple(x.shape[1:])).cpu().unbind(0))

    def from_local(self, local_rows) -> torch.Tensor:
        """This process's rows (r, *e) from the host onto its device."""
        return _host(local_rows).to(self.device, copy=True)

    def to_local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows as one host tensor of their own."""
        return x.detach().to("cpu", copy=True)

    def canonicalize(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's shard of an array sharded on ``dim`` over the
        axis → its row of the canonical (n, *local) layout: the shard under
        a new leading dimension.  Zero wire."""
        if not 0 <= dim < x.dim():
            raise ValueError(f"canonicalize: dim {dim} out of range for "
                             f"rank-{x.dim()} array")
        self._rows(x)
        return x.unsqueeze(0).clone()

    # -- collectives --------------------------------------------------------
    #
    # With R rows over n processes each holds r = R/n of them (one process
    # holding all R is the single-card regime).  Local fold or slice over
    # the r rows, then one collective across processes.

    def _fold_local(self, xs: torch.Tensor, op: Op) -> torch.Tensor:
        """op-reduce the local rows (r, *e) → (*e)."""
        if op.name == "sum":
            return torch.sum(xs, dim=0, dtype=xs.dtype)
        if op.name == "max":
            return torch.amax(xs, dim=0)
        if op.name == "min":
            return torch.amin(xs, dim=0)
        if op.name == "prod":
            return torch.prod(xs, dim=0, dtype=xs.dtype)
        if op.name in _BITWISE:
            # the fold across processes, so every regime of r gives the
            # reference's rank-per-device result
            return _fold_rows(xs, op, xs.dtype)
        acc = xs[0]
        for i in range(1, xs.shape[0]):
            acc = op.fn(acc, xs[i])
        return acc

    def allreduce(self, x: torch.Tensor, op: Op = SUM) -> torch.Tensor:
        """Every rank's row ← op over all rows. (r,*e) → (r,*e)."""
        r = self._rows(x)
        # the fold is a fresh tensor wherever _reduce reuses it in place
        folded = self._fold_local(x, op)
        return _repeat_rows(_reduce(folded, op, self.group), r)

    def reduce(self, x: torch.Tensor, op: Op = SUM,
               root: int = 0) -> torch.Tensor:
        """MPI promises only the root's row; every row gets it, as in the
        reference."""
        return self.allreduce(x, op)

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Every row ← row ``root`` (one broadcast of one row)."""
        r = self._rows(x)
        root_dev, root_local = divmod(int(root), r)
        row = (x[root_local].clone() if self.pos == root_dev
               else torch.empty_like(x[0]))
        dist.broadcast(_wire(row), src=dist.get_global_rank(
            self.group, root_dev), group=self.group)
        return _repeat_rows(row, r)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """(r, b, *e) → (r, R*b, *e): every row = concat of all rows."""
        r = self._rows(x)
        full = _all_gather(x, self.group)
        return _repeat_rows(full.reshape((-1,) + tuple(x.shape[2:])), r)

    def allgather_dedup(self, x: torch.Tensor) -> torch.Tensor:
        """(r, b, *e) → (1, R*b, *e): ONE gathered copy per process, shared
        by its r ranks (the global result is (n, R*b, *e))."""
        self._rows(x)
        full = _all_gather(x, self.group)
        return full.reshape((1, -1) + tuple(x.shape[2:]))

    def dedup_to_ranks(self, x: torch.Tensor, ranks: int) -> list:
        """Per-rank host views of an ``allgather_dedup`` result: rank i
        reads its process's single copy, row i // r."""
        self._rows(x)
        host = _all_gather(x, self.group).reshape(
            (-1,) + tuple(x.shape[1:])).cpu()
        n = host.shape[0]
        if n == 0 or ranks % n:
            raise ValueError(
                f"ranks ({ranks}) must be a positive multiple of the "
                f"result's device rows ({n})")
        r = ranks // n
        return [host[i // r] for i in range(ranks)]

    def reduce_scatter(self, x: torch.Tensor, op: Op = SUM) -> torch.Tensor:
        """(r, R*b, *e) → (r, b, *e): row i = op-reduced i-th block."""
        r = self._rows(x)
        R = r * self.n
        if x.shape[1] % R:
            raise ValueError(f"dim 1 ({x.shape[1]}) is not divisible by "
                             f"{R} ranks")
        b = x.shape[1] // R
        e = tuple(x.shape[2:])
        folded = self._fold_local(x, op)                 # (R*b, *e)
        if op.dist_op is not None:
            mine = torch.empty((r * b,) + e, dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(_wire(mine), _wire(folded.contiguous()),
                                       op=op.dist_op, group=self.group)
        else:
            red = _fold_rows(_all_gather(folded, self.group), op, x.dtype)
            mine = red[self.pos * r * b:(self.pos + 1) * r * b].clone()
        return mine.reshape((r, b) + e)

    def alltoall(self, x: torch.Tensor) -> torch.Tensor:
        """(r, R, b, *e) → (r, R, b, *e): out[i, j] = in[j, i]."""
        r = self._rows(x)
        n = self.n
        rest = tuple(x.shape[2:])
        # send[k, a, c] = my row a's block for rank k*r + c
        send = x.reshape((r, n, r) + rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(_wire(recv), _wire(send), group=self.group)
        # recv[p, a, c] = in[p*r + a, pos*r + c] = out[c, p*r + a]
        perm = (2, 0, 1) + tuple(range(3, recv.dim()))
        return recv.permute(perm).reshape((r, n * r) + rest).contiguous()

    def ring_shift(self, x: torch.Tensor, shift: int = 1,
                   steps: int = 1) -> torch.Tensor:
        """(r,*e) → (r,*e) with global row i moved to row (i+shift)%R.
        ``steps > 1`` runs ``steps`` hops of stride ``shift/steps``."""
        if int(steps) > 1:
            if shift % int(steps):
                raise ValueError(
                    f"ring_shift: shift {shift} does not decompose into "
                    f"{steps} equal strides (shift % steps must be 0)")
            stride = shift // int(steps)
            for _ in range(int(steps)):
                x = self.ring_shift(x, stride)
            return x
        r = self._rows(x)
        x = x.contiguous()
        n, me = self.n, self.pos
        # the source rows of a block span at most two processes: rows
        # [off:] of process me+q, then rows [:off] of process me+q+1
        s = shift % (r * n)
        off = (-s) % r
        q = (-s - off) // r
        from .. import traffic
        if traffic.enabled:
            # the reference's perms for the same shift; per-rank bytes,
            # and note_ppermute banks the matching coll_wire_bytes
            row = x.nbytes // max(r, 1)
            if r == 1:
                traffic.note_ppermute(
                    self.mesh, self.axis,
                    [(i, (i + shift) % n) for i in range(n)], row,
                    spc=self.spc, coll="ring_shift")
            else:
                traffic.note_ppermute(
                    self.mesh, self.axis,
                    [((d + q) % n, d) for d in range(n)], (r - off) * row,
                    spc=self.spc, coll="ring_shift")
                if off:
                    traffic.note_ppermute(
                        self.mesh, self.axis,
                        [((d + q + 1) % n, d) for d in range(n)],
                        off * row, spc=self.spc, coll="ring_shift")
        a = torch.empty_like(x[off:])
        sends = [(x[off:], (me - q) % n, 0)]
        recvs = [(a, (me + q) % n, 0)]
        if off:
            b = torch.empty_like(x[:off])
            sends.append((x[:off], (me - q - 1) % n, 1))
            recvs.append((b, (me + q + 1) % n, 1))
        _p2p(self.group, sends, recvs)
        return torch.cat([a, b]) if off else a

    def push_row(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """(r, *e) → (r, *e) with global row dst ← row src, the others
        unchanged: one row crosses between two processes."""
        r = self._rows(x)
        src_dev, src_loc = divmod(int(src), r)
        dst_dev, dst_loc = divmod(int(dst), r)
        from .. import traffic
        if traffic.enabled and src_dev != dst_dev:
            # exactly one row crosses, on the (src_dev, dst_dev) edge
            traffic.note_ppermute(self.mesh, self.axis, [(src_dev, dst_dev)],
                                  x.nbytes // max(r, 1), spc=self.spc,
                                  coll="push_row")
        out = x.clone(memory_format=torch.contiguous_format)
        row = torch.empty_like(x[0])
        sends = [(x[src_loc], dst_dev, 0)] if self.pos == src_dev else []
        recvs = [(row, src_dev, 0)] if self.pos == dst_dev else []
        _p2p(self.group, sends, recvs)
        if self.pos == dst_dev:
            out[dst_loc] = row
        return out

    def scan(self, x: torch.Tensor, op: Op = SUM,
             exclusive: bool = False) -> torch.Tensor:
        """Prefix reduction across ranks: row i ← op(rows 0..i)."""
        r = self._rows(x)
        cum = {"sum": lambda t: torch.cumsum(t, 0, dtype=t.dtype),
               "prod": lambda t: torch.cumprod(t, 0, dtype=t.dtype),
               "max": lambda t: torch.cummax(t, 0).values,
               "min": lambda t: torch.cummin(t, 0).values}.get(op.name)
        if cum is not None:
            # local prefix, then only the per-process totals cross
            loc = cum(x)                                   # (r, *e)
            totals = _all_gather(loc[-1], self.group)      # (n, *e)
            csum = cum(totals)
            base = (csum[self.pos - 1] if self.pos > 0
                    else _op_identity(op, totals[0]))
            out = op.fn(base.unsqueeze(0).expand(loc.shape), loc)
            if exclusive:
                out = torch.cat([base.unsqueeze(0), out[:-1]])
            return out
        # a general op: gather every row, then an in-order scan
        full = _all_gather(x, self.group).reshape(
            (-1,) + tuple(x.shape[1:]))                    # (R, *e)
        acc = [full[0]]
        for i in range(1, full.shape[0]):
            acc.append(op.fn(acc[-1], full[i]))
        csum = torch.stack(acc)
        if exclusive:
            try:
                z = _op_identity(op, csum[:1])
            except ValueError:
                # a user op with no identity: MPI leaves exclusive row 0
                # undefined; zeros, as in the reference
                z = torch.zeros_like(csum[:1])
            csum = torch.cat([z, csum[:-1]])
        return self._mine(csum, r).clone()

    def barrier(self) -> None:
        """A real cross-process sync: a one-element all-reduce, waited on."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        t.item()

    # -- ragged (v-variant) collectives ------------------------------------
    #
    # Ragged buffers keep the reference's padded layouts — (r, cap, *e) with
    # row i holding counts[i] valid elements, and (r, R, cap, *e) blocks —
    # so results match it position for position.  On the wire only valid
    # elements travel: all_to_all_single with split sizes, packed and
    # unpacked by index maps built on the device from the host counts and
    # kept in the LRU of index maps.

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power-of-two capacity bucket (≥1)."""
        return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1

    @staticmethod
    def pack_ragged_blocks(rows: np.ndarray, C: np.ndarray,
                           cap: int) -> np.ndarray:
        """Host helper: dense per-rank rows (R, total, *e) + counts matrix
        C (C[i, j] = elements rank i sends to j, row sums ≤ total) → the
        padded (R, R, cap, *e) block layout alltoallv consumes."""
        rows = np.asarray(rows)
        R = C.shape[0]
        out = np.zeros((R, R, cap) + rows.shape[2:], rows.dtype)
        for i in range(R):
            off = 0
            for j in range(R):
                c = int(C[i, j])
                out[i, j, :c] = rows[i, off:off + c]
                off += c
        return out

    @staticmethod
    def compact_ragged_blocks(blocks: np.ndarray, C: np.ndarray,
                              out_cap: int) -> np.ndarray:
        """Host helper: padded (R, R, cap, *e) blocks → (R, out_cap, *e)
        rows, row j the dense concatenation of every source's valid
        elements for j (the staged arm and the oracle in tests)."""
        blocks = np.asarray(blocks)
        R = C.shape[0]
        out = np.zeros((R, out_cap) + blocks.shape[3:], blocks.dtype)
        for j in range(R):
            pos = 0
            for i in range(R):
                c = int(C[i, j])
                out[j, pos:pos + c] = blocks[i, j, :c]
                pos += c
        return out

    @staticmethod
    def compact_from_rows(rows: np.ndarray, C: np.ndarray,
                          out_cap: int) -> np.ndarray:
        """Host oracle/staged arm for :meth:`alltoallv_from_rows`: dense
        per-rank send rows + counts → the compact padded receive rows."""
        rows = np.asarray(rows)
        C = np.asarray(C, dtype=np.int64)
        R = C.shape[0]
        soff = np.zeros((R, R), np.int64)
        soff[:, 1:] = np.cumsum(C, axis=1)[:, :-1]
        out = np.zeros((R, int(out_cap)) + rows.shape[2:], rows.dtype)
        for j in range(R):
            pos = 0
            for i in range(R):
                c = int(C[i, j])
                out[j, pos:pos + c] = rows[i, soff[i, j]:soff[i, j] + c]
                pos += c
        return out

    def pad_ragged(self, arrays: Sequence) -> Tuple[torch.Tensor, list]:
        """The R ragged per-rank host buffers → (this process's rows of the
        padded (R, cap_bucket, *e) layout, counts)."""
        counts = [int(np.asarray(a).shape[0]) for a in arrays]
        cap = self._bucket(max(counts) if counts else 1)
        R = len(arrays)
        if R % self.n:
            raise ValueError(f"{R} ranks do not divide over {self.n} "
                             f"processes")
        r = R // self.n
        first = _host(arrays[0])
        out = torch.zeros((r, cap) + tuple(first.shape[1:]),
                          dtype=first.dtype)
        for i, a in enumerate(self._mine(list(arrays), r)):
            a = _host(a)
            out[i, :a.shape[0]] = a
        return out.to(self.device), counts

    def unpad_ragged(self, x: torch.Tensor, counts: Sequence[int]) -> list:
        """Padded (r, cap, *e) → every rank's exact host buffer (R of
        them; all-gathers, as to_ranks does)."""
        return [row[:int(c)] for row, c in zip(self.to_ranks(x), counts)]

    def allgatherv(self, x: torch.Tensor,
                   counts: Sequence[int]) -> torch.Tensor:
        """(r, cap, *e) padded + counts → (r, total, *e): every row is the
        dense concatenation of all ranks' valid elements."""
        r = self._rows(x)
        counts = [int(c) for c in counts]
        cap = x.shape[1]
        e = tuple(x.shape[2:])
        total = sum(counts)
        per = [sum(counts[k * r:(k + 1) * r]) for k in range(self.n)]
        mine = self._mine(counts, r)
        idx = self._idx_cached(
            ("allgatherv", cap, tuple(mine)),
            lambda: _ragged_arange(np.arange(r) * cap, mine, self.device))
        packed = x.reshape((r * cap,) + e).index_select(0, idx)
        out = torch.empty((total,) + e, dtype=x.dtype, device=x.device)
        if total:
            send = packed.repeat((self.n,) + (1,) * len(e))
            dist.all_to_all_single(_wire(out), _wire(send),
                                   output_split_sizes=per,
                                   input_split_sizes=[per[self.pos]] * self.n,
                                   group=self.group)
        return _repeat_rows(out, r)

    def gather(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """MPI promises only the root's row; every row gets the gather, as
        in the reference."""
        return self.allgather(x)

    def gatherv(self, x: torch.Tensor, counts: Sequence[int],
                root: int = 0) -> torch.Tensor:
        return self.allgatherv(x, counts)

    def scatter(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """(r, R, b, *e) — rank ``root``'s row holds R blocks — → (r, b, *e):
        row i gets root's block i."""
        r = self._rows(x)
        root_dev, root_local = divmod(int(root), r)
        out = torch.empty_like(x[0, :r])
        parts = None
        if self.pos == root_dev:
            parts = [_wire(p.contiguous())
                     for p in x[root_local].split(r, dim=0)]
        dist.scatter(_wire(out), parts, src=dist.get_global_rank(
            self.group, root_dev), group=self.group)
        return out

    def scatterv(self, x: torch.Tensor, counts: Sequence[int],
                 root: int = 0) -> torch.Tensor:
        """(r, R, cap, *e) padded blocks in row ``root`` → (r, cap, *e)
        (still padded: unpad_ragged for exact rows)."""
        return self.scatter(x, root)

    def _a2av_steps(self, key, C: np.ndarray, soff: np.ndarray,
                    stride: int, out_cap: int, S: int, k: int) -> list:
        """Per slice step s of a ragged exchange, the maps that pack this
        process's valid elements [s*S, (s+1)*S) of every block (i, j) in
        destination order (send index into the flat source rows, whose
        row i starts at i_local*stride and block j at soff[i, j]), the
        split sizes, and where each received element lands in the flat
        (r*out_cap) output."""
        def build():
            n, r, me = self.n, C.shape[0] // self.n, self.pos
            R = n * r
            roff = np.zeros((R, R), np.int64)          # recv offsets in j
            roff[1:, :] = np.cumsum(C, axis=0)[:-1, :]
            rows = np.arange(me * r, (me + 1) * r)
            steps = []
            for s in range(k):
                cs = np.clip(C - s * S, 0, S)          # (src i, dst j)
                if not cs.any():       # a slice past every block's end
                    continue
                # send order: dst j (all R, by process), then my src i
                cnt = cs[rows, :].T                    # (R j, r i)
                st = (np.arange(r)[None, :] * stride
                      + soff[rows, :].T + s * S)
                send = _ragged_arange(st, cnt, self.device)
                sends = cnt.reshape(n, -1).sum(axis=1)
                # recv order: src process p, my dst j, p's src i
                rc = cs[:, rows].reshape(n, r, r).transpose(0, 2, 1)
                dst = (np.arange(r)[None, :, None] * out_cap
                       + roff[:, rows].reshape(n, r, r).transpose(0, 2, 1)
                       + s * S)
                land = _ragged_arange(dst, rc, self.device)
                recvs = rc.reshape(n, -1).sum(axis=1)
                steps.append((send, [int(v) for v in sends], land,
                              [int(v) for v in recvs]))
            return steps
        return self._idx_cached(key, build)

    def _a2av_exchange(self, flat: torch.Tensor, steps: list, r: int,
                       out_cap: int) -> torch.Tensor:
        e = tuple(flat.shape[1:])
        out = torch.zeros((r * out_cap,) + e, dtype=flat.dtype,
                          device=flat.device)
        for send_idx, sends, land, recvs in steps:
            buf = flat.index_select(0, send_idx)
            got = torch.empty((sum(recvs),) + e, dtype=flat.dtype,
                              device=flat.device)
            dist.all_to_all_single(_wire(got), _wire(buf),
                                   output_split_sizes=recvs,
                                   input_split_sizes=sends,
                                   group=self.group)
            out.index_copy_(0, land, got)
        return out.reshape((r, out_cap) + e)

    def alltoallv(self, x: torch.Tensor, counts) -> Tuple[torch.Tensor, list]:
        """Ragged all-to-all. x: (r, R, cap, *e) padded blocks — block
        [i, j] holds counts[i][j] valid elements from rank i to rank j.
        Returns ((r, out_cap, *e) padded, recv_counts): row j is the dense
        concatenation over sources of their valid elements for j."""
        r = self._rows(x)
        C = np.asarray(counts, dtype=np.int64)
        R, cap = r * self.n, x.shape[2]
        if C.size and int(C.max()) > cap:
            raise ValueError(f"a count ({int(C.max())}) exceeds the block "
                             f"capacity {cap}")
        recv_tot = C.sum(axis=0)
        out_cap = self._bucket(int(recv_tot.max()) if R else 1)
        soff = np.broadcast_to(np.arange(R) * cap, (R, R))
        steps = self._a2av_steps(("alltoallv", cap, C.tobytes()), C, soff,
                                 R * cap, out_cap, max(cap, 1), 1)
        flat = x.reshape((r * R * cap,) + tuple(x.shape[3:]))
        out = self._a2av_exchange(flat, steps, r, out_cap)
        return out, [int(t) for t in recv_tot]

    def a2av_plan(self, shape: tuple, counts,
                  slice_cap: Optional[int] = None) -> Dict[str, int]:
        """The (slice_cap, scan_steps, out_cap) figures the sliced ragged
        exchange takes for a (R, L, *e) send of ``shape`` + counts matrix
        — pure shape math.  An explicit ``slice_cap`` wins; else
        ``OMPI_TPU_coll_a2av_slice_cap``; else the ~1M-element transient
        heuristic of the reference."""
        C = np.asarray(counts, dtype=np.int64)
        R = shape[0]
        cap = self._bucket(int(C.max()) if C.size else 1)
        out_cap = self._bucket(int(C.sum(axis=0).max()) if C.size else 1)
        elem = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        if slice_cap is None:
            raw = os.environ.get(SLICE_CAP_ENV, "") or "0"
            try:
                cfgd = int(raw)
            except ValueError:
                raise ValueError(f"{SLICE_CAP_ENV}={raw!r} is not an "
                                 f"integer") from None
            if cfgd > 0:
                slice_cap = min(cap, cfgd)
            else:
                slice_cap = min(cap, max(64, self._bucket(
                    max(1, (1 << 20) // max(R * elem, 1)))))
        slice_cap = max(1, int(slice_cap))
        return {"slice_cap": int(slice_cap),
                "scan_steps": int(-(-cap // slice_cap)),
                "out_cap": int(out_cap)}

    def alltoallv_from_rows(self, x: torch.Tensor, counts,
                            slice_cap: Optional[int] = None
                            ) -> Tuple[torch.Tensor, list]:
        """Ragged all-to-all straight from DENSE rows: (r, L, *e) + counts
        matrix C → ((r, out_cap, *e) padded-dense, recv_counts), the same
        result as ``pack_ragged_blocks`` + :meth:`alltoallv` with no padded
        block tensor anywhere.  The capacity runs in ``slice_cap``-sized
        slices, one exchange a slice, so the transient per step is
        O(R·slice_cap·r) as in the reference.  Row i of the global x holds
        its sends dense and concatenated in destination order."""
        r = self._rows(x)
        C = np.asarray(counts, dtype=np.int64)
        R, L = r * self.n, x.shape[1]
        # the plan is shape math on the global (R, L, *e) send
        plan = self.a2av_plan((R,) + tuple(x.shape[1:]), C, slice_cap)
        # the footprint/padding trade this call took, for the caller's
        # decision audit (moe_block_ep reads it)
        self._last_a2av = dict(plan)
        S, k, out_cap = plan["slice_cap"], plan["scan_steps"], plan["out_cap"]
        soff = np.zeros((R, R), np.int64)
        soff[:, 1:] = np.cumsum(C, axis=1)[:, :-1]
        steps = self._a2av_steps(("a2av_rows", L, S, k, C.tobytes()), C,
                                 soff, L, out_cap, S, k)
        flat = x.reshape((r * L,) + tuple(x.shape[2:]))
        out = self._a2av_exchange(flat, steps, r, out_cap)
        return out, [int(t) for t in C.sum(axis=0)]

    def _row_gather_dev(self, x: torch.Tensor, idx: torch.Tensor,
                        m: int) -> torch.Tensor:
        """row_gather against this process's rows of a device map (r, m)."""
        r = self._rows(x)
        T = x.shape[1]
        e = tuple(x.shape[2:])
        flat = (idx.clamp(min=0)
                + torch.arange(r, device=idx.device)[:, None] * T)
        out = x.reshape((r * T,) + e).index_select(0, flat.reshape(-1))
        out = out.reshape((r, m) + e)
        mask = (idx >= 0).reshape((r, m) + (1,) * len(e))
        return torch.where(mask, out, torch.zeros_like(out))

    def row_gather(self, x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """Per-row gather: (r, T, *e) + host map idx (R, M) → (r, M, *e),
        out[i, m] = x[i, idx[i, m]] (idx −1 → zeros).  The map uploads
        per call, as in the reference."""
        r = self._rows(x)
        idx = np.asarray(idx, np.int64)
        mine = torch.as_tensor(self._mine(idx, r), device=self.device)
        return self._row_gather_dev(x, mine, idx.shape[1])

    def reduce_scatter_v(self, x: torch.Tensor, counts: Sequence[int],
                         op: Op = SUM) -> torch.Tensor:
        """(r, total, *e) + counts → (r, cap, *e) padded: row i holds the
        op-reduction of every rank's block [displ_i : displ_i+counts_i]."""
        r = self._rows(x)
        counts = [int(c) for c in counts]
        R = len(counts)
        e = tuple(x.shape[2:])
        cap = self._bucket(max(counts) if counts else 1)

        def build():
            displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
            idx = np.full((R, cap), -1, np.int64)
            for i, c in enumerate(counts):
                idx[i, :c] = np.arange(c) + int(displs[i])
            dev = lambda a: torch.as_tensor(a, device=self.device)
            return dev(np.maximum(idx, 0).reshape(-1)), dev(idx >= 0)

        safe, mask = self._idx_cached(("reduce_scatter_v", cap,
                                       tuple(counts)), build)
        folded = self._fold_local(x, op)                   # (total, *e)
        if op.dist_op is not None:
            # padded blocks, zeros in the pad (every op maps zeros to 0)
            blocks = folded.index_select(0, safe)
            m = mask.reshape((-1,) + (1,) * len(e))
            blocks = torch.where(m, blocks, torch.zeros_like(blocks))
            mine = torch.empty((r * cap,) + e, dtype=x.dtype,
                               device=x.device)
            dist.reduce_scatter_tensor(_wire(mine), _wire(blocks),
                                       op=op.dist_op, group=self.group)
            return mine.reshape((r, cap) + e)
        red = _fold_rows(_all_gather(folded, self.group), op, x.dtype)
        my = slice(self.pos * r * cap, (self.pos + 1) * r * cap)
        mine = red.index_select(0, safe[my]).reshape((r, cap) + e)
        m = self._mine(mask, r).reshape((r, cap) + (1,) * len(e))
        return torch.where(m, mine, torch.zeros_like(mine))

    # -- neighbourhood exchange (halo / stencil) -----------------------------
    #
    # Rank-per-position layout only (one row per process, r = 1), as in the
    # reference.  On a periodic cart every neighbour slot (dim, ±1) is one
    # ring permutation of the whole rank set; all 2·ndims slots go in one
    # batch of point-to-point transfers, tagged by slot.

    def _cart_perms(self, topo) -> list:
        """[(dim, dir, [(src, dst), ...])] in the standard's slot order
        (per dim: -1 then +1): the value FROM src lands AT dst."""
        perms = []
        for dim in range(len(topo.dims)):
            for disp in (-1, 1):
                pairs = []
                for i in range(self.n):
                    c = topo.coords(i)
                    c[dim] += disp           # periodic wrap in rank_of
                    pairs.append((topo.rank_of(c), i))
                perms.append((dim, disp, pairs))
        return perms

    def _check_cart(self, x, topo) -> None:
        self._one_axis("the device cart exchange")
        if not all(topo.periods):
            raise ValueError("device cart exchange requires a fully "
                             "periodic topology (host path otherwise)")
        R = self._rows(x) * self.n
        if topo.size != R or R != self.n:
            raise ValueError(
                f"cart size {topo.size} / rows {R} / mesh "
                f"{self.n} disagree (rank-per-position layout required)")

    def _slot_exchange(self, blocks: Callable[[int], torch.Tensor],
                       slots: list, like: torch.Tensor) -> torch.Tensor:
        """out[0, j] ← the tensor ``blocks(j)`` of the process that slot j's
        pairs name as this process's source."""
        me = self.pos
        out = torch.empty((1, len(slots)) + tuple(like.shape),
                          dtype=like.dtype, device=like.device)
        sends, recvs = [], []
        for j, pairs in enumerate(slots):
            for src, dst in pairs:
                if src == me:
                    sends.append((blocks(j), dst, j))
                if dst == me:
                    recvs.append((out[0, j], src, j))
        _p2p(self.group, sends, recvs)
        return out

    def neighbor_allgather_cart(self, x: torch.Tensor, topo) -> torch.Tensor:
        """(1, b, *e) → (1, k, b, *e): slot j is neighbour j's row
        (k = 2·ndims, dim-major, -1 then +1)."""
        self._check_cart(x, topo)
        slots = [pairs for _d, _s, pairs in self._cart_perms(topo)]
        return self._slot_exchange(lambda j: x[0], slots, x[0])

    def neighbor_alltoall_cart(self, x: torch.Tensor, topo) -> torch.Tensor:
        """(1, k, b, *e) → (1, k, b, *e): block j travels to neighbour j,
        landing in the MIRROR slot (a dim's -1 block arrives in the
        receiver's +1 slot) — the halo-exchange data motion."""
        self._check_cart(x, topo)
        k = 2 * len(topo.dims)
        if x.shape[1] != k:
            raise ValueError(f"block dim {x.shape[1]} != {k} neighbors")
        slots = [pairs for _d, _s, pairs in self._cart_perms(topo)]
        return self._slot_exchange(lambda j: x[0, j ^ 1], slots, x[0, 0])

    def _check_graph(self, x, topo) -> int:
        R = self._rows(x) * self.n
        if R != self.n or getattr(topo, "size", R) != R:
            raise ValueError(
                f"graph exchange needs rank-per-position layout (rows "
                f"{R} == mesh {self.n} == topo size)")
        return R

    def neighbor_allgather_graph(self, x: torch.Tensor, topo) -> torch.Tensor:
        """General-topology neighbourhood allgather: (1, b, *e) →
        (1, maxdeg, b, *e), slot j = in-neighbour j's row (zeros past this
        rank's degree).  Degrees are host metadata; callers slice by
        topo.in_neighbors."""
        R = self._check_graph(x, topo)
        ins = [list(topo.in_neighbors(i)) for i in range(R)]
        maxdeg = max((len(nb) for nb in ins), default=0)
        me = self.pos
        out = torch.zeros((1, maxdeg) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        sends = [(x[0], i, k) for i, nb in enumerate(ins)
                 for k, s in enumerate(nb) if s == me]
        recvs = [(out[0, k], s, k) for k, s in enumerate(ins[me])]
        _p2p(self.group, sends, recvs)
        return out

    def neighbor_alltoall_graph(self, x: torch.Tensor, topo) -> torch.Tensor:
        """General-topology neighbourhood alltoall: x (1, outdeg_max, b, *e)
        — block p goes to this rank's p-th OUT-neighbour — →
        (1, indeg_max, b, *e), slot k from the k-th IN-neighbour (zeros past
        this rank's degree)."""
        R = self._check_graph(x, topo)
        K = x.shape[1]
        outs = [list(topo.out_neighbors(i)) for i in range(R)]
        ins = [list(topo.in_neighbors(i)) for i in range(R)]
        if max((len(o) for o in outs), default=0) > K:
            raise ValueError(
                f"block dim {K} < max out-degree "
                f"{max(len(o) for o in outs)}")
        for o in outs:
            if len(set(o)) != len(o):
                raise ValueError("repeated edges are not supported "
                                 "on the device graph path")
        edges_out = sorted((i, j) for i, o in enumerate(outs) for j in o)
        edges_in = sorted((s, j) for j, nb in enumerate(ins) for s in nb)
        if edges_out != edges_in:
            raise ValueError("the topology's in- and out-neighbour lists "
                             "disagree")
        indeg_max = max((len(nb) for nb in ins), default=0)
        me = self.pos
        out = torch.zeros((1, indeg_max) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        # tag = the receiver's slot
        sends = [(x[0, p], j, ins[j].index(me))
                 for p, j in enumerate(outs[me])]
        recvs = [(out[0, k], s, k) for k, s in enumerate(ins[me])]
        _p2p(self.group, sends, recvs)
        return out


__all__ = ["DeviceComm", "psum", "pmax", "pmin", "preduce",
           "all_gather_axis", "reduce_scatter_axis", "all_to_all_axis",
           "ppermute", "ring_shift", "pbcast", "ring_hop", "reduce_from",
           "copy_to"]
