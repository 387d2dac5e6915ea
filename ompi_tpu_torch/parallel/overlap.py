"""parallel/overlap — bucketed, backward-overlapped gradient sync.

The port's copy of ``ompi_tpu/parallel/overlap.py``.  The dp gradient
allreduce is the framework's largest collective; issued one leaf at a time
after the whole backward, small leaves pay the launch floor and the wire
idles through the backward.  Here the gradients are flattened into
fixed-byte BUCKETS (default 4 MiB, ``coll_nccl_grad_bucket_bytes`` or
``Config(grad_bucket_bytes=...)``) in reverse flatten order, the order the
backward produces them, and each bucket's one allreduce is issued as soon
as its last gradient exists, so it overlaps the rest of the backward.

Mechanism: where the JAX package tags each bucket with an identity
``jax.custom_vjp``, the port hooks each bucket's leaves
(``Tensor.register_hook``: a leaf's hook sees its whole gradient); when
the last of them has its gradient, the bucket's gradients are flattened
into one f32 buffer and its allreduce is issued: with ``async_op=True``
(native: the backward goes on while NCCL moves it) or through
``coll/quant.psum_quant`` (quant, ordered on the stream), the arm chosen
per bucket by the decision layer (``coll/nccl.decide_mode``, coll name
``grad_sync``).  Buckets are issued in plan order on every rank (a bucket
whose hook fires early waits for the ones before it), so every rank issues
the same collectives in the same order, as NCCL requires.  The step waits
for every bucket before it returns the gradients (and so before AdamW).

Like the reference, the sync runs over the data-parallel axes only: on a
mesh whose tp or sp axis is larger than 1 it would replicate those axes'
parameter shards, so such meshes are refused.  An outer ``dpo`` axis is
part of the sync domain (``dp_sync_axes``: the dpo×dp product, the batch
cut row-major over it): on a two-tier domain (``dpo`` slow, ``dp`` fast,
``parallel/hierarchy.hier_axes``) a bucket may also take the
hierarchical arms, ``hier`` (reduce-scatter over dp, allreduce over dpo
on the scattered 1/n_dp, allgather over dp) and ``hier+quant`` (the outer
stage block-quantized).  The reference's ``decide:`` events, spans,
traffic and numerics hooks come with P16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import var as _var
from ..optim import tree_leaves
from .mesh import axes_group, axes_position, axis_size, classify_axes

GRAD_SYNC_MODES = ("perleaf", "bucketed", "unsynced")

# pvar state (read through by spc.Counters): the most recently built
# grad-sync plan — how many bucket exchanges it issues and the total
# gradient bytes they carry
_PVARS = {"grad_bucket_count": 0, "grad_bucket_bytes": 0}


def pvar_value(name: str) -> int:
    """MPI_T read-through accessor (spc.Counters.get/snapshot)."""
    return _PVARS[name]


# -- post-sync hooks ----------------------------------------------------------
# callables(grads) invoked after every grad sync, right before the
# (loss, grads) return — the point low-rate maintenance work rides on.  A
# raising hook is logged with attribution and dropped for the step rather
# than poisoning the training loop.

_post_sync_hooks: List[Callable] = []


def add_post_sync_hook(fn: Callable) -> Callable:
    _post_sync_hooks.append(fn)
    return fn


def remove_post_sync_hook(fn: Callable) -> None:
    try:
        _post_sync_hooks.remove(fn)
    except ValueError:
        pass


def _run_post_sync(grads) -> None:
    if not _post_sync_hooks:
        return
    from ..core.output import output
    for fn in list(_post_sync_hooks):
        try:
            fn(grads)
        except Exception as err:
            name = getattr(fn, "__qualname__",
                           getattr(fn, "__name__", repr(fn)))
            output.verbose(1, "overlap",
                           f"post-sync hook {name} raised "
                           f"{type(err).__name__}: {err}")


# -- bucket planning ----------------------------------------------------------

@dataclass(frozen=True)
class Bucket:
    indices: Tuple[int, ...]     # leaf indices into the FLATTEN order
    nbytes: int


@dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    total_bytes: int
    bucket_bytes: int            # the target size buckets close at
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def max_buckets(self) -> int:
        """The storm-collapse guarantee: ceil(total / bucket_bytes)."""
        return max(1, math.ceil(self.total_bytes / self.bucket_bytes))


def _nbytes(x) -> int:
    size = int(np.prod(x.shape)) if len(x.shape) else 1
    if isinstance(x.dtype, torch.dtype):
        return size * x.dtype.itemsize
    return size * np.dtype(x.dtype).itemsize


def bucket_plan(leaves: Sequence, bucket_bytes: int) -> BucketPlan:
    """Group leaves (anything with .shape/.dtype, flatten order) into
    fixed-byte buckets walking the list in REVERSE — the approximate order
    the backward finishes their gradients (last layer first).  A bucket
    closes only AFTER its bytes reach the target, so every closed bucket
    carries >= bucket_bytes and the count is <= ceil(total / target)."""
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    sizes = [_nbytes(x) for x in leaves]
    buckets: List[Bucket] = []
    group: List[int] = []
    acc = 0
    for i in reversed(range(len(sizes))):
        group.append(i)
        acc += sizes[i]
        if acc >= bucket_bytes:
            buckets.append(Bucket(tuple(group), acc))
            group, acc = [], 0
    if group:
        buckets.append(Bucket(tuple(group), acc))
    return BucketPlan(tuple(buckets), sum(sizes), bucket_bytes, len(sizes))


def resolve_bucket_bytes(bucket_bytes: Optional[int] = None) -> int:
    """Config override, else the coll_nccl_grad_bucket_bytes var (4 MiB)."""
    nb = int(bucket_bytes if bucket_bytes is not None
             else _var.get("coll_nccl_grad_bucket_bytes", 4 << 20))
    if nb < 1:
        raise ValueError(f"grad_bucket_bytes must be >= 1, got {nb}")
    return nb


# -- decision -----------------------------------------------------------------

def _decide_buckets(plan: BucketPlan, ndev: int, platform: str,
                    plane: Optional[str] = None, hier_ok: bool = False,
                    hier_why: str = "") -> Tuple[str, ...]:
    """One decision-layer pass per bucket (coll name ``grad_sync``, arms
    native|quant|hier|hier+quant — the hier arms only when the sync spans
    a two-tier dpo×dp split) and the bucket pvars.  Runs once per built
    sync."""
    from ..coll import nccl

    rules = nccl._load_device_rules()
    arms = []
    for b in plan.buckets:
        arm, _reason, _chain = nccl.decide_mode(
            "grad_sync", b.nbytes, ndev, platform, rules,
            allowed=("native", "quant"), quant_ok=True, dtype=np.float32,
            plane=plane, hier_ok=hier_ok, hier_why=hier_why)
        arms.append(arm)
    _PVARS["grad_bucket_count"] = plan.n_buckets
    _PVARS["grad_bucket_bytes"] = plan.total_bytes
    return tuple(arms)


# -- the sync -----------------------------------------------------------------

def dp_sync_axes(mesh):
    """The sync domain: ``("dpo", "dp")`` when the mesh carries an outer
    data-parallel axis (the two-tier shape the hier arms address by
    level), else plain ``"dp"``."""
    return ("dpo", "dp") if "dpo" in mesh.mesh_dim_names else "dp"


def check_dp_mesh(mesh, what: str) -> int:
    """The dp-only contract shared with the quant grad sync: a sync over the
    data-parallel axes replicates every other axis, which would undo tp/sp
    parameter sharding — refuse instead.  An optional ``dpo`` outer axis
    is part of the sync domain, not a sharded dimension.  Returns the
    domain's size."""
    names = tuple(mesh.mesh_dim_names)
    if "dp" not in names:
        raise ValueError(
            f"{what} needs a 'dp' mesh axis to sync over "
            f"(mesh axes: {names})")
    n = axis_size(mesh, "dp")
    for a in names:
        if a == "dpo":
            n *= axis_size(mesh, a)
        elif a != "dp" and axis_size(mesh, a) > 1:
            raise ValueError(
                f"{what} is dp-only: the sync over dp would replicate axis "
                f"{a!r} (size {axis_size(mesh, a)}) and undo its parameter "
                "sharding; use grad_sync='native' on dp×tp/sp meshes")
    return n


def dp_batch(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of the whole batch, cut over the sync domain (the
    reference's data spec: row-major over dpo×dp where dpo exists)."""
    axes = dp_sync_axes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    n = int(np.prod([axis_size(mesh, a) for a in axes]))
    pos = axes_position(mesh, axes)
    if tokens.shape[0] % n:
        raise ValueError(f"batch of {tokens.shape[0]} does not divide over "
                         f"{'×'.join(axes)}={n}")
    b = tokens.shape[0] // n
    return tokens[pos * b:(pos + 1) * b]


def pmean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over the group's n members (a fresh tensor)."""
    if n == 1:
        return x.clone()
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out / n


class _Buckets:
    """One step's bucketed sync: the hooks fill the buckets, each full
    bucket is issued in plan order, ``finish`` waits and splits."""

    def __init__(self, plan: BucketPlan, arms, leaves, group, n: int,
                 quant_block: int, mesh=None, levels=None) -> None:
        self.plan, self.arms, self.leaves = plan, arms, leaves
        self.group, self.n, self.block = group, n, quant_block
        # (inner, outer, n_outer) of a two-tier domain, for the hier arms
        self.mesh, self.levels = mesh, levels
        self.ready: List[Optional[torch.Tensor]] = [None] * plan.n_buckets
        self.out: List[Optional[torch.Tensor]] = [None] * plan.n_buckets
        self.works = []
        self.next = 0
        # one hook a leaf (a leaf's hook sees its whole gradient, the tied
        # embedding's included); a bucket fires when its last leaf's does
        self.got: List[dict] = [{} for _ in plan.buckets]
        self.handles = [leaves[j].register_hook(self._hook(i, j))
                        for i, b in enumerate(plan.buckets)
                        for j in b.indices]

    def _hook(self, i: int, j: int):
        def seen(grad):
            got = self.got[i]
            got[j] = grad
            if len(got) == len(self.plan.buckets[i].indices):
                self.ready[i] = self._flat(
                    i, [got[k] for k in self.plan.buckets[i].indices])
                self.got[i] = {}
                self._issue_ready()
        return seen

    def _flat(self, i: int, grads) -> torch.Tensor:
        parts = [(g if g is not None else torch.zeros_like(self.leaves[j]))
                 .reshape(-1).float()
                 for j, g in zip(self.plan.buckets[i].indices, grads)]
        return parts[0].clone() if len(parts) == 1 else torch.cat(parts)

    def _issue_ready(self) -> None:
        while (self.next < self.plan.n_buckets
               and self.ready[self.next] is not None):
            i, self.next = self.next, self.next + 1
            flat, self.ready[i] = self.ready[i], None
            if self.arms[i] in ("hier", "hier+quant"):
                # the HAN shape over the two-tier domain, then the mean
                from .hierarchy import (hierarchical_psum,
                                        hierarchical_psum_quant)
                inner, outer, n_outer = self.levels
                if self.arms[i] == "hier+quant":
                    flat = hierarchical_psum_quant(
                        flat, inner, outer, n_outer, block=self.block,
                        mesh=self.mesh) / self.n
                else:
                    flat = hierarchical_psum(flat, inner, outer,
                                             mesh=self.mesh) / self.n
            elif self.arms[i] == "quant":
                from ..coll.quant import psum_quant
                flat = psum_quant(flat, self.group, self.n, avg=True,
                                  block=self.block)
            elif self.n > 1:
                self.works.append(dist.all_reduce(flat, group=self.group,
                                                  async_op=True))
            self.out[i] = flat

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def finish(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Issue what no hook issued (from the returned gradients), wait
        for every bucket, and split them back into per-leaf gradients."""
        for i, b in enumerate(self.plan.buckets):
            if self.out[i] is None and self.ready[i] is None:
                self.ready[i] = self._flat(i, [grads[j] for j in b.indices])
        self._issue_ready()
        for w in self.works:
            w.wait()
        synced: List[Optional[torch.Tensor]] = [None] * len(grads)
        for i, b in enumerate(self.plan.buckets):
            flat = self.out[i]
            if self.arms[i] == "native" and self.n > 1:
                flat = flat / self.n
            off = 0
            for j in b.indices:
                size = grads[j].numel()
                synced[j] = flat[off:off + size].reshape(
                    grads[j].shape).to(grads[j].dtype)
                off += size
        return synced


def make_grad_sync(mode: str, mesh, local_loss: Callable,
                   bucket_bytes: Optional[int] = None,
                   quant_block: int = 256) -> Callable:
    """Build ``(params, batch) -> (loss, grads)`` with the dp gradient sync
    carried by the requested scheduler; ``grads`` are in
    ``optim.tree_leaves(params)`` order:

      * ``perleaf``  — one native mean per leaf after the whole backward
        (the explicit collective storm; the baseline the bucketed arm is
        measured and pinned against);
      * ``bucketed`` — fixed-byte buckets in reverse flatten order, each
        synced by ONE allreduce as soon as its gradients exist; the arm
        per bucket (native|quant) comes from the decision layer;
      * ``unsynced`` — no gradient exchange at all (the loss is still
        averaged).  MEASUREMENT ONLY: its step time is the compute floor
        the overlap efficiency divides against; training with it diverges
        the replicas.

    ``local_loss(params, batch)`` evaluates this rank's loss on its dp
    rows of the batch with no mesh inside (the one exchange is the sync
    built here).  Every rank of the mesh calls the result with the whole
    batch."""
    if mode not in GRAD_SYNC_MODES:
        raise ValueError(f"unknown grad sync mode {mode!r} "
                         f"(expected one of {GRAD_SYNC_MODES})")
    n = check_dp_mesh(mesh, f"grad_sync={mode!r}")
    sync_axes = dp_sync_axes(mesh)
    group = axes_group(mesh, (sync_axes,) if isinstance(sync_axes, str)
                       else sync_axes)
    nb = resolve_bucket_bytes(bucket_bytes)
    plane, hier_ok, hier_why, levels = None, False, \
        "single-axis comm (no inner/outer levels)", None
    if isinstance(sync_axes, tuple):
        # the two-tier context feeds the hier arms and '@<plane>' rows
        from .hierarchy import hier_axes
        kinds = classify_axes(mesh, sync_axes)
        plane = "dcn" if "dcn" in kinds.values() else "ici"
        inner, outer, why = hier_axes(mesh, sync_axes, kinds=kinds)
        hier_ok, hier_why = inner is not None, why or ""
        if hier_ok:
            levels = (inner, outer, axis_size(mesh, outer))

    def vg(params, batch):
        leaves = tree_leaves(params)
        local = dp_batch(torch.as_tensor(batch), mesh)
        buckets = None
        if mode == "bucketed":
            plan = bucket_plan(leaves, nb)
            arms = _decide_buckets(plan, n, mesh.device_type, plane,
                                   hier_ok, hier_why)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if mode == "bucketed":
                buckets = _Buckets(plan, arms, leaves, group, n, quant_block,
                                   mesh, levels)
            with torch.enable_grad():
                loss = local_loss(params, local)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            if buckets is not None:
                buckets.remove()
            for p in leaves:
                p.requires_grad_(False)
        if buckets is not None:
            grads = buckets.finish(grads)
        elif mode == "perleaf":
            grads = [pmean(g, group, n) for g in grads]
        loss = pmean(loss.detach(), group, n)
        _run_post_sync(grads)
        return loss, tuple(grads)

    return vg


# -- collective-matmul ring arbitration ---------------------------------------

def decide_collmm(kind: str, nbytes: int, mesh, axis: str,
                  eligible_bidir: bool) -> str:
    """Ring-direction pick for one collective-matmul call site via the
    shared decision layer (coll name ``collmm``; arms native = one ring |
    bidir = two half-rings, one each way).  Shapes whose per-rank row
    count is odd drop the bidir arm: the decision never names a schedule
    the op cannot run."""
    from ..coll import nccl

    allowed = ("native", "bidir") if eligible_bidir else ("native",)
    arm, _reason, _chain = nccl.decide_mode(
        "collmm", int(nbytes), axis_size(mesh, axis), mesh.device_type,
        nccl._load_device_rules(), allowed, quant_ok=False)
    return arm


__all__ = ["GRAD_SYNC_MODES", "Bucket", "BucketPlan", "bucket_plan",
           "resolve_bucket_bytes", "dp_sync_axes", "check_dp_mesh",
           "make_grad_sync", "decide_collmm", "add_post_sync_hook",
           "remove_post_sync_hook", "pvar_value"]
