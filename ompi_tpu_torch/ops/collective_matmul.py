"""Collective matmuls: the ring copy of one block overlaps the product of
another.

The port's copy of ``ompi_tpu/ops/collective_matmul.py``.  In place of
``allgather then matmul`` (the wire idle during the product, the tensor
cores idle during the gather), the shards rotate around the axis's ring and
each visiting shard's product is computed while the next hop is in flight.
The JAX package writes the rings with ``lax.ppermute`` inside
``shard_map`` and leaves the overlap to XLA; here each hop is an
``isend``/``irecv`` pair issued (``batch_isend_irecv``) BEFORE the current
block's product and waited after it, so NCCL moves the next block while
the card multiplies this one.  The products stay ``torch.matmul``: the
reference computes them with ``jnp.dot`` outside any Pallas kernel.

Two schedules, each on this process's shard over a process group (an axis
of a mesh):

  * ``allgather_matmul``      — Y = all_gather(X, axis) @ W, X cut by rows
    (the column-parallel products under Megatron sequence parallelism);
  * ``matmul_reduce_scatter`` — Y = reduce_scatter(X @ W, axis), X and W
    cut on the contraction; the ring carries f32 partial sums and each
    hop's block is computed just in time (the row-parallel products).

Both take an optional leading batch dimension ((b, m, k) activations) and
a ``bidirectional`` schedule: each rank's rows split in halves that ride
the ring in opposite directions, so each link carries half the bytes.  The
decision layer picks the direction per call site under the coll name
``collmm`` (``parallel/overlap.decide_collmm``).

Both are differentiable (``torch.autograd.Function``), and each backward
is the other ring: the gradient of ``allgather_matmul``'s input is a
``matmul_reduce_scatter`` of the output's gradient, and the gradient of
``matmul_reduce_scatter``'s input an ``allgather_matmul``, whose gathered
blocks also give the weight's gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import _check_backend, _group_of


def _hop(group, sends, recvs) -> list:
    """Start one ring step: ``sends``/``recvs`` are (tensor, group rank,
    tag); returns the works to wait on."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer),
                      group, tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer),
                       group, tag) for t, peer, tag in recvs]
    return dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


def _mm(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    return torch.matmul(x, w).to(dtype)


def _ag_ring(x: torch.Tensor, w: torch.Tensor, group, reverse: bool,
             bidir: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., m_local, k) this rank's rows, w (k, c) → (all_gather(x) @ w
    (..., m_local·n, c), all_gather(x)).  Exactly n − 1 hops: the own
    block's product is peeled before the first."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    m_local = x.shape[-2]
    odt = torch.promote_types(x.dtype, w.dtype)
    lead = tuple(x.shape[:-2])
    out = torch.empty(lead + (m_local * n, w.shape[1]), dtype=odt,
                      device=x.device)
    full = torch.empty(lead + (m_local * n, x.shape[-1]), dtype=x.dtype,
                       device=x.device)

    def place(block, row0):
        rows = block.shape[-2]
        full.narrow(-2, row0, rows).copy_(block)
        out.narrow(-2, row0, rows).copy_(_mm(block, w, odt))

    if bidir:
        mh = m_local // 2
        # the +1 half visiting at step i left rank my − i, the −1 half
        # left rank my + i
        cur = [x.narrow(-2, 0, mh).contiguous(),
               x.narrow(-2, mh, m_local - mh).contiguous()]
        for i in range(n):
            if i < n - 1:
                nxt = [torch.empty_like(c) for c in cur]
                works = _hop(group,
                             [(cur[0], (my + 1) % n, 0),
                              (cur[1], (my - 1) % n, 1)],
                             [(nxt[0], (my - 1) % n, 0),
                              (nxt[1], (my + 1) % n, 1)])
            place(cur[0], ((my - i) % n) * m_local)
            place(cur[1], ((my + i) % n) * m_local + mh)
            if i < n - 1:
                _wait(works)
                cur = nxt
        return out, full
    shift = -1 if reverse else 1
    cur = x.contiguous()
    for i in range(n):
        if i < n - 1:
            nxt = torch.empty_like(cur)
            works = _hop(group, [(cur, (my + shift) % n, 0)],
                         [(nxt, (my - shift) % n, 0)])
        # after i hops the visiting shard started at rank my − i·shift
        place(cur, ((my - i * shift) % n) * m_local)
        if i < n - 1:
            _wait(works)
            cur = nxt
    return out, full


def _rs_ring(x: torch.Tensor, w: torch.Tensor, group,
             bidir: bool) -> torch.Tensor:
    """x (..., m, k_local) the full rows with this rank's contraction
    slice, w (k_local, c) → (..., m/n, c): the reduced block this rank
    owns.  n − 1 hops of f32 partial sums.

    The chunk for rank d starts at rank d + 1 and rides the ring n − 1
    hops, each rank adding its own partial block: after t hops rank r
    holds the chunk for d = r − 1 − t, after n − 1 hops its own.  In the
    bidirectional form the bottom half of each chunk rides the other way
    (it starts at d − 1; after t hops rank r holds d = r + 1 + t)."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[-2]
    mb = m // n
    odt = torch.promote_types(x.dtype, w.dtype)

    def block(idx, off, rows):
        return _mm(x.narrow(-2, idx * mb + off, rows), w, torch.float32)

    if bidir:
        mbh = mb // 2
        af = block((my - 1) % n, 0, mbh)
        ab = block((my + 1) % n, mbh, mb - mbh)
        for t in range(1, n):
            rf, rb = torch.empty_like(af), torch.empty_like(ab)
            works = _hop(group, [(af, (my + 1) % n, 0),
                                 (ab, (my - 1) % n, 1)],
                         [(rf, (my - 1) % n, 0), (rb, (my + 1) % n, 1)])
            pf = block((my - 1 - t) % n, 0, mbh)
            pb = block((my + 1 + t) % n, mbh, mb - mbh)
            _wait(works)
            af, ab = rf + pf, rb + pb
        return torch.cat([af, ab], dim=-2).to(odt)
    acc = block((my - 1) % n, 0, mb)
    for t in range(1, n):
        got = torch.empty_like(acc)
        works = _hop(group, [(acc, (my + 1) % n, 0)],
                     [(got, (my - 1) % n, 0)])
        part = block((my - 1 - t) % n, 0, mb)
        _wait(works)
        acc = got + part
    return acc.to(odt)


def _weight_grad(x: torch.Tensor, g: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """Σ over the leading dims of xᵀ·g: the weight's gradient."""
    return torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                        g.reshape(-1, g.shape[-1])).to(like.dtype)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, reverse, bidir):
        out, full = _ag_ring(x, w, group, reverse, bidir)
        ctx.save_for_backward(full, w)
        ctx.group, ctx.bidir, ctx.x_dtype = group, bidir, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        full, w = ctx.saved_tensors
        dx = _rs_ring(g, w.t(), ctx.group, ctx.bidir).to(ctx.x_dtype)
        return dx, _weight_grad(full, g, w), None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, bidir):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.bidir = group, bidir
        return _rs_ring(x, w, group, bidir)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, g_full = _ag_ring(g, w.t(), ctx.group, False, ctx.bidir)
        return dx.to(x.dtype), _weight_grad(x, g_full, w), None, None


def ring_allgather_matmul_local(x: torch.Tensor, w: torch.Tensor, group,
                                reverse: bool = False) -> torch.Tensor:
    """The allgather-matmul ring on this rank's rows x (..., m_local, k)
    and its weight w (k, c) over ``group``: (..., m_local·n, c), every
    rank's block filled; ``reverse`` turns the ring the other way."""
    return _AllGatherMatmul.apply(x, w, group, reverse, False)


def ring_allgather_matmul_bidir_local(x: torch.Tensor, w: torch.Tensor,
                                      group) -> torch.Tensor:
    """The bidirectional allgather-matmul ring: the rows' two halves rotate
    in opposite directions, n − 1 hops each."""
    return _AllGatherMatmul.apply(x, w, group, False, True)


def ring_matmul_reduce_scatter_local(x: torch.Tensor, w: torch.Tensor,
                                     group) -> torch.Tensor:
    """The matmul-reduce-scatter ring on x (..., m, k_local) and w
    (k_local, c) over ``group``: (..., m/n, c), the block this rank owns."""
    return _MatmulReduceScatter.apply(x, w, group, False)


def ring_matmul_reduce_scatter_bidir_local(x: torch.Tensor, w: torch.Tensor,
                                           group) -> torch.Tensor:
    """The bidirectional matmul-reduce-scatter ring: each chunk's halves
    ride the ring in opposite directions."""
    return _MatmulReduceScatter.apply(x, w, group, True)


def _setup(x: torch.Tensor, axis, mesh, name: str):
    if x.dim() not in (2, 3):
        raise ValueError(f"{name} wants 2-D or 3-D x, got shape "
                         f"{tuple(x.shape)}")
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    return group, dist.get_world_size(group)


def _check_bidir(m: int, n: int) -> None:
    if (m // n) % 2:
        raise ValueError(
            f"bidirectional ring needs an even per-rank row count, got "
            f"m={m} over {n} ranks (m_local={m // n})")


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis, mesh=None,
                     reverse: bool = False,
                     bidirectional: bool = False) -> torch.Tensor:
    """Y = all_gather(X over ``axis``) @ W without a standalone all-gather.

    x: this rank's rows, (m/n, k) or batched (b, m/n, k); w: this rank's
    (k, c) (its column shard in the column-parallel case).  Returns
    (..., m, c) with m gathered.  ``axis`` is a process group, or an axis
    name of ``mesh``.  ``bidirectional`` splits each rank's rows across
    the two ring directions; it needs an even per-rank row count and
    ignores ``reverse``."""
    group, n = _setup(x, axis, mesh, "allgather_matmul")
    if bidirectional:
        _check_bidir(x.shape[-2] * n, n)
        return ring_allgather_matmul_bidir_local(x, w, group)
    return ring_allgather_matmul_local(x, w, group, reverse)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axis,
                          mesh=None,
                          bidirectional: bool = False) -> torch.Tensor:
    """Y = reduce_scatter(X @ W over ``axis``), the contraction cut.

    x: (m, k/n) or batched (b, m, k/n), this rank's contraction slice of
    every row; w: its (k/n, c) rows.  Returns (..., m/n, c): the fully
    reduced block of rows this rank owns.  ``bidirectional`` halves each
    chunk across the two ring directions; it needs m/n even."""
    group, n = _setup(x, axis, mesh, "matmul_reduce_scatter")
    m = x.shape[-2]
    if m % n:
        raise ValueError(f"m={m} not divisible by ring size {n}")
    if bidirectional:
        _check_bidir(m, n)
        return ring_matmul_reduce_scatter_bidir_local(x, w, group)
    return ring_matmul_reduce_scatter_local(x, w, group)


__all__ = ["allgather_matmul", "matmul_reduce_scatter",
           "ring_allgather_matmul_local", "ring_allgather_matmul_bidir_local",
           "ring_matmul_reduce_scatter_local",
           "ring_matmul_reduce_scatter_bidir_local"]
