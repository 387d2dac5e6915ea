"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

Counterpart of ``ompi_tpu/parallel/ulysses.py``: the all-to-all
alternative to ring attention (SURVEY.md §5.7, "Ulysses = alltoall of
heads").  With the sequence sharded over the ``sp`` axis, one all-to-all
a tensor re-shards q, k and v from sequence-parallel to head-parallel,
attention runs over the FULL sequence for this member's subset of the
heads, and one more all-to-all shards the output back.  The reference
runs two tiled ``lax.all_to_all``s inside ``shard_map``; here each is one
``all_to_all_single`` over the axis's process group, inside a
``torch.autograd.Function`` whose backward is the inverse exchange.

``attn_fn`` is the attention on the full sequence: by default
``attention_reference``; the flagship's ``attn="flash"`` passes
``flash_mha``, so kernel K1 runs the forward and K2/K3 the backward on
every member at the full sequence length.

With the traffic plane on, each call charges its exchanges once
(``traffic.note_a2a``, coll ``ulysses``): four all-to-alls (q, k and v
to heads, the output back), each moving this member's shard, so the
per-rank wire is 2·q + k + v of this member's shards — the reference's
(2·Q + K + V)/n over the whole arrays.  The reference charges only
outside a trace; the port has none, so every call charges, the train
step's included (ROADMAP, Departures: eager charging).  A call on a bare
process group (``mesh`` None) has no grid to place edges on and charges
nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import traffic
from .collectives import _check_backend, _group_of, _wire
from .ring import attention_reference


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(b, s/n, h, d) → (b, s, h/n, d): head block j goes to member j;
    member i's sequence shard lands at rows [i·s/n, (i+1)·s/n)."""
    b, s, h, d = x.shape
    send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)                    # (n, b, s/n, h/n, d)
    # comm-lint: disable=CL001 the tiled alltoall IS the ulysses algorithm (head/seq transpose); wire bytes attributed eagerly via traffic.note_a2a in ulysses_attention
    dist.all_to_all_single(_wire(recv), _wire(send), group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(b, s, h/n, d) → (b, s/n, h, d): sequence block j goes to member j;
    member i's head block lands at heads [i·h/n, (i+1)·h/n)."""
    b, s, h, d = x.shape
    send = x.reshape(b, n, s // n, h, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)                    # (n, b, s/n, h/n, d)
    # comm-lint: disable=CL001 inverse transpose of the waived seq_to_heads exchange
    dist.all_to_all_single(_wire(recv), _wire(send), group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _seq_to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group, ctx.n), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _heads_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group, ctx.n), None, None


def seq_to_heads(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The forward exchange on its own (differentiable): this member's
    (b, s/n, h, d) sequence shard → its (b, s, h/n, d) head shard."""
    group = _group_of(axis, mesh)
    n = dist.get_world_size(group)
    return x if n == 1 else _SeqToHeads.apply(x, group, n)


def heads_to_seq(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The inverse exchange (differentiable): (b, s, h/n, d) →
    (b, s/n, h, d)."""
    group = _group_of(axis, mesh)
    n = dist.get_world_size(group)
    return x if n == 1 else _HeadsToSeq.apply(x, group, n)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sp", causal: bool = False,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Every member of ``axis`` calls it with its own (batch, seq/n, heads,
    head_dim) sequence shard of q, k and v (consecutive blocks in member
    order) and gets its shard of the output; heads must be divisible by
    the axis size.  ``attn_fn(q, k, v)`` attends the full sequence of this
    member's heads (default: ``attention_reference`` with ``causal`` and
    ``scale``)."""
    group = _group_of(axis, mesh)
    _check_backend(q.device.type, dist.get_backend(group))
    n = dist.get_world_size(group)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by axis size {n}")
    if traffic.enabled and n > 1 and mesh is not None:
        traffic.note_a2a(mesh, axis,
                         2 * _nbytes(q) + _nbytes(k) + _nbytes(v),
                         "ulysses")
    attn = attn_fn or (lambda qq, kk, vv: attention_reference(
        qq, kk, vv, causal=causal, scale=scale))
    qh, kh, vh = (seq_to_heads(t, group) for t in (q, k, v))
    return heads_to_seq(attn(qh, kh, vh), group)


__all__ = ["ulysses_attention", "seq_to_heads", "heads_to_seq"]
