"""Ring attention: context parallelism over a mesh axis.

Counterpart of ``ompi_tpu/parallel/ring.py``.  The reference runs a
``lax.fori_loop`` of (block attention, ``lax.ppermute``) steps inside
``shard_map``; here each process holds its own (batch, seq, heads,
head_dim) shard and the loop runs in Python: hop i attends the local Q
shard against the K/V shard of member ``src = (my - i) % n``, merges the
partials by online softmax, and passes K/V one member along the ring
(``ring_hop``, point-to-point over the axis's process group).  The
reference rotates K/V after the last block too; that result is never read,
so the port stops after n - 1 hops.

The block compute is plain PyTorch by default (``block_impl="jnp"``, the
reference's jnp block, which XLA fused): it is differentiable, autograd
running the hops backward in reverse and sending each dK/dV home.
``block_impl="pallas"`` runs kernel K1 (``flash_attention_partials``) on
each hop with the hop's global offsets, forward only, as in the reference.

Also here: ``attention_reference``, the dense attention that
``Config(attn="dense")`` takes, and ``_merge``, the online-softmax
combine.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import NEG_INF, flash_attention_partials
from .collectives import ring_hop
from .mesh import axis_rank, axis_size

_BLOCK_IMPLS = ("jnp", "pallas")


def _block_attn(q, k, v, scale, mask):
    """One (q-block × kv-block) attention piece → (numerator, max, denom),
    batched over the leading dim, in q's dtype as the reference's.

    q: (bh, sq, d), k/v: (bh, sk, d), mask: (sq, sk) additive or None.
    Returns o: (bh, sq, d) un-normalised, m and l: (bh, sq)."""
    s = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return p @ v, m, p.sum(dim=-1)


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two online-softmax partials (the flash-attention combine).
    o: (..., s, d), m and l: (..., s)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return o, m, l


def ring_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, my: int,
               src: int, causal: bool = False, scale: Optional[float] = None,
               block_impl: str = "jnp"):
    """One hop of the ring: member ``my``'s folded Q shard (bh, s, d)
    against member ``src``'s K/V shard, the shards' global positions
    ``my·s`` and ``src·s`` driving the causal mask.  Returns the
    un-normalised (o, m, l) in q's dtype.  ``block_impl="pallas"`` is K1
    with those offsets (its plain version on a CPU tensor), its f32 o, m
    and l rounded to q's dtype as the reference rounds them."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.shape[1]
    if block_impl == "pallas":
        o, m, l = flash_attention_partials(q, k, v, causal=causal,
                                           scale=scale, q_offset=my * s,
                                           kv_offset=src * s)
        return o.to(q.dtype), m.to(q.dtype), l.to(q.dtype)
    mask = None
    if causal:
        q_pos = my * s + torch.arange(s, device=q.device)
        kv_pos = src * k.shape[1] + torch.arange(k.shape[1], device=q.device)
        mask = torch.where(q_pos[:, None] >= kv_pos[None, :], 0.0,
                           NEG_INF).to(q.dtype)
    return _block_attn(q, k, v, scale, mask)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None,
                   block_impl: str = "jnp") -> torch.Tensor:
    """Attention over a sequence sharded on ``axis`` of ``mesh``.

    Every member of the axis calls it with its own (b, s, h, d) shard of
    q, k and v (s = seq/n, consecutive blocks in member order) and gets
    its shard of the output.  ``batch_axis`` and ``head_axis`` name the
    axes the local batch and heads are sharded on, as in the reference;
    the ring never talks over them, so they are only checked.
    ``block_impl="pallas"`` is forward only: with autograd recording on
    an input that needs a gradient it raises, as the reference has no VJP
    for it."""
    if block_impl not in _BLOCK_IMPLS:
        raise ValueError(f"block_impl {block_impl!r} (expected one of "
                         f"{_BLOCK_IMPLS})")
    for name in (axis, batch_axis, head_axis):
        if name is not None and name not in mesh.mesh_dim_names:
            raise ValueError(f"axis {name!r} is not one of the mesh's "
                             f"{mesh.mesh_dim_names}")
    if block_impl == "pallas" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError("ring_attention(block_impl='pallas') is forward "
                           "only (flash_attention_partials has no VJP); "
                           "train through block_impl='jnp'")
    n, my = axis_size(mesh, axis), axis_rank(mesh, axis)
    from .. import traffic
    if traffic.enabled and n > 1:
        # the reference's per-rank wire: all n ring steps rotate (its
        # schedule permutes after the last block too) its K/V shard of
        # the global arrays = the whole K+V bytes.  The port stops after
        # n - 1 hops but charges the reference's figure.
        whole = n * (k.nbytes + v.nbytes)
        for name in (batch_axis, head_axis):
            if name is not None:
                whole *= axis_size(mesh, name)
        traffic.note_ring(mesh, axis, whole, "ring_attention")
    b, s, h, d = q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(b * h, s, d) for t in (q, k, v))
    kv = torch.stack([kf, vf])              # one hop carries both
    o = torch.zeros_like(qf)
    m = torch.full(qf.shape[:2], NEG_INF, dtype=qf.dtype, device=qf.device)
    l = torch.zeros(qf.shape[:2], dtype=qf.dtype, device=qf.device)
    for i in range(n):
        src = (my - i) % n
        o, m, l = _merge(o, m, l, *ring_block(qf, kv[0], kv[1], my, src,
                                              causal, scale, block_impl))
        if i < n - 1:
            kv = ring_hop(kv, axis, mesh)
    out = o / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, h, s, d).transpose(1, 2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense single-device attention over (batch, seq, heads, head_dim)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.shape[1]
    qf = q.transpose(1, 2)      # (b, h, s, d)
    kf = k.transpose(1, 2)
    vf = v.transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vf)
    return out.transpose(1, 2)
