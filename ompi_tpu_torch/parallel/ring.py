"""Attention pieces of the JAX package's ``parallel/ring.py``.

So far only what a single device needs: ``attention_reference``, the dense
attention that ``Config(attn="dense")`` takes, and ``_merge``, the
online-softmax combine of two partials that ring attention applies after
every hop.  ``ring_attention`` itself (the K/V ring over
``batch_isend_irecv``) comes with ROADMAP slice P5.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import NEG_INF


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two online-softmax partials (the flash-attention combine).
    o: (..., s, d), m and l: (..., s)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return o, m, l


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
