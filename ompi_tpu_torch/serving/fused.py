"""Fused decode program — the whole decode backbone and logits as ONE
function on this rank's tensors (``Config(decode_overlap="fused")``).

Counterpart of ``ompi_tpu/serving/fused.py``.  The eager decode path
dispatches 27 audited collectives a token step at the flagship's six
layers (1 embed AG + 4 AGs a layer + the logits RS→AG pair) between its
pieces.  Here the residual stream is BATCH-sharded over tp (Megatron
sequence parallelism with sequence ↦ batch: each rank owns B/tp batch
rows), so every tp combine becomes an n−1-hop collective-matmul ring
(``ops/collective_matmul``, one ``batch_isend_irecv`` a hop on the comm's
tp group):

* qkv / gate|up / logits — ``ring_allgather_matmul_local``: the (B/tp, d)
  residual shard rotates around the ring while this rank's column block
  of the weight multiplies the visiting rows (weights never move).
* wo / down — ``ring_matmul_reduce_scatter_local``: float32 partial sums
  ride the ring and the output lands batch-scattered, so the residual add
  is local.

A decode step leaves 4 rings a layer + 1 logits ring (gate and up share
one ring through a column-concat weight), each carrying a (B/tp, d)
payload for n−1 hops, and exactly TWO eager dispatches: the embed
``decode_ag`` (the d/tp feature combine that builds the replicated
residual) and the logits ``decode_ag`` (the vocab-block combine).  The
engine decides and audits one ``decode_collmm`` event a ring
(``ring_schedule``).  The JAX package jits the body into one
``shard_map``; here it is eager PyTorch on this rank's tensors, and the
page write and attention are the eager path's own (``_page_write``, and
``decode_attention`` over the paged gather in ``_paged_attn``), as there.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..models.transformer import _rms_norm, rope_rows
from ..ops.collective_matmul import (ring_allgather_matmul_local,
                                     ring_matmul_reduce_scatter_local)
from .engine import _page_write, _paged_attn

# per-layer ring sites in program order; the logits ring closes the step
LAYER_SITES = ("qkv_ag", "wo_rs", "gateup_ag", "down_rs")
LOGITS_SITE = "logits_ag"


def ring_schedule(n_layers: int, B: int, d_model: int, n: int,
                  itemsize: int) -> List[Tuple[str, int, int]]:
    """The fused program's static ring schedule: one ``(site,
    payload_bytes, wire_bytes)`` row per ring, in dispatch order.  Every
    ring rotates a (B/n, d_model) block for n−1 hops — the AG rings carry
    the residual shard in the compute dtype, the RS rings carry float32
    partial sums — so wire = (n−1)·payload per rank.  The engine decides
    and audits one ``decode_collmm`` event per row."""
    rows: List[Tuple[str, int, int]] = []
    bl = B // n
    for i in range(n_layers):
        for site in LAYER_SITES:
            size = itemsize if site.endswith("_ag") else 4  # RS rides f32
            payload = bl * d_model * size
            rows.append((f"L{i}/{site}", payload, (n - 1) * payload))
    payload = bl * d_model * itemsize
    rows.append((LOGITS_SITE, payload, (n - 1) * payload))
    return rows


def build_fused_decode(dc, n_layers: int, head_dim: int,
                       rope_base: float) -> Callable:
    """The fused decode program over ``dc``'s tp group.

    Returned callable::

        fn(x, bt, pos, page_idx, offset, layers, final_norm, embed_lg,
           k_pools, v_pools) -> logits

    * ``x`` (1, B, d) — this rank's row of the replicated residual (the
      eager embed AG's regrouped output); rank ``dc.pos`` works on batch
      rows [pos·B/n, (pos+1)·B/n).
    * ``bt`` (B, pmax) block tables; ``pos``/``page_idx``/``offset`` (B,)
      index tensors on the comm's device (pos −1 = inactive).
    * ``layers`` — per-layer dicts: ``attn_norm``/``mlp_norm`` (d,);
      ``wqkv`` (1, d, 3h/n) and ``wgu`` (1, d, 2f/n) column shards;
      ``wo`` (1, h/n, d) and ``wd`` (1, f/n, d) ROW shards (the RS ring
      contracts over the local rows).
    * ``embed_lg`` (1, d, V/n) — the tied embedding's vocab block,
      transposed.
    * ``k_pools``/``v_pools`` — the paged pools, (1, n_pages, page, h/n,
      hd) a layer, written in place.

    Returns this rank's (1, B, V/n) float32 logits block: one eager
    ``decode_ag`` and a regroup away from the full logits."""
    group, n, my = dc.group, dc.n, dc.pos

    @torch.no_grad()
    def fn(x: torch.Tensor, bt: torch.Tensor, pos: torch.Tensor,
           page_idx: torch.Tensor, offset: torch.Tensor,
           layers: Sequence[Dict[str, torch.Tensor]],
           final_norm: torch.Tensor, embed_lg: torch.Tensor,
           k_pools: Sequence[torch.Tensor],
           v_pools: Sequence[torch.Tensor]) -> torch.Tensor:
        B = x.shape[1]
        bl = B // n
        xs = x[0, my * bl:(my + 1) * bl]
        for lw, kp, vp in zip(layers, k_pools, v_pools):
            h = _rms_norm(xs, lw["attn_norm"])
            q, k, v = ring_allgather_matmul_local(
                h, lw["wqkv"][0], group).chunk(3, dim=-1)
            shape = (1, B, q.shape[-1] // head_dim, head_dim)
            q = rope_rows(q.reshape(shape), pos, rope_base)
            _page_write(kp, vp, rope_rows(k.reshape(shape), pos, rope_base),
                        v.reshape(shape), page_idx, offset)
            att = _paged_attn(q, kp, vp, bt, pos)[0]
            o = ring_matmul_reduce_scatter_local(att, lw["wo"][0], group)
            xs = xs + o.to(xs.dtype)
            h2 = _rms_norm(xs, lw["mlp_norm"])
            g, u = ring_allgather_matmul_local(
                h2, lw["wgu"][0], group).chunk(2, dim=-1)
            z = torch.nn.functional.silu(g) * u
            dn = ring_matmul_reduce_scatter_local(z, lw["wd"][0], group)
            xs = xs + dn.to(xs.dtype)
        hf = _rms_norm(xs, final_norm)
        lg = ring_allgather_matmul_local(hf, embed_lg[0], group)
        return lg[None].float()

    return fn


__all__ = ["LAYER_SITES", "LOGITS_SITE", "ring_schedule",
           "build_fused_decode"]
