"""Continuous-batching serving engine — prefill/decode over the decode
weight layout, decode collectives audited as ``decode_ag``/``decode_rs``.

Counterpart of ``ompi_tpu/serving/engine.py``'s eager path.  The per-layer
compute is a handful of collective-free pieces (the reference's jitted
pieces, here plain functions on tensors), and the only cross-rank traffic
is the decided and audited decode collectives between them, one decision
per dispatch.

Layout.  One process per tp position (``DeviceComm.n`` processes): every
weight is this rank's decode shard under a leading row
(``DeviceComm.canonicalize``, zero wire), and every activation is this
rank's ``(1, B, …)`` row of the reference's canonical ``(tp, B, …)``
array; ``_regroup`` applies to the ``(1, tp·B, c)`` that
``DeviceComm.allgather`` returns.  Dataflow per token step, consistent with
``models/transformer.decode_param_specs`` (all weights column-parallel,
output features sharded over tp; the residual stream rides
replicated-content rows):

* embed lookup → ``decode_ag`` (combine the d/tp feature shards)
* per layer: qkv (local) → rope → paged-cache write (in place) → paged
  attention (local: heads are tp-sharded) → ``decode_ag`` (head combine)
  → wo (local) → ``decode_ag`` → +residual; mlp gate/up (local) →
  ``decode_ag`` (d_ff combine) → w_down (local) → ``decode_ag`` →
  +residual
* logits: this rank's partial over its d/tp slice of the tied embedding
  → ``decode_rs`` + ``decode_ag`` (the sum over tp)

Every dispatch runs the decision chain (``coll/nccl.decide_mode``: force
vars ``coll_nccl_decode_ag_mode``/``coll_nccl_decode_rs_mode`` > blanket >
DEVICE_RULES rows > platform default; the hierarchical arms ineligible:
the decode collectives are single-stage) and leaves one audit record:
``dispatches``, ``wire_bytes`` (``coll/quant.wire_bytes``'s figure for the
arm) and, with an spc table on the comm, ``coll_arm_<arm>_count`` and
``coll_wire_bytes``.  The trace, perf and traffic halves of the audit come
with ROADMAP P16; the fused decode program (``decode_overlap="fused"``,
refused by ``Config``), ``decode_window`` and speculative decoding with
P11b; the MoE decode path with P12 (``Config`` refuses ``mlp="moe"``).

Prefill runs the prompt at its own length: the reference pads it to a
power-of-two bucket only to bound its JIT compiles, and the padded
positions never enter the causal window, so the values are the same.
Prefill attention is ``parallel/ring.attention_reference`` and decode
attention ``models/transformer.decode_attention``, as in the reference: no
kernel of the port runs here.  The engine follows the comm's device; on a
CUDA mesh without CUDA it raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import optim, serving
from ..device import check_on, resolve_device
from ..models.transformer import _rms_norm, decode_attention, rope_rows
from ..parallel.mesh import classify_axes
from ..parallel.ring import attention_reference
from .cache import PagedKVCache

# -- collective-free pieces, on this rank's (1, B, …) rows ------------------


def _regroup(y: torch.Tensor, n: int) -> torch.Tensor:
    """(1, n·B, c) allgather output → (1, B, n·c): per-token feature concat
    of the n ranks' column shards (a local reshape/transpose)."""
    _, nb, c = y.shape
    b = nb // n
    return y.reshape(1, n, b, c).transpose(1, 2).reshape(1, b, n * c)


def _embed(embed_can: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(1, V, d/tp), (B,) → (1, B, d/tp) local embedding slices."""
    return embed_can[:, tokens]


def _qkv(x, norm_w, wqkv, pos, head_dim: int, base: float):
    """Residual (1, B, d) → roped q, k, v (1, B, heads/tp, head_dim).  The
    qkv product is column-parallel: zero comm."""
    h = _rms_norm(x, norm_w)
    q, k, v = torch.matmul(h, wqkv).chunk(3, dim=-1)
    r, b, c = q.shape
    shape = (r, b, c // head_dim, head_dim)
    return (rope_rows(q.reshape(shape), pos, base),
            rope_rows(k.reshape(shape), pos, base), v.reshape(shape))


def _page_write(kp, vp, k_new, v_new, page_idx, offset) -> None:
    """Scatter one k/v row per batch slot into its page, in place (an
    ``index_put_`` on the pools), so cache data never visits the host."""
    kp[:, page_idx, offset] = k_new
    vp[:, page_idx, offset] = v_new


def _paged_attn(q, kp, vp, bt, q_pos):
    """Decode attention against the paged pools: gather each slot's pages
    by block table, flatten to key positions, run the shared
    ``decode_attention`` core.  Heads are tp-sharded → fully local."""
    k = kp[:, bt]                      # (1, B, pmax, page, hl, hd)
    v = vp[:, bt]
    r, b, pmax, pg, hl, hd = k.shape
    k = k.reshape(r, b, pmax * pg, hl, hd)
    v = v.reshape(r, b, pmax * pg, hl, hd)
    return decode_attention(q, k, v, q_pos).reshape(r, b, hl * hd)


def _prefill_attn(q, k, v):
    """Prompt-phase causal attention over the fresh q/k/v (the pages were
    just written; attending the in-register copies avoids the gather) —
    ``attention_reference`` with the row as batch."""
    r, s, hl, hd = q.shape
    return attention_reference(q, k, v, causal=True).reshape(r, s, hl * hd)


def _o_proj(ag_att, wo, n: int):
    return torch.matmul(_regroup(ag_att, n), wo)


def _mlp_in(ag_o, x, norm_w, wg, wu, n: int):
    x = x + _regroup(ag_o, n)
    h = _rms_norm(x, norm_w)
    g = torch.nn.functional.silu(torch.matmul(h, wg))
    return x, g * torch.matmul(h, wu)


def _mlp_down(ag_z, wd, n: int):
    return torch.matmul(_regroup(ag_z, n), wd)


def _residual(ag_d, x, n: int):
    return x + _regroup(ag_d, n)


def _logits_partial(x, norm_w, embed_can, n: int, pos: int):
    """This rank's partial logits: ITS d/tp slice of the hidden state
    against its embedding columns — the partial sums then reduce through
    decode_rs + decode_ag (the audited sum over tp)."""
    h = _rms_norm(x, norm_w)
    r, b, d = h.shape
    w = d // n
    part = torch.matmul(h[..., pos * w:(pos + 1) * w],
                        embed_can.transpose(1, 2))
    return part.reshape(r, b * part.shape[-1])


def _logits_argmax(ag, b: int):
    logits = ag.reshape(1, b, -1).float()
    return logits, logits.argmax(dim=-1)


# -- decision + audit -------------------------------------------------------

def _decide_serve_coll(dc, coll: str, nbytes: int, dtype, plane: str,
                       allowed: Tuple[str, ...] = ("native", "quant"),
                       ) -> Tuple[str, str, List[str]]:
    """Decision over ``coll/nccl.decide_mode`` for the decode coll names:
    per-entry/blanket force vars, DEVICE_RULES rows (plane-keyed
    included), the full precedence chain.  The decode collectives are
    single-stage (a flat tp ring), so the hier arms are ineligible by
    construction."""
    from ..coll.nccl import _load_device_rules, decide_mode
    from ..op import SUM, quantizable
    return decide_mode(coll, int(nbytes), dc.n, dc.device.type,
                       _load_device_rules(), allowed,
                       quant_ok=quantizable(SUM, dtype), dtype=dtype,
                       op=None, plane=plane, hier_ok=False,
                       hier_why="decode collectives are single-stage")


def _audit_serve_coll(dc, coll: str, arm: str, x: torch.Tensor) -> int:
    """ONE audit record per decode collective: the arm's wire bytes
    (``coll/quant.wire_bytes``'s figure for this rank's payload), counted
    as ``coll_arm_<arm>_count`` and ``coll_wire_bytes`` in the comm's spc."""
    from ..coll.quant import wire_bytes
    nbytes = x.numel() * x.element_size()
    qcoll = "allgather" if coll == "decode_ag" else "reduce_scatter"
    try:
        wb = wire_bytes(qcoll, max(x.numel(), 1), dc.n, x.dtype)
    except (ValueError, TypeError):
        wb = None
    wire = nbytes
    if wb is not None:
        wire = wb["quant_bytes"] if arm == "quant" else wb["native_bytes"]
    spc = dc.spc
    if spc is not None:
        spc.inc(f"coll_arm_{arm}_count")
        spc.inc("coll_wire_bytes", int(wire))
    return int(wire)


class ServingEngine:
    """Prefill + continuous decode over one tp DeviceComm.

    ``params`` are this rank's shards, in the TRAIN layout by default
    (``shard_params``), converted on the device through
    ``convert_params(to="decode")``, then lifted into rows with zero wire;
    ``layout="decode"`` takes decode shards as they are.  Every rank of the
    comm builds the engine and calls ``prefill``/``decode_step`` with the
    same arguments."""

    def __init__(self, dc, params: Dict, cfg, *, n_pages: int = 64,
                 page_size: int = 16, max_seqs: int = 8,
                 max_pages_per_seq: Optional[int] = None,
                 layout: str = "train") -> None:
        from ..models import transformer as tfm
        self.device = resolve_device(dc.device)
        for name in ("n_heads", "d_model", "vocab", "d_ff"):
            dim = getattr(cfg, name)
            if dim % dc.n:
                raise ValueError(
                    f"ServingEngine: cfg.{name}={dim} not divisible by "
                    f"the {dc.n}-way tp axis")
        if layout not in ("train", "decode"):
            raise ValueError(f"layout={layout!r} (want train|decode)")
        check_on(optim.tree_leaves(params), self.device, "params")
        if layout == "train":
            params = tfm.convert_params(params, dc.mesh, cfg, to="decode")
        self.dc = dc
        self.cfg = cfg
        self.max_seqs = int(max_seqs)
        # the plane that keys '<coll>@<plane>' rules rows, fixed here
        self._plane = classify_axes(dc.mesh, dc.axis)[dc.axis]

        def can(w):
            # weight-stationary: store in the compute dtype (the same cast
            # forward() pays per step), under a leading row
            return dc.canonicalize(w.to(cfg.dtype), 1)

        # wqkv's decode shard is already [q_t | k_t | v_t] (cut by heads)
        self._embed = can(params["embed"])             # (1, V, d/tp)
        self._final_norm = params["final_norm"]
        self._layers: List[Dict[str, Any]] = [
            {"attn_norm": lw["attn_norm"], "wqkv": can(lw["wqkv"]),
             "wo": can(lw["wo"]), "mlp_norm": lw["mlp_norm"],
             "w_gate": can(lw["w_gate"]), "w_up": can(lw["w_up"]),
             "w_down": can(lw["w_down"])}
            for lw in params["layers"]]
        self.cache = PagedKVCache(
            dc, cfg.n_layers, cfg.n_heads, cfg.head_dim,
            n_pages=n_pages, page_size=page_size, max_seqs=max_seqs,
            max_pages_per_seq=max_pages_per_seq, dtype=cfg.dtype)
        self.dispatches: Dict[str, int] = {"decode_ag": 0, "decode_rs": 0}
        self.wire_bytes = 0

    # -- audited collective dispatch ---------------------------------------

    def _dispatch(self, coll: str, x: torch.Tensor) -> torch.Tensor:
        arm, _reason, _chain = _decide_serve_coll(
            self.dc, coll, x.numel() * x.element_size(), x.dtype,
            self._plane)
        if coll == "decode_ag":
            out = (self.dc.quant.allgather(x) if arm == "quant"
                   else self.dc.allgather(x))
        else:
            out = (self.dc.quant.reduce_scatter(x) if arm == "quant"
                   else self.dc.reduce_scatter(x))
        self.wire_bytes += _audit_serve_coll(self.dc, coll, arm, x)
        self.dispatches[coll] += 1
        if serving.enabled:
            serving.note_dispatch("eager")
        return out

    def _ag(self, x):
        return self._dispatch("decode_ag", x)

    def _rs(self, x):
        return self._dispatch("decode_rs", x)

    # -- forward pieces ----------------------------------------------------

    def _backbone(self, x, pos_dev, page_idx, offset,
                  attend: Callable) -> torch.Tensor:
        cfg, n = self.cfg, self.dc.n
        for i, lw in enumerate(self._layers):
            q, k, v = _qkv(x, lw["attn_norm"], lw["wqkv"], pos_dev,
                           cfg.head_dim, float(cfg.rope_base))
            _page_write(self.cache.k[i], self.cache.v[i], k, v, page_idx,
                        offset)
            att = attend(i, q, k, v)
            o = _o_proj(self._ag(att), lw["wo"], n)
            x, z = _mlp_in(self._ag(o), x, lw["mlp_norm"], lw["w_gate"],
                           lw["w_up"], n)
            d = _mlp_down(self._ag(z), lw["w_down"], n)
            x = _residual(self._ag(d), x, n)
        return x

    def _logits(self, x, b: int):
        part = _logits_partial(x, self._final_norm, self._embed, self.dc.n,
                               self.dc.pos)
        return _logits_argmax(self._ag(self._rs(part)), b)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # -- serving entry points ----------------------------------------------

    def prefill(self, slot: int, prompt: np.ndarray):
        """Run one request's prompt through the decode-layout model: writes
        its KV pages, returns (first greedy token, last-position logits
        (1, 1, V), this rank's row)."""
        prompt = np.asarray(prompt, np.int64)
        s = int(prompt.shape[0])
        positions = np.arange(s)
        page_idx, offset = self.cache.write_indices(np.full(s, slot),
                                                    positions)
        x = _regroup(self._ag(_embed(self._embed, self._index(prompt))),
                     self.dc.n)
        x = self._backbone(x, self._index(positions),
                           self._index(page_idx), self._index(offset),
                           lambda i, q, k, v: _prefill_attn(q, k, v))
        logits, nxt = self._logits(x[:, s - 1:s], 1)
        self.cache.seq_lens[slot] = s
        return int(nxt[0, 0]), logits

    def decode_step(self, tokens: np.ndarray, positions: np.ndarray):
        """One continuous-batching decode step over the FULL batch:
        ``tokens``/``positions`` are (max_seqs,) with position −1 marking
        an inactive slot (its lane computes masked garbage on the scratch
        page — the batch shape never changes).  Returns (next greedy token
        per slot (max_seqs,), logits (1, max_seqs, V), this rank's row)."""
        b = self.max_seqs
        tokens = np.asarray(tokens, np.int64)
        positions = np.asarray(positions, np.int64)
        page_idx, offset = self.cache.write_indices(np.arange(b),
                                                    positions)
        bt = self._index(self.cache.block_tables)
        pos_dev = self._index(positions)
        x = _regroup(self._ag(_embed(
            self._embed, self._index(np.where(positions >= 0, tokens, 0)))),
            self.dc.n)
        x = self._backbone(
            x, pos_dev, self._index(page_idx), self._index(offset),
            lambda i, q, k, v: _paged_attn(q, self.cache.k[i],
                                           self.cache.v[i], bt, pos_dev))
        logits, nxt = self._logits(x, b)
        return nxt[0].cpu().numpy(), logits
