"""Continuous-batching serving engine — prefill/decode over the decode
weight layout, decode collectives audited as ``decode_ag``/``decode_rs``.

Counterpart of ``ompi_tpu/serving/engine.py``.  On the eager path the
per-layer compute is a handful of collective-free pieces (the reference's
jitted pieces, here plain functions on tensors), and the only cross-rank
traffic is the decided and audited decode collectives between them, one
decision per dispatch.

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
``coll_wire_bytes``.

``decode_overlap="fused"`` (dense MLP, tp ≥ 2, max_seqs divisible by tp)
runs each decode step as the fused program of ``serving/fused``: one eager
embed ``decode_ag``, every tp combine a collective-matmul ring inside the
program (4 a layer + the logits ring, each decided and audited as
``decode_collmm``), then the eager logits ``decode_ag``: 2 eager
dispatches a step.  Its row-parallel weights (``wo``, ``w_down``, the tied
embedding) are laid out once at construction by ``parallel/reshard``.
``decode_window`` runs a k-token teacher-forced verify window on either
path (speculative decoding, ``serving/scheduler``'s ``spec_k``).

``mlp="moe"`` (the eager path only) replaces each layer's gate/up/down
with the ragged expert-parallel block (``models/moe.moe_block_ep``) over
the engine's comm: each rank hands its B/tp rows of the normed residual to
the block, the routed tokens travel the audited ``moe_dispatch`` /
``moe_combine`` exchanges, and the ranks' mixtures are all-gathered back
into the replicated (B, d) residual (an unaudited gather, where the
reference reads the mixture back to the host).  Each rank holds its
n_experts/tp experts whole, resharded once at construction from the
(E, d, f/tp) train shards.  A prompt whose length tp does not divide is
padded, as the reference pads it, with positions that write the scratch
page and never enter the causal window.

Each audit record is the reference's fan-out (``_audit_serve_coll``,
``_audit_collmm``): the spc pvars, the simulated-DCN charge, a perf
sample under the logical per-row bytes (the dispatch as the host issued
it, timed as ``perf.timed_coll`` times a collective; a fused ring gets
its share of the program's), the traffic edges of the same wire (a ring
on the comm's axis) and ONE ``decide:<coll>`` event with the chain, under
this process's world rank.  With tracing on, ``prefill``,
``decode_step`` and ``decode_window`` each record the reference's
``serve:*`` span (``prefill`` carries the request's ``rid``); the span
ends after the result reached the host, so it covers the step's device
work.  Replicas of the engine make a fleet (``serving/fleet``).
``verify_decode_program`` proves the fused program's static wire against
one decode step's audit (``analysis/commgraph``).

Prefill runs the prompt at its own length: the reference pads it to a
power-of-two bucket only to bound its JIT compiles, and the padded
positions never enter the causal window, so the values are the same.
Prefill attention is ``parallel/ring.attention_reference`` and decode
attention ``models/transformer.decode_attention``, as in the reference: no
kernel of the port runs here.  The engine follows the comm's device; on a
CUDA mesh without CUDA it raises.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import optim, perf, serving, trace, traffic
from ..device import check_on, resolve_device
from ..models.transformer import _rms_norm, decode_attention, rope_rows
from ..parallel import simdcn
from ..parallel.mesh import classify_axes
from ..parallel.ring import attention_reference
from .cache import PagedKVCache

# -- collective-free pieces, on this rank's (1, B, …) rows ------------------


def _bucket(n: int) -> int:
    """The reference's prefill bucket: the least power of 2 >= max(n, 8)."""
    p = 8
    while p < n:
        p *= 2
    return p


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


def _fused_logits_argmax(ag, n: int):
    """Fused-path logits: the program returns (1, B, V/tp) vocab blocks;
    after the eager decode_ag the regroup concats them in rank order —
    full (1, B, V) logits and the greedy argmax."""
    logits = _regroup(ag, n).float()
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


def _charge_simdcn(dc, kinds, wire: int) -> None:
    """The simulated-DCN delay shim (``parallel/simdcn``), when it is on:
    the DCN fraction of the comm's ring of ``wire`` bytes."""
    if simdcn.us_per_mib() > 0:
        simdcn.charge(int(wire * simdcn.ring_dcn_fraction(
            dc.mesh, dc.axis, kinds=kinds)))


def _audit_serve_coll(dc, coll: str, arm: str, reason: str,
                      chain: List[str], x: torch.Tensor, dur_s: float,
                      kinds=None) -> int:
    """ONE audit record per decode collective — the same fan-out as
    coll/nccl's audit: the arm's wire bytes (``coll/quant.wire_bytes``'s
    figure for this rank's payload) counted as ``coll_arm_<arm>_count``
    and ``coll_wire_bytes`` in the comm's spc, the simulated-DCN charge
    of the comm's axes (``kinds``), a perf sample under the LOGICAL
    payload bytes (what ``decide_mode`` sees, so native and quant land in
    one cell), the traffic ring edges of the same wire figure and the
    decision event carrying the precedence chain."""
    from ..coll.quant import _dtype_name, wire_bytes
    nbytes = x.numel() * x.element_size()
    qcoll = "allgather" if coll == "decode_ag" else "reduce_scatter"
    try:
        wb = wire_bytes(qcoll, max(x.numel(), 1), dc.n, x.dtype)
    except (ValueError, TypeError):
        wb = None
    ratio = wb["ratio"] if wb is not None else None
    wire = nbytes
    if wb is not None:
        wire = wb["quant_bytes"] if arm == "quant" else wb["native_bytes"]
    spc = dc.spc
    if spc is not None:
        spc.inc(f"coll_arm_{arm}_count")
        spc.inc("coll_wire_bytes", int(wire))
    _charge_simdcn(dc, kinds, int(wire))
    if perf.enabled:
        perf.note_sample(coll, arm, int(nbytes), dur_s, dc.n)
    if traffic.enabled:
        traffic.note_coll(dc, coll, arm, int(wire))
    if trace.enabled:
        bucket = 1 << max(int(nbytes) - 1, 0).bit_length()
        trace.decision(coll, arm=arm, reason=reason, verdict=None,
                       nbytes=int(nbytes), rank=dist.get_rank(),
                       shape_bucket=bucket, shape=tuple(x.shape),
                       dtype=_dtype_name(x.dtype), ndev=dc.n,
                       wire_bytes=int(wire), quant_ratio=ratio,
                       chain=list(chain))
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
        self.moe = cfg.mlp == "moe"
        dims = ["n_heads", "d_model", "vocab"] + ([] if self.moe
                                                  else ["d_ff"])
        for name in dims:
            dim = getattr(cfg, name)
            if dim % dc.n:
                raise ValueError(
                    f"ServingEngine: cfg.{name}={dim} not divisible by "
                    f"the {dc.n}-way tp axis")
        if self.moe:
            # moe_block_ep's canonical (R, t, d) layout splits the batch
            # over the ranks, and rank j owns experts [j·epr, (j+1)·epr)
            if int(max_seqs) % dc.n:
                raise ValueError(
                    f"ServingEngine: moe decode needs max_seqs="
                    f"{max_seqs} divisible by the {dc.n}-way comm axis")
            if cfg.n_experts % dc.n:
                raise ValueError(
                    f"ServingEngine: cfg.n_experts={cfg.n_experts} not "
                    f"divisible by the {dc.n}-way comm axis")
        if layout not in ("train", "decode"):
            raise ValueError(f"layout={layout!r} (want train|decode)")
        self.fused = cfg.decode_overlap == "fused"
        if self.fused:
            if cfg.mlp == "moe":
                raise ValueError(
                    "ServingEngine: decode_overlap='fused' is dense-MLP "
                    "only — moe decode stays on the eager path")
            if dc.n < 2:
                raise ValueError(
                    "ServingEngine: decode_overlap='fused' needs tp>=2 "
                    "(the rings are the whole point)")
            if int(max_seqs) % dc.n:
                raise ValueError(
                    f"ServingEngine: decode_overlap='fused' needs "
                    f"max_seqs={max_seqs} divisible by the {dc.n}-way "
                    f"tp axis (batch-sharded residual)")
        check_on(optim.tree_leaves(params), self.device, "params")
        if layout == "train":
            params = tfm.convert_params(params, dc.mesh, cfg, to="decode")
        self.dc = dc
        self.cfg = cfg
        self.max_seqs = int(max_seqs)
        # the comm's axes' classification and the plane that keys
        # '<coll>@<plane>' rules rows, fixed here
        self._kinds = classify_axes(dc.mesh, dc.axis)
        self._plane = "dcn" if "dcn" in self._kinds.values() else "ici"

        def can(w):
            # weight-stationary: store in the compute dtype (the same cast
            # forward() pays per step), under a leading row
            return dc.canonicalize(w.to(cfg.dtype), 1)

        # wqkv's decode shard is already [q_t | k_t | v_t] (cut by heads)
        self._embed = can(params["embed"])             # (1, V, d/tp)
        self._final_norm = params["final_norm"]
        self._layers: List[Dict[str, Any]] = []
        for lw in params["layers"]:
            cl = {"attn_norm": lw["attn_norm"], "wqkv": can(lw["wqkv"]),
                  "wo": can(lw["wo"]), "mlp_norm": lw["mlp_norm"]}
            if self.moe:
                cl["moe"] = self._local_experts(lw["moe"])
            else:
                cl.update({"w_gate": can(lw["w_gate"]),
                           "w_up": can(lw["w_up"]),
                           "w_down": can(lw["w_down"])})
            self._layers.append(cl)
        self.cache = PagedKVCache(
            dc, cfg.n_layers, cfg.n_heads, cfg.head_dim,
            n_pages=n_pages, page_size=page_size, max_seqs=max_seqs,
            max_pages_per_seq=max_pages_per_seq, dtype=cfg.dtype)
        self.dispatches: Dict[str, int] = {"decode_ag": 0, "decode_rs": 0,
                                           "decode_collmm": 0}
        self.wire_bytes = 0
        if self.fused:
            self._init_fused(params)

    def _local_experts(self, moe: Dict) -> Dict[str, torch.Tensor]:
        """This rank's n_experts/tp experts, whole, in the compute dtype
        (the router stays f32, as moe_block_ep computes it): the (E, d,
        f/tp) and (E, f/tp, d) decode shards move the tp cut from the
        features to the experts, one planned and audited ``all_to_all``
        a leaf (``parallel/reshard``), once."""
        from ..parallel.reshard import Resharder
        ax = self.dc.axis
        rs = Resharder(self.dc.mesh, spc=self.dc.spc)
        cut = {"w_gate": (None, None, ax), "w_up": (None, None, ax),
               "w_down": (None, ax, None)}
        return {"router": moe["router"],
                **{k: rs.run(moe[k].to(self.cfg.dtype), src, (ax, None, None))
                   for k, src in cut.items()}}

    def _moe_mlp(self, x: torch.Tensor, lw: Dict) -> torch.Tensor:
        """One layer's MoE MLP: this rank's B/tp rows of the normed
        residual (1, B, d) to ``moe_block_ep`` (only the routed tokens
        travel, under the audited moe_dispatch/moe_combine), every rank's
        mixture gathered back and added to the replicated residual."""
        from ..models.moe import _all_rows, moe_block_ep
        dc, cfg = self.dc, self.cfg
        h = _rms_norm(x, lw["mlp_norm"])
        b, d = h.shape[1], h.shape[2]
        t = b // dc.n
        mine = h[0, dc.pos * t:(dc.pos + 1) * t][None]          # (1, t, d)
        out, _aux, _info = moe_block_ep(
            dc, mine, lw["moe"], cfg.n_experts, cfg.moe_top_k,
            cfg.moe_capacity_factor)
        return x + _all_rows(dc, out).reshape(1, b, d).to(x.dtype)

    def _init_fused(self, params: Dict) -> None:
        """The fused decode program and its weight views.  The AG rings
        reuse the column shards lifted above (gate|up concatenated into
        one ``wgu`` so the pair shares a ring); the RS rings contract over
        local ROWS, so ``wo``, ``w_down`` and the tied embedding are laid
        out row-parallel once here — one planned and audited
        ``all_to_all`` step each (``parallel/reshard``) — and the
        embedding's vocab block is transposed to (1, d, V/tp)."""
        from ..parallel.reshard import Resharder
        from .fused import build_fused_decode
        dc, cfg = self.dc, self.cfg
        # audited into this comm's spc (the mesh's shared Resharder would
        # keep the comm's table for later callers)
        rs = Resharder(dc.mesh, spc=dc.spc)
        col, row = (None, dc.axis), (dc.axis, None)

        def row_can(w):
            return dc.canonicalize(rs.run(w.to(cfg.dtype), col, row), 0)

        self._fused_layers: List[Dict[str, torch.Tensor]] = [
            {"attn_norm": cl["attn_norm"], "mlp_norm": cl["mlp_norm"],
             "wqkv": cl["wqkv"],
             "wgu": torch.cat([cl["w_gate"], cl["w_up"]], dim=-1),
             "wo": row_can(lw["wo"]),                 # (1, h/tp, d)
             "wd": row_can(lw["w_down"])}             # (1, f/tp, d)
            for lw, cl in zip(params["layers"], self._layers)]
        self._embed_lg = row_can(params["embed"]).transpose(1, 2).contiguous()
        self._fused = build_fused_decode(dc, cfg.n_layers, cfg.head_dim,
                                         float(cfg.rope_base))
        # one ring schedule per row count: the continuous batch and each
        # speculative window length (the payloads scale with the rows)
        self._ring_rows: Dict[int, List[Tuple[str, int, int]]] = {}

    # -- audited collective dispatch ---------------------------------------

    def _dispatch(self, coll: str, x: torch.Tensor) -> torch.Tensor:
        # the decision and the dispatch timed as the host issues them
        t0 = time.perf_counter()
        arm, reason, chain = _decide_serve_coll(
            self.dc, coll, x.numel() * x.element_size(), x.dtype,
            self._plane)
        if coll == "decode_ag":
            out = (self.dc.quant.allgather(x) if arm == "quant"
                   else self.dc.allgather(x))
        else:
            out = (self.dc.quant.reduce_scatter(x) if arm == "quant"
                   else self.dc.reduce_scatter(x))
        dur = time.perf_counter() - t0
        self.wire_bytes += _audit_serve_coll(self.dc, coll, arm, reason,
                                             chain, x, dur, self._kinds)
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
            if self.moe:
                x = self._moe_mlp(_residual(self._ag(o), x, n), lw)
                continue
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

    # -- fused decode (decode_overlap="fused") -----------------------------

    def _audit_collmm(self, site: str, payload: int, wire: int, arm: str,
                      reason: str, chain: List[str], dur_s: float,
                      rows: int) -> None:
        """One audit record per fused ring — the decode_collmm counterpart
        of ``_audit_serve_coll``.  The ring is an n−1-hop rotation, so the
        wire figure is exact (``ring_schedule``): counted as
        ``coll_arm_<arm>_count`` and ``coll_wire_bytes`` in the comm's spc,
        in ``dispatches`` and ``wire_bytes``, and as a ``"fused"``
        dispatch in the serve plane; then the simulated-DCN charge, the
        perf sample (this ring's share of the program's time), the ring
        edges on the comm's axis (``note_ring``: ``decode_collmm`` has no
        entry in traffic's coll table) and one ``decide:decode_collmm``
        event naming the ring's site."""
        from ..coll.quant import _dtype_name
        dc = self.dc
        spc = dc.spc
        if spc is not None:
            spc.inc(f"coll_arm_{arm}_count")
            spc.inc("coll_wire_bytes", int(wire))
        _charge_simdcn(dc, self._kinds, int(wire))
        if perf.enabled:
            perf.note_sample("decode_collmm", arm, int(payload), dur_s,
                             dc.n)
        if traffic.enabled:
            traffic.note_ring(dc.mesh, dc.axis, int(wire), "decode_collmm",
                              "fwd")
        if trace.enabled:
            bucket = 1 << max(int(payload) - 1, 0).bit_length()
            trace.decision("decode_collmm", arm=arm, reason=reason,
                           verdict=None, nbytes=int(payload),
                           rank=dist.get_rank(), shape_bucket=bucket,
                           shape=(rows // dc.n, self.cfg.d_model),
                           dtype=_dtype_name(self.cfg.dtype), ndev=dc.n,
                           wire_bytes=int(wire), quant_ratio=None,
                           chain=list(chain), site=site)
        self.dispatches["decode_collmm"] += 1
        self.wire_bytes += int(wire)
        if serving.enabled:
            serving.note_dispatch("fused")

    def _decode_fused(self, tokens, positions, page_idx, offset, bt):
        """The fused decode body: every ring of the program is decided
        (the full precedence chain, native the only arm) BEFORE it runs,
        then one eager embed ``decode_ag``, the program (every tp combine
        an n−1-hop collective-matmul ring, ``serving/fused``), one
        ``decode_collmm`` audit a ring, and the eager logits
        ``decode_ag``.  The arguments are flat over any row count
        divisible by tp: the continuous batch (``decode_step``) and the
        speculative window (``decode_window``) share this body, each row
        count with its own ring schedule."""
        from .fused import ring_schedule
        cfg, n = self.cfg, self.dc.n
        rows = int(tokens.shape[0])
        sched = self._ring_rows.get(rows)
        if sched is None:
            sched = self._ring_rows[rows] = ring_schedule(
                cfg.n_layers, rows, cfg.d_model, n, cfg.dtype.itemsize)
        decided = [(site, payload, wire)
                   + _decide_serve_coll(self.dc, "decode_collmm", payload,
                                        cfg.dtype, self._plane,
                                        allowed=("native",))
                   for site, payload, wire in sched]
        x = _regroup(self._ag(_embed(self._embed, self._index(tokens))), n)
        t0 = time.perf_counter()
        lg = self._fused(x, self._index(bt), self._index(positions),
                         self._index(page_idx), self._index(offset),
                         self._fused_layers, self._final_norm,
                         self._embed_lg, self.cache.k, self.cache.v)
        share = (time.perf_counter() - t0) / max(len(decided), 1)
        for site, payload, wire, arm, reason, chain in decided:
            self._audit_collmm(site, payload, wire, arm, reason, chain,
                               share, rows)
        return _fused_logits_argmax(self._ag(lg), n)

    def _decode_rows(self, tokens, positions, page_idx, offset, bt):
        """One decode pass over flat rows (inactive rows at position −1,
        their token 0) on the engine's path: eager or fused.  Returns the
        (1, rows, V) logits and the (1, rows) greedy tokens."""
        if self.fused:
            return self._decode_fused(tokens, positions, page_idx, offset,
                                      bt)
        bt = self._index(bt)
        pos_dev = self._index(positions)
        x = _regroup(self._ag(_embed(self._embed, self._index(tokens))),
                     self.dc.n)
        x = self._backbone(
            x, pos_dev, self._index(page_idx), self._index(offset),
            lambda i, q, k, v: _paged_attn(q, self.cache.k[i],
                                           self.cache.v[i], bt, pos_dev))
        return self._logits(x, int(tokens.shape[0]))

    # -- serving entry points ----------------------------------------------

    def _span(self, name: str, t0: Optional[float], args: Dict) -> None:
        """Record one ``serve:*`` span begun at ``t0`` (None when tracing
        was off at the start)."""
        if t0 is not None:
            trace.record_span(name, "serve", t0, time.perf_counter(),
                              rank=dist.get_rank(), args=args)

    def prefill(self, slot: int, prompt: np.ndarray, rid: Any = None):
        """Run one request's prompt through the decode-layout model: writes
        its KV pages, returns (first greedy token, last-position logits
        (1, 1, V), this rank's row).  Prefill is eager on either path, as
        in the reference.  ``rid`` tags the ``serve:prefill`` span with the
        owning request."""
        t0 = time.perf_counter() if trace.enabled else None
        try:
            first, logits = self._prefill(slot, prompt)
        finally:
            self._span("serve:prefill", t0,
                       {"slot": slot, "prompt_len": int(len(prompt)),
                        "rid": rid})
        return first, logits

    def _prefill(self, slot: int, prompt: np.ndarray):
        prompt = np.asarray(prompt, np.int64)
        s = int(prompt.shape[0])
        # MoE: pad to the reference's power-of-2 bucket of at least 8
        # (token 0 at positions the causal window never reaches, written
        # to the scratch page): moe_block_ep's capacity is taken over the
        # padded tokens, so the bucket keeps the reference's drops.  The
        # rows split over the ranks (a bucket a power-of-2 tp divides).
        spad = -(-_bucket(s) // self.dc.n) * self.dc.n if self.moe else s
        positions = np.arange(spad)
        page_idx, offset = self.cache.write_indices(
            np.full(spad, slot), np.where(positions < s, positions, -1))
        tokens = np.zeros(spad, np.int64)
        tokens[:s] = prompt
        x = _regroup(self._ag(_embed(self._embed, self._index(tokens))),
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
        t0 = time.perf_counter() if trace.enabled else None
        try:
            logits, nxt = self._decode_rows(
                np.where(positions >= 0, tokens, 0), positions, page_idx,
                offset, self.cache.block_tables)
            nxt = nxt[0].cpu().numpy()
        finally:
            self._span("serve:decode_step", t0,
                       {"active": int((positions >= 0).sum()), "slots": b,
                        "path": "fused" if self.fused else "eager"})
        return nxt, logits

    def decode_window(self, tokens: np.ndarray, positions: np.ndarray):
        """Teacher-forced k-token verify window for speculative decoding:
        ``tokens``/``positions`` are (max_seqs, k) — slot s's row is its
        last accepted token followed by k−1 draft tokens, at consecutive
        positions (−1 = inactive, whole row).  All k KV rows are written to
        the slot's pages FIRST, then the flattened (max_seqs·k) rows attend
        under the causal position mask — within-window causality falls out
        of ``decode_attention`` masking key positions > q_pos.  Returns
        (greedy next token per window position (max_seqs, k), logits
        (1, max_seqs·k, V), this rank's row).

        Rejection is the caller's job: truncate ``cache.seq_lens`` back to
        the accepted prefix — the stale KV rows beyond it are masked by
        every later query and overwritten when the position is refilled.
        The window rides the engine's path, eager (27 audited dispatches
        at the flagship's depth) or fused (the rings at the window's row
        count)."""
        b = self.max_seqs
        tokens = np.asarray(tokens, np.int64)
        positions = np.asarray(positions, np.int64)
        k = int(tokens.shape[1])
        slots = np.broadcast_to(np.arange(b)[:, None], (b, k))
        page_idx, offset = self.cache.write_indices(slots, positions)
        t0 = time.perf_counter() if trace.enabled else None
        try:
            logits, nxt = self._decode_rows(
                np.where(positions >= 0, tokens, 0).reshape(-1),
                positions.reshape(-1), page_idx.reshape(-1),
                offset.reshape(-1), np.repeat(self.cache.block_tables, k,
                                              axis=0))
            nxt = nxt[0].cpu().numpy().reshape(b, k)
        finally:
            self._span("serve:decode_window", t0,
                       {"active": int((positions[:, 0] >= 0).sum()),
                        "slots": b, "k": k})
        return nxt, logits

    def verify_decode_program(self):
        """Prove the fused decode program's static wire against the
        runtime audit byte for byte (``analysis/commgraph``): extract the
        program's collectives (every ring hop one ppermute record, its
        perm assembled over the tp group), run ONE real decode step with
        mixed live and inactive rows, and compare the static ppermute
        bytes with the step's ``decode_collmm`` charge.  Returns the
        commgraph ``VerifyReport``; ``report.ok`` is the acceptance gate.
        Collective over the engine's comm.  The extraction runs the
        program once, so it writes position 0 of the live rows' pages, as
        the decode step that follows does."""
        if not self.fused:
            raise ValueError("verify_decode_program needs "
                             "decode_overlap='fused'")
        from ..analysis import commgraph
        b = self.max_seqs
        zeros = np.zeros(b, np.int64)
        live = np.arange(b, dtype=np.int64) % 2  # mixed live/inactive
        positions = np.where(live > 0, 0, -1).astype(np.int64)
        page_idx, offset = self.cache.write_indices(np.arange(b),
                                                    positions)
        args = (torch.zeros((1, b, self.cfg.d_model), dtype=self.cfg.dtype,
                            device=self.device),
                self._index(self.cache.block_tables),
                self._index(positions), self._index(page_idx),
                self._index(offset), self._fused_layers, self._final_norm,
                self._embed_lg, self.cache.k, self.cache.v)

        def runner():
            self.decode_step(zeros, positions)

        return commgraph.verify(
            self._fused, args, self.dc.mesh,
            coll_map={"decode_collmm": "ppermute"}, runner=runner,
            source="serving.fused:decode", comm=self.dc.group)
