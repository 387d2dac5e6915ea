"""Flagship workload: the GPT-style decoder of the JAX package, on one device.

Counterpart of ``ompi_tpu/models/transformer.py`` on one device: the same
``Config``, the same parameter tree and layouts (``wqkv (d, 3h)`` as
``[q|k|v]`` columns, ``wo (h, d)``, ``w_gate``/``w_up (d, f)``,
``w_down (f, d)``, ``embed (V, d)``; every product is a plain ``x @ w``),
f32 master parameters cast to ``cfg.dtype`` at each use (no autocast), the
RMS norm and half-split RoPE of the reference, and a tied embedding with
f32 logits.  ``attn="flash"`` runs ``flash_mha`` (kernel K1 on the card);
``attn="dense"`` runs ``attention_reference``.  The large products are
``torch.matmul``, as the JAX package left them to XLA.

Training: ``make_train_step``'s step takes ``value_and_grad`` of
``loss_fn`` over the f32 master leaves (``flash_mha``'s backward is K2 and
K3 on the card) and applies AdamW in place (``ompi_tpu_torch.optim``).  ``remat`` wraps each
layer in ``torch.utils.checkpoint``: ``"full"`` recomputes the layer,
``"dots"`` saves the weight products' outputs and recomputes the rest, K1
included.  ``loss_chunk`` runs the chunked cross-entropy.

Not yet ported, each refused with the ROADMAP slice that brings it:
``attn="ring"`` (P5), ``mlp="moe"`` (P12), ``tp_overlap="fused"`` (P9)
and training on a mesh (P6).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import optim
from ..device import DeviceLike, check_on, resolve_device
from ..ops.attention import flash_mha
from ..parallel.ring import attention_reference

_NOT_YET = {
    ("attn", "ring"): "ring attention comes with ROADMAP slice P5",
    ("mlp", "moe"): "the MoE block comes with ROADMAP slice P12",
    ("tp_overlap", "fused"): "fused tp overlap comes with ROADMAP slice P9",
}
_CHOICES = {"attn": ("dense", "flash", "ring"), "mlp": ("dense", "moe"),
            "tp_overlap": ("none", "fused"),
            "remat": ("none", "dots", "full"),
            "opt_moment_dtype": ("float32", "bfloat16")}
_GRAD_SYNC = ("native", "quant", "perleaf", "bucketed", "unsynced")


@dataclass(frozen=True)
class Config:
    vocab: int = 512
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 8
    head_dim: int = 16
    d_ff: int = 512
    seq: int = 128
    dtype: torch.dtype = torch.bfloat16   # activation/compute dtype
    attn: str = "dense"                   # "dense" | "flash" (K1)
    rope_base: float = 10000.0
    mlp: str = "dense"
    tp_overlap: str = "none"
    remat: str = "none"                   # "none" | "dots" | "full"
    # flash fwd/bwd block overrides: they tile the plain versions (CPU);
    # the CUDA kernels keep their own tiles
    attn_block: Optional[int] = None
    attn_bwd_block: Optional[int] = None
    loss_chunk: Optional[int] = None      # chunked cross-entropy slice
    opt_moment_dtype: str = "float32"     # AdamW first moment: or bfloat16
    grad_sync: str = "native"             # others need a mesh (P6)

    def __post_init__(self):
        for name, allowed in _CHOICES.items():
            val = getattr(self, name)
            if val not in allowed:
                raise ValueError(f"Config.{name}={val!r} (expected one of "
                                 f"{allowed})")
            if (name, val) in _NOT_YET:
                raise NotImplementedError(
                    f"Config.{name}={val!r}: {_NOT_YET[(name, val)]}")


def flagship_config(seq: int = 2048) -> Config:
    """The single-chip flagship of the JAX package: vocab 32768, d_model
    2048, 6 layers, 16 heads of 128, d_ff 8192, bf16, flash attention,
    remat "dots" (~440 M parameters)."""
    return Config(vocab=32768, d_model=2048, n_layers=6, n_heads=16,
                  head_dim=128, d_ff=8192, seq=seq, attn="flash",
                  remat="dots")


def train_flops_per_token(cfg: Config) -> float:
    """Counted model FLOPs per trained token (the MFU numerator), as the
    JAX package counts them: 6 × matmul-weight params (fwd 2N + bwd 4N)
    plus causal attention 6·s·h per layer, h = n_heads·head_dim.  Remat
    recompute is hardware work but is not counted."""
    h = cfg.n_heads * cfg.head_dim
    per_layer = (cfg.d_model * 3 * h          # wqkv
                 + h * cfg.d_model            # wo
                 + 3 * cfg.d_model * cfg.d_ff)  # gate/up/down
    n_mm = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab  # + logits
    attn = 6 * cfg.seq * h * cfg.n_layers                      # causal
    return 6.0 * n_mm + attn


# -- parameters ---------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: Config,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's distributions: normal /
    sqrt(fan_in) for the products, ones for the norms, all f32.  They are
    drawn on the generator's device and then moved, so a seed gives the
    same weights on the CPU and on the card.  (They are not the JAX
    package's weights for the same seed: those cross through
    ``params_from_numpy``.)"""
    dev = resolve_device(device)

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w / math.sqrt(fan_in)).to(dev)

    ones = lambda n: torch.ones(n, dtype=torch.float32, device=dev)
    h = cfg.n_heads * cfg.head_dim
    params: Dict[str, Any] = {
        "embed": dense(cfg.d_model, cfg.vocab, cfg.d_model),
        "final_norm": ones(cfg.d_model),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": ones(cfg.d_model),
            "wqkv": dense(cfg.d_model, cfg.d_model, 3 * h),
            "wo": dense(h, h, cfg.d_model),
            "mlp_norm": ones(cfg.d_model),
            "w_gate": dense(cfg.d_model, cfg.d_model, cfg.d_ff),
            "w_up": dense(cfg.d_model, cfg.d_model, cfg.d_ff),
            "w_down": dense(cfg.d_ff, cfg.d_ff, cfg.d_model),
        })
    return params


_LAYER_KEYS = ("attn_norm", "wqkv", "wo", "mlp_norm", "w_gate", "w_up",
               "w_down")


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays, as the port's
    tree.  The layouts are the same, so nothing is transposed."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    layers = []
    for layer in tree["layers"]:
        if set(layer) != set(_LAYER_KEYS):
            raise ValueError(f"layer keys {sorted(layer)} are not the dense "
                             f"layer's {sorted(_LAYER_KEYS)}")
        layers.append({k: t(layer[k]) for k in _LAYER_KEYS})
    return {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
            "layers": layers}


# -- model --------------------------------------------------------------------

def _rms_norm(x, w):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * w.to(x.dtype)


def _rope(x, positions, base):
    # x: (b, s, h, d) — rotate the two halves
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None].float() * freqs[None, :]       # (s, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


def _attn_apply(x, layer, cfg: Config):
    """Attention half of the decoder layer, residual included."""
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)
    h = _rms_norm(x, layer["attn_norm"])
    qkv = h @ layer["wqkv"].to(cfg.dtype)            # (b, s, 3*heads*hd)
    q, k, v = (t.reshape(b, s, cfg.n_heads, cfg.head_dim)
               for t in qkv.chunk(3, dim=-1))
    q = _rope(q, positions, cfg.rope_base)
    k = _rope(k, positions, cfg.rope_base)
    if cfg.attn == "flash":
        att = flash_mha(q, k, v, True, None, cfg.attn_block, cfg.attn_block,
                        None, cfg.attn_bwd_block, cfg.attn_bwd_block)
    else:
        att = attention_reference(q, k, v, causal=True)
    att = att.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return x + att @ layer["wo"].to(cfg.dtype)


def _layer_apply(x, layer, cfg: Config):
    """One decoder layer with the dense (SwiGLU) MLP."""
    x = _attn_apply(x, layer, cfg)
    h = _rms_norm(x, layer["mlp_norm"])
    gate = torch.nn.functional.silu(h @ layer["w_gate"].to(cfg.dtype))
    up = h @ layer["w_up"].to(cfg.dtype)
    return x + (gate * up) @ layer["w_down"].to(cfg.dtype)


def _checkpointed(fn: Callable, context_fn=noop_context_fn) -> Callable:
    """``fn`` under non-reentrant activation checkpointing while autograd
    records; without a graph to record there is nothing to save."""
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``: save the outputs of products with
    no batch dimension (``x @ w`` folds to ``aten.mm``), recompute the rest:
    norms, RoPE, SiLU, the weight casts, the batched attention products of
    ``attn="dense"`` and ``flash_mha``'s forward (K1), as ``jax.checkpoint``
    re-runs a ``custom_vjp``'s forward."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn: Callable, mode: str) -> Callable:
    if mode == "full":
        return _checkpointed(fn)
    if mode == "dots":
        return _checkpointed(fn, functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return fn


def _backbone(params, tokens, cfg: Config, embed):
    """tokens (b, s) → hidden (b, s, d) after the final norm."""
    x = embed[tokens]                                 # (b, s, d)
    layer_fn = _remat_wrap(lambda x, layer: _layer_apply(x, layer, cfg),
                           cfg.remat)
    for layer in params["layers"]:
        x = layer_fn(x, layer)
    return _rms_norm(x, params["final_norm"])


def _prepare(params, tokens, device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    check_on(optim.tree_leaves(params), dev, "params")
    return torch.as_tensor(tokens, dtype=torch.long, device=dev)


def forward(params: Dict[str, Any], tokens, cfg: Config,
            device: DeviceLike = None) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab) float32.  Runs on
    ``device`` (``None`` = cuda), where ``params`` must already lie."""
    tokens = _prepare(params, tokens, device)
    embed = params["embed"].to(cfg.dtype)
    x = _backbone(params, tokens, cfg, embed)
    return (x @ embed.T).float()                      # tied embedding


def _chunked_ce(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """Mean cross-entropy without the whole (b, s, vocab) f32 logits: the
    sequence goes in slices of ``chunk`` positions (the last one ragged),
    each checkpointed so that the backward recomputes its logits from the
    (b, chunk, d) hidden slice instead of saving them."""
    b, s, _ = x.shape

    def one(x_c, t_c):                         # (b, chunk, d), (b, chunk)
        logits = (x_c @ embed.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_c[..., None])[..., 0]
        return (lse - gold).sum()

    one = _checkpointed(one)
    total = sum(one(x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk])
                for c0 in range(0, s, chunk))
    return total / (b * s)


def loss_fn(params: Dict[str, Any], tokens, cfg: Config,
            device: DeviceLike = None) -> torch.Tensor:
    """Mean next-token cross-entropy in logsumexp form; with
    ``cfg.loss_chunk`` the chunked form, which never holds the whole
    logits."""
    tokens = _prepare(params, tokens, device)
    targets = tokens[:, 1:]
    if cfg.loss_chunk:
        # the reference's refusal; Config refuses mlp="moe" before it here
        if cfg.mlp == "moe":
            raise ValueError("loss_chunk is only supported with "
                             "mlp='dense'; unset loss_chunk for this path")
        embed = params["embed"].to(cfg.dtype)
        x = _backbone(params, tokens[:, :-1], cfg, embed)
        return _chunked_ce(x, embed, targets, int(cfg.loss_chunk))
    logits = forward(params, tokens[:, :-1], cfg, tokens.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - gold).mean()


def greedy(params: Dict[str, Any], prompts: Sequence[Sequence[int]],
           n_new: int, cfg: Config,
           device: DeviceLike = None) -> List[List[int]]:
    """Answer requests greedily by full-context recompute: each new token
    is the argmax of the last position of ``forward`` over the whole
    context so far.  Prompts of one length run as one batch; the rows are
    independent, so each stream is what the prompt alone would give."""
    dev = resolve_device(device)
    lengths = {len(p) for p in prompts}
    if len(lengths) != 1:
        raise ValueError(f"greedy batches prompts of one length, got "
                         f"{sorted(lengths)}")
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    out = []
    for _ in range(n_new):
        nxt = forward(params, toks, cfg, dev)[:, -1].argmax(dim=-1)
        out.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).tolist() if out else [[] for _ in prompts]


# -- training -----------------------------------------------------------------

def value_and_grad(params: Dict[str, Any], tokens: torch.Tensor, cfg: Config,
                   device: DeviceLike = None,
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``(loss, grads)`` of ``loss_fn`` over the f32 master leaves, the
    grads in the order of ``optim.tree_leaves(params)``; the leaves leave
    with ``requires_grad`` off, as they came."""
    dev = resolve_device(device)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, tokens, cfg, dev)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(cfg: Config, mesh: Any = None,
                    learning_rate: float = 1e-3, device: DeviceLike = None,
                    ) -> Tuple[Callable, Callable]:
    """Returns ``(init_opt, step)``, the single-device counterpart of the
    JAX package's ``make_train_step`` (``optax.adamw(learning_rate,
    mu_dtype=cfg.opt_moment_dtype)``).  ``step(params, opt_state, tokens)``
    takes value-and-grad of ``loss_fn`` over the f32 master leaves on
    ``device`` (``None`` = cuda, where ``params`` must lie) and applies
    AdamW in place; it returns ``(params, opt_state, loss)``."""
    if cfg.grad_sync not in _GRAD_SYNC:
        raise ValueError(f"unknown grad_sync {cfg.grad_sync!r} "
                         f"(expected one of {_GRAD_SYNC})")
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step on a mesh comes with ROADMAP slice P6")
    if cfg.grad_sync != "native":
        raise ValueError(f"grad_sync={cfg.grad_sync!r} requires a mesh "
                         "(single-controller has no dp axis to sync)")
    dev = resolve_device(device)

    def init_opt(params):
        return optim.adamw_init(params, cfg.opt_moment_dtype)

    def step(params, opt_state, tokens):
        loss, grads = value_and_grad(params, tokens, cfg, dev)
        optim.adamw_update(params, list(grads), opt_state, learning_rate)
        return params, opt_state, loss

    return init_opt, step
