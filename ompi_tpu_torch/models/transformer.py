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

On a mesh (a ``DeviceMesh`` with axes among dp, sp, ep and tp; one
process a rank) the reference's GSPMD collectives are written out.
``shard_params`` gives each rank its Megatron shard (``param_specs``):
``wqkv``, ``w_gate`` and ``w_up`` column-parallel, ``wo`` and ``w_down``
row-parallel, ``embed`` vocab-parallel, norms replicated (a MoE layer's
experts over ep); ``wqkv``'s columns are cut by heads, so
tp rank t holds heads [t·h/tp, (t+1)·h/tp) of each of q, k and v.  Each
column-parallel product takes its input through *f* and each row-parallel
one ends in *g* (``parallel.collectives``); the lookup and the
cross-entropy are vocab-parallel; ``attn="ring"`` runs ``ring_attention``
over sp with global RoPE positions, and ``attn="flash"`` or ``"dense"`` on
sp > 1 run ``ulysses_attention`` over sp on this rank's h/tp heads (the
full sequence of (h/tp)/sp heads a rank: ``flash_mha``, so K1 forward and
K2/K3 backward, or ``attention_reference``), where the reference
replicates them over sp under GSPMD: the same values; tokens are cut over
dp (batch) and sp (sequence); the gradients sum over dp × sp
(``grad_sync="native"``).  An outer ``dpo`` axis is replicated by the
native step, as in the reference, and is part of the dp sync domain of
the other ``grad_sync`` modes (``parallel/overlap``).
``attn="ring"`` without a mesh is ``attention_reference``, as in the
reference.

``tp_overlap="fused"`` is Megatron sequence parallelism with the tp
collectives fused into the products (``_layer_apply_fused``): the residual
stream is cut over tp by sequence, qkv, gate and up are
``allgather_matmul`` and wo and down ``matmul_reduce_scatter``
(``ops/collective_matmul``), the ring direction of each call site decided
under the coll name ``collmm``.

``grad_sync`` other than native is dp-only, as in the reference: each rank
takes its dp rows of the batch, the loss on them with no mesh inside, and
the gradients are averaged over dp by the chosen scheduler: ``quant`` one
``psum_quant`` per leaf after the backward (``coll/quant``), ``perleaf``
one native mean per leaf after the backward, ``bucketed`` fixed-byte
buckets issued from autograd hooks during the backward
(``parallel/overlap``), ``unsynced`` none (a measurement floor).

Serving (``serving/engine``) reads the decode layout
(``decode_param_specs``: every product column-parallel, the embedding cut
over d_model), reached from the train shards by ``convert_params``
through ``parallel/reshard``, and ``rope_rows``/``decode_attention``, the
reference's per-row RoPE and paged decode attention.
``decode_overlap="fused"`` runs the engine's decode step as one program
whose tp combines are the collective-matmul rings (``serving/fused``).

``mlp="moe"`` replaces each layer's SwiGLU MLP by the capacity-dropping
expert block (``models/moe``, the reference's keys: a ``"moe"`` subtree of
``router``, ``w_gate``, ``w_up``, ``w_down`` in place of the dense three).
``forward`` then returns ``(logits, router aux)``, ``loss_fn`` adds
``moe.aux_weight(cfg.moe_aux_weight) × aux``, and the train step
differentiates the einsum block, as the reference's jitted step does: on
one card ``moe_block``, on a mesh ``moe_block_mesh``, whose experts are
cut over ep and their features over tp (``moe_param_specs``), with the
batch's capacity, slots and aux those of the one-card block.  The MoE mesh
loss adds the aux, the same global value on every rank, once, beside the
cross-entropy's sum over dp × sp.  With ``grad_sync`` other than native a
dp-only mesh runs ``moe_block`` on each rank's rows, with the capacity
over those rows, as the reference's per-shard loss does.
``moe_forward_ep``/``moe_eval_loss`` run every MoE layer on the ragged
expert-parallel exchange of a ``DeviceComm`` (``moe_block_ep``), the
forward/eval/serving arm.  The port's own refusals: ``attn="flash"`` or
``"dense"`` on sp > 1 when this rank's h/tp heads do not divide over sp
(Ulysses splits them), and ``tp_overlap="fused"`` on sp > 1 (the fused
layer attends its rank's sequence; the reference replicates it over sp).
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import moe as moe_plane
from .. import optim
from ..device import DeviceLike, check_on, resolve_device
from ..ops.attention import flash_mha
from ..ops.collective_matmul import allgather_matmul, matmul_reduce_scatter
from ..parallel import overlap
from ..parallel.collectives import (copy_to, gather_from, pmax, reduce_from,
                                    split_to)
from ..parallel.mesh import axes_group, axis_rank, axis_size, sharded
from ..parallel.reshard import resharder
from ..parallel.ring import attention_reference, ring_attention
from ..parallel.ulysses import ulysses_attention
from .moe import (init_moe_params, moe_block, moe_block_mesh,
                  moe_param_specs)

_CHOICES = {"attn": ("dense", "flash", "ring"), "mlp": ("dense", "moe"),
            "tp_overlap": ("none", "fused"),
            "remat": ("none", "dots", "full"),
            "opt_moment_dtype": ("float32", "bfloat16"),
            "decode_overlap": ("eager", "fused")}
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
    attn: str = "dense"                   # "dense" | "flash" (K1) | "ring"
    rope_base: float = 10000.0
    mlp: str = "dense"                    # "dense" | "moe"
    n_experts: int = 8
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    # how MoE dispatch/combine moves: "einsum" is the dense (T, E, C)
    # one-hot contraction the train step differentiates; "ragged" names the
    # expert-parallel exchange (moe_forward_ep / moe_eval_loss / serving)
    moe_impl: str = "einsum"
    # per-expert capacity headroom, C = ceil(T·k·cf/E); the ragged path
    # reads it through the live hot-expert adaptation (moe.capacity_factor)
    moe_capacity_factor: float = 1.25
    tp_overlap: str = "none"
    remat: str = "none"                   # "none" | "dots" | "full"
    # flash fwd/bwd block overrides: they tile the plain versions (CPU);
    # the CUDA kernels keep their own tiles
    attn_block: Optional[int] = None
    attn_bwd_block: Optional[int] = None
    loss_chunk: Optional[int] = None      # chunked cross-entropy slice
    opt_moment_dtype: str = "float32"     # AdamW first moment: or bfloat16
    # how the dp gradient sum moves: "native" (exact, over dp × sp) or, on
    # a dp-only mesh, "quant" | "perleaf" | "bucketed" | "unsynced"
    grad_sync: str = "native"
    grad_sync_block: int = 256            # quantization block, "quant"
    # "bucketed" bucket target; None = the coll_nccl_grad_bucket_bytes
    # variable (4 MiB)
    grad_bucket_bytes: Optional[int] = None
    # how the serving engine's decode step moves its tp combines: "eager",
    # one audited decode_ag/decode_rs between the pieces; "fused", the
    # collective-matmul rings inside one program (serving/fused)
    decode_overlap: str = "eager"

    def __post_init__(self):
        for name, allowed in _CHOICES.items():
            val = getattr(self, name)
            if val not in allowed:
                raise ValueError(f"Config.{name}={val!r} (expected one of "
                                 f"{allowed})")


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
        layer = {
            "attn_norm": ones(cfg.d_model),
            "wqkv": dense(cfg.d_model, cfg.d_model, 3 * h),
            "wo": dense(h, h, cfg.d_model),
            "mlp_norm": ones(cfg.d_model),
        }
        if cfg.mlp == "moe":
            layer["moe"] = init_moe_params(generator, cfg.d_model, cfg.d_ff,
                                           cfg.n_experts, dev)
        else:
            layer.update({
                "w_gate": dense(cfg.d_model, cfg.d_model, cfg.d_ff),
                "w_up": dense(cfg.d_model, cfg.d_model, cfg.d_ff),
                "w_down": dense(cfg.d_ff, cfg.d_ff, cfg.d_model),
            })
        params["layers"].append(layer)
    return params


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays, as the port's
    tree (a dense or a MoE layer's keys, the ``moe`` subtree included).
    The layouts are the same, so nothing is transposed."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    layers = []
    for layer in tree["layers"]:
        want = _layer_spec("moe" if "moe" in layer else "dense")
        if set(layer) != set(want) or (
                "moe" in layer and set(layer["moe"]) != set(want["moe"])):
            raise ValueError(f"layer keys {sorted(layer)} are neither the "
                             f"dense nor the MoE layer's")
        layers.append(optim.tree_map(t, layer))
    return {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
            "layers": layers}


# -- the Megatron layout over a mesh ------------------------------------------

def _layer_spec(mlp: str, decode: bool = False) -> Dict[str, Any]:
    """One layer's specs: the train layout (row-parallel wo/down) or the
    decode one (every product column-parallel); a MoE layer's ``moe``
    subtree is ``moe_param_specs`` in both, as in the reference."""
    row = (None, "tp") if decode else ("tp", None)
    layer = {"attn_norm": (), "wqkv": (None, "tp"), "wo": row,
             "mlp_norm": ()}
    if mlp == "moe":
        layer["moe"] = moe_param_specs()
    else:
        layer.update({"w_gate": (None, "tp"), "w_up": (None, "tp"),
                      "w_down": row})
    return layer


def param_specs(cfg: Config) -> Dict[str, Any]:
    """Megatron-style tp layout, the reference's: one axis name (or None)
    per dim of each leaf.  qkv/gate/up column-parallel (their output
    features over tp), wo/down row-parallel (their input features), the
    embedding vocab-parallel, the norms replicated; a MoE layer's experts
    over ep and their features over tp (``moe_param_specs``)."""
    return {"embed": ("tp", None), "final_norm": (),
            "layers": [_layer_spec(cfg.mlp) for _ in range(cfg.n_layers)]}


def _qkv_by_heads(w: torch.Tensor, tp: int,
                  inverse: bool = False) -> torch.Tensor:
    """wqkv's [q|k|v] columns, reordered so that the column cut over tp
    gives rank t heads [t·h/tp, (t+1)·h/tp) of each of q, k and v:
    (d, 3, tp, cols) → (d, tp, 3, cols).  ``inverse`` undoes it.  (The
    reference's P(None, "tp") on the fused matrix would give rank 0 all of
    q; GSPMD computes the same either way, explicit Megatron cannot.)"""
    d = w.shape[0]
    shape = (d, tp, 3, -1) if inverse else (d, 3, tp, -1)
    return w.reshape(shape).transpose(1, 2).reshape(d, -1)


def _map_specs(fn: Callable, params: Dict[str, Any], cfg: Config,
               specs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``fn(leaf, spec, name)`` over the parameter tree, beside its
    ``specs`` (``param_specs`` by default)."""
    specs = param_specs(cfg) if specs is None else specs
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['layers'])} layers, Config has "
                         f"{cfg.n_layers}")

    def one(leaf, spec, name):
        if isinstance(spec, dict):                   # a layer's moe subtree
            return {k: fn(leaf[k], spec[k], f"{name}/{k}") for k in spec}
        return fn(leaf, spec, name)

    return {"embed": fn(params["embed"], specs["embed"], "embed"),
            "final_norm": fn(params["final_norm"], specs["final_norm"],
                             "final_norm"),
            "layers": [{k: one(layer[k], spec[k], k) for k in spec}
                       for layer, spec in zip(params["layers"],
                                              specs["layers"])]}


def _fit(mesh: DeviceMesh, spec) -> Tuple[Optional[str], ...]:
    # an axis the mesh lacks: that dimension is simply replicated
    return tuple(a if a in mesh.mesh_dim_names else None for a in spec)


def shard_params(params: Dict[str, Any], mesh: DeviceMesh,
                 cfg: Config) -> Dict[str, Any]:
    """The full parameter tree → this rank's shards, fresh tensors on the
    parameters' device (the reference's ``shard_params``; see
    ``_qkv_by_heads`` for the one leaf cut otherwise)."""
    tp = axis_size(mesh, "tp")

    def one(x, spec, name):
        if name == "wqkv":
            x = _qkv_by_heads(x, tp)
        return sharded(mesh, *_fit(mesh, spec)).local(x)

    _check_tp(cfg, tp)
    return _map_specs(one, params, cfg)


def gather_params(params: Dict[str, Any], mesh: DeviceMesh,
                  cfg: Config) -> Dict[str, Any]:
    """``shard_params``' inverse: every rank's shards → the full tree on
    every rank (collective over tp)."""
    tp = axis_size(mesh, "tp")

    def one(x, spec, name):
        full = sharded(mesh, *_fit(mesh, spec)).gather(x)
        return _qkv_by_heads(full, tp, inverse=True) if name == "wqkv" \
            else full

    _check_tp(cfg, tp)
    return _map_specs(one, params, cfg)


def decode_param_specs(cfg: Config) -> Dict[str, Any]:
    """Decode/serving layout: weight-stationary column-parallel.  Train's
    row-parallel weights (wo, w_down) flip to sharding their OUTPUT
    features over `tp`, and the embedding flips from vocab- to model-dim
    sharding, as in the reference.  ``wqkv`` keeps the train cut, by heads
    (``_qkv_by_heads``): rank t's columns are [q_t | k_t | v_t], the
    per-rank layout the serving engine reads."""
    return {"embed": (None, "tp"), "final_norm": (),
            "layers": [_layer_spec(cfg.mlp, decode=True)
                       for _ in range(cfg.n_layers)]}


def convert_params(params: Dict[str, Any], mesh: DeviceMesh, cfg: Config,
                   to: str = "decode") -> Dict[str, Any]:
    """Switch this rank's shards between the train and decode layouts on
    the device: each leaf moves through ``parallel/reshard``'s compiled
    plan (``embed``, ``wo`` and ``w_down`` one ``all_to_all[tp:0->1]``
    each); a leaf already in the target layout has the empty plan and
    comes back as a copy.  Collective over the mesh."""
    if to == "decode":
        src, dst = param_specs(cfg), decode_param_specs(cfg)
    elif to == "train":
        src, dst = decode_param_specs(cfg), param_specs(cfg)
    else:
        raise ValueError(f"convert_params: to={to!r} (want train|decode)")
    _check_tp(cfg, axis_size(mesh, "tp"))
    want = {"embed": dst["embed"], "final_norm": dst["final_norm"],
            **dst["layers"][0],
            **{f"moe/{k}": v for k, v in dst["layers"][0].get("moe",
                                                              {}).items()}}
    rs = resharder(mesh)
    return _map_specs(lambda x, spec, name: rs.run(
        x, _fit(mesh, spec), _fit(mesh, want[name])), params, cfg, src)


class _Plan:
    """What the layers need of a dp×sp×ep×tp mesh, read once a call: each
    axis's size and this rank's position on it (an axis the mesh lacks
    has one member), and the collectives the reference's GSPMD inserted.
    The batch is cut over dp and sp and replicated over ep and tp; only a
    MoE layer's experts are cut over ep (``models/moe.moe_block_mesh``)."""

    def __init__(self, mesh: DeviceMesh, cfg: Config) -> None:
        self.mesh = mesh
        self.dp, self.sp, self.ep, self.tp = (
            axis_size(mesh, a) for a in ("dp", "sp", "ep", "tp"))
        self.dp_rank, self.sp_rank, self.ep_rank, self.tp_rank = (
            axis_rank(mesh, a) for a in ("dp", "sp", "ep", "tp"))
        self.ring = cfg.attn == "ring" and "sp" in mesh.mesh_dim_names
        # flash and dense attend the whole sequence: over sp > 1 through
        # the Ulysses exchange
        self.ulysses = cfg.attn != "ring" and self.sp > 1
        self.fused = cfg.tp_overlap == "fused"
        # every leaf is replicated over dp and sp: its gradient sums there
        # (over ep a replicated leaf's gradient is already whole on each
        # rank, and an expert's lives on one ep rank)
        self.data = (axes_group(mesh, ("dp", "sp"))
                     if self.dp * self.sp > 1 else None)

    def axis(self, name: str) -> Optional[str]:
        return name if name in self.mesh.mesh_dim_names else None

    def to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """*f*, before a column-parallel product."""
        return copy_to(x, "tp", self.mesh) if self.tp > 1 else x

    def from_tp(self, x: torch.Tensor) -> torch.Tensor:
        """*g*, after a row-parallel product."""
        return reduce_from(x, "tp", self.mesh) if self.tp > 1 else x

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """(B, S) over the whole batch → this rank's (B/dp, S/sp) block."""
        B, S = t.shape
        if B % self.dp or S % self.sp:
            raise ValueError(f"tokens ({B}, {S}) do not divide over "
                             f"dp={self.dp} and sp={self.sp}")
        b, s = B // self.dp, S // self.sp
        return t[self.dp_rank * b:(self.dp_rank + 1) * b,
                 self.sp_rank * s:(self.sp_rank + 1) * s]

    def lookup(self, embed: torch.Tensor, tokens: torch.Tensor):
        """The vocab-parallel lookup: this rank's rows, zeros for tokens
        another rank holds, summed over tp."""
        if self.tp == 1:
            return embed[tokens]
        rows = embed.shape[0]
        idx = tokens - self.tp_rank * rows
        inside = (idx >= 0) & (idx < rows)
        x = embed[idx.clamp(0, rows - 1)]
        return self.from_tp(torch.where(inside[..., None], x, 0.0))

    def cross_entropy(self, logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """Per-token logsumexp − gold over this rank's vocab columns
        (b, s, V/tp), summed over tp.  Every tp rank holds the same
        result, so the sums are *g*: backward, each rank's cotangent is
        its own columns' (no all-gather of the logits, whose backward
        would sum tp copies)."""
        if self.tp == 1:
            lse = torch.logsumexp(logits, dim=-1)
            return lse - torch.gather(logits, -1, targets[..., None])[..., 0]
        m = pmax(logits.detach().amax(dim=-1), "tp", self.mesh)
        total = self.from_tp(torch.exp(logits - m[..., None]).sum(dim=-1))
        cols = logits.shape[-1]
        idx = targets - self.tp_rank * cols
        inside = (idx >= 0) & (idx < cols)
        gold = torch.gather(logits, -1, idx.clamp(0, cols - 1)[..., None])
        gold = self.from_tp(torch.where(inside, gold[..., 0], 0.0))
        return torch.log(total) + m - gold

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """*g* over dp × sp: the global loss from each rank's part."""
        return reduce_from(x, self.data) if self.data is not None else x

    def sync(self, grads: Sequence[torch.Tensor]) -> None:
        """The native gradient sync, in place: a sum over dp × sp."""
        if self.data is None:
            return
        for g in grads:
            # comm-lint: disable=CL001 the native mesh step's gradient sum over dp x sp, the psums GSPMD inserts in the reference's jitted step, where neither the reference's extractor nor its traffic plane sees them; the audited grad-sync tiers are parallel/overlap's
            dist.all_reduce(g, group=self.data)


def _plan(mesh: Optional[DeviceMesh], cfg: Config) -> Optional[_Plan]:
    """None without a mesh; else the mesh's plan, after the refusals."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: a torch.distributed DeviceMesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    _check_moe_mesh(cfg, mesh)
    if cfg.loss_chunk:
        # the reference's refusal: the seq slicing would cross sp shards
        raise ValueError("loss_chunk is only supported single-controller "
                         "with mlp='dense' (got mesh=set); unset loss_chunk "
                         "for this path")
    sp, tp = axis_size(mesh, "sp"), axis_size(mesh, "tp")
    if cfg.tp_overlap == "fused":
        _check_fused(cfg, mesh)
    _check_tp(cfg, tp)
    if cfg.attn != "ring" and sp > 1 and (cfg.n_heads // tp) % sp:
        raise ValueError(
            f"attn={cfg.attn!r} on a mesh with sp={sp} runs Ulysses "
            f"attention over sp, which splits this rank's "
            f"{cfg.n_heads // tp} heads (n_heads {cfg.n_heads} / tp={tp}): "
            f"they are not divisible by sp={sp}")
    return _Plan(mesh, cfg)


_MOE_AXES = ("dp", "sp", "ep", "tp")


def _check_moe_mesh(cfg: Config, mesh: DeviceMesh) -> None:
    """mlp='moe' on a mesh (the native step) runs ``moe_block_mesh``: its
    axes must be among dp, sp, ep and tp (the experts cut over ep, their
    features over tp, the batch over dp × sp), and the experts must
    divide over ep."""
    if cfg.mlp != "moe":
        return
    other = [a for a in mesh.mesh_dim_names if a not in _MOE_AXES]
    if other:
        raise ValueError(
            f"mlp='moe' on a mesh takes axes among {_MOE_AXES}; "
            f"{tuple(other)} are not one of them (mesh axes: "
            f"{tuple(mesh.mesh_dim_names)})")
    ep = axis_size(mesh, "ep")
    if cfg.n_experts % ep:
        raise ValueError(f"Config.n_experts={cfg.n_experts} does not "
                         f"divide over ep={ep}")


def _check_fused(cfg: Config, mesh: Optional[DeviceMesh]) -> None:
    """The reference's refusals of tp_overlap='fused' that the mesh and
    the config decide (the sequence's is checked per call)."""
    if mesh is None or "tp" not in mesh.mesh_dim_names:
        raise ValueError(
            "tp_overlap='fused' needs a mesh with a tp axis "
            f"(got mesh={'set' if mesh is not None else None})")
    tp = axis_size(mesh, "tp")
    dims = {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}
    if tp < 2:
        raise ValueError("tp_overlap='fused' needs a tp mesh axis of "
                         f"size >= 2 (mesh axes: {dims})")
    if cfg.attn != "dense" or cfg.mlp != "dense":
        raise ValueError(
            "tp_overlap='fused' supports dense attention + dense MLP "
            f"only (got attn={cfg.attn!r}, mlp={cfg.mlp!r})")
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tp_overlap='fused' needs n_heads ({cfg.n_heads}) and d_ff "
            f"({cfg.d_ff}) divisible by tp={tp}")
    if axis_size(mesh, "sp") > 1:
        # the fused layer attends its rank's whole running sequence; the
        # reference replicates it over sp, the port shards tokens over sp
        raise ValueError(
            f"tp_overlap='fused' runs on sp = 1 only (mesh axes: {dims}): "
            f"its attention is this rank's sequence, and the port cuts the "
            f"sequence over sp")


def _check_tp(cfg: Config, tp: int) -> None:
    for name in ("n_heads", "d_ff", "vocab"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"Config.{name}={getattr(cfg, name)} does not "
                             f"divide over tp={tp}")


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


def rope_rows(x, positions, base):
    """``_rope`` with PER-ROW positions: x (..., b, h, d), positions (b,) —
    the decode-path variant where every batch row sits at its own sequence
    position.  Same rotation math as ``_rope``."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(ang).unsqueeze(-2)                 # (b, 1, half)
    sin = torch.sin(ang).unsqueeze(-2)
    x1, x2 = x[..., :half], x[..., half:]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


def decode_attention(q, k, v, q_pos):
    """One decode step of the attention core against a paged KV view: q
    (..., b, hl, hd) is the new token per batch slot, k/v (..., b, L, hl,
    hd) the slot's gathered cache pages flattened to L key positions,
    q_pos (b,) the token's absolute position (−1 for an inactive slot —
    fully masked, output garbage the scheduler discards).  Query b attends
    key slots l ≤ q_pos[b] (itself included: the engine writes the new k/v
    before attending), ``attention_reference``'s causal row for position
    q_pos.  Heads stay tp-sharded, so the op is local."""
    # sqrt(hd) rounded to q's dtype, as the reference divides; a Python
    # scalar, so no host-to-device copy stalls the stream
    scale = torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype).item()
    scores = torch.einsum("...bnd,...blnd->...bnl", q, k) / scale
    L = k.shape[-3]
    mask = (torch.arange(L, device=q.device)[None, :]
            <= q_pos[:, None])                         # (b, L)
    scores = scores.masked_fill(~mask[:, None, :], -1e30)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("...bnl,...blnd->...bnd", w, v)


def _attn_apply(x, layer, cfg: Config, mesh: Optional[_Plan] = None):
    """Attention half of the decoder layer, residual included.  On a mesh
    x is this rank's (b/dp, s/sp, d), replicated over tp, and the layer
    holds its tp shards."""
    b, s = x.shape[0], x.shape[1]
    heads = cfg.n_heads
    positions = torch.arange(s, device=x.device)
    h = _rms_norm(x, layer["attn_norm"])
    if mesh is not None:
        heads //= mesh.tp
        positions = positions + mesh.sp_rank * s       # global positions
        h = mesh.to_tp(h)
    qkv = h @ layer["wqkv"].to(cfg.dtype)            # (b, s, 3*heads*hd)
    q, k, v = (t.reshape(b, s, heads, cfg.head_dim)
               for t in qkv.chunk(3, dim=-1))
    q = _rope(q, positions, cfg.rope_base)
    k = _rope(k, positions, cfg.rope_base)
    if cfg.attn == "flash":
        attn = lambda q, k, v: flash_mha(
            q, k, v, True, None, cfg.attn_block, cfg.attn_block, None,
            cfg.attn_bwd_block, cfg.attn_bwd_block)
    else:
        attn = lambda q, k, v: attention_reference(q, k, v, causal=True)
    if mesh is not None and mesh.ring:
        att = ring_attention(q, k, v, mesh.mesh, "sp", causal=True,
                             batch_axis=mesh.axis("dp"),
                             head_axis=mesh.axis("tp"))
    elif mesh is not None and mesh.ulysses:
        att = ulysses_attention(q, k, v, mesh.mesh, "sp", attn_fn=attn)
    else:
        att = attn(q, k, v)
    att = att.reshape(b, s, heads * cfg.head_dim)
    out = att @ layer["wo"].to(cfg.dtype)
    return x + (out if mesh is None else mesh.from_tp(out))


def _layer_apply_fused(x, layer, cfg: Config, mesh: _Plan):
    """The tp_overlap='fused' decoder layer: Megatron sequence parallelism
    with the collectives fused into the products.  x is this rank's
    (b/dp, s/tp, d) rows of the residual stream.  Each column-parallel
    product (qkv, gate, up) is an ``allgather_matmul`` (the ring gather
    overlaps the products) and each row-parallel one (wo, down) a
    ``matmul_reduce_scatter`` (partial sums ride the ring), so no
    standalone all-gather or sum waits on the products.  The norms run on
    the rank's rows, so their weights' gradients sum over tp (*f*).  Ring
    direction per call site (native | bidir) comes from the decision layer
    under the coll name ``collmm``."""
    tp = mesh.tp
    b, s_local = x.shape[0], x.shape[1]
    s = s_local * tp
    heads = cfg.n_heads // tp
    positions = torch.arange(s, device=x.device)
    # per-rank ring payload of the sequence-cut activations: the byte
    # count DEVICE_RULES rows for `collmm` match against
    shard_bytes = b * s_local * cfg.d_model * cfg.dtype.itemsize
    bidir_ok = s_local % 2 == 0

    def bidir(kind: str) -> bool:
        return overlap.decide_collmm(kind, shard_bytes, mesh.mesh, "tp",
                                     bidir_ok) == "bidir"

    def norm(x, w):
        return _rms_norm(x, mesh.to_tp(w))

    def ag(h, w, kind):
        return allgather_matmul(h, w.to(cfg.dtype), "tp", mesh.mesh,
                                bidirectional=bidir(kind))

    def rs(h, w, kind):
        return matmul_reduce_scatter(h, w.to(cfg.dtype), "tp", mesh.mesh,
                                     bidirectional=bidir(kind))

    h = norm(x, layer["attn_norm"])
    qkv = ag(h, layer["wqkv"], "qkv")                   # (b, s, 3·hl·hd)
    q, k, v = (t.reshape(b, s, heads, cfg.head_dim)
               for t in qkv.chunk(3, dim=-1))
    q = _rope(q, positions, cfg.rope_base)
    k = _rope(k, positions, cfg.rope_base)
    # full-sequence attention on this rank's heads: the fused products
    # bracket it
    att = attention_reference(q, k, v, causal=True)
    x = x + rs(att.reshape(b, s, heads * cfg.head_dim), layer["wo"], "wo")
    h = norm(x, layer["mlp_norm"])
    gate = torch.nn.functional.silu(ag(h, layer["w_gate"], "gate"))
    up = ag(h, layer["w_up"], "up")
    return x + rs(gate * up, layer["w_down"], "down")


def _layer_apply(x, layer, cfg: Config, mesh: Optional[_Plan] = None):
    """One decoder layer: (x, router aux), the aux None with the dense
    (SwiGLU) MLP."""
    if cfg.tp_overlap == "fused":
        if mesh is None:
            _check_fused(cfg, None)
        return _layer_apply_fused(x, layer, cfg, mesh), None
    x = _attn_apply(x, layer, cfg, mesh)
    h = _rms_norm(x, layer["mlp_norm"])
    if "moe" in layer:
        block = (moe_block if mesh is None else functools.partial(
            moe_block_mesh, plan=mesh))
        out, aux = block(h, layer["moe"], cfg.n_experts, cfg.moe_top_k,
                         cfg.moe_capacity_factor)
        return x + out, aux
    if mesh is not None:
        h = mesh.to_tp(h)
    gate = torch.nn.functional.silu(h @ layer["w_gate"].to(cfg.dtype))
    up = h @ layer["w_up"].to(cfg.dtype)
    out = (gate * up) @ layer["w_down"].to(cfg.dtype)
    return x + (out if mesh is None else mesh.from_tp(out)), None


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


def _backbone(params, tokens, cfg: Config, embed,
              mesh: Optional[_Plan] = None):
    """tokens (b, s) → (hidden (b, s, d) after the final norm, the layers'
    summed router aux; None with the dense MLP).  Under
    tp_overlap='fused' the layers run on this rank's rows of the sequence,
    cut after the lookup and gathered before the final norm."""
    x = embed[tokens] if mesh is None else mesh.lookup(embed, tokens)
    fused = mesh is not None and mesh.fused
    if fused:
        if x.shape[1] % mesh.tp:
            raise ValueError(
                f"tp_overlap='fused' sequence-shards the residual over tp: "
                f"running seq {x.shape[1]} must be divisible by "
                f"tp={mesh.tp} (the training loss drops one position — "
                f"pick cfg.seq = k*tp + 1)")
        x = split_to(x, 1, "tp", mesh.mesh)
    layer_fn = _remat_wrap(lambda x, layer: _layer_apply(x, layer, cfg, mesh),
                           cfg.remat)
    aux_total = None
    for layer in params["layers"]:
        x, aux = layer_fn(x, layer)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    if fused:
        x = gather_from(x, 1, "tp", mesh.mesh)
    return _rms_norm(x, params["final_norm"]), aux_total


def _prepare(params, tokens, device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    check_on(optim.tree_leaves(params), dev, "params")
    return torch.as_tensor(tokens, dtype=torch.long, device=dev)


def forward(params: Dict[str, Any], tokens, cfg: Config,
            device: DeviceLike = None,
            mesh: Optional[DeviceMesh] = None):
    """tokens (batch, seq) → logits (batch, seq, vocab) float32; with
    ``cfg.mlp == "moe"`` → (logits, router aux loss).  Runs on ``device``
    (``None`` = cuda), where ``params`` must already lie.  On a ``mesh``
    every rank passes the whole batch and its ``shard_params`` shards, and
    gets its block of the logits: (batch/dp, seq/sp, vocab/tp)."""
    tokens = _prepare(params, tokens, device)
    plan = _plan(mesh, cfg)
    embed = params["embed"].to(cfg.dtype)
    if plan is not None:
        tokens = plan.local(tokens)
    x, aux = _backbone(params, tokens, cfg, embed, plan)
    if plan is not None:
        x = plan.to_tp(x)
    logits = (x @ embed.T).float()                    # tied embedding
    return (logits, aux) if cfg.mlp == "moe" else logits


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
            device: DeviceLike = None,
            mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in logsumexp form; with
    ``cfg.loss_chunk`` the chunked form, which never holds the whole
    logits.  On a ``mesh`` every rank passes the whole (batch, seq + 1)
    batch and gets the global mean; backward, each rank's graph carries
    its own tokens' share (``reduce_from`` over dp × sp)."""
    tokens = _prepare(params, tokens, device)
    plan = _plan(mesh, cfg)
    targets = tokens[:, 1:]
    if cfg.loss_chunk:
        # the reference's refusal: the MoE loss carries the router aux
        if cfg.mlp == "moe":
            raise ValueError(
                "loss_chunk is only supported single-controller with "
                f"mlp='dense' (got mesh=None, mlp={cfg.mlp!r}); unset "
                "loss_chunk for this path")
        embed = params["embed"].to(cfg.dtype)
        x, _ = _backbone(params, tokens[:, :-1], cfg, embed)
        return _chunked_ce(x, embed, targets, int(cfg.loss_chunk))
    out = forward(params, tokens[:, :-1], cfg, tokens.device, mesh)
    logits, aux = out if cfg.mlp == "moe" else (out, None)
    if plan is not None:
        ce = plan.cross_entropy(logits, plan.local(targets))
        ce = plan.data_sum(ce.sum() / targets.numel())
        if aux is None:
            return ce
        # the aux is the global value on every rank: it enters once, beside
        # the sum over dp × sp (inside it, it would count dp·sp times); its
        # backward carries this rank's tokens' share (moe_block_mesh)
        return ce + moe_plane.aux_weight(cfg.moe_aux_weight) * aux
    ce = _cross_entropy(logits, targets)
    if aux is None:
        return ce
    # the aux weight reads through the MoE plane's live adaptation
    # (the identity while the plane is off)
    return ce + moe_plane.aux_weight(cfg.moe_aux_weight) * aux


def _cross_entropy(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in logsumexp form."""
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
        logits = forward(params, toks, cfg, dev)
        if cfg.mlp == "moe":
            logits = logits[0]
        nxt = logits[:, -1].argmax(dim=-1)
        out.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).tolist() if out else [[] for _ in prompts]


# -- training -----------------------------------------------------------------

def value_and_grad(params: Dict[str, Any], tokens: torch.Tensor, cfg: Config,
                   device: DeviceLike = None,
                   mesh: Optional[DeviceMesh] = None,
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``(loss, grads)`` of ``loss_fn`` over the f32 master leaves, the
    grads in the order of ``optim.tree_leaves(params)``; the leaves leave
    with ``requires_grad`` off, as they came.  On a ``mesh``: the global
    loss and the gradients of this rank's shards, summed over dp × sp."""
    dev = resolve_device(device)
    plan = _plan(mesh, cfg)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, tokens, cfg, dev, mesh)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    if plan is not None:
        plan.sync(grads)
    return loss.detach(), grads


def _quant_grad_sync(cfg: Config, mesh: DeviceMesh,
                     dev: torch.device) -> Callable:
    """value-and-grad with the dp sum carried by the block-quantized tier:
    this rank's loss on its dp rows (no mesh inside), each leaf's gradient
    averaged over dp by ``coll/quant.psum_quant`` after the backward, the
    loss averaged exactly (a scalar).  dp-only, as the reference."""
    from ..coll.quant import psum_quant

    n = overlap.check_dp_mesh(mesh, "grad_sync='quant'")
    if axis_size(mesh, "dpo") > 1:
        # the reference's per-leaf quant sync is over dp alone, so it
        # refuses an outer dpo axis as it refuses any other
        raise ValueError(
            "grad_sync='quant' is dp-only: the sync over dp would "
            f"replicate axis 'dpo' (size {axis_size(mesh, 'dpo')}) and undo "
            "its parameter sharding; use grad_sync='native' on dp×tp/sp "
            "meshes")
    group = mesh.get_group("dp")

    def vg(params, tokens):
        local = overlap.dp_batch(torch.as_tensor(tokens), mesh)
        loss, grads = value_and_grad(params, local, cfg, dev)
        grads = tuple(psum_quant(g, group, n, avg=True,
                                 block=cfg.grad_sync_block) for g in grads)
        return overlap.pmean(loss, group, n), grads

    return vg


def make_value_and_grad(cfg: Config, mesh: Any = None,
                        device: DeviceLike = None) -> Callable:
    """``vg(params, tokens) -> (loss, grads)`` as the train step takes it
    for ``cfg.grad_sync``, the grads in ``optim.tree_leaves`` order:
    "native" is ``value_and_grad`` (on a mesh the exact sum over dp × sp);
    the others need a dp-only mesh (see the module docstring), where every
    rank passes the whole batch.  Making it is collective on a mesh."""
    if cfg.grad_sync not in _GRAD_SYNC:
        raise ValueError(f"unknown grad_sync {cfg.grad_sync!r} "
                         f"(expected one of {_GRAD_SYNC})")
    if cfg.tp_overlap == "fused" and cfg.grad_sync != "native":
        # the explicit grad-sync schedulers run the loss with no mesh
        # inside: the fused layer cannot run there
        raise ValueError(
            f"tp_overlap='fused' requires grad_sync='native' "
            f"(got {cfg.grad_sync!r}): the dp-only grad sync runs the "
            "loss without the fused layer's mesh")
    dev = resolve_device(device)
    if cfg.grad_sync == "native":
        _plan(mesh, cfg)
        return lambda params, tokens: value_and_grad(params, tokens, cfg,
                                                     dev, mesh)
    if mesh is None:
        raise ValueError(f"grad_sync={cfg.grad_sync!r} requires a mesh "
                         "(single-controller has no dp axis to sync)")
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: a torch.distributed DeviceMesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    if cfg.grad_sync == "quant":
        return _quant_grad_sync(cfg, mesh, dev)
    return overlap.make_grad_sync(
        cfg.grad_sync, mesh,
        lambda params, tokens: loss_fn(params, tokens, cfg, dev),
        bucket_bytes=cfg.grad_bucket_bytes, quant_block=cfg.grad_sync_block)


def make_train_step(cfg: Config, mesh: Any = None,
                    learning_rate: float = 1e-3, device: DeviceLike = None,
                    ) -> Tuple[Callable, Callable]:
    """Returns ``(init_opt, step)``, the counterpart of the JAX package's
    ``make_train_step`` (``optax.adamw(learning_rate,
    mu_dtype=cfg.opt_moment_dtype)``).  ``step(params, opt_state, tokens)``
    takes value-and-grad of ``loss_fn`` over the f32 master leaves on
    ``device`` (``None`` = cuda, where ``params`` must lie) and applies
    AdamW in place; it returns ``(params, opt_state, loss)``.

    With a ``mesh`` every rank of it calls ``step`` with its
    ``shard_params`` shards and the whole (batch, seq + 1) batch, and gets
    the global mean loss; the gradients move as ``cfg.grad_sync`` says
    (``make_value_and_grad``) and AdamW, elementwise, runs on each rank's
    shards.  Making the step is collective.  With ``mlp="moe"`` the step
    differentiates the einsum block whatever ``moe_impl`` names, as the
    reference's does.  With the perf plane on (``perf.enabled``) each
    step is timed to completion and folded into the goodput ledger
    (``perf.record_step``: tokens, ``train_flops_per_token``,
    ``perf.peak_tflops()``); off, the step is one attribute read away
    from the plain one."""
    if cfg.mlp == "moe" and cfg.moe_impl not in ("einsum", "ragged"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r} "
                         "(expected 'einsum' or 'ragged')")
    vg = make_value_and_grad(cfg, mesh, device)

    def init_opt(params):
        return optim.adamw_init(params, cfg.opt_moment_dtype)

    def step(params, opt_state, tokens):
        loss, grads = vg(params, tokens)
        optim.adamw_update(params, list(grads), opt_state, learning_rate)
        return params, opt_state, loss

    fpt = train_flops_per_token(cfg)

    def timed_step(params, opt_state, tokens):
        from .. import perf
        if not perf.enabled:
            return step(params, opt_state, tokens)
        # goodput/MFU ledger: the step's wall to completion (on the card,
        # a synchronize closes it).  Only wall + token FLOPs are
        # measurable from one step — the comm split is never fabricated.
        t0 = time.perf_counter()
        out = step(params, opt_state, tokens)
        if out[2].is_cuda:
            torch.cuda.synchronize()
        perf.record_step(time.perf_counter() - t0,
                         tokens=tokens.shape[0] * max(tokens.shape[1] - 1,
                                                      1),
                         flops_per_token=fpt,
                         peak_tflops=perf.peak_tflops())
        return out

    return init_opt, timed_step


# -- the ragged expert-parallel forward (moe_impl="ragged") -------------------

def moe_forward_ep(dc, params: Dict[str, Any], tokens, cfg: Config,
                   step: Optional[int] = None, rows: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with every MoE layer on the ragged expert-parallel
    exchange of ``dc`` (``models/moe.moe_block_ep``): the token payloads
    travel the audited ``moe_dispatch``/``moe_combine`` instead of the
    dense einsum block.  Returns (logits (b, s, vocab) f32, router aux).

    Every process of ``dc`` passes the whole (b, s) batch and the whole
    tree but for the experts, of which it holds its rows' own
    (``moe.local_experts``); it runs the attention on the whole batch, as
    the reference's single controller does, hands its rows of the
    canonical (R, t, d) layout (R = ``rows``, one a process by default;
    t = b·s/R) to ``moe_block_ep`` and gathers every row's mixture back.
    Runs on the comm's device; not differentiated."""
    if cfg.mlp != "moe":
        raise ValueError("moe_forward_ep needs cfg.mlp='moe' "
                         f"(got {cfg.mlp!r})")
    from .moe import _all_rows, moe_block_ep
    R = dc.n if rows is None else int(rows)
    if R % dc.n:
        raise ValueError(f"moe_forward_ep: {R} rows do not divide over "
                         f"the comm's {dc.n} processes")
    r = R // dc.n
    tokens = _prepare(params, tokens, dc.device)
    b, s = tokens.shape
    if (b * s) % R:
        raise ValueError(f"moe_forward_ep: batch·seq {b * s} not divisible "
                         f"by the {R} rows")
    t = (b * s) // R
    embed = params["embed"].to(cfg.dtype)
    aux_total = None
    with torch.no_grad():
        x = embed[tokens]                                 # (b, s, d)
        d = x.shape[-1]
        for layer in params["layers"]:
            x = _attn_apply(x, layer, cfg)
            h = _rms_norm(x, layer["mlp_norm"]).reshape(R, t, d)
            mine = h[dc.pos * r:(dc.pos + 1) * r]
            out, aux, _info = moe_block_ep(
                dc, mine, layer["moe"], cfg.n_experts, cfg.moe_top_k,
                cfg.moe_capacity_factor, step=step)
            x = x + _all_rows(dc, out).reshape(b, s, d)
            aux_total = aux if aux_total is None else aux_total + aux
        x = _rms_norm(x, params["final_norm"])
        return (x @ embed.T).float(), aux_total


def moe_eval_loss(dc, params: Dict[str, Any], tokens, cfg: Config,
                  step: Optional[int] = None,
                  rows: Optional[int] = None) -> torch.Tensor:
    """``loss_fn``'s ragged-arm counterpart: the same logsumexp-form
    cross-entropy plus the aux term, the MoE layers on ``moe_forward_ep``
    and the aux weight read live through the MoE plane each call."""
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dc.device)
    logits, aux = moe_forward_ep(dc, params, tokens[:, :-1], cfg, step=step,
                                 rows=rows)
    return (_cross_entropy(logits, tokens[:, 1:])
            + moe_plane.aux_weight(cfg.moe_aux_weight) * aux)
