"""Flash attention forward for the port: the K1 kernel and its plain version.

Counterpart of ``ompi_tpu/ops/attention.py``.  Two entry points so far:

  * ``flash_attention_partials`` — the *un-normalised* (o, m, l) triple of a
    Q shard against one visiting K/V shard, with global position offsets
    for the causal mask: the per-hop block compute of ring attention and
    the core of ``flash_mha``.  On a CUDA tensor it launches the
    hand-written Hopper kernel ``csrc/flash_partials.cu`` (K1); on a CPU
    tensor it runs ``flash_attention_partials_reference``.
  * ``flash_mha`` — flash attention over (batch, seq, heads, head_dim),
    forward only: the normalising epilogue over the partials.  Its
    backward (K2, K3) comes with the training slice.

``flash_attention_partials_reference`` runs the same blocked algorithm as
the TPU kernel: the block_q × block_k tile loop with the causal block skip,
the finite ``NEG_INF`` mask, the online-softmax (m, l, acc) state in f32,
and p cast to the storage dtype before the PV product.  Its products take
the storage-dtype operands exactly into f32 (an f32 product of two bf16
values is exact), which is what the TPU's MXU and the Hopper tensor cores
do with f32 accumulation.

Two devices of the TPU kernel are not carried over: ``_auto_block`` (a
block-size sweep measured on a TPU v5e) and ``check_tpu_block`` (the Mosaic
(8, 128) tiling rule).  Neither says anything about this card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30

# K1 launches since the count was last set to 0: one per kernel launch,
# counted only where the wrapper launches it.
launches = 0

_KERNEL_DTYPES = {torch.bfloat16: "flash_partials_bf16",
                  torch.float32: "flash_partials_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _default_block(s: int) -> int:
    """The sequence clamped to 128; a sequence that 128 does not divide is
    one block (the plain version only: the kernel has its own tile)."""
    b = min(s, 128)
    return b if b and s % b == 0 else s


def _block_sizes(s_q: int, s_k: int, block_q: Optional[int],
                 block_k: Optional[int]) -> Tuple[int, int]:
    """Resolve (block_q, block_k): explicit override, else the default,
    clamped to the sequence and checked for divisibility."""
    bq = min(block_q or _default_block(s_q), s_q)
    bk = min(block_k or _default_block(s_k), s_k)
    if (bq and s_q % bq) or (bk and s_k % bk):
        raise ValueError(f"seq lengths ({s_q},{s_k}) must divide into "
                         f"blocks ({bq},{bk})")
    return bq, bk


def flash_attention_partials_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = False, scale: Optional[float] = None,
        q_offset: int = 0, kv_offset: int = 0,
        block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 on any device: (bh, s, d) inputs →
    o (bh, s_q, d), m (bh, s_q), l (bh, s_q), all float32."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bq, bk = _block_sizes(s_q, s_k, block_q, block_k)
    dt = q.dtype
    qf = q.float()
    kf = k.to(dt).float()
    vf = v.to(dt).float()
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.zeros((bh, s_q, d), **f32)
    m = torch.full((bh, s_q), NEG_INF, **f32)
    l = torch.zeros((bh, s_q), **f32)
    for q0 in range(0, s_q, bq or 1):
        rows = q_offset + q0 + torch.arange(bq, device=q.device)
        qb = qf[:, q0:q0 + bq]
        m_i = m[:, q0:q0 + bq].clone()
        l_i = l[:, q0:q0 + bq].clone()
        acc = torch.zeros((bh, bq, d), **f32)
        for k0 in range(0, s_k, bk or 1):
            # causal block skip, as on the TPU: a kv block wholly after
            # this q block's last row contributes nothing
            if causal and q_offset + q0 + bq - 1 < kv_offset + k0:
                break
            s = qb @ kf[:, k0:k0 + bk].transpose(1, 2) * scale
            if causal:
                cols = kv_offset + k0 + torch.arange(bk, device=q.device)
                s = torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)
            m_cur = torch.maximum(m_i, s.amax(dim=-1))
            alpha = torch.exp(m_i - m_cur)
            p = torch.exp(s - m_cur[..., None])
            l_i = l_i * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(dt).float() @ vf[:, k0:k0 + bk]
            m_i = m_cur
        o[:, q0:q0 + bq] = acc
        m[:, q0:q0 + bq] = m_i
        l[:, q0:q0 + bq] = l_i
    return o, m, l


def _partials_cuda(q, k, v, causal, scale, q_offset, kv_offset):
    global launches
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    fn_name = _KERNEL_DTYPES.get(q.dtype)
    if fn_name is None:
        raise TypeError(f"flash_attention_partials on CUDA takes bfloat16 or "
                        f"float32, got {q.dtype}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"flash_attention_partials on CUDA needs head_dim a "
                         f"multiple of 16 in [16, 256], got {d}")
    if bh > 65535:
        raise ValueError(f"batch*heads {bh} exceeds the kernel grid's 65535")
    for x in (q_offset, kv_offset, s_q + q_offset, s_k + kv_offset):
        if not -2**31 <= x < 2**31:
            raise ValueError(f"positions must fit int32, got {x}")

    def ready(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    q, k, v = ready(q), ready(k), ready(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((bh, s_q, d), **f32)
    m = torch.empty((bh, s_q), **f32)
    l = torch.empty((bh, s_q), **f32)
    if o.numel() == 0:
        return o, m, l
    lib = _build.library("flash_partials")
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 m.data_ptr(), l.data_ptr(), bh, s_q, s_k, d, float(scale),
                 int(bool(causal)), int(q_offset), int(kv_offset), stream)
    if err:
        lib.flash_partials_error_string.restype = ctypes.c_char_p
        lib.flash_partials_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_partials_error_string(err).decode()
        raise RuntimeError(f"flash_partials launch failed: CUDA error {err} "
                           f"({msg})")
    launches += 1
    return o, m, l


def flash_attention_partials(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = False, scale: Optional[float] = None,
        q_offset: int = 0, kv_offset: int = 0,
        block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised flash partials for ring attention's merge step.

    q/k/v: (bh, seq, head_dim), batch and heads already folded.
    ``q_offset``/``kv_offset`` are the global positions (Python ints) of the
    local Q shard and the visiting K/V shard.  Returns (o, m, l): o
    un-normalised (bh, s_q, d), m and l (bh, s_q), all float32.  k and v are
    cast to q's dtype first.

    A CUDA tensor launches K1, which tiles by its own fixed tile and masks
    the ragged edge itself; ``block_q``/``block_k`` tile the plain version
    and raise ``ValueError`` for sequences they do not divide on either
    device.  A row that sees no key has m ≤ -1e29; its o and l are
    tiling-dependent garbage that a merge weights by zero.
    """
    if not (k.device == q.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _block_sizes(s_q, s_k, block_q, block_k)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if q.device.type == "cuda":
        return _partials_cuda(q, k, v, causal, scale, q_offset, kv_offset)
    if q.device.type == "cpu":
        return flash_attention_partials_reference(
            q, k, v, causal, scale, q_offset, kv_offset, block_q, block_k)
    raise ValueError(f"flash_attention_partials: unsupported device "
                     f"{q.device}")


def _flash_mha_fwd(q, k, v, causal=False, scale=None, block_q=None,
                   block_k=None):
    """Forward of flash_mha: returns (out, lse), lse (b*h, s_q) f32 being
    the residual the backward kernels of the training slice will read."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_mha requires uniform q/k/v dtype, got q={q.dtype} "
            f"k={k.dtype} v={v.dtype}; cast inputs before calling")
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    fold = lambda x, s: x.transpose(1, 2).reshape(b * h, s, d)
    o_un, m, l = flash_attention_partials(
        fold(q, s_q), fold(k, s_k), fold(v, s_k), causal=causal, scale=scale,
        block_q=block_q, block_k=block_k)
    l = torch.clamp_min(l, 1e-20)
    of = (o_un / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    return of.reshape(b, h, s_q, d).transpose(1, 2), lse


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None,
              block_q: Optional[int] = None,
              block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention over (batch, seq, heads, head_dim), forward only.

    The same math as the JAX package's ``flash_mha`` forward: partials,
    then o / max(l, 1e-20) in q's dtype.  Gradients need the backward
    kernels (K2, K3) and the ``torch.autograd.Function`` of the training
    slice, so an input that requires grad raises."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_mha has no backward yet: the training slice (ROADMAP "
            "P2, kernels K2/K3) brings it; run under torch.no_grad() or "
            "use attn='dense'")
    out, _ = _flash_mha_fwd(q, k, v, causal, scale, block_q, block_k)
    return out
