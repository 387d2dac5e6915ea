"""Flash attention for the port: the K1, K2, K3 and K4 kernels and their
plain versions.

Counterpart of ``ompi_tpu/ops/attention.py``.  Entry points:

  * ``flash_attention`` — normalised attention over (batch, seq, heads,
    head_dim), cross-attention (s_q ≠ s_k) and a top-left causal mask
    allowed.  On a CUDA tensor it launches the hand-written Hopper kernel
    ``csrc/flash_attention.cu`` (K4, K1's tile loop with a normalising
    epilogue), which reads q, k and v through their strides and writes
    (batch, seq, heads, head_dim) itself; on a CPU tensor it folds batch
    and heads and runs ``flash_attention_reference``.
  * ``flash_attention_partials`` — the *un-normalised* (o, m, l) triple of a
    Q shard against one visiting K/V shard, with global position offsets
    for the causal mask: the per-hop block compute of ring attention and
    the core of ``flash_mha``.  On a CUDA tensor it launches the
    hand-written Hopper kernel ``csrc/flash_partials.cu`` (K1); on a CPU
    tensor it runs ``flash_attention_partials_reference``.
  * ``flash_mha_bwd_dkdv`` and ``flash_mha_bwd_dq`` — the FlashAttention-2
    backward, split in two as the JAX package splits it: dK/dV (K2) and dQ
    (K3), both in ``csrc/flash_bwd.cu``, recomputing p from the saved row
    logsumexp.  bf16 at head_dim ≤ 128 runs the Hopper kernels of
    ``csrc/flash_bwd_sm90.cuh`` (tiles: ``flash_bwd_tile`` in the built
    library); bf16 above it and float32 run the simple loops.  On a CPU
    tensor they run their ``*_reference`` versions.
  * ``flash_mha`` — differentiable flash attention over (batch, seq, heads,
    head_dim): a ``torch.autograd.Function`` whose forward is K1 plus the
    normalising epilogue and whose backward is δ = Σ dO·O, then K2, then K3
    (the counterpart of the JAX ``custom_vjp``).

The plain versions run the same blocked algorithms as the TPU kernels: the
block_q × block_k tile loop with the causal block skip, the finite
``NEG_INF`` mask, f32 softmax state and accumulators, and p (and ds in the
backward) cast to the storage dtype before their products.  Their products
take the storage-dtype operands exactly into f32 (an f32 product of two
bf16 values is exact), which is what the TPU's MXU and the Hopper tensor
cores do with f32 accumulation.

Two devices of the TPU kernels are not carried over: ``_auto_block`` (a
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

# Launches since a count was last set to 0: one per kernel launch, counted
# only where the wrapper launches it.  K1, K2, K3 and K4 respectively.
launches = 0
dkdv_launches = 0
dq_launches = 0
attention_launches = 0

_DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_PARTIALS_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_float] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])
_DKDV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ATTENTION_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# The forward kernels' grid is (bh, q tiles): at most 65535 q tiles of
# their smallest tile (32 rows, float32).  The backward's simple loops
# (float32, bf16 above head_dim 128) take (tiles, bh), so bh is held to
# 65535 on every backward launch.
_MAX_FWD_SEQ = 65535 * 32
_MAX_BWD_BH = 65535


def _default_block(s: int) -> int:
    """The sequence clamped to 128; a sequence that 128 does not divide is
    one block (the plain versions only: the kernels have their own tile)."""
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


def _check_kernel_shape(what: str, dtype: torch.dtype, d: int,
                        positions=()) -> str:
    """Raise on what the CUDA kernels do not take; return the dtype suffix
    of the kernel's C entry point."""
    suffix = _DTYPE_SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"{what} on CUDA takes bfloat16 or float32, got "
                        f"{dtype}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"{what} on CUDA needs head_dim a multiple of 16 in "
                         f"[16, 256], got {d}")
    for x in positions:
        if not -2**31 <= x < 2**31:
            raise ValueError(f"positions must fit int32, got {x}")
    return suffix


def _check_bwd_grid(bh: int) -> None:
    if bh > _MAX_BWD_BH:
        raise ValueError(f"batch*heads {bh} exceeds the backward kernels' "
                         f"grid ({_MAX_BWD_BH})")


def _check_fwd_seq(what: str, s_q: int) -> None:
    if s_q > _MAX_FWD_SEQ:
        raise ValueError(f"{what} on CUDA takes at most {_MAX_FWD_SEQ} "
                         f"queries (65535 tiles of 32 rows), got {s_q}")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _strided_ready(t: torch.Tensor) -> torch.Tensor:
    """A (b, s, h, d) operand as K4 reads it in place: d contiguous, the
    base and every other stride 16-byte aligned (what a TMA tensor map and
    the float32 loop's 16-byte loads take).  Anything else is made
    contiguous first; strides of size-1 dimensions are never read."""
    size = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            n == 1 or (st * size) % 16 == 0
            for n, st in zip(t.shape[:-1], t.stride()[:-1])):
        return t
    return _ready(t)


def _strides(t: torch.Tensor):
    """Element strides (b, s, h) of a (b, s, h, d) operand; a size-1
    dimension, whose stride is never read, takes d's row length, which is
    16-byte aligned."""
    d = t.shape[-1]
    return [st if n > 1 else d for n, st in zip(t.shape[:-1], t.stride()[:-1])]


def _launch(lib_name: str, fn_name: str, argtypes, device, *args) -> None:
    """Call a kernel's C entry point on the current stream of ``device``
    and raise if the launch was refused."""
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        describe = getattr(lib, f"{lib_name}_error_string")
        describe.restype, describe.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} "
                           f"({describe(err).decode()})")


# -- K1: forward partials -----------------------------------------------------

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
    suffix = _check_kernel_shape(
        "flash_attention_partials", q.dtype, d,
        (q_offset, kv_offset, s_q + q_offset, s_k + kv_offset))
    _check_fwd_seq("flash_attention_partials", s_q)
    q, k, v = _ready(q), _ready(k), _ready(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((bh, s_q, d), **f32)
    m = torch.empty((bh, s_q), **f32)
    l = torch.empty((bh, s_q), **f32)
    if o.numel() == 0:
        return o, m, l
    _launch("flash_partials", f"flash_partials_{suffix}", _PARTIALS_ARGTYPES,
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), bh, s_q, s_k, d, float(scale),
            int(bool(causal)), int(q_offset), int(kv_offset))
    launches += 1
    return o, m, l


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) → (b·h, s, d): batch and heads folded, as the kernels
    take them."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _unfold(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(b·h, s, d) → (b, s, h, d), a view."""
    return x.reshape(b, h, *x.shape[1:]).transpose(1, 2)


def _check_shapes(q, k, v) -> None:
    """q (b, s_q, h, d) and k, v (b, s_k, h, d), or raise: the kernels
    index k and v by q's b·h and d."""
    b, _, h, d = q.shape
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _check_devices(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


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
    dev = _check_devices(q, k, v)
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _block_sizes(s_q, s_k, block_q, block_k)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if dev.type == "cuda":
        return _partials_cuda(q, k, v, causal, scale, q_offset, kv_offset)
    return flash_attention_partials_reference(
        q, k, v, causal, scale, q_offset, kv_offset, block_q, block_k)


# -- K4: flash_attention ------------------------------------------------------

def flash_attention_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = False, scale: Optional[float] = None,
        block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K4 on any device: (bh, s, d) inputs → the
    normalised output (bh, s_q, d) in q's dtype.  The blocked online
    softmax of K1's plain version at zero offsets, then the TPU kernel's
    epilogue: o / max(l, 1e-20), cast to q's dtype."""
    o, _, l = flash_attention_partials_reference(
        q, k, v, causal, scale, 0, 0, block_q, block_k)
    return (o / torch.clamp_min(l, 1e-20)[..., None]).to(q.dtype)


def _attention_cuda(q, k, v, causal, scale):
    """K4 on (b, s, h, d) operands as they lie: k and v cast only when
    their dtype is not q's, an operand copied only when its strides are
    not ones the kernel reads (``_strided_ready``).  Returns a new
    (b, s_q, h, d) tensor in q's dtype."""
    global attention_launches
    d = q.shape[-1]
    suffix = _check_kernel_shape("flash_attention", q.dtype, d,
                                 (q.shape[1], k.shape[1]))
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    _check_fwd_seq("flash_attention", s_q)
    k, v = (x if x.dtype == q.dtype else x.to(q.dtype) for x in (k, v))
    q, k, v = (_strided_ready(x) for x in (q, k, v))
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    _launch("flash_attention", f"flash_attention_{suffix}",
            _ATTENTION_ARGTYPES, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), b, h, s_q, s_k, d,
            *_strides(q), *_strides(k), *_strides(v), float(scale),
            int(bool(causal)))
    attention_launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Attention over (batch, seq, heads, head_dim) inputs.

    q may have a different sequence length than k/v (cross attention);
    ``causal`` assumes both sequences start at position 0, so row i sees
    the keys j ≤ i.  k and v are cast to q's dtype and the output comes in
    q's dtype.  A CUDA tensor launches K4 once, which reads the inputs
    through their strides, writes a new (b, s_q, h, d) output, tiles by its
    own fixed tile and masks the ragged edge itself; ``block_q``/``block_k``
    tile the plain version and raise ``ValueError`` for sequences they do
    not divide on either device.
    """
    dev = _check_devices(q, k, v)
    _check_shapes(q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _block_sizes(s_q, s_k, block_q, block_k)
    if dev.type == "cuda":
        return _attention_cuda(q, k, v, causal, scale)
    qf, kf, vf = (_fold(x).to(q.dtype) for x in (q, k, v))
    return _unfold(flash_attention_reference(qf, kf, vf, causal, scale,
                                             block_q, block_k), b, h)


# -- K2, K3: the backward -----------------------------------------------------

def _bwd_tiles(q, k, causal, block_q, block_k):
    """Shared set-up of the two plain backward versions: shapes, blocks and
    the causal mask of one tile pair."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    bq, bk = _block_sizes(s_q, s_k, block_q, block_k)

    def mask(s, q0, k0):
        if not causal:
            return s
        rows = q0 + torch.arange(bq, device=q.device)
        cols = k0 + torch.arange(bk, device=q.device)
        return torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)

    return bh, s_q, s_k, d, bq, bk, mask


def flash_mha_bwd_dkdv_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, delta: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None, block_q: Optional[int] = None,
        block_k: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 on any device: q/do (bh, s_q, d), k/v
    (bh, s_k, d), lse/delta (bh, s_q) f32 → dk, dv (bh, s_k, d) in q's
    dtype.  One kv tile at a time, looping over the q tiles."""
    bh, s_q, s_k, d, bq, bk, mask = _bwd_tiles(q, k, causal, block_q,
                                               block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.zeros((bh, s_k, d), **f32)
    dv = torch.zeros((bh, s_k, d), **f32)
    for k0 in range(0, s_k, bk or 1):
        kb, vb = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        dk_acc = torch.zeros((bh, bk, d), **f32)
        dv_acc = torch.zeros((bh, bk, d), **f32)
        for q0 in range(0, s_q, bq or 1):
            # causal block skip: this q block's last row is before the kv
            # block's first column
            if causal and q0 + bq - 1 < k0:
                continue
            qb, dob = qf[:, q0:q0 + bq], dof[:, q0:q0 + bq]
            s = mask(qb @ kb.transpose(1, 2) * scale, q0, k0)
            p = torch.exp(s - lse[:, q0:q0 + bq, None])
            dv_acc += p.to(dt).float().transpose(1, 2) @ dob
            dp = dob @ vb.transpose(1, 2)
            ds = p * (dp - delta[:, q0:q0 + bq, None]) * scale
            dk_acc += ds.to(dt).float().transpose(1, 2) @ qb
        dk[:, k0:k0 + bk] = dk_acc
        dv[:, k0:k0 + bk] = dv_acc
    return dk.to(dt), dv.to(dt)


def flash_mha_bwd_dq_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, delta: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None, block_q: Optional[int] = None,
        block_k: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K3 on any device → dq (bh, s_q, d) in q's
    dtype.  One q tile at a time, looping over the kv tiles."""
    bh, s_q, s_k, d, bq, bk, mask = _bwd_tiles(q, k, causal, block_q,
                                               block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    dq = torch.zeros((bh, s_q, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s_q, bq or 1):
        qb, dob = qf[:, q0:q0 + bq], dof[:, q0:q0 + bq]
        acc = torch.zeros((bh, bq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, s_k, bk or 1):
            if causal and q0 + bq - 1 < k0:
                break
            kb = kf[:, k0:k0 + bk]
            s = mask(qb @ kb.transpose(1, 2) * scale, q0, k0)
            p = torch.exp(s - lse[:, q0:q0 + bq, None])
            dp = dob @ vf[:, k0:k0 + bk].transpose(1, 2)
            ds = p * (dp - delta[:, q0:q0 + bq, None]) * scale
            acc += ds.to(dt).float() @ kb
        dq[:, q0:q0 + bq] = acc
    return dq.to(dt)


def _bwd_inputs(q, k, v, do, lse, delta, block_q, block_k):
    """Check the backward's inputs on any device; return the device."""
    dev = _check_devices(q, k, v, do, lse, delta)
    if not (k.dtype == v.dtype == do.dtype == q.dtype):
        raise TypeError(f"flash_mha backward needs uniform q/k/v/do dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"lse and delta must be float32, got {lse.dtype}, "
                        f"{delta.dtype}")
    bh, s_q, _ = q.shape
    if lse.shape != (bh, s_q) or delta.shape != (bh, s_q) or \
            do.shape != q.shape or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)}")
    _block_sizes(s_q, k.shape[1], block_q, block_k)
    return dev


def flash_mha_bwd_dkdv(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, delta: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None, block_q: Optional[int] = None,
        block_k: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV of flash attention (bh-folded inputs, zero offsets): K2 on a
    CUDA tensor, ``flash_mha_bwd_dkdv_reference`` on a CPU tensor.  The
    blocks tile the plain version; the kernel has its own tile."""
    global dkdv_launches
    dev = _bwd_inputs(q, k, v, do, lse, delta, block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dev.type == "cpu":
        return flash_mha_bwd_dkdv_reference(q, k, v, do, lse, delta, causal,
                                            scale, block_q, block_k)
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    suffix = _check_kernel_shape("flash_mha_bwd_dkdv", q.dtype, d, (s_q, s_k))
    _check_bwd_grid(bh)
    q, k, v, do, lse, delta = map(_ready, (q, k, v, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_bwd", f"flash_bwd_dkdv_{suffix}", _DKDV_ARGTYPES, dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, s_q, s_k, d, float(scale), int(bool(causal)))
    dkdv_launches += 1
    return dk, dv


def flash_mha_bwd_dq(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, delta: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None, block_q: Optional[int] = None,
        block_k: Optional[int] = None) -> torch.Tensor:
    """dQ of flash attention: K3 on a CUDA tensor,
    ``flash_mha_bwd_dq_reference`` on a CPU tensor."""
    global dq_launches
    dev = _bwd_inputs(q, k, v, do, lse, delta, block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dev.type == "cpu":
        return flash_mha_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                          scale, block_q, block_k)
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    suffix = _check_kernel_shape("flash_mha_bwd_dq", q.dtype, d, (s_q, s_k))
    _check_bwd_grid(bh)
    q, k, v, do, lse, delta = map(_ready, (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd", f"flash_bwd_dq_{suffix}", _DQ_ARGTYPES, dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s_q, s_k,
            d, float(scale), int(bool(causal)))
    dq_launches += 1
    return dq


# -- flash_mha ----------------------------------------------------------------

def _flash_mha_fwd(q, k, v, causal=False, scale=None, block_q=None,
                   block_k=None):
    """Forward of flash_mha: returns (out, residuals), the residuals being
    (qf, kf, vf, of, lse, (b, h)) as in the JAX package — the folded
    inputs, the normalised output ``of`` in q's dtype (δ is computed from
    it) and lse (b*h, s_q) f32."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_mha requires uniform q/k/v dtype, got q={q.dtype} "
            f"k={k.dtype} v={v.dtype}; cast inputs before calling")
    _check_shapes(q, k, v)
    b, _, h, _ = q.shape
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    o_un, m, l = flash_attention_partials(
        qf, kf, vf, causal=causal, scale=scale, block_q=block_q,
        block_k=block_k)
    l = torch.clamp_min(l, 1e-20)
    of = (o_un / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    return _unfold(of, b, h), (qf, kf, vf, of, lse, (b, h))


def _flash_mha_bwd(causal, scale, bwd_block_q, bwd_block_k, residuals, g):
    """Backward of flash_mha from the forward's residuals and the cotangent
    g (b, s_q, h, d): δ, then K2, then K3.  Returns dq, dk, dv."""
    qf, kf, vf, of, lse, (b, h) = residuals
    dof = _fold(g).to(qf.dtype)
    # δ_i = Σ_d dO·O, the dS correction term (FlashAttention-2 eq. 4), from
    # the output in q's dtype, as the JAX package computes it
    delta = (dof.float() * of.float()).sum(dim=-1)
    dk, dv = flash_mha_bwd_dkdv(qf, kf, vf, dof, lse, delta, causal, scale,
                                bwd_block_q, bwd_block_k)
    dq = flash_mha_bwd_dq(qf, kf, vf, dof, lse, delta, causal, scale,
                          bwd_block_q, bwd_block_k)
    return _unfold(dq, b, h), _unfold(dk, b, h), _unfold(dv, b, h)


class _FlashMha(torch.autograd.Function):
    """The counterpart of the JAX package's ``custom_vjp`` around
    ``flash_mha``: residuals q, k, v, o, lse — O(seq) memory, never the
    score matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, bwd_block_q,
                bwd_block_k):
        out, (qf, kf, vf, of, lse, bh) = _flash_mha_fwd(
            q, k, v, causal, scale, block_q, block_k)
        ctx.save_for_backward(qf, kf, vf, of, lse)
        # bwd tiles independently of fwd: the bwd override, else the fwd
        # override, else the default
        ctx.args = (causal, scale, bwd_block_q or block_q,
                    bwd_block_k or block_k, bh)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, scale, bq, bk, bh = ctx.args
        grads = _flash_mha_bwd(causal, scale, bq, bk,
                               (*ctx.saved_tensors, bh), g)
        return (*grads, None, None, None, None, None, None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None,
              block_q: Optional[int] = None, block_k: Optional[int] = None,
              bwd_block_q: Optional[int] = None,
              bwd_block_k: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention over (batch, seq, heads, head_dim).

    The same math as the JAX package's ``flash_mha``: the forward is the
    partials (K1) normalised by max(l, 1e-20) in q's dtype, and the
    backward recomputes p blockwise from the saved logsumexp in K2 (dK, dV)
    and K3 (dQ).  ``bwd_block_q``/``bwd_block_k`` tile the backward's plain
    versions independently of the forward (None = the forward's override,
    else the default).  The block arguments only tile the plain versions
    (CPU tensors): on CUDA tensors they are checked and have no effect, as
    the kernels keep their own tiles.  q, k and v must share one dtype."""
    return _FlashMha.apply(q, k, v, causal, scale, block_q, block_k,
                           bwd_block_q, bwd_block_k)
