"""The port's ``flash_attention`` (ompi_tpu_torch.ops.attention, the entry
point of kernel K4) against the JAX package's, on the CPU.

The port runs its plain PyTorch version here (the tensors lie on the CPU);
the JAX side runs the Pallas kernel in interpret mode, as tests/test_ops.py
does.  Inputs are made with numpy from a seed and handed to both.

Tolerances: the cases of tests/test_ops.py ``TestFlashAttention`` keep its
shapes, blocks and figures — 2e-5 in f32 against both the JAX
``flash_attention`` and the dense ``attention_reference``, and in bf16 0.06
against the f32 reference of the same bf16 values.  bf16 is also held to
the JAX ``flash_attention`` at the same blocks to 1e-2 (rtol = atol): with
one tiling both sides round p to bf16 at the same running maxima, so they
differ only where an f32 value sits on a bf16 rounding boundary, by a bf16
step or two of the output (≤ 2^-6 of it) in a few elements (≤ 1e-3 here).

Left out on purpose: ``test_wrappers_enforce_it`` (tests/test_ops.py:376-384)
expects ``flash_attention(q, q, q, block_q=4)`` to raise "not
TPU-lowerable".  That is ``check_tpu_block``, the Mosaic (8, 128) tiling
rule of the TPU, which says nothing about the port: block_q=4 divides the
sequence, so the port's plain version takes it (``test_small_block``).  Nor
is the JAX default block pick ``_auto_block`` (a v5e sweep, which raises
for a long sequence that no power of two ≤ 1024 divides) carried over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.ops import attention as jax_attn
from ompi_tpu.parallel import ring as jax_ring
from ompi_tpu_torch.ops import attention as attn

F32_TOL = 2e-5
BF16_VS_F32_TOL = 0.06
BF16_SAME_BLOCKS_TOL = 1e-2
B, H, D = 2, 2, 16


def _inputs(s_q, s_k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, s_k, H, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# name: (s_q, s_k, causal, (block_q, block_k), dense reference applies).
# The first four are tests/test_ops.py TestFlashAttention's shapes and
# blocks; the rest are cross attention, where a causal mask is aligned at
# the top left and the dense reference (one sequence length) does not
# apply, and the default tiling.
CASES = {
    "matches_reference": (256, 256, False, (64, 64), True),
    "causal": (128, 128, True, (64, 64), True),
    "single_block": (64, 64, False, (64, 64), True),
    "bfloat16_blocks": (256, 256, False, (128, 128), True),
    "cross_sq_lt_sk": (64, 128, False, (64, 64), True),
    "cross_sq_gt_sk": (128, 64, False, (32, 64), True),
    "causal_sq_gt_sk": (128, 64, True, (64, 32), False),
    "causal_sq_lt_sk": (64, 128, True, (32, 64), False),
    "default_blocks": (256, 256, True, (None, None), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_matches_jax(case):
    s_q, s_k, causal, (bq, bk), dense = CASES[case]
    q, k, v = _inputs(s_q, s_k)
    got = attn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, block_q=bq, block_k=bk)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, jax_attn.flash_attention(jq, jk, jv, causal=causal,
                                         block_q=bq, block_k=bk,
                                         interpret=True), F32_TOL)
    if dense:
        _close(got, jax_ring.attention_reference(jq, jk, jv, causal=causal),
               F32_TOL)


@pytest.mark.parametrize("case", ["bfloat16_blocks", "causal",
                                  "causal_sq_gt_sk", "causal_sq_lt_sk"])
def test_bf16_matches_jax(case):
    """bf16 in, bf16 out: against the JAX kernel at the same blocks, and
    (where it applies) against the f32 dense reference of the same bf16
    values, the check of tests/test_ops.py ``test_bfloat16_inputs``."""
    s_q, s_k, causal, (bq, bk), dense = CASES[case]
    arrays = _inputs(s_q, s_k)
    got = attn.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrays),
        causal=causal, block_q=bq, block_k=bk)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    want = jax_attn.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                    block_k=bk, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16_SAME_BLOCKS_TOL)
    if dense:
        ref = jax_ring.attention_reference(
            *(x.astype(jnp.float32) for x in (jq, jk, jv)), causal=causal)
        _close(got, ref, BF16_VS_F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mixed_dtype_casts_kv_to_q(causal):
    """bf16 q with f32 k/v: k and v are cast to q's dtype, as in the JAX
    package, and the result is bf16."""
    q, k, v = _inputs(128, 64)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = attn.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                               block_k=64)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, attn.flash_attention(
        tq, tk.to(torch.bfloat16), tv.to(torch.bfloat16), causal=causal,
        block_q=64, block_k=64))
    want = jax_attn.flash_attention(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, block_q=64, block_k=64,
                                    interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(got, want, BF16_SAME_BLOCKS_TOL)


def test_small_block():
    """block_q=4 divides the sequence: the JAX wrapper refuses it only by
    its TPU tiling rule (left out, see the module docstring), so the port
    takes it and agrees with the JAX result at a lowerable block."""
    q, k, v = _inputs(64, 64)
    got = attn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               block_q=4)
    _close(got, jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                         block_q=64, interpret=True),
           F32_TOL)


def test_reference_is_the_folded_entry_point():
    """``flash_attention_reference`` on (bh, s, d) is ``flash_attention``
    with batch and heads folded, bit for bit."""
    q, k, v = map(torch.from_numpy, _inputs(64, 128))
    fold = lambda x: x.transpose(1, 2).reshape(B * H, x.shape[1], D)
    got = attn.flash_attention_reference(fold(q), fold(k), fold(v),
                                         causal=True)
    want = attn.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fold(want))


@pytest.mark.parametrize("blocks", [(48, 64), (64, 96)])
def test_blocks_must_divide_sequence(blocks):
    q, k, v = map(torch.from_numpy, _inputs(128, 128))
    with pytest.raises(ValueError, match="must divide into"):
        attn.flash_attention(q, k, v, block_q=blocks[0], block_k=blocks[1])


def test_refuses_bad_inputs():
    q, k, v = map(torch.from_numpy, _inputs(64, 64))
    for entry in (attn.flash_attention, attn.flash_mha):
        with pytest.raises(ValueError, match="shapes"):
            entry(q, k[:, :, :1], v[:, :, :1])
        with pytest.raises(ValueError, match="shapes"):
            entry(q, k, v[:, :32])
    meta = torch.empty((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attn.flash_attention(meta, meta, meta)


@pytest.mark.parametrize("dtype, d, s, error", [
    (torch.float16, 64, 64, TypeError), (torch.float32, 8, 64, ValueError),
    (torch.bfloat16, 272, 64, ValueError),
    (torch.bfloat16, 72, 64, ValueError),
    # the grid holds at most 65535 q tiles of 32 rows
    (torch.bfloat16, 16, 65535 * 32 + 1, ValueError)])
def test_kernel_refuses_what_it_does_not_take(dtype, d, s, error):
    """K4's launch path refuses a dtype, head_dim or sequence the kernel
    does not take before it touches a device (the (b, s, h, d) inputs here
    hold no data), so a CUDA tensor raises there rather than taking the
    plain version."""
    x = torch.empty((1, s, 2, d), dtype=dtype, device="meta")
    with pytest.raises(error):
        attn._attention_cuda(x, x, x, False, 1.0)


def test_grid_limits():
    """The forward kernels put b·h on the grid's x axis, which has no
    65535 cap; so do the backward's Hopper kernels (bf16, head_dim <= 128),
    while its simple loops keep b·h on y."""
    attn._check_fwd_seq("flash_attention", 65535 * 32)
    attn._check_bwd_grid("K2", torch.float32, 64, 65535, 128)
    with pytest.raises(ValueError, match="65535"):
        attn._check_bwd_grid("K2", torch.float32, 64, 65536, 128)


@pytest.mark.parametrize("dtype,d,bh,rows,ok", [
    # the Hopper kernels: bh on grid x, 128-row tiles on y
    (torch.bfloat16, 64, 65600, 128, True),
    (torch.bfloat16, 128, 2**20, 2048, True),
    (torch.bfloat16, 128, 4, 65535 * 128, True),
    (torch.bfloat16, 128, 4, 65535 * 128 + 1, False),
    # the wmma loop (bf16 above head_dim 128) and the float32 FMA loop:
    # (tiles, bh), so bh stays within 65535, loudly
    (torch.bfloat16, 256, 65535, 128, True),
    (torch.bfloat16, 256, 65536, 128, False),
    (torch.float32, 64, 65600, 128, False),
    (torch.float32, 128, 65600, 128, False)])
def test_bwd_grid_decision(dtype, d, bh, rows, ok):
    if ok:
        attn._check_bwd_grid("flash_mha_bwd_dq", dtype, d, bh, rows)
    else:
        with pytest.raises(ValueError, match="flash_mha_bwd_dq"):
            attn._check_bwd_grid("flash_mha_bwd_dq", dtype, d, bh, rows)


def _packed(b, s, h, d, n, dtype=torch.bfloat16):
    """n operands of (b, s, h, d), sliced from one (b, s, n, h, d) tensor
    as a fused projection leaves them."""
    x = torch.randn((b, s, n, h, d)).to(dtype)
    return [x[:, :, i] for i in range(n)]


def test_strided_ready_reads_views_in_place():
    """K4 reads a (b, s, h, d) operand through its strides when d is
    contiguous and the base and the other strides are 16-byte aligned;
    otherwise the operand is made contiguous first."""
    for t in _packed(2, 8, 3, 32, 3) + [
            torch.randn((2, 3, 8, 32)).transpose(1, 2),
            torch.randn((2, 8, 1, 32))[:, :, :, :16]]:
        got = attn._strided_ready(t)
        assert got.data_ptr() == t.data_ptr() and got.stride() == t.stride()
    odd_rows = torch.randn((2, 8, 3, 36)).to(torch.bfloat16)[..., :32]
    not_unit = torch.randn((2, 8, 3, 64))[..., ::2]
    shifted = torch.randn(2 * 8 * 3 * 32 + 1)[1:].view(2, 8, 3, 32)
    for t in (odd_rows, not_unit, shifted):
        got = attn._strided_ready(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, t)
    # a size-1 dimension's stride is never read: d's row length stands in
    t = torch.randn((1, 8, 1, 32))
    assert attn._strides(t) == [32, 32, 32]


# name: how q, k and v are laid out, as views of one tensor each
VIEWS = {
    "packed_qkv": lambda b, s, h, d: _packed(b, s, h, d, 3, torch.float32),
    "transposed": lambda b, s, h, d: [
        torch.randn((b, h, s, d)).transpose(1, 2) for _ in range(3)],
    "q_apart_packed_kv": lambda b, s, h, d: [
        torch.randn((b, s, h, d))] + _packed(b, s, h, d, 2, torch.float32),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_noncontiguous_views_match_jax(view, causal):
    """flash_attention on (b, s, h, d) views that are not contiguous (as a
    model passes them) equals the JAX flash_attention in interpret mode on
    the same values."""
    torch.manual_seed(3)
    q, k, v = VIEWS[view](B, 128, H, D)
    assert not q.is_contiguous() or not k.is_contiguous()
    got = attn.flash_attention(q, k, v, causal=causal, block_q=64,
                               block_k=64)
    jq, jk, jv = (jnp.asarray(x.contiguous().numpy()) for x in (q, k, v))
    want = jax_attn.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                    block_k=64, interpret=True)
    assert got.shape == q.shape
    _close(got, want, F32_TOL)


# Public names of the JAX package's attention module that the port leaves
# out, and why: each is a device of the TPU that says nothing about a GPU.
TPU_ONLY = {
    "check_tpu_block": "the Mosaic (8, 128) TPU tiling rule",
    "_auto_block": "a block-size sweep measured on a TPU v5e",
    "_auto_block_bwd": "the same sweep for the backward",
    "_default_interpret": "Pallas interpret mode off a TPU; the port's "
                          "counterpart is the plain version on a CPU tensor",
}


def _public(module):
    return {n for n, v in vars(module).items() if not n.startswith("_")
            and (getattr(v, "__module__", None) == module.__name__
                 or isinstance(v, (int, float)))}


def test_public_surface_has_counterparts():
    """Every public name of ompi_tpu.ops.attention has a counterpart of the
    same name in the port, apart from the TPU-only ones listed above."""
    public = _public(jax_attn)
    assert {"flash_attention", "flash_attention_partials", "flash_mha",
            "NEG_INF"} <= public
    assert all(hasattr(jax_attn, n) for n in TPU_ONLY)
    missing = {n for n in public - set(TPU_ONLY) if not hasattr(attn, n)}
    assert not missing
    assert not any(hasattr(attn, n) for n in TPU_ONLY)
    assert attn.NEG_INF == jax_attn.NEG_INF
