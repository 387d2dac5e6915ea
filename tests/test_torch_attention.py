"""The port's flash attention (ompi_tpu_torch.ops.attention) against the JAX
package's, on the CPU.

The port runs its plain PyTorch version here (the tensors lie on the CPU);
the JAX side runs the Pallas kernels in interpret mode, as tests/test_ops.py
does.  Inputs are made with numpy from a seed and handed to both.

Tolerances: f32 2e-5 and bf16 2e-2 on the normalised partials o/l (bf16:
p is rounded to bf16 before the PV product on both sides, and the two
accumulate in different orders), and the flash_mha forward to 2e-5 (f32) and
0.06 (bf16), the figures of tests/test_ops.py.  Partials are compared only
on rows that see at least one key: a fully masked row's o and l depend on
the tiling, and a merge weights them by zero.

Gradients (the backward's plain versions of K2 and K3 through autograd,
against jax.grad through the Pallas backward) are held to 2e-4 in f32, the
figure of tests/test_ops.py, and in bf16 to 2e-2 of the largest gradient:
both sides round p and ds to bf16 before their products at the same
tiling, so they differ by a bf16 rounding of the sums (2^-8 relative) in a
few elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.ops import attention as jax_attn
from ompi_tpu.parallel import ring as jax_ring
from ompi_tpu_torch.ops import attention as attn
from ompi_tpu_torch.parallel import ring

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _arrays(shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _both(arrays, dtype):
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _assert_partials_close(got, want, seen, tol):
    """(o, m, l) triples agree on the rows in ``seen`` (bh, s_q); rows that
    see no key have m ≤ -1e29 on both sides."""
    (o1, m1, l1), (o2, m2, l2) = [[_np(x) for x in t] for t in (got, want)]
    np.testing.assert_allclose(o1[seen] / l1[seen][:, None],
                               o2[seen] / l2[seen][:, None], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(m1[seen], m2[seen], rtol=tol, atol=tol)
    np.testing.assert_allclose(l1[seen], l2[seen], rtol=tol, atol=tol)
    assert (m1[~seen] <= -1e29).all() and (m2[~seen] <= -1e29).all()


def _seen(bh, s_q, causal, q_offset, kv_offset, s_k):
    rows = q_offset + np.arange(s_q)
    seen = (rows >= kv_offset) if causal else np.ones(s_q, bool)
    return np.broadcast_to(seen & (s_k > 0), (bh, s_q))


# (causal, q_offset, kv_offset, s_q, s_k): the offset cases of
# tests/test_ops.py plus a hop that sees nothing and partly masked hops
CASES = {
    "dense": (False, 0, 0, 128, 128),
    "causal": (True, 0, 0, 128, 128),
    "hop_fully_visible": (True, 128, 0, 128, 128),
    "hop_invisible": (True, 0, 128, 128, 128),
    "hop_partly_masked": (True, 0, 32, 128, 128),
    "hop_q_later": (True, 32, 0, 128, 128),
    "cross_sq_lt_sk": (False, 0, 0, 64, 128),
    "cross_causal": (True, 64, 0, 64, 128),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_jax(case, dtype):
    causal, q_off, kv_off, s_q, s_k = CASES[case]
    bh, d = 2, 16
    q, k, v = (_arrays((bh, s_q, d), 1, seed=1)
               + _arrays((bh, s_k, d), 2, seed=2))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    want = jax_attn.flash_attention_partials(
        jq, jk, jv, causal=causal, q_offset=q_off, kv_offset=kv_off,
        block_q=64, block_k=64, interpret=True)
    got = attn.flash_attention_partials(
        tq, tk, tv, causal=causal, q_offset=q_off, kv_offset=kv_off,
        block_q=64, block_k=64)
    assert all(x.dtype == torch.float32 for x in got)
    assert got[0].shape == (bh, s_q, d) and got[1].shape == (bh, s_q)
    _assert_partials_close(got, want,
                           _seen(bh, s_q, causal, q_off, kv_off, s_k),
                           DTYPES[dtype][2])


@pytest.mark.parametrize("causal", [False, True])
def test_partials_bf16_same_tiling_rounds_p_alike(causal):
    """With the Pallas kernel's own tiling the running maxima match, so p
    rounds to the same bf16 values before the PV product on both sides and
    the results agree far inside the bf16 tolerance (1e-4; without the
    cast of p they differ by ~1e-3)."""
    bh, s, d = 2, 128, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((bh, s, d)), "bf16")
    want = jax_attn.flash_attention_partials(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = attn.flash_attention_partials(tq, tk, tv, causal=causal,
                                        block_q=64, block_k=64)
    _assert_partials_close(got, want, _seen(bh, s, causal, 0, 0, s), 1e-4)


@pytest.mark.parametrize("blocks", [(32, 32), (128, 64), (None, None)])
def test_partials_tiling_does_not_change_seen_rows(blocks):
    """Any legal tiling of the plain version gives the JAX result on rows
    that see a key, the default (None) included."""
    bh, s, d = 2, 128, 16
    q, k, v = _arrays((bh, s, d))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "f32")
    want = jax_attn.flash_attention_partials(
        jq, jk, jv, causal=True, kv_offset=16, block_q=64, block_k=64,
        interpret=True)
    got = attn.flash_attention_partials(tq, tk, tv, causal=True,
                                        kv_offset=16, block_q=blocks[0],
                                        block_k=blocks[1])
    _assert_partials_close(got, want, _seen(bh, s, True, 0, 16, s), 2e-5)


def test_partials_default_block_ragged_sequence():
    """A sequence that 128 does not divide is one block of the plain
    version; the JAX package's auto-pick takes it whole too."""
    bh, s, d = 2, 200, 16
    q, k, v = _arrays((bh, s, d))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "f32")
    want = jax_attn.flash_attention_partials(jq, jk, jv, causal=True,
                                             interpret=True)
    got = attn.flash_attention_partials(tq, tk, tv, causal=True)
    _assert_partials_close(got, want, _seen(bh, s, True, 0, 0, s), 2e-5)


def test_partials_cast_kv_to_q_dtype():
    bh, s, d = 1, 64, 16
    q, k, v = _arrays((bh, s, d))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = attn.flash_attention_partials(tq, tk, tv)
    want = attn.flash_attention_partials(tq, tk.to(torch.bfloat16),
                                         tv.to(torch.bfloat16))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_merge_across_shards_equals_dense(causal):
    """Two K/V halves merged with ring._merge equal attention over the whole
    kv: the contract ring attention relies on (tests/test_ops.py)."""
    b, s, h, d = 1, 128, 2, 16
    q, k, v = _arrays((b, s, h, d))
    fold = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(b * h, s, d)
    qf, kf, vf = fold(q), fold(k), fold(v)
    half = s // 2
    p1 = attn.flash_attention_partials(qf, kf[:, :half], vf[:, :half],
                                       causal=causal, block_q=64, block_k=64)
    p2 = attn.flash_attention_partials(qf, kf[:, half:], vf[:, half:],
                                       causal=causal, kv_offset=half,
                                       block_q=64, block_k=64)
    o, m, l = ring._merge(*p1, *p2)
    out = (o / l[..., None]).reshape(b, h, s, d).transpose(1, 2)
    want = jax_ring.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v = _arrays((2, 64, 2, 16))
    got = ring.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    want = jax_ring.attention_reference(*map(jnp.asarray, (q, k, v)),
                                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


FLASH_MHA_TOL = {"f32": 2e-5, "bf16": 0.06}


@pytest.mark.parametrize("dtype", sorted(FLASH_MHA_TOL))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_forward_matches_jax(dtype, causal):
    q, k, v = _arrays((2, 128, 2, 16))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    want, res = jax_attn._flash_mha_fwd(jq, jk, jv, causal, None, 64, 64,
                                        True)
    got = attn.flash_mha(tq, tk, tv, causal, None, 64, 64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = FLASH_MHA_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    _, got_res = attn._flash_mha_fwd(tq, tk, tv, causal, None, 64, 64)
    # δ comes from the saved output in q's dtype, as in the JAX package
    assert got_res[3].dtype == tq.dtype
    np.testing.assert_allclose(got_res[4].numpy(), np.asarray(res[4]),
                               rtol=tol, atol=tol)


def test_flash_mha_requires_uniform_dtype():
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 64, 2, 16)))
    with pytest.raises(TypeError, match="uniform q/k/v dtype"):
        attn.flash_mha(q, k.to(torch.bfloat16), v)


def _jax_grads(fn, q, k, v):
    # the loss of tests/test_ops.py: a non-uniform cotangent, so that dq,
    # dk and dv all see structure
    def loss(q, k, v):
        out = fn(q, k, v)
        w = jnp.arange(out.size, dtype=out.dtype).reshape(out.shape)
        return jnp.sum(out * w) / out.size
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(fn, q, k, v):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    w = torch.arange(out.numel(), dtype=out.dtype).reshape(out.shape)
    ((out * w).sum() / out.numel()).backward()
    return q.grad, k.grad, v.grad


def _assert_grads_close(got, want, dtype):
    for g, w, name in zip(got, want, "qkv"):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"d{name}")
        else:
            err = np.abs(g - w).max()
            assert err <= 2e-2 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_grads_match_jax(dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((2, 128, 2, 16)), dtype)
    want = _jax_grads(lambda q, k, v: jax_attn.flash_mha(
        q, k, v, causal, None, 64, 64, True), jq, jk, jv)
    got = _torch_grads(lambda q, k, v: attn.flash_mha(
        q, k, v, causal, None, 64, 64), tq, tk, tv)
    assert all(g.dtype == tq.dtype for g in got)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("bwd_blocks", [(32, 32), (64, 32), (128, 64)])
def test_flash_mha_bwd_blocks_tile_independently(bwd_blocks):
    """The backward tiles independently of the forward: any legal pair of
    bwd blocks gives the JAX package's gradients (tests/test_ops.py)."""
    bq, bk = bwd_blocks
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((2, 128, 2, 16)), "f32")
    want = _jax_grads(lambda q, k, v: jax_attn.flash_mha(
        q, k, v, True, None, 64, 64, True, bq, bk), jq, jk, jv)
    got = _torch_grads(lambda q, k, v: attn.flash_mha(
        q, k, v, True, None, 64, 64, None, bq, bk), tq, tk, tv)
    _assert_grads_close(got, want, "f32")


@pytest.mark.parametrize("interpret", [None, True])
def test_flash_mha_takes_the_reference_positionals(interpret):
    """The JAX package's own call (models/transformer.py: ten positionals,
    interpret eighth) binds the same arguments on the port: the output and
    gradients match the JAX call."""
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((2, 128, 2, 16)), "f32")
    args = (True, None, 64, 64, interpret, 32, 64)
    want_out = _np(jax_attn.flash_mha(jq, jk, jv, True, None, 64, 64, True,
                                      32, 64))
    np.testing.assert_allclose(_np(attn.flash_mha(tq, tk, tv, *args)),
                               want_out, rtol=2e-4, atol=2e-4)
    want = _jax_grads(lambda q, k, v: jax_attn.flash_mha(
        q, k, v, True, None, 64, 64, True, 32, 64), jq, jk, jv)
    got = _torch_grads(lambda q, k, v: attn.flash_mha(q, k, v, *args),
                       tq, tk, tv)
    _assert_grads_close(got, want, "f32")


def test_flash_mha_interpret_refuses_cuda_tensors():
    """interpret=True means the plain versions, which only CPU tensors
    run: any other device raises rather than being moved."""
    q = torch.empty((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="interpret"):
        attn.flash_mha(q, q, q, True, None, None, None, True)


def test_flash_mha_grads_match_dense_reference():
    """Autograd through flash_mha equals autograd through the dense
    attention_reference (the check of tests/test_ops.py, port side)."""
    tq, tk, tv = (torch.from_numpy(a) for a in _arrays((2, 128, 2, 16)))
    got = _torch_grads(lambda q, k, v: attn.flash_mha(q, k, v, True), tq,
                       tk, tv)
    want = _torch_grads(lambda q, k, v: ring.attention_reference(
        q, k, v, causal=True), tq, tk, tv)
    _assert_grads_close(got, want, "f32")


# on the same residuals and cotangent the two backwards differ only in the
# order of f32 sums: f32 to 1e-6 of max|grad|, and bf16 to 1e-3 of it, a
# quarter of one bf16 step (2^-8) at the largest gradient — a missing cast
# of p or ds to bf16 moves results by about one step
SAME_RESIDUALS_TOL = {"f32": 1e-6, "bf16": 1e-3}

# (causal, s_q, s_k, forward blocks, backward blocks): the offset-free cases
# of CASES at bwd blocks (32, 64), then the tiles of the Hopper kernels that
# chip_smoke.py holds against these plain versions (K2 64 q x 128 kv rows,
# K3 128 x 128; the plain versions run both kernels' loops at one tile
# pair), ragged lengths on either side of 128 (one block each), and causal
# masking with s_q != s_k both ways
SAME_RESIDUALS_CASES = {
    name: (CASES[name][0], CASES[name][3], CASES[name][4], (64, 64),
           (32, 64)) for name in ("causal", "dense", "cross_sq_lt_sk")} | {
    "k2_tile_64x128": (True, 256, 256, (64, 64), (64, 128)),
    "k3_tile_128x128": (True, 256, 256, (64, 64), (128, 128)),
    "ragged_127": (True, 127, 127, (None, None), (None, None)),
    "ragged_129": (True, 129, 129, (None, None), (None, None)),
    "causal_sq_lt_sk": (True, 128, 256, (64, 64), (64, 128)),
    "causal_sq_gt_sk": (True, 256, 128, (64, 64), (128, 128)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", list(SAME_RESIDUALS_CASES))
def test_flash_mha_bwd_matches_jax_on_same_residuals(case, dtype):
    """The port's backward (δ, then the plain versions of K2 and K3) fed
    the JAX package's own forward residuals and cotangent, against the
    JAX package's Pallas backward, s_q ≠ s_k included."""
    causal, s_q, s_k, (fq, fk), (bq, bk) = SAME_RESIDUALS_CASES[case]
    b, h, d = 1, 2, 16
    q, g = _arrays((b, s_q, h, d), 2, seed=3)
    k, v = _arrays((b, s_k, h, d), 2, seed=4)
    (jq, jk, jv, jg), (_, _, _, tg) = _both([q, k, v, g], dtype)
    _, res = jax_attn._flash_mha_fwd(jq, jk, jv, causal, None, fq, fk, True)
    want = jax_attn._flash_mha_bwd(causal, None, fq, fk, True, bq, bk, res,
                                   jg)
    td = DTYPES[dtype][1]
    qf, kf, vf, of = (torch.tensor(_np(x)).to(td) for x in res[:4])
    lse = torch.tensor(np.asarray(res[4]))
    got = attn._flash_mha_bwd(causal, None, bq, bk,
                              (qf, kf, vf, of, lse, res[5]), tg)
    for x, w, name in zip(got, want, "qkv"):
        assert x.dtype == td and x.shape == w.shape
        w = _np(w)
        err = np.abs(_np(x) - w).max()
        assert err <= SAME_RESIDUALS_TOL[dtype] * np.abs(w).max(), (name,
                                                                     err)


def test_bwd_refuses_mixed_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((2, 64, 16), 4))
    lse = delta = torch.zeros((2, 64))
    with pytest.raises(TypeError, match="uniform"):
        attn.flash_mha_bwd_dq(q, k.to(torch.bfloat16), v, do, lse, delta)
    with pytest.raises(TypeError, match="float32"):
        attn.flash_mha_bwd_dkdv(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError, match="shapes"):
        attn.flash_mha_bwd_dkdv(q, k, v, do, lse[:, :32], delta)
    with pytest.raises(ValueError, match="must divide into"):
        attn.flash_mha_bwd_dq(q, k, v, do, lse, delta, block_q=48)
    meta = torch.empty((2, 64, 16), device="meta")
    mlse = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attn.flash_mha_bwd_dkdv(meta, meta, meta, meta, mlse, mlse)


@pytest.mark.parametrize("blocks", [(48, 64), (64, 96)])
def test_blocks_must_divide_sequence(blocks):
    q, k, v = (torch.from_numpy(a) for a in _arrays((2, 128, 16)))
    with pytest.raises(ValueError, match="must divide into"):
        attn.flash_attention_partials(q, k, v, block_q=blocks[0],
                                      block_k=blocks[1])
    with pytest.raises(ValueError, match="must divide into"):
        attn.flash_mha(q[:, :, None], k[:, :, None], v[:, :, None], True,
                       None, *blocks)


def test_unsupported_device_raises():
    q = torch.empty((1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attn.flash_attention_partials(q, q, q)
