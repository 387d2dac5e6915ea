"""The port's flagship forward (ompi_tpu_torch.models.transformer) against
the JAX package's, on the CPU, with the JAX package's weights carried
across by ``params_from_numpy``.

f32 configurations are held to 2e-4, the figure of tests/test_transformer.py
for flash vs dense.  The one bf16 case is held to a relative RMS of 2e-2 on
the logits: both frameworks round every product and norm to bf16 (2^-8
relative), in different places, across two layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.models import transformer as jax_tfm
from ompi_tpu_torch.models import transformer as tfm

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=64)


def _configs(attn, dtype="f32"):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jax_tfm.Config(attn=attn, dtype=jd, **KW),
            tfm.Config(attn=attn, dtype=td, **KW))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs("flash")
    jparams = jax_tfm.init_params(jax.random.key(1), jcfg)
    return jparams, tfm.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape,
                                                dtype=np.int32)


def test_params_from_numpy_keeps_layouts(weights):
    jparams, params = weights
    flat_j = jax.tree.leaves(jparams)
    flat_t = jax.tree.leaves(params)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_init_params_shapes_and_scale():
    jcfg, cfg = _configs("flash")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    want = jax.tree.map(lambda x: x.shape, jax_tfm.init_params(
        jax.random.key(0), jcfg))
    assert jax.tree.map(lambda x: tuple(x.shape), params) == \
        jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, tuple))
    layer = params["layers"][0]
    assert torch.equal(layer["attn_norm"], torch.ones(cfg.d_model))
    # normal / sqrt(fan_in): fan_in of w_down is d_ff
    std = float(layer["w_down"].std()) * np.sqrt(cfg.d_ff)
    assert 0.9 < std < 1.1
    again = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert torch.equal(again["embed"], params["embed"])


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_forward_matches_jax_f32(weights, attn):
    jparams, params = weights
    jcfg, cfg = _configs(attn)
    tokens = _tokens((2, KW["seq"]))
    want = jax_tfm.forward(jparams, jnp.asarray(tokens), jcfg)
    got = tfm.forward(params, tokens, cfg, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_and_dense_forward_agree(weights):
    _, params = weights
    tokens = _tokens((2, KW["seq"]), seed=3)
    lf = tfm.forward(params, tokens, _configs("flash")[1], device="cpu")
    ld = tfm.forward(params, tokens, _configs("dense")[1], device="cpu")
    np.testing.assert_allclose(lf.numpy(), ld.numpy(), rtol=2e-4, atol=2e-4)


def test_forward_matches_jax_bf16(weights):
    jparams, params = weights
    jcfg, cfg = _configs("flash", "bf16")
    tokens = _tokens((2, KW["seq"]), seed=2)
    want = np.asarray(jax_tfm.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tfm.forward(params, tokens, cfg, device="cpu").numpy()
    assert np.isfinite(got).all()
    rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    assert rel < 2e-2, rel


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_loss_matches_jax(weights, attn):
    jparams, params = weights
    jcfg, cfg = _configs(attn)
    tokens = _tokens((2, KW["seq"] + 1), seed=4)
    want = float(jax_tfm.loss_fn(jparams, jnp.asarray(tokens), jcfg))
    got = float(tfm.loss_fn(params, tokens, cfg, device="cpu"))
    assert abs(got - want) <= 2e-5 * abs(want)


def _jax_greedy(jparams, prompt, n_new, jcfg):
    """Full-context greedy via the JAX forward, the rule of the serving
    tests' _reference_greedy."""
    toks = list(prompt)
    for _ in range(n_new):
        lg = jax_tfm.forward(jparams, jnp.asarray([toks], jnp.int32), jcfg)
        toks.append(int(np.asarray(lg)[0, -1].argmax()))
    return toks[len(prompt):]


def test_greedy_stream_matches_jax(weights):
    jparams, params = weights
    jcfg, cfg = _configs("flash")
    prompts = _tokens((2, 9), seed=5).tolist()
    got = tfm.greedy(params, prompts, 4, cfg, device="cpu")
    want = [_jax_greedy(jparams, p, 4, jcfg) for p in prompts]
    assert got == want


@pytest.mark.parametrize("field,value,slice_", [
    ("attn", "ring", "P5"), ("mlp", "moe", "P12"),
    ("tp_overlap", "fused", "P9"), ("loss_chunk", 16, "P2")])
def test_unported_options_refuse(field, value, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        tfm.Config(**{field: value})


def test_params_on_another_device_refused(weights):
    _, params = weights
    moved = dict(params, final_norm=params["final_norm"].to("meta"))
    with pytest.raises(ValueError, match="tensor on meta, expected cpu"):
        tfm.forward(moved, _tokens((1, 8)), _configs("flash")[1],
                    device="cpu")
