"""The port's flagship forward (ompi_tpu_torch.models.transformer) against
the JAX package's, on the CPU, with the JAX package's weights carried
across by ``params_from_numpy``.

f32 configurations are held to 2e-4, the figure of tests/test_transformer.py
for flash vs dense.  The one bf16 case is held to a relative RMS of 2e-2 on
the logits: both frameworks round every product and norm to bf16 (2^-8
relative), in different places, across two layers.

The train step runs three AdamW steps (lr 1e-3) on both sides from the
same weights and batches.  Losses agree to 2e-5 relative (the f32 forward);
parameters to 1e-5 absolute (1% of one step's lr: Adam's normalised update
turns a gradient difference of ~1e-7 into at most that much), and to 1e-4
with a bf16 first moment, where the two round mu to bf16 from sums that
differ in the last f32 bit and one flipped bf16 rounding moves an update
by up to 2^-8 of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ompi_tpu.models import transformer as jax_tfm
from ompi_tpu_torch import optim
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.ops import attention as attn_ops

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=64)


def _configs(attn, dtype="f32", **extra):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(KW, **extra)
    return (jax_tfm.Config(attn=attn, dtype=jd, **kw),
            tfm.Config(attn=attn, dtype=td, **kw))


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
    ("mlp", "moe", "P12b"), ("tp_overlap", "fused", "P9")])
def test_unported_options_refuse(field, value, slice_):
    """Options that a slice brought, where a refusal stood before.  Slice
    P9 brought tp_overlap="fused": the Config takes it, and without a mesh
    the forward raises the reference's ValueError (it needs a tp axis).
    Slice P12a brought mlp="moe" on one device and P12b on a mesh: on a
    (1, 1, 1) mesh the forward and the train step ("native" and
    "bucketed") run and equal the one-card forward and step."""
    if slice_ == "P9":
        jcfg = jax_tfm.Config(**KW, dtype=jnp.float32, tp_overlap=value)
        cfg = tfm.Config(**KW, dtype=torch.float32, tp_overlap=value)
        tokens = _tokens((2, KW["seq"]), seed=7)
        with pytest.raises(ValueError, match="needs a mesh with a tp axis"):
            jax_tfm.forward(jax_tfm.init_params(jax.random.key(0), jcfg),
                            jnp.asarray(tokens), jcfg)
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        with pytest.raises(ValueError, match="needs a mesh with a tp axis"):
            tfm.forward(params, tokens, cfg, device="cpu")
        return
    cfg = tfm.Config(**KW, dtype=torch.float32, **{field: value})
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    tokens = _tokens((2, KW["seq"] + 1), seed=7)
    clone = lambda: optim.tree_map(lambda t: t.clone(), pristine)

    def one_step(c, mesh=None):
        init_opt, step = tfm.make_train_step(c, mesh, device="cpu")
        params = clone()
        params, _, loss = step(params, init_opt(params), tokens)
        return float(loss), optim.tree_leaves(params)

    want_logits, want_aux = tfm.forward(pristine, tokens[:, :-1], cfg,
                                        device="cpu")
    want_loss, want_params = one_step(cfg)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("dp", "sp", "tp"))
        logits, aux = tfm.forward(pristine, tokens[:, :-1], cfg,
                                  device="cpu", mesh=mesh)
        torch.testing.assert_close(logits, want_logits, rtol=1e-5,
                                   atol=1e-5)
        assert abs(float(aux) - float(want_aux)) <= 1e-6
        for mode in ("native", "bucketed"):
            loss, params = one_step(dataclasses.replace(cfg, grad_sync=mode),
                                    mesh)
            assert abs(loss - want_loss) <= 2e-5 * abs(want_loss)
            for got, want in zip(params, want_params):
                torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_ring_without_a_mesh_is_dense(weights):
    """attn="ring" with no mesh falls through to attention_reference, as
    the reference's _attn_apply does."""
    _, params = weights
    tokens = _tokens((2, KW["seq"]), seed=6)
    ring = tfm.forward(params, tokens, _configs("ring")[1], device="cpu")
    dense = tfm.forward(params, tokens, _configs("dense")[1], device="cpu")
    assert torch.equal(ring, dense)


def test_params_on_another_device_refused(weights):
    _, params = weights
    moved = dict(params, final_norm=params["final_norm"].to("meta"))
    with pytest.raises(ValueError, match="tensor on meta, expected cpu"):
        tfm.forward(moved, _tokens((1, 8)), _configs("flash")[1],
                    device="cpu")


# -- training -----------------------------------------------------------------

TRAIN_KW = dict(seq=32)


def _jax_train(jcfg, jparams, batches):
    init, step = jax_tfm.make_train_step(jcfg)
    state, losses = init(jparams), []
    for b in batches:
        jparams, state, loss = step(jparams, state, jnp.asarray(b))
        losses.append(float(loss))
    return jparams, state, losses


def _torch_train(cfg, params, batches, state=None):
    init, step = tfm.make_train_step(cfg, device="cpu")
    state, losses = state or init(params), []
    for b in batches:
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return params, state, losses


def _assert_trained_alike(jparams, jlosses, params, losses, atol):
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    want = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    got = optim.tree_leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)


def _train_setup(attn, seed=0, **extra):
    jcfg, cfg = _configs(attn, **dict(TRAIN_KW, **extra))
    jparams = jax_tfm.init_params(jax.random.key(1), jcfg)
    params = tfm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    batches = [_tokens((2, TRAIN_KW["seq"] + 1), seed=seed + i)
               for i in range(3)]
    return jcfg, cfg, jparams, params, batches


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_train_step_matches_jax(attn, remat):
    jcfg, cfg, jparams, params, batches = _train_setup(attn, remat=remat)
    jparams, _, jlosses = _jax_train(jcfg, jparams, batches)
    params, state, losses = _torch_train(cfg, params, batches)
    assert state["count"] == 3
    _assert_trained_alike(jparams, jlosses, params, losses, 1e-5)


def test_train_step_bf16_first_moment_matches_jax():
    jcfg, cfg, jparams, params, batches = _train_setup(
        "flash", seed=10, remat="dots", opt_moment_dtype="bfloat16")
    jparams, jstate, jlosses = _jax_train(jcfg, jparams, batches)
    params, state, losses = _torch_train(cfg, params, batches)
    assert all(m.dtype == torch.bfloat16
               for m in optim.tree_leaves(state["mu"]))
    assert all(n.dtype == torch.float32
               for n in optim.tree_leaves(state["nu"]))
    _assert_trained_alike(jparams, jlosses, params, losses, 1e-4)


def test_train_resumes_from_jax_state():
    """One JAX step, then the weights and the optax state carried across
    (params_from_numpy, opt_state_from_numpy): the port's next two steps
    are the JAX package's."""
    jcfg, cfg, jparams, _, batches = _train_setup("flash", seed=20,
                                                  remat="full")
    init, step = jax_tfm.make_train_step(jcfg)
    jparams, jstate, _ = step(jparams, init(jparams), jnp.asarray(batches[0]))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    params = tfm.params_from_numpy(to_np(jparams), device="cpu")
    state = optim.opt_state_from_numpy(to_np(jstate), device="cpu")
    assert state["count"] == 1
    jlosses = []
    for b in batches[1:]:
        jparams, jstate, loss = step(jparams, jstate, jnp.asarray(b))
        jlosses.append(float(loss))
    params, state, losses = _torch_train(cfg, params, batches[1:], state)
    assert state["count"] == 3
    _assert_trained_alike(jparams, jlosses, params, losses, 1e-5)


@pytest.mark.parametrize("chunk", [8, 12])
def test_loss_chunk_matches_jax(chunk):
    """The chunked cross-entropy (12 leaves a ragged tail of 8 over 32
    positions): loss and gradients equal the JAX package's."""
    jcfg, cfg, jparams, params, batches = _train_setup(
        "flash", seed=30, loss_chunk=chunk, remat="dots")
    tokens = batches[0]
    jloss, jgrads = jax.value_and_grad(jax_tfm.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    loss, grads = tfm.value_and_grad(params, tokens, cfg, device="cpu")
    assert not any(p.requires_grad for p in optim.tree_leaves(params))
    assert abs(loss.item() - float(jloss)) <= 2e-5 * abs(float(jloss))
    unchunked = tfm.loss_fn(params, tokens, _configs(
        "flash", **TRAIN_KW)[1], device="cpu")
    assert abs(loss.item() - unchunked.item()) <= 2e-5 * unchunked.item()
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("remat,k1_per_step", [("none", 1), ("dots", 2),
                                               ("full", 2)])
def test_remat_reruns_the_flash_forward(monkeypatch, remat, k1_per_step):
    """What chip_smoke.py asserts of K1/K2/K3 launches, on the plain
    versions: the flash forward runs once per layer and again in the remat
    recompute (selective checkpointing re-runs it, as jax.checkpoint
    re-runs a custom_vjp's forward); each backward piece once per layer."""
    calls = {"fwd": 0, "dkdv": 0, "dq": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    for name, fn_name in (("fwd", "flash_attention_partials_reference"),
                          ("dkdv", "flash_mha_bwd_dkdv_reference"),
                          ("dq", "flash_mha_bwd_dq_reference")):
        monkeypatch.setattr(attn_ops, fn_name,
                            counted(name, getattr(attn_ops, fn_name)))
    _, cfg, _, params, batches = _train_setup("flash", remat=remat)
    _torch_train(cfg, params, batches[:1])
    n = cfg.n_layers
    assert calls == {"fwd": k1_per_step * n, "dkdv": n, "dq": n}


def test_dots_policy_saves_only_unbatched_products():
    policy = tfm._dots_policy
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.mm.default) == save
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten._to_copy.default):
        assert policy(None, op) != save


def test_train_flops_per_token_matches_jax():
    assert tfm.train_flops_per_token(tfm.flagship_config()) == \
        jax_tfm.train_flops_per_token(jax_tfm.flagship_config())
    jcfg, cfg = _configs("flash")
    assert tfm.train_flops_per_token(cfg) == \
        jax_tfm.train_flops_per_token(jcfg)


def test_flagship_config_matches_jax():
    want, got = jax_tfm.flagship_config(), tfm.flagship_config()
    for name in ("vocab", "d_model", "n_layers", "n_heads", "head_dim",
                 "d_ff", "seq", "attn", "remat", "attn_block",
                 "attn_bwd_block", "loss_chunk", "opt_moment_dtype",
                 "grad_sync"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("field,value", [("remat", "some"),
                                         ("opt_moment_dtype", "float16")])
def test_config_refuses_unknown_choices(field, value):
    with pytest.raises(ValueError, match=field):
        tfm.Config(**{field: value})


def test_train_step_refusals():
    _, cfg = _configs("flash")
    for mode in ("quant", "perleaf", "bucketed", "unsynced"):
        with pytest.raises(ValueError, match="requires a mesh"):
            tfm.make_train_step(tfm.Config(grad_sync=mode), device="cpu")
    with pytest.raises(ValueError, match="unknown grad_sync"):
        tfm.make_train_step(tfm.Config(grad_sync="ring"), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tfm.make_train_step(cfg, mesh=object(), device="cpu")
    # the refusals on a mesh, in a gloo world of one (this process)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("dp", "sp", "tp"))
        on_mesh = lambda **kw: tfm.make_train_step(
            dataclasses.replace(cfg, **kw), mesh, device="cpu")
        # P8 (quant) and P9 (perleaf, bucketed, unsynced) run on a dp-only
        # mesh and refuse others with the reference's ValueErrors: a mesh
        # without dp, a tp or sp axis larger than 1 (layouts only, no
        # process group behind them), and fused tp overlap beside them
        no_dp = DeviceMesh("cpu", torch.arange(1).reshape(1),
                           mesh_dim_names=("tp",), _init_backend=False)
        tp2 = DeviceMesh("cpu", torch.arange(2).reshape(1, 1, 2),
                         mesh_dim_names=("dp", "sp", "tp"),
                         _init_backend=False)
        for mode in ("quant", "perleaf", "bucketed", "unsynced"):
            c = dataclasses.replace(cfg, grad_sync=mode)
            on_mesh(grad_sync=mode)
            with pytest.raises(ValueError, match="'dp' mesh axis"):
                tfm.make_train_step(c, no_dp, device="cpu")
            with pytest.raises(ValueError, match="dp-only"):
                tfm.make_train_step(c, tp2, device="cpu")
            with pytest.raises(ValueError, match="grad_sync='native'"):
                tfm.make_train_step(dataclasses.replace(
                    c, attn="dense", tp_overlap="fused"), tp2, device="cpu")
        with pytest.raises(ValueError, match="loss_chunk"):
            on_mesh(loss_chunk=8)
        # sp = 2: the mesh's layout only, no process group behind it.
        # flash and dense run there through Ulysses attention
        # (tests/test_torch_ulysses.py), which splits each rank's h/tp
        # heads over sp: heads that do not divide are refused, naming it,
        # before any group is made; so is the fused tp layer on sp > 1
        sp2 = DeviceMesh("cpu", torch.arange(2).reshape(1, 2, 1),
                         mesh_dim_names=("dp", "sp", "tp"),
                         _init_backend=False)
        for attn in ("flash", "dense"):
            odd = dataclasses.replace(cfg, attn=attn, n_heads=3)
            with pytest.raises(ValueError, match="not divisible by sp=2"):
                tfm.make_train_step(odd, sp2, device="cpu")
        sp2tp2 = DeviceMesh("cpu", torch.arange(4).reshape(1, 2, 2),
                            mesh_dim_names=("dp", "sp", "tp"),
                            _init_backend=False)
        with pytest.raises(ValueError, match="sp = 1 only"):
            tfm.make_train_step(dataclasses.replace(
                cfg, attn="dense", tp_overlap="fused"), sp2tp2,
                device="cpu")
    finally:
        dist.destroy_process_group()
