"""The port's MoE einsum block, the MoE flagship on one device and the MoE
routing plane against the JAX package, on the CPU.

``moe_block`` takes the JAX package's weights as numpy and is held to the
reference's block on the same tokens: f32 to 1e-5 absolute, bf16 to 2e-2
(both round every product to bf16, 2^-8 relative, in other places), at the
reference tests' sizes (R·t = 128 tokens, d 32, 8 experts), over top_k 1
(the raw Switch gate), 2 and E (every token on every expert: frac is
uniform, ``tests/test_moe_ep.py:111``), a capacity that drops tokens, and
one expert against the dense FFN (``tests/test_pipeline_moe.py:74``).

The MoE flagship (``mlp="moe"``, attention dense on both sides or flash in
the port: K1-K3's plain bodies) is held to the reference's forward, loss
and ``jax.grad`` of its loss at 1e-4 relative under every remat mode,
its greedy tokens equal, and the aux weight moves the loss
(``tests/test_pipeline_moe.py:115``).  The plane's sentry, cooldown and cf
cap are held to the reference's on the same load sequences; a trip with
the plane enabled raises naming P16b (the policy bus).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu import moe as jax_plane
from ompi_tpu.core import var as jax_var
from ompi_tpu.models import moe as jax_moe
from ompi_tpu.models import transformer as jax_tfm
from ompi_tpu_torch import moe as plane
from ompi_tpu_torch import optim
from ompi_tpu_torch import spc
from ompi_tpu_torch.core import var
from ompi_tpu_torch.models import moe
from ompi_tpu_torch.models import transformer as tfm

R, T, D, E = 8, 16, 32, 8
KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
          d_ff=64, seq=8, mlp="moe", n_experts=8, moe_top_k=2)

# the reference's functions compiled once a configuration (its eager
# dispatch compiles every op at every new shape)
_jit_block = jax.jit(jax_moe.moe_block, static_argnums=(2, 3, 4))
_jit_forward = jax.jit(jax_tfm.forward, static_argnums=2)
_jit_loss = jax.jit(jax_tfm.loss_fn, static_argnums=2)
_jit_value_and_grad = jax.jit(jax.value_and_grad(jax_tfm.loss_fn),
                              static_argnums=2)


def _tree(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax.tree.map(np.asarray, params).items()}


@pytest.fixture(scope="module")
def block_inputs():
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(0), D, 2 * D, E)
    h = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, R * T, D),
                                   jnp.float32))
    return jp, _tree(jp), h


@pytest.mark.parametrize("top_k,cf", [(1, 8.0), (2, 8.0), (E, 8.0),
                                      (2, 1.25), (2, 0.5)],
                         ids=["top1_switch", "top2", "topE_uniform",
                              "top2_cf1.25", "top2_drops"])
def test_moe_block_matches_jax(block_inputs, top_k, cf):
    jp, tp, h = block_inputs
    want, want_aux = _jit_block(jnp.asarray(h), jp, E, top_k, cf)
    got, aux = moe.moe_block(torch.from_numpy(h), tp, E, top_k, cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert abs(float(aux) - float(want_aux)) < 1e-5
    if top_k == E:                       # frac uniform: aux = Σ mean_prob
        assert abs(float(aux) - 1.0) < 1e-5
    if cf == 0.5:                        # the case must drop tokens
        capacity = int(np.ceil(R * T * top_k * cf / E))
        probs = torch.softmax(torch.from_numpy(h[0]) @ tp["router"], -1)
        load = torch.bincount(torch.topk(probs, top_k).indices.reshape(-1),
                              minlength=E)
        assert int(load.max()) > capacity


def test_moe_block_bf16_matches_jax(block_inputs):
    jp, tp, h = block_inputs
    want, want_aux = _jit_block(jnp.asarray(h, jnp.bfloat16), jp, E, 2,
                                1.25)
    got, aux = moe.moe_block(torch.from_numpy(h).bfloat16(), tp, E, 2, 1.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)
    assert abs(float(aux) - float(want_aux)) < 2e-2


def test_one_expert_is_the_dense_ffn():
    jp = jax_moe.init_moe_params(jax.random.key(0), 8, 16, 1)
    p = _tree(jp)
    h = np.array(jax.random.normal(jax.random.key(1), (2, 4, 8)))
    out, aux = moe.moe_block(torch.from_numpy(h), p, 1, top_k=1,
                             capacity_factor=2.0)
    x = torch.from_numpy(h).reshape(-1, 8)
    gate = torch.nn.functional.silu(x @ p["w_gate"][0])
    want = ((gate * (x @ p["w_up"][0])) @ p["w_down"][0]).reshape(h.shape)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    jout, _ = _jit_block(jnp.asarray(h), jp, 1, 1, 2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    assert abs(float(aux) - 1.0) < 1e-6


def test_init_moe_params_shapes_and_scale():
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 32, 64, 8,
                            device="cpu")
    want = jax.tree.map(lambda x: tuple(x.shape),
                        jax_moe.init_moe_params(jax.random.key(0), 32, 64, 8))
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert abs(float(p["w_down"].std()) * np.sqrt(64) - 1.0) < 0.05
    assert moe.moe_param_specs() == {
        k: tuple(s) for k, s in jax_moe.moe_param_specs().items()}


# -- the MoE flagship on one device -------------------------------------------

def _configs(attn="dense", **extra):
    kw = dict(KW, **extra)
    return (jax_tfm.Config(attn="dense", dtype=jnp.float32, **kw),
            tfm.Config(attn=attn, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    jparams = jax_tfm.init_params(jax.random.key(1), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape,
                                                dtype=np.int32)


def test_params_from_numpy_carries_the_moe_subtree(weights):
    jparams, tree = weights
    params = tfm.params_from_numpy(tree, device="cpu")
    assert set(params["layers"][0]) == {"attn_norm", "wqkv", "wo",
                                        "mlp_norm", "moe"}
    flat_j, flat_t = jax.tree.leaves(jparams), optim.tree_leaves(params)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _, cfg = _configs()
    fresh = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), fresh) == jax.tree.map(
        lambda x: tuple(x.shape), params)
    bad = {**tree, "layers": [dict(tree["layers"][0], w_up=0)]}
    with pytest.raises(ValueError, match="neither"):
        tfm.params_from_numpy(bad, device="cpu")


def test_forward_and_aux_weight_match_jax(weights):
    jparams, tree = weights
    params = tfm.params_from_numpy(tree, device="cpu")
    tokens = _tokens((2, KW["seq"] + 1), seed=3)
    jcfg, cfg = _configs()
    logits, aux = tfm.forward(params, tokens[:, :-1], cfg, device="cpu")
    jlogits, jaux = _jit_forward(jparams, jnp.asarray(tokens[:, :-1]),
                                 jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4 * float(np.abs(jlogits).max()))
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    losses = []
    for w in (0.0, 1.0):
        jc, c = _configs(moe_aux_weight=w)
        got = float(tfm.loss_fn(params, tokens, c, device="cpu"))
        want = float(_jit_loss(jparams, jnp.asarray(tokens), jc))
        assert abs(got - want) <= 1e-4 * abs(want)
        losses.append(got)
    assert losses[1] > losses[0]                     # the aux contributes


@pytest.fixture(scope="module")
def jax_grads(weights):
    jparams, _ = weights
    jcfg, _ = _configs()
    tokens = _tokens((2, KW["seq"] + 1), seed=4)
    loss, grads = _jit_value_and_grad(jparams, jnp.asarray(tokens), jcfg)
    return tokens, float(loss), [np.asarray(g) for g in
                                 jax.tree.leaves(grads)]


@pytest.mark.parametrize("attn,remat", [("dense", "none"), ("flash", "none"),
                                        ("flash", "dots"), ("flash", "full")])
def test_value_and_grad_matches_jax_grad(weights, jax_grads, attn, remat):
    """The JAX gradients of the dense-attention loss (remat changes no
    value there); the port's under each remat mode, flash through K1-K3's
    plain bodies."""
    _, tree = weights
    tokens, want_loss, want = jax_grads
    _, cfg = _configs(attn, remat=remat)
    params = tfm.params_from_numpy(tree, device="cpu")
    loss, grads = tfm.value_and_grad(params, tokens, cfg, device="cpu")
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= \
            1e-4 * float(np.abs(w).max()) + 1e-9


def test_train_step_runs_and_refuses_an_unknown_impl(weights):
    _, tree = weights
    _, cfg = _configs("flash", remat="dots")
    params = tfm.params_from_numpy(tree, device="cpu")
    init_opt, step = tfm.make_train_step(cfg, device="cpu")
    opt = init_opt(params)
    tokens = _tokens((2, KW["seq"] + 1), seed=6)
    losses = [float(step(params, opt, tokens)[2]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="moe_impl"):
        tfm.make_train_step(dataclasses.replace(cfg, moe_impl="bogus"),
                            device="cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        jax_tfm.make_train_step(jax_tfm.Config(mlp="moe", moe_impl="bogus"))
    with pytest.raises(ValueError, match="loss_chunk"):
        tfm.loss_fn(params, tokens, dataclasses.replace(cfg, loss_chunk=8),
                    device="cpu")


def test_greedy_matches_jax(weights):
    jparams, tree = weights
    params = tfm.params_from_numpy(tree, device="cpu")
    jcfg, cfg = _configs()
    prompts = _tokens((2, 5), seed=5).tolist()
    got = tfm.greedy(params, prompts, 3, cfg, device="cpu")
    toks = jnp.asarray(prompts, jnp.int32)
    want = []
    for _ in range(3):
        lg, _ = _jit_forward(jparams, toks, jcfg)
        nxt = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        want.append(np.asarray(nxt))
        toks = jnp.concatenate([toks, nxt[:, None]], axis=1)
    assert got == np.stack(want, axis=1).tolist()


# -- the routing plane --------------------------------------------------------

@pytest.fixture
def planes():
    """Both planes reset and disabled around a test, their variables
    cleared."""
    names = ("moe_adapt_cooldown", "moe_sentry_min_tokens")
    for p in (plane, jax_plane):
        p.reset()
        p.disable()
    yield
    for p, reg in ((plane, var.registry), (jax_plane, jax_var.registry)):
        p.reset()
        p.disable()
        for name in names:
            reg.clear_cli(name)


def _loads(E=8, hot=None, base=20, hot_load=500, uniform=100):
    if hot is None:
        return [uniform] * E
    loads = [base] * E
    loads[hot] = hot_load
    return loads


SEQUENCES = {
    # trip, same expert held (no re-trip), cool down, a new hot spot
    "episodes": [_loads(), _loads(), _loads(hot=3), _loads(hot=3),
                 _loads(), _loads(hot=5), _loads(hot=5, hot_load=900)],
    # the hot spot moves without cooling: each move is a new episode
    "moving": [_loads(hot=1), _loads(hot=2), _loads(hot=2), _loads(hot=7)],
    # under the min-token floor and a wide natural spread: no trip
    "quiet": [[1, 2, 3, 60, 1, 2, 3, 2], [5, 80, 90, 70, 60, 75, 85, 65],
              [0] * 8, [10]],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_sentry_matches_jax(planes, seq):
    mine, ref = plane.HotExpertSentry(), jax_plane.HotExpertSentry()
    for step, loads in enumerate(SEQUENCES[seq]):
        assert mine.check(loads, step=step) == ref.check(loads, step=step)
        assert mine.hot() == ref.hot()
    assert mine.trips() == ref.trips()
    assert mine.verdicts() == ref.verdicts()
    mine.reset()
    assert (mine.trips(), mine.verdicts(), mine.hot()) == (0, [], False)


@pytest.mark.parametrize("cooldown", [1, 4])
def test_adaptation_cooldown_and_cap_match_jax(planes, cooldown):
    verdict = {"expert": 3, "ratio": 25.0}
    events = {}
    for name, p, reg in (("port", plane, var.registry),
                         ("jax", jax_plane, jax_var.registry)):
        reg.set_cli("moe_adapt_cooldown", str(cooldown))
        p.enable()
        rows = [(p.apply_adaptation(verdict, step),
                 p.capacity_factor(1.25), p.aux_weight(0.01))
                for step in (0, 1, 2, 3, 4, 6, 9, 12, 20, 30, 40, 50)]
        events[name] = (rows, p.adaptations(), p.report())
        assert p.capacity_factor(2.0) <= 4.0           # the cf cap
    assert events["port"] == events["jax"]


def test_disabled_plane_is_the_identity(planes):
    for p in (plane, jax_plane):
        assert p.capacity_factor(1.25) == 1.25
        assert p.aux_weight(0.01) == 0.01
        assert p.note_routing([1000, 1], step=0) is None
    assert plane.report() == jax_plane.report()


def test_trip_raises_naming_p16b(planes):
    plane.enable()
    c = spc.Counters()
    for s in range(3):
        assert plane.note_routing(_loads(), dropped=2, step=s) is None
    with pytest.raises(NotImplementedError, match="P16b"):
        plane.note_routing(_loads(hot=3), step=3)
    # the step was recorded before the bus hop: the reference's counters
    assert c.get("moe_routed_tokens") == 3 * 800 + 640
    assert c.get("moe_dropped_tokens") == 6
    assert c.get("moe_hot_expert_trips") == 1
    rep = plane.report()
    assert rep["steps"] == 4 and rep["hot_now"]
    assert rep["verdicts"][0]["expert"] == 3
    assert rep["adaptations"] == []
