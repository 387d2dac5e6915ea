"""The port's flagship on a dp×sp×tp mesh against the JAX package's, on
the CPU.

The JAX package places the parameters with ``shard_params`` on the virtual
CPU mesh and lets GSPMD insert every collective; the port runs one gloo
process a rank, each with its ``shard_params`` shards, and writes the
collectives out (Megatron's f and g over tp, the vocab-parallel lookup and
loss, ring attention over sp, the gradient sum over dp × sp).  The same
numpy weights and tokens go to both.

Tolerances, f32: the loss to 1e-5 relative and every gathered gradient
leaf to rtol 1e-4 / atol 1e-6 (the sums run in other orders: over ranks,
and over the ring's hops in place of one softmax); three train steps'
losses to 1e-4 relative, and the parameters after them to 1e-5 absolute
(1% of one step's lr, as in ``test_torch_transformer.py``).  The
reference's own test (``tests/test_transformer.py``: dp2·sp2·tp2,
``attn="ring"``, bf16, 12 steps at lr 3e-3) must cut the loss by 20%.

The JAX side compiles three programs on the virtual mesh: value-and-grad
of the ring loss at dp2·sp2·tp2, of the flash loss at dp2·tp2, and the
ring train step at dp2·sp2·tp2.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=32)
DSP = {"dp": 2, "sp": 2, "tp": 2}
DT = {"dp": 2, "tp": 2}

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def _cfgs(attn, dtype="float32", **extra):
    kw = dict(KW, attn=attn, **extra)
    jcfg = jax_tfm.Config(dtype=getattr(jnp, dtype), **kw)
    return jcfg, dict(kw, dtype=dtype)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape,
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def pool8():
    p = W.Pool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = W.Pool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs("ring")
    jparams = jax_tfm.init_params(jax.random.key(1), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _jax_vg(jcfg, jparams, axes, tokens, n_devices=8):
    mesh = make_mesh(axes, devices=jax.devices()[:n_devices])
    sharded = jax_tfm.shard_params(jparams, mesh, jcfg)
    loss, grads = jax.jit(jax.value_and_grad(jax_tfm.loss_fn),
                          static_argnums=(2, 3))(
        sharded, jnp.asarray(tokens), jcfg, mesh)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _assert_vg(port, want):
    wloss, wgrads = want
    for loss, grads in port:        # every rank: the global loss, the
        assert abs(loss - wloss) <= 1e-5 * abs(wloss)   # gathered grads
        assert len(grads) == len(wgrads)
        for g, w in zip(grads, wgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_shard_params_round_trip_bitwise(pool8, weights):
    """gather_params undoes shard_params bit for bit, and tp rank t holds
    heads [t·h/tp, (t+1)·h/tp) of each of q, k and v."""
    _, tree = weights
    _, kw = _cfgs("ring")
    out = pool8.run("_torch_mesh_worker:shard_roundtrip", DSP, kw, tree)
    w = tree["layers"][0]["wqkv"]
    hd = KW["n_heads"] * KW["head_dim"]
    cols = hd // DSP["tp"]
    for same, t, wqkv, shapes in out:
        assert same
        want = np.concatenate([w[:, p * hd + t * cols:p * hd + (t + 1) * cols]
                               for p in range(3)], axis=1)
        np.testing.assert_array_equal(wqkv, want)
        assert shapes[0] == (KW["vocab"] // 2, KW["d_model"])  # embed
    assert out[0][3] == out[1][3]


@pytest.fixture(scope="module")
def ring_vg(weights):
    jparams, _ = weights
    jcfg, _ = _cfgs("ring")
    tokens = _tokens((4, KW["seq"] + 1), 0)
    return tokens, _jax_vg(jcfg, jparams, DSP, tokens)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_value_and_grad_ring_matches_jax(pool8, weights, ring_vg, remat):
    """dp2·sp2·tp2, attn="ring"; under remat "dots" the backward recomputes
    each layer, its ring hops and tp sums included, on every rank."""
    _, tree = weights
    tokens, want = ring_vg
    _, kw = _cfgs("ring", remat=remat)
    _assert_vg(pool8.run("_torch_mesh_worker:value_and_grad", DSP, kw, tree,
                         tokens), want)


def test_value_and_grad_flash_matches_jax(pool4, weights):
    """dp2·tp2 (sp 1), attn="flash": flash_mha on each rank's
    (b/dp, s, h/tp, d) shard, through K1–K3's plain versions."""
    jparams, tree = weights
    jcfg, kw = _cfgs("flash")
    tokens = _tokens((4, KW["seq"] + 1), 1)
    want = _jax_vg(jcfg, jparams, DT, tokens, n_devices=4)
    _assert_vg(pool4.run("_torch_mesh_worker:value_and_grad", DT, kw, tree,
                         tokens), want)


def test_train_steps_match_jax(pool8, weights):
    jparams, tree = weights
    jcfg, kw = _cfgs("ring")
    batches = [_tokens((4, KW["seq"] + 1), 10 + i) for i in range(3)]
    mesh = make_mesh(DSP)
    init, step = jax_tfm.make_train_step(jcfg, mesh)
    params = jax_tfm.shard_params(jparams, mesh, jcfg)
    state, jlosses = init(params), []
    for b in batches:
        params, state, loss = step(params, state, jnp.asarray(b))
        jlosses.append(float(loss))
    want = [np.asarray(x) for x in jax.tree.leaves(params)]
    for losses, leaves in pool8.run("_torch_mesh_worker:train", DSP, kw,
                                    tree, batches, 1e-3):
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for g, w in zip(leaves, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_reference_config_learns(pool8):
    """tests/test_transformer.py's sharded training test on the port: its
    config, weights and toy batches, bf16, 12 steps at lr 3e-3."""
    jcfg = jax_tfm.Config(vocab=32, d_model=32, n_layers=1, n_heads=4,
                          head_dim=8, d_ff=64, seq=32, attn="ring")
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(
        jcfg) if f.name in ("vocab", "d_model", "n_layers", "n_heads",
                            "head_dim", "d_ff", "seq", "attn")}
    kw["dtype"] = "bfloat16"
    tree = jax.tree.map(np.asarray, jax_tfm.init_params(jax.random.key(0),
                                                        jcfg))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(12):              # token t+1 = (t + 1) % vocab
        start = rng.integers(0, jcfg.vocab, size=(4, 1))
        batches.append((start + np.arange(jcfg.seq + 1)) % jcfg.vocab)
    for losses, _ in pool8.run("_torch_mesh_worker:train", DSP, kw, tree,
                               batches, 3e-3):
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] * 0.8, f"no learning: {losses}"
