"""The port's Ulysses attention (``ompi_tpu_torch/parallel/ulysses.py``)
and the flagship's ``attn="flash"``/``"dense"`` on sp > 1 against the JAX
package's, on the CPU.

The port runs one gloo process a rank in a world of 4; the JAX package
runs the same inputs on virtual CPU devices.

* ``ulysses_attention`` at sp 4 against the JAX ``ulysses_attention`` on
  an sp-4 mesh (``tests/test_parallel.py``'s shape, its sequence over 4
  in place of 8), causal and not: the output to the reference's rtol
  2e-4 / atol 2e-5; q/k/v gradients of sum(out · cot) against
  ``jax.grad`` of the JAX one to its ring test's rtol 5e-3 / atol 5e-4.
  With ``flash_mha`` as the attention (K1–K3's plain versions here) the
  same, causal.  A causal case is what shows the exchange keeps the
  sequence in rank order: a permuted sequence still passes a non-causal
  one.
* The bad-heads ``ValueError`` ("divisible").
* The flagship's mesh step with ``attn="flash"`` and ``"dense"`` at (dp,
  sp, tp) = (1, 2, 2) and (2, 2, 1) against the JAX package's GSPMD step
  on the same mesh (which replicates the attention over sp), held as
  ``tests/test_torch_mesh_train.py`` holds ``"ring"``: the loss to 1e-5
  relative, every gathered gradient leaf to rtol 1e-4 / atol 1e-6; once
  more under remat "dots", where each layer's recompute runs the
  exchanges again on every rank.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh  # noqa: E402
from ompi_tpu.parallel.ulysses import ulysses_attention  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

B, S, H, D = 2, 64, 8, 16          # seq 64 over 4 processes: 16 each
SP = {"sp": 4}
KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=32)
MESHES = {"1x2x2": {"dp": 1, "sp": 2, "tp": 2},
          "2x2x1": {"dp": 2, "sp": 2, "tp": 1}}

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(4)
    yield p
    p.close()


def _inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(n)]


def _assemble(blocks):
    """The whole (b, s, h, d) array from the 4 sequence shards."""
    return np.concatenate(blocks, axis=1)


def _jax_ulysses(q, k, v, causal, cot=None):
    mesh = make_mesh(SP, devices=jax.devices()[:4])
    sh = lambda x: jax.device_put(jnp.asarray(x),
                                  NamedSharding(mesh, P(None, "sp")))
    qd, kd, vd = sh(q), sh(k), sh(v)
    out = np.asarray(ulysses_attention(qd, kd, vd, mesh, "sp",
                                       causal=causal))
    if cot is None:
        return out, None

    def loss(a, b, c):
        return jnp.sum(ulysses_attention(a, b, c, mesh, "sp",
                                         causal=causal) * cot)
    grads = jax.grad(loss, argnums=(0, 1, 2))(qd, kd, vd)
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(pool, causal):
    q, k, v, cot = _inputs(1)
    want, wgrads = _jax_ulysses(q, k, v, causal, cot)
    out = pool.run("_torch_p13_worker:ulysses", SP, q, k, v, causal,
                   cot=cot)
    np.testing.assert_allclose(_assemble([o[0] for o in out]), want,
                               rtol=2e-4, atol=2e-5)
    for i, w in enumerate(wgrads):
        np.testing.assert_allclose(_assemble([o[i + 1] for o in out]), w,
                                   rtol=5e-3, atol=5e-4)


def test_ulysses_flash_matches_jax(pool):
    """attn_fn=flash_mha (K1 forward, K2/K3 backward: their plain
    versions on the CPU), causal."""
    q, k, v, cot = _inputs(2)
    want, wgrads = _jax_ulysses(q, k, v, True, cot)
    out = pool.run("_torch_p13_worker:ulysses", SP, q, k, v, True, cot=cot,
                   flash=True)
    np.testing.assert_allclose(_assemble([o[0] for o in out]), want,
                               rtol=2e-4, atol=2e-5)
    for i, w in enumerate(wgrads):
        np.testing.assert_allclose(_assemble([o[i + 1] for o in out]), w,
                                   rtol=5e-3, atol=5e-4)


def test_ulysses_rejects_bad_heads(pool):
    q = np.zeros((B, S // 4, 6, D), np.float32)     # 6 heads over sp 4
    for msg in pool.run("_torch_p13_worker:ulysses_bad_heads", SP, q):
        assert msg is not None and "divisible" in msg


# -- the flagship's mesh step -------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tfm.Config(dtype=jnp.float32, attn="dense", **KW)
    jparams = jax_tfm.init_params(jax.random.key(1), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _jax_vg(attn, jparams, axes, tokens):
    jcfg = jax_tfm.Config(dtype=jnp.float32, attn=attn, **KW)
    mesh = make_mesh(axes, devices=jax.devices()[:4])
    sharded = jax_tfm.shard_params(jparams, mesh, jcfg)
    loss, grads = jax.jit(jax.value_and_grad(jax_tfm.loss_fn),
                          static_argnums=(2, 3))(
        sharded, jnp.asarray(tokens), jcfg, mesh)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, KW["vocab"],
                                             (4, KW["seq"] + 1),
                                             dtype=np.int32)


@pytest.mark.parametrize("attn", ["flash", "dense"])
@pytest.mark.parametrize("layout", list(MESHES))
def test_mesh_step_matches_jax(pool, weights, tokens, attn, layout):
    jparams, tree = weights
    axes = MESHES[layout]
    wloss, wgrads = _jax_vg(attn, jparams, axes, tokens)
    kw = dict(KW, attn=attn, dtype="float32")
    for loss, grads in pool.run("_torch_mesh_worker:value_and_grad", axes,
                                kw, tree, tokens):
        assert abs(loss - wloss) <= 1e-5 * abs(wloss)
        assert len(grads) == len(wgrads)
        for g, w in zip(grads, wgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_mesh_step_flash_dots_matches_jax(pool, weights, tokens):
    """remat "dots" at (1, 2, 2): the recompute runs K1 and both
    exchanges again on every rank."""
    jparams, tree = weights
    axes = MESHES["1x2x2"]
    wloss, wgrads = _jax_vg("flash", jparams, axes, tokens)
    kw = dict(KW, attn="flash", dtype="float32", remat="dots")
    for loss, grads in pool.run("_torch_mesh_worker:value_and_grad", axes,
                                kw, tree, tokens):
        assert abs(loss - wloss) <= 1e-5 * abs(wloss)
        for g, w in zip(grads, wgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
