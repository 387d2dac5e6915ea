"""The port's collective matmuls (``ompi_tpu_torch/ops/
collective_matmul.py``) and ``tp_overlap="fused"`` against the JAX
package's, on the CPU.

The cases of the reference's ``tests/test_ops.py::TestCollectiveMatmul``
and ``TestCollectiveMatmulBackward`` — rings of 2 and 4, one direction
(either way) and bidirectional, 2-D and batched 3-D, and the refusal of
odd per-rank halves — run in gloo worlds of 2 and 4 processes, each
holding its shard, against the JAX package's on 2 and 4 virtual devices
with the same numpy inputs.  The outputs and the gradients of
sum(out · cot) (a non-uniform cotangent, as the reference's) are held to
1e-5 (rtol = atol; f32 products of a few dozen terms).

``allgather_matmul``'s weight is cut by columns over the ring's axis, the
column-parallel layout of the fused layer (the reference's
``w_sharded_axis``): each rank's output is its columns of the product, so
the sum over the ranks' losses is the reference's one loss.  With a
replicated weight every rank's output is the whole product, and the
port's per-rank losses would count it n times; that layout is held on
its forward.

The fused train step (dp1·tp2 and dp2·tp2, f32) against the JAX package's
``tp_overlap="fused"`` loss and gradients on the same meshes: the loss to
1e-5 relative, the gathered gradients to rtol 1e-4 / atol 1e-6 (the
tolerance of ``test_torch_mesh_train.py``), and two AdamW steps.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.ops.collective_matmul import (  # noqa: E402
    allgather_matmul, matmul_reduce_scatter)
from ompi_tpu.parallel import make_mesh  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")
TOL = 1e-5


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    pool = W.Pool(n)
    yield n, pool, make_mesh({"x": n}, devices=jax.devices()[:n])
    pool.close()


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(kind, shape, n):
    """(x, w): for "ag" x is (…, m, k) cut by rows, w (k, c) by columns;
    for "rs" x (…, m, k) cut on k, w (k, c) on its rows."""
    lead = (2,) if shape == "3d" else ()
    if kind == "ag":
        return _normal(1, *lead, 8 * n, 12), _normal(2, 12, 8)
    return _normal(3, *lead, 8 * n, 6 * n), _normal(4, 6 * n, 10)


def _jax(kind, x, w, mesh, bidir, reverse, cot):
    def fn(x, w):
        if kind == "ag":
            return allgather_matmul(x, w, mesh, "x", w_sharded_axis="x",
                                    reverse=reverse, bidirectional=bidir)
        return matmul_reduce_scatter(x, w, mesh, "x", bidirectional=bidir)

    out = fn(jnp.asarray(x), jnp.asarray(w))
    grads = jax.jit(jax.grad(lambda x, w: jnp.sum(fn(x, w) * cot),
                             argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), [np.asarray(g) for g in grads]


SCHEDULES = [("ag", "uni"), ("ag", "reverse"), ("ag", "bidir"),
             ("rs", "uni"), ("rs", "bidir")]


@pytest.mark.parametrize("shape", ["2d", "3d"])
@pytest.mark.parametrize("kind,schedule", SCHEDULES)
def test_collective_matmul_matches_jax(world, kind, schedule, shape):
    n, pool, mesh = world
    x, w = _inputs(kind, shape, n)
    out_shape = (x @ w).shape
    cot = (np.arange(np.prod(out_shape), dtype=np.float32).reshape(
        out_shape) / np.prod(out_shape))
    bidir, reverse = schedule == "bidir", schedule == "reverse"
    want, (gx, gw) = _jax(kind, x, w, mesh, bidir, reverse, cot)
    np.testing.assert_allclose(want, x @ w, rtol=1e-4, atol=1e-4)
    got = pool.run("_torch_sync_worker:collmm", kind, x, w, bidir, reverse,
                   cot)
    if kind == "ag":
        # each rank holds its columns of the product and of w's gradient;
        # x's gradient is cut by rows
        out = np.concatenate([o for o, _, _ in got], axis=-1)
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        gx_got = np.concatenate([g for _, g, _ in got], axis=-2)
        gw_got = np.concatenate([g for _, _, g in got], axis=-1)
    else:
        out = np.concatenate([o for o, _, _ in got], axis=-2)
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        gx_got = np.concatenate([g for _, g, _ in got], axis=-1)
        gw_got = np.concatenate([g for _, _, g in got], axis=0)
    np.testing.assert_allclose(gx_got, gx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gw_got, gw, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bidir", [False, True])
def test_allgather_matmul_replicated_w(world, bidir):
    """The reference's test_allgather_matmul and its bidirectional case:
    w whole on every rank, every rank's output the whole product."""
    n, pool, mesh = world
    x, w = _normal(5, 6 * n, 16), _normal(6, 16, 20)
    want = np.asarray(allgather_matmul(jnp.asarray(x), jnp.asarray(w), mesh,
                                       "x", bidirectional=bidir))
    for out in pool.run("_torch_sync_worker:collmm", "ag", x, w, bidir,
                        w_cut=False):
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def test_bidirectional_odd_halves_raise(world):
    n, pool, mesh = world
    x, w = np.ones((3 * n, 8), np.float32), np.ones((8, 8), np.float32)
    with pytest.raises(ValueError, match="even per-rank row count"):
        allgather_matmul(jnp.asarray(x), jnp.asarray(w), mesh, "x",
                         bidirectional=True)
    for msg in pool.run("_torch_sync_worker:collmm_raises", "ag", x, w):
        assert "even per-rank row count" in msg
    x2, w2 = np.ones((3 * n, 4 * n), np.float32), np.ones((4 * n, 8),
                                                           np.float32)
    with pytest.raises(ValueError, match="even per-rank row count"):
        matmul_reduce_scatter(jnp.asarray(x2), jnp.asarray(w2), mesh, "x",
                              bidirectional=True)
    for msg in pool.run("_torch_sync_worker:collmm_raises", "rs", x2, w2):
        assert "even per-rank row count" in msg


# -- tp_overlap="fused" ------------------------------------------------------------

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=32, attn="dense", tp_overlap="fused")


@pytest.fixture(scope="module")
def fused_setup():
    jcfg = jax_tfm.Config(dtype=jnp.float32, **KW)
    jparams = jax_tfm.init_params(jax.random.key(3), jcfg)
    pool = W.Pool(4)
    yield jcfg, jparams, jax.tree.map(np.asarray, jparams), pool
    pool.close()


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, KW["vocab"],
                                                (4, KW["seq"] + 1),
                                                dtype=np.int32)


@pytest.mark.parametrize("axes", [{"dp": 1, "tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["dp1tp2", "dp2tp2"])
def test_fused_value_and_grad_matches_jax(fused_setup, axes):
    jcfg, jparams, tree, pool = fused_setup
    n = axes["dp"] * axes["tp"]
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    tokens = _tokens(n)
    sharded = jax_tfm.shard_params(jparams, mesh, jcfg)
    loss, grads = jax.jit(jax.value_and_grad(jax_tfm.loss_fn),
                          static_argnums=(2, 3))(
        sharded, jnp.asarray(tokens), jcfg, mesh)
    wgrads = [np.asarray(g) for g in jax.tree.leaves(grads)]
    kw = dict(KW, dtype="float32")
    if n == 2:
        # a world of four cannot hold a two-rank mesh: its own pool
        pool2 = W.Pool(2)
        try:
            got = pool2.run("_torch_sync_worker:fused_value_and_grad", axes,
                            kw, tree, tokens)
        finally:
            pool2.close()
    else:
        got = pool.run("_torch_sync_worker:fused_value_and_grad", axes, kw,
                       tree, tokens)
    for gloss, ggrads in got:
        assert abs(gloss - float(loss)) <= 1e-5 * abs(float(loss))
        for g, w in zip(ggrads, wgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_fused_train_steps_match_jax(fused_setup):
    jcfg, jparams, tree, pool = fused_setup
    axes = {"dp": 2, "tp": 2}
    mesh = make_mesh(axes, devices=jax.devices()[:4])
    batches = [_tokens(30 + i) for i in range(2)]
    init, step = jax_tfm.make_train_step(jcfg, mesh)
    params = jax_tfm.shard_params(jparams, mesh, jcfg)
    state, jlosses = init(params), []
    for b in batches:
        params, state, loss = step(params, state, jnp.asarray(b))
        jlosses.append(float(loss))
    want = [np.asarray(x) for x in jax.tree.leaves(params)]
    kw = dict(KW, dtype="float32")
    for losses, leaves in pool.run("_torch_sync_worker:train", axes, kw,
                                   tree, batches, 1e-3):
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for g, w in zip(leaves, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
