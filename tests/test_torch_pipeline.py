"""The port's GPipe schedule (``ompi_tpu_torch/parallel/pipeline.py``)
against the JAX package's, on the CPU.

The port runs one gloo process a rank in a world of 8, a pp 4 × dp 2 mesh
(the microbatches replicated over dp); the JAX package runs
``tests/test_pipeline_moe.py``'s toy stage (tanh(x @ w + b) a layer, 8
layers of width 16 in 4 stages, 6 microbatches of 2 rows) on the same
mesh of 8 virtual CPU devices.  The same numpy weights, microbatches and
cotangent go to both.

* The outputs against the JAX ``pipeline``'s, and both against the 8
  layers applied in order: f32 to the reference's rtol 2e-5 / atol 2e-5.
* The gradients of sum(out · cot): each stage's parameters against its
  stage of ``jax.grad`` of the JAX ``pipeline`` (which equals ``jax.grad``
  of the layers in order, checked here first), and the microbatches' (on
  stage 0, the only stage that reads them), to rtol 1e-4 / atol 1e-5 (the
  backward crosses the point-to-point shifts and the recompute of
  ``torch.utils.checkpoint``).  Without the checkpoint as well.
* The layer-split refusal ("do not split").
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu.parallel import make_mesh  # noqa: E402
from ompi_tpu.parallel.pipeline import (  # noqa: E402
    pipeline, shard_stage_params, stack_stage_params)

import _torch_coll_worker as W  # noqa: E402

AXES = {"pp": 4, "dp": 2}
D, L, M, MB = 16, 8, 6, 2

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(8)
    yield p
    p.close()


def _layer(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage(sp, x):
    def body(h, p):
        return _layer(p, h), None
    out, _ = jax.lax.scan(body, x, sp)
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    layers = [{"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(
        np.float32), "b": (0.1 * rng.standard_normal(D)).astype(np.float32)}
        for _ in range(L)]
    mbs = rng.standard_normal((M, MB, D)).astype(np.float32)
    cot = rng.standard_normal((M, MB, D)).astype(np.float32)
    mesh = make_mesh(AXES)
    jl = [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]
    stacked = stack_stage_params(jl, 4)
    sharded = shard_stage_params(stacked, mesh, "pp")

    def loss_p(params, x):
        return jnp.sum(pipeline(_stage, params, x, mesh, "pp")
                       * jnp.asarray(cot))

    def loss_seq(params, x):
        h = x
        for i in range(L):
            h = _layer(jax.tree.map(lambda a: a[i // 2, i % 2], params), h)
        return jnp.sum(h * jnp.asarray(cot))

    out = np.asarray(pipeline(_stage, sharded, jnp.asarray(mbs), mesh, "pp"))
    seq = jnp.asarray(mbs)
    for p in jl:
        seq = _layer(p, seq)
    np.testing.assert_allclose(out, np.asarray(seq), rtol=2e-5, atol=2e-5)
    g = jax.grad(loss_p, argnums=(0, 1))(sharded, jnp.asarray(mbs))
    gs = jax.grad(loss_seq, argnums=(0, 1))(stacked, jnp.asarray(mbs))
    for a, b in ((g[0]["w"], gs[0]["w"]), (g[0]["b"], gs[0]["b"]),
                 (g[1], gs[1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    return layers, mbs, cot, out, {k: np.asarray(v) for k, v in
                                   g[0].items()}, np.asarray(g[1])


@pytest.mark.parametrize("checkpoint", [True, False])
def test_pipeline_matches_jax(pool, case, checkpoint):
    layers, mbs, cot, want, wparams, wx = case
    res = pool.run("_torch_p13_worker:pipe", AXES, layers, mbs, cot,
                   checkpoint=checkpoint)
    stages = sorted(r[2] for r in res)
    assert stages == [0, 0, 1, 1, 2, 2, 3, 3]
    for out, loss, stage, gw, gb, gx in res:
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
        assert abs(loss - float((want * cot).sum())) <= 1e-4 * abs(loss)
        np.testing.assert_allclose(gw, wparams["w"][stage], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(gb, wparams["b"][stage], rtol=1e-4,
                                   atol=1e-5)
        if stage == 0:
            np.testing.assert_allclose(gx, wx, rtol=1e-4, atol=1e-5)
        else:
            assert not gx.any()


def test_layer_split_refused(pool):
    with pytest.raises(ValueError, match="do not split"):
        stack_stage_params([{"w": jnp.zeros(2)}] * 3, 2)
    for msg in pool.run("_torch_p13_worker:pipe_bad_split", 3, 2):
        assert msg is not None and "do not split" in msg
