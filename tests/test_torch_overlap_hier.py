"""The port's bucketed gradient sync over a two-tier dpo×dp domain (the
``hier`` and ``hier+quant`` bucket arms of ``ompi_tpu_torch/parallel/
overlap.py``) against the JAX package's, on the CPU.

The port runs one gloo process a rank in a world of 4, a {"dpo": 2,
"dp": 2} mesh with dpo classified slow by the simulated-DCN override; the
JAX package runs the same small f32 config on 4 virtual CPU devices.  The
batch is cut row-major over dpo×dp in both.

The yardstick is the JAX package's per-shard gradients in a ``shard_map``
the test builds with the replication check off (as
``tests/test_torch_overlap.py`` builds its own: the JAX package's
``make_grad_sync`` gives n× the mean with the installed JAX), each bucket
of f32 gradients synced as the reference's bucket tag syncs it:
``lax.pmean`` over (dpo, dp) for native, ``hierarchical_psum`` / n for
hier, ``hierarchical_psum_quant`` / n for hier+quant.

* perleaf and bucketed with native buckets against the native yardstick,
  hier against the hier one: the loss to 1e-5 relative, every leaf to
  rtol 1e-4 / atol 1e-6 (the frameworks sum in other orders);
* hier+quant within one int8 step of its block in the JAX hier+quant
  bucket (``coll/quant``'s error model: the codec is the same, the f32
  accumulations may round apart);
* the decided arm: with no rules row native, with a
  ``grad_sync@dcn 1 0 hier`` row hier on every bucket;
* on an all-ICI dpo×dp mesh (no override) a forced hier raises the
  reference's ineligibility, and the decided arm stays native.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.jaxcompat import shard_map  # noqa: E402
from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import hierarchy as j_hier  # noqa: E402
from ompi_tpu.parallel import make_mesh  # noqa: E402
from ompi_tpu.parallel import overlap as j_overlap  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=32, attn="dense")
AXES = {"dpo": 2, "dp": 2}
BUCKET = 4096
pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tfm.Config(dtype=jnp.float32, **KW)
    jparams = jax_tfm.init_params(jax.random.key(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(0, KW["vocab"],
                                             (8, KW["seq"] + 1),
                                             dtype=np.int32)


def _kw(mode):
    return dict(KW, dtype="float32", grad_sync=mode,
                grad_bucket_bytes=BUCKET)


def _yardstick(jcfg, jparams, tokens, arm):
    """(loss, leaves) of the per-shard gradients with every bucket of the
    reference's plan synced by ``arm`` over the dpo×dp domain."""
    mesh = make_mesh(AXES, devices=jax.devices()[:4])
    plan = j_overlap.bucket_plan(jax.tree.leaves(jparams), BUCKET)
    axes = ("dpo", "dp")

    def sync(flat):
        if arm == "hier":
            return j_hier.hierarchical_psum(flat, "dp", "dpo") / 4
        if arm == "hier+quant":
            return j_hier.hierarchical_psum_quant(
                flat, "dp", "dpo", 2, block=jcfg.grad_sync_block) / 4
        return lax.pmean(flat, axes)

    def local(params, t):
        loss, grads = jax.value_and_grad(jax_tfm.loss_fn)(params, t, jcfg,
                                                          None)
        g, tree_def = jax.tree.flatten(grads)
        out = list(g)
        for b in plan.buckets:
            flat = sync(jnp.concatenate([g[j].reshape(-1)
                                         for j in b.indices]))
            off = 0
            for j in b.indices:
                out[j] = flat[off:off + g[j].size].reshape(g[j].shape)
                off += g[j].size
        return lax.pmean(loss, axes), jax.tree.unflatten(tree_def, out)

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(axes)),
                           out_specs=(P(), P()), check_vma=False))
    loss, grads = fn(jparams, jnp.asarray(tokens))
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(grads)], \
        plan


def _within_one_step(got, want, block):
    flat_w, flat_g = want.reshape(-1), got.reshape(-1)
    pad = -flat_w.size % block
    w = np.pad(flat_w, (0, pad)).reshape(-1, block)
    g = np.pad(flat_g, (0, pad)).reshape(-1, block)
    step = np.abs(w).max(axis=-1, keepdims=True) / 127.0
    return bool(np.all(np.abs(g - w) <= step * (1 + 1e-5) + 1e-9))


@pytest.mark.parametrize("mode,force,arm", [
    ("perleaf", None, "native"), ("bucketed", "native", "native"),
    ("bucketed", "hier", "hier"), ("bucketed", "hier+quant", "hier+quant")])
def test_two_tier_arms_match_jax(pool, weights, tokens, mode, force, arm):
    jcfg, jparams, tree = weights
    wloss, want, plan = _yardstick(jcfg, jparams, tokens, arm)
    got = pool.run("_torch_p13_worker:grad_sync", AXES, "dpo", _kw(mode),
                   tree, tokens, force=force)
    for loss, grads, arms in got:
        assert abs(loss - wloss) <= 1e-5 * abs(wloss)
        if mode == "bucketed":
            assert arms == [arm] * plan.n_buckets
        if arm == "hier+quant":
            for b in plan.buckets:
                g = np.concatenate([grads[j].reshape(-1) for j in b.indices])
                w = np.concatenate([want[j].reshape(-1) for j in b.indices])
                assert _within_one_step(g, w, jcfg.grad_sync_block)
        else:
            for g, w in zip(grads, want):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    for _, grads, _ in got[1:]:          # every rank holds the same sync
        for g, g0 in zip(grads, got[0][1]):
            np.testing.assert_array_equal(g, g0)


def test_decided_arm(pool, weights, tokens, tmp_path):
    jcfg, jparams, tree = weights
    rules = tmp_path / "rules.txt"
    rules.write_text("grad_sync 1 0 native\ngrad_sync@dcn 1 0 hier\n")
    plan = j_overlap.bucket_plan(jax.tree.leaves(jparams), BUCKET)
    _, native, _ = _yardstick(jcfg, jparams, tokens, "native")
    for _, grads, arms in pool.run("_torch_p13_worker:grad_sync", AXES,
                                   "dpo", _kw("bucketed"), tree, tokens):
        assert arms == ["native"] * plan.n_buckets
        for g, w in zip(grads, native):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    _, hier, _ = _yardstick(jcfg, jparams, tokens, "hier")
    got = pool.run("_torch_p13_worker:grad_sync", AXES, "dpo",
                   _kw("bucketed"), tree, tokens, rules=str(rules))
    for _, grads, arms in got:
        assert arms == ["hier"] * plan.n_buckets
        for g, w in zip(grads, hier):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_flat_domain_refuses_forced_hier(pool, weights, tokens):
    jcfg, jparams, tree = weights
    for got in pool.run("_torch_p13_worker:grad_sync", AXES, None,
                        _kw("bucketed"), tree, tokens, force="hier"):
        assert got[0] == "ValueError"
        assert "ineligible: single-plane mesh (no DCN axis among " \
               "('dpo', 'dp'))" in got[1]
    plan = j_overlap.bucket_plan(jax.tree.leaves(jparams), BUCKET)
    for _, _, arms in pool.run("_torch_p13_worker:grad_sync", AXES, None,
                               _kw("bucketed"), tree, tokens):
        assert arms == ["native"] * plan.n_buckets
