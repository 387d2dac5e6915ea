"""The port's gradient-sync schedulers (``ompi_tpu_torch/parallel/
overlap.py`` and ``grad_sync="quant"``) against the JAX package's, on the
CPU.

The port runs one gloo process a dp rank (worlds of 2 and 4); the JAX
package runs the same small f32 config on 2 and 4 virtual devices.  The
same numpy weights and tokens go to both.

* ``bucket_plan`` gives the JAX package's buckets on the same leaves.
* perleaf and bucketed against the JAX package's per-shard gradients
  averaged by ``lax.pmean`` in a ``shard_map`` the test builds: the loss
  to 1e-5 relative, every leaf to rtol 1e-4 / atol 1e-6 (the tolerance of
  ``test_torch_mesh_train.py``: the frameworks sum in other orders).  The
  JAX package's own ``make_grad_sync`` is not the yardstick here: with
  the installed JAX, its shard_map checks replication (``check_vma``),
  and the gradient of the replicated parameters then already sums over dp
  before its ``pmean`` (the cause of its own failing
  ``test_bucketed_matches_gspmd_native``); the test's shard_map turns the
  check off, as its ``psum_quant`` test does.
* bucketed against the port's own perleaf: bitwise at dp 2 (a sum of two
  numbers does not depend on its order), and at dp 4 within f32
  reassociation: gloo's ring allreduce cuts its buffer into chunks by
  position and adds the four contributions in an order that depends on
  the chunk an element falls in, and a bucket puts each element at
  another position than its own leaf's buffer does.
* quant, and bucketed with its buckets forced onto the quant arm,
  against JAX's per-shard gradients averaged by ``psum_quant`` (a leaf or
  a bucket at a time) in a ``shard_map`` the test builds (the JAX package's own quant train step
  does not trace with the installed JAX: shard_map cannot infer the replication
  of its gradient output over dp), each element within one int8 step of
  its block's scale in the JAX result.
* unsynced: each rank's gradient is its own shard's (the JAX gradient of
  its rows alone).
* Two train steps of perleaf and bucketed against the JAX package's
  perleaf gradients under optax's AdamW.
* The refusals of the reference's ``test_validation_errors``.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.coll import quant as j_quant  # noqa: E402
from ompi_tpu.jaxcompat import shard_map  # noqa: E402
from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh  # noqa: E402
from ompi_tpu.parallel import overlap as j_overlap  # noqa: E402
from ompi_tpu_torch.parallel import overlap as t_overlap  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=32, attn="dense")
BUCKET = 4096
pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def _cfgs(**extra):
    kw = dict(KW, **extra)
    return jax_tfm.Config(dtype=jnp.float32, **kw), dict(kw,
                                                         dtype="float32")


def _tokens(seed, n=8):
    return np.random.default_rng(seed).integers(0, KW["vocab"],
                                                (n, KW["seq"] + 1),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jparams = jax_tfm.init_params(jax.random.key(0), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    pool = W.Pool(n)
    yield n, pool, make_mesh({"dp": n}, devices=jax.devices()[:n])
    pool.close()


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# -- bucket planning -------------------------------------------------------------

@pytest.mark.parametrize("sizes,targets", [
    ([100, 7, 300, 1, 50, 1024, 3, 900], (64, 256, 1024, 4096, 1 << 20)),
    ([10, 20, 30, 40], (1,)),
    ([17, 9, 33, 2, 41, 5, 28], (100,)),
    ([8, 8], (1 << 30,))])
def test_bucket_plan_matches_jax(sizes, targets):
    import torch
    leaves = [np.zeros(s, np.float32) for s in sizes]
    tensors = [torch.zeros(s) for s in sizes]
    for target in targets:
        want = j_overlap.bucket_plan(leaves, target)
        for got in (t_overlap.bucket_plan(leaves, target),
                    t_overlap.bucket_plan(tensors, target)):
            assert [(b.indices, b.nbytes) for b in got.buckets] == \
                [(b.indices, b.nbytes) for b in want.buckets]
            assert (got.total_bytes, got.bucket_bytes, got.n_leaves,
                    got.n_buckets, got.max_buckets) == \
                (want.total_bytes, want.bucket_bytes, want.n_leaves,
                 want.n_buckets, want.max_buckets)
            assert got.n_buckets <= max(1, math.ceil(got.total_bytes
                                                     / target))


def test_bucket_plan_of_the_model_matches_jax(weights):
    jparams, tree = weights
    from ompi_tpu_torch import optim
    from ompi_tpu_torch.models import transformer as tfm
    params = tfm.params_from_numpy(tree, device="cpu")
    for target in (BUCKET, 1 << 20):
        want = j_overlap.bucket_plan(jax.tree.leaves(jparams), target)
        got = t_overlap.bucket_plan(optim.tree_leaves(params), target)
        assert [(b.indices, b.nbytes) for b in got.buckets] == \
            [(b.indices, b.nbytes) for b in want.buckets]
        assert got.total_bytes == want.total_bytes


def test_resolve_bucket_bytes():
    assert t_overlap.resolve_bucket_bytes(None) == (4 << 20)
    assert t_overlap.resolve_bucket_bytes(12345) == 12345
    with pytest.raises(ValueError, match="grad_bucket_bytes"):
        t_overlap.resolve_bucket_bytes(0)
    with pytest.raises(ValueError, match="bucket_bytes"):
        t_overlap.bucket_plan([np.zeros(8, np.float32)], 0)


# -- the modes against the JAX package -------------------------------------------

def _jax_synced(jcfg, mesh, n, quant=False):
    """Per-shard gradients inside the test's own shard_map over dp, each
    leaf averaged by lax.pmean, or by psum_quant with ``quant``; the loss
    by lax.pmean.  Jitted: ``fn(params, tokens) -> (loss, grads)``."""
    def sync(g):
        if quant:
            return j_quant.psum_quant(g, "dp", n, avg=True,
                                      block=jcfg.grad_sync_block)
        return lax.pmean(g, "dp")

    def local(params, t):
        loss, grads = jax.value_and_grad(jax_tfm.loss_fn)(params, t, jcfg,
                                                          None)
        return lax.pmean(loss, "dp"), jax.tree.map(sync, grads)

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P("dp")),
                             out_specs=(P(), P()), check_vma=False))


def _jax_local(jcfg, jparams, tokens, n):
    """Each dp shard's own (loss, gradients), no sync."""
    vg = jax.jit(jax.value_and_grad(jax_tfm.loss_fn), static_argnums=(2,))
    out = []
    for shard in np.split(tokens, n):
        loss, grads = vg(jparams, jnp.asarray(shard), jcfg)
        out.append((float(loss), _leaves(grads)))
    return out


def _within_one_step(got, want, block):
    """Each element within amax / 127 of its block in ``want`` (the leaf
    flattened and padded to whole blocks, as psum_quant lays it out)."""
    flat_w, flat_g = want.reshape(-1), got.reshape(-1)
    pad = -flat_w.size % block
    w = np.pad(flat_w, (0, pad)).reshape(-1, block)
    g = np.pad(flat_g, (0, pad)).reshape(-1, block)
    step = np.abs(w).max(axis=-1, keepdims=True) / 127.0
    return bool(np.all(np.abs(g - w) <= step * (1 + 1e-5) + 1e-9))


@pytest.mark.parametrize("mode", ["perleaf", "bucketed", "quant",
                                  "unsynced"])
def test_grad_sync_matches_jax(world, weights, mode):
    n, pool, jmesh = world
    jparams, tree = weights
    jcfg, kw = _cfgs(grad_sync=mode, grad_bucket_bytes=BUCKET)
    tokens = _tokens(seed=n)
    got = pool.run("_torch_sync_worker:grad_sync", {"dp": n}, kw, tree,
                   tokens)
    local = _jax_local(jcfg, jparams, tokens, n)
    mean_loss = float(np.mean([loss for loss, _ in local]))
    if mode != "unsynced":
        loss, grads = _jax_synced(jcfg, jmesh, n, mode == "quant")(
            jparams, jnp.asarray(tokens))
        want = (float(loss), _leaves(grads))
    for rank, (loss, grads, pvars) in enumerate(got):
        assert abs(loss - mean_loss) <= 1e-5 * abs(mean_loss)
        if mode == "unsynced":
            want = local[rank]
        assert len(grads) == len(want[1])
        for g, w in zip(grads, want[1]):
            if mode == "quant":
                assert _within_one_step(g, w, jcfg.grad_sync_block)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        if mode == "bucketed":
            plan = j_overlap.bucket_plan(jax.tree.leaves(jparams), BUCKET)
            assert pvars == {"grad_bucket_count": plan.n_buckets,
                             "grad_bucket_bytes": plan.total_bytes}
    if mode != "unsynced":
        # every rank holds the same synced gradients
        for _, grads, _ in got[1:]:
            for g, g0 in zip(grads, got[0][1]):
                np.testing.assert_array_equal(g, g0)


def test_quant_buckets_match_jax(world, weights):
    """Bucketed with every bucket forced onto the quant arm
    (``coll_nccl_grad_sync_mode=quant``) against the JAX package's
    per-shard gradients with each bucket's concatenated f32 gradients
    averaged by one psum_quant, in the test's shard_map; each element
    within one int8 step of its block in the JAX bucket."""
    n, pool, jmesh = world
    jparams, tree = weights
    jcfg, kw = _cfgs(grad_sync="bucketed", grad_bucket_bytes=BUCKET)
    tokens = _tokens(seed=40 + n)
    leaves = jax.tree.leaves(jparams)
    plan = j_overlap.bucket_plan(leaves, BUCKET)

    def local(params, t):
        loss, grads = jax.value_and_grad(jax_tfm.loss_fn)(params, t, jcfg,
                                                          None)
        g, tree_def = jax.tree.flatten(grads)
        out = list(g)
        for b in plan.buckets:
            flat = jnp.concatenate([g[j].reshape(-1) for j in b.indices])
            flat = j_quant.psum_quant(flat, "dp", n, avg=True,
                                      block=jcfg.grad_sync_block)
            off = 0
            for j in b.indices:
                out[j] = flat[off:off + g[j].size].reshape(g[j].shape)
                off += g[j].size
        return lax.pmean(loss, "dp"), jax.tree.unflatten(tree_def, out)

    fn = jax.jit(shard_map(local, mesh=jmesh, in_specs=(P(), P("dp")),
                           out_specs=(P(), P()), check_vma=False))
    _, jgrads = fn(jparams, jnp.asarray(tokens))
    want = _leaves(jgrads)
    got = pool.run("_torch_sync_worker:grad_sync", {"dp": n}, kw, tree,
                   tokens, force="quant")
    for _, grads, pvars in got:
        assert pvars["grad_bucket_count"] == plan.n_buckets
        for b in plan.buckets:
            g = np.concatenate([grads[j].reshape(-1) for j in b.indices])
            w = np.concatenate([want[j].reshape(-1) for j in b.indices])
            assert _within_one_step(g, w, jcfg.grad_sync_block)


def test_bucketed_matches_perleaf(world, weights):
    n, pool, _ = world
    _, tree = weights
    tokens = _tokens(seed=10 + n)
    runs = {}
    for mode in ("perleaf", "bucketed"):
        _, kw = _cfgs(grad_sync=mode, grad_bucket_bytes=BUCKET)
        runs[mode] = pool.run("_torch_sync_worker:grad_sync", {"dp": n}, kw,
                              tree, tokens)
    for (lp, gp, _), (lb, gb, _) in zip(runs["perleaf"], runs["bucketed"]):
        assert lp == lb
        for a, b in zip(gp, gb):
            if n == 2:
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=1e-6, atol=1e-6 * float(np.abs(a).max()))


@pytest.mark.parametrize("mode", ["perleaf", "bucketed"])
def test_train_steps_match_jax(weights, mode):
    """Two AdamW steps at dp 4 against optax over the JAX package's
    perleaf gradients."""
    import optax

    jparams, tree = weights
    jcfg, kw = _cfgs(grad_sync=mode, grad_bucket_bytes=BUCKET)
    mesh = make_mesh({"dp": 4}, devices=jax.devices()[:4])
    batches = [_tokens(seed=20 + i, n=4) for i in range(2)]
    vg = _jax_synced(jcfg, mesh, 4)
    tx = optax.adamw(1e-3)
    params, state, jlosses = jparams, tx.init(jparams), []
    for b in batches:
        loss, grads = vg(params, jnp.asarray(b))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(loss))
    want = _leaves(params)
    pool = W.Pool(4)
    try:
        out = pool.run("_torch_sync_worker:train", {"dp": 4}, kw, tree,
                       batches, 1e-3)
    finally:
        pool.close()
    for losses, leaves in out:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for g, w in zip(leaves, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_validation_errors(world):
    """The reference's refusals: a dp×tp mesh (dp-only), a mesh without
    dp, an unknown mode, no mesh, an unknown grad_sync, the per-leaf quant
    sync on a dpo×dp mesh; and what the reference builds, the bucketed
    sync over a two-tier dpo×dp domain (its arms are held in
    ``tests/test_torch_overlap_hier.py``)."""
    n, pool, _ = world
    jmesh = make_mesh({"dp": 2, "tp": 4})
    jmesh_dpo = make_mesh({"dpo": 2, "dp": n // 2},
                          devices=jax.devices()[:n])
    j_overlap.make_grad_sync("bucketed", jmesh_dpo, lambda p, t: 0.0)
    want = {}
    for name, fn in {
            "quant_dpo": lambda: jax_tfm.make_train_step(
                _cfgs(grad_sync="quant")[0], mesh=jmesh_dpo),
            "dp_tp": lambda: j_overlap.make_grad_sync(
                "bucketed", jmesh, lambda p, t: 0.0),
            "tp_only": lambda: j_overlap.make_grad_sync(
                "bucketed", make_mesh({"tp": 8}), lambda p, t: 0.0),
            "banana": lambda: j_overlap.make_grad_sync(
                "banana", make_mesh({"dp": 8}), lambda p, t: 0.0),
            "no_mesh": lambda: jax_tfm.make_train_step(
                _cfgs(grad_sync="bucketed")[0], mesh=None),
            "unknown": lambda: jax_tfm.make_train_step(
                _cfgs(grad_sync="nope")[0], mesh=make_mesh({"dp": 8}))}.items():
        with pytest.raises(ValueError) as exc:
            fn()
        want[name] = str(exc.value)
    _, kw = _cfgs()
    for got in pool.run("_torch_sync_worker:refusals", kw):
        for name, msg in want.items():
            kind, text = got[name]
            assert kind == "ValueError", (name, got[name])
            # the reference's message, up to its first colon (the port
            # has no shard_map to name after it)
            head = msg.split(":")[0]
            assert text.startswith(head), (name, text, msg)
        assert got["dpo"] is None
