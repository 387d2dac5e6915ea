"""The port's MoE mesh train step (``models/moe.moe_block_mesh`` in the
mesh step) against the JAX package's, on the CPU.

The JAX package places the parameters with ``shard_params`` on the virtual
CPU mesh (the experts over ep, their features over tp) and lets GSPMD run
the single program, so its capacity, slots and aux are those of the whole
batch.  The port runs one gloo process a rank with its ``shard_params``
shards and writes the collectives out: the expert ids all-gathered over
dp × sp, the experts' inputs summed over dp × sp, the experts' outputs
all-gathered over ep.  The same numpy weights and tokens go to both.

The config is the reference's own test's (``tests/test_pipeline_moe.py::
TestMoE::test_moe_flagship_train_step_on_ep_mesh``: vocab 64, d 32, two
layers of 4 × 8 heads, d_ff 64, seq 16, 4 experts, top 2), in f32.
Tolerances are ``test_torch_mesh_train.py``'s: the loss to 1e-5 relative,
every gathered gradient leaf to rtol 1e-4 / atol 1e-6, three train steps'
losses to 1e-4 relative and the parameters after them to 1e-5 absolute.
The routing ids are compared first and must agree exactly: a flipped id
would move a token to another expert, which no tolerance covers.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.jaxcompat import shard_map  # noqa: E402
from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
          seq=16, mlp="moe", n_experts=4, moe_top_k=2)
DET = {"dp": 2, "ep": 2, "tp": 2}
# the second case's capacity factor: the global routing and the routing
# over each dp shard's own tokens drop different tokens there
LOW_CF = 0.5

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def _cfgs(attn="flash", dtype="float32", **extra):
    kw = dict(KW, attn=attn, **extra)
    return jax_tfm.Config(dtype=getattr(jnp, dtype), **kw), dict(
        kw, dtype=dtype)


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
    jcfg, _ = _cfgs()
    jparams = jax_tfm.init_params(jax.random.key(0), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _jax_vg(jcfg, jparams, axes, tokens):
    mesh = make_mesh(axes)
    sharded = jax_tfm.shard_params(jparams, mesh, jcfg)
    loss, grads = jax.jit(jax.value_and_grad(jax_tfm.loss_fn),
                          static_argnums=(2, 3))(
        sharded, jnp.asarray(tokens), jcfg, mesh)
    return float(loss), grads


def _jax_ids(jcfg, jparams, tokens):
    """The reference's expert ids of each layer, (B·S, k), and its router
    probabilities (B·S, E), from its one-device forward run eagerly with
    ``lax.top_k`` recorded."""
    ids, real = [], lax.top_k

    def rec(x, k):
        vals, idx = real(x, k)
        ids.append((np.asarray(idx), np.asarray(x)))
        return vals, idx

    lax.top_k = rec
    try:
        with jax.disable_jit():
            jax_tfm.forward(jparams, jnp.asarray(tokens[:, :-1]), jcfg)
    finally:
        lax.top_k = real
    return ids


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _assert_vg(got, want):
    wloss, wgrads = want
    wleaves = _leaves(wgrads)
    for loss, grads, *_ in got:
        assert abs(loss - wloss) <= 1e-5 * abs(wloss)
        assert len(grads) == len(wleaves)
        for g, w in zip(grads, wleaves):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def _kept(ids, capacity, n_experts):
    """The reference's position loop on (T, k) ids: which (token, slot)
    pairs keep their expert."""
    used = np.zeros(n_experts, np.int64)
    keep = np.zeros(ids.shape, bool)
    for slot in range(ids.shape[1]):
        e = ids[:, slot]
        onehot = (e[:, None] == np.arange(n_experts)).astype(np.int64)
        pos = ((np.cumsum(onehot, 0) - 1) * onehot).sum(1) + used[e]
        keep[:, slot] = pos < capacity
        used += (onehot * keep[:, slot, None]).sum(0)
    return keep


def _capacity(tokens, cf):
    k, E = KW["moe_top_k"], KW["n_experts"]
    return max(int(np.ceil(tokens * k * cf / E)), k)


def _drops(ids, cf, shards):
    """The kept mask of the global routing and of each of ``shards``
    batch shards routed over its own tokens, (T, k) each."""
    T = ids.shape[0]
    glob = _kept(ids, _capacity(T, cf), KW["n_experts"])
    n = T // shards
    local = np.concatenate([
        _kept(ids[i * n:(i + 1) * n], _capacity(n, cf), KW["n_experts"])
        for i in range(shards)])
    return glob, local


def _gather_ids(got, axes, batch=4):
    """Every rank's recorded (b·s, k) ids of each layer put back into the
    one-card (B·S, k) order by its dp and sp coordinates."""
    out = []
    dp, sp = axes.get("dp", 1), axes.get("sp", 1)
    for layer in range(KW["n_layers"]):
        blocks = {}
        for *_, coord, ids in got:
            blocks[coord.get("dp", 0), coord.get("sp", 0)] = \
                ids[layer].reshape(batch // dp, KW["seq"] // sp, -1)
        rows = [np.concatenate([blocks[d, s] for s in range(sp)], axis=1)
                for d in range(dp)]
        full = np.concatenate(rows, axis=0)
        out.append(full.reshape(-1, full.shape[-1]))
    return out


def _ids_agree(port, ref):
    """Every token's ids in slot order equal the reference's; a flip is
    reported with the reference's probability gap between its k-th and
    (k+1)-th expert (a near tie, if that gap is ~1e-7)."""
    for layer, (p, (r, probs)) in enumerate(zip(port, ref)):
        flips = np.flatnonzero((p != r).any(1))
        k = r.shape[1]
        top = -np.sort(-probs[flips], axis=1)
        gaps = (top[:, k - 1] - top[:, k]).tolist() if flips.size else []
        assert flips.size == 0, (
            f"layer {layer}: tokens {flips.tolist()} route otherwise in "
            f"the port than in the reference; the reference's gaps "
            f"between its k-th and next probability: {gaps}")


def test_shard_params_round_trip_bitwise(pool8, weights):
    """gather_params undoes shard_params bit for bit on the MoE tree, and
    each rank holds experts [ep·E/ep, …) with tp's slice of their
    features (moe_param_specs)."""
    _, tree = weights
    _, kw = _cfgs()
    out = pool8.run("_torch_mesh_worker:moe_roundtrip", DET, kw, tree)
    moe = tree["layers"][0]["moe"]
    n_e = KW["n_experts"] // DET["ep"]
    f = KW["d_ff"] // DET["tp"]
    for same, coord, w_gate, w_down in out:
        assert same
        e, t = coord["ep"], coord["tp"]
        np.testing.assert_array_equal(
            w_gate, moe["w_gate"][e * n_e:(e + 1) * n_e, :, t * f:(t + 1) * f])
        np.testing.assert_array_equal(
            w_down, moe["w_down"][e * n_e:(e + 1) * n_e, t * f:(t + 1) * f])


@pytest.fixture(scope="module")
def main_case(pool8, weights):
    jparams, tree = weights
    jcfg, kw = _cfgs()
    tokens = _tokens((4, KW["seq"] + 1), 0)
    got = pool8.run("_torch_mesh_worker:moe_value_and_grad", DET, kw, tree,
                    tokens)
    return tokens, got, _jax_vg(jcfg, jparams, DET, tokens)


def test_routing_ids_match_jax(weights, main_case):
    """The port's expert ids at dp2·ep2·tp2, every rank's block put back
    in order, equal the reference's, layer by layer."""
    jparams, _ = weights
    tokens, got, _ = main_case
    jcfg, _ = _cfgs()
    _ids_agree(_gather_ids(got, DET), _jax_ids(jcfg, jparams, tokens))


def test_value_and_grad_matches_jax(main_case):
    """dp2·ep2·tp2, attn="flash": the loss and every gathered gradient
    leaf against the reference's GSPMD step, and the router's gradient as
    each rank holds it (every ep and tp rank the whole, after the sum over
    dp × sp) against the reference's."""
    _, got, want = main_case
    _assert_vg(got, want)
    routers = [np.asarray(layer["moe"]["router"])
               for layer in want[1]["layers"]]
    eps = set()
    for _, _, mine, coord, _ in got:
        eps.add(coord["ep"])
        for g, w in zip(mine, routers):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    assert eps == {0, 1}


def test_global_capacity_matches_jax(pool8, weights):
    """At cf LOW_CF the global routing and the routing over each dp
    shard's own tokens drop different tokens (numpy, on the reference's
    ids); the port matches the reference's global routing there, and with
    its capacity and positions taken over the rank's own tokens it does
    not."""
    jparams, tree = weights
    jcfg, kw = _cfgs(moe_capacity_factor=LOW_CF)
    tokens = _tokens((4, KW["seq"] + 1), 2)
    ref_ids = _jax_ids(jcfg, jparams, tokens)
    differ = []
    for ids, _ in ref_ids:
        glob, local = _drops(ids, LOW_CF, DET["dp"])
        differ.append(bool((glob != local).any()))
    assert any(differ), "the global and the rank-local routing agree"
    want = _jax_vg(jcfg, jparams, DET, tokens)
    got = pool8.run("_torch_mesh_worker:moe_value_and_grad", DET, kw, tree,
                    tokens)
    _ids_agree(_gather_ids(got, DET), ref_ids)
    _assert_vg(got, want)
    bad = pool8.run("_torch_mesh_worker:moe_value_and_grad", DET, kw, tree,
                    tokens, fault="local_capacity")
    with pytest.raises(AssertionError):
        _assert_vg(bad, want)


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 2}, {"ep": 4}],
                         ids=["dp2_ep2", "ep4"])
def test_other_layouts_match_one_card(pool4, weights, axes):
    """dp2·ep2 and ep4 (one expert a rank) against the port's one-card
    step on the same weights and tokens (itself held to the reference in
    ``test_torch_moe.py``)."""
    import torch
    from ompi_tpu_torch import optim
    from ompi_tpu_torch.models import transformer as tfm
    _, tree = weights
    _, kw = _cfgs()
    tokens = _tokens((4, KW["seq"] + 1), 3)
    cfg = tfm.Config(**dict(kw, dtype=torch.float32))
    loss, grads = tfm.value_and_grad(tfm.params_from_numpy(tree, "cpu"),
                                     tokens, cfg, device="cpu")
    want = (float(loss), [g.numpy() for g in grads])
    got = pool4.run("_torch_mesh_worker:moe_value_and_grad", axes, kw, tree,
                    tokens)
    for loss, leaves, *_ in got:
        assert abs(loss - want[0]) <= 1e-5 * abs(want[0])
        for g, w in zip(leaves, want[1]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    assert len(optim.tree_leaves(tree)) == len(want[1])


def test_sp_ep_ring_matches_jax(pool8, weights):
    """sp2·ep2·tp2 with attn="ring": the tokens cut over sp, their ids
    gathered over it, against the reference's GSPMD step."""
    jparams, tree = weights
    jcfg, kw = _cfgs(attn="ring")
    axes = {"sp": 2, "ep": 2, "tp": 2}
    tokens = _tokens((4, KW["seq"] + 1), 4)
    want = _jax_vg(jcfg, jparams, axes, tokens)
    got = pool8.run("_torch_mesh_worker:moe_value_and_grad", axes, kw, tree,
                    tokens)
    _ids_agree(_gather_ids(got, axes), _jax_ids(jcfg, jparams, tokens))
    _assert_vg(got, want)


# Adam's step is g / (|g| + 1e-8) at its first step: where a gradient is
# near Adam's eps its update turns float-order noise into up to a whole
# lr.  At this seed the reference's first gradient of one expert weight
# (layer 1, w_down[3, 62, 7]) is 1.15e-8 on the mesh and 9.7e-9 on one
# device, and the two reference steps end 4.7e-5 apart there.  Such
# elements (reference gradient below NEAR_EPS at any step: 74 of 59,808
# at this seed) are held to the port's own one-card step instead.
NEAR_EPS = 1e-6


def test_train_steps_match_jax(pool8, weights):
    """Three AdamW steps at dp2·ep2·tp2 against the reference's
    make_train_step: the losses to 1e-4 relative, the parameters to 1e-5
    absolute wherever the reference's gradients stay above NEAR_EPS; and
    every parameter to 1e-5 absolute against the port's one-card step
    from the same weights and batches."""
    import torch
    from ompi_tpu_torch import optim
    from ompi_tpu_torch.models import transformer as tfm
    jparams, tree = weights
    jcfg, kw = _cfgs(attn="dense")
    batches = [_tokens((4, KW["seq"] + 1), 10 + i) for i in range(3)]
    mesh = make_mesh(DET)
    init, step = jax_tfm.make_train_step(jcfg, mesh)
    vg = jax.jit(jax.value_and_grad(jax_tfm.loss_fn), static_argnums=(2, 3))
    params = jax_tfm.shard_params(jparams, mesh, jcfg)
    state, jlosses = init(params), []
    smallest = None
    for b in batches:
        g = [np.abs(x) for x in _leaves(vg(params, jnp.asarray(b), jcfg,
                                           mesh)[1])]
        smallest = g if smallest is None else [np.minimum(a, c) for a, c
                                               in zip(smallest, g)]
        params, state, loss = step(params, state, jnp.asarray(b))
        jlosses.append(float(loss))
    want = _leaves(params)
    cfg = tfm.Config(**dict(kw, dtype=torch.float32))
    one = tfm.params_from_numpy(tree, "cpu")
    init_one, step_one = tfm.make_train_step(cfg, learning_rate=1e-3,
                                             device="cpu")
    state_one = init_one(one)
    for b in batches:
        one, state_one, _ = step_one(one, state_one, b)
    one = [x.numpy() for x in optim.tree_leaves(one)]
    for losses, leaves in pool8.run("_torch_mesh_worker:train", DET, kw,
                                    tree, batches, 1e-3):
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for g, w, o, m in zip(leaves, want, one, smallest):
            far = m >= NEAR_EPS
            np.testing.assert_allclose(g[far], w[far], rtol=0, atol=1e-5)
            np.testing.assert_allclose(g, o, rtol=0, atol=1e-5)


def test_reference_bf16_step_is_finite(pool8):
    """The reference test's own assertion on the port: its config, its
    weights (``init_params(key(0))``), bf16, zero tokens, one step at
    dp2·ep2·tp2 gives a finite loss."""
    jcfg = jax_tfm.Config(**KW)
    tree = jax.tree.map(np.asarray, jax_tfm.init_params(jax.random.key(0),
                                                        jcfg))
    kw = dict(KW, attn=jcfg.attn, dtype="bfloat16")
    tokens = np.zeros((4, KW["seq"] + 1), np.int32)
    for losses, _ in pool8.run("_torch_mesh_worker:train", DET, kw, tree,
                               [tokens], 1e-3):
        assert np.isfinite(losses).all(), losses


def test_bucketed_moe_on_dp_only_mesh(pool4, weights):
    """grad_sync="bucketed" with mlp="moe" on {"dp": 4}: each rank's loss
    is the one-card block's on its rows (capacity over those rows), as
    the reference's per-shard loss; against JAX's per-shard gradients
    averaged by lax.pmean in a shard_map built as ``test_torch_overlap``
    builds it."""
    jparams, tree = weights
    jcfg, kw = _cfgs(attn="dense", grad_sync="bucketed",
                     grad_bucket_bytes=4096)
    tokens = _tokens((8, KW["seq"] + 1), 5)

    def local(params, t):
        loss, grads = jax.value_and_grad(jax_tfm.loss_fn)(params, t, jcfg,
                                                          None)
        return lax.pmean(loss, "dp"), jax.tree.map(
            lambda g: lax.pmean(g, "dp"), grads)

    fn = jax.jit(shard_map(local, mesh=make_mesh(
                               {"dp": 4}, devices=jax.devices()[:4]),
                           in_specs=(P(), P("dp")), out_specs=(P(), P()),
                           check_vma=False))
    loss, grads = fn(jparams, jnp.asarray(tokens))
    want = _leaves(grads)
    got = pool4.run("_torch_sync_worker:grad_sync", {"dp": 4}, kw, tree,
                    tokens)
    for gl, gg, _ in got:
        assert abs(gl - float(loss)) <= 1e-5 * abs(float(loss))
        for g, w in zip(gg, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("axes,match", [
    ({"dp": 2, "pp": 2}, "axes among"),
    ({"dp": 1, "ep": 4}, None)], ids=["unknown_axis", "ep4_of_4_experts"])
def test_mesh_refusals(pool4, axes, match):
    """An axis the MoE mesh step does not know raises; four experts over
    ep 4 do not."""
    _, kw = _cfgs()
    got = pool4.run("_torch_mesh_worker:moe_mesh_refused", axes, kw)
    for r in got:
        if match is None:
            assert r is None
        else:
            assert r[0] == "ValueError" and match in r[1]
