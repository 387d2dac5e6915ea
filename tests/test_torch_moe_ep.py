"""The port's ragged expert-parallel MoE (``models/moe.moe_block_ep``,
``ragged_ep_route``/``ragged_ep_combine``, ``moe_eval_loss``) and the
serving engine's MoE decode against the JAX package, on the CPU.

The reference runs on the 8-virtual-device CPU mesh; the port holds every
row in this process (a gloo world of one, ``make_mesh({"x": 1})``) and,
for the multi-process regime, in a gloo world of four (two rows a
process).  At the reference tests' sizes (R = 8 rows, t = 16, d = 32,
E = 8, k = 2):

* the ragged round trip is bitwise with the reference's receive rows and
  counts, and the exchange's plan (``DeviceComm._last_a2av``) is the
  reference's, the slice-cap variable included;
* ``moe_block_ep``'s native arm gives the reference's output (2e-5, the
  reference test's bound), aux (1e-5), info and spc wire bytes, with and
  without dropped tokens, in one process and across four;
* the hier and hier+quant arms on {"epo": 2, "epi": 2} with "epo"
  simulated as the slow plane are held to ``moe_block`` (2e-5; 0.05 with
  the int8 lane) and to the conservation sums, not to the reference,
  whose two hier tests fail on this box
  (``test_moe_ep.py::TestMoeBlockEP::test_hier_arms_split_planes_and_conserve``
  and ``::test_hier_quant_shrinks_outer_combine_only``: cases left out);
* ``moe_eval_loss`` is held to the reference's one-card ``loss_fn``
  within 5e-4 (``tests/test_moe_ep.py:TestRaggedForward``);
* the engine with ``mlp="moe"`` at tp 1, 2 and 4 answers the reference's
  einsum-forward greedy tokens at ``moe_capacity_factor=4.0``
  (``tests/test_decode.py:344-375``), a prompt that tp does not divide
  included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from ompi_tpu import spc as jax_spc
from ompi_tpu.core import var as jax_var
from ompi_tpu.models import moe as jax_moe
from ompi_tpu.models import transformer as jax_tfm
from ompi_tpu.parallel import DeviceComm as JaxComm
from ompi_tpu.parallel import make_mesh as jax_mesh

from ompi_tpu_torch.core import var
from ompi_tpu_torch.parallel import reshard as port_reshard
from ompi_tpu_torch.parallel.collectives import SLICE_CAP_ENV, DeviceComm
from ompi_tpu_torch.parallel.device_plane import init_device_plane

import _torch_coll_worker as W  # noqa: E402
import _torch_moe_worker as M  # noqa: E402
import _torch_serve_worker as S  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

R, T, D, E, K = 8, 16, 32, 8, 2
HIER = {"epo": 2, "epi": 2}
HIER_FORCE = {"hier": {"coll_nccl_moe_dispatch_mode": "hier",
                       "coll_nccl_moe_combine_mode": "hier"},
              "hier+quant": {"coll_nccl_moe_dispatch_mode": "hier+quant",
                             "coll_nccl_moe_combine_mode": "hier+quant"}}


@pytest.fixture(scope="module")
def dc1():
    """Every row in this process: a gloo world of one, gone after the
    module (a live world would change what later modules see)."""
    init_device_plane(rank=0, world_size=1, store=dist.HashStore(),
                      device="cpu")
    try:
        yield DeviceComm(S._mesh({"x": 1}), "x")
    finally:
        S._MESHES.clear()
        M._COMMS.clear()
        port_reshard._resharders.clear()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(4)
    yield p
    p.close()


def _jax_comm(n):
    return JaxComm(jax_mesh({"x": n}, devices=jax.devices()[:n]), "x")


@pytest.fixture(scope="module")
def ep_inputs():
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(0), D, 2 * D, E)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (R, T, D),
                                     jnp.float32))
    return jp, jax.tree.map(np.asarray, jp), h


@pytest.fixture(scope="module")
def jax_ep(ep_inputs):
    """The reference's moe_block_ep on 8 devices, by capacity factor."""
    jp, _, h = ep_inputs
    out = {}
    for cf in (8.0, 1.25):
        jdc = _jax_comm(R)
        jdc.spc = jax_spc.Counters()
        o, aux, info = jax_moe.moe_block_ep(jdc, jdc.from_ranks(list(h)), jp,
                                            E, top_k=K, capacity_factor=cf)
        out[cf] = {"out": np.asarray(o), "aux": float(aux), "info": info,
                   "wire": jdc.spc.get("coll_wire_bytes"),
                   "a2av": dict(jdc._last_a2av)}
    ref, _ = jax.jit(jax_moe.moe_block, static_argnums=(2, 3, 4))(
        jnp.asarray(h.reshape(1, R * T, D)), jp, E, K, 8.0)
    out["einsum"] = np.asarray(ref).reshape(R, T, D)
    return out


def _skewed_owner(rng, R, T):
    """Rank R-1 receives no token and rank 0 more than twice the mean
    (``tests/test_moe_ep.py::_skewed_owner``)."""
    owner = rng.integers(0, max(R - 1, 1), size=(R, T))
    owner[:, : max(1, (2 * T) // max(R, 2)) + 1] = 0
    return owner


@pytest.mark.parametrize("n,slice_cap", [(2, None), (4, None), (8, None),
                                         (8, 2)])
def test_route_roundtrip_matches_jax(dc1, monkeypatch, n, slice_cap):
    rng = np.random.default_rng(7 + n)
    owner = _skewed_owner(rng, n, 24)
    tokens = rng.normal(size=(n, 24, 6)).astype(np.float32)
    jdc = _jax_comm(n)
    if slice_cap is not None:
        monkeypatch.setenv(SLICE_CAP_ENV, str(slice_cap))
        jax_var.registry.set_cli("coll_a2av_slice_cap", str(slice_cap))
    try:
        recv, counts, ctx = jax_moe.ragged_ep_route(
            jdc, jdc.from_ranks(list(tokens)), owner)
        want_a2av = dict(jdc._last_a2av)
        jax_moe.ragged_ep_combine(jdc, recv, ctx)
        got = M.route_roundtrip(dc1, tokens, owner)
    finally:
        jax_var.registry.clear_cli("coll_a2av_slice_cap")
    want = np.asarray(recv)
    assert got["counts"] == counts
    np.testing.assert_array_equal(got["C"], ctx["C"])
    for j in range(n):                   # the routed payload, bitwise
        np.testing.assert_array_equal(got["recv"][j, :counts[j]],
                                      want[j, :counts[j]])
    np.testing.assert_array_equal(got["back"], tokens)
    # the combine's plan: the transposed counts, the same shape math
    assert got["a2av"] == dict(jdc._last_a2av)
    if slice_cap is not None:
        assert want_a2av["slice_cap"] == got["a2av"]["slice_cap"] == 2


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_block_ep_native_matches_jax(dc1, ep_inputs, jax_ep, cf):
    _, tree, h = ep_inputs
    got = M.block_ep(dc1, None, h, tree, E, K, cf)
    want = jax_ep[cf]
    np.testing.assert_allclose(got["out"], want["out"], atol=2e-5)
    assert abs(got["aux"] - want["aux"]) < 1e-5
    assert got["info"] == want["info"]
    assert got["wire"] == want["wire"] == (
        got["info"]["dispatch"]["wire_bytes"]
        + got["info"]["combine"]["wire_bytes"])
    assert got["a2av"] == want["a2av"]
    assert got["arms"]["native"] == 2
    if cf == 8.0:
        assert got["info"]["dropped_tokens"] == 0
        np.testing.assert_allclose(got["out"], jax_ep["einsum"], atol=2e-5)
    else:
        assert got["info"]["dropped_tokens"] > 0


def test_block_ep_native_across_processes(pool, ep_inputs, jax_ep):
    """Two rows a process over four: the routing needs every row's expert
    ids and the aux every row's probabilities; each process returns the
    reference's info and its rows of the reference's output."""
    _, tree, h = ep_inputs
    want = jax_ep[1.25]
    got = pool.run("_torch_moe_worker:block_ep", None, h, tree, E, K, 1.25)
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]),
                               want["out"], atol=2e-5)
    for g in got:
        assert abs(g["aux"] - want["aux"]) < 1e-5
        assert g["info"] == want["info"]
        assert g["wire"] == want["wire"]


@pytest.fixture(scope="module")
def hier_runs(pool, ep_inputs):
    _, tree, h = ep_inputs
    return {arm: pool.run("_torch_moe_worker:block_ep", HIER, h, tree, E, K,
                          8.0, sim="epo", force=force)
            for arm, force in HIER_FORCE.items()}


def test_hier_arms_split_planes_and_conserve(hier_runs, jax_ep):
    runs = hier_runs["hier"]
    out = np.concatenate([g["out"] for g in runs])
    np.testing.assert_allclose(out, jax_ep["einsum"], atol=2e-5)
    for g in runs:
        info = g["info"]
        assert info["dispatch"]["arm"] == info["combine"]["arm"] == "hier"
        for leg in ("dispatch", "combine"):
            assert (info[leg]["inner_bytes"] + info[leg]["outer_bytes"]
                    == info[leg]["wire_bytes"])
            assert info[leg]["outer_bytes"] > 0
        assert g["wire"] == (info["dispatch"]["wire_bytes"]
                             + info["combine"]["wire_bytes"])
        assert g["arms"]["hier"] == 2
    assert len({str(g["info"]) for g in runs}) == 1


def test_hier_quant_shrinks_outer_combine_only(hier_runs, jax_ep):
    plain, quant = hier_runs["hier"][0]["info"], hier_runs["hier+quant"]
    out = np.concatenate([g["out"] for g in quant])
    assert float(np.abs(out - jax_ep["einsum"]).max()) < 0.05
    for g in quant:
        info = g["info"]
        # the dispatch decays to hier: expert inputs have no int8 lane
        assert info["dispatch"]["arm"] == "hier"
        assert info["combine"]["arm"] == "hier+quant"
        assert info["dispatch"] == plain["dispatch"]
        comb, plain_comb = info["combine"], plain["combine"]
        assert comb["outer_bytes"] < plain_comb["outer_bytes"]
        assert comb["inner_bytes"] == plain_comb["inner_bytes"]
        assert (info["combine"]["inner_bytes"]
                + info["combine"]["outer_bytes"]
                == info["combine"]["wire_bytes"])
        assert g["wire"] == (info["dispatch"]["wire_bytes"]
                             + info["combine"]["wire_bytes"])
        assert g["arms"]["hier"] == g["arms"]["hier+quant"] == 1


def test_forced_hier_on_a_flat_comm_refuses(dc1, ep_inputs):
    _, tree, h = ep_inputs
    with pytest.raises(ValueError, match="ineligible"):
        M.block_ep(dc1, None, h, tree, E, K, 8.0, force={
            "coll_nccl_moe_dispatch_mode": "hier+quant"})
    assert var.get("coll_nccl_moe_dispatch_mode") == ""


EVAL_KW = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
               d_ff=64, seq=17, mlp="moe", n_experts=8, moe_impl="ragged",
               moe_capacity_factor=8.0)


@pytest.fixture(scope="module")
def eval_case():
    jcfg = jax_tfm.Config(dtype=jnp.float32, **EVAL_KW)
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1),
                                         (8, EVAL_KW["seq"]), 0,
                                         EVAL_KW["vocab"]))
    want = float(jax.jit(jax_tfm.loss_fn, static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg))
    return jax.tree.map(np.asarray, jparams), tokens, want


def test_moe_eval_loss_matches_jax_loss(dc1, pool, eval_case):
    tree, tokens, want = eval_case
    got = M.eval_loss(dc1, None, EVAL_KW, tree, tokens, rows=R)
    assert abs(got - want) < 5e-4, (got, want)
    across = pool.run("_torch_moe_worker:eval_loss", None, EVAL_KW, tree,
                      tokens)
    for g in across:
        assert abs(g - want) < 5e-4, (g, want)


ENGINE_KW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8, head_dim=16,
                 d_ff=256, mlp="moe", n_experts=8, moe_top_k=2,
                 moe_capacity_factor=4.0)
PROMPT = [3, 17, 99, 254, 7]               # 5 tokens: prefill pads to 8
STEPS = 2


@pytest.fixture(scope="module")
def engine_case():
    """The reference's einsum forward, greedy by full-context recompute
    at each context's own length (capacity couples the rows of a batch,
    so a padded fixed-width row would route differently)."""
    jcfg = jax_tfm.Config(dtype=jnp.float32, **ENGINE_KW)
    jparams = jax_tfm.init_params(jax.random.PRNGKey(2), jcfg)
    fwd = jax.jit(jax_tfm.forward, static_argnums=2)
    toks, want = list(PROMPT), []
    for _ in range(STEPS + 1):
        lg, _ = fwd(jparams, jnp.asarray([toks], jnp.int32), jcfg)
        want.append(int(np.asarray(lg)[0, -1].argmax()))
        toks.append(want[-1])
    return jax.tree.map(np.asarray, jparams), want


def _moe_calls(run):
    """moe_block_ep calls the spc counted: two native arms a call, beside
    the decode collectives and the construction's three expert reshards a
    layer."""
    extra = sum(run["dispatches"].values()) + 3 * ENGINE_KW["n_layers"]
    return (run["arms"]["native"] - extra) / 2


def test_engine_moe_tp1_matches_einsum_greedy(dc1, engine_case):
    tree, want = engine_case
    run = S.engine_greedy(dc1, {"tp": 1}, ENGINE_KW, tree, [PROMPT], STEPS,
                          engine_kw={"max_seqs": 8})
    assert run["runs"][0]["tokens"] == want
    assert _moe_calls(run) == ENGINE_KW["n_layers"] * (STEPS + 1)


def test_engine_moe_prefill_drops_as_the_reference(dc1, engine_case):
    """At the default capacity factor 1.25 a prefill drops tokens: its
    capacity is taken over the padded prompt, so the port pads as the
    reference does (a power-of-2 bucket of at least 8) and its first token
    and logits equal the reference engine's prefill."""
    from ompi_tpu.serving.engine import ServingEngine as JaxEngine
    tree, _ = engine_case
    kw = dict(ENGINE_KW, moe_capacity_factor=1.25)
    jcfg = jax_tfm.Config(dtype=jnp.float32, **kw)
    jdc = JaxComm(jax_mesh({"tp": 1}, devices=jax.devices()[:1]), "tp")
    jeng = JaxEngine(jdc, jax_tfm.shard_params(
        jax.tree.map(jnp.asarray, tree), jdc.mesh, jcfg), jcfg, n_pages=64,
        page_size=8, max_seqs=8)
    # on one device the reference's cache puts every layer's k and v on
    # one zeros buffer, which its donating page write refuses: own copies
    jeng.cache.k = [jnp.array(a, copy=True) for a in jeng.cache.k]
    jeng.cache.v = [jnp.array(a, copy=True) for a in jeng.cache.v]
    want, want_lg = jeng.prefill(jeng.cache.admit(len(PROMPT), 1),
                                 np.asarray(PROMPT, np.int32))
    eng = S._engine({"tp": 1}, kw, tree, {"max_seqs": 8})
    got, got_lg = eng.prefill(eng.cache.admit(len(PROMPT), 1),
                              np.asarray(PROMPT))
    assert got == want
    np.testing.assert_allclose(got_lg[0, 0].numpy(),
                               np.asarray(want_lg)[0, 0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("axes", [{"rep": 2, "tp": 2}, {"tp": 4}],
                         ids=["tp2", "tp4"])
def test_engine_moe_multi_rank_matches_einsum_greedy(pool, engine_case,
                                                     axes):
    tree, want = engine_case
    runs = pool.run("_torch_serve_worker:engine_greedy", axes, ENGINE_KW,
                    tree, [PROMPT], STEPS, engine_kw={"max_seqs": 8})
    for run in runs:
        assert run["runs"][0]["tokens"] == want
        assert _moe_calls(run) == \
            ENGINE_KW["n_layers"] * (STEPS + 1)
