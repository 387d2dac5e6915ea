"""The port's serving tier (``ompi_tpu_torch/serving``) against the JAX
package, on the CPU, at ``tests/test_serving.py``'s CFG (f32, 2 layers,
d 128).

The engine's greedy token streams at tp 1 (in this process, a gloo world
of one), tp 2 and tp 4 (gloo worlds) equal the JAX package's full-context
greedy through ``ompi_tpu.models.transformer.forward``, with every
logits row within 1e-4 relative (``tests/test_serving.py:214-223``); the
weights cross as numpy.  The audit counts (``COLLS_PER_STEP`` dispatches,
``wire_bytes == coll_wire_bytes``), the quant arm forced (0.05 relative,
≥ 75% of tokens, teacher-forced), ``continuous`` against ``static``, the
plane report, EOS eviction, the paged cache's accounting and the
refusals are the reference test's.  ``rope_rows`` and
``decode_attention`` are held against the JAX functions.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu.models import transformer as jax_tfm  # noqa: E402

from ompi_tpu_torch import serving  # noqa: E402
from ompi_tpu_torch.models import transformer as tfm  # noqa: E402
from ompi_tpu_torch.parallel import reshard as port_reshard  # noqa: E402
from ompi_tpu_torch.parallel.collectives import DeviceComm  # noqa: E402
from ompi_tpu_torch.parallel.device_plane import (  # noqa: E402
    init_device_plane)
from ompi_tpu_torch.serving.cache import PagedKVCache  # noqa: E402
from ompi_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from ompi_tpu_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler, poisson_stream)

import _torch_coll_worker as W  # noqa: E402
import _torch_serve_worker as S  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

CFG_KW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8, head_dim=16,
              d_ff=256)
JCFG = jax_tfm.Config(dtype=jnp.float32, **CFG_KW)
CFG = tfm.Config(dtype=torch.float32, **CFG_KW)
# audited decode collectives per step/prefill: 1 embed AG + 4 AGs per
# layer + logits RS + logits AG
COLLS_PER_STEP = 1 + 4 * CFG.n_layers + 2
PROMPTS = [[3, 17, 99, 254, 7], [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]]
STEPS = 5


@pytest.fixture(scope="module")
def dc1():
    """tp 1 in this process: a gloo world of one, gone after the module
    (a live world would change what later modules in this worker see)."""
    init_device_plane(rank=0, world_size=1, store=dist.HashStore(),
                      device="cpu")
    try:
        yield DeviceComm(S._mesh({"tp": 1}), "tp")
    finally:
        S._MESHES.clear()
        port_reshard._resharders.clear()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = W.Pool(world)
        return made[world]

    yield get
    for p in made.values():
        p.close()


@pytest.fixture(scope="module")
def weights():
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def reference(weights):
    """Full-context greedy through the JAX train-layout forward(): tokens
    and the logits each came from, per prompt.  The context rides in one
    fixed-length (jitted) batch row, read at its last real position: the
    attention is causal, so the positions after it do not reach it."""
    jparams, _ = weights
    width = max(map(len, PROMPTS)) + STEPS
    fwd = jax.jit(lambda toks: jax_tfm.forward(jparams, toks, JCFG))
    out = []
    for prompt in PROMPTS:
        toks, got, logits = list(prompt), [], []
        for _ in range(STEPS + 1):
            row = np.zeros((1, width), np.int32)
            row[0, :len(toks)] = toks
            lg = np.asarray(fwd(jnp.asarray(row)))[0, len(toks) - 1]
            got.append(int(lg.argmax()))
            logits.append(lg)
            toks.append(got[-1])
        out.append({"tokens": got, "logits": np.stack(logits)})
    return out


@pytest.fixture(scope="module")
def runs(weights, dc1, pools):
    """The engine's greedy runs at tp 1, 2 and 4, made once."""
    _, tree = weights
    made = {}

    def get(world):
        if world not in made:
            args = ({"tp": world}, dict(CFG_KW), tree, PROMPTS, STEPS)
            made[world] = ([S.engine_greedy(dc1, *args)] if world == 1
                           else pools(world).run(
                               "_torch_serve_worker:engine_greedy", *args))
        return made[world]

    return get


def _relerr(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


# -- the paged cache (tests/test_serving.py's TestPagedKVCache) ---------------

def test_admit_release_page_accounting(dc1):
    c = PagedKVCache(dc1, CFG.n_layers, CFG.n_heads, CFG.head_dim,
                     n_pages=9, page_size=4, max_seqs=4)
    assert c.pages_used == 0
    # 8 usable pages (page 0 is the inactive-lane scratch page)
    assert c.can_admit(7, 1)      # 8 positions -> 2 pages
    s0 = c.admit(7, 1)
    assert c.pages_used == 2
    s1 = c.admit(13, 3)           # 16 positions -> 4 pages
    assert c.pages_used == 6
    assert not c.can_admit(9, 4)  # would need 4 more, only 2 left
    c.release(s0)
    assert c.pages_used == 4
    assert c.can_admit(9, 4)
    s2 = c.admit(9, 4)
    assert s2 != s1 and c.pages_used == 8
    c.release(s1)
    c.release(s2)
    assert c.pages_used == 0


def test_slot_exhaustion_blocks_admit(dc1):
    c = PagedKVCache(dc1, CFG.n_layers, CFG.n_heads, CFG.head_dim,
                     n_pages=64, page_size=8, max_seqs=2)
    a = c.admit(4, 1)
    b = c.admit(4, 1)
    assert not c.can_admit(4, 1)  # pages free, but no slot
    c.release(a)
    assert c.can_admit(4, 1)
    c.release(b)


def test_inactive_positions_route_to_scratch_page(dc1):
    c = PagedKVCache(dc1, CFG.n_layers, CFG.n_heads, CFG.head_dim,
                     n_pages=8, page_size=4, max_seqs=2)
    slot = c.admit(3, 2)
    page, off = c.write_indices(np.array([slot, 1 - slot]),
                                np.array([5, -1]))
    assert page[1] == 0 and off[1] == 0       # inactive -> scratch
    assert page[0] != 0 and off[0] == 5 % 4   # live -> its block
    assert c.k[0].shape == (1, 8, 4, CFG.n_heads, CFG.head_dim)
    c.release(slot)


# -- the two functions the engine adds to models/transformer ------------------

def test_rope_rows_and_decode_attention():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([0, 3, 7, 12, 30])
    np.testing.assert_allclose(
        tfm.rope_rows(torch.from_numpy(x), torch.from_numpy(pos),
                      10000.0).numpy(),
        np.asarray(jax_tfm.rope_rows(jnp.asarray(x), jnp.asarray(pos),
                                     10000.0)), rtol=1e-5, atol=1e-6)
    q = rng.standard_normal((1, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 5, 24, 4, 16)).astype(np.float32)
            for _ in range(2))
    q_pos = np.array([0, 5, 23, -1, 11])
    got = tfm.decode_attention(*(torch.from_numpy(a) for a in (q, k, v,
                                                               q_pos)))
    want = jax_tfm.decode_attention(*(jnp.asarray(a) for a in (q, k, v,
                                                                q_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- engine parity and the audit ----------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_greedy_matches_jax_forward(world, runs, reference):
    for rank in runs(world):
        for run, ref in zip(rank["runs"], reference):
            assert run["tokens"] == ref["tokens"]
            assert _relerr(run["logits"], ref["logits"]) < 1e-4


@pytest.mark.parametrize("world", [1, 2, 4])
def test_audit_counts_and_wire_ledger(world, runs):
    total = len(PROMPTS) * (STEPS + 1) * COLLS_PER_STEP
    for rank in runs(world):
        assert sum(rank["dispatches"].values()) == total
        assert rank["dispatches"]["decode_rs"] == len(PROMPTS) * (STEPS + 1)
        assert rank["wire_bytes"] == rank["spc_wire"]
        assert rank["arms"] == {"native": total, "quant": 0, "staged": 0}
        assert rank["pages_used"] == 0
        assert (rank["wire_bytes"] > 0) == (world > 1)


def test_quant_arm_forced_parity(runs, weights, pools):
    """Both decode arms forced onto quant at block 32, teacher-forced on
    the native stream: logits within 0.05 relative, ≥ 75% of tokens."""
    _, tree = weights
    native = runs(2)
    teacher = [r["tokens"] for r in native[0]["runs"]]
    force = {"coll_nccl_decode_ag_mode": "quant",
             "coll_nccl_decode_rs_mode": "quant", "coll_quant_block": 32}
    quant = pools(2).run("_torch_serve_worker:engine_greedy", {"tp": 2},
                         dict(CFG_KW), tree, PROMPTS, STEPS,
                         teacher=teacher, force=force)
    total = len(PROMPTS) * (STEPS + 1) * COLLS_PER_STEP
    for q, n in zip(quant, native):
        assert q["arms"] == {"native": 0, "quant": total, "staged": 0}
        assert q["wire_bytes"] == q["spc_wire"] > 0
        assert q["wire_bytes"] < n["wire_bytes"]
        for rq, rn in zip(q["runs"], n["runs"]):
            assert _relerr(rq["logits"], rn["logits"]) < 0.05
            match = np.mean([a == b for a, b in zip(rq["tokens"],
                                                    rn["tokens"])])
            assert match >= 0.75


# -- the scheduler (tp 1, this process) ---------------------------------------

@pytest.fixture(scope="module")
def train1(dc1, weights):
    return tfm.shard_params(tfm.params_from_numpy(weights[1], device="cpu"),
                            dc1.mesh, CFG)


def _engine(dc, train, **kw):
    kw.setdefault("n_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seqs", 4)
    return ServingEngine(dc, train, CFG, **kw)


def _schedule(dc, train, policy, n=10, seed=1):
    serving.reset()
    serving.enable()
    try:
        eng = _engine(dc, train)
        reqs = poisson_stream(n, qps=50.0, vocab=CFG.vocab, seed=seed)
        out = ContinuousBatchingScheduler(eng, reqs, policy=policy).run()
        rep = serving.report()
    finally:
        serving.disable()
    assert eng.cache.pages_used == 0  # fully drained
    return out, rep


def test_continuous_vs_static_token_parity(dc1, train1):
    out_c, rep_c = _schedule(dc1, train1, "continuous")
    out_s, rep_s = _schedule(dc1, train1, "static")
    assert set(out_c["results"]) == set(out_s["results"])
    for rid, r in out_c["results"].items():
        assert r["tokens"] == out_s["results"][rid]["tokens"], rid
    # continuous keeps the device batch fuller and finishes in fewer
    # decode steps
    assert rep_c["batch_occupancy"] > rep_s["batch_occupancy"]
    assert out_c["decode_steps"] < out_s["decode_steps"]


def test_plane_ledger(dc1, train1):
    n = 10
    out, rep = _schedule(dc1, train1, "continuous", n=n)
    assert out["completed"] == n
    assert rep["evictions"] == n
    assert rep["active_seqs"] == 0
    assert rep["kv_pages_used"] == 0
    assert rep["prefills"] == n
    assert rep["tokens"] == out["tokens"]
    assert serving.pvar_value("serve_tokens") == out["tokens"]
    g = rep["goodput"]
    assert g["total_s"] >= g["prefill_s"] + g["decode_s"]
    assert rep["itl"]["count"] > 0
    assert rep["itl"]["p99_ms"] >= rep["itl"]["p50_ms"]
    assert {r["state"] for r in rep["requests"]} == {"done"}
    assert rep["dispatches"]["eager"] > 0


def test_eos_eviction(dc1, train1):
    eng = _engine(dc1, train1)
    # probe one greedy step to learn a token the model will emit, then use
    # THAT as eos so the request must stop early
    probe = S._greedy_decode(eng, np.array([3, 17], np.int32), 1)["tokens"]
    reqs = poisson_stream(1, qps=50.0, vocab=CFG.vocab, seed=9)
    reqs[0].prompt = np.array([3, 17], np.int32)
    reqs[0].max_new = 8
    reqs[0].eos_id = probe[0]
    out = ContinuousBatchingScheduler(eng, reqs).run()
    r = out["results"][reqs[0].rid]
    assert r["reason"] == "eos"
    assert len(r["tokens"]) == 1


# -- refusals -----------------------------------------------------------------

def test_refusals(dc1, train1):
    # the fused decode program and speculative decoding are the
    # reference's behaviour now (tests/test_torch_decode.py); the fused
    # engine refuses tp 1, as the reference does, and MoE decode stays on
    # the eager path (tests/test_torch_moe_ep.py), as in the reference
    fused = tfm.Config(dtype=torch.float32, decode_overlap="fused",
                       **CFG_KW)
    with pytest.raises(ValueError, match="tp>=2"):
        ServingEngine(dc1, train1, fused)
    with pytest.raises(ValueError, match="dense-MLP only"):
        ServingEngine(dc1, train1, dataclasses.replace(fused, mlp="moe"))
    eng = _engine(dc1, train1)
    assert ContinuousBatchingScheduler(eng, [], spec_k=2).spec_k == 2
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingScheduler(eng, [], spec_k=1)
    with pytest.raises(ValueError, match="policy"):
        ContinuousBatchingScheduler(eng, [], policy="fifo")
    with pytest.raises(ValueError, match="layout"):
        _engine(dc1, train1, layout="serve")
    three = types.SimpleNamespace(n=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="n_heads=8 not divisible by the "
                                         "3-way tp axis"):
        ServingEngine(three, train1, CFG)
