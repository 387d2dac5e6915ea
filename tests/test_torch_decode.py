"""The port's fused decode program and speculative decoding
(``ompi_tpu_torch/serving/fused.py``, ``ServingEngine(decode_overlap=
"fused")``, ``decode_window``, the scheduler's ``spec_k``) against the JAX
package, on the CPU, at ``tests/test_decode.py``'s CFG (f32, 2 layers,
d 128).

* ``ring_schedule`` and the n-gram ``_draft`` equal the JAX functions;
  ``decide_mode("decode_collmm", …)`` equals ``coll/xla``'s.
* The fused engine at tp 2 and 4 (gloo worlds) gives the JAX fused
  engine's greedy tokens and the port's eager engine's, with f32 logits
  within 1e-4 relative (``tests/test_decode.py:139-140``); a decode step
  makes 2 eager dispatches and 4·n_layers + 1 ``decode_collmm``, whose
  wire is ``ring_schedule``'s, and spc moves by the same.
* ``decode_window`` at k = 2 and 3, eager at tp 1 and fused at tp 2,
  against the JAX ``decode_window`` on the same inputs.
* The speculative scheduler (``tests/test_decode.py:209-259``): spec_k 2
  and 3 give spec_k 0's streams and the JAX scheduler's, with its
  windows, drafted and accepted drafts (some accepted); the ledger is
  consistent, every page is released; eager at tp 1, fused at tp 2, eager
  at tp 4 (the tp ranks' clocks agree).  A window past a full block table
  writes the scratch page.
* The refusals: fused at tp 1, ``max_seqs % tp``, ``verify_decode_program``
  (P17), ``spec_k=1``.
"""

import itertools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu.coll import xla as j_xla  # noqa: E402
from ompi_tpu.core import var as j_var  # noqa: E402
from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.op import SUM as J_SUM  # noqa: E402
from ompi_tpu.op import quantizable as j_quantizable  # noqa: E402
from ompi_tpu.parallel import DeviceComm as JDeviceComm  # noqa: E402
from ompi_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ompi_tpu import serving as j_serving  # noqa: E402
from ompi_tpu.serving import fused as j_fused  # noqa: E402
from ompi_tpu.serving.engine import (  # noqa: E402
    ServingEngine as JServingEngine)
from ompi_tpu.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JScheduler)
from ompi_tpu.serving.scheduler import (  # noqa: E402
    poisson_stream as j_poisson_stream)

from ompi_tpu_torch.coll import nccl as t_nccl  # noqa: E402
from ompi_tpu_torch.coll.quant import wire_bytes  # noqa: E402
from ompi_tpu_torch.core import var as t_var  # noqa: E402
from ompi_tpu_torch.op import SUM as T_SUM  # noqa: E402
from ompi_tpu_torch.op import quantizable as t_quantizable  # noqa: E402
from ompi_tpu_torch.parallel import reshard as port_reshard  # noqa: E402
from ompi_tpu_torch.parallel.collectives import DeviceComm  # noqa: E402
from ompi_tpu_torch.parallel.device_plane import (  # noqa: E402
    init_device_plane)
from ompi_tpu_torch.serving import fused  # noqa: E402
from ompi_tpu_torch.serving.cache import PagedKVCache  # noqa: E402
from ompi_tpu_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler)

import _torch_coll_worker as W  # noqa: E402
import _torch_serve_worker as S  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

CFG_KW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8, head_dim=16,
              d_ff=256)
FUSED_KW = dict(CFG_KW, decode_overlap="fused")
JCFG = jax_tfm.Config(dtype=jnp.float32, **CFG_KW)
JCFG_F = jax_tfm.Config(dtype=jnp.float32, **FUSED_KW)
# the fused program's rings a step: 4 a layer (qkv AG, wo RS, gate|up AG,
# down RS) + the logits AG
RINGS = 4 * CFG_KW["n_layers"] + 1
MAX_SEQS = 4
PROMPTS = [[3, 17, 99, 254, 7], [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]]
STEPS = 5
REL = 1e-4


def _relerr(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


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


def _jax_engine(jparams, n, cfg):
    mesh = j_make_mesh({"tp": n}, devices=jax.devices()[:n])
    eng = JServingEngine(JDeviceComm(mesh, "tp"),
                         jax_tfm.shard_params(jparams, mesh, cfg), cfg,
                         n_pages=64, page_size=8, max_seqs=MAX_SEQS)
    if n == 1:
        # on one device the JAX cache's device_put returns its one zeros
        # buffer for every pool, which the donating page write refuses
        # (this JAX); give each pool its own
        eng.cache.k = [jnp.array(x, copy=True) for x in eng.cache.k]
        eng.cache.v = [jnp.array(x, copy=True) for x in eng.cache.v]
    return eng


def _jax_greedy(eng, prompt, steps):
    """``_torch_serve_worker._greedy_decode`` on the JAX engine."""
    slot = eng.cache.admit(len(prompt), steps + 1)
    first, lg0 = eng.prefill(slot, np.asarray(prompt, np.int32))
    toks, logits, last = [first], [np.asarray(lg0)[0, 0]], first
    for _ in range(steps):
        t = np.zeros(eng.max_seqs, np.int32)
        p = np.full(eng.max_seqs, -1, np.int64)
        t[slot] = last
        p[slot] = int(eng.cache.seq_lens[slot])
        nxt, lg = eng.decode_step(t, p)
        eng.cache.seq_lens[slot] += 1
        last = int(nxt[slot])
        toks.append(last)
        logits.append(np.asarray(lg)[0, slot])
    eng.cache.release(slot)
    return {"tokens": toks, "logits": np.stack(logits)}


def _jax_window(eng, prompts, windows):
    """``_torch_serve_worker.window`` on the JAX engine."""
    cache = eng.cache
    slots = []
    for prompt in prompts:
        slot = cache.admit(len(prompt), 16)
        eng.prefill(slot, np.asarray(prompt, np.int32))
        slots.append(slot)
    out = []
    for table in windows:
        k = table.shape[1]
        positions = np.full(table.shape, -1, np.int64)
        for s in slots:
            positions[s] = cache.seq_lens[s] + np.arange(k)
        nxt, lg = eng.decode_window(table.astype(np.int32), positions)
        rows = np.concatenate([np.arange(s * k, (s + 1) * k) for s in slots])
        out.append({"next": np.asarray(nxt)[slots],
                    "logits": np.asarray(lg)[0, rows]})
        for s in slots:
            cache.seq_lens[s] += 2
    return out


# -- the fused program's schedule, the draft, the decision --------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_schedule_matches_jax(n):
    for layers, rows, d, isz in itertools.product((1, 2, 6), (8, 24, 32),
                                                  (128, 2048), (2, 4)):
        assert (fused.ring_schedule(layers, rows, d, n, isz)
                == j_fused.ring_schedule(layers, rows, d, n, isz))


def test_ring_schedule_sites_and_wire_pinned():
    """``tests/test_decode.py:107-127``."""
    n, rows, d, isz = 8, 8, 128, 4
    sched = fused.ring_schedule(2, rows, d, n, isz)
    assert [s for s, _, _ in sched] == [
        "L0/qkv_ag", "L0/wo_rs", "L0/gateup_ag", "L0/down_rs",
        "L1/qkv_ag", "L1/wo_rs", "L1/gateup_ag", "L1/down_rs", "logits_ag"]
    for site, payload, wire in sched:
        assert payload == (rows // n) * d * (isz if site.endswith("_ag")
                                             else 4)
        assert wire == (n - 1) * payload
    a = fused.ring_schedule(2, 8, 128, 8, 4)
    b = fused.ring_schedule(2, 24, 128, 8, 4)
    assert len(a) == len(b) == RINGS
    for (_, pa, wa), (_, pb, wb) in zip(a, b):
        assert pb == 3 * pa and wb == 3 * wa


def test_draft_matches_jax():
    d = ContinuousBatchingScheduler._draft
    # tests/test_decode.py:261-266
    assert d([1, 2, 3, 4, 5, 2, 3], 2) == [4, 5]
    assert d([7, 8, 9], 2) == [9, 9]
    rng = np.random.default_rng(7)
    for _ in range(50):
        hist = rng.integers(0, int(rng.integers(2, 9)),
                            int(rng.integers(1, 40))).tolist()
        n = int(rng.integers(1, 6))
        assert d(hist, n) == JScheduler._draft(hist, n), (hist, n)


@pytest.mark.parametrize("force", [None, ("mode", "native"),
                                   ("mode", "quant"), ("mode", "staged"),
                                   ("COLL_QUANT", "on")])
def test_decode_collmm_decision_matches_jax(force):
    """``decide_mode("decode_collmm", …, allowed=("native",),
    hier_ok=False)`` as the engine calls it, against ``coll/xla``'s, with
    and without ``DEVICE_RULES.txt`` (its row ``decode_collmm 1 0
    native``); no ``decode_collmm_mode`` force variable exists in either."""
    rules = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "DEVICE_RULES.txt")
    rows_j = {"none": [], "rules": j_xla._load_device_rules(rules)}
    rows_t = {"none": [], "rules": t_nccl._load_device_rules(rules)}
    assert ("decode_collmm", 1, 0, "native") in rows_t["rules"]
    if force is not None:
        name = force[0] if force[0] == "COLL_QUANT" else None
        j_var.registry.set_cli(name or f"coll_xla_{force[0]}", force[1])
        t_var.registry.set_cli(name or f"coll_nccl_{force[0]}", force[1])
    for reg in (j_var, t_var):
        reg.registry.reset_cache()
    try:
        for nbytes, ndev, (jp, tp), plane, rules, (jdt, tdt) in \
                itertools.product((0, 256, 8192, 1 << 20, 64 << 20),
                                  (1, 2, 4, 8),
                                  (("cpu", "cpu"), ("tpu", "cuda")),
                                  ("ici", "dcn"), ("none", "rules"),
                                  ((np.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16))):
            kw = dict(op=None, plane=plane, hier_ok=False,
                      hier_why="decode collectives are single-stage")
            ref = j_xla.decide_mode(
                "decode_collmm", nbytes, ndev, jp, rows_j[rules],
                ("native",), quant_ok=j_quantizable(J_SUM, jdt), dtype=jdt,
                **kw)
            got = t_nccl.decide_mode(
                "decode_collmm", nbytes, ndev, tp, rows_t[rules],
                ("native",), quant_ok=t_quantizable(T_SUM, tdt), dtype=tdt,
                **kw)
            want = tuple(x.replace("coll_xla", "coll_nccl")
                         .replace("platform=tpu", "platform=cuda")
                         if isinstance(x, str) else
                         [c.replace("coll_xla", "coll_nccl") for c in x]
                         for x in ref)
            assert got == want, (nbytes, ndev, tp, plane, rules, tdt)
            assert got[0] == "native"
    finally:
        for reg, pre in ((j_var, "coll_xla_"), (t_var, "coll_nccl_")):
            reg.registry.clear_cli(pre + "mode")
            reg.registry.clear_cli("COLL_QUANT")
            reg.registry.reset_cache()


# -- the fused engine ---------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_runs(weights, pools):
    """Per tp: the JAX fused engine's greedy runs, the port's fused and
    eager engines' (every rank's)."""
    jparams, tree = weights
    made = {}

    def get(world):
        if world not in made:
            jeng = _jax_engine(jparams, world, JCFG_F)
            args = ({"tp": world}, tree, PROMPTS, STEPS)
            pool = pools(world)
            made[world] = {
                "jax": [_jax_greedy(jeng, p, STEPS) for p in PROMPTS],
                "fused": pool.run("_torch_serve_worker:engine_greedy",
                                  args[0], dict(FUSED_KW), *args[1:]),
                "eager": pool.run("_torch_serve_worker:engine_greedy",
                                  args[0], dict(CFG_KW), *args[1:])}
        return made[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
def test_fused_greedy_matches_jax_fused(world, greedy_runs):
    runs = greedy_runs(world)
    for rank in runs["fused"]:
        for got, want in zip(rank["runs"], runs["jax"]):
            assert got["tokens"] == want["tokens"]
            assert _relerr(got["logits"], want["logits"]) < REL


def _row_parallel_wire(world):
    """The wire of the fused engine's one-time row-parallel layouts: wo,
    w_down a layer and the embedding, one all_to_all each."""
    d, h = CFG_KW["d_model"], CFG_KW["n_heads"] * CFG_KW["head_dim"]
    shapes = ([(h, d), (CFG_KW["d_ff"], d)] * CFG_KW["n_layers"]
              + [(CFG_KW["vocab"], d)])
    plans = [port_reshard.compile_plan(s, torch.float32, (None, "tp"),
                                       ("tp", None), {"tp": world})
             for s in shapes]
    assert all(p.describe() == ["all_to_all[tp:1->0]"] for p in plans)
    return sum(p.wire_bytes for p in plans)


@pytest.mark.parametrize("world", [2, 4])
def test_fused_greedy_matches_eager(world, greedy_runs):
    runs = greedy_runs(world)
    for fr, er in zip(runs["fused"], runs["eager"]):
        assert fr["pages_used"] == 0
        # spc also holds the construction's audited reshard steps
        assert fr["spc_wire"] - fr["wire_bytes"] == _row_parallel_wire(world)
        assert er["spc_wire"] == er["wire_bytes"]
        for got, want in zip(fr["runs"], er["runs"]):
            assert got["tokens"] == want["tokens"]
            assert _relerr(got["logits"], want["logits"]) < REL


@pytest.mark.parametrize("world", [2, 4])
def test_fused_weight_views_are_numpy_blocks(world, weights, pools):
    """Each rank's views, bitwise, against numpy blocks of the JAX
    weights: wqkv its heads of q, k and v; wgu its gate and up columns;
    wo, w_down and the tied embedding its rows (the embedding's
    transposed)."""
    _, tree = weights
    for rank in pools(world).run("_torch_serve_worker:fused_views",
                                 {"tp": world}, dict(FUSED_KW), tree):
        t = rank["pos"]

        def rows(w):
            n = w.shape[0] // world
            return w[t * n:(t + 1) * n]

        def cols(w):
            return rows(w.T).T

        np.testing.assert_array_equal(rank["embed_lg"],
                                      rows(tree["embed"]).T)
        for got, lw in zip(rank["layers"], tree["layers"]):
            np.testing.assert_array_equal(got["wqkv"], np.concatenate(
                [cols(w) for w in np.split(lw["wqkv"], 3, axis=1)], 1))
            np.testing.assert_array_equal(got["wgu"], np.concatenate(
                [cols(lw["w_gate"]), cols(lw["w_up"])], 1))
            np.testing.assert_array_equal(got["wo"], rows(lw["wo"]))
            np.testing.assert_array_equal(got["wd"], rows(lw["w_down"]))


@pytest.mark.parametrize("world", [2, 4])
def test_fused_dispatch_collapse_and_wire(world, weights, pools):
    """Per decode step: 2 eager decode_ag, RINGS decode_collmm, wire =
    ring_schedule's wire column + the two AGs' (the embed's d/tp and the
    logits' V/tp columns), and spc's native arm count and wire bytes move
    by the same."""
    _, tree = weights
    sched = fused.ring_schedule(CFG_KW["n_layers"], MAX_SEQS,
                                CFG_KW["d_model"], world, 4)
    ring_wire = sum(w for _, _, w in sched)
    eager_wire = sum(
        wire_bytes("allgather", MAX_SEQS * c // world, world,
                   torch.float32)["native_bytes"]
        for c in (CFG_KW["d_model"], CFG_KW["vocab"]))
    for rank in pools(world).run("_torch_serve_worker:step_audit",
                                 {"tp": world}, dict(FUSED_KW), tree,
                                 PROMPTS[0], 3):
        for step in rank:
            assert step["dispatches"] == {"decode_ag": 2, "decode_rs": 0,
                                          "decode_collmm": RINGS}
            assert step["wire_bytes"] == ring_wire + eager_wire
            assert step["spc_wire"] == step["wire_bytes"]
            assert step["spc_native"] == 2 + RINGS


# -- decode_window ------------------------------------------------------------

def _window_tables():
    rng = np.random.default_rng(11)
    return [rng.integers(0, CFG_KW["vocab"], (MAX_SEQS, k)) for k in (2, 3)]


@pytest.mark.parametrize("path", ["eager_tp1", "fused_tp2"])
def test_decode_window_matches_jax(path, weights, dc1, pools):
    jparams, tree = weights
    tables = _window_tables()
    if path == "eager_tp1":
        want = _jax_window(_jax_engine(jparams, 1, JCFG), PROMPTS, tables)
        got = [S.window(dc1, {"tp": 1}, dict(CFG_KW), tree, PROMPTS,
                        tables)]
    else:
        want = _jax_window(_jax_engine(jparams, 2, JCFG_F), PROMPTS, tables)
        got = pools(2).run("_torch_serve_worker:window", {"tp": 2},
                           dict(FUSED_KW), tree, PROMPTS, tables)
    for rank in got:
        for g, w in zip(rank, want):
            np.testing.assert_array_equal(g["next"], w["next"])
            assert _relerr(g["logits"], w["logits"]) < REL


# -- the speculative scheduler ------------------------------------------------

# the scheduler's stream (``tests/test_decode.py:209-259``), and the host
# clock every scheduler run of the port reads: STEP_CLOCK seconds a
# reading, times 1 + the rank's tp position
SPEC_STREAM = (8, 21)
SPEC_KS = (2, 3)
STEP_CLOCK = 2e-3


def _jax_spec(eng, ks):
    """The JAX scheduler at each spec_k of ``ks`` over SPEC_STREAM: per
    spec_k the streams and the speculative ledger."""
    out = {}
    for k in ks:
        j_serving.reset()
        j_serving.enable()
        try:
            reqs = j_poisson_stream(*SPEC_STREAM[:1], qps=50.0,
                                    vocab=CFG_KW["vocab"],
                                    seed=SPEC_STREAM[1])
            res = JScheduler(eng, reqs, spec_k=k).run()
            rep = j_serving.report()
        finally:
            j_serving.disable()
        assert eng.cache.pages_used == 0
        out[k] = {"streams": {rid: r["tokens"]
                              for rid, r in res["results"].items()},
                  "speculative": rep["speculative"]}
    return out


@pytest.mark.parametrize("path", ["eager_tp1", "fused_tp2", "eager_tp4"])
def test_speculative_stream_identity_and_ledger(path, weights, dc1, pools):
    """spec_k 2 and 3 against spec_k 0 on the port, and against the JAX
    scheduler on the same stream: the same streams, and the same windows,
    drafted and accepted drafts (each request's follow from its own greedy
    stream alone, so they do not depend on how the requests were batched).
    At tp 4 the ranks' clocks run at different rates, so only the clock
    agreement keeps their admissions, and so their collectives, in step."""
    jparams, tree = weights
    fused_path = path.startswith("fused")
    cfg_kw = dict(FUSED_KW if fused_path else CFG_KW)
    world = int(path[-1])
    args = ({"tp": world}, cfg_kw, tree, SPEC_STREAM, SPEC_KS, STEP_CLOCK)
    ranks = ([S.spec_streams(dc1, *args)] if world == 1 else
             pools(world).run("_torch_serve_worker:spec_streams", *args))
    want = (None if world == 4 else
            _jax_spec(_jax_engine(jparams, world,
                                  JCFG_F if fused_path else JCFG), SPEC_KS))
    for rank in ranks:
        plain = rank[0]
        assert plain["speculative"]["windows"] == 0
        assert plain["pages_used"] == 0
        for run in rank[1:]:
            k = run["spec_k"]
            assert run["streams"] == plain["streams"], k
            sp = run["speculative"]
            assert sp["windows"] > 0
            assert sp["drafted"] == sp["windows"] * (k - 1)
            assert 0 < sp["accepted"] <= sp["drafted"]
            assert sp["acceptance_rate"] == pytest.approx(
                sp["accepted"] / sp["drafted"])
            assert run["decode_steps"] <= plain["decode_steps"]
            assert run["pages_used"] == 0
            assert ("fused" in run["dispatches"]) == fused_path
            if want is not None:
                assert run["streams"] == want[k]["streams"], k
                jsp = want[k]["speculative"]
                assert ({f: sp[f] for f in ("windows", "drafted",
                                            "accepted")}
                        == {f: jsp[f] for f in ("windows", "drafted",
                                                "accepted")}), k
    # every rank emits the same streams (one controller's, in the reference)
    streams = [[run["streams"] for run in rank] for rank in ranks]
    assert all(s == streams[0] for s in streams)


def test_window_past_the_block_table_writes_scratch(dc1):
    """A window may run k − 1 rows past the pages its request reserved.
    Where those pages fill the slot's block table, the rows past it go to
    the scratch page 0, not into the table's last page (the reference
    clamps there, over live rows of the same slot)."""
    c = PagedKVCache(dc1, CFG_KW["n_layers"], CFG_KW["n_heads"],
                     CFG_KW["head_dim"], n_pages=8, page_size=4,
                     max_seqs=2, max_pages_per_seq=2)
    slot = c.admit(5, 3)                       # 8 rows: the whole table
    page, off = c.write_indices(np.full(5, slot), np.array([6, 7, 8, 9,
                                                            -1]))
    last = c.block_tables[slot, 1]
    assert last != 0
    np.testing.assert_array_equal(page, [last, last, 0, 0, 0])
    np.testing.assert_array_equal(off, [2, 3, 0, 0, 0])
    c.release(slot)


def test_speculative_stream_on_full_block_tables(dc1, weights):
    """Requests whose pages fill ``max_pages_per_seq`` exactly: the last
    windows run past the table, and spec_k 3 still gives spec_k 0's
    streams."""
    _, tree = weights
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, CFG_KW["vocab"], n).tolist(), 16 - n)
            for n in (3, 5, 6, 8, 9, 11)]
    runs = S.spec_streams(dc1, {"tp": 1}, dict(CFG_KW), tree, reqs, (3,),
                          engine_kw={"max_pages_per_seq": 2})
    plain, spec = runs
    assert spec["speculative"]["windows"] > 0
    assert spec["streams"] == plain["streams"]
    assert spec["pages_used"] == plain["pages_used"] == 0


# -- refusals -----------------------------------------------------------------

def test_fused_refusals(dc1, weights, pools):
    _, tree = weights
    with pytest.raises(ValueError, match="tp>=2"):
        S._engine({"tp": 1}, dict(FUSED_KW), tree)
    eng = S._engine({"tp": 1}, dict(CFG_KW), tree)
    with pytest.raises(ValueError, match="decode_overlap='fused'"):
        eng.verify_decode_program()
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingScheduler(eng, [], spec_k=1)
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingScheduler(eng, [], spec_k=-2)
    got = pools(2).run("_torch_serve_worker:fused_refusals", {"tp": 2},
                       dict(FUSED_KW), tree)
    for out in got:
        assert "max_seqs=3 divisible by the 2-way tp axis" in out["max_seqs"]
        # the fused program's static wire equals one decode step's audit
        rep = out["verify"]
        assert rep["ok"], rep
        row = next(r for r in rep["rows"] if r["coll"] == "decode_collmm")
        assert row["static"] == row["runtime"] > 0
        assert rep["issues"] == [] and rep["host_transfers"] == []
