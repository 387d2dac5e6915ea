"""The port's static collective verifier (``ompi_tpu_torch.analysis
.commgraph``) against the JAX package's, on the CPU.

* The pure parts on the same inputs: ``check`` and ``match`` give the
  reference's issue kinds and severities on its hand-built records
  (``tests/test_analysis.py:126-236``); the wire models give the same
  integers and agree with ``perf.model._FACTOR``; ``verify_action``
  returns equal dicts for every (coll, arm) and raises the same
  ``ValueError``s; ``VerifyReport.to_json`` has the same keys;
  ``from_reshard_plan`` lifts the port's ``compile_plan`` into the
  reference's records.
* Extraction in a gloo world of 4 (``_torch_analysis_worker`` in one
  ``Pool(4)``): ring attention is n − 1 ppermute records of K and V with
  the whole ring perm, its static bytes (n − 1)/n of the reference's
  ``extract`` figure (the port stops after n − 1 hops and charges what
  moves); Ulysses is 4 all-to-all records whose bytes equal the
  reference's ``extract`` figure; the perleaf and bucketed grad syncs
  and the small train step price 2·(n−1)·flat//n; a scalar loss average is control and
  the scheduler's MAX agreement is priced by no model, and the traffic
  plane charges neither; a host read is flagged; a rank that diverges is
  a ``mismatch`` naming it.
* ``verify`` byte for byte: ring attention, Ulysses, perleaf and a
  reshard plan, as the reference's ``TestVerifyByteForByte`` does, and a
  ring charging one hop fewer fails.  Left out: the reference's
  ``test_small_train_step`` fails with the installed JAX; the port's train
  step is held to the closed form instead (the reference's psum
  extraction fails there too, in ``test_scalar_psum_is_control``,
  ``test_graph_bookkeeping`` and ``test_perleaf_grad_sync``, so those
  figures are closed forms as well).
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.analysis import commgraph as j_cg  # noqa: E402
from ompi_tpu.models import transformer as j_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ompi_tpu.parallel.reshard import compile_plan as j_compile  # noqa: E402
from ompi_tpu.parallel.ring import ring_attention as j_ring  # noqa: E402
from ompi_tpu.parallel.ulysses import ulysses_attention as j_ulysses  # noqa: E402

from ompi_tpu_torch.analysis import commgraph as t_cg  # noqa: E402
from ompi_tpu_torch.analysis import rules as t_rules  # noqa: E402
from ompi_tpu_torch.parallel.reshard import compile_plan as t_compile  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

N = 4
A = "_torch_analysis_worker:"

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(N)
    yield p
    p.close()


def _jmesh(axes):
    return j_make_mesh(axes, devices=jax.devices()[:N])


def _qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((1, 64, 8, 8)).astype(np.float32)
                 for _ in range(3))


# -- the pure parts ------------------------------------------------------------

def _rec(mod, **kw):
    base = dict(op="psum", axes=("x",), dtype="float32", shape=(4,),
                nbytes=16)
    base.update(kw)
    return mod.CollRecord(**base)


CHECK_CASES = {
    "non_bijective": ([dict(op="ppermute", perm=((0, 1), (1, 1), (2, 0)))],
                      {"x": 8}),
    "outside_domain": ([dict(op="ppermute", perm=((0, 9),))], {"x": 8}),
    "unknown_axis": ([dict(axes=("nope",))], {"x": 8}),
    "hier_reuses_inner": ([dict(op="reduce_scatter", axes=("inner",)),
                           dict(op="psum", axes=("inner",)),
                           dict(op="all_gather", axes=("inner",))],
                          {"inner": 4, "outer": 2}),
    "hier_proper_split": ([dict(op="reduce_scatter", axes=("inner",)),
                           dict(op="psum", axes=("outer",)),
                           dict(op="all_gather", axes=("inner",))],
                          {"inner": 4, "outer": 2}),
    "hier_partial_mesh": ([dict(op="reduce_scatter", axes=("inner",)),
                           dict(op="psum", axes=("outer",)),
                           dict(op="all_gather", axes=("inner",))],
                          {"inner": 4, "outer": 2, "tp": 2}),
    "clean_ring": ([dict(op="ppermute",
                         perm=tuple((i, (i + 1) % 8) for i in range(8)))],
                   {"x": 8}),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_equals_reference(case):
    recs, sizes = CHECK_CASES[case]
    got = t_cg.CommGraph(records=[_rec(t_cg, **r) for r in recs]).check(
        sizes)
    want = j_cg.CommGraph(records=[_rec(j_cg, **r) for r in recs]).check(
        sizes)
    assert [(i.kind, i.severity, i.msg) for i in got] == \
        [(i.kind, i.severity, i.msg) for i in want]
    assert want or case.startswith(("hier_proper", "clean"))


def test_match_and_signatures_equal_reference():
    def graphs(mod):
        a = mod.CommGraph(records=[_rec(mod), _rec(mod, op="all_gather")])
        b = mod.CommGraph(records=[_rec(mod), _rec(mod,
                                                   op="reduce_scatter")])
        c = mod.CommGraph(records=[_rec(mod)])
        return a, b, c

    (ta, tb, tc), (ja, jb, jc) = graphs(t_cg), graphs(j_cg)
    for (x, y), (u, v) in (((ta, tb), (ja, jb)), ((ta, tc), (ja, jc)),
                           ((ta, ta), (ja, ja))):
        assert [(i.kind, i.msg) for i in x.match(y)] == \
            [(i.kind, i.msg) for i in u.match(v)]
    assert ta.signatures() == ja.signatures()
    assert sorted(ta.by_op()) == sorted(ja.by_op())
    for shape in ((), (4,), (2, 3)):
        assert _rec(t_cg, shape=shape).control == \
            _rec(j_cg, shape=shape).control


def test_wire_models_equal_reference_and_perf_factors():
    t_model = importlib.import_module("ompi_tpu_torch.perf.model")
    j_model = importlib.import_module("ompi_tpu.perf.model")
    n, payload = 8, 4096
    recs = [dict(op="psum", shape=(1024,), nbytes=payload),
            dict(op="all_gather", shape=(1024,), nbytes=payload),
            dict(op="reduce_scatter", shape=(1024,), nbytes=payload),
            dict(op="ppermute", shape=(1024,), nbytes=payload),
            dict(op="all_to_all", shape=(1024,), nbytes=payload),
            dict(op="psum", shape=(), nbytes=4)]
    tg = t_cg.CommGraph(records=[_rec(t_cg, **r) for r in recs])
    jg = j_cg.CommGraph(records=[_rec(j_cg, **r) for r in recs])
    for sizes in ({"x": n}, {"x": 1}, {"x": 3}):
        assert tg.psum_ring_bytes(sizes) == jg.psum_ring_bytes(sizes)
        assert tg.gather_scatter_bytes(sizes) == \
            jg.gather_scatter_bytes(sizes)
    assert tg.ppermute_bytes() == jg.ppermute_bytes() == payload
    assert tg.all_to_all_bytes() == jg.all_to_all_bytes() == payload
    for m in (t_model, j_model):
        assert tg.psum_ring_bytes({"x": n}) == \
            int(m._FACTOR["allreduce"](n) * payload)
        assert tg.gather_scatter_bytes({"x": n}) == \
            int(m._FACTOR["allgather"](n) * payload * n) + \
            int(m._FACTOR["reduce_scatter"](n) * payload)
    assert t_cg.CommGraph(records=[_rec(t_cg)]).psum_ring_bytes(
        {"x": 1}) == 0


def test_verify_action_equals_reference():
    colls = sorted(t_cg._ACTION_COLL_FACTORS) + ["nope"]
    assert sorted(t_cg._ACTION_COLL_FACTORS) == \
        sorted(j_cg._ACTION_COLL_FACTORS)
    for coll in colls:
        for arm in t_rules.MODES + ("bogus",):
            for nbytes, ndev, dtype in ((1 << 20, 8, "float32"),
                                        (3000, 1, "float16")):
                try:
                    want = j_cg.verify_action(coll, arm, nbytes, ndev, dtype)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        t_cg.verify_action(coll, arm, nbytes, ndev, dtype)
                    assert str(got.value) == str(e)
                    continue
                assert t_cg.verify_action(coll, arm, nbytes, ndev,
                                          dtype) == want


def test_report_shape_equals_reference():
    kw = dict(source="s", n_records=2,
              rows=[{"coll": "grad_sync", "model": "psum_ring",
                     "static": 8, "runtime": 8, "ok": True}],
              host_transfers=["a/b"])
    t = t_cg.VerifyReport(issues=[t_cg.Issue("hier-cover", "m", "warn")],
                          **kw)
    j = j_cg.VerifyReport(issues=[j_cg.Issue("hier-cover", "m", "warn")],
                          **kw)
    assert t.to_json() == j.to_json()
    assert t.summary() == j.summary() and t.summary().startswith(
        "commgraph:")
    assert t.ok and not t_cg.VerifyReport(
        issues=[t_cg.Issue("mismatch", "m")], **kw).ok


@pytest.mark.parametrize("src,dst", [(("x", None), (None, "x")),
                                     ((None, "x"), ("x", None)),
                                     (("x", None), (None, None))])
def test_reshard_plan_lift_equals_reference(src, dst):
    want = j_cg.from_reshard_plan(j_compile(
        (64, 8), jnp.float32, P(*src), P(*dst), _jmesh({"x": N})))
    got = t_cg.from_reshard_plan(t_compile((64, 8), np.float32, src, dst,
                                           {"x": N}))
    assert [r.__dict__ for r in got.records] == \
        [r.__dict__ for r in want.records]
    assert got.source == want.source
    assert got.reshard_bytes() == want.reshard_bytes()


# -- extraction and verify on a gloo world of 4 ------------------------------------

def test_ring_attention_hops_and_whole_perm(pool):
    q, k, v = _qkv()
    want = j_cg.extract(lambda a, b, c: j_ring(a, b, c, _jmesh({"sp": N}),
                                               axis="sp"),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert want.ppermute_bytes() == k.nbytes + v.nbytes
    ring = [(i, (i + 1) % N) for i in range(N)]
    for got in pool.run(A + "ring", q, k, v):
        recs = got["records"]
        assert len(recs) == N - 1                # n − 1 hops of K and V
        for op, axes, dtype, shape, nbytes, trips, perm, path, ctl in recs:
            assert (op, axes, dtype, trips, ctl) == ("ppermute", ("sp",),
                                                     "float32", 1, False)
            assert nbytes == got["shard_bytes"] == (k.nbytes + v.nbytes) // N
            assert sorted(perm) == ring           # the whole bijection
        assert got["issues"] == []
        static = sum(r[4] for r in recs)
        assert static == want.ppermute_bytes() * (N - 1) // N
        rep = got["report"]
        assert rep["ok"], rep
        row = next(r for r in rep["rows"] if r["coll"] == "ring_attention")
        assert row["static"] == row["runtime"] == static
        # the planted fault: a ring charging one hop fewer fails verify
        bad = got["planted"]
        assert not bad["ok"]
        assert bad["rows"][0]["runtime"] == static - got["shard_bytes"]


def test_ulysses_alltoall_records(pool):
    q, k, v = _qkv()
    want = j_cg.extract(
        lambda a, b, c: j_ulysses(a, b, c, _jmesh({"sp": N}), axis="sp"),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert len(want.by_op()["all_to_all"]) == 4
    for got in pool.run(A + "ulysses", q, k, v):
        assert [r[0] for r in got["records"]] == ["all_to_all"] * 4
        assert got["all_to_all_bytes"] == want.all_to_all_bytes() == \
            (2 * q.nbytes + k.nbytes + v.nbytes) // N
        assert got["issues"] == []
        rep = got["report"]
        assert rep["ok"], rep
        assert rep["rows"] == [{"coll": "ulysses", "model": "all_to_all",
                                "static": want.all_to_all_bytes(),
                                "runtime": want.all_to_all_bytes(),
                                "ok": True}]


@pytest.mark.parametrize("mode", ["perleaf", "bucketed"])
def test_grad_sync(pool, mode):
    """One psum a leaf after the backward (perleaf), or a bucket's from
    the leaves' hooks inside it (bucketed): 2·(n−1)·flat//n either way."""
    params = {"w": np.ones((16, 16), np.float32),
              "b": np.zeros((16,), np.float32)}
    flat = sum(x.nbytes for x in params.values())
    for got in pool.run(A + "grad_sync", mode, params,
                        np.ones((8, 16), np.float32)):
        psums = [r for r in got["records"] if r[0] == "psum"]
        assert sum(r[4] for r in psums if not r[8]) == flat
        if mode == "perleaf":
            assert sorted(r[4] for r in psums if not r[8]) == sorted(
                x.nbytes for x in params.values())
        assert [r[3] for r in psums if r[8]] == [()]      # the loss mean
        assert got["psum_ring"] == 2 * (N - 1) * flat // N
        rep = got["report"]
        assert rep["ok"], rep
        assert rep["rows"][0]["static"] == rep["rows"][0]["runtime"] == \
            2 * (N - 1) * flat // N


def test_small_train_step_closed_form(pool):
    cfg = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
               d_ff=64, seq=32, attn="dense", grad_sync="perleaf")
    tree = jax.tree.map(np.asarray, j_tfm.init_params(
        jax.random.key(0), j_tfm.Config(**cfg, dtype=jnp.float32)))
    flat = sum(x.nbytes for x in jax.tree.leaves(tree))
    tokens = np.random.default_rng(1).integers(0, 64, (8, 33))
    for got in pool.run(A + "train_step", {**cfg, "dtype": "float32"},
                        tree, tokens):
        assert got["flat"] == flat
        assert got["ops"] == ["psum"]
        assert got["psum_ring"] == 2 * (N - 1) * flat // N
        rep = got["report"]
        assert rep["ok"], rep
        row = rep["rows"][0]
        assert row["static"] == row["runtime"] == 2 * (N - 1) * flat // N
        # the optimizer reads back only constants it lifted from Python
        # (b1 rounded to mu's dtype): no host transfer
        assert rep["host_transfers"] == [] and got["issues"] == []


def test_control_payloads_priced_by_neither_ledger(pool):
    for got in pool.run(A + "control"):
        (loss, agree) = got["records"]
        assert (loss[0], loss[3], loss[8]) == ("psum", (), True)
        assert (agree[0], agree[3], agree[8]) == ("pmax", (1,), False)
        assert got["psum_ring"] == got["gather_scatter"] == 0
        assert not any(got["charged"].values())


def test_host_read_flagged(pool):
    for got in pool.run(A + "host_read"):
        assert got["host"] == ["<top>/_local_scalar_dense"]
        assert [i[0] for i in got["issues"]] == ["host-transfer"]


def test_divergent_rank_is_a_mismatch_naming_it(pool):
    for rank, got in enumerate(pool.run(A + "divergent", 2)):
        assert got["clean"] == []
        # every rank names rank 2; rank 2 also sees its extra collective
        # on a group outside the mesh
        want = ([("unknown-axis", "error")] if rank == 2 else []) + [
            ("mismatch", "error")]
        assert [i[:2] for i in got["issues"]] == want
        assert got["divergent"] == [got["divergent"][0]]
        assert got["divergent"][0].startswith("rank 2: collective count "
                                              "differs: 1 vs 2")


def test_reshard_plan_verify(pool):
    src, dst = ("x", None), (None, "x")
    want = j_cg.from_reshard_plan(j_compile(
        (64, 8), jnp.float32, P(*src), P(*dst), _jmesh({"x": N})))
    for got in pool.run(A + "reshard", {"x": N}, (64, 8), src, dst):
        assert [r[:8] for r in got["records"]] == [
            (r.op, r.axes, r.dtype, r.shape, r.nbytes, r.trips, r.perm,
             r.path) for r in want.records]
        assert got["reshard_bytes"] == got["plan_wire"] == \
            want.reshard_bytes() > 0
        assert got["issues"] == []
        rep = got["report"]
        assert rep["ok"], rep
        assert rep["rows"][0]["static"] == rep["rows"][0]["runtime"] == \
            got["plan_wire"]


def test_non_bijective_record_fails_check():
    g = t_cg.CommGraph(records=[_rec(t_cg, op="ppermute",
                                     perm=((0, 1), (1, 1), (2, 0)))])
    assert [i.kind for i in g.check({"x": N})] == ["bijection"]
