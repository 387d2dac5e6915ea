"""The second half of the audit planes on the port's training-side seams
(``parallel/reshard.py``, ``models/moe.py``, ``parallel/ulysses.py``,
``parallel/pipeline.py``, ``coll/quant.py``) against the JAX package, on
the CPU, in gloo worlds of 4.

* Reshard: plans from the reference's ``Resharder.plan`` (pure; no
  reference plan runs — the JAX ``Resharder`` with an ``all_gather`` step
  dies in this JAX's ``check_vma``) over ``tests/test_torch_reshard.py``'s
  grammar: one ``decide:reshard`` a step with the plan's fields, the
  counters, the plan log and the last run's rows; the traffic edges equal
  the reference's ``traffic.note_reshard_step`` on the same arguments.  A
  cross plan (``compile_cross_plan``'s pieces) charges its moving pieces
  to the world ranks they join: the edges sum to its wire.
* MoE: ``moe_block_ep`` native on four processes, one row each, against
  the reference's on four devices (``tests/test_moe_ep.py:180``'s check
  at R = 4): one decision an exchange with the reference's fields, the
  edges the reference's byte for byte (the routing plan's per-pair token
  bytes, not a uniform fill); the hier arms hold conservation.
* Ulysses: the charge equals the reference's ``note_a2a`` figure,
  (2·Q + K + V)/n of the whole arrays.
* Pipeline: ``tests/test_observability.py:690-730``'s names and tick
  count, the reference's args but ``cache``, ``status="error"`` on a
  raise.
* Quant: the ``quant:*`` spans' args equal the reference's.
"""

import importlib
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu import trace as j_trace  # noqa: E402
from ompi_tpu import traffic as j_traffic  # noqa: E402
from ompi_tpu.models import moe as jax_moe  # noqa: E402
from ompi_tpu.parallel import DeviceComm as JDeviceComm  # noqa: E402
from ompi_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ompi_tpu.parallel.pipeline import pipeline as j_pipeline  # noqa: E402
from ompi_tpu.parallel.pipeline import (  # noqa: E402
    shard_stage_params as j_shard_stage, stack_stage_params as j_stack)
from ompi_tpu.parallel.reshard import Resharder as JResharder  # noqa: E402
from ompi_tpu.parallel.ulysses import (  # noqa: E402
    ulysses_attention as j_ulysses)

from ompi_tpu_torch.parallel import reshard as port_reshard  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

j_reshard = importlib.import_module("ompi_tpu.parallel.reshard")
j_planes = importlib.import_module("ompi_tpu.traffic.planes")

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(4)
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    j_trace.clear()
    j_trace.disable()
    j_traffic.reset()
    j_traffic.disable()


def _jax_mesh(axes, ranks=None):
    ranks = list(range(int(np.prod(list(axes.values()))))) \
        if ranks is None else list(ranks)
    devs = np.asarray(jax.devices())[ranks].reshape(tuple(axes.values()))
    return Mesh(devs, tuple(axes))


def _jax_edges(charges):
    """The reference's traffic matrix after ``charges``: ``(fn, args)``
    calls on a fresh, enabled plane."""
    j_traffic.reset()
    j_traffic.enable()
    j_planes._PROC_CACHE.clear()
    for fn, args, kw in charges:
        fn(*args, **kw)
    rows = j_traffic.matrix.rows()
    j_traffic.disable()
    j_traffic.reset()
    return rows


def _nccl(text):
    return json.loads(json.dumps(text).replace("coll_xla", "coll_nccl"))


# -- reshard ----------------------------------------------------------------------

SHAPE = (64, 48)
RESHARD = {
    "x4": ({"x": 4}, SHAPE, [(("x", None), (None, "x")),
                             ((None, "x"), (None, None)),
                             ((None, None), ("x", None)),
                             (("x", None), ("x", None))]),
    "ragged": ({"x": 4}, (7, 10), [(("x", None), (None, "x"))]),
    "2x2": ({"a": 2, "b": 2}, SHAPE, [(("a", "b"), ("b", "a")),
                                      (("a", None), ("b", None))]),
}
KIND = {"all_to_all": "a2a", "all_gather": "ring", "ppermute": "perm",
        "device_put": "a2a"}


@pytest.mark.parametrize("case", sorted(RESHARD))
def test_reshard_audit_from_reference_plans(case, pool):
    axes, shape, cases = RESHARD[case]
    host = np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)
    ranks = pool.run("_torch_serve_worker:reshard_audit", axes, host, cases)
    jmesh = _jax_mesh(axes)
    jrs = JResharder(jmesh)
    for i, (src, dst) in enumerate([cases[0]] + cases):
        ref = jrs.plan(shape, jnp.float32, P(*src), P(*dst))
        mine = port_reshard.compile_plan(shape, np.float32, src, dst, axes)
        # the port's device_put gathers and slices: its wire and peak
        # are its own (tests/test_torch_reshard.py); every other figure
        # is the reference plan's
        own = [s.op for s in mine.steps] == ["device_put"]
        wires = [s.wire_bytes for s in (mine if own else ref).steps]
        peak = (mine if own else ref).peak_bytes
        ndev = [int(np.prod([axes[a] for a in s.axes])) for s in ref.steps]
        edges = _jax_edges([
            (j_traffic.note_reshard_step,
             (jmesh, KIND[s.op], s.axes, w), {"pairs": s.perm or None})
            for s, w in zip(ref.steps, wires) if w])
        for got in ranks:
            run = got[i]
            assert [(d["step"], d["step_op"], d["plan"], d["plan_steps"],
                     d["peak_bytes"], d["bound_bytes"], d["wire_bytes"],
                     d["nbytes"], d["ndev"], d["arm"], d["rank"])
                    for d in run["decisions"]] == [
                (j, s.describe(), ref.label, len(ref.steps), peak,
                 ref.bound_bytes, w, w, n, "native", got[0]["rank"])
                for j, (s, w, n) in enumerate(zip(ref.steps, wires, ndev))]
            assert all(_nccl(d["reason"]) == "default:platform=cpu"
                       for d in run["decisions"])
            assert run["edges"] == edges
            assert run["unattributed"] == 0
            assert sum(e["bytes"] for e in run["edges"]) == run["wire"] == \
                sum(wires)
            assert run["counters"] == {"reshard_plans": int(i != 1),
                                       "reshard_steps": len(ref.steps),
                                       "reshard_bytes": sum(wires)}
            assert run["marks"] == (["cache_hit:reshard_plan"] if i == 1
                                    else ["reshard:compile_plan"])
            if ref.steps:
                assert [r["op"] for r in run["last"]["steps"]] == \
                    ref.describe()
                assert run["last"]["plan"] == ref.label
            log = run["plan_log"]
            assert (log["plan"], log["steps"]) == (ref.label,
                                                   ref.describe())
            if any(w and n >= 2 for w, n in zip(wires, ndev)):
                # the flat cell and the plane-keyed one
                assert run["perf_cells"] == [("reshard", "native"),
                                             ("reshard@ici", "native")]


CROSS = {
    "bridge": ((2, 2, 3, 2, 2, 4), ("fleet", "tp"), (None, "tp"),
               ({"fleet": 2, "tp": 2}, (0, 1, 2, 3)), ({"tp": 2}, (2, 3))),
    "survivors": ((8, 4), ("x", None), ("x", None),
                  ({"x": 4}, (3, 1, 0, 2)), ({"x": 2}, (1, 2))),
}


def test_cross_plan_edges_sum_to_its_wire(pool):
    """The cross plan's pairs land on the world ranks they join, one
    ``decide:reshard`` with ``cross=True`` on every rank of the source
    mesh, the pieces those of the reference's ``compile_cross_plan``."""
    rng = np.random.default_rng(2)
    names = sorted(CROSS)
    cases = [(rng.standard_normal(CROSS[n][0]).astype(np.float32),
              CROSS[n][1], CROSS[n][2], CROSS[n][3], CROSS[n][4])
             for n in names]
    ranks = pool.run("_torch_fleet_worker:cross_audit", cases)
    for c, (host, src, dst, (sa, sr), (da, dr)) in enumerate(cases):
        want = j_reshard.compile_cross_plan(
            host.shape, jnp.float32, P(*src), P(*dst), _jax_mesh(sa, sr),
            _jax_mesh(da, dr))
        pairs = {}
        for pc in want.pieces:
            if pc.src_pos != pc.dst_pos:
                key = (sr[pc.src_pos], sr[pc.dst_pos])
                pairs[key] = pairs.get(key, 0) + pc.nbytes
        assert sum(pairs.values()) == want.wire_bytes > 0
        for rank, got in enumerate(ranks):
            got = got[c]
            if rank not in sr:
                continue
            assert {(e["src"], e["dst"]): e["bytes"]
                    for e in got["edges"]} == pairs
            assert got["attributed"] == got["wire"] == want.wire_bytes
            assert got["unattributed"] == 0
            (d,) = got["decisions"]
            assert (d["cross"], d["dead"], d["plan"], d["wire_bytes"],
                    d["peak_bytes"], d["bound_bytes"], d["ndev"],
                    d["rank"]) == (True, [], want.label, want.wire_bytes,
                                   want.peak_bytes, want.bound_bytes,
                                   len(sr), rank)
            assert got["marks"] == ["reshard:compile_cross_plan"]


# -- MoE ----------------------------------------------------------------------------

R, T, D, E, K = 4, 16, 32, 8, 2
MOE_FIELDS = ("arm", "reason", "chain", "nbytes", "wire_bytes", "ndev",
              "a2av_slice_cap", "a2av_scan_steps", "routed_tokens",
              "dropped_tokens", "moe_inner_bytes", "moe_outer_bytes")


@pytest.fixture(scope="module")
def moe_inputs():
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(0), D, 2 * D, E)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (R, T, D),
                                     jnp.float32))
    return jp, jax.tree.map(np.asarray, jp), h


def test_moe_exchange_audit_equals_reference(pool, moe_inputs):
    jp, tree, h = moe_inputs
    jdc = JDeviceComm(j_make_mesh({"x": R}, devices=jax.devices()[:R]),
                      "x")
    j_trace.clear()
    j_trace.enable()
    j_traffic.reset()
    j_traffic.enable()
    jax_moe.moe_block_ep(jdc, jdc.from_ranks(list(h)), jp, E, top_k=K,
                         capacity_factor=1.25)
    want = [(e["name"], _nccl({k: e["args"][k] for k in MOE_FIELDS}))
            for e in j_trace.events() if e["name"].startswith("decide:moe")]
    want_edges = j_traffic.matrix.rows()
    assert len({e["bytes"] for e in want_edges}) > 1     # skewed pairs
    for rank, got in enumerate(pool.run("_torch_moe_worker:block_ep_audit",
                                        None, h, tree, E, K, 1.25)):
        assert [(n, {k: a[k] for k in MOE_FIELDS})
                for n, _r, a in got["decisions"]] == want
        assert {r for _n, r, _a in got["decisions"]} == {rank}
        assert got["edges"] == want_edges
        assert got["attributed"] == got["wire"] == sum(
            e["bytes"] for e in want_edges)
        assert got["unattributed"] == 0
        assert got["perf_cells"] == [("moe_combine", "native"),
                                     ("moe_dispatch", "native")]


HIER = {"epo": 2, "epi": 2}
HIER_FORCE = {"hier": {"coll_nccl_moe_dispatch_mode": "hier",
                       "coll_nccl_moe_combine_mode": "hier"},
              "hier+quant": {"coll_nccl_moe_dispatch_mode": "hier+quant",
                             "coll_nccl_moe_combine_mode": "hier+quant"}}


@pytest.mark.parametrize("arm", sorted(HIER_FORCE))
def test_moe_hier_arms_conserve(arm, pool, moe_inputs):
    """The hier arms (the reference's own tests of them fail on this box):
    one decision an exchange on the arm, edges summing to the audited
    wire with nothing unattributed, as the native test's shape."""
    _, tree, h = moe_inputs
    for rank, got in enumerate(pool.run(
            "_torch_moe_worker:block_ep_audit", HIER, h, tree, E, K, 8.0,
            sim="epo", force=HIER_FORCE[arm])):
        info = got["info"]
        assert [n for n, _r, _a in got["decisions"]] == [
            "decide:moe_dispatch", "decide:moe_combine"]
        assert [a["arm"] for _n, _r, a in got["decisions"]] == [
            info["dispatch"]["arm"], info["combine"]["arm"]]
        assert info["combine"]["arm"] == arm
        for (_n, _r, a), leg in zip(got["decisions"],
                                    ("dispatch", "combine")):
            assert a["wire_bytes"] == info[leg]["wire_bytes"]
            assert a["moe_outer_bytes"] == info[leg]["outer_bytes"] > 0
        assert got["attributed"] == got["wire"] == sum(
            e["bytes"] for e in got["edges"])
        assert got["unattributed"] == 0


# -- Ulysses, the pipeline, quant -----------------------------------------------------

def test_ulysses_charge_equals_reference(pool):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 16, 8, 4)).astype(np.float32)
               for _ in range(3))
    mesh = j_make_mesh({"sp": 4}, devices=jax.devices()[:4])
    j_traffic.reset()
    j_traffic.enable()
    j_planes._PROC_CACHE.clear()
    j_ulysses(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, "sp")
    want = j_traffic.matrix.rows()
    assert sum(e["bytes"] for e in want) == (2 * q.nbytes + k.nbytes
                                             + v.nbytes) // 4
    for got in pool.run("_torch_p13_worker:ulysses_charge", {"sp": 4},
                        q, k, v):
        assert got["edges"] == want
        assert got["per_coll"] == {"ulysses": sum(e["bytes"] for e in want)}
        assert got["unattributed"] == 0


LAYERS = [{"w": (np.eye(8) * 0.5).astype(np.float32),
           "b": np.zeros(8, np.float32)} for _ in range(4)]
MBS = np.ones((4, 2, 8), np.float32)


def test_pipeline_spans_equal_reference(pool):
    """``tests/test_observability.py:690-730``'s pipeline: one
    ``pipeline:run`` span and M + P − 1 synthetic ticks, the reference's
    args (its ``cache`` has no counterpart); a raising stage closes the
    run span with ``status="error"``."""
    mesh = j_make_mesh({"pp": 4}, devices=jax.devices()[:4])

    def stage_fn(stage_params, x):
        def body(h, p):
            return jnp.tanh(h @ p["w"] + p["b"]), None
        out, _ = jax.lax.scan(body, x, stage_params)
        return out

    j_trace.clear()
    j_trace.enable()
    sharded = j_shard_stage(j_stack([jax.tree.map(jnp.asarray, lay)
                                     for lay in LAYERS], 4), mesh, "pp")
    j_pipeline(stage_fn, sharded, jnp.asarray(MBS), mesh, "pp")
    want = [(e["name"], e["cat"], {k: v for k, v in e["args"].items()
                                   if k != "cache"})
            for e in j_trace.events() if e["name"].startswith("pipeline:")]
    assert [n for n, _c, _a in want].count("pipeline:tick") == 4 + 4 - 1
    for rank, got in enumerate(pool.run("_torch_p13_worker:pipe_trace",
                                        {"pp": 4}, LAYERS, MBS)):
        assert sorted([(e["name"], e["cat"], e["args"]) for e in got],
                      key=str) == sorted(want, key=str)
        assert {e["rank"] for e in got} == {rank}
        run = [e for e in got if e["name"] == "pipeline:run"][0]
        ticks = [e for e in got if e["name"] == "pipeline:tick"]
        assert sum(t["dur"] for t in ticks) == pytest.approx(run["dur"])
    for got in pool.run("_torch_p13_worker:pipe_trace", {"pp": 4}, LAYERS,
                        MBS, True):
        assert [(e["name"], e["args"]) for e in got] == [
            ("pipeline:run", {"stages": 4, "microbatches": 4,
                              "axis": "pp", "status": "error"})]


def test_quant_spans_equal_reference(pool):
    x = np.random.default_rng(4).standard_normal((4, 512)).astype(
        np.float32)
    dc = JDeviceComm(j_make_mesh({"x": 4}, devices=jax.devices()[:4]), "x")
    j_trace.clear()
    j_trace.enable()
    jx = dc.from_ranks(list(x))
    dc.quant.allreduce(jx)
    dc.quant.reduce_scatter(jx)
    dc.quant.allgather(jx)
    want = [(e["name"], e["args"]) for e in j_trace.events()
            if e["name"].startswith("quant:")]
    assert [n for n, _a in want] == ["quant:allreduce",
                                     "quant:reduce_scatter",
                                     "quant:allgather"]
    for rank, got in enumerate(pool.run("_torch_p13_worker:quant_spans",
                                        {"x": 4}, x)):
        assert [(n, a) for n, _r, a in got] == want
        assert {r for _n, r, _a in got} == {rank}
