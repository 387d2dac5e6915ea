"""The port's serving fleet (``ompi_tpu_torch/serving/fleet.py``), its
cross-mesh reshard (``parallel/reshard.compile_cross_plan`` /
``cross_reshard``), ``parallel/simdcn``, the router and the fleet ledger
against the JAX package, on the CPU, at ``tests/test_fleet.py``'s CFG
(vocab 512, d 128, 2 layers, 8 heads of 16, d_ff 256, f32).

* ``compile_cross_plan`` equals the JAX plan field for field over
  ``tests/test_elastic.py:89-140``'s cases and the fleet's bridge at tp 1,
  2 and 4; ``cross_reshard`` in gloo worlds of 4 gives numpy's blocks
  (cut by the JAX ``NamedSharding``'s index map) with one audited decision
  and the plan's wire; a dead rank's block without a live copy is refused
  naming P14, a fallback plan naming itself.
* ``FleetRouter`` makes the JAX router's assignments over a 200-request
  stream: even weights, after ``update``, under an ``apply_route_weight``
  bias, at ties and with all-zero weights.
* A migration at 1 + 1 and tp 2 moves the pages bitwise and carries
  ``seq_lens`` over, with the JAX fleet's ledger row and spc figures; with
  the fleet axis a simulated DCN axis it sleeps ``simdcn.penalty_us``.
* Per-request tokens equal the JAX ``ServingFleet.run``'s on
  ``tests/test_fleet.py:62-66``'s stream in four shapes (colocated 1 × tp
  2 and 2 × tp 1, disaggregated 1 + 1 at tp 2 and 1 + 2 at tp 1), with
  the same assignments and migrations.
* The SPMD guard: every rank reads a step clock of its own rate; two
  runs in a row (the second under the weights ``update`` moved) give every
  rank the same assignments and tokens, disaggregated 1 + 1 and colocated
  2 × 2, both at tp 2.
* The chaos variables move the prefill lane's clock as they move the JAX
  fleet's (``serve_req_chaos_migrate_ms`` by its ms a migration,
  ``serve_req_chaos_prefill_scale`` the prefill seconds), and not the
  tokens; a second fleet of a layout makes no new process group.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import dataclasses  # noqa: E402
import importlib  # noqa: E402

from ompi_tpu import serving as j_serving  # noqa: E402
from ompi_tpu import spc as j_spc  # noqa: E402
from ompi_tpu.core import var as j_var  # noqa: E402
from ompi_tpu.ft import elastic  # noqa: E402
from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ompi_tpu.serving.fleet import ServingFleet as JFleet  # noqa: E402
from ompi_tpu.serving.scheduler import FleetRouter as JRouter  # noqa: E402
from ompi_tpu.serving.scheduler import (  # noqa: E402
    poisson_stream as j_poisson_stream)

from ompi_tpu_torch import serving  # noqa: E402
from ompi_tpu_torch.parallel import reshard as port_reshard  # noqa: E402
from ompi_tpu_torch.parallel import simdcn  # noqa: E402
from ompi_tpu_torch.serving.scheduler import FleetRouter  # noqa: E402

import _torch_coll_worker as W  # noqa: E402
from _torch_serve_worker import _StepClock  # noqa: E402

j_reshard = importlib.import_module("ompi_tpu.parallel.reshard")

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

CFG_KW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8, head_dim=16,
              d_ff=256)
JCFG = jax_tfm.Config(dtype=jnp.float32, **CFG_KW)
FW = "_torch_fleet_worker:"
# the four fleets of the token test: (replicas, tp, prefill_replicas)
TOPOS = {"colocated_1x2": (1, 2, 0), "colocated_2x1": (2, 1, 0),
         "disagg_1+1_tp2": (2, 2, 1), "disagg_1+2_tp1": (3, 1, 1)}
STEP_CLOCK = 2e-3


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


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    for s in (serving, j_serving):
        s.reset()
        s.disable()


def _stream():
    """``tests/test_fleet.py:62-66``'s stream."""
    return j_poisson_stream(6, 200.0, CFG_KW["vocab"], seed=7,
                            prompt_len=(10, 22), max_new=(3, 5))


def _rows(reqs):
    return [(r.rid, r.prompt.tolist(), r.max_new, r.arrival) for r in reqs]


def _plan_fields(plan):
    out = {k: getattr(plan, k) for k in plan.__dataclass_fields__
           if k != "key"}
    out["pieces"] = [tuple(vars(p).values()) for p in plan.pieces]
    out["label"], out["describe"] = plan.label, plan.describe()
    return out


# -- the cross-mesh plan ------------------------------------------------------

def _elastic_meshes():
    mesh8 = j_make_mesh({"dp": 8})
    return (mesh8, elastic.survivor_mesh(mesh8, [3]),
            port_reshard.RankMesh.make({"dp": 8}, range(8)),
            port_reshard.RankMesh.make({"dp": 4}, [0, 1, 2, 4]))


ELASTIC_CASES = {
    "8_to_4_dead": ((16, 4), ("dp", None), ("dp", None), [3]),
    "replicated": ((3, 3), (), (), [3]),
    "irregular": ((16, 8), (None, "dp"), ("dp", None), []),
}


@pytest.mark.parametrize("case", sorted(ELASTIC_CASES))
def test_cross_plan_equals_jax_elastic(case):
    """``tests/test_elastic.py:89-140``: 8 → 4 survivors of a dead rank
    (one shadow piece), replicated (pure alias, zero wire) and an axis move
    no whole source block tiles (the device_put fallback)."""
    shape, src, dst, dead = ELASTIC_CASES[case]
    jm8, jm4, m8, m4 = _elastic_meshes()
    want = j_reshard.compile_cross_plan(shape, jnp.float32, P(*src),
                                        P(*dst), jm8, jm4, dead=dead)
    got = port_reshard.compile_cross_plan(shape, np.float32, src, dst, m8,
                                          m4, dead=dead)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.peak_bytes <= got.bound_bytes or got.fallback_reason


@pytest.mark.parametrize("case", ["dead_in_dst", "irregular_with_dead"])
def test_cross_plan_refusals_equal_jax(case):
    jm8, jm4, m8, m4 = _elastic_meshes()
    if case == "dead_in_dst":
        jdst = j_make_mesh({"dp": 4}, devices=jax.devices()[:4])
        dst = port_reshard.RankMesh.make({"dp": 4}, range(4))
        args = ((16, 4), ("dp", None), ("dp", None))
    else:
        jdst, dst = jm4, m4
        args = ((16, 8), (None, "dp"), ("dp", None))
    with pytest.raises(j_reshard.ReshardError) as want:
        j_reshard.compile_cross_plan(args[0], jnp.float32, P(*args[1]),
                                     P(*args[2]), jm8, jdst, dead=[3])
    with pytest.raises(port_reshard.ReshardError) as got:
        port_reshard.compile_cross_plan(args[0], np.float32, args[1],
                                        args[2], m8, dst, dead=[3])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_cross_plan_equals_jax_fleet_bridge(tp):
    """The migration's plan: the bridge P("fleet", "tp") over two rows,
    the destination P(None, "tp") on the decode row; tp cross-rank pieces
    and tp local ones, peak == bound."""
    devs = jax.devices()
    shape = (2, tp, 2 * 2 * 3, 8, 8 // tp, 16)
    want = j_reshard.compile_cross_plan(
        shape, jnp.float32, P("fleet", "tp"), P(None, "tp"),
        j_make_mesh({"fleet": 2, "tp": tp}, devices=devs[:2 * tp]),
        j_make_mesh({"tp": tp}, devices=devs[tp:2 * tp]))
    got = port_reshard.compile_cross_plan(
        shape, np.float32, ("fleet", "tp"), (None, "tp"),
        port_reshard.RankMesh.make({"fleet": 2, "tp": tp}, range(2 * tp)),
        port_reshard.RankMesh.make({"tp": tp}, range(tp, 2 * tp)))
    assert _plan_fields(got) == _plan_fields(want)
    assert len(got.pieces) == 2 * tp
    assert got.peak_bytes == got.bound_bytes


# -- cross_reshard in a gloo world of 4 ---------------------------------------

RUN_CASES = [
    # (shape, src spec, dst spec, (src axes, ranks), (dst axes, ranks))
    ((8, 4), ("x", None), ("x", None), ({"x": 4}, range(4)),
     ({"x": 2}, (0, 2))),
    ((3, 5), (), (), ({"x": 4}, range(4)), ({"x": 2}, (1, 3))),
    ((2, 2, 3, 2, 2, 4), ("fleet", "tp"), (None, "tp"),
     ({"fleet": 2, "tp": 2}, range(4)), ({"tp": 2}, (2, 3))),
    ((8, 6), ("a", "b"), (None, "b"), ({"a": 2, "b": 2}, range(4)),
     ({"b": 2}, (0, 1))),
]


def _jax_block(host, spec, axes, ranks, rank):
    """The block of ``host`` the rank's device holds under the JAX
    ``NamedSharding`` of ``spec`` on a mesh of those ranks' devices."""
    devs = np.asarray(jax.devices())[list(ranks)].reshape(
        tuple(axes.values()))
    sh = NamedSharding(Mesh(devs, tuple(axes)), P(*spec))
    return host[sh.devices_indices_map(host.shape)[jax.devices()[rank]]]


def test_cross_reshard_values_and_audit(pools):
    rng = np.random.default_rng(0)
    cases = [(rng.standard_normal(shape).astype(np.float32), src, dst,
              (sa, tuple(sr)), (da, tuple(dr)))
             for shape, src, dst, (sa, sr), (da, dr) in RUN_CASES]
    ranks = pools(4).run(FW + "cross_cases", cases)
    for c, (host, src, dst, (sa, sr), (da, dr)) in enumerate(cases):
        plan = port_reshard.compile_cross_plan(
            host.shape, np.float32, src, dst,
            port_reshard.RankMesh.make(sa, sr),
            port_reshard.RankMesh.make(da, dr))
        for rank, got in enumerate(ranks):
            got = got[c]
            if rank in dr:
                np.testing.assert_array_equal(
                    got["out"], _jax_block(host, dst, da, dr, rank))
            else:
                assert got["out"] is None
            assert got["arms"] == 1
            assert got["wire"] == got["plan_wire"] == plan.wire_bytes
            last = got["last"]
            assert (last["wire_bytes"], last["peak_bytes"],
                    last["bound_bytes"]) == (plan.wire_bytes,
                                             plan.peak_bytes,
                                             plan.bound_bytes)
            assert last["steps"][0]["arm"] == "native"
        # the replicated case is a pure alias on its destination ranks
        assert [r[c]["alias"] for r in ranks] == (
            [rank in dr for rank in range(4)] if c == 1 else [False] * 4)


def test_cross_reshard_refusals(pools):
    host = np.arange(64, dtype=np.float32).reshape(8, 8)
    for got in pools(4).run(FW + "cross_refusals", host):
        assert "P14" in got["shadow"] and "[1]" in got["shadow"]
        assert "fell back" in got["fallback"]
        assert "irregular tiling" in got["fallback"]


# -- the router ---------------------------------------------------------------

ROUTER_CASES = {
    "even": (3, None, None, ()),
    "updated": (3, [(0, 120.0, 8.0), (1, 90.0, 30.0), (2, 60.0, 5.0)],
                None, ()),
    "biased": (3, None, None, ((1, 0.5), (2, 0.25))),
    "ties": (4, None, [2.0, 2.0, 1.0, 1.0], ()),
    "all_zero": (3, None, [0.0, 0.0, 0.0], ()),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_assignments_equal_jax(case):
    n, updates, weights, bias = ROUTER_CASES[case]
    out = []
    for plane, Router in ((j_serving, JRouter), (serving, FleetRouter)):
        plane.reset()
        plane.enable()
        plane.set_fleet_replicas(n)
        for i in range(n):
            plane.update_replica(i, {"role": "serve"})
        for i, scale in bias:
            plane.apply_route_weight(i, scale)
        r = Router(n, weights)
        for i, tps, p99 in updates or ():
            r.update(i, tps, p99)
        picks = [r.assign(rid) for rid in range(200)]
        out.append((picks, plane.fleet_report()["routes"][-5:],
                    plane.fleet_pvar_value("fleet_rebalances")))
    assert out[0] == out[1]
    counts = np.bincount(out[0][0], minlength=n)
    if case in ("even", "all_zero"):
        assert counts.max() - counts.min() <= 1


def test_route_weight_unknown_replica_is_a_noop():
    for plane in (j_serving, serving):
        plane.reset()
        plane.update_replica(0, {"role": "serve"})
        assert plane.apply_route_weight(3, 0.5) is None
        assert plane.fleet_pvar_value("fleet_rebalances") == 0
        assert plane.fleet_route_bias(3) == 1.0
    assert serving.pvar_value("fleet_replicas") == 0


# -- the migration --------------------------------------------------------------

def _jax_fleet(jparams, replicas, tp, pre):
    fl = JFleet(jparams, JCFG, replicas=replicas, tp=tp,
                prefill_replicas=pre,
                devices=jax.devices()[:replicas * tp], spc=j_spc.Counters())
    if tp == 1:
        # on one device the JAX cache's device_put returns its one zeros
        # buffer for every pool, which the donating page write refuses
        # (this JAX); give each pool its own
        for rep in fl.replicas:
            cache = rep.engine.cache
            cache.k = [jnp.array(x, copy=True) for x in cache.k]
            cache.v = [jnp.array(x, copy=True) for x in cache.v]
    return fl


def _jax_migration(jparams, prompt, max_new):
    """``tests/test_fleet.py:70-129`` at 1 + 1 and tp 2: the ledger row
    and the spc's deltas over the migration."""
    j_serving.reset()
    j_serving.enable()
    fl = _jax_fleet(jparams, 2, 2, 1)
    pre, dec = fl.replicas
    pslot = pre.engine.cache.admit(len(prompt), max_new)
    pre.engine.prefill(pslot, np.asarray(prompt, np.int32))
    c = j_spc.Counters()
    fl.spc = c
    for rep in fl.replicas:
        rep.dc.spc = c
    fl.migrate(pre, dec, pslot, len(prompt), max_new, rid="r0")
    return (j_serving.fleet_report(), c.get("coll_arm_native_count"),
            c.get("coll_wire_bytes"))


def test_migration_bitwise_ledger_and_spc(pools, weights):
    jparams, tree = weights
    prompt = np.random.default_rng(3).integers(2, CFG_KW["vocab"],
                                               17).tolist()
    ranks = pools(4).run(FW + "migration", dict(CFG_KW), tree, prompt, 4, 2)
    want_rep, want_arms, want_wire = _jax_migration(jparams, prompt, 4)
    want_row = {k: v for k, v in want_rep["migration_log"][0].items()
                if k != "dur_ms"}
    pre = {r["pos"]: r for r in ranks if r["side"] == "prefill"}
    dec = {r["pos"]: r for r in ranks if r["side"] == "decode"}
    assert sorted(pre) == sorted(dec) == [0, 1]
    for pos, d in dec.items():
        for layer in range(CFG_KW["n_layers"]):
            for kv in ("k", "v"):
                got, want = d[kv][layer], pre[pos][kv][layer]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        assert d["seq_len"] == pre[pos]["seq_len"] == len(prompt)
    for r in ranks:
        row = {k: v for k, v in r["report"]["migration_log"][0].items()
               if k != "dur_ms"}
        assert row == want_row
        assert r["report"]["migrations"] == want_rep["migrations"] == 1
        assert r["report"]["migrated_bytes"] == want_rep["migrated_bytes"]
        assert (r["arms"], r["wire"]) == (want_arms, want_wire)
        assert r["wire"] == row["bytes"] == r["last"]["wire_bytes"]
        assert row["peak_bytes"] <= row["bound_bytes"]


def test_migration_charges_simulated_dcn(pools, weights):
    _, tree = weights
    prompt = list(range(5, 18))
    for got in pools(2).run(FW + "migration_simdcn", dict(CFG_KW), tree,
                            prompt, 250.0):
        assert got["plane"] == "dcn"
        assert got["wire"] > 0
        assert got["penalty_us"] == simdcn.penalty_us(got["wire"], 250.0)
        assert got["slept"] == [got["penalty_us"] * 1e-6]


# -- the fleet's tokens against the JAX fleet's ---------------------------------

@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX fleet's run of the stream in each topology of TOPOS: the
    streams, assignments and migrations."""
    jparams, _ = weights
    out = {}
    for name, (replicas, tp, pre) in TOPOS.items():
        j_serving.reset()
        j_serving.enable()
        res = _jax_fleet(jparams, replicas, tp, pre).run(_stream())
        rep = j_serving.fleet_report()
        j_serving.disable()
        out[name] = {"streams": {rid: r["tokens"]
                                 for rid, r in res["results"].items()},
                     "assign": [(r["rid"], r["replica"])
                                for r in rep["routes"]],
                     "migrations": rep["migrations"]}
    return out


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_fleet_tokens_equal_jax(topo, pools, weights, jax_runs):
    _, tree = weights
    replicas, tp, pre = TOPOS[topo]
    ranks = pools(replicas * tp).run(FW + "fleet_runs", dict(CFG_KW), tree,
                                     TOPOS[topo], _rows(_stream()))
    want = jax_runs[topo]
    for rank, got in enumerate(ranks):
        run = got[0]
        assert run["completed"] == 6
        assert run["streams"] == want["streams"]
        assert run["assign"] == want["assign"]
        assert run["pages_used"] == 0
        # a process's ledger holds the migrations it took part in: the one
        # prefill lane's, every migration; a decode replica's, its own
        # requests' (each outlives its first token: max_new >= 3)
        replica = rank // tp
        mine = (6 if replica < pre else
                sum(1 for _, r in run["assign"] if r == replica - pre))
        assert run["migrations"] == (mine if pre else 0)
    assert want["migrations"] == (6 if pre else 0)


# -- the SPMD guard -------------------------------------------------------------

SKEW_TOPOS = {"disagg_1+1_tp2": (2, 2, 1), "colocated_2x2": (2, 2, 0)}


@pytest.mark.parametrize("topo", sorted(SKEW_TOPOS))
def test_skewed_clocks_agree(topo, pools, weights, jax_runs):
    """Every rank's clock moves at its own rate (1 + its world rank step
    clocks), so ranks that decided on their own clocks would admit,
    migrate and reweight differently and issue mismatched collectives.
    Two runs in a row complete, with the same assignments, tokens, decode
    steps and router weights on every rank; the second run routes under
    the weights the first run's ``update`` set."""
    _, tree = weights
    replicas, tp, pre = SKEW_TOPOS[topo]
    ranks = pools(replicas * tp).run(FW + "fleet_runs", dict(CFG_KW), tree,
                                     SKEW_TOPOS[topo], _rows(_stream()), 2,
                                     STEP_CLOCK)
    keys = ("assign", "streams", "decode_steps", "clock_s", "weights",
            "migrations", "per_replica")
    for rank in ranks[1:]:
        for got, want in zip(rank, ranks[0]):
            assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    first, second = ranks[0]
    for run in (first, second):
        assert run["completed"] == 6
        # greedy streams do not depend on the topology
        assert run["streams"] == jax_runs["disagg_1+1_tp2"]["streams"]
        assert run["pages_used"] == 0
    assert first["weights"] != [1.0] * len(first["weights"])
    if replicas - pre > 1:
        # the first run's weights moved the second run's assignments
        assert second["assign"] != first["assign"]


def test_fleet_refusals(pools, weights):
    _, tree = weights
    for got in pools(2).run(FW + "fleet_refusals", dict(CFG_KW), tree):
        assert "needs 3 processes, the world has 2" in got["world"]
        assert "at least one decode replica" in got["split"]
        assert "P16" in got["hot"]


# -- the chaos variables and the layouts ---------------------------------------

CHAOS = {"migrate_ms": ("serve_req_chaos_migrate_ms", "5"),
         "prefill_scale": ("serve_req_chaos_prefill_scale", "3")}


def _lane(per_replica):
    """The prefill lane's (clock, prefill seconds)."""
    row = next(r for r in per_replica if r["role"] == "prefill")
    return row["clock_s"], row["prefill_s"]


def _jax_chaos_run(jparams, reqs, cli):
    """The JAX fleet at 1 + 1 and tp 1 on a step clock of STEP_CLOCK a
    reading under the variables ``cli``: the lane and the streams."""
    mods = [importlib.import_module("ompi_tpu.serving." + m)
            for m in ("fleet", "scheduler")]
    real = [m.time for m in mods]
    clock = _StepClock(STEP_CLOCK)
    for m in mods:
        m.time = clock
    for name, value in cli.items():
        j_var.registry.set_cli(name, value)
    try:
        res = _jax_fleet(jparams, 2, 1, 1).run(reqs)
    finally:
        for m, t in zip(mods, real):
            m.time = t
        for name in cli:
            j_var.registry.clear_cli(name)
    return _lane(res["per_replica"]), {rid: r["tokens"] for rid, r
                                       in res["results"].items()}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_chaos_variable_moves_the_lane_clock(case, pools, weights):
    """Every request arrives at 0, so the lane never waits on an arrival
    and its clock is the sum of its prefills and migrations: 6 migrations
    at 5 ms more each, or every prefill's virtual duration tripled."""
    jparams, tree = weights
    name, value = CHAOS[case]
    reqs = [dataclasses.replace(r, arrival=0.0) for r in _stream()]
    got, want = {}, {}
    for on, cli in (("off", {}), ("on", {name: value})):
        want[on] = _jax_chaos_run(jparams, reqs, cli)
        ranks = pools(2).run(FW + "fleet_runs", dict(CFG_KW), tree,
                             (2, 1, 1), _rows(reqs), 1, STEP_CLOCK, False,
                             cli)
        assert ranks[0][0]["per_replica"] == ranks[1][0]["per_replica"]
        got[on] = (_lane(ranks[0][0]["per_replica"]), ranks[0][0]["streams"])
    assert got["on"][1] == got["off"][1] == want["on"][1] == want["off"][1]
    moved = {k: (d["on"][0][0] - d["off"][0][0],
                 d["on"][0][1] - d["off"][0][1])
             for k, d in (("port", got), ("jax", want))}
    prefill_s = got["off"][0][1]
    assert prefill_s > 0
    expect = ((6 * 5e-3, 0.0) if case == "migrate_ms"
              else (2 * prefill_s, 2 * prefill_s))
    assert moved["port"] == pytest.approx(expect, abs=2e-6)
    assert moved["port"] == pytest.approx(moved["jax"], abs=2e-6)


@pytest.mark.parametrize("topo", ["colocated_2x1", "disagg_1+2_tp1"])
def test_fleet_layout_made_once(topo, pools, weights, jax_runs):
    _, tree = weights
    replicas, tp, pre = TOPOS[topo]
    for first, second in pools(replicas * tp).run(
            FW + "fleet_layouts", dict(CFG_KW), tree, TOPOS[topo],
            _rows(_stream())):
        assert second["groups"] == first["groups"]
        assert first["streams"] == second["streams"] == \
            jax_runs[topo]["streams"]
