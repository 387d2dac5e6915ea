"""The port's topology traffic plane (``ompi_tpu_torch.traffic``) against
the JAX package's (``ompi_tpu.traffic``).

* The pure geometry on the same inputs: ``spread`` (exact and
  deterministic), ring edges on 1-D and 2-D grids, bipartite and perm
  edges, ``a2a_weights``, ``note_reshard_step``, and ``plane_fn`` on fake
  multi-host grids and under the simulated-DCN override — the port splits
  planes by host where the reference splits them by process.
* The audit's ``note_coll`` on a fake comm (ring directions, the staged
  arm into the ``host`` plane, an unknown coll, alltoallv weights), the
  hot-link and plane-imbalance sentries on the same edge streams.
* End to end under ``tpurun -np 4 --device-plane cpu`` beside the
  reference's single controller on a 4-device mesh: conservation (the
  edges sum to ``coll_wire_bytes``, byte for byte the reference's edges,
  ``traffic_edge_count`` N·(N-1), the same ``per_coll``), the staged arm,
  the collective-matmul directions, ring attention, the hierarchical
  split and the grad sync; the single-card regime (one process, R = 8)
  beside a one-device mesh.
* The disabled path (a plain bool, zero state), the variable watcher, the
  pvars and the Prometheus rows.
"""

import importlib
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from ompi_tpu import traffic as j_traffic
from ompi_tpu.core import var as j_var
from ompi_tpu.traffic import planes as j_planes
from ompi_tpu.traffic.sentry import HotlinkSentry as JSentry
from ompi_tpu_torch import trace as t_trace
from ompi_tpu_torch import traffic as t_traffic
from ompi_tpu_torch.core import var as t_var
from ompi_tpu_torch.traffic import planes as t_planes
from ompi_tpu_torch.traffic.sentry import HotlinkSentry as TSentry

# the package's ``matrix`` attribute is its TrafficMatrix; the modules:
j_matrix = importlib.import_module("ompi_tpu.traffic.matrix")
t_matrix = importlib.import_module("ompi_tpu_torch.traffic.matrix")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_audit_ref as ref  # noqa: E402

N = 4


@pytest.fixture(autouse=True)
def _clean():
    for mod in (j_traffic, t_traffic):
        mod.disable()
        mod.reset()
    j_planes._PROC_CACHE.clear()      # keyed by id(): fakes reuse ids
    yield
    for mod in (j_traffic, t_traffic):
        mod.disable()
        mod.reset()
    t_trace.disable()
    t_trace.clear()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traffic4")
    return ref.port(tmp, N, ["traffic", "geometry"])


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traffic1")
    return ref.port(tmp, 1, ["traffic"], r_per=8)[0]


def j_fake(shape, names, proc_of=None):
    """The reference's duck-typed mesh (tests/test_traffic.py)."""
    size = int(np.prod(shape))
    devs = np.empty(size, dtype=object)
    for i in range(size):
        devs[i] = SimpleNamespace(id=i, platform="cpu",
                                  process_index=proc_of(i) if proc_of else 0)
    return SimpleNamespace(devices=devs.reshape(shape),
                           axis_names=tuple(names))


def t_fake(shape, names, host_of=None):
    """The port's: a rank grid, its axis names, and a host per position."""
    size = int(np.prod(shape))
    return SimpleNamespace(
        mesh=np.arange(size).reshape(shape), mesh_dim_names=tuple(names),
        hosts=[host_of(i) if host_of else 0 for i in range(size)])


def both_fakes(shape, names, where=None):
    return j_fake(shape, names, where), t_fake(shape, names, where)


# -- pure geometry -------------------------------------------------------------

def test_spread_exact_deterministic_and_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        k = int(rng.integers(1, 12))
        edges = [(int(a), int(b)) for a, b in rng.integers(0, 8, (k, 2))]
        total = int(rng.integers(0, 10_000))
        w = None if rng.random() < 0.3 else rng.random(k).tolist()
        got = t_matrix.spread(total, edges, w)
        assert got == j_matrix.spread(total, edges, w)
        assert got == t_matrix.spread(total, edges, w)
        if got:
            assert sum(b for _, b in got) == total
    assert t_matrix.spread(100, [(0, 1)], [0.0]) == []
    assert t_matrix.spread(0, [(0, 1)]) == []


@pytest.mark.parametrize("shape,names", [((4,), ("x",)), ((1,), ("x",)),
                                         ((2, 3), ("a", "b")),
                                         ((2, 2, 2), ("dpo", "dp", "tp"))])
def test_edges_equal_reference(shape, names):
    jm, tm = both_fakes(shape, names)
    axes = list(names) + ([tuple(names[:2])] if len(names) > 1 else [])
    for axis in axes:
        for d in ("fwd", "rev", "bidir"):
            assert (t_matrix.ring_edges(tm, axis, d)
                    == j_matrix.ring_edges(jm, axis, d))
        assert (t_matrix.bipartite_edges(tm, axis)
                == j_matrix.bipartite_edges(jm, axis))
        n = int(np.prod([shape[names.index(a)] for a in
                         (axis if isinstance(axis, tuple) else (axis,))]))
        pairs = [(i, (i + 1) % n) for i in range(n)] + [(0, 0)]
        assert (t_matrix.perm_edges(tm, axis, pairs)
                == j_matrix.perm_edges(jm, axis, pairs))


def test_a2a_weights_equal_reference():
    C = np.random.default_rng(1).integers(0, 9, (4, 4))
    for lines in (1, 3):
        assert t_matrix.a2a_weights(C, lines) == j_matrix.a2a_weights(C,
                                                                      lines)


@pytest.mark.parametrize("where,sim", [
    (None, ""), (lambda i: i // 2, ""), (lambda i: i, ""),
    (lambda i: 1 if i == 3 else 0, ""), (None, "dp"), (None, "dp,tp")])
def test_plane_fn_by_host_equals_reference_by_process(where, sim):
    """The reference's process boundary is the port's host boundary: the
    same split on the same grid gives the same plane for every edge."""
    jm, tm = both_fakes((2, 2), ("dp", "tp"), where)
    j_var.registry.set_cli("topo_sim_dcn_axes", sim)
    j_var.registry.reset_cache()
    old = os.environ.get("OMPI_TPU_topo_sim_dcn_axes")
    os.environ["OMPI_TPU_topo_sim_dcn_axes"] = sim
    try:
        jp, tp = j_planes.plane_fn(jm), t_planes.plane_fn(tm)
        for s in range(4):
            for d in range(4):
                assert tp(s, d) == jp(s, d), (s, d)
    finally:
        j_var.registry.clear_cli("topo_sim_dcn_axes")
        j_var.registry.reset_cache()
        if old is None:
            os.environ.pop("OMPI_TPU_topo_sim_dcn_axes")
        else:
            os.environ["OMPI_TPU_topo_sim_dcn_axes"] = old


def test_note_reshard_step_equals_reference():
    jm, tm = both_fakes((2, 2), ("a", "b"), lambda i: i // 2)
    for kind, axes, pairs in (("ring", "b", None), ("a2a", ("a", "b"), None),
                              ("perm", "a", [(0, 1), (1, 0)]),
                              ("ring", "a", None)):
        got = t_traffic.note_reshard_step(tm, kind, axes, 1001, pairs)
        want = j_traffic.note_reshard_step(jm, kind, axes, 1001, pairs)
        assert got == want
    assert t_traffic.matrix.to_json() == j_traffic.matrix.to_json()
    with pytest.raises(ValueError, match="unknown kind"):
        t_traffic.note_reshard_step(tm, "star", "a", 10)


# -- the audit's attribution on a fake comm -------------------------------------

def _dcs(n=N, where=None):
    jm, tm = both_fakes((n,), ("x",), where)
    return (SimpleNamespace(mesh=jm, axis="x", n=n),
            SimpleNamespace(mesh=tm, axis="x", n=n))


@pytest.mark.parametrize("coll,arm,weights", [
    ("allreduce", "native", None), ("allreduce", "bidir", None),
    ("allreduce", "staged", None), ("frobnicate", "native", None),
    ("alltoall", "native", None),
    ("alltoallv", "native", [[0, 9, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1],
                             [0, 0, 1, 0]]),
    ("moe_dispatch", "native", None), ("decode_ag", "native", None)])
def test_note_coll_equals_reference(coll, arm, weights):
    jdc, tdc = _dcs(where=lambda i: i // 2)
    w = None if weights is None else np.asarray(weights)
    j_traffic.note_coll(jdc, coll, arm, 1200, weights=w)
    t_traffic.note_coll(tdc, coll, arm, 1200, weights=w)
    assert t_traffic.matrix.to_json() == j_traffic.matrix.to_json()
    assert t_traffic.report() == j_traffic.report()
    if arm == "staged":
        assert t_traffic.matrix.plane_totals() == {"host": 1200}
    if coll == "frobnicate":
        assert t_traffic.pvar_value("traffic_unattributed_bytes") == 1200


def test_note_coll_hier_split_equals_reference():
    jm, tm = both_fakes((2, 2), ("dpo", "dp"), lambda i: i // 2)
    jdc = SimpleNamespace(mesh=jm, axis=("dpo", "dp"), n=4)
    tdc = SimpleNamespace(mesh=tm, axis=("dpo", "dp"), n=4)
    split = ("dp", "dpo", 500, 300, 600)
    j_traffic.note_coll(jdc, "allreduce", "hier", 1300, hier=split)
    t_traffic.note_coll(tdc, "allreduce", "hier", 1300, hier=split)
    assert t_traffic.report() == j_traffic.report()
    assert t_traffic.matrix.plane_totals() == {"ici": 1000, "dcn": 300}


# -- the sentries ------------------------------------------------------------------

def _edges(vals, plane=lambda e: "ici"):
    return [(e, b, plane(e)) for e, b in vals.items()]


def _streams():
    base = {(i, i + 1): 10_000 for i in range(7)}
    hot3, hot9, hot12 = dict(base), dict(base), dict(base)
    hot3[(0, 5)], hot9[(0, 5)], hot12[(0, 5)] = 30_000, 90_000, 120_000
    small = {(i, i + 1): 10 for i in range(7)}
    small[(0, 5)] = 1000
    one = {(0, 1): 10 ** 9}
    return [base, hot3, hot9, hot9, hot9, base, hot12, small, one]


def test_hotlink_sentry_trips_equal_reference():
    js, ts = JSentry(), TSentry()
    for vals in _streams():
        assert ts.check(_edges(vals)) == js.check(_edges(vals))
    assert ts.trips() == js.trips() == 2
    assert ts.verdicts() == js.verdicts()


def test_plane_imbalance_equals_reference():
    js, ts = JSentry(), TSentry()
    plane = lambda e: "dcn" if e[0] >= 4 else "ici"  # noqa: E731
    skew = {(i, i + 1): 100_000 for i in range(4)}
    skew.update({(i + 4, i + 5): 1_000 for i in range(4)})
    even = {e: 50_000 for e in skew}
    for vals in (skew, skew, even, skew):
        ts.check(_edges(vals, plane))
        js.check(_edges(vals, plane))
    assert ts.verdicts() == js.verdicts()
    assert sum(v["kind"] == "plane_imbalance" for v in ts.verdicts()) == 2


def test_hotlink_trip_emits_trace_instant():
    t_trace.enable()
    t_trace.clear()
    hot = {(i, i + 1): 10_000 for i in range(7)}
    hot[(0, 5)] = 90_000
    assert TSentry().check(_edges(hot)) is not None
    evs = [e for e in t_trace.events() if e["name"] == "traffic_hotlink"]
    assert len(evs) == 1 and (evs[0]["args"]["src"],
                              evs[0]["args"]["dst"]) == (0, 5)


# -- the gate --------------------------------------------------------------------

def test_disabled_gate_is_a_plain_bool_and_var_watched():
    assert t_traffic.enabled is False
    assert type(vars(t_traffic)["enabled"]) is bool
    assert not hasattr(t_traffic, "__getattr__")
    t_var.registry.set_cli("traffic_enabled", "1")
    t_var.registry.reset_cache()
    try:
        assert t_traffic.enabled is True
    finally:
        t_var.registry.clear_cli("traffic_enabled")
        t_var.registry.reset_cache()
    assert t_traffic.enabled is False
    # the disabled path leaves nothing behind
    _jdc, tdc = _dcs()
    assert t_traffic.matrix.ops == 0 and t_traffic.sentry.trips() == 0
    assert t_traffic.prometheus_rows() == []


# -- end to end: four processes beside a four-device mesh ------------------------

def test_conservation_four_processes_equal_reference(world4):
    want = ref.ref_conservation(N)
    for rank, got in enumerate(world4):
        c = got["conservation"]
        # THE invariant, per process: every wire-counted byte on an edge
        assert c["spc"]["coll_wire_bytes"] > 0
        assert (c["spc"]["traffic_attributed_bytes"]
                == c["spc"]["coll_wire_bytes"])
        assert c["spc"]["traffic_unattributed_bytes"] == 0
        assert (sum(e["bytes"] for e in c["matrix"]["rows"])
                == c["spc"]["coll_wire_bytes"])
        assert c["spc"]["traffic_edge_count"] == N * (N - 1)
        # byte for byte the reference's single-controller matrix
        assert c["matrix"] == want["matrix"], rank
        assert c["spc"] == want["spc"], rank
        assert set(c["matrix"]["planes"]) == {"ici"}      # one host
        assert got["staged"] == want["staged"]
        assert got["staged"]["planes"] == {"host": got["staged"]["placed"]}


def test_prometheus_rows_parse(world4):
    text = world4[1]["prometheus"]
    assert text.endswith("\n")
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'[-+]?[0-9.eE+-]+$')
    typed = set()
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if line.startswith("# HELP "):
            continue
        assert sample.match(line), line
        assert line.split("{")[0] in typed, line
    assert re.search(r'ompi_tpu_traffic_edge_bytes\{rank="1",comm="world",'
                     r'src="0",dst="1",plane="ici"\} ', text)
    assert ('ompi_tpu_traffic_plane_bytes{rank="1",comm="world",'
            'plane="ici"}') in text
    for name in t_traffic.PVARS:
        assert f"ompi_tpu_{name}{{" in text


def _moved(m: dict, n: int) -> dict:
    """A reference matrix's byte figures times (n − 1)/n (each divides
    exactly here): ring attention's charge when the ring makes the n − 1
    hops the port makes, where the reference charges n."""
    def part(b):
        assert b * (n - 1) % n == 0, b
        return b * (n - 1) // n
    return {**m, "edges": [{**e, "bytes": part(e["bytes"])}
                           for e in m["edges"]],
            "planes": {k: part(v) for k, v in m["planes"].items()},
            "per_coll": {k: part(v) for k, v in m["per_coll"].items()},
            "attributed_bytes": part(m["attributed_bytes"])}


def test_wrapper_charges_equal_reference(world4):
    """Every wrapper's charge equals the reference's, but ring
    attention's: the port charges the n − 1 hops it makes, (n − 1)/n of
    the reference's n-hop figure (ROADMAP, Departures)."""
    want = ref.ref_geometry(N)
    want["ring_attention"] = _moved(want["ring_attention"], N)
    for got in world4:
        geo = got["geometry"]
        for key, w in want.items():
            assert geo[key] == w, key
        # the bucketed sync charges the same ring figure as perleaf
        assert geo["grad_sync_bucketed"] == geo["grad_sync_perleaf"]
        assert geo["grad_sync_unsynced"]["ops"] == 0
        fwd = {(i, (i + 1) % N) for i in range(N)}
        assert {(e["src"], e["dst"])
                for e in geo["collmm_rev"]["edges"]} == {
            (d, s) for s, d in fwd}


def test_single_card_regime_equals_one_device_mesh(world1):
    """One process holding R = 8 rows: a ring of one, no links.  The
    reference's one-device mesh charges the same (nothing on edges; the
    alltoall's per-rank payload, with no model, lands unattributed)."""
    want = ref.ref_conservation(1, r_per=8)
    assert world1["conservation"]["spc"] == want["spc"]
    assert world1["conservation"]["matrix"] == want["matrix"]
    assert world1["conservation"]["matrix"]["edge_count"] == 0
    assert world1["staged"] == want["staged"]
