"""The second half of the audit planes on the port's serving tier
(``ompi_tpu_torch/serving/engine.py``, ``fleet.py``, ``scheduler.py``,
the request plane ``serving/requests.py`` and ``trace/critical.py``)
against the JAX package, on the CPU, at ``tests/test_serving.py``'s CFG
(f32, 2 layers, d 128).

* The pure functions equal the reference's on equal inputs:
  ``critical.request_trees``, ``conservation``, ``tail_attribution`` and
  ``analyze_requests`` on hand timelines (a request whose stages ran on
  two lanes, ``tests/test_requests.py:108``; a population with a tail, an
  unfinished request and an unaligned rank); the request plane's report,
  pvars, ``prometheus_rows``, ``_attribute``, ``_judge`` and its exemplar
  reservoir (``:218``); the flow events' Chrome round trip (``:145``).
* An SLO breach is recorded (counters, exemplar, the ``req:e2e`` span's
  ``breach`` flag) and then refused naming P16b; the report after the
  stream equals the reference's.
* The engine at tp 2 against the reference's at tp 2
  (``tests/test_serving.py:301-370``): per dispatch the decision's arm,
  reason, chain, nbytes, wire bytes and quant ratio, natively and with
  the quant arm forced; the traffic edges byte for byte; conservation;
  the ``serve:*`` spans; on the fused path one ``decide:decode_collmm``
  a ring with the reference's ``ring_schedule`` figures.
* The request plane on the fleet, colocated 2 × 1 and disaggregated
  1 + 1 at tp 2, on one uniform step clock in both packages: the
  ``req:*`` spans and ``report()`` equal the reference's
  ``ServingFleet.run``'s, stage sums equal e2e, and the merged trace of
  every process holds exactly one tree a request; a breached SLO target
  refuses after the counters moved; the disabled plane leaves no state.
"""

import copy
import importlib
import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu import policy as j_policy  # noqa: E402
from ompi_tpu import serving as j_serving  # noqa: E402
from ompi_tpu import spc as j_spc  # noqa: E402
from ompi_tpu import trace as j_trace  # noqa: E402
from ompi_tpu import traffic as j_traffic  # noqa: E402
from ompi_tpu.core import var as j_var  # noqa: E402
from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import DeviceComm as JDeviceComm  # noqa: E402
from ompi_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ompi_tpu.serving import requests as j_requests  # noqa: E402
from ompi_tpu.serving.engine import ServingEngine as JEngine  # noqa: E402
from ompi_tpu.serving.fleet import ServingFleet as JFleet  # noqa: E402
from ompi_tpu.serving.fused import ring_schedule  # noqa: E402
from ompi_tpu.serving.scheduler import (  # noqa: E402
    poisson_stream as j_poisson_stream)
from ompi_tpu.trace import critical as j_critical  # noqa: E402
from ompi_tpu.trace import merge as j_merge  # noqa: E402

from ompi_tpu_torch import spc, trace  # noqa: E402
from ompi_tpu_torch.core import var  # noqa: E402
from ompi_tpu_torch.serving import requests  # noqa: E402
from ompi_tpu_torch.trace import critical, merge  # noqa: E402

import _torch_coll_worker as W  # noqa: E402
from _torch_serve_worker import _StepClock  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

CFG_KW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8, head_dim=16,
              d_ff=256)
JCFG = jax_tfm.Config(dtype=jnp.float32, **CFG_KW)
SW, FW = "_torch_serve_worker:", "_torch_fleet_worker:"
# a prompt of 8 tokens: the reference pads a prefill to a power-of-2
# bucket of at least 8, the port runs it at its own length, so at 8 the
# two prefills dispatch the same payloads
PROMPT = [3, 17, 99, 254, 7, 11, 42, 5]
STEPS = 3
STEP_CLOCK = 2e-3
REQ_VARS = ("serve_req_exemplar_k", "serve_req_slo_ttft_ms",
            "serve_req_slo_itl_ms", "serve_req_slo_e2e_ms")


def _both_planes():
    return ((requests, trace, var), (j_requests, j_trace, j_var))


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    for req, tr, vr in _both_planes():
        for name in REQ_VARS:
            vr.registry.clear_cli(name)
        req.reset()
        req.disable()
        tr.clear()
        tr.disable()
    for name in ("coll_xla_decode_ag_mode", "coll_xla_decode_rs_mode",
                 "coll_quant_block"):
        j_var.registry.clear_cli(name)
    j_policy.reset()
    j_serving.reset()
    j_serving.disable()
    j_traffic.reset()
    j_traffic.disable()


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


def _set(name, value):
    for _req, _tr, vr in _both_planes():
        vr.registry.set_cli(name, value)


# -- the pure functions on hand timelines ---------------------------------------

def _play_one(req, rid, finish=0.050, migrate_end=0.034):
    """``tests/test_requests.py:82-95``: one request crossing lanes 0
    (prefill) → 1 (decode) on the virtual clock."""
    req.note_route(rid, 1, [0.25, 0.75])
    req.note_admit(rid, 0.0, 0.010, 8, 4, replica=1, rank=0)
    req.note_stage(rid, "prefill", 0.010, 0.030, rank=0)
    req.note_stage(rid, "migrate", 0.030, migrate_end, rank=0, src=0,
                   dst=1, wire_bytes=4096)
    req.note_stage(rid, "join", migrate_end, migrate_end + 0.001, rank=1)
    req.note_token(rid, migrate_end + 0.002, rank=1)
    req.note_token(rid, migrate_end + 0.006, rank=1)
    req.note_finish(rid, finish)


def _population(req):
    """Eight requests on two lanes with a slow migration tail, and one
    admitted that never finishes."""
    for i in range(8):
        _play_one(req, i, finish=0.050 + 0.004 * i,
                  migrate_end=0.034 + (0.012 if i in (5, 7) else 0.0))
    req.note_admit(99, 0.0, 0.001, 4, 4, replica=0, rank=0)
    req.note_stage(99, "prefill", 0.001, 0.002, rank=0)


def _events(play):
    """The port's request plane records ``play``; its events, the same
    dicts for both packages' merge."""
    trace.clear()
    trace.enable()
    requests.reset()
    requests.enable()
    play(requests)
    evs = trace.events()
    per = {}
    for e in evs:
        per.setdefault(e["rank"], []).append(e)
    return per


TIMELINES = {
    "bridge": (lambda r: _play_one(r, 7), {0: 0.0, 1: -2e-3},
               {0: 1e-5, 1: 1e-5}),
    "population": (_population, {0: 0.0, 1: 1e-4}, {0: 2e-5, 1: 4e-5}),
    "unaligned": (_population, {0: 0.0}, {0: 2e-5}),
}


@pytest.mark.parametrize("case", sorted(TIMELINES))
def test_critical_path_equals_reference(case):
    play, offsets, rtt = TIMELINES[case]
    per = _events(play)
    got_tl = merge.merge(copy.deepcopy(per), offsets=offsets, best_rtt=rtt)
    want_tl = j_merge.merge(copy.deepcopy(per), offsets=offsets,
                            best_rtt=rtt)
    assert critical.request_trees(got_tl) == j_critical.request_trees(
        want_tl)
    assert critical.conservation(got_tl) == j_critical.conservation(
        want_tl)
    for q in (0.5, 0.99):
        assert (critical.tail_attribution(got_tl, q=q)
                == j_critical.tail_attribution(want_tl, q=q))
    got = critical.analyze_requests(got_tl)
    assert got == j_critical.analyze_requests(want_tl)
    if case == "bridge":
        tree = critical.request_trees(got_tl)[7]
        assert tree["ranks"] == [0, 1]
        assert [s["name"] for s in tree["spans"]] == list(
            critical.STAGE_NAMES)
        assert [f["ph"] for f in tree["flows"]] == ["s", "t", "f"]
        assert got["conservation"]["all_ok"]
    if case == "population":
        assert got["finished"] == 8 and got["requests"] == 9
        assert got["tail"]["rollup"] == {"migrate": 1}
    if case == "unaligned":
        assert not got["conservation"]["all_ok"]


# -- the request plane's pure half ------------------------------------------------

def _stream_play(req, durs):
    for i, d in enumerate(durs):
        rid = f"q{i}"
        req.note_admit(rid, 0.0, 0.001, 4, 2, replica=i % 2)
        req.note_stage(rid, "prefill", 0.001, 0.001 + d / 4,
                       rank=i % 2)
        req.note_token(rid, 0.001 + d / 4, rank=i % 2)
        req.note_token(rid, 0.001 + d / 2, rank=i % 2)
        req.note_finish(rid, d)


DURS = [0.010, 0.030, 0.020, 0.050, 0.005, 0.025]


def test_request_plane_equals_reference():
    """``tests/test_requests.py:218``'s reservoir: identical streams keep
    identical exemplars, the k slowest; the report, the pvars, the
    Prometheus rows, ``_attribute`` and ``_judge`` equal the reference's
    on the same notes."""
    _set("serve_req_exemplar_k", "2")
    got = {}
    for name, (req, tr, _vr) in zip(("port", "jax"), _both_planes()):
        req.enable()
        tr.enable()
        runs = []
        for _ in range(2):
            req.reset()
            _stream_play(req, DURS)
            runs.append([e["rid"] for e in req.report()["exemplars"]])
        assert runs[0] == runs[1]
        got[name] = {
            "report": req.report(),
            "pvars": {n: req.pvar_value(n) for n in req.PVARS},
            "prom": req.prometheus_rows(3, comm="tp"),
            "attribute": [req._attribute(s) for s in (
                {"queue": 0.001, "prefill": 0.009, "decode": 0.002},
                {"decode": 0.5}, {"migrate": 0.2, "prefill": 0.001})],
        }
    assert got["port"] == got["jax"]
    assert set(got["port"]["report"]["exemplars"][i]["rid"]
               for i in range(2)) == {"q3", "q1"}
    for v in ("serve_req_slo_ttft_ms", "serve_req_slo_itl_ms",
              "serve_req_slo_e2e_ms"):
        _set(v, "5")
    for args in ((1.0, 2.0, 3.0), (6.0, 2.0, 7.5), (9.0, 9.0, 9.0)):
        assert requests._judge(*args) == j_requests._judge(*args)


def test_pvars_read_through_and_prometheus():
    requests.reset()
    requests.enable()
    requests.note_admit("a", 0.0, 0.001, 4, 2, replica=0)
    requests.note_admit("b", 0.0, 0.002, 4, 2, replica=0)
    requests.note_finish("a", 0.025)
    c = spc.Counters()
    assert (c.get("req_active"), c.get("req_completed"),
            c.get("req_exemplars_kept")) == (1, 1, 1)
    assert set(requests.PVARS) <= set(c.snapshot())
    text = spc.export_prometheus(c)
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
                            r"(\{[^}]*\})? [-+0-9.e]+$", line), line
    rows = [ln for ln in text.splitlines()
            if ln.startswith("ompi_tpu_request_stage_seconds")]
    assert any('stage="queue"' in ln and 'quantile="0.99"' in ln
               for ln in rows)


def test_breach_recorded_then_refused_naming_p16b():
    """The first breach of an episode is recorded — the breach and
    episode counters, the exemplar, the ``req:e2e`` span's ``breach``
    flag — and then refused: its verdict rides the policy bus (P16b).
    Breaches later in the episode are recorded without a refusal, and the
    report after the stream equals the reference's."""
    _set("serve_req_exemplar_k", "2")
    _set("serve_req_slo_e2e_ms", "40")
    for req, tr, _vr in _both_planes():
        req.reset()
        req.enable()
        tr.enable()
    durs = [0.010, 0.030, 0.050, 0.045, 0.020, 0.060]
    refused = []
    for i, d in enumerate(durs):
        try:
            rid = f"q{i}"
            for req in (requests, j_requests):
                req.note_admit(rid, 0.0, 0.001, 4, 2, replica=0)
                req.note_stage(rid, "prefill", 0.001, 0.002, rank=0)
            j_requests.note_finish(rid, d)
            requests.note_finish(rid, d)
        except NotImplementedError as e:
            assert "P16b" in str(e) and rid in str(e)
            refused.append(rid)
    # q2 (50 ms) opens the episode, q3 (45 ms) stays in it, q4 re-arms,
    # q5 (60 ms) opens the second
    assert refused == ["q2", "q5"]
    rep = requests.report()
    assert (rep["slo_breaches"], rep["episodes"]) == (3, 2)
    assert rep == j_requests.report()
    e2e = {e["args"]["rid"]: e["args"]["breach"] for e in trace.events()
           if e["name"] == "req:e2e"}
    assert [r for r, b in e2e.items() if b] == ["q2", "q3", "q5"]


def test_flow_events_chrome_roundtrip(tmp_path):
    """``tests/test_requests.py:145``: the flow rows survive
    save_chrome → load_chrome as the reference's do."""
    docs = {}
    for name, (_req, tr, _vr) in zip(("port", "jax"), _both_planes()):
        tr.clear()
        tr.enable()
        tr.record_span("req:prefill", "req", 0.010, 0.020, rank=0,
                       args={"rid": 3})
        tr.flow("req:handoff", "req", 3, "s", rank=0, t=0.020)
        tr.flow("req:handoff", "req", 3, "t", rank=0, t=0.024)
        tr.flow("req:handoff", "req", 3, "f", rank=1, t=0.025)
        with pytest.raises(ValueError):
            tr.flow("req:handoff", "req", 3, "x", rank=0, t=0.026)
        paths = [tr.save_chrome(str(tmp_path / f"{name}{r}.json"), rank=r)
                 for r in (0, 1)]
        rows = [json.load(open(p))["traceEvents"] for p in paths]
        loaded = (merge if name == "port" else j_merge).load_chrome(paths)
        # times count from each package's own trace epoch: compare them
        # from the first event's
        t0 = min(r["ts"] for f in rows for r in f if "ts" in r)
        docs[name] = ([[dict(r, ts=r["ts"] - t0) if "ts" in r else r
                        for r in f] for f in rows],
                      {k: [dict(e, t=round(e["t"] - t0 / 1e6, 9))
                           for e in v] for k, v in loaded.items()})
    assert docs["port"] == docs["jax"]
    fin = [r for r in docs["port"][0][1] if r["ph"] == "f"]
    assert fin[0]["id"] == 3 and fin[0]["bp"] == "e"


# -- the engine's decode audit at tp 2 -----------------------------------------

def _jax_engine(jparams, cli=None, **cfg):
    for name, value in (cli or {}).items():
        j_var.registry.set_cli(name, value)
    jcfg = jax_tfm.Config(dtype=jnp.float32, **dict(CFG_KW, **cfg))
    mesh = j_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    dc = JDeviceComm(mesh, "tp")
    eng = JEngine(dc, jax_tfm.shard_params(jparams, mesh, jcfg), jcfg,
                  n_pages=64, page_size=8, max_seqs=4)
    dc.spc = j_spc.Counters()
    eng.wire_bytes = 0
    return eng


def _jax_audit(eng):
    j_trace.clear()
    j_trace.enable()
    j_traffic.reset()
    j_traffic.enable()
    prompt = np.asarray(PROMPT, np.int32)
    slot = eng.cache.admit(len(prompt), STEPS + 1)
    first, _ = eng.prefill(slot, prompt)
    toks, last = [first], first
    for _ in range(STEPS):
        t = np.zeros(eng.max_seqs, np.int32)
        p = np.full(eng.max_seqs, -1, np.int64)
        t[slot], p[slot] = last, int(eng.cache.seq_lens[slot])
        nxt, _ = eng.decode_step(t, p)
        eng.cache.seq_lens[slot] += 1
        last = int(nxt[slot])
        toks.append(last)
    evs = j_trace.events()
    return {"tokens": toks,
            "decisions": [e["args"] for e in evs
                          if e["name"].startswith("decide:decode")],
            "spans": [e["name"] for e in evs
                      if e["name"].startswith("serve:")],
            "edges": j_traffic.matrix.rows(),
            "wire": int(eng.dc.spc.get("coll_wire_bytes"))}


FIELDS = ("op", "arm", "reason", "chain", "nbytes", "wire_bytes",
          "quant_ratio", "shape_bucket", "ndev")


def _fields(args):
    out = {k: args[k] for k in FIELDS}
    # the reference's shape is the canonical (tp, …) array, the port's
    # this process's (1, …) row of it
    out["shape"] = list(args["shape"])[1:]
    return json.loads(json.dumps(out).replace("coll_xla", "coll_nccl"))


ARMS = {"native": ({}, {}),
        "quant": ({"coll_nccl_decode_ag_mode": "quant",
                   "coll_nccl_decode_rs_mode": "quant",
                   "coll_quant_block": 32},
                  {"coll_xla_decode_ag_mode": "quant",
                   "coll_xla_decode_rs_mode": "quant",
                   "coll_quant_block": "32"})}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_engine_decode_audit_equals_reference(arm, pools, weights):
    """One decision a dispatch on every rank with the reference's fields;
    the ring edges equal the reference's byte for byte and sum to the
    wire the spc counted; one ``serve:prefill`` and one
    ``serve:decode_step`` a step; perf cells for both decode colls."""
    jparams, tree = weights
    force, cli = ARMS[arm]
    ranks = pools(2).run(SW + "engine_audit", {"tp": 2}, dict(CFG_KW), tree,
                         PROMPT, STEPS, force)
    want = _jax_audit(_jax_engine(jparams, cli))
    n_disp = (1 + STEPS) * (1 + 4 * CFG_KW["n_layers"] + 2)
    for got in ranks:
        assert got["tokens"] == want["tokens"] or arm == "quant"
        assert sum(got["dispatches"].values()) == n_disp
        assert len(got["decisions"]) == n_disp
        assert all(d["rank"] == got["rank"] for d in got["decisions"])
        assert [_fields(d["args"]) for d in got["decisions"]] == [
            _fields(d) for d in want["decisions"]]
        assert {d["args"]["arm"] for d in got["decisions"]} == {arm}
        assert got["edges"] == want["edges"]
        assert got["spc_wire"] == got["wire_bytes"] == want["wire"]
        assert got["attributed"] == got["spc_wire"] > 0
        assert got["unattributed"] == 0
        assert [s["name"] for s in got["spans"]] == want["spans"] == (
            ["serve:prefill"] + ["serve:decode_step"] * STEPS)
        assert got["spans"][1]["args"] == {"active": 1, "slots": 4,
                                           "path": "eager"}
        assert {(c, a) for c, a, _n in got["perf_cells"]} == {
            ("decode_ag", arm), ("decode_rs", arm)}


def test_fused_engine_one_decision_per_ring(pools, weights):
    """The fused decode at tp 2: every ring of a step one
    ``decide:decode_collmm`` with the reference ``ring_schedule``'s site,
    payload and wire, the ring edges summing to the wire."""
    _, tree = weights
    ranks = pools(2).run(SW + "engine_audit", {"tp": 2},
                         dict(CFG_KW, decode_overlap="fused"), tree,
                         PROMPT, STEPS)
    sched = ring_schedule(CFG_KW["n_layers"], 4, CFG_KW["d_model"], 2, 4)
    for got in ranks:
        rings = [d["args"] for d in got["decisions"]
                 if d["name"] == "decide:decode_collmm"]
        assert got["dispatches"]["decode_collmm"] == len(rings) == (
            STEPS * len(sched))
        assert [(a["site"], a["nbytes"], a["wire_bytes"], a["arm"])
                for a in rings] == [(s, p, w, "native")
                                    for s, p, w in sched] * STEPS
        assert got["attributed"] == got["spc_wire"] == got["wire_bytes"]
        assert got["unattributed"] == 0
        assert {s["args"]["path"] for s in got["spans"]
                if s["name"] == "serve:decode_step"} == {"fused"}


# -- the request plane on the fleet ---------------------------------------------

TOPOS = {"colocated_2x1": (2, 1, 0), "disagg_1+1_tp2": (2, 2, 1)}


def _stream():
    """``tests/test_fleet.py:62-66``'s stream."""
    return j_poisson_stream(6, 200.0, CFG_KW["vocab"], seed=7,
                            prompt_len=(10, 22), max_new=(3, 5))


def _rows(reqs):
    return [(r.rid, r.prompt.tolist(), r.max_new, r.arrival) for r in reqs]


def _jax_fleet_run(jparams, topo):
    """The JAX fleet over the stream on a uniform step clock, the serve,
    trace and request planes on: its request events and report."""
    replicas, tp, pre = topo
    mods = [importlib.import_module("ompi_tpu.serving." + m)
            for m in ("fleet", "scheduler")]
    real = [m.time for m in mods]
    clock = _StepClock(STEP_CLOCK)
    for m in mods:
        m.time = clock
    j_serving.reset()
    j_serving.enable()
    j_requests.reset()
    j_requests.enable()
    j_trace.clear()
    j_trace.enable()
    try:
        fl = JFleet(jparams, JCFG, replicas=replicas, tp=tp,
                    prefill_replicas=pre,
                    devices=jax.devices()[:replicas * tp],
                    spc=j_spc.Counters())
        if tp == 1:
            # one device: give each pool its own buffer (see
            # test_torch_fleet._jax_fleet)
            for rep in fl.replicas:
                cache = rep.engine.cache
                cache.k = [jnp.array(x, copy=True) for x in cache.k]
                cache.v = [jnp.array(x, copy=True) for x in cache.v]
        fl.run(_stream())
    finally:
        for m, t in zip(mods, real):
            m.time = t
    return ([e for e in j_trace.events()
             if e["name"].startswith("req:") or e["name"] == "decide:route"],
            j_requests.report())


def _req_rows(evs):
    """Request events as comparable rows, in a fixed order (the route
    decision's time is the host's, not the virtual clock's)."""
    rows = []
    for e in evs:
        args = {k: v for k, v in e["args"].items()
                if k not in ("verdict",)}
        t = None if e["name"] == "decide:route" else round(e["t"], 9)
        dur = round(e["dur"], 9) if "dur" in e else None
        rows.append((e["name"], e["ph"], e["rank"], t, dur,
                     json.dumps(args, sort_keys=True, default=str)))
    return sorted(rows, key=str)


def _assert_close(got, want, path="", tol=1e-12):
    """Equal structures, floats to ``tol`` (the two packages' virtual
    clocks sum the same steps in different orders)."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= tol, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}", tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]", tol)
    else:
        assert got == want, (path, got, want)


def _report(rep):
    rep = json.loads(json.dumps(rep, default=str))
    rep.pop("enabled")
    return rep


@pytest.fixture(scope="module")
def fleet_runs(weights, pools):
    jparams, tree = weights
    out = {}
    for name, topo in TOPOS.items():
        ranks = pools(topo[0] * topo[1]).run(
            FW + "fleet_requests", dict(CFG_KW), tree, topo,
            _rows(_stream()), STEP_CLOCK)
        out[name] = (ranks, _jax_fleet_run(jparams, topo))
    return out


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_fleet_request_plane_equals_reference(topo, fleet_runs):
    ranks, (want_evs, want_rep) = fleet_runs[topo]
    replicas, tp, pre = TOPOS[topo]
    firsts = [r * tp for r in range(replicas)]
    recording = [r for r in ranks if r["rank"] in firsts]
    # the replicas' first ranks hold the request plane; the others none
    for got in ranks:
        if got["rank"] not in firsts:
            assert got["report"]["completed"] == 0
            assert not got["payload"]["lanes"]
            assert not [e for e in got["payload"]["events"]
                        if e["cat"] == "req"]
    owners = [r for r in recording if r["report"]["completed"]]
    assert sum(r["report"]["completed"] for r in owners) == 6
    # the merged trace of every process: one tree a request, the
    # reference's spans, conservation
    tl = merge.merge_payloads({r["rank"]: r["payload"] for r in ranks},
                              {}, {})
    got_evs = [e for e in tl.events if e["name"].startswith("req:")
               or e["name"] == "decide:route"]
    assert _req_rows(got_evs) == _req_rows(want_evs)
    ana = critical.analyze_requests(tl)
    assert ana["requests"] == ana["finished"] == 6
    assert sorted(t["rid"] for t in ana["trees"]) == list(range(6))
    assert ana["conservation"]["all_ok"], ana["conservation"]
    if pre:
        assert {tuple(t["ranks"]) for t in ana["trees"]} == {(0, 1)}
    # the report of the one recording process equals the reference's
    # when one replica records every request (disaggregated 1 + 1)
    if len(owners) == 1:
        _assert_close(_report(owners[0]["report"]), _report(want_rep))
    else:
        got_rids = sorted(str(e["rid"]) for r in owners
                          for e in r["report"]["exemplars"])
        assert got_rids == sorted(str(e["rid"])
                                  for e in want_rep["exemplars"])
    for r in owners:
        assert r["pvars"]["req_completed"] == r["report"]["completed"]
        for ex in r["report"]["exemplars"]:
            c = ex["conservation"]
            assert abs(c["resid_ms"]) <= 1e-6 * c["e2e_ms"] + 1e-9


def test_fleet_slo_breach_refused_after_counters(pools, weights):
    """A target every request breaches: each replica's first finish is
    recorded, then refused naming P16b."""
    _, tree = weights
    for got in pools(2).run(FW + "fleet_requests", dict(CFG_KW), tree,
                            (2, 1, 0), _rows(_stream()), STEP_CLOCK, True,
                            {"serve_req_slo_e2e_ms": "1e-6"}):
        assert "P16b" in got["refused"]
        assert got["pvars"]["req_slo_breaches"] == 1
        rep = got["report"]
        assert (rep["completed"], rep["episodes"]) == (1, 1)
        assert rep["exemplars"][0]["breach"][0]["metric"] == "e2e"


def test_disabled_plane_leaves_zero_state(pools, weights):
    _, tree = weights
    for got in pools(2).run(FW + "fleet_requests", dict(CFG_KW), tree,
                            (2, 1, 0), _rows(_stream()[:3]), STEP_CLOCK,
                            False):
        assert got["streams"] is not None and got["refused"] is None
        assert all(v == 0.0 for v in got["pvars"].values())
        assert got["events"] == 0
        assert got["report"]["completed"] == 0
        assert got["report"]["exemplars"] == []
