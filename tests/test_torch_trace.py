"""The port's trace plane (``ompi_tpu_torch.trace``, ``trace.merge``,
``trace.analyze``, ``tools.mpisync``) against the JAX package's.

* The recorder: the var-watched gate (a plain bool, one attribute read),
  the ring and its per-rank dropped counts, ``stats``/``format_stats``,
  ``chrome_doc``/``save_chrome``/``load_chrome``/``load_offsets`` in every
  form, equal to the reference's on the same events and files.
* Floor µs once: over 200 seeded offset sets the merged Chrome trace of
  adjacent spans has no overlap in any (pid, tid) lane after a file round
  trip (the reference floors twice and can overlap by 1 µs).
* The analyzer on hand timelines: ``entry_skew``, ``decision_drift``,
  ``bubble_fraction``, ``latency_histograms``, ``ring_health`` and
  ``analyze`` equal to the reference's, floats to 1e-12.
* mpisync and ``gather`` over threaded ranks (host point-to-point).
* The wired audit under ``tpurun -np 4 --device-plane cpu`` beside the
  reference's single controller on a 4-device mesh: the twelve
  ``comm.coll`` entries and the forced, blanket, rules and floor regimes
  leave ONE decision event per entry per process whose decision-layer
  fields are the reference's; the quant arm's wire bytes in the event and
  in spc; the disabled path leaves nothing; a var write toggles each
  plane; a live straggler is flagged exactly and the merged trace holds.
"""

import io
import json
import os
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from ompi_tpu import trace as j_trace
from ompi_tpu.trace import analyze as j_analyze
from ompi_tpu.trace import merge as j_merge
from ompi_tpu_torch import runtime as t_runtime
from ompi_tpu_torch import trace as t_trace
from ompi_tpu_torch.core import var as t_var
from ompi_tpu_torch.tools import mpisync as t_mpisync
from ompi_tpu_torch.trace import analyze as t_analyze
from ompi_tpu_torch.trace import merge as t_merge

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_audit_prog as prog  # noqa: E402
import _torch_audit_ref as ref  # noqa: E402

N = 4


@pytest.fixture(autouse=True)
def _tracing():
    for mod in (j_trace, t_trace):
        mod.clear()
        mod.enable(capacity=65536)
    yield
    for mod in (j_trace, t_trace):
        mod.disable()
        mod.clear()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace4")
    return tmp, ref.port(tmp, N, ["decisions", "regimes", "disabled",
                                  "skew", "toggle"])


def close(a, b, path="") -> None:
    """Equal structures, floats to 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(fn) -> None:
    """Run ``fn(trace_module)`` against each package."""
    for mod in (j_trace, t_trace):
        fn(mod)


# -- the recorder ---------------------------------------------------------------

def test_gate_is_one_attribute_read_and_var_watched():
    t_trace.disable()
    assert "enabled" in vars(t_trace) and type(t_trace.enabled) is bool
    assert not hasattr(t_trace, "__getattr__")
    t_var.registry.set_cli("trace_enabled", "1")
    t_var.registry.reset_cache()
    try:
        assert t_trace.enabled is True
        # notify fires on CHANGE only: a reset pass keeps a direct disable
        t_trace.disable()
        t_var.registry.reset_cache()
        assert t_trace.enabled is False
    finally:
        t_var.registry.clear_cli("trace_enabled")
        t_var.registry.reset_cache()
    assert t_trace.enabled is False
    t_var.registry.set_override("trace_enabled", True)
    assert t_trace.enabled is True
    t_var.registry.reset_cache()
    assert t_trace.enabled is False


def test_enable_rereads_capacity_var():
    t_var.registry.set_cli("trace_buffer_events", "16")
    t_var.registry.reset_cache()
    try:
        t_trace.enable()
        for i in range(40):
            t_trace.instant(f"e{i}", "event")
        assert len(t_trace.events()) == 16
        assert t_trace.dropped_events() == 24
    finally:
        t_var.registry.clear_cli("trace_buffer_events")
        t_var.registry.reset_cache()


def test_ring_dropped_and_stats_equal_reference():
    def record(tr):
        tr.enable(capacity=4)
        for r, n in ((0, 4), (1, 7), (2, 12)):
            for i in range(n):
                tr.instant(f"r{r}e{i}", "event", rank=r, t=1.0 + i)
        tr.record_span("s", "span", 0.5, 0.75, rank=1, args={"arm": "x"})
        tr.decision("allreduce", "native", "default:platform=cpu", 64,
                    rank=2, t=3.5, ndev=4, chain=[])
        tr.flow("hop", "req", 7, "s", rank=0, t=2.0)
    both(record)
    assert t_trace.dropped_by_rank() == j_trace.dropped_by_rank()
    assert t_trace.dropped_events() == j_trace.dropped_events() == 14
    for r in (None, 0, 1, 2, 99):
        assert t_trace.dropped_events(r) == j_trace.dropped_events(r)
        assert t_trace.events(r) == j_trace.events(r)
        close(t_trace.stats(r), j_trace.stats(r))
        assert t_trace.format_stats(r) == j_trace.format_stats(r)
    assert t_trace.explain_last("allreduce") == j_trace.explain_last(
        "allreduce")
    assert t_trace.last_decisions() == j_trace.last_decisions()
    with pytest.raises(ValueError, match="flow phase"):
        t_trace.flow("x", "c", 1, "z")


def test_span_error_tag_and_sink():
    seen = []
    t_trace.set_span_sink(lambda *a: seen.append(a))
    try:
        with pytest.raises(KeyError):
            with t_trace.span("work", "span", rank=0, args={"k": 1}):
                raise KeyError("x")
        with t_trace.span("ok", "span"):
            pass
    finally:
        from ompi_tpu_torch import perf
        t_trace.set_span_sink(perf._ingest_span)
    evs = t_trace.events()
    assert evs[0]["args"] == {"k": 1, "status": "error"}
    assert [a[0] for a in seen] == ["work", "ok"]


def _adjacent_spans(tr, ranks=3, spans=5):
    for r in range(ranks):
        t = 0.0
        for i in range(spans):
            tr.record_span(f"work:{i}", "span", t, t + 1e-4, rank=r)
            t += 1e-4
        tr.instant("enter:allreduce", "coll-enter", rank=r,
                   args={"op": "allreduce"}, t=t)


def test_chrome_doc_matches_reference_lanes():
    """Same rows, lanes and metadata as the reference's; each time within
    the reference's by at most the 1 µs its direct floor can lose."""
    both(_adjacent_spans)
    jd = j_trace.chrome_doc(j_trace.events(), 0.0)
    td = t_trace.chrome_doc(t_trace.events(), 0.0)
    assert len(jd["traceEvents"]) == len(td["traceEvents"])
    for a, b in zip(jd["traceEvents"], td["traceEvents"]):
        assert {k: v for k, v in a.items() if k not in ("ts", "dur")} == {
            k: v for k, v in b.items() if k not in ("ts", "dur")}
        for k in ("ts", "dur"):
            if k in a:
                assert abs(a[k] - b[k]) <= 1
    assert td["displayTimeUnit"] == jd["displayTimeUnit"]


def test_save_load_chrome_and_offsets_equal_reference(tmp_path):
    _adjacent_spans(t_trace)
    t_trace.flow("hop", "req", 3, "f", rank=1, t=1e-3)
    paths = []
    for r in range(3):
        p = str(tmp_path / f"trace.{r}.json")
        assert t_trace.save_chrome(p, rank=r) == p
        paths.append(p)
    both_all = str(tmp_path / "all.json")
    t_trace.save_chrome(both_all)
    for ps, ranks in ((paths, None), ([both_all], None),
                      (paths[:1] * 2, [5, 6])):
        assert t_merge.load_chrome(ps, ranks) == j_merge.load_chrome(ps,
                                                                     ranks)
    forms = {"flat.json": {"0": 0.0, "1": -2e-3},
             "list.json": [0.0, -2e-3, 3e-3],
             "combined.json": {"offsets": {"0": 0.0, "1": 4e-3},
                               "best_rtt": {"0": 0.0, "1": 1e-4}}}
    for name, doc in forms.items():
        p = str(tmp_path / name)
        with open(p, "w") as fh:
            json.dump(doc, fh)
        assert t_merge.load_offsets(p) == j_merge.load_offsets(p)
        assert t_merge.load_offsets_ex(p) == j_merge.load_offsets_ex(p)


def _lane_overlaps(doc) -> int:
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            lanes.setdefault((e["pid"], e["tid"]), []).append(e)
    bad = 0
    for spans in lanes.values():
        spans.sort(key=lambda e: e["ts"])
        bad += sum(a["ts"] + a["dur"] > b["ts"]
                   for a, b in zip(spans, spans[1:]))
    return bad


def test_merged_chrome_never_overlaps_over_200_offset_sets(tmp_path):
    """The reference's test_merged_chrome_monotonic_and_nonoverlapping,
    over 200 seeded offset sets: zero overlaps, monotonic, pid = rank."""
    _adjacent_spans(t_trace)
    paths = []
    for r in range(3):
        p = str(tmp_path / f"trace.{r}.json")
        t_trace.save_chrome(p, rank=r)
        paths.append(p)
    per_rank = t_merge.load_chrome(paths)
    assert sorted(per_rank) == [0, 1, 2]
    assert all(len(v) == 6 for v in per_rank.values())
    rng = np.random.default_rng(2024)
    out = str(tmp_path / "merged.json")
    overlaps = 0
    for _ in range(200):
        offsets = {0: 0.0, 1: float(rng.uniform(-5e-3, 5e-3)),
                   2: float(rng.uniform(-5e-3, 5e-3))}
        tl = t_merge.merge(per_rank, offsets=offsets,
                           best_rtt={r: 1e-5 for r in range(3)})
        ts = [e["t"] for e in tl.events]
        assert ts == sorted(ts)
        tl.save_chrome(out)
        with open(out) as fh:
            doc = json.load(fh)
        rows = [e for e in doc["traceEvents"] if e["ph"] != "M"]
        assert all(e["ts"] >= 0 for e in rows)
        assert [e["ts"] for e in rows] == sorted(e["ts"] for e in rows)
        assert {e["pid"] for e in rows} == {0, 1, 2}
        overlaps += _lane_overlaps(doc)
        assert doc["otherData"]["clock_offsets_s"]["2"] == offsets[2]
    assert overlaps == 0


# -- the analyzer on hand timelines ----------------------------------------------

def _fleet(tr, n_ranks=4, straggler=3, delay=8e-4, instances=12, seed=0):
    """Every rank enters each allreduce instance (jittered); one rank
    late; plus decisions, pipeline and grad-sync spans."""
    rng = np.random.default_rng(seed)
    for k in range(instances):
        base = k * 1e-3
        for r in range(n_ranks):
            late = delay if r == straggler else 0.0
            tr.instant("enter:allreduce", "coll-enter", rank=r,
                       args={"op": "allreduce"},
                       t=base + late + r * 1e-6 + rng.uniform(0, 2e-6))
    for arm, reason, nb in (("native", "default:platform=cpu", 4096),
                            ("staged", "rule:allreduce 1 0 staged", 4096),
                            ("quant", "force:coll_x_mode=quant", 4096),
                            ("native", "default:platform=cpu", 2 << 20),
                            ("staged", "ineligible:dtype", 2 << 20)):
        tr.decision("allreduce", arm, reason, nb, rank=0, ndev=4,
                    t=0.05 + rng.uniform(0, 1e-3))
    tr.decision("alltoall", "staged", "default:small", 4096, rank=1,
                ndev=4, t=0.06)
    tr.record_span("pipeline:run", "pipeline", 0.0, 0.1, rank=0,
                   args={"stages": 4, "microbatches": 4, "ticks": 7})
    tr.record_span("grad_sync:run", "overlap", 0.2, 0.25, rank=1,
                   args={"mode": "bucketed", "ndev": 8})
    for i in range(5):
        tr.record_span("grad_sync:bucket", "overlap-buckets",
                       0.2 + i * 0.01, 0.2 + (i + 1) * 0.01, rank=1,
                       args={"arm": "native", "nbytes": 1 << 20,
                             "ndev": 4})
        tr.record_span("quant:allreduce", "quant", 0.3 + i * 1e-3,
                       0.3 + i * 1e-3 + 10 ** -(4 + i % 3), rank=2,
                       args={"arm": "quant", "wire_bytes": 4096})


def _timelines(offsets=None, best_rtt=None):
    both(_fleet)
    sink = io.StringIO()
    with redirect_stderr(sink), redirect_stdout(sink):
        tl_j = j_merge.merge({r: j_trace.events(r) for r in range(4)},
                             offsets=offsets, best_rtt=best_rtt,
                             dropped={0: 0, 1: 3})
        tl_t = t_merge.merge({r: t_trace.events(r) for r in range(4)},
                             offsets=offsets, best_rtt=best_rtt,
                             dropped={0: 0, 1: 3})
    return tl_j, tl_t, sink.getvalue()


RULES = [("allreduce", 1, 0, "staged"), ("allreduce", 1, 1 << 20, "native")]


@pytest.mark.parametrize("offsets,best_rtt", [
    (None, None), ({0: 0.0, 1: -2e-3, 2: 1e-3, 3: 5e-4}, None),
    (None, {3: 0.01}), ({0: 0.0, 1: 0.0, 2: 0.0}, None)])
def test_analyze_equals_reference(offsets, best_rtt):
    tl_j, tl_t, _ = _timelines(offsets, best_rtt)
    assert tl_t.ranks == tl_j.ranks
    assert tl_t.unaligned_ranks == tl_j.unaligned_ranks
    close(t_analyze.entry_skew(tl_t, 2.0), j_analyze.entry_skew(tl_j, 2.0))
    close(t_analyze.latency_histograms(tl_t),
          j_analyze.latency_histograms(tl_j))
    close(t_analyze.bubble_fraction(tl_t), j_analyze.bubble_fraction(tl_j))
    close(t_analyze.decision_drift(tl_t, RULES),
          j_analyze.decision_drift(tl_j, RULES))
    close(t_analyze.ring_health(tl_t), j_analyze.ring_health(tl_j))
    close(t_analyze.analyze(tl_t, z_thresh=2.0),
          j_analyze.analyze(tl_j, z_thresh=2.0))


def test_straggler_drift_and_bubble_values():
    tl_j, tl_t, _ = _timelines()
    sk = t_analyze.entry_skew(tl_t, z_thresh=2.0)
    assert sk["flagged"] == [3]
    assert sk["per_coll"]["allreduce"]["worst_rank"] == 3
    drift = t_analyze.decision_drift(tl_t, RULES)
    assert drift["checked"] == 5 and drift["drift_count"] == 1
    assert t_analyze.bubble_fraction(tl_t)["bubble_fraction_mean"] == round(
        3 / 7, 4)
    assert t_analyze.ring_health(tl_t)["overflowed_ranks"] == [1]
    # confidence gate: lateness inside ±rtt/2 is never flagged
    _, tl_t, _ = _timelines(best_rtt={3: 0.01})
    assert t_analyze.entry_skew(tl_t, 2.0)["flagged"] == []


def test_drift_from_rules_file_equals_reference(tmp_path):
    rules = tmp_path / "rules.conf"
    rules.write_text("# comment\nallreduce 1 0 staged\n"
                     "allreduce 1 1048576 native\nalltoall 2 0 staged\n")
    assert t_analyze.load_rules(str(rules)) == j_analyze.load_rules(
        str(rules))
    tl_j, tl_t, _ = _timelines()
    close(t_analyze.decision_drift(tl_t, str(rules)),
          j_analyze.decision_drift(tl_j, str(rules)))
    close(t_analyze.analyze(tl_t, rules=str(rules)),
          j_analyze.analyze(tl_j, rules=str(rules)))


def test_partial_offsets_degrade_loudly_empty_quiet(monkeypatch):
    from ompi_tpu_torch.core.output import output
    buf = io.StringIO()
    monkeypatch.setattr(output, "_stream", buf)
    _, tl_t, _ = _timelines()
    assert tl_t.unaligned_ranks == []
    t_trace.clear()
    _fleet(t_trace)
    tl = t_merge.merge({r: t_trace.events(r) for r in range(4)},
                       offsets={0: 0.0, 1: -2e-3, 2: 1e-3})
    assert tl.unaligned_ranks == [3]
    assert "covers rank(s) [0, 1, 2] but not [3]" in buf.getvalue()
    assert t_analyze.entry_skew(tl, 2.0)["flagged"] == []
    buf.truncate(0)
    tl = t_merge.merge({r: t_trace.events(r) for r in range(4)}, offsets={})
    assert tl.unaligned_ranks == []
    assert "unaligned" not in buf.getvalue()


# -- mpisync and gather over threaded ranks ----------------------------------------

def test_mpisync_size1_no_pingpong():
    def fn(ctx):
        c = ctx.comm_world
        before = ctx.spc.get("sends") + ctx.spc.get("isends")
        off, rtt = t_mpisync.clock_sync_ex(c)
        return off, rtt, ctx.spc.get("sends") + ctx.spc.get("isends") \
            - before

    off, rtt, sent = t_runtime.run_ranks(1, fn)[0]
    assert off.tolist() == [0.0] and rtt.tolist() == [0.0] and sent == 0


def test_mpisync_offsets_and_gather_live_straggler():
    """Four threaded ranks: offsets against rank 0 with their RTT bound,
    bcast to all; then host allreduces with rank 2 late, gathered to rank
    0 and attributed exactly."""
    def fn(ctx):
        c = ctx.comm_world
        off, rtt = t_mpisync.clock_sync_ex(c, rounds=6)
        for _ in range(6):
            if ctx.rank == 2:
                time.sleep(0.006)
            c.coll.allreduce(c, np.ones(8, np.float32))
        return off, rtt, t_merge.gather(c, rounds=5)

    res = t_runtime.run_ranks(4, fn, timeout=120)
    for off, rtt, _ in res:
        np.testing.assert_array_equal(off, res[0][0])
        np.testing.assert_array_equal(rtt, res[0][1])
    off, rtt, tl = res[0]
    assert off[0] == 0.0 and rtt[0] == 0.0 and (rtt[1:] > 0).all()
    assert np.abs(off[1:]).max() <= max(rtt.max(), 0.1)
    assert all(r[2] is None for r in res[1:])
    assert tl.ranks == [0, 1, 2, 3]
    assert {e["rank"] for e in tl.arrivals("allreduce")} == {0, 1, 2, 3}
    sk = t_analyze.entry_skew(tl, z_thresh=2.0)
    assert sk["flagged"] == [2], sk
    assert sk["per_coll"]["allreduce"]["p99"] >= 3000


# -- the wired audit: four processes beside the single controller ------------------

def test_one_decision_per_entry_with_reference_fields(world):
    _tmp, ranks = world
    want = ref.ref_decisions(N)
    assert [d["op"] for d in want["decisions"]] == list(prog.ENTRIES)
    for rank, got in enumerate(ranks):
        assert got["decide_ranks"] == [rank]    # its own rank, once each
        assert [d["op"] for d in got["decisions"]] == list(prog.ENTRIES)
        assert got["enter"] == len(prog.ENTRIES)
        for g, w in zip(got["decisions"], want["decisions"]):
            assert g == {k: ref.port_name(v) for k, v in w.items()}, g
        assert got["arms"] == want["arms"]
    # default decisions on the CPU fabric: alltoall staged, the rest native
    arms = {d["op"]: d["arm"] for d in ranks[0]["decisions"]}
    assert arms.pop("alltoall") == "staged"
    assert set(arms.values()) == {"native"}


def test_regimes_equal_reference(world):
    tmp, ranks = world
    want = ref.ref_regimes(N, str(tmp))
    for got in ranks:
        for name, w in want.items():
            g = got["regimes"][name]
            assert g["events"] == w["events"] == 1
            assert g["delta"] == w["delta"], name
            fields = {k: ref.port_name(w["rec"][k]) for k in prog.FIELDS
                      if k in w["rec"]}
            assert {k: g["rec"][k] for k in fields} == fields, name
    force = ranks[0]["regimes"]["force"]
    # the quant arm's wire bytes: in the event and in spc, and below the
    # native ring's
    assert force["rec"]["arm"] == "quant"
    assert force["delta"]["coll_wire_bytes"] == force["rec"]["wire_bytes"]
    assert force["rec"]["wire_bytes"] < force["rec"]["nbytes"] * 2 * (N - 1)
    floor = ranks[0]["regimes"]["floor"]["rec"]
    assert floor["reason"] in floor["chain"]


def test_disabled_path_leaves_nothing_and_vars_toggle(world):
    _tmp, ranks = world
    for got in ranks:
        assert got["disabled"] == {"events": 0, "ops": 0, "asked": 0,
                                   "cells": 0, "steps": 0, "explain": None}
        assert got["toggle"] == {p: [True, False]
                                 for p in ("trace", "perf", "traffic")}


def test_live_straggler_gather_and_merged_lanes(world):
    tmp, ranks = world
    root = ranks[0]
    assert root["flagged"] == [2]
    assert root["ranks"] == [0, 1, 2, 3]
    # one decision per allreduce per process, each under its own rank
    assert root["decisions_per_rank"] == {str(r): 20 for r in range(N)}
    for got in ranks:
        assert got["offsets"] == root["offsets"] and got["offsets"][0] == 0
    with open(tmp / "merged.json") as fh:
        doc = json.load(fh)
    assert _lane_overlaps(doc) == 0
    rows = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in rows] == sorted(e["ts"] for e in rows)
    # the per-rank dumps load back into the reference's loader too
    paths = [str(tmp / f"trace_{r}.json") for r in range(N)]
    assert t_merge.load_chrome(paths) == j_merge.load_chrome(paths)
