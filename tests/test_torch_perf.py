"""The port's continuous performance plane (``ompi_tpu_torch.perf``)
against the JAX package's (``ompi_tpu.perf``).

* Pure functions on the same inputs, floats to 1e-12: ``busbw_GBps`` and
  ``size_bucket``; the cost model's convergence, bounded windows, ±widen
  bucket search, ``best_arm`` and its ``learned:`` reason, crossovers and
  JSON round trip; ``goodput.account`` on the reference's hand timeline,
  ``pipeline_bubble_s`` and the ledger's EWMA; the sentry's trips, once
  per episode, on the same sample streams; the ledger file's round trip
  under ``tmp_path`` both ways between the packages.
* The span sink: ``grad_sync:bucket`` spans fold, ``status=error`` ones
  and other names never do.
* ``timed_coll`` under ``tpurun -np 4 --device-plane cpu`` grows the
  cells the reference's dispatch wrapper grows on a 4-device mesh (flat
  and ``@ici`` plane-keyed), and the pvars reach spc.
* The goodput row: ``make_train_step(cfg, device="cpu")`` with the plane
  on gives one ledger row a step, whose tokens and FLOPs per token are the
  ones the reference's ``timed_step`` computes for the same config.
"""

import importlib
import os
import sys

import numpy as np
import pytest

from ompi_tpu import perf as j_perf
from ompi_tpu.perf import goodput as j_goodput
from ompi_tpu_torch import perf as t_perf
from ompi_tpu_torch import spc as t_spc
from ompi_tpu_torch import trace as t_trace
from ompi_tpu_torch.core import var as t_var
from ompi_tpu_torch.perf import goodput as t_goodput

# the package's ``model`` attribute is its CostModel; the modules:
j_model = importlib.import_module("ompi_tpu.perf.model")
t_model = importlib.import_module("ompi_tpu_torch.perf.model")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_audit_ref as ref  # noqa: E402

N = 4


@pytest.fixture(autouse=True)
def _clean():
    for mod in (j_perf, t_perf):
        mod.disable()
        mod.reset()
    yield
    for mod in (j_perf, t_perf):
        mod.disable()
        mod.reset()
    t_trace.disable()
    t_trace.clear()
    t_var.registry.reset_cache()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return ref.port(tmp_path_factory.mktemp("perf4"), N, ["perf"])


def close(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), (a, b)
        for k in a:
            close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
    else:
        assert a == b


# -- the cost model -----------------------------------------------------------

def test_busbw_and_size_bucket_equal_reference():
    rng = np.random.default_rng(0)
    colls = ("allreduce", "grad_sync", "reduce_scatter", "allgather",
             "allgatherv", "bcast", "alltoall", "allreduce@ici", "x@dcn")
    for _ in range(300):
        coll = colls[int(rng.integers(len(colls)))]
        nbytes = int(rng.integers(0, 1 << 30))
        dur = float(rng.choice([0.0, rng.uniform(1e-6, 1.0)]))
        ndev = int(rng.integers(1, 9))
        assert t_model.busbw_GBps(coll, nbytes, dur, ndev) == \
            j_model.busbw_GBps(coll, nbytes, dur, ndev)
        assert t_model.size_bucket(nbytes) == j_model.size_bucket(nbytes)


def _feed(m, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        m.record("allreduce", "native", 4096, 1e-5 * rng.uniform(0.9, 1.1), 8)
        m.record("allreduce", "staged", 4096, 1e-3 * rng.uniform(0.9, 1.1), 8)
        m.record("allgather", "quant", 1 << 20, 1e-4 * rng.uniform(0.5, 2), 4)
        m.record("bcast", "native", 0, 1e-4, 4)        # no signal: dropped


def test_cost_model_equals_reference():
    jm = j_model.CostModel(window=16, alpha=0.5)
    tm = t_model.CostModel(window=16, alpha=0.5)
    _feed(jm)
    _feed(tm)
    close(tm.table(), jm.table())
    close(tm.to_json(), jm.to_json())
    assert tm.crossovers() == jm.crossovers()
    assert tm.bucket_count() == jm.bucket_count() == 3
    assert all(len(c.bw) <= 16 for c in tm._cells.values())
    for nbytes in (4096, 1 << 14, 1 << 15, 1 << 10):
        for allowed in (("native", "staged"), ("staged",), ("quant",)):
            close(tm.best_arm("allreduce", nbytes, allowed),
                  jm.best_arm("allreduce", nbytes, allowed))
    assert tm.best_arm("allreduce", 1 << 14,
                       ("native", "staged"))[0] == "native"
    assert tm.best_arm("allreduce", 1 << 15, ("native", "staged")) is None
    close(tm.stats("allreduce", "native", 4096),
          jm.stats("allreduce", "native", 4096))
    fresh = t_model.CostModel(window=16)
    assert fresh.load_json(jm.to_json()) == 3
    close(fresh.table(), tm.table())


def test_best_arm_reason_equals_reference():
    for mod in (j_perf, t_perf):
        for _ in range(3):
            mod.model.record("allreduce", "staged", 4096, 1e-5, 8)
            mod.model.record("allreduce", "native", 4096, 1e-3, 8)
        mod.model.record("bcast", "native", 4096, 1e-5, 8)
    for coll, allowed in (("allreduce", ("native", "staged")),
                          ("bcast", ("native", "staged")),
                          ("alltoall", ("native",))):
        assert t_perf.best_arm(coll, 4096, allowed) == j_perf.best_arm(
            coll, 4096, allowed)
    arm, reason = t_perf.best_arm("allreduce", 4096, ("native", "staged"))
    assert arm == "staged" and reason.startswith("learned:staged=")


# -- goodput --------------------------------------------------------------------

def test_goodput_account_equals_reference():
    cases = [dict(wall_s=1.0, comm_total_s=0.4, comm_exposed_s=0.1,
                  host_s=0.1, tokens=1000, flops_per_token=2e9,
                  peak_tflops=10.0),
             dict(wall_s=1.0), dict(wall_s=0.0, tokens=5),
             dict(wall_s=2.5, comm_exposed_s=0.0, tokens=8192,
                  flops_per_token=3.3e9, peak_tflops=989.0)]
    for kw in cases:
        close(t_goodput.account(**kw), j_goodput.account(**kw))
    row = t_goodput.account(**cases[0])
    assert row["goodput_pct"] == pytest.approx(80.0)
    assert row["overlap_efficiency"] == pytest.approx(0.75)
    assert row["mfu_pct"] == pytest.approx(20.0)
    for args in ((4, 12, 1.5), (1, 8, 1.0), (3, 0, 1.0), (2, 2, 0.0)):
        assert t_goodput.pipeline_bubble_s(*args) == \
            j_goodput.pipeline_bubble_s(*args)


def test_goodput_ledger_ewma_equals_reference():
    rng = np.random.default_rng(3)
    for _ in range(30):
        kw = dict(comm_total_s=float(rng.uniform(0.1, 0.5)),
                  comm_exposed_s=float(rng.uniform(0, 0.1)),
                  tokens=int(rng.integers(1, 5000)), flops_per_token=2e9,
                  peak_tflops=10.0)
        wall = float(rng.uniform(0.5, 1.5))
        if rng.random() < 0.3:
            kw = {k: kw[k] for k in ("tokens", "flops_per_token",
                                     "peak_tflops")}
        close(t_perf.record_step(wall, **kw), j_perf.record_step(wall, **kw))
    close(t_perf.ledger.snapshot(), j_perf.ledger.snapshot())
    close(t_perf.ledger.to_json(), j_perf.ledger.to_json())


# -- the sentry ------------------------------------------------------------------

def _slow(bw, nbytes=1 << 20, ndev=N):
    return 2 * (ndev - 1) / ndev * nbytes / (bw * 1e9)


def test_sentry_trips_equal_reference():
    t_trace.enable()
    t_trace.clear()
    base = {"allreduce|native|20": {"bw_GBps": [10.0] * 8},
            "bcast|native|20": {"bw_GBps": [1.0] * 2}}
    stream = ([10.0] * 5 + [1.0] * 4 + [10.0] + [1.0] * 3)
    for mod in (j_perf, t_perf):
        assert mod.sentry.load_baseline(base, [90.0] * 8) == 3
        for bw in stream:
            mod.sentry.observe_coll("allreduce", "native", 1 << 20,
                                    _slow(bw), N)
        for g in (30.0, 30.0, 30.0, 95.0):
            mod.sentry.observe_goodput(g)
        assert mod.sentry.observe_coll("bcast", "native", 1 << 20,
                                       _slow(0.01), N) is None
    assert t_perf.sentry.trips() == j_perf.sentry.trips() == 3
    close(t_perf.sentry.verdicts(), j_perf.sentry.verdicts())
    evs = [e for e in t_trace.events() if e["name"] == "perf_regression"]
    assert len(evs) == 3
    assert t_spc.Counters().get("perf_regressions") == 3.0


# -- the ledger file ----------------------------------------------------------------

def test_ledger_round_trip_between_packages(tmp_path):
    for mod in (j_perf, t_perf):
        for _ in range(6):
            mod.model.record("allreduce", "native", 1 << 20, 1e-4, N)
            mod.model.record("allreduce", "staged", 1 << 20, 1e-2, N)
            mod.record_step(1.0, comm_total_s=0.4, comm_exposed_s=0.1,
                            tokens=1000, flops_per_token=2e9,
                            peak_tflops=10.0)
    tp = str(tmp_path / "PERF_LEDGER_port.json")
    jp = str(tmp_path / "PERF_LEDGER_ref.json")
    close(t_perf.save_ledger(tp, platform="cuda"),
          j_perf.save_ledger(jp, platform="cuda"))
    for mod in (j_perf, t_perf):
        mod.reset()
    got_t = t_perf.load_ledger(jp)          # each loads the other's file
    got_j = j_perf.load_ledger(tp)
    assert got_t == got_j == {"cells": 2, "baseline_keys": 3}
    close(t_perf.report(), j_perf.report())
    assert t_perf.pvar_value("perf_ledger_buckets") == 2.0
    # enable() autoloads the var-configured ledger path
    t_perf.reset()
    t_var.registry.set_cli("perf_ledger", tp)
    t_var.registry.reset_cache()
    try:
        t_perf.enable()
        assert t_perf.enabled and t_perf.model.bucket_count() == 2
    finally:
        t_var.registry.clear_cli("perf_ledger")
    assert t_perf.default_ledger_path("cuda", root="/x") == \
        j_perf.default_ledger_path("cuda", root="/x") == \
        "/x/PERF_LEDGER_cuda.json"


# -- sources: the span sink and the dispatch wrapper ---------------------------

def test_span_sink_ingests_only_clean_bucket_spans():
    t_trace.enable()
    t_perf.enable()
    args = {"arm": "native", "nbytes": 1 << 20, "ndev": 4}
    t_trace.record_span("grad_sync:bucket", "overlap-buckets", 0.0, 1e-3,
                        args=args)
    t_trace.record_span("grad_sync:bucket", "overlap-buckets", 0.0, 1e-3,
                        args=dict(args, status="error"))
    t_trace.record_span("quant:allreduce", "quant", 0.0, 1e-3, args=args)
    t_trace.record_span("grad_sync:bucket", "overlap-buckets", 0.0, 1e-3,
                        args=dict(args, ndev=1))
    rows = t_perf.model.table()
    assert [(r["coll"], r["count"]) for r in rows] == [("grad_sync", 1)]
    t_perf.disable()
    t_trace.record_span("grad_sync:bucket", "overlap-buckets", 0.0, 1e-3,
                        args=args)
    assert t_perf.model.table()[0]["count"] == 1


def test_gate_is_a_plain_bool_and_var_watched():
    assert type(vars(t_perf)["enabled"]) is bool
    assert not hasattr(t_perf, "__getattr__")
    t_var.registry.set_override("perf_enabled", True)
    assert t_perf.enabled is True
    t_var.registry.reset_cache()
    assert t_perf.enabled is False


def test_timed_coll_grows_the_reference_cells(world):
    want = ref.ref_perf_keys(N)
    assert any(c.endswith("@ici") for c, *_ in want)
    for got in world:
        keys = [(r["coll"], r["arm"], r["bucket_bytes"], r["count"])
                for r in got["perf_table"]]
        assert keys == want
        assert got["perf_pvars"]["perf_ledger_buckets"] == len(want)
        assert all(r["lat_us_p50"] > 0 for r in got["perf_table"])


# -- the goodput row of the train step ---------------------------------------------

def test_train_step_goodput_row_matches_reference(monkeypatch):
    import jax
    import jax.numpy as jnp
    import torch

    from ompi_tpu.models import transformer as j_tfm
    from ompi_tpu_torch.models import transformer as t_tfm

    kw = dict(vocab=32, d_model=16, n_layers=1, n_heads=2, head_dim=8,
              d_ff=32, seq=16)
    jcfg = j_tfm.Config(dtype=jnp.float32, **kw)
    tcfg = t_tfm.Config(dtype=torch.float32, **kw)
    tokens = np.random.default_rng(0).integers(0, 32, (2, 17))

    rows = {}
    for name, mod in (("ref", j_perf), ("port", t_perf)):
        real = mod.record_step

        def spy(wall_s, _real=real, _name=name, **k):
            rows.setdefault(_name, []).append(dict(k, wall_s=wall_s))
            return _real(wall_s, **k)

        monkeypatch.setattr(mod, "record_step", spy)
        mod.enable()
    t_var.registry.set_override("perf_peak_tflops", 989.0)
    from ompi_tpu.core import var as j_var
    j_var.registry.set_override("perf_peak_tflops", 989.0)

    init, step = j_tfm.make_train_step(jcfg)
    jp = j_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    st = init(jp)
    jp, st, _ = step(jp, st, jnp.asarray(tokens))

    init, step = t_tfm.make_train_step(tcfg, device="cpu")
    tp = t_tfm.init_params(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    st = init(tp)
    for _ in range(3):
        step(tp, st, torch.as_tensor(tokens))
    assert len(rows["port"]) == 3 and t_perf.ledger.steps == 3
    for got in rows["port"]:
        for k in ("tokens", "flops_per_token", "peak_tflops"):
            assert got[k] == rows["ref"][0][k], k
        assert got["wall_s"] > 0
    assert rows["port"][0]["tokens"] == 2 * 16
    assert t_perf.ledger.snapshot()["samples"]["wall_s"] == 3
    t_perf.disable()
    step(tp, st, torch.as_tensor(tokens))
    assert t_perf.ledger.steps == 3            # off: nothing recorded
