"""Both sides of the audit-plane parity tests (``test_torch_trace``,
``test_torch_perf``, ``test_torch_traffic``).

``port(tmp, np_, phases, r_per)`` runs ``_torch_audit_prog`` under the
port's ``tpurun -np np_ --device-plane cpu`` and returns every rank's
record; the ``ref_*`` functions run the same inputs through the JAX
package's single controller on an ``N``-device CPU mesh (its
``runtime.run_ranks(1, ...)``, the 8 virtual devices of
``tests/conftest.py``), with the planes the same phase turns on.
"""

import json
import os
import subprocess
import sys

import numpy as np

import _torch_audit_prog as prog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROG = os.path.join(REPO, "tests", "_torch_audit_prog.py")


def port(tmp, np_: int, phases, r_per: int = 1) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np",
         str(np_), "--timeout", "150", "--device-plane", "cpu", PROG,
         str(tmp), ",".join(phases), str(r_per)],
        env=env, capture_output=True, text=True, timeout=180, cwd=str(tmp))
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    out = []
    for rank in range(np_):
        with open(os.path.join(tmp, f"rank{rank}.json")) as fh:
            out.append(json.load(fh))
    return out


def port_name(text):
    """The port's spelling of a reference decision string: the
    ``coll_xla`` variables are ``coll_nccl`` ones."""
    if isinstance(text, str):
        return text.replace("coll_xla", "coll_nccl")
    if isinstance(text, list):
        return [port_name(t) for t in text]
    return text


def _mesh(N):
    import jax

    from ompi_tpu.parallel import make_mesh
    return make_mesh({"x": N}, devices=jax.devices()[:N])


def _with_cli(settings: dict, fn):
    from ompi_tpu import runtime
    from ompi_tpu.core import var
    for k, v in settings.items():
        var.registry.set_cli(k, v)
    var.registry.reset_cache()
    try:
        return runtime.run_ranks(1, fn, timeout=240)[0]
    finally:
        for k in settings:
            var.registry.clear_cli(k)
        var.registry.reset_cache()


def _reset():
    from ompi_tpu import perf, trace, traffic
    from ompi_tpu.traffic import planes
    trace.disable()
    trace.clear()
    traffic.disable()
    traffic.reset()
    perf.disable()
    perf.reset()
    planes._PROC_CACHE.clear()


def _decisions(trace):
    return [prog.jsonable({k: e["args"].get(k) for k in prog.FIELDS
                           if k in e["args"]})
            for e in trace.events() if e["cat"] == "decision"]


def matrix_view(traffic) -> dict:
    return prog.jsonable(prog.matrix_view(traffic))


def ref_decisions(N: int, r_per: int = 1) -> dict:
    from ompi_tpu import trace
    from ompi_tpu.parallel import attach_mesh

    _reset()
    trace.enable()

    def fn(ctx):
        c = ctx.comm_world
        attach_mesh(c, _mesh(N), "x")
        data = prog.entry_data(N * r_per)
        prog.run_entries(c, lambda k: c.device_comm.from_local(data[k]),
                         N * r_per)
        return {k: ctx.spc.get(k) for k in (
            "coll_arm_native_count", "coll_arm_staged_count",
            "coll_arm_quant_count")}

    try:
        arms = _with_cli({}, fn)
        return {"decisions": _decisions(trace), "arms": arms}
    finally:
        _reset()


def ref_regimes(N: int, tmp) -> dict:
    from ompi_tpu import trace
    from ompi_tpu.parallel import attach_mesh

    out = {}
    for name, settings, rules, seed in prog.REGIMES:
        cli = {("COLL_QUANT" if k == "COLL_QUANT" else f"coll_xla_{k}"): v
               for k, v in settings.items()}
        if rules is not None:
            path = os.path.join(tmp, f"ref_rules_{name}")
            with open(path, "w") as fh:
                fh.write(rules)
            cli["coll_xla_dynamic_rules"] = path
        _reset()
        trace.enable()

        def fn(ctx, seed=seed):
            c = ctx.comm_world
            attach_mesh(c, _mesh(N), "x")
            before = dict(ctx.spc.snapshot())
            c.coll.allreduce(c, c.device_comm.from_local(
                prog.regime_rows(N, seed)))
            after = ctx.spc.snapshot()
            return {k: after.get(k, 0) - before.get(k, 0) for k in (
                "coll_wire_bytes", "coll_arm_native_count",
                "coll_arm_staged_count", "coll_arm_quant_count",
                "coll_staged_fallbacks")}

        try:
            delta = _with_cli(cli, fn)
            out[name] = {"rec": prog.jsonable(trace.explain_last(
                "allreduce")), "events": len(_decisions(trace)),
                "delta": delta}
        finally:
            _reset()
    return out


def ref_conservation(N: int, r_per: int = 1) -> dict:
    """allreduce, allgather, alltoall (native forced) and one push_row on
    an N-device mesh holding N·r_per rows, then the staged alltoall of the
    CPU default alone."""
    from ompi_tpu import traffic
    from ompi_tpu.parallel import attach_mesh

    R = N * r_per
    _reset()
    traffic.enable()
    data = prog.conservation_rows(R)

    def fn(ctx):
        c = ctx.comm_world
        attach_mesh(c, _mesh(N), "x")
        d = c.device_comm
        before = dict(ctx.spc.snapshot())
        x = d.from_local(data["x"])
        c.coll.allreduce(c, x)
        c.coll.allgather(c, x)
        c.coll.alltoall(c, d.from_local(data["xa"]))
        if r_per == 1:
            d.push_row(x, 1, R - 1)
        else:
            d.push_row(x, 2, 5)
            d.ring_shift(x, 3)
        snap = ctx.spc.snapshot()
        return {k: snap[k] - before.get(k, 0) for k in (
            "coll_wire_bytes", "traffic_attributed_bytes",
            "traffic_unattributed_bytes")} | {
            "traffic_edge_count": snap["traffic_edge_count"]}

    try:
        got = {"spc": _with_cli({"coll_xla_mode": "native"}, fn),
               "matrix": matrix_view(traffic)}
        traffic.reset()

        def staged(ctx):
            c = ctx.comm_world
            attach_mesh(c, _mesh(N), "x")
            c.coll.alltoall(c, c.device_comm.from_local(data["xa"]))
            return True

        _with_cli({}, staged)
        got["staged"] = matrix_view(traffic)
        return got
    finally:
        _reset()


def ref_geometry(N: int) -> dict:
    """The eager wrappers' charges, each from a reset matrix, at the
    shapes ``_torch_audit_prog.geometry`` gives the port (global here)."""
    import jax
    import jax.numpy as jnp

    from ompi_tpu import traffic
    from ompi_tpu.ops.collective_matmul import (allgather_matmul,
                                               matmul_reduce_scatter)
    from ompi_tpu.parallel import make_mesh
    from ompi_tpu.parallel.hierarchy import hierarchical_allreduce
    from ompi_tpu.parallel.overlap import make_grad_sync
    from ompi_tpu.parallel.ring import ring_attention

    devs = jax.devices()[:N]
    _reset()
    traffic.enable()
    out = {}
    try:
        mesh = make_mesh({"x": N}, devices=devs)
        x = jnp.ones((16, 8), jnp.float32)
        w = jnp.ones((8, 4), jnp.float32)
        for name, kw in (("fwd", {}), ("rev", {"reverse": True}),
                         ("bidir", {"bidirectional": True})):
            traffic.reset()
            allgather_matmul(x, w, mesh, "x", **kw)
            out[f"collmm_{name}"] = prog.jsonable(traffic.matrix.to_json())
        traffic.reset()
        matmul_reduce_scatter(x, w, mesh, "x")
        out["collmm_rs"] = prog.jsonable(traffic.matrix.to_json())
        sp = make_mesh({"sp": N}, devices=devs)
        q = jnp.ones((1, 16, 2, 4), jnp.float32)
        traffic.reset()
        ring_attention(q, q, q, sp, axis="sp")
        out["ring_attention"] = prog.jsonable(traffic.matrix.to_json())
        two = make_mesh({"dp": 2, "tp": N // 2}, devices=devs)
        traffic.reset()
        hierarchical_allreduce(jnp.ones((2, N // 2, 64), jnp.float32), two,
                               inner="tp", outer="dp")
        out["hier"] = prog.jsonable(traffic.report())
        dp = make_mesh({"dp": N}, devices=devs)
        params = {"w": jnp.ones((N, 4), jnp.float32)}

        def local_loss(p, t):
            return jnp.sum(p["w"]) * jnp.mean(t)

        batch = jnp.ones((N, 2), jnp.float32)
        for mode in ("perleaf", "unsynced"):
            traffic.reset()
            make_grad_sync(mode, dp, local_loss)(params, batch)
            out[f"grad_sync_{mode}"] = prog.jsonable(
                traffic.matrix.to_json())
        return out
    finally:
        _reset()


def ref_perf_keys(N: int) -> list:
    """The cost-model cells the perf phase's dispatches grow (perf and
    traffic on, as the port's phase has them)."""
    import jax.numpy as jnp

    from ompi_tpu import perf, traffic
    from ompi_tpu.parallel import attach_mesh

    _reset()
    perf.enable()
    traffic.enable()

    def fn(ctx):
        c = ctx.comm_world
        attach_mesh(c, _mesh(N), "x")
        for size in (256, 4096, 65536):
            for _ in range(3):
                xs = c.device_comm.from_local(
                    np.asarray(jnp.ones((N, size), jnp.float32)))
                c.coll.allreduce(c, xs)
                c.coll.allgather(c, xs)
            c.coll.barrier(c)
        return True

    try:
        _with_cli({}, fn)
        return [(r["coll"], r["arm"], r["bucket_bytes"], r["count"])
                for r in perf.model.table()]
    finally:
        _reset()
