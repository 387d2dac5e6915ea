"""What the gloo workers of the port's reshard, serving and decode tests run.

``_torch_coll_worker.Pool`` runs these by ``"_torch_serve_worker:<name>"``
in every process of its world (the tp 1 serving tests call them in the
test process, in a world of one); each function builds (once) the named
mesh over that world and works on this process's shard.  Like the pool's
own module it imports torch, numpy and the port only, never JAX: inputs
arrive as numpy arrays and results leave as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch import spc as spc_mod
from ompi_tpu_torch.core import var
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel.collectives import DeviceComm
from ompi_tpu_torch.parallel.mesh import axis_rank, make_mesh
from ompi_tpu_torch.parallel.reshard import Resharder
from ompi_tpu_torch.serving.engine import ServingEngine

_MESHES = {}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(axes):
    """One mesh per axes dict in each worker: its groups are made once."""
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes))
    return _MESHES[key]


def block(x: np.ndarray, sizes: dict, coords: dict, spec) -> np.ndarray:
    """The block of x a rank at ``coords`` holds under ``spec`` (one axis
    name, a tuple of them, or None per dim): ceiling-sized blocks over the
    axes' row-major product, the last short or empty, as a NamedSharding
    lays out a dim its axes do not divide."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n, pos = 1, 0
        for a in (tuple(axis) if isinstance(axis, (tuple, list))
                  else (axis,)):
            n, pos = n * sizes[a], pos * sizes[a] + coords[a]
        extent = x.shape[d]
        c = -(-extent // n)
        start = min(pos * c, extent)
        idx = [slice(None)] * x.ndim
        idx[d] = slice(start, start + min(c, extent - start))
        x = x[tuple(idx)]
    return np.ascontiguousarray(x)


def _coords(mesh) -> dict:
    return {a: axis_rank(mesh, a) for a in mesh.mesh_dim_names}


def reshard_cases(dc, axes, host, cases, dtype="float32",
                  peak_factor=None):
    """Each (src, dst) of ``cases`` on this rank's block of ``host``: the
    result block, the plan's steps and wire bytes, and what the audit
    counted.  ``peak_factor`` plans on a fresh Resharder under that
    bound."""
    mesh = _mesh(axes)
    coords = _coords(mesh)
    sizes = dict(axes)
    if peak_factor is not None:
        var.registry.set_override("reshard_peak_factor", peak_factor)
    try:
        rs = Resharder(mesh, spc=spc_mod.Counters())
        out = []
        for src, dst in cases:
            x = torch.from_numpy(block(host, sizes, coords, src)).to(
                _DTYPES[dtype])
            arms = rs.spc.get("coll_arm_native_count")
            wire = rs.spc.get("coll_wire_bytes")
            y = rs.run(x, src, dst, global_shape=host.shape)
            plan = rs.plan(host.shape, x.dtype, src, dst)
            out.append({"coords": coords, "out": y.float().numpy(),
                        "fresh": y.data_ptr() != x.data_ptr(),
                        "steps": plan.describe(),
                        "plan_wire": plan.wire_bytes,
                        "arms": rs.spc.get("coll_arm_native_count") - arms,
                        "wire": rs.spc.get("coll_wire_bytes") - wire})
        out.append(rs.cache_info())
        return out
    finally:
        if peak_factor is not None:
            var.registry.set_override("reshard_peak_factor", 2.0)


def reshard_tuple_refused(dc, axes, host):
    """A dim laid out over a tuple of axes that does not divide over their
    product: the refusal's message."""
    mesh = _mesh(axes)
    rs = Resharder(mesh)
    sizes, coords = dict(axes), _coords(mesh)
    src = (tuple(axes), None)
    try:
        rs.run(torch.from_numpy(block(host, sizes, coords, src)), src,
               (None, None), global_shape=host.shape)
    except ValueError as e:
        return str(e)
    return None


def _leaves(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return {k: v.detach().float().numpy() for k, v in out.items()}


def _config(cfg_kw):
    kw = dict(cfg_kw)
    kw["dtype"] = _DTYPES[kw.get("dtype", "float32")]
    return tfm.Config(**kw)


def convert(dc, axes, cfg_kw, tree):
    """The train shards of ``tree``, their decode layout by
    ``convert_params`` and back: this rank's leaves of each."""
    mesh = _mesh(axes)
    cfg = _config(cfg_kw)
    train = tfm.shard_params(tfm.params_from_numpy(tree, device="cpu"),
                             mesh, cfg)
    dec = tfm.convert_params(train, mesh, cfg, to="decode")
    back = tfm.convert_params(dec, mesh, cfg, to="train")
    return {"train": _leaves(train), "decode": _leaves(dec),
            "back": _leaves(back)}


def _engine(axes, cfg_kw, tree, engine_kw=None):
    """An engine from this rank's train shards of ``tree`` on a fresh comm
    with its own spc table."""
    mesh = _mesh(axes)
    cfg = _config(cfg_kw)
    comm = DeviceComm(mesh, "tp")
    comm.spc = spc_mod.Counters()
    train = tfm.shard_params(tfm.params_from_numpy(tree, device="cpu"),
                             mesh, cfg)
    kw = dict(n_pages=64, page_size=8, max_seqs=4)
    kw.update(engine_kw or {})
    return ServingEngine(comm, train, cfg, **kw)


def engine_greedy(dc, axes, cfg_kw, tree, prompts, steps, teacher=None,
                  force=None, engine_kw=None):
    """Per prompt: prefill + ``steps`` single-slot greedy decode steps
    (``tests/test_serving.py``'s ``_greedy_decode``; with ``teacher`` the
    fed-back tokens come from it), on an engine built from this rank's
    train shards.  ``force`` sets the decode arms' force variables (and
    the quant block) for the run.  Returns the tokens, the prefill's and
    each step's logits, and the audit counts."""
    eng = _engine(axes, cfg_kw, tree, engine_kw)
    comm = eng.dc
    for name, value in (force or {}).items():
        var.registry.set_override(name, value)
    try:
        runs = []
        for i, prompt in enumerate(prompts):
            runs.append(_greedy_decode(
                eng, np.asarray(prompt), steps,
                None if teacher is None else teacher[i]))
    finally:
        for name in (force or {}):
            var.registry.set_override(
                name, var.registry.lookup(name).default)
    return {"runs": runs, "dispatches": dict(eng.dispatches),
            "wire_bytes": eng.wire_bytes,
            "spc_wire": comm.spc.get("coll_wire_bytes"),
            "arms": {a: comm.spc.get(f"coll_arm_{a}_count")
                     for a in ("native", "quant", "staged")},
            "pages_used": eng.cache.pages_used}


def _greedy_decode(eng, prompt, steps, teacher=None):
    slot = eng.cache.admit(len(prompt), steps + 1)
    first, lg0 = eng.prefill(slot, prompt)
    toks = [first]
    logits = [lg0[0, 0].numpy()]
    last = first if teacher is None else teacher[0]
    for i in range(steps):
        t = np.zeros(eng.max_seqs, np.int32)
        p = np.full(eng.max_seqs, -1, np.int64)
        t[slot] = last
        p[slot] = int(eng.cache.seq_lens[slot])
        nxt, lg = eng.decode_step(t, p)
        eng.cache.seq_lens[slot] += 1
        toks.append(int(nxt[slot]))
        logits.append(lg[0, slot].numpy())
        last = int(nxt[slot]) if teacher is None else teacher[i + 1]
    eng.cache.release(slot)
    return {"tokens": toks, "logits": np.stack(logits)}


# -- the fused decode program and speculative decoding ------------------------

def step_audit(dc, axes, cfg_kw, tree, prompt, steps):
    """Per decode step after one prefill: the engine's dispatch counts,
    wire bytes and the spc's native arm count and wire bytes, each as the
    step's delta."""
    eng = _engine(axes, cfg_kw, tree)
    spc = eng.dc.spc
    slot = eng.cache.admit(len(prompt), steps + 1)
    last, _ = eng.prefill(slot, np.asarray(prompt))
    out = []
    for _ in range(steps):
        before = (dict(eng.dispatches), eng.wire_bytes,
                  spc.get("coll_arm_native_count"),
                  spc.get("coll_wire_bytes"))
        t = np.zeros(eng.max_seqs, np.int32)
        p = np.full(eng.max_seqs, -1, np.int64)
        t[slot] = last
        p[slot] = int(eng.cache.seq_lens[slot])
        nxt, _ = eng.decode_step(t, p)
        eng.cache.seq_lens[slot] += 1
        last = int(nxt[slot])
        out.append({"dispatches": {k: v - before[0][k]
                                   for k, v in eng.dispatches.items()},
                    "wire_bytes": eng.wire_bytes - before[1],
                    "spc_native": spc.get("coll_arm_native_count")
                    - before[2],
                    "spc_wire": spc.get("coll_wire_bytes") - before[3]})
    eng.cache.release(slot)
    return out


def window(dc, axes, cfg_kw, tree, prompts, windows):
    """Prefill ``prompts`` into slots, then one ``decode_window`` per
    (max_seqs, k) token table of ``windows``: each live slot's row at its
    next positions; after each window the slot keeps its first two rows
    (one accepted draft).  Returns, per window, the next tokens and the
    logits rows of the live slots."""
    eng = _engine(axes, cfg_kw, tree)
    cache = eng.cache
    slots = []
    for prompt in prompts:
        slot = cache.admit(len(prompt), 16)
        eng.prefill(slot, np.asarray(prompt))
        slots.append(slot)
    out = []
    for table in windows:
        table = np.asarray(table)
        k = table.shape[1]
        positions = np.full(table.shape, -1, np.int64)
        for s in slots:
            positions[s] = cache.seq_lens[s] + np.arange(k)
        nxt, lg = eng.decode_window(table, positions)
        rows = np.concatenate([np.arange(s * k, (s + 1) * k) for s in slots])
        out.append({"next": nxt[slots], "logits": lg[0, rows].numpy()})
        for s in slots:
            cache.seq_lens[s] += 2
    return out


class _StepClock:
    """A host clock that moves ``step`` seconds a reading: every duration
    the scheduler measures is then ``step``, so its virtual clock, and
    with it how arrivals interleave with steps, is the same in every run
    (measured durations differ from run to run and from rank to rank)."""

    def __init__(self, step: float) -> None:
        self.step, self.now = float(step), 0.0

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


def spec_streams(dc, axes, cfg_kw, tree, requests, ks, clock=None,
                 engine_kw=None):
    """The scheduler at spec_k 0 and each of ``ks`` on one engine:
    streams, decode steps, the serve plane's speculative ledger and the
    pages left held.  ``requests`` is ``(n, seed)`` for ``poisson_stream(n,
    50 qps, seed)`` or a list of ``(prompt, max_new)`` arrived at 0.  With
    ``clock`` the scheduler reads a ``_StepClock`` of ``clock·(1 + tp
    position)`` seconds a reading (the ranks' clocks then run apart, and
    only their agreement keeps the ranks' admissions in step)."""
    from ompi_tpu_torch import serving
    from ompi_tpu_torch.serving import scheduler as sched
    eng = _engine(axes, cfg_kw, tree, engine_kw)
    real_time = sched.time
    out = []
    for k in (0, *ks):
        if isinstance(requests, tuple):
            reqs = sched.poisson_stream(requests[0], qps=50.0,
                                        vocab=eng.cfg.vocab,
                                        seed=requests[1])
        else:
            reqs = [sched.Request(rid=i, prompt=np.asarray(p, np.int32),
                                  max_new=m)
                    for i, (p, m) in enumerate(requests)]
        serving.reset()
        serving.enable()
        if clock is not None:
            sched.time = _StepClock(clock * (1 + eng.dc.pos))
        try:
            res = sched.ContinuousBatchingScheduler(eng, reqs,
                                                    spec_k=k).run()
            rep = serving.report()
        finally:
            sched.time = real_time
            serving.disable()
        out.append({"spec_k": k, "decode_steps": res["decode_steps"],
                    "streams": {rid: r["tokens"]
                                for rid, r in res["results"].items()},
                    "speculative": rep["speculative"],
                    "dispatches": rep["dispatches"],
                    "pages_used": eng.cache.pages_used})
    return out


def fused_refusals(dc, axes, cfg_kw, tree):
    """The fused engine on a tp ≥ 2 mesh: its refusal of max_seqs not
    divisible by tp, and ``verify_decode_program``'s report (JSON)."""
    out = {}
    try:
        _engine(axes, cfg_kw, tree, {"max_seqs": 3})
    except ValueError as e:
        out["max_seqs"] = str(e)
    out["verify"] = _engine(axes, cfg_kw,
                            tree).verify_decode_program().to_json()
    return out


def fused_views(dc, axes, cfg_kw, tree):
    """This rank's weight views of the fused program: per layer wqkv, wgu
    (column shards), wo and wd (row shards), and the transposed embedding
    block, with the rank's tp position."""
    eng = _engine(axes, cfg_kw, tree)
    f = lambda t: t[0].float().numpy()
    return {"pos": eng.dc.pos, "embed_lg": f(eng._embed_lg),
            "layers": [{k: f(lw[k]) for k in ("wqkv", "wgu", "wo", "wd")}
                       for lw in eng._fused_layers]}


# -- the audit planes on the engine -------------------------------------------

def _event_rows(evs, prefix):
    return [{"name": e["name"], "ph": e["ph"], "rank": e["rank"],
             "args": dict(e["args"])}
            for e in evs if e["name"].startswith(prefix)]


def engine_audit(dc, axes, cfg_kw, tree, prompt, steps, force=None,
                 engine_kw=None):
    """``_greedy_decode`` with the trace, perf and traffic planes on,
    opened after the engine's construction (its ``convert_params``
    reshard is audited under coll ``reshard``): this process's decision
    events and ``serve:*`` spans, the dispatches, the wire the spc and the
    engine counted, the traffic edges and the perf cells."""
    from ompi_tpu_torch import perf, trace, traffic
    eng = _engine(axes, cfg_kw, tree, engine_kw)
    comm = eng.dc
    comm.spc = spc_mod.Counters()
    eng.wire_bytes = 0
    before = dict(eng.dispatches)
    for name, value in (force or {}).items():
        var.registry.set_override(name, value)
    trace.clear()
    trace.enable()
    traffic.reset()
    traffic.enable()
    perf.reset()
    perf.enable()
    try:
        run = _greedy_decode(eng, np.asarray(prompt), steps)
        evs = trace.events()
        return {"tokens": run["tokens"],
                "decisions": _event_rows(evs, "decide:"),
                "spans": _event_rows(evs, "serve:"),
                "dispatches": {k: v - before[k]
                               for k, v in eng.dispatches.items()},
                "wire_bytes": eng.wire_bytes,
                "spc_wire": comm.spc.get("coll_wire_bytes"),
                "attributed": comm.spc.get("traffic_attributed_bytes"),
                "unattributed": comm.spc.get("traffic_unattributed_bytes"),
                "edges": traffic.matrix.rows(),
                "perf_cells": sorted({(r["coll"], r["arm"], r["count"])
                                      for r in perf.model.table()}),
                "rank": torch.distributed.get_rank()}
    finally:
        for name in (force or {}):
            var.registry.set_override(
                name, var.registry.lookup(name).default)
        trace.disable()
        trace.clear()
        traffic.disable()
        traffic.reset()
        perf.disable()
        perf.reset()


def reshard_audit(dc, axes, host, cases):
    """Each (src, dst) of ``cases`` run on this rank's block of ``host``
    by one Resharder with the trace, perf and traffic planes on (the first
    case twice, so its plan is a cache hit): per run the decision events,
    the compile spans and cache-hit instants, the traffic edges, the wire
    the spc counted, the module counters' moves and ``report()["last"]``."""
    from ompi_tpu_torch import perf, trace, traffic
    from ompi_tpu_torch.parallel import reshard
    mesh = _mesh(axes)
    coords = _coords(mesh)
    rs = Resharder(mesh, spc=spc_mod.Counters())
    out = []
    try:
        for src, dst in [cases[0]] + list(cases):
            x = torch.from_numpy(block(host, dict(axes), coords, src))
            trace.clear()
            trace.enable()
            traffic.reset()
            traffic.enable()
            perf.reset()
            perf.enable()
            wire = rs.spc.get("coll_wire_bytes")
            counts = dict(reshard.report()["counters"])
            rs.run(x, src, dst, global_shape=host.shape)
            evs = trace.events()
            after = reshard.report()
            out.append({
                "decisions": [dict(e["args"]) for e in evs
                              if e["name"] == "decide:reshard"],
                "rank": torch.distributed.get_rank(),
                "marks": [e["name"] for e in evs
                          if e["name"].startswith(("reshard:",
                                                   "cache_hit:"))],
                "edges": traffic.matrix.rows(),
                "unattributed": traffic.matrix.unattributed_bytes,
                "wire": rs.spc.get("coll_wire_bytes") - wire,
                "counters": {k: v - counts[k]
                             for k, v in after["counters"].items()},
                "last": after["last"],
                "plan_log": after["plans"][-1],
                "perf_cells": sorted({(r["coll"], r["arm"])
                                      for r in perf.model.table()})})
    finally:
        trace.disable()
        trace.clear()
        traffic.disable()
        traffic.reset()
        perf.disable()
        perf.reset()
    return out
