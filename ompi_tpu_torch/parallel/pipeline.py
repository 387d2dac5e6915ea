"""Pipeline parallelism — a GPipe schedule over a mesh axis.

Counterpart of ``ompi_tpu/parallel/pipeline.py`` (≙ what PP users build on
the reference's p2p sends, pml_ob1_isend.c:249 — SURVEY.md §2.6).  Each
member of the ``pp`` axis is one stage and holds that stage's layers
(``shard_stage_params``).  M microbatches drain through P stages in
M + P − 1 ticks: at tick t stage 0 takes microbatch t (zeros once none
remain), every stage runs ``stage_fn`` on what it holds, and each stage's
output moves one stage forward over the pp group (``collectives.ring_hop``:
one ``batch_isend_irecv`` inside a ``torch.autograd.Function`` whose
backward moves the cotangent one stage back; the last tick's shift, which
no stage reads, is not sent).  The microbatch leaving the
last stage at tick t is t − (P − 1).  The last stage's outputs are then
broadcast over pp, as the reference's psum of a one-hot does
(``collectives.reduce_from``: every member gets them; backward, each
member's cotangent stays its own, so the last stage's flows back through
the schedule).

``checkpoint=True`` runs ``stage_fn`` under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``: a stage keeps its inputs, not its
activations, and recomputes them in the backward.

With tracing on, ``_traced_run`` records the reference's spans on this
process's world rank: one measured ``pipeline:run`` span a run (on the
card bounded by a synchronize, taken under ``trace.enabled`` only;
``status="error"`` when the run raises) and M + P − 1 ``pipeline:tick``
spans, an even subdivision of the run marked ``synthetic`` (the host
sees no tick boundary inside the run either).  The reference's ``cache``
arg (hit or miss of its compiled schedule) has no counterpart: the port
compiles nothing (ROADMAP, Departures).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint as _checkpoint

from .. import trace
from .collectives import reduce_from, ring_hop
from .mesh import axis_rank, axis_size


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_zip(fn: Callable, trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_zip(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_zip(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(trees)


def stack_stage_params(layer_params: list, n_stages: int):
    """[L per-layer trees] → one tree whose leaves have leading (P, L/P)
    dims: stage p holds layers [p·L/P, (p+1)·L/P)."""
    n = len(layer_params)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    per = n // n_stages
    return _tree_zip(lambda xs: torch.stack(xs).reshape(
        (n_stages, per) + tuple(xs[0].shape)), list(layer_params))


def shard_stage_params(stacked, mesh, axis: str = "pp"):
    """This member's stage of a ``stack_stage_params`` tree: every leaf's
    (L/P, ...) slice at its position on ``axis``, as a tensor of its own
    (the reference places the stages dimension on the axis and each
    device reads its slice)."""
    n, stage = axis_size(mesh, axis), axis_rank(mesh, axis)

    def mine(x):
        if x.shape[0] != n:
            raise ValueError(f"a stacked leaf has {x.shape[0]} stages, the "
                             f"{axis!r} axis {n}")
        return x[stage].clone()
    return _tree_map(mine, stacked)


class _Tie(torch.autograd.Function):
    """``value``, with ``dep`` tied in so that autograd sends it a zero
    cotangent.  Each member differentiates only what its own loss reaches,
    and the shifts' backward is point-to-point: every member must run
    every shift's backward.  So stage 0 ties in the shifted state it
    ignores, and every stage but the last, whose outputs are all zeros in
    the broadcast, ties its last tick's output into them; its gradients
    then arrive through the shifts' backward from the stages after it."""

    @staticmethod
    def forward(ctx, value, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _traced_run(run: Callable, stage_params, microbatches, n_stages: int,
                m_count: int, axis: str):
    """Run the schedule; when tracing is on, record one measured
    ``pipeline:run`` span (a synchronize on the card bounds it) plus
    M + P − 1 synthetic ``pipeline:tick`` spans, each annotating what its
    tick's shift sends and which microbatch stage 0 ingests and the last
    stage emits."""
    if not trace.enabled:
        return run(stage_params, microbatches)
    rank = dist.get_rank()
    cuda = microbatches.device.type == "cuda"
    t0 = time.perf_counter()
    try:
        out = run(stage_params, microbatches)
        if cuda:
            torch.cuda.synchronize(microbatches.device)
    except BaseException:
        trace.record_span("pipeline:run", "pipeline", t0,
                          time.perf_counter(), rank=rank,
                          args={"stages": n_stages,
                                "microbatches": m_count,
                                "axis": axis, "status": "error"})
        raise
    t1 = time.perf_counter()
    ticks = m_count + n_stages - 1
    trace.record_span("pipeline:run", "pipeline", t0, t1, rank=rank,
                      args={"stages": n_stages, "microbatches": m_count,
                            "ticks": ticks, "axis": axis})
    per = (t1 - t0) / max(ticks, 1)
    for t in range(ticks):
        trace.record_span(
            "pipeline:tick", "pipeline-ticks", t0 + t * per,
            t0 + (t + 1) * per, rank=rank,
            args={"tick": t, "synthetic": True,
                  "send": "ppermute ring shift (stage i -> i+1)",
                  "ingest": t if t < m_count else None,
                  "emit": t - (n_stages - 1)
                  if t >= n_stages - 1 else None})
    return out


def pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             stage_params, microbatches: torch.Tensor, mesh,
             axis: str = "pp", checkpoint: bool = True) -> torch.Tensor:
    """Run ``microbatches`` (M, mb, ...) through the P stages of ``axis``.

    Every member of the axis calls it with its own stage's parameters
    (``shard_stage_params``) and the same microbatches.
    ``stage_fn(params_for_stage, x) -> y`` maps one microbatch through one
    stage; activations keep one shape across stages.  Returns the (M, mb,
    ...) outputs of the LAST stage on every member, differentiable end to
    end (autograd runs the ticks backward, each shift's cotangent moving
    one stage back)."""
    n_stages = axis_size(mesh, axis)
    stage = axis_rank(mesh, axis)
    m_count = microbatches.shape[0]
    last = n_stages - 1
    fn = stage_fn
    if checkpoint:
        def fn(p, x):
            if not torch.is_grad_enabled():
                return stage_fn(p, x)
            return _checkpoint(stage_fn, p, x, use_reentrant=False)

    def run(params, mbs):
        zero = torch.zeros_like(mbs[0])
        state = zero
        outs = [zero] * m_count
        ticks = m_count + n_stages - 1
        for t in range(ticks):
            feed = mbs[t] if t < m_count else zero
            x = state if stage else (_Tie.apply(feed, state)
                                     if state.requires_grad else feed)
            y = fn(params, x)
            if stage == last and t >= last:
                outs[t - last] = y
            if t < ticks - 1:
                # every stage's output moves one stage forward (the last
                # tick's shift, which no stage reads, is not sent)
                state = ring_hop(y, axis, mesh)
        # only the last stage holds real outputs: its one-hot, summed
        mine = torch.stack(outs)
        if stage != last and y.requires_grad:
            mine = _Tie.apply(mine, y)
        return reduce_from(mine, axis, mesh)

    return _traced_run(run, stage_params, microbatches, n_stages, m_count,
                       axis)


__all__ = ["stack_stage_params", "shard_stage_params", "pipeline"]
