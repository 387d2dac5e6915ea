"""Request-level continuous batching over the ServingEngine.

Counterpart of ``ompi_tpu/serving/scheduler.py`` (``Request``,
``poisson_stream``, ``ContinuousBatchingScheduler``, ``FleetRouter``).  The scheduler is
pure host orchestration — admission, eviction and the per-step device
batch are integer bookkeeping against the paged cache; all device work
happens inside the engine's prefill/decode_step.  Two policies share the
loop:

* ``continuous`` — admit whenever a batch slot AND the request's full
  page reservation are free, every step.  Finished sequences evict (EOS
  or max-new) and their slot refills on the next step, so the device
  batch stays full while requests of different lengths drain.
* ``static`` — the classic baseline: admit a wave only when the batch is
  EMPTY, then run the wave to completion.  Short requests finish early
  and their slots idle until the longest member drains.

Time is a virtual clock fed by MEASURED durations (prefill, decode step,
host bookkeeping): arrivals interleave against real step costs and idle
gaps jump to the next arrival.  Every tp rank runs the scheduler on the
same stream (one process a rank, where the reference has one controller),
so before each admission decision the ranks take the largest of their
clocks: each rank measures its own durations, and a rank that admitted a
request while another ran a decode step would issue mismatched
collectives.

Speculative decoding (``spec_k >= 2``): each step drafts ``spec_k − 1``
tokens a slot by an n-gram self-draft over the request's own history and
verifies them in one ``engine.decode_window``; the longest prefix the
model's greedy output agrees with is accepted, so the streams are the
non-speculative ones.  ``FleetRouter`` assigns a stream's requests to
the replicas of a ``serving/fleet`` fleet.

The request plane (``serving/requests``: admit, the prefill stage,
tokens, finish and the router's decision, each behind ONE
``requests.enabled`` read) records a request on one process only: a
scheduler's ``req_records`` is true on the first rank of its engine's
comm (in a fleet, of its replica), and ``rank`` is the lane its events
take (the replica).  The tp ranks run the same loop on the same agreed
clock, so that process sees every event of the request.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import serving
from ..op import MAX
from . import requests as _requests


@dataclass
class Request:
    """One inference request in the stream."""
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32 token ids
    max_new: int                       # generation budget (incl. the
                                       # prefill's first token)
    arrival: float = 0.0               # virtual-clock arrival time
    eos_id: Optional[int] = None       # per-request EOS override


def poisson_stream(n: int, qps: float, vocab: int, *, seed: int = 0,
                   prompt_len: tuple = (4, 16),
                   max_new: tuple = (4, 16),
                   eos_id: Optional[int] = None) -> List[Request]:
    """Synthetic open-loop request stream: exponential inter-arrival gaps
    at ``qps`` (a Poisson process), uniform prompt/generation lengths.
    Deterministic under ``seed`` — the reference's numpy stream — so the
    continuous and static arms replay the IDENTICAL stream."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, n)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new=int(rng.integers(max_new[0], max_new[1] + 1)),
            arrival=float(arrivals[i]),
            eos_id=eos_id))
    return reqs


@dataclass
class _Active:
    req: Request
    slot: int
    tokens: List[int] = field(default_factory=list)
    last: int = 0                      # next decode step's input token


class ContinuousBatchingScheduler:
    """Drives one engine over a request stream; see module docstring."""

    def __init__(self, engine, requests: List[Request], *,
                 policy: str = "continuous",
                 eos_id: Optional[int] = None,
                 spec_k: int = 0) -> None:
        if policy not in ("continuous", "static"):
            raise ValueError(f"policy={policy!r} "
                             "(want continuous|static)")
        if spec_k < 0 or spec_k == 1:
            raise ValueError(f"spec_k={spec_k} (0 disables; >=2 sets "
                             "the draft/verify window length)")
        self.engine = engine
        self.policy = policy
        self.eos_id = eos_id
        self.spec_k = int(spec_k)
        self.pending: List[Request] = sorted(requests,
                                             key=lambda r: r.arrival)
        self.active: Dict[int, _Active] = {}       # slot -> state
        self.rank = 0                  # request-plane lane (replica id)
        # the request plane records on the comm's first rank only (a
        # fleet's scheduler on a rank without its replica's engine sets
        # its own)
        self.req_records = engine is None or engine.dc.pos == 0
        self.clock = 0.0
        self.decode_steps = 0
        self.decode_s = 0.0
        self.occ_sum = 0.0
        self.results: Dict[int, Dict[str, Any]] = {}

    def _on_token(self, st: _Active) -> None:
        """Subclass hook: one emitted token for ``st`` at ``self.clock``
        (the fleet's per-replica ITL attribution overrides this)."""

    # -- lifecycle ---------------------------------------------------------

    def _admit_one(self, req: Request) -> None:
        cache = self.engine.cache
        slot = cache.admit(len(req.prompt), req.max_new)
        if serving.enabled:
            serving.note_admit(req.rid, len(req.prompt), req.max_new,
                               req.arrival, self.clock)
            serving.set_pages_used(cache.pages_used)
        if _requests.enabled and self.req_records:
            _requests.note_admit(req.rid, req.arrival, self.clock,
                                 len(req.prompt), req.max_new,
                                 replica=self.rank)
        t0 = time.perf_counter()
        first, _ = self.engine.prefill(slot, req.prompt, rid=req.rid)
        dur = time.perf_counter() - t0
        self.clock += dur
        st = _Active(req=req, slot=slot, tokens=[first], last=first)
        self.active[slot] = st
        if serving.enabled:
            serving.note_prefill(dur, len(req.prompt))
            serving.note_token(req.rid, self.clock)
        if _requests.enabled and self.req_records:
            _requests.note_stage(req.rid, "prefill", self.clock - dur,
                                 self.clock, rank=self.rank)
            _requests.note_token(req.rid, self.clock, rank=self.rank)
        self._on_token(st)
        self._maybe_finish(st, first)

    def _finish(self, st: _Active, reason: str) -> None:
        self.engine.cache.release(st.slot)
        del self.active[st.slot]
        self.results[st.req.rid] = {
            "rid": st.req.rid, "tokens": list(st.tokens),
            "reason": reason, "finished_at": self.clock}
        if serving.enabled:
            serving.note_evict(st.req.rid, reason, self.clock)
            serving.set_pages_used(self.engine.cache.pages_used)
        if _requests.enabled and self.req_records:
            _requests.note_finish(st.req.rid, self.clock, reason)

    def _maybe_finish(self, st: _Active, tok: int) -> bool:
        eos = (st.req.eos_id if st.req.eos_id is not None
               else self.eos_id)
        if eos is not None and tok == eos:
            self._finish(st, "eos")
            return True
        if len(st.tokens) >= st.req.max_new:
            self._finish(st, "max_new")
            return True
        return False

    def _agree_clock(self) -> None:
        """The largest of the tp ranks' clocks, on every rank: one MAX
        ``allreduce`` of one row on the engine's comm."""
        dc = self.engine.dc
        if dc.n > 1:
            t = torch.tensor([[self.clock]], dtype=torch.float64,
                             device=dc.device)
            self.clock = float(dc.allreduce(t, MAX)[0, 0])

    def _admissible(self) -> bool:
        if not self.pending:
            return False
        self._agree_clock()
        if self.pending[0].arrival > self.clock:
            return False
        if self.policy == "static" and self.active:
            return False
        req = self.pending[0]
        return self.engine.cache.can_admit(len(req.prompt), req.max_new)

    # -- the loop ----------------------------------------------------------

    def run(self, max_steps: int = 100000) -> Dict[str, Any]:
        while self.pending or self.active:
            th0 = time.perf_counter()
            while self._admissible():
                host = time.perf_counter() - th0
                self.clock += host
                if serving.enabled:
                    serving.note_host(host)
                self._admit_one(self.pending.pop(0))
                th0 = time.perf_counter()
            host = time.perf_counter() - th0
            self.clock += host
            if serving.enabled:
                serving.note_host(host)
            if not self.active:
                if not self.pending:
                    break
                # idle: jump the virtual clock to the next arrival
                self.clock = max(self.clock, self.pending[0].arrival)
                continue
            if self.spec_k >= 2:
                self._step_spec()
            else:
                self._step()
            if self.decode_steps >= max_steps:
                raise RuntimeError(f"scheduler exceeded {max_steps} "
                                   "decode steps without draining")
        return self.summary()

    def _step(self) -> None:
        cache = self.engine.cache
        b = self.engine.max_seqs
        tokens = np.zeros(b, np.int32)
        positions = np.full(b, -1, np.int64)
        for slot, st in self.active.items():
            tokens[slot] = st.last
            positions[slot] = int(cache.seq_lens[slot])
        t0 = time.perf_counter()
        nxt, _ = self.engine.decode_step(tokens, positions)
        dur = time.perf_counter() - t0
        self.clock += dur
        self.decode_steps += 1
        self.decode_s += dur
        self.occ_sum += len(self.active) / b
        if serving.enabled:
            serving.note_decode_step(dur, len(self.active), b)
        th0 = time.perf_counter()
        for slot in list(self.active):
            st = self.active[slot]
            cache.seq_lens[slot] += 1          # the input token's kv
            tok = int(nxt[slot])
            st.tokens.append(tok)
            st.last = tok
            if serving.enabled:
                serving.note_token(st.req.rid, self.clock)
            if _requests.enabled and self.req_records:
                _requests.note_token(st.req.rid, self.clock,
                                     rank=self.rank)
            self._on_token(st)
            self._maybe_finish(st, tok)
        host = time.perf_counter() - th0
        self.clock += host
        if serving.enabled:
            serving.note_host(host)

    # -- speculative decoding (spec_k >= 2) --------------------------------

    @staticmethod
    def _draft(history: List[int], n: int) -> List[int]:
        """n-gram SELF-draft: continue the sequence by the most recent
        bigram match in the request's own history (prompt + emitted
        tokens), falling back to repeating the last token.  Free — no
        second model — and measurably nonzero on any stream with local
        structure; the acceptance rate is MEASURED by the verify loop
        (serving.note_spec), never assumed."""
        work = list(history)
        out: List[int] = []
        for _ in range(n):
            d = None
            if len(work) >= 2:
                prev, last = work[-2], work[-1]
                for i in range(len(work) - 3, -1, -1):
                    if work[i] == prev and work[i + 1] == last:
                        d = work[i + 2]
                        break
            if d is None:
                d = work[-1]
            out.append(d)
            work.append(d)
        return out

    @staticmethod
    def _accepted(drafts: List[int], out: List[int]) -> int:
        """How many leading drafts the window confirms: draft i against
        the model's greedy output at window position i."""
        j = 0
        while j < len(drafts) and drafts[j] == out[j]:
            j += 1
        return j

    def _truncate(self, slot: int, rows: int) -> None:
        """Keep ``slot``'s first ``rows`` KV rows: the consumed tokens, the
        input and the accepted drafts, one row each; the rows past them
        are rolled back (masked by every later query, overwritten when
        their positions refill)."""
        self.engine.cache.seq_lens[slot] = rows

    def _step_spec(self) -> None:
        """One draft/verify window: each active slot runs its next input
        token plus ``spec_k − 1`` draft tokens through ONE teacher-forced
        ``decode_window`` call, then accepts the longest prefix where draft
        i equals the model's greedy output at window position i−1 — so
        every emitted token is EXACTLY the token non-speculative greedy
        would have produced, and a rejection is a block-table truncate
        (``cache.seq_lens`` rolls back to the accepted prefix; the stale KV
        rows are masked and later overwritten)."""
        cache = self.engine.cache
        b, k = self.engine.max_seqs, self.spec_k
        tokens = np.zeros((b, k), np.int32)
        positions = np.full((b, k), -1, np.int64)
        drafts: Dict[int, List[int]] = {}
        for slot, st in self.active.items():
            d = self._draft(list(st.req.prompt) + st.tokens, k - 1)
            drafts[slot] = d
            tokens[slot] = [st.last] + d
            p = int(cache.seq_lens[slot])
            positions[slot] = np.arange(p, p + k)
        t0 = time.perf_counter()
        nxt, _ = self.engine.decode_window(tokens, positions)
        dur = time.perf_counter() - t0
        self.clock += dur
        self.decode_steps += 1
        self.decode_s += dur
        self.occ_sum += len(self.active) / b
        if serving.enabled:
            serving.note_decode_step(dur, len(self.active), b)
        th0 = time.perf_counter()
        for slot in list(self.active):
            st = self.active[slot]
            y = [int(t) for t in nxt[slot]]
            j = self._accepted(drafts[slot], y)
            if serving.enabled:
                serving.note_spec(k - 1, j)
            emitted = 0
            finished = False
            for i in range(j + 1):       # y_0..y_j are all greedy-true
                tok = y[i]
                st.tokens.append(tok)
                st.last = tok
                emitted += 1
                if serving.enabled:
                    serving.note_token(st.req.rid, self.clock)
                if _requests.enabled and self.req_records:
                    _requests.note_token(st.req.rid, self.clock,
                                         rank=self.rank)
                self._on_token(st)
                if self._maybe_finish(st, tok):
                    finished = True
                    break
            if not finished:
                self._truncate(slot, int(positions[slot, 0]) + emitted)
        host = time.perf_counter() - th0
        self.clock += host
        if serving.enabled:
            serving.note_host(host)

    def summary(self) -> Dict[str, Any]:
        toks = sum(len(r["tokens"]) for r in self.results.values())
        return {
            "policy": self.policy,
            "clock_s": self.clock,
            "decode_steps": self.decode_steps,
            "completed": len(self.results),
            "tokens": toks,
            "tokens_per_s": toks / self.clock if self.clock else 0.0,
            "results": self.results,
        }


class FleetRouter:
    """Deterministic weighted admission across fleet replicas.

    Deficit weighted round-robin: every assignment credits each replica
    its share of the effective weight vector and picks the replica with
    the largest accumulated credit (ties break to the LOWEST replica id),
    then debits the winner one unit.  The decision is a pure function of
    the weight/credit history, so two routers fed identical streams under
    identical weights make identical assignments: every process of a
    fleet runs its own router, and they agree because their weights are
    fed the same agreed rows.

    Two inputs move the weights: ``update(replica, tokens_per_s,
    itl_p99_ms)`` feeds a replica's goodput/ITL (a replica with high tail
    latency per unit goodput loses share), and the per-replica bias of
    ``serving.apply_route_weight`` (``serving.fleet_route_bias``), read on
    EVERY assignment.

    With the request plane on, each assignment is noted with the weight
    snapshot (``requests.note_route``) where ``req_owner(pick)`` holds:
    a fleet sets it to "this process records the picked replica's
    requests"; None notes every assignment (a router alone in its
    process)."""

    def __init__(self, n: int,
                 weights: Optional[List[float]] = None) -> None:
        if n < 1:
            raise ValueError(f"n={n} (want >= 1 replicas)")
        if weights is not None and len(weights) != n:
            raise ValueError(f"{len(weights)} weights for {n} replicas")
        self.n = int(n)
        self.weights = ([1.0] * n if weights is None
                        else [float(w) for w in weights])
        self._credits = [0.0] * n
        self.req_owner: Optional[Callable[[int], bool]] = None

    def set_weight(self, replica: int, w: float) -> None:
        self.weights[int(replica)] = max(float(w), 0.0)

    def update(self, replica: int, tokens_per_s: float,
               itl_p99_ms: float) -> None:
        """Live reweighting from a replica's serving stats: goodput per
        unit of tail latency, so slow-tail replicas shed admission share
        proportionally."""
        self.weights[int(replica)] = (max(float(tokens_per_s), 0.0)
                                      / max(float(itl_p99_ms), 1e-3))

    def effective_weights(self) -> List[float]:
        eff = [max(self.weights[i], 0.0)
               * serving.fleet_route_bias(i) for i in range(self.n)]
        if not any(w > 0.0 for w in eff):
            eff = [1.0] * self.n           # all-zero: fall back to even
        return eff

    def assign(self, rid: Any) -> int:
        eff = self.effective_weights()
        tot = sum(eff)
        for i in range(self.n):
            self._credits[i] += eff[i] / tot
        pick = 0
        for i in range(1, self.n):
            if self._credits[i] > self._credits[pick] + 1e-12:
                pick = i
        self._credits[pick] -= 1.0
        if serving.enabled:
            serving.note_route(rid, pick, eff)
        if _requests.enabled and (self.req_owner is None
                                  or self.req_owner(pick)):
            # the weight snapshot rides the route DECISION event too, so
            # "why this replica" is answerable from the trace alone
            _requests.note_route(rid, pick, eff)
        return pick
