"""Serving fleet — goodput-routed replicas + prefill/decode split, SPMD.

Counterpart of ``ompi_tpu/serving/fleet.py`` (``:83-542``).  The fleet is
one serving configuration whose only knobs are the replica count (R) and
the tp degree.  The world is ``R × tp`` processes on one
``{"fleet": R, "tp": tp}`` mesh: replica r is the mesh's r-th row, and
each process builds only its own replica's ``ServingEngine``, on
``DeviceComm(mesh, "tp")``, from its train shards (``shard_params``).  A
front-end ``FleetRouter`` admits one Poisson stream across the replicas.

Two topologies over the same cards:

* **colocated** (``prefill_replicas=0``) — every replica runs its own
  continuous-batching loop, prefill and decode on the same engine.
* **disaggregated** — the first ``prefill_replicas`` replicas ONLY
  prefill; the rest ONLY decode.  A finished prompt's KV pages migrate
  prefill→decode through :meth:`ServingFleet.migrate`: the reference's
  move, a ``parallel.reshard.cross_reshard`` over a 2×tp bridge (the two
  rows), the real pages on the prefill row and a zero half on the decode
  row, the destination replicated over ``fleet``, so the plan has tp
  cross-rank pieces (prefill j → decode j, wire == page bytes) and tp
  zero-wire local pieces, peak == 4·shard == the default bound.  The
  move runs on world-group point-to-point, so it needs no group of its
  own.  The fleet charges ``simdcn`` for it when the ``fleet`` axis
  classifies as DCN, and writes the fleet ledger row
  (``serving.note_migration``).

Time is the reference's virtual clock, one a replica on a common axis:
the prefill lane works ahead on its own clock, and a migrated sequence
joins the decode batch once the decode clock reaches its handoff time.

SPMD.  The reference is one controller; here every rank takes every
decision itself, so every value that feeds a decision is agreed before
it, and all ranks take the same path:

* within a replica, the tp ranks' clock (``_agree_clock``, as the bare
  scheduler does);
* across a prefill/decode pair, before each admission, the decode clock,
  the prefill lane's clock and the decode cache's ``can_admit``; after the
  prefill, the lane's clock and the first token (computed on the prefill
  ranks, emitted on the decode ranks); after the migration, the lane's
  clock — each one MAX ``DeviceComm.allreduce`` of one float64 row over
  the pair's group, where each side contributes its own values and −inf
  for the other's;
* after the loops, each replica's summary row (clock, tokens/s, ITL) and
  its results from its first rank, shared with every process, before
  ``router.update`` and ``update_replica``; the fleet clock is the
  largest replica clock.

Every process group is made at construction, by every rank, in one
order, and only once for the life of the world: a fleet of a layout
built before reuses that layout's mesh and pair groups.  A prefill
replica that serves several decode replicas runs their loops in the
reference's order, carrying its lane clock from one to the next;
colocated replicas, and pairs that share no replica, run concurrently.

The pair runs in lock step: the decode ranks wait in each agreement for
the prefill ranks' prefill and migration, so on the host's clock a
prefill does not overlap the decode steps.  Only the virtual clock keeps
the two lanes apart, as the reference's does.

The request plane (``serving/requests``) records each request on the
first rank of the replica that decodes it: in the colocated topology
that replica's scheduler (admit, prefill, tokens, finish); in the
disaggregated one the decode replica's first rank, which runs the
prefill lane in step and so sees its agreed clock and first token, notes
the admission, the prefill and the migration on the prefill replica's
lane and the join, the tokens and the finish on its own.  Every event's
``rank`` is a replica index, as in the reference; the router notes its
assignment on the process that records the picked replica.  With
tracing on, every rank of a migration records its ``serve:migrate``
span (``status="error"`` when the move raises).

Left for later slices: the ``hot_replica`` sentry
(``check_hot_replicas``: the policy bus, ROADMAP P16b) and
``comm_doctor --fleet`` (P18).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import serving, trace
from ..core import var as _var
from ..op import MAX
from ..parallel import reshard as _reshard
from ..parallel import simdcn
from ..parallel.collectives import DeviceComm
from ..parallel.mesh import axis_rank, classify_axes, make_mesh
from . import requests as _requests
from .engine import ServingEngine
from .scheduler import (ContinuousBatchingScheduler, FleetRouter, Request,
                        _Active)

_var.register("serve", "req", "chaos_migrate_ms", 0.0, type=float, level=4,
              help="Fault injection: extra virtual delay (ms) added to "
                   "every KV-page migration hop, modelling a degraded "
                   "DCN lane. 0 = off.")
_var.register("serve", "req", "chaos_prefill_scale", 1.0, type=float,
              level=4,
              help="Fault injection: multiplier on every fleet prefill's "
                   "virtual duration, modelling a slowed prefill "
                   "replica. 1.0 = off.")

_NONE = float("-inf")                  # the other side's slot in a row

# the fleets' meshes, by (replicas, tp), and pair comms, by world ranks
# (None on a rank outside the pair), for the life of the world: every
# rank builds the same fleets in one order, so every rank makes or finds
# each at the same point
_LAYOUTS: Dict[str, Any] = {"world": None, "meshes": {}, "pairs": {}}


def _layouts() -> Dict[str, Any]:
    if _LAYOUTS["world"] is not dist.group.WORLD:
        _LAYOUTS.update(world=dist.group.WORLD, meshes={}, pairs={})
    return _LAYOUTS


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    k = min(int(round(q * (len(s) - 1))), len(s) - 1)
    return s[k]


class _Replica:
    """One fleet member: its row of world ranks, its role, the prefill-lane
    clock the disaggregated scheduler advances, and — in its own
    processes only — its engine."""

    def __init__(self, idx: int, role: str, ranks: List[int],
                 engine: Optional[ServingEngine] = None) -> None:
        self.idx = idx
        self.role = role                   # "serve" | "prefill" | "decode"
        self.ranks = ranks
        self.engine = engine
        self.prefills = 0
        self.prefill_s = 0.0
        self.clock = 0.0                   # prefill-lane virtual time


class _ReplicaScheduler(ContinuousBatchingScheduler):
    """The base continuous loop plus per-replica ITL attribution."""

    def __init__(self, replica: _Replica, requests: List[Request],
                 **kw: Any) -> None:
        super().__init__(replica.engine, requests, **kw)
        self.replica = replica
        self.rank = replica.idx
        self.req_records = dist.get_rank() == replica.ranks[0]
        self.itl: List[float] = []
        self._last_t: Dict[Any, float] = {}

    def _on_token(self, st: _Active) -> None:
        rid = st.req.rid
        last = self._last_t.get(rid)
        if last is not None:
            self.itl.append(self.clock - last)
        self._last_t[rid] = self.clock


class _DisaggScheduler(_ReplicaScheduler):
    """Decode-replica loop with prefill and migration on a separate lane,
    run by the ranks of both replicas of the pair.

    The prefill lane runs on its own virtual clock (it may work AHEAD of
    the decode clock), gated only by arrival and decode-cache admission
    backpressure.  A prefilled sequence's pages migrate at once
    (reserving the decode slot), then the sequence joins the decode batch
    once the decode clock reaches the handoff time.  The prefill ranks run
    ``_pump_prefill`` alone, in step with the decode ranks' calls of it:
    both sides reach the same decisions from the same agreed rows."""

    def __init__(self, fleet: "ServingFleet", pre: _Replica,
                 dec: _Replica, requests: List[Request],
                 **kw: Any) -> None:
        super().__init__(dec, requests, **kw)
        self.fleet = fleet
        self.pre = pre
        self.on_prefill = fleet.me == pre.idx
        self.ready: List[Tuple[float, Request, int, int]] = []

    def _admissible(self) -> bool:
        return False                       # admission goes via the pump

    def _agree(self, mine: List[float]) -> List[float]:
        return self.fleet._agree(self.pre.idx, self.replica.idx, mine)

    def _pump_prefill(self) -> None:
        pre, dec = self.pre, self.replica
        side = self.on_prefill
        while self.pending:
            req = self.pending[0]
            # the decode clock, the lane's clock and the decode cache's
            # backpressure, agreed across the pair
            dclock, pclock, can = self._agree(
                [_NONE, pre.clock, _NONE] if side else
                [self.clock, _NONE,
                 float(dec.engine.cache.can_admit(len(req.prompt),
                                                  req.max_new))])
            self.clock, pre.clock = dclock, pclock
            if req.arrival > max(self.clock, pre.clock):
                break
            if not can:
                break                      # decode-cache backpressure
            self.pending.pop(0)
            pre.clock = max(pre.clock, req.arrival)
            admitted = pre.clock
            if serving.enabled:
                serving.note_admit(req.rid, len(req.prompt), req.max_new,
                                   req.arrival, pre.clock)
            if _requests.enabled and self.req_records:
                _requests.note_admit(req.rid, req.arrival, pre.clock,
                                     len(req.prompt), req.max_new,
                                     replica=dec.idx, rank=pre.idx)
            pslot, first = None, _NONE
            if side:
                pcache = pre.engine.cache
                pslot = pcache.admit(len(req.prompt), req.max_new)
                t0 = time.perf_counter()
                first, _ = pre.engine.prefill(pslot, req.prompt,
                                              rid=req.rid)
                pdur = time.perf_counter() - t0
                # fault injection: a slowed prefill replica is a
                # multiplier on the VIRTUAL prefill duration
                scale = float(_var.get("serve_req_chaos_prefill_scale",
                                       1.0))
                if scale != 1.0:
                    pdur *= max(scale, 0.0)
                pre.clock += pdur
            # the lane's clock and the first token, from the prefill ranks
            pclock, first = self._agree(
                [pre.clock, float(first)] if side else [_NONE, _NONE])
            pre.clock, first = pclock, int(first)
            pdur = pre.clock - admitted
            pre.prefills += 1
            pre.prefill_s += pdur
            if serving.enabled:
                serving.note_prefill(pdur, len(req.prompt))
                serving.note_token(req.rid, pre.clock)
            if _requests.enabled and self.req_records:
                _requests.note_stage(req.rid, "prefill", pre.clock - pdur,
                                     pre.clock, rank=pre.idx)
                _requests.note_token(req.rid, pre.clock, rank=pre.idx)
            self._last_t[req.rid] = pre.clock
            eos = (req.eos_id if req.eos_id is not None else self.eos_id)
            if (eos is not None and first == eos) or req.max_new <= 1:
                # done at the first token: nothing to migrate
                if side:
                    pre.engine.cache.release(pslot)
                reason = ("eos" if eos is not None and first == eos
                          else "max_new")
                self.results[req.rid] = {
                    "rid": req.rid, "tokens": [first], "reason": reason,
                    "finished_at": pre.clock}
                if serving.enabled:
                    serving.note_evict(req.rid, reason, pre.clock)
                if _requests.enabled and self.req_records:
                    _requests.note_finish(req.rid, pre.clock, reason)
                continue
            t0 = time.perf_counter()
            dslot = self.fleet.migrate(pre, dec, pslot, len(req.prompt),
                                       req.max_new, rid=req.rid)
            mdur = time.perf_counter() - t0
            # fault injection: a degraded migration lane is extra virtual
            # delay on every hand-off
            mdur += 1e-3 * float(_var.get("serve_req_chaos_migrate_ms",
                                          0.0))
            # both sides timed the move: the lane's clock after it, agreed
            before = pre.clock
            pre.clock = self._agree([pre.clock + mdur])[0]
            if _requests.enabled and self.req_records:
                last = _reshard.report()["last"] or {}
                _requests.note_stage(
                    req.rid, "migrate", before, pre.clock, rank=pre.idx,
                    src=pre.idx, dst=dec.idx,
                    wire_bytes=int(last.get("wire_bytes", 0)),
                    link="decide:reshard")
            if side:
                pre.engine.cache.release(pslot)
            else:
                self.ready.append((pre.clock, req, dslot, first))

    def _join_ready(self) -> None:
        rest = []
        for t, req, dslot, first in self.ready:
            if t <= self.clock:
                self.active[dslot] = _Active(req=req, slot=dslot,
                                             tokens=[first], last=first)
                if _requests.enabled and self.req_records:
                    _requests.note_stage(req.rid, "join", t, self.clock,
                                         rank=self.replica.idx)
            else:
                rest.append((t, req, dslot, first))
        self.ready = rest

    def run(self, max_steps: int = 100000) -> Dict[str, Any]:
        if self.on_prefill:
            while self.pending:
                self._pump_prefill()
            return self.summary()
        while self.pending or self.ready or self.active:
            self._pump_prefill()
            self._agree_clock()
            self._join_ready()
            if not self.active:
                if self.ready:
                    # idle: jump the decode clock to the next handoff
                    self.clock = max(self.clock,
                                     min(t for t, *_ in self.ready))
                elif self.pending:
                    self.clock = max(self.clock,
                                     self.pending[0].arrival)
                else:
                    break
                continue
            self._step()
            if self.decode_steps >= max_steps:
                raise RuntimeError(f"fleet scheduler exceeded "
                                   f"{max_steps} decode steps without "
                                   "draining")
        return self.summary()


class ServingFleet:
    """R data-parallel serving replicas over the rows of a
    ``{"fleet": R, "tp": tp}`` mesh of the whole world (R × tp processes).

    ``params`` arrive in the train layout (the whole tree, on this
    process's device); each process shards them onto its replica's row
    and the engine converts them to the decode layout.
    ``prefill_replicas=0`` is the colocated topology;
    ``prefill_replicas=k`` dedicates the first k replicas to prefill and
    the rest to decode.  Every rank of the world builds the fleet and
    calls ``run`` with the same arguments.  ``spc`` is this process's
    counter table (the engine's comm and the migrations count into it)."""

    def __init__(self, params: Dict, cfg, *, replicas: int = 1,
                 tp: int = 8, prefill_replicas: int = 0,
                 n_pages: int = 96, page_size: int = 8, max_seqs: int = 8,
                 spc=None, router: Optional[FleetRouter] = None,
                 layout: str = "train") -> None:
        from ..models import transformer as tfm
        replicas, tp = int(replicas), int(tp)
        need = replicas * tp
        world = dist.get_world_size()
        if world != need:
            raise ValueError(f"ServingFleet: {replicas} replicas × tp={tp} "
                             f"needs {need} processes, the world has "
                             f"{world}")
        if prefill_replicas < 0 or prefill_replicas >= replicas and \
                prefill_replicas > 0:
            raise ValueError(
                f"ServingFleet: prefill_replicas={prefill_replicas} "
                f"must leave at least one decode replica of {replicas}")
        self.cfg = cfg
        self.tp = tp
        self.spc = spc
        self.mode = ("disaggregated" if prefill_replicas
                     else "colocated")
        layouts = _layouts()
        if (replicas, tp) not in layouts["meshes"]:
            layouts["meshes"][(replicas, tp)] = make_mesh(
                {"fleet": replicas, "tp": tp})
        self.mesh = layouts["meshes"][(replicas, tp)]
        rows = self.mesh.mesh.reshape(replicas, tp).tolist()
        self.me = axis_rank(self.mesh, "fleet")
        # the fleet axis's plane keys the migration's decision and the
        # simulated-DCN charge (collective: every rank classifies)
        self._plane = classify_axes(self.mesh)["fleet"]
        dc = DeviceComm(self.mesh, "tp")
        dc.spc = spc
        sharded = (tfm.shard_params(params, self.mesh, cfg)
                   if layout == "train" else params)
        eng = ServingEngine(dc, sharded, cfg, n_pages=n_pages,
                            page_size=page_size, max_seqs=max_seqs,
                            layout=layout)
        self.engine = eng
        self._device = dc.device
        self.replicas: List[_Replica] = []
        for r in range(replicas):
            role = ("prefill" if r < prefill_replicas
                    else ("decode" if prefill_replicas else "serve"))
            self.replicas.append(_Replica(r, role, rows[r],
                                          eng if r == self.me else None))
        self.prefill_ids = list(range(prefill_replicas))
        self.serve_ids = list(range(prefill_replicas, replicas))
        self.router = router if router is not None else \
            FleetRouter(len(self.serve_ids))
        # the route decision is noted where the picked replica's
        # requests are recorded: its first rank
        me = dist.get_rank()
        self.router.req_owner = \
            lambda pick: self.replicas[self.serve_ids[pick]].ranks[0] == me
        # each prefill/decode pair's comm (its agreements) over a group
        # made by every rank in one order; a member builds the comm
        self._pairs: Dict[Tuple[int, int], Optional[DeviceComm]] = {}
        for i, t in enumerate(self.serve_ids):
            if self.prefill_ids:
                p = self.prefill_ids[i % len(self.prefill_ids)]
                ranks = tuple(sorted(rows[p] + rows[t]))
                if ranks not in layouts["pairs"]:
                    g = dist.new_group(list(ranks), group_desc="fleet_pair")
                    layouts["pairs"][ranks] = (
                        DeviceComm(DeviceMesh.from_group(
                            g, self.mesh.device_type,
                            mesh_dim_names=("pair",)), "pair")
                        if dist.get_rank() in ranks else None)
                self._pairs[(p, t)] = layouts["pairs"][ranks]
        self._bridges: Dict[Tuple[int, int], Tuple[Any, Any]] = {}
        serving.set_fleet_replicas(replicas)
        for rep in self.replicas:
            serving.update_replica(rep.idx, {"role": rep.role})

    # -- agreement ---------------------------------------------------------

    def _agree(self, pre: int, dec: int, mine: List[float]) -> List[float]:
        """The element-wise largest of the pair's rows, one MAX
        ``allreduce`` on the pair's comm: each side fills its own values
        and −inf for the other's."""
        dc = self._pairs[(pre, dec)]
        t = torch.tensor([mine], dtype=torch.float64, device=dc.device)
        return dc.allreduce(t, MAX)[0].tolist()

    # -- KV-page migration (the cross_reshard hop) -------------------------

    def _bridge(self, src: _Replica, dst: _Replica):
        key = (src.idx, dst.idx)
        got = self._bridges.get(key)
        if got is None:
            got = self._bridges[key] = (
                _reshard.RankMesh.make({"fleet": 2, "tp": self.tp},
                                       src.ranks + dst.ranks),
                _reshard.RankMesh.make({"tp": self.tp}, dst.ranks))
        return got

    def migrate(self, src: _Replica, dst: _Replica,
                src_slot: Optional[int], prompt_len: int, max_new: int,
                rid: Any = None) -> Optional[int]:
        """Hand ``src_slot``'s KV pages from ``src`` to ``dst``: every rank
        of both replicas calls it (the decode ranks with ``src_slot``
        None).  On the decode ranks it admits the sequence, writes the
        pages with one ``index_copy_`` a pool, carries ``seq_lens`` over
        (the prompt's rows) and returns the dest slot; on the prefill
        ranks it returns None.  Pages move bitwise — whole pages, dest
        pages fully overwritten.  With tracing on, each rank records one
        ``serve:migrate`` span."""
        t0 = time.perf_counter()
        try:
            return self._migrate(src, dst, src_slot, prompt_len, max_new,
                                 rid, t0)
        except BaseException:
            if trace.enabled:
                trace.record_span("serve:migrate", "serve", t0,
                                  time.perf_counter(), rank=dist.get_rank(),
                                  args={"rid": rid, "src": src.idx,
                                        "dst": dst.idx, "status": "error"})
            raise

    def _migrate(self, src: _Replica, dst: _Replica,
                 src_slot: Optional[int], prompt_len: int, max_new: int,
                 rid: Any, t0: float) -> Optional[int]:
        on_src = self.me == src.idx
        if not on_src and self.me != dst.idx:
            raise ValueError(f"ServingFleet.migrate: this process serves "
                             f"replica {self.me}, not {src.idx} or "
                             f"{dst.idx}")
        cache = self.engine.cache
        L, pg = cache.n_layers, cache.page_size
        hl, hd = cache.heads_local, cache.head_dim
        npg = cache.pages_needed(prompt_len, max_new)
        rows = 2 * L * npg                 # k then v, layer-major
        if on_src:
            pages = list(cache._slot_pages[src_slot])
            if len(pages) != npg or int(cache.seq_lens[src_slot]) != \
                    prompt_len:
                raise RuntimeError(
                    f"ServingFleet.migrate: slot {src_slot} holds "
                    f"{len(pages)} pages and {cache.seq_lens[src_slot]} "
                    f"rows, want {npg} and {prompt_len}")
            idx = torch.as_tensor(pages, device=self._device)
            blk = torch.cat([p.index_select(1, idx)
                             for p in cache.k + cache.v], dim=1)
            dst_slot = None
        else:
            dst_slot = cache.admit(prompt_len, max_new)
            # the zero half: resident on the decode rank, so its piece is
            # a zero-wire local copy in the cross plan
            blk = torch.zeros((1, rows, pg, hl, hd), dtype=cache.dtype,
                              device=self._device)
        bridge, dmesh = self._bridge(src, dst)
        out = _reshard.cross_reshard(
            blk.reshape(1, 1, rows, pg, hl, hd),
            (2, self.tp, rows, pg, hl, hd), cache.dtype, ("fleet", "tp"),
            (None, "tp"), bridge, dmesh, spc=self.spc, plane=self._plane)
        last = _reshard.report()["last"]
        wire = int(last["wire_bytes"])
        # the simulated DCN hop, when the fleet axis classifies as DCN
        if wire and simdcn.us_per_mib() > 0 and self._plane == "dcn":
            simdcn.charge(wire)
        if dst_slot is not None:
            payload = out[0]               # (1, rows, pg, hl, hd)
            didx = torch.as_tensor(cache._slot_pages[dst_slot],
                                   device=self._device)
            for li in range(L):
                cache.k[li].index_copy_(
                    1, didx, payload[:, li * npg:(li + 1) * npg])
                cache.v[li].index_copy_(
                    1, didx, payload[:, (L + li) * npg:(L + li + 1) * npg])
            cache.seq_lens[dst_slot] = prompt_len
        t1 = time.perf_counter()
        if serving.enabled:
            serving.note_migration(rid, src.idx, dst.idx, npg, wire,
                                   int(last["peak_bytes"]),
                                   int(last["bound_bytes"]), t1 - t0)
        if trace.enabled:
            trace.record_span("serve:migrate", "serve", t0, t1,
                              rank=dist.get_rank(),
                              args={"rid": rid, "src": src.idx,
                                    "dst": dst.idx, "pages": npg,
                                    "wire_bytes": wire,
                                    "seq_len": prompt_len})
        return dst_slot

    # -- the fleet run -----------------------------------------------------

    def run(self, requests: List[Request], *,
            eos_id: Optional[int] = None,
            spec_k: int = 0) -> Dict[str, Any]:
        """Admit one request stream across the fleet: the router assigns
        every request (in arrival order) to a serving/decode replica under
        the current effective weights, each replica drains its share on
        its own virtual clock (the fleet's makespan is the LARGEST replica
        clock), then the replicas' rows — shared from each replica's first
        rank — feed the fleet ledger and the router's goodput/ITL weights.
        Every process returns the whole fleet's result."""
        serving.set_fleet_replicas(len(self.replicas))
        for rep in self.replicas:
            # each run replays an independent stream whose arrivals
            # restart near t=0: the prefill lanes' clocks restart with it
            rep.clock = 0.0
            rep.prefills = 0
            rep.prefill_s = 0.0
        reqs = sorted(requests, key=lambda r: r.arrival)
        buckets: Dict[int, List[Request]] = {i: [] for i in
                                             self.serve_ids}
        for req in reqs:
            pick = self.serve_ids[self.router.assign(req.rid)]
            buckets[pick].append(req)
        # this process's loops, in the reference's order
        mine: Dict[int, Dict[str, Any]] = {}
        for i, t in enumerate(self.serve_ids):
            dec = self.replicas[t]
            if self.mode == "disaggregated":
                pre = self.replicas[
                    self.prefill_ids[i % len(self.prefill_ids)]]
                if self.me not in (pre.idx, t):
                    continue
                s: _ReplicaScheduler = _DisaggScheduler(
                    self, pre, dec, buckets[t], eos_id=eos_id)
            elif self.me == t:
                s = _ReplicaScheduler(dec, buckets[t], eos_id=eos_id,
                                      spec_k=spec_k)
            else:
                continue
            out = s.run()
            if self.me == t:
                mine[t] = {"out": out, "itl": s.itl,
                           "occupancy": s.occ_sum / max(s.decode_steps, 1)}
        lane = None
        if self.me in self.prefill_ids:
            own = self.replicas[self.me]
            lane = (own.prefills, own.prefill_s, own.clock)
        shared: List[Any] = [None] * dist.get_world_size()
        # comm-lint: disable=CL001 the fleet's agreement on its summary: one all-gather of each replica's host-side results after the run, where the reference reads them on its single controller; not decode traffic
        dist.all_gather_object(shared, (mine, lane))
        first = {r.idx: shared[r.ranks[0]] for r in self.replicas}
        results: Dict[Any, Dict[str, Any]] = {}
        itl_all: List[float] = []
        per_replica: List[Dict[str, Any]] = []
        total_tokens = 0
        total_steps = 0
        clock = 0.0
        for i, t in enumerate(self.serve_ids):
            got = first[t][0][t]
            out, itl = got["out"], got["itl"]
            results.update(out["results"])
            itl_all.extend(itl)
            total_tokens += out["tokens"]
            total_steps += out["decode_steps"]
            clock = max(clock, out["clock_s"])
            p99 = 1e3 * _percentile(itl, 0.99)
            row = {
                "replica": t, "role": self.replicas[t].role,
                "requests": len(buckets[t]),
                "tokens": out["tokens"],
                "decode_steps": out["decode_steps"],
                "clock_s": round(out["clock_s"], 6),
                "tokens_per_s": round(out["tokens_per_s"], 2),
                "occupancy": round(got["occupancy"], 4),
                "itl_p50_ms": round(1e3 * _percentile(itl, 0.50), 3),
                "itl_p99_ms": round(p99, 3),
            }
            per_replica.append(row)
            serving.update_replica(t, row)
            # live reweighting: goodput per unit tail latency
            self.router.update(i, out["tokens_per_s"], max(p99, 1e-3))
        for p in self.prefill_ids:
            pre = self.replicas[p]
            pre.prefills, pre.prefill_s, pre.clock = first[p][1]
            clock = max(clock, pre.clock)
            row = {"replica": p, "role": "prefill",
                   "prefills": pre.prefills,
                   "prefill_s": round(pre.prefill_s, 6),
                   "clock_s": round(pre.clock, 6)}
            per_replica.append(row)
            serving.update_replica(p, row)
        itl = sorted(itl_all)
        return {
            "mode": self.mode,
            "replicas": len(self.replicas),
            "tp": self.tp,
            "clock_s": clock,
            "completed": len(results),
            "tokens": total_tokens,
            "decode_steps": total_steps,
            "tokens_per_s": (total_tokens / clock) if clock else 0.0,
            "itl": {"count": len(itl),
                    "p50_ms": 1e3 * _percentile(itl, 0.50),
                    "p99_ms": 1e3 * _percentile(itl, 0.99)},
            "per_replica": per_replica,
            "results": results,
        }

    def check_hot_replicas(self, step: int = 0):
        """The reference's hot_replica sentry publishes on the policy bus,
        which comes with ROADMAP P16 (P16b)."""
        raise NotImplementedError(
            "ServingFleet.check_hot_replicas: the hot_replica sentry "
            "publishes on the policy bus, which comes with ROADMAP P16")


__all__ = ["ServingFleet"]
