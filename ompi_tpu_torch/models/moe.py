"""Mixture-of-Experts layer, einsum and ragged expert-parallel.

The port's copy of ``ompi_tpu/models/moe.py``.  Top-k routing with
capacity dropping (GShard/Switch): each expert takes at most
C = ceil(T·k·capacity_factor / E) tokens, first come first served in token
order, slot by slot; overflow tokens fall through on the residual stream.
The auxiliary load-balancing loss is E · Σ_e frac_e · mean_prob_e, frac_e
the share of all T·k dispatched slots.

* ``moe_block`` — the dense form: (T, E, C) one-hots contracted against
  the tokens (``torch.einsum``), the experts as one batched product.  This
  is what ``models/transformer`` differentiates in the one-card train
  step.  Where the reference leaves the one-hot to ``jax.nn.one_hot``
  (a zero row for a position past the capacity), the port compares the
  positions with ``arange(C)``, which gives the same zero row.
* ``moe_block_mesh`` — the same block on a dp×sp×ep×tp mesh (the mesh
  train step): the reference's GSPMD collectives written out inside
  autograd.  Each rank routes its own tokens, all-gathers the integer
  expert ids over the token axes (dp × sp) and runs ``moe_block``'s
  position loop on the whole batch, so the capacity, the slots and the
  drops are the one-card block's; its experts' (E/ep, C, d) inputs are
  its tokens' share summed over dp × sp, the gate and up products
  column-parallel over tp and the down product row-parallel, and the
  experts' outputs are all-gathered over ep for the combine.  The aux
  takes its means over the whole batch.
* ``ragged_ep_route`` / ``ragged_ep_combine`` — the dropless exchange over
  ``DeviceComm.row_gather`` + ``alltoallv_from_rows``.
* ``moe_block_ep`` — the capacity-dropping block on the ragged exchange,
  only the routed tokens on the wire, under the decided and audited coll
  names ``moe_dispatch``/``moe_combine`` with the arms native, hier (a
  same-outer-group lane and a cross-DCN lane) and hier+quant (the cross
  lane of the combine as int8 blocks, ``coll/quant``).

Layout of ``moe_block_ep``.  The reference holds the (R, t, d) tokens on R
devices and the (E, d, f) stacks sharded over the experts; row j owns
experts [j·epr, (j+1)·epr).  Each process of the port holds r = R/n rows
of the tokens (``DeviceComm``'s layout) and the r·epr experts those rows
own, whole: the stacks' leading dim is cut over the comm's processes
(``local_experts`` cuts them from the full stacks; the serving engine
reshards its tp shards into that layout once).  The routing plan needs
every row's expert ids, so each process all-gathers them (a few bytes a
token, the metadata the reference takes to the host), and the aux loss
sums the router's probabilities over the comm: both are the reference's
global values.  Rows may outnumber processes: one process can hold all R
(``make_mesh({"x": 1})``).

The audit is the reference's fan-out, one record an exchange:
``coll_arm_<arm>_count``, ``coll_wire_bytes``, the simulated-DCN charge
of the cross-plane bytes (``parallel/simdcn``), the perf sample of the
timed dispatch (``perf.note_sample``; the host's time to issue the
exchange, as ``perf.timed_coll`` times any collective), the traffic
edges weighted by the routing plan's per-(src, dst) token bytes (a hot
expert shows as a hot link) and one ``decide:moe_dispatch`` /
``decide:moe_combine`` event with the chain and the exchange's a2av plan.
The reference charges only outside a trace; the port has none, so every
call charges (ROADMAP, Departures: eager charging).  The routing outcome
feeds the MoE
plane (``ompi_tpu_torch.moe``), whose live capacity factor the block reads.
No kernel of the port runs here: the products are ``torch.matmul`` and
``torch.einsum``, as the reference left them to XLA.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import perf, trace, traffic
from ..core import var as _var
from ..device import DeviceLike, resolve_device
from ..parallel.collectives import _all_gather, copy_to, gather_from
from ..parallel import simdcn
from ..parallel.mesh import axis_size

# the dtypes the reference's combine takes as floating for its quantized
# lane (numpy's floating kinds: bfloat16 is not one of them there)
_QUANT_DTYPES = (torch.float16, torch.float32, torch.float64)


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, device: DeviceLike = None) -> Dict:
    """The reference's distributions (normal / sqrt(fan_in), f32), drawn
    on the generator's device in the order router, w_gate, w_up, w_down
    and then moved to ``device``."""
    dev = resolve_device(device)

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w / math.sqrt(fan_in)).to(dev)

    return {
        "router": dense(d_model, d_model, n_experts),
        "w_gate": dense(d_model, n_experts, d_model, d_ff),
        "w_up": dense(d_model, n_experts, d_model, d_ff),
        "w_down": dense(d_ff, n_experts, d_ff, d_model),
    }


def moe_param_specs() -> Dict:
    """Experts dim over ep; expert-internal features over tp (composes the
    Megatron column/row split with expert parallelism)."""
    return {
        "router": (),
        "w_gate": ("ep", None, "tp"),
        "w_up": ("ep", None, "tp"),
        "w_down": ("ep", "tp", None),
    }


def _route(probs: torch.Tensor, top_k: int):
    """Top-k gates (renormalised for k > 1; the raw top-1 probability for
    k == 1, Switch routing, which keeps the router on the task loss's
    gradient) and their expert ids."""
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    if top_k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return gate_vals, expert_idx


def _positions(expert_idx: torch.Tensor, n_experts: int,
               capacity: int) -> torch.Tensor:
    """Each (token, slot)'s place in its expert's buffer, (T, k) long: the
    slots earlier top-k rounds filled plus the earlier tokens of this
    round, in token order (the reference's ``used``/``cumsum`` loop).  A
    place at or past ``capacity`` is a drop, and fills no slot."""
    experts = torch.arange(n_experts, device=expert_idx.device)
    used = torch.zeros(n_experts, dtype=torch.long,
                       device=expert_idx.device)
    out = []
    for slot in range(expert_idx.shape[1]):
        e = expert_idx[:, slot]                                   # (T,)
        onehot_e = (e[:, None] == experts).long()                 # (T, E)
        pos_in_e = (torch.cumsum(onehot_e, dim=0) - 1) * onehot_e
        pos = pos_in_e.sum(dim=1) + used[e]                       # (T,)
        used = used + (onehot_e * (pos < capacity)[:, None]).sum(dim=0)
        out.append(pos)
    return torch.stack(out, dim=1)


def _slot_mask(e: torch.Tensor, pos: torch.Tensor, experts: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """(T, E, C) bool: token t holds slot c of expert e this round.  A
    dropped token's position matches no slot: a zero row, as
    ``jax.nn.one_hot`` gives it."""
    return ((e[:, None] == experts)[:, :, None]
            & (pos[:, None] == slots)[:, None, :])


def _capacity(tokens: int, top_k: int, capacity_factor: float,
              n_experts: int) -> int:
    return max(int(np.ceil(tokens * top_k * capacity_factor / n_experts)),
               top_k)


def moe_block(h: torch.Tensor, params: Dict, n_experts: int,
              top_k: int = 2, capacity_factor: float = 1.25,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (b, s, d) → (out (b, s, d), aux_loss scalar f32)."""
    b, s, d = h.shape
    t = b * s
    x = h.reshape(t, d)
    cd = h.dtype
    probs = torch.softmax(x.float() @ params["router"], dim=-1)   # (T, E)
    capacity = _capacity(t, top_k, capacity_factor, n_experts)
    gate_vals, expert_idx = _route(probs, top_k)                  # (T, k)
    pos = _positions(expert_idx, n_experts, capacity)             # (T, k)
    experts = torch.arange(n_experts, device=h.device)
    slots = torch.arange(capacity, device=h.device)
    dispatch = torch.zeros((t, n_experts, capacity), dtype=cd,
                           device=h.device)
    combine = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                          device=h.device)
    for slot in range(top_k):
        oh = _slot_mask(expert_idx[:, slot], pos[:, slot], experts, slots)
        dispatch = dispatch + oh.to(cd)
        combine = combine + torch.where(
            oh, gate_vals[:, slot, None, None], 0.0)
    ein = torch.einsum("tec,td->ecd", dispatch, x)                # (E, C, d)
    gate = F.silu(torch.einsum("ecd,edf->ecf", ein,
                               params["w_gate"].to(cd)))
    up = torch.einsum("ecd,edf->ecf", ein, params["w_up"].to(cd))
    eout = torch.einsum("ecf,efd->ecd", gate * up,
                        params["w_down"].to(cd))
    out = torch.einsum("tec,ecd->td", combine.to(cd), eout)
    frac = torch.bincount(expert_idx.reshape(-1), minlength=n_experts
                          ).float() / (t * top_k)
    aux = n_experts * torch.sum(frac * probs.mean(dim=0))
    return out.reshape(b, s, d), aux


# -- the einsum block on a dp×sp×ep×tp mesh -----------------------------------

def _global_ids(expert_idx: torch.Tensor, plan):
    """This rank's (b, s, k) expert ids → (every token's ids (T, k) in the
    one-card (b, s) order of the whole batch, the rows of this rank's
    tokens in it (t,)).  The ids are all-gathered over the token axes
    (dp × sp), whose group holds its members in the mesh's row-major
    order; they carry no gradient."""
    b, s, k = expert_idx.shape
    dev = expert_idx.device
    rows = ((plan.dp_rank * b + torch.arange(b, device=dev))[:, None]
            * (s * plan.sp)
            + plan.sp_rank * s + torch.arange(s, device=dev)[None, :])
    if plan.data is None:
        return expert_idx.reshape(-1, k), rows.reshape(-1)
    g = _all_gather(expert_idx, plan.data)            # (dp·sp, b, s, k)
    order = [a for a in plan.mesh.mesh_dim_names if a in ("dp", "sp")]
    g = g.reshape(plan.dp if order[0] == "dp" else plan.sp, -1, b, s, k)
    if order[0] == "sp":
        g = g.transpose(0, 1)                         # (dp, sp, b, s, k)
    g = g.reshape(plan.dp, plan.sp, b, s, k).permute(0, 2, 1, 3, 4)
    return g.reshape(-1, k), rows.reshape(-1)


def _dispatch_input(x: torch.Tensor, plan) -> torch.Tensor:
    """The dispatch's read of the block input, through *f* over ep.  Each
    ep rank's dispatch reads the tokens only for its own experts, so the
    input's cotangent from the dispatch is a sum over ep; the router's
    path, which every ep rank runs whole, takes the input directly."""
    return copy_to(x, "ep", plan.mesh) if plan.ep > 1 else x


def _combine_gather(eout: torch.Tensor, plan) -> torch.Tensor:
    """Every expert's (E, C, d) outputs from each ep rank's (E/ep, C, d).
    The tokens, and so the combine, are replicated over ep: every ep rank
    computes the same mixture, whose cotangent is the same on each, so
    the gather's backward is this rank's slice of it (``gather_from``),
    not a reduce-scatter, which would count each expert's gradient ep
    times."""
    return gather_from(eout, 0, "ep", plan.mesh) if plan.ep > 1 else eout


def moe_block_mesh(h: torch.Tensor, params: Dict, n_experts: int,
                   top_k: int, capacity_factor: float, plan,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_block`` on a mesh (``models/transformer._Plan``): h is this
    rank's (b, s, d) tokens, cut over dp (batch) and sp (sequence) and
    replicated over ep and tp; params the router (whole) and this rank's
    experts, (E/ep, d, f/tp) gate and up and (E/ep, f/tp, d) down
    (``moe_param_specs``).  Returns (this rank's (b, s, d) mixture,
    replicated over ep and tp; the aux over the whole batch, the same on
    every rank).  Collective over the mesh.

    The reference runs the single program under GSPMD, so this is what
    it computes: capacity C = ceil(T·k·cf/E) over the global T, each
    token's slot from the position loop over the whole batch in (b, s)
    order, and the aux's fraction and mean probability over the whole
    batch.  The ids are gathered; the gates stay local and
    differentiable."""
    b, s, d = h.shape
    t, cd = b * s, h.dtype
    x = h.reshape(t, d)
    probs = torch.softmax(x.float() @ params["router"], dim=-1)   # (t, E)
    gate_vals, expert_idx = _route(probs, top_k)                  # (t, k)
    everyone, mine = _global_ids(expert_idx.reshape(b, s, top_k), plan)
    T = everyone.shape[0]
    capacity = _capacity(T, top_k, capacity_factor, n_experts)
    pos = _positions(everyone, n_experts, capacity)[mine]         # (t, k)
    n_local = n_experts // plan.ep
    lo = plan.ep_rank * n_local
    experts = torch.arange(n_experts, device=h.device)
    slots = torch.arange(capacity, device=h.device)
    dispatch = torch.zeros((t, n_local, capacity), dtype=cd,
                           device=h.device)
    combine = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                          device=h.device)
    for slot in range(top_k):
        oh = _slot_mask(expert_idx[:, slot], pos[:, slot], experts, slots)
        dispatch = dispatch + oh[:, lo:lo + n_local].to(cd)
        combine = combine + torch.where(
            oh, gate_vals[:, slot, None, None], 0.0)
    # this rank's tokens' share of its experts' inputs (E/ep, C, d); every
    # slot belongs to one token, so the sum over dp × sp (*g*) completes
    # them.  Its backward is the identity, not a second sum: the expert
    # FFN is row-wise and a rank's combine reads only its tokens' slots,
    # so the cotangent of rank i's expert inputs is nonzero only on rank
    # i's slots, the ones its dispatch wrote
    ein = plan.data_sum(torch.einsum("tec,td->ecd", dispatch,
                                     _dispatch_input(x, plan)))
    # the experts: gate and up column-parallel over tp (*f* first), down
    # row-parallel (*g* after)
    ein = plan.to_tp(ein)
    gate = F.silu(torch.einsum("ecd,edf->ecf", ein,
                               params["w_gate"].to(cd)))
    up = torch.einsum("ecd,edf->ecf", ein, params["w_up"].to(cd))
    eout = plan.from_tp(torch.einsum("ecf,efd->ecd", gate * up,
                                     params["w_down"].to(cd)))
    out = torch.einsum("tec,ecd->td", combine.to(cd),
                       _combine_gather(eout, plan))
    # the aux over the whole batch: the fraction from every token's ids,
    # the mean probability from the probabilities summed over dp × sp
    # (*g*: each rank's backward carries its own tokens' share, and the
    # gradient sync over dp × sp adds the shares)
    frac = torch.bincount(everyone.reshape(-1), minlength=n_experts
                          ).float() / everyone.numel()
    mean_probs = plan.data_sum(probs.sum(dim=0)) / T
    aux = n_experts * torch.sum(frac * mean_probs)
    return out.reshape(b, s, d), aux


# -- dropless routing over the ragged device exchange -------------------------

def ragged_ep_route(dc, tokens: torch.Tensor, owner: np.ndarray):
    """Route tokens to their owning EP rank, dropless.

    tokens: this process's rows (r, T, d) of the canonical (R, T, d)
    layout; owner: host int array (R, T), owner[i, t] ∈ [0, R) the rank
    whose experts serve token t of rank i.

    Returns (recv, recv_counts, ctx): recv is this process's rows of the
    padded (R, cap_out, d) — row j holds recv_counts[j] tokens ordered by
    (source rank, source order); ctx is what ragged_ep_combine needs."""
    owner = np.asarray(owner)
    R, T = owner.shape
    C = np.stack([np.bincount(owner[i], minlength=R) for i in range(R)])
    # one stable sort a row puts every rank's sends dense in destination
    # order: alltoallv_from_rows' send layout
    orders = np.argsort(owner, axis=1, kind="stable")
    sorted_tokens = dc.row_gather(tokens, orders.astype(np.int32))
    recv, recv_counts = dc.alltoallv_from_rows(sorted_tokens, C)
    return recv, recv_counts, {"C": C, "owner": owner, "orders": orders}


def ragged_ep_combine(dc, outputs: torch.Tensor, ctx) -> torch.Tensor:
    """Inverse route: expert outputs in ragged_ep_route's padded layout
    back to (r, T, d) in the original token order (the exchange over the
    transposed counts, then the route's sort undone)."""
    C, owner = ctx["C"], ctx["owner"]
    R, T = owner.shape
    returned, _ = dc.alltoallv_from_rows(outputs, C.T)
    order = np.empty((R, T), np.int32)
    rows = np.arange(R)[:, None]
    order[rows, ctx["orders"]] = np.arange(T, dtype=np.int32)[None, :]
    return dc.row_gather(returned, order)


# -- moe_block_ep -------------------------------------------------------------

def _all_rows(dc, x: torch.Tensor) -> torch.Tensor:
    """Every process's rows (r, *e) → all R rows (R, *e), on the device."""
    if dc.n == 1:
        return x
    return _all_gather(x, dc.group).reshape((-1,) + tuple(x.shape[1:]))


def local_experts(params: Dict, dc) -> Dict:
    """This process's block of full (E, …) expert stacks over ``dc``'s
    processes (the router stays whole): the layout ``moe_block_ep``
    takes.  Local slices, zero wire."""
    def cut(w):
        n = w.shape[0] // dc.n
        return w[dc.pos * n:(dc.pos + 1) * n].clone()
    return {"router": params["router"],
            **{k: cut(params[k]) for k in ("w_gate", "w_up", "w_down")}}


def _router_fwd(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The router on this process's rows (r, t, d): probabilities, gates
    and expert ids, the formulas of ``moe_block``."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)           # (r, t, E)
    gate_vals, expert_idx = _route(probs, top_k)                   # (r, t, k)
    return probs, gate_vals, expert_idx


def _router_aux(dc, probs: torch.Tensor, eid: np.ndarray,
                n_experts: int) -> torch.Tensor:
    """The load-balance aux over ALL R·t tokens: frac from the gathered
    (R, t, k) expert ids, the mean probability from the comm's sum of
    every row's."""
    R, t, k = eid.shape
    psum = dc.allreduce(probs.sum(dim=1))[0] if dc.n > 1 \
        else probs.sum(dim=(0, 1))
    counts = np.bincount(eid.reshape(-1), minlength=n_experts)
    frac = torch.as_tensor(counts, dtype=torch.float32,
                           device=probs.device) / (R * t * k)
    return n_experts * torch.sum(frac * (psum / (R * t)))


def _expert_ffn(xbuf: torch.Tensor, e_local: torch.Tensor, wg, wu, wd,
                epr: int) -> torch.Tensor:
    """Per-local-expert silu-gated FFN over a padded receive buffer.

    xbuf: (r, L, d), row j the tokens routed to rank j's experts; e_local
    (r, L): the local expert of each slot (−1 = padding, which no mask
    selects, so pads stay zero); w*: (r, epr, …), row j rank j's experts."""
    cd = xbuf.dtype
    out = torch.zeros_like(xbuf)
    for le in range(epr):
        m = (e_local == le)[..., None].to(cd)
        xin = xbuf * m
        g = F.silu(torch.einsum("rld,rdf->rlf", xin, wg[:, le].to(cd)))
        u = torch.einsum("rld,rdf->rlf", xin, wu[:, le].to(cd))
        out = out + torch.einsum("rlf,rfd->rld", g * u,
                                 wd[:, le].to(cd)) * m
    return out


def _gate_combine(slot_out: torch.Tensor, gate_vals: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """(r, t, k, d) slot outputs × gates × keep mask → the (r, t, d)
    expert mixture (dropped slots contribute zero)."""
    w = (gate_vals * keep.float())[..., None]
    return torch.sum(slot_out.float() * w, dim=2).to(slot_out.dtype)


def _outer_groups(dc, kinds: Dict[str, str], r: int) -> np.ndarray:
    """Per-row DCN-slab group id over the comm (a process's coordinates on
    every DCN-classified axis of the comm, row-major; its r rows share
    it).  All zero on a single-plane comm."""
    axes = simdcn.axis_tuple(dc.axis)
    sizes = [axis_size(dc.mesh, a) for a in axes]
    coords = np.stack(np.unravel_index(np.arange(dc.n), sizes), axis=1)
    g = np.zeros(dc.n, np.int64)
    for dim, a in enumerate(axes):
        if kinds.get(a) == "dcn":
            g = g * sizes[dim] + coords[:, dim]
    return np.repeat(g, r)


def _decide_moe_coll(dc, coll: str, nbytes: int, dtype, quant_ok: bool,
                     kinds: Dict[str, str], ndev: int
                     ) -> Tuple[str, str, List[str]]:
    """Decision over ``coll/nccl.decide_mode`` for the moe coll names: the
    force variables (``coll_nccl_moe_dispatch_mode`` /
    ``coll_nccl_moe_combine_mode`` / the blanket), DEVICE_RULES rows, with
    hier eligibility from the comm's own axis classification.  A forced
    hier+quant on the dispatch decays to hier (its payloads are never
    quantized); a per-entry force of an impossible one raises."""
    from ..coll.nccl import _load_device_rules, decide_mode
    from ..parallel.hierarchy import hier_axes
    inner, _outer, why = hier_axes(dc.mesh, dc.axis, kinds)
    hier_ok = inner is not None
    plane = "dcn" if any(kinds.get(a) == "dcn"
                         for a in simdcn.axis_tuple(dc.axis)) else "ici"
    ent = str(_var.get(f"coll_nccl_{coll}_mode", "") or "")
    eff = ent or str(_var.get("coll_nccl_mode", "") or "")
    if coll == "moe_dispatch" and eff == "hier+quant":
        if hier_ok:
            src = f"coll_nccl_{coll}_mode" if ent else "coll_nccl_mode"
            return ("hier",
                    f"force:{src}=hier+quant (dispatch has no "
                    "quantized lane; took hier)", [])
        if ent:
            raise ValueError(
                f"coll_nccl_{coll}_mode forces hier+quant but the comm "
                f"is ineligible: {why}")
    return decide_mode(coll, int(nbytes), ndev, dc.device.type,
                       _load_device_rules(), ("native",),
                       quant_ok=quant_ok, dtype=dtype, op=None,
                       plane=plane, hier_ok=hier_ok, hier_why=why or "")


def _audit_moe_coll(dc, coll: str, arm: str, reason: str, chain: List,
                    wire: int, W: np.ndarray, cross_bytes: int,
                    nbytes: int, dtype, dur_s: float,
                    extra: Dict[str, Any]) -> None:
    """ONE audit record per moe collective, the reference's fan-out: the
    arm and wire pvars, the simulated-DCN charge of the cross-slab lane,
    the timed perf sample, the traffic edges weighted by the REAL
    per-(src, dst) token bytes ``W`` (R × R over the rows; folded to the
    processes when one holds several rows) and the trace decision event
    with the chain and the a2av plan."""
    spc = dc.spc
    if spc is not None:
        spc.inc(f"coll_arm_{arm}_count")
        spc.inc("coll_wire_bytes", int(wire))
    if simdcn.us_per_mib() > 0 and cross_bytes > 0:
        simdcn.charge(int(cross_bytes))
    if perf.enabled:
        perf.note_sample(coll, arm, int(wire), dur_s, dc.n)
    if traffic.enabled:
        n = dc.n
        r = W.shape[0] // n
        if r > 1:
            W = W.reshape(n, r, n, r).sum(axis=(1, 3))
        traffic.note_coll(dc, coll, arm, int(wire), weights=W, hier=None)
    if trace.enabled:
        from ..coll.quant import _dtype_name
        trace.decision(coll, arm=arm, reason=reason, verdict=None,
                       nbytes=int(nbytes), rank=dist.get_rank(),
                       dtype=_dtype_name(dtype), ndev=dc.n, wire_bytes=int(wire),
                       chain=list(chain), **extra)


def _a2av_extra(dc, plan: Dict[str, Any], inner: int,
                outer: int) -> Dict[str, Any]:
    """The decision event's plan fields: the a2av slice plan the last
    exchange took (``DeviceComm._last_a2av``) and the routing counts."""
    a2av = dict(dc._last_a2av or {})
    return {"a2av_slice_cap": a2av.get("slice_cap"),
            "a2av_scan_steps": a2av.get("scan_steps"),
            "routed_tokens": plan["routed"],
            "dropped_tokens": plan["dropped"],
            "moe_inner_bytes": inner, "moe_outer_bytes": outer}


def _route_plan(expert_idx: np.ndarray, n_experts: int, epr: int,
                capacity: int) -> Dict[str, Any]:
    """Host routing plan from the (R, t, k) expert assignment: global
    per-expert capacity (first come in flat rank-major, token-major
    order), each rank's send order a stable sort by global expert id
    (owner-monotone: dense in destination order), the counts matrix."""
    eid = np.asarray(expert_idx)
    R, t, k = eid.shape
    flat = eid.reshape(R, t * k)
    keep = np.ones((R, t * k), bool)
    conc = flat.reshape(-1)
    kflat = keep.reshape(-1)
    for e in range(n_experts):
        sel = np.flatnonzero(conc == e)
        if len(sel) > capacity:
            kflat[sel[capacity:]] = False
    owner = flat // epr
    C = np.zeros((R, R), np.int64)
    send_slots: List[np.ndarray] = []
    for i in range(R):
        ks = np.flatnonzero(keep[i])
        order = ks[np.argsort(flat[i, ks], kind="stable")]
        send_slots.append(order)
        C[i] = np.bincount(owner[i, order], minlength=R)
    loads = np.bincount(conc[kflat], minlength=n_experts)
    return {"flat": flat, "keep": keep, "owner": owner, "C": C,
            "send_slots": send_slots, "loads": loads,
            "routed": int(keep.sum()), "dropped": int((~keep).sum())}


def _lane_arrays(plan: Dict[str, Any], sel_fn: Callable, k: int, epr: int,
                 bucket: Callable) -> Optional[Dict[str, Any]]:
    """Per-lane host maps for one ragged exchange: the lane's counts
    matrix, the send token-index map (row_gather), the receiver's
    local-expert map, and the inverse map that puts returned outputs back
    on their (token, slot).  ``sel_fn(i, owners)`` masks which of rank
    i's sends ride this lane.  None when the lane is empty this step."""
    flat, owner = plan["flat"], plan["owner"]
    R, tk = flat.shape
    sl = []
    C = np.zeros((R, R), np.int64)
    for i in range(R):
        s = plan["send_slots"][i]
        s = s[sel_fn(i, owner[i, s])]
        sl.append(s)
        C[i] = np.bincount(owner[i, s], minlength=R)
    if int(C.sum()) == 0:
        return None
    lmax = max(1, max(len(s) for s in sl))
    send_idx = np.full((R, lmax), -1, np.int32)
    inv = np.full((R, tk), -1, np.int32)
    for i in range(R):
        send_idx[i, :len(sl[i])] = sl[i] // k
        inv[i, sl[i]] = np.arange(len(sl[i]), dtype=np.int32)
    out_cap = bucket(int(C.sum(axis=0).max()))
    e_local = np.full((R, out_cap), -1, np.int32)
    fill = np.zeros(R, np.int64)
    for i in range(R):
        for j in range(R):
            seg = sl[i][owner[i, sl[i]] == j]
            n = len(seg)
            if n:
                e_local[j, fill[j]:fill[j] + n] = flat[i, seg] - j * epr
                fill[j] += n
    return {"C": C, "send_idx": send_idx, "inv": inv, "e_local": e_local}


@torch.no_grad()
def moe_block_ep(dc, h: torch.Tensor, params: Dict, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 step: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """The MoE block on the ragged expert-parallel exchange.

    h: this process's rows (r, t, d) of the canonical (R, t, d) layout
    over ``dc`` (R = r × dc.n); params: the router and this process's
    r·epr experts (``local_experts``), n_experts % R == 0, rank j owning
    experts [j·epr, (j+1)·epr).  Returns (this process's rows (r, t, d) of
    the expert mixture, the aux load-balance scalar over all R·t tokens,
    info).  Collective over ``dc``; not differentiated (the forward,
    eval and serving path, as in the reference).

    The routing is ``moe_block``'s: top-k, global per-expert capacity
    C = ceil(T·k·cf/E) with T = R·t, overflow dropped; only the routed
    tokens travel, via row_gather + alltoallv_from_rows under the decided
    and audited ``moe_dispatch``/``moe_combine``.  The capacity factor
    reads through ``ompi_tpu_torch.moe.capacity_factor`` and the step's
    per-expert loads go to ``moe.note_routing``."""
    from .. import moe as _moe
    r, t, d = h.shape
    R = r * dc.n
    if n_experts % R:
        raise ValueError(f"moe_block_ep: n_experts {n_experts} not "
                         f"divisible by the comm's {R} rows")
    epr = n_experts // R
    if params["w_gate"].shape[0] != r * epr:
        raise ValueError(
            f"moe_block_ep: this process holds {params['w_gate'].shape[0]} "
            f"experts; its {r} rows own {r * epr} (local_experts)")
    cf_eff = _moe.capacity_factor(capacity_factor)
    probs, gate_vals, expert_idx = _router_fwd(h, params["router"], top_k)
    eid = _all_rows(dc, expert_idx).cpu().numpy()                 # (R, t, k)
    aux = _router_aux(dc, probs, eid, n_experts)
    capacity = _capacity(t * R, top_k, cf_eff, n_experts)
    plan = _route_plan(eid, n_experts, epr, capacity)
    tok_bytes = d * h.element_size()
    kinds = dc.axis_kinds()
    g = _outer_groups(dc, kinds, r)
    offdiag = ~np.eye(R, dtype=bool)
    cross = g[:, None] != g[None, :]          # the row pair crosses DCN
    payload = plan["routed"] * tok_bytes // max(R, 1)

    # -- dispatch: token payloads to their owning expert rank -------------
    arm_d, reason_d, chain_d = _decide_moe_coll(
        dc, "moe_dispatch", payload, h.dtype, False, kinds, R)
    lanes: List[Tuple[str, Dict[str, Any]]] = []
    if arm_d in ("hier", "hier+quant"):
        for lname, sel in (("inner", lambda i, ow: g[ow] == g[i]),
                           ("outer", lambda i, ow: g[ow] != g[i])):
            ln = _lane_arrays(plan, sel, top_k, epr, dc._bucket)
            if ln is not None:
                lanes.append((lname, ln))
    else:
        ln = _lane_arrays(plan, lambda i, ow: np.ones(len(ow), bool),
                          top_k, epr, dc._bucket)
        if ln is not None:
            lanes.append(("all", ln))
    t0 = time.perf_counter()
    recvs = []
    for lname, ln in lanes:
        sendbuf = dc.row_gather(h, ln["send_idx"])
        recv, _cnt = dc.alltoallv_from_rows(sendbuf, ln["C"])
        recvs.append((lname, ln, recv))
    dur_d = time.perf_counter() - t0
    Wd = plan["C"] * tok_bytes
    wire_d = int(Wd[offdiag].sum())
    inner_d = int(Wd[offdiag & ~cross].sum())
    outer_d = wire_d - inner_d
    _audit_moe_coll(dc, "moe_dispatch", arm_d, reason_d, chain_d, wire_d,
                    Wd, outer_d, payload, h.dtype, dur_d,
                    _a2av_extra(dc, plan, inner_d, outer_d))

    # -- the experts on each lane's receive buffer ------------------------
    wg = params["w_gate"].reshape(r, epr, d, -1)
    wu = params["w_up"].reshape(r, epr, d, -1)
    wd = params["w_down"].reshape(r, epr, -1, d)
    outs = [(lname, ln, _expert_ffn(recv, dc.from_ranks(list(ln["e_local"])),
                                    wg, wu, wd, epr))
            for lname, ln, recv in recvs]

    # -- combine: expert outputs back to their (token, slot) --------------
    arm_c, reason_c, chain_c = _decide_moe_coll(
        dc, "moe_combine", payload, h.dtype, h.dtype in _QUANT_DTYPES,
        kinds, R)
    block = int(_var.get("coll_quant_block", 256))
    block = block if block and d % block == 0 else d
    qtok_bytes = d + (d // block) * 4            # int8 + an f32 scale a block
    t1 = time.perf_counter()
    slot_sum = None
    for lname, ln, obuf in outs:
        if arm_c == "hier+quant" and lname == "outer":
            from ..coll.quant import dequantize_blocks, quantize_blocks
            q, scale = quantize_blocks(obuf, block)
            q_ret, _ = dc.alltoallv_from_rows(q, ln["C"].T)
            s_ret, _ = dc.alltoallv_from_rows(scale, ln["C"].T)
            returned = dequantize_blocks(q_ret, s_ret, block, dtype=h.dtype)
        else:
            returned, _ = dc.alltoallv_from_rows(obuf, ln["C"].T)
        back = dc.row_gather(returned, ln["inv"])          # (r, t·k, d)
        slot_sum = back if slot_sum is None else slot_sum + back
    if slot_sum is None:
        slot_sum = h.new_zeros((r, t * top_k, d))
    dur_c = time.perf_counter() - t1
    CT = plan["C"].T
    Wc = CT * tok_bytes
    if arm_c == "hier+quant":
        Wc = np.where(cross, CT * qtok_bytes, Wc)
    wire_c = int(Wc[offdiag].sum())
    inner_c = int(Wc[offdiag & ~cross].sum())
    outer_c = wire_c - inner_c
    _audit_moe_coll(dc, "moe_combine", arm_c, reason_c, chain_c, wire_c,
                    Wc, outer_c, payload, h.dtype, dur_c,
                    _a2av_extra(dc, plan, inner_c, outer_c))

    keep = dc.from_ranks(list(plan["keep"].reshape(R, t, top_k)))
    out = _gate_combine(slot_sum.reshape(r, t, top_k, d), gate_vals, keep)

    # -- the routing plane: this step's skew is the next step's cf --------
    verdict = _moe.note_routing(plan["loads"], routed=plan["routed"],
                                dropped=plan["dropped"], step=step)
    info = {"routed_tokens": plan["routed"],
            "dropped_tokens": plan["dropped"],
            "capacity": capacity, "capacity_factor": cf_eff,
            "expert_load": plan["loads"].tolist(),
            "dispatch": {"arm": arm_d, "wire_bytes": wire_d,
                         "inner_bytes": inner_d, "outer_bytes": outer_d},
            "combine": {"arm": arm_c, "wire_bytes": wire_c,
                        "inner_bytes": inner_c, "outer_bytes": outer_c},
            "verdict": verdict}
    return out, aux, info
