"""coll/nccl — NCCL device collectives for the MPI-style comm API.

The component the whole design exists for (BASELINE.json north_star): when a
collective's buffers are device-resident (CUDA tensors), dispatch to NCCL
collectives over the communicator's device mesh (``DeviceComm``) instead of
staging device→host like the reference's coll/accelerator shim
(ompi/mca/coll/accelerator/coll_accelerator_allreduce.c:31-60). Host (numpy)
buffers fall through to the host algorithms (coll/tuned) — the same
buffer-type dispatch the reference does with accelerator.check_addr
(accelerator.h:171), with the fast path inverted: device is native here,
host is the staged case.

Selection: query() succeeds only for communicators with an attached device
mesh (``parallel.attach_mesh(comm, mesh, axis)``); priority 80 outranks
self(75)/tuned(30)/basic(10), which is how the north star requires the
device component to win for device buffers.

Layout: as ``DeviceComm``, every entry takes this process's rows of the
JAX package's canonical (R, *elem) array and returns this process's rows
of its result (R = rows × processes; one process holding all R rows is the
single-card regime).

Arms: ``native`` is the DeviceComm method (one NCCL collective, gloo on the
CPU tests' plane); ``staged`` is an explicit D2H of this process's rows,
the rows of the other processes over the host algorithms (tuned's
allgather on the same communicator; nothing crosses in a world of one),
the numpy fold and an H2D — counted in ``device_stage_out_bytes``,
``device_stage_in_bytes`` and ``coll_staged_fallbacks``; ``quant`` is the
block-quantized tier (``coll/quant``, ``DeviceComm.quant``) for float
SUM/AVG reductions and allgather; ``hier`` and ``hier+quant`` are the
two-tier HAN allreduce (``parallel/hierarchy``: reduce-scatter over the
inner level, allreduce over the outer one on the scattered 1/n_inner,
quantized for ``hier+quant``, allgather over the inner level), eligible
on a comm whose tuple of axes spans a fast and a slow level.  The
learned rules source (P18) is a later slice: where the JAX package would
read it, the port raises ``NotImplementedError`` naming the slice.  Each
dispatch leaves one audit record: ``coll_arm_<arm>_count`` and
``coll_wire_bytes`` in the context's spc, the simulated-DCN charge
(``parallel/simdcn``) when the shim is on, then, each behind its plane's
one flag, the executed arm and wire bytes for the perf cost model
(``perf.note_arm``), the per-edge attribution of the same wire figure
(``traffic.note_coll``) and ONE ``decide:<coll>`` trace event with the
precedence chain.  Every process of the comm records its own event
(``rank`` = its world rank; ``shape`` its own rows), where the JAX
package's single controller records one for the mesh.

The port of ``ompi_tpu/coll/xla.py`` (decision layer, native and staged
arms, audit).  The neighbourhood entries raise until communicator
topologies come (``topo.cart_create``, ROADMAP P7, what waits).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import accelerator
from ..analysis import rules as _rules_grammar
from ..core import var as _var
from ..core.component import Component, component
from ..op import SUM, Op, quantizable
from .framework import CollModule
from .quant import _dtype_name, _itemsize, check_quantizable, wire_bytes
from .tuned import TunedModule


def _is_device(x) -> bool:
    return accelerator.check_addr(x) is not None


# -- device decision layer (≙ coll_tuned_decision_fixed.c:55-104 +
#    coll_tuned_dynamic_file.c:58, applied to the DEVICE path) --------------
#
# The host components pick an algorithm per (comm size, msg size); the
# device component picks a MODE per (collective, device count, msg size):
# "native" runs the NCCL collective, "staged" takes the explicit D2H → host
# op → H2D round trip (the coll/accelerator shim as a *measured choice*,
# not a fallback).  The fixed defaults are the JAX package's: on the CPU
# test fabric dense alltoall below 32 MB a rank is staged, every other
# entry native; on the card staging crosses the host bridge, so native
# always wins.

_var.register("coll", "nccl", "mode", "", type=str, level=3,
              help="Force device-collective mode for every entry: "
                   "native|staged|quant|hier|hier+quant (empty = "
                   "per-entry decision; quant/hier apply to entries "
                   "with that arm, others keep the auto decision).")
_var.register("coll", "nccl", "dynamic_rules", "", type=str, level=4,
              help="Path to a device decision rules file: lines of "
                   "'<coll>[@<plane>] <min_ndev> <min_bytes> "
                   "<native|staged|quant|bidir|hier|hier+quant>' "
                   "(plane in {ici,dcn}; plane-keyed rows beat plain "
                   "rows on comms spanning that plane).")
# the blanket quantization switch (env OMPI_TPU_COLL_QUANT), read by the
# decision chain exactly as the JAX package reads it
_var.register("COLL_QUANT", "", "", "", type=str, level=2,
              help="Blanket switch for the block-quantized device tier: "
                   "on/force | off | empty (rules decide).")
_var.register("coll", "quant", "min_bytes", 1 << 20, type=int, level=3,
              help="Per-rank byte floor below which rule-selected quant "
                   "keeps the exact arm.")
_var.register("coll", "nccl", "rules", "", type=str, level=3,
              help="Arm-selection source: empty/'static' = platform "
                   "default + DEVICE_RULES rows; 'learned' = the perf "
                   "cost-model ledger (ROADMAP P18).")

_DECIDED = ("allreduce", "reduce", "bcast", "allgather", "alltoall",
            "reduce_scatter_block", "scan", "exscan", "allgatherv",
            "gather", "gatherv", "scatter", "scatterv", "alltoallv",
            "reduce_scatter")
# entries with a quantized arm in the JAX package
_QUANT_COLLS = ("allreduce", "reduce_scatter_block", "reduce_scatter",
                "allgather", "grad_sync", "decode_ag", "decode_rs")
for _c in _DECIDED:
    _var.register("coll", "nccl", f"{_c}_mode", "", type=str, level=3,
                  help=f"Force the {_c} device mode (native|staged"
                       + ("|quant" if _c in _QUANT_COLLS else "")
                       + "; empty = auto).")
# the overlap tier's decision points (not NcclModule entries): the bucketed
# gradient sync (parallel/overlap) and the collective-matmul ring direction
# (ops/collective_matmul via Config(tp_overlap="fused"))
_var.register("coll", "nccl", "grad_bucket_bytes", 4 << 20, type=int,
              level=3,
              help="Target bytes per gradient-sync bucket for the "
                   "bucketed overlap tier (parallel/overlap): grads are "
                   "flattened into fixed-byte buckets in reverse-layer "
                   "order and each bucket allreduces as soon as its "
                   "leaves are produced in the backward pass.")
_var.register("coll", "nccl", "grad_sync_mode", "", type=str, level=3,
              help="Force the gradient-sync bucket arm (native|quant|"
                   "hier|hier+quant; empty = auto via DEVICE_RULES "
                   "grad_sync rows).")
_var.register("coll", "nccl", "collmm_mode", "", type=str, level=3,
              help="Force the collective-matmul ring schedule "
                   "(native = unidirectional ring | bidir = two "
                   "half-rings in both ring directions; empty = auto "
                   "via DEVICE_RULES collmm rows).")
# the reshard plan steps (parallel/reshard) and the serving tier's decode
# combines (serving/engine): decided by coll name, not NcclModule entries
_var.register("coll", "nccl", "reshard_mode", "", type=str, level=3,
              help="Force the reshard plan-step arm (native; empty = "
                   "auto via DEVICE_RULES reshard rows). Plan steps are "
                   "layout-pure single collectives, so native is the "
                   "only executable arm.")
_var.register("coll", "nccl", "decode_ag_mode", "", type=str, level=3,
              help="Force the serving decode allgather arm (native|"
                   "quant; empty = auto via DEVICE_RULES decode_ag "
                   "rows): every decode-path feature combine plus the "
                   "logits-sum gather half.")
_var.register("coll", "nccl", "decode_rs_mode", "", type=str, level=3,
              help="Force the serving decode reduce-scatter arm "
                   "(native|quant; empty = auto via DEVICE_RULES "
                   "decode_rs rows): the logits-sum reduce half.")
_var.register("coll", "nccl", "moe_dispatch_mode", "", type=str, level=3,
              help="Force the MoE token-dispatch exchange arm (native|"
                   "hier|hier+quant; empty = auto via DEVICE_RULES "
                   "moe_dispatch rows). hier splits the ragged exchange "
                   "into same-outer-group and cross-DCN lanes; dispatch "
                   "payloads are never quantized (hier+quant decays to "
                   "hier here).")
_var.register("coll", "nccl", "moe_combine_mode", "", type=str, level=3,
              help="Force the MoE expert-output combine exchange arm "
                   "(native|hier|hier+quant; empty = auto via "
                   "DEVICE_RULES moe_combine rows). hier+quant sends "
                   "the cross-DCN lane as int8 blocks; the same-group "
                   "lane stays full precision.")

_MODES = _rules_grammar.MODES
_PLANES = _rules_grammar.PLANES

# the rules source a later slice brings, by name
_LACKING = {
    "learned": "coll_nccl_rules=learned reads the perf cost model, which "
               "comes with ROADMAP P18",
}


def _load_device_rules(path: Optional[str] = None):
    """Parse a device decision rules file into (coll, min_ndev,
    min_bytes, mode) rows.  With no argument the configured
    ``coll_nccl_dynamic_rules`` path is read (the dispatch-time caller);
    an explicit path serves offline consumers — the trace analyzer's
    decision-drift check re-evaluates audited arms against any rules
    file, e.g. the repo's DEVICE_RULES.txt.

    The coll column may be plane-keyed: ``<coll>@<plane>`` (plane in
    {ici, dcn}) rows apply only to communicators whose axes include
    that plane and BEAT plain rows for the same coll at decision time
    (decide_mode's two-lane rule walk).  An unknown plane is a loud
    ValueError — a typo must not silently deactivate a row.  Parsing
    is delegated to ``analysis.rules`` (the grammar module CI shares),
    which also rejects an exactly-duplicated
    ``(coll[@plane], min_ndev, min_bytes)`` key naming both lines —
    before that validator the later row silently won the rule walk."""
    if path is None:
        path = _var.get("coll_nccl_dynamic_rules", "")
    if not path:
        return []
    return _rules_grammar.parse_file(path)


def _quant_pads_past_native(coll: str, nbytes: int, ndev: int,
                            dtype) -> bool:
    """True when the quantized arm's block padding pushes its wire bytes
    past the native arm's for this payload (the per-rank shard pads up to
    ``coll_quant_block`` elements before the int8 cast): the decision
    records ``ineligible:quant:pad-past-native`` instead of shipping more
    bytes than native would.  With no dtype it never vetoes."""
    if dtype is None:
        return False
    try:
        count = max(int(nbytes) // _itemsize(dtype), 1)
        qcoll = ("allreduce" if coll == "allreduce" else
                 "reduce_scatter" if ("reduce_scatter" in coll
                                      or coll.endswith("_rs"))
                 else "allgather")
        wb = wire_bytes(qcoll, count, max(int(ndev), 1), dtype)
    except (ValueError, TypeError, KeyError):
        return False     # no quant wire model for this coll/dtype
    return wb["quant_bytes"] > wb["native_bytes"]


def decide_mode(coll: str, nbytes: int, ndev: int, platform: str,
                rules, allowed, quant_ok: bool = False,
                dtype=None, op: Op = None, plane: Optional[str] = None,
                hier_ok: bool = False, hier_why: str = "") -> tuple:
    """The device decision-precedence chain, the JAX package's
    ``coll/xla.decide_mode`` with the ``coll_nccl_*`` variables: given the
    same arguments it returns the same (arm, reason, chain), with
    ``platform`` the device type (``"cuda"`` decides as every non-CPU
    platform there).  The ``learned`` rules source raises here.  The
    chain is returned as (arm, reason, chain): per-entry force var >
    blanket coll_nccl_mode > blanket COLL_QUANT > platform default, then
    DEVICE_RULES rows (later lines win; quant rows vetoed by the off
    switch, the coll_quant_min_bytes floor, or op/dtype/layout
    ineligibility).  ``reason`` is the link that decided; ``chain``
    records every vetoed/skipped link so trace.explain_last can show the
    full evaluation.

    ``allowed`` is the set of arms the calling entry can actually execute
    for this buffer/op — the decision never names an arm the entry would
    silently ignore.  NcclModule dispatches funnel through here (via
    ``_mode``); in the JAX package the overlap tier calls it directly with
    the coll names ``grad_sync`` and ``collmm`` (P9).

    Two-tier extensions: ``plane`` is the calling comm's plane context
    ('dcn' when any comm axis crosses a DCN boundary, else 'ici') —
    ``<coll>@<plane>`` rule rows match only their plane and BEAT plain
    rows for the same coll (their vetoes included).  The hierarchical
    arms (hier, hier+quant) are gated by ``hier_ok`` instead of
    ``allowed``: an ineligible comm (flat mesh, single axis, non-sum
    op) records the audited ``ineligible:hier:<hier_why>`` veto, and an
    explicit per-entry force of an impossible hier raises."""
    chain: list = []
    qvar = str(_var.get("COLL_QUANT", "") or "").strip().lower()
    ent = _var.get(f"coll_nccl_{coll}_mode", "")
    forced = ent or _var.get("coll_nccl_mode", "")
    src = f"coll_nccl_{coll}_mode" if ent else "coll_nccl_mode"
    if forced:
        if forced not in _MODES:
            raise ValueError(
                f"coll_nccl mode for {coll!r} is {forced!r} "
                f"(want one of {', '.join(_MODES)})")
        if forced == "quant":
            if coll in _QUANT_COLLS:
                if "quant" in allowed:
                    # invalid op/dtype under an explicit quant force
                    # must fail loudly, not silently take the exact
                    # path
                    check_quantizable(op or SUM,
                                      dtype if dtype is not None
                                      else np.float32)
                    return "quant", f"force:{src}=quant", chain
                chain.append(f"force:{src}=quant skipped "
                             "(layout has no quantized arm)")
            elif ent:
                raise ValueError(
                    f"collective {coll!r} has no quantized arm "
                    f"(quant applies to {', '.join(_QUANT_COLLS)})")
            else:
                chain.append("force:coll_nccl_mode=quant skipped "
                             "(entry has no quantized arm)")
            # global quant force: entries without a quantized arm
            # keep the auto decision below
        elif forced in ("hier", "hier+quant"):
            if not hier_ok:
                if ent:
                    # a per-entry force of an impossible hier must fail
                    # loudly, not silently take the flat path
                    raise ValueError(
                        f"coll_nccl mode for {coll!r} forces {forced} "
                        f"but the comm is ineligible: {hier_why}")
                chain.append(f"force:{src}={forced} skipped "
                             f"(ineligible:hier:{hier_why})")
            elif forced == "hier+quant" and not quant_ok:
                if ent:
                    check_quantizable(op or SUM,
                                      dtype if dtype is not None
                                      else np.float32)
                chain.append(f"force:{src}={forced} skipped "
                             "(op/dtype has no quantized outer stage)")
            else:
                return forced, f"force:{src}={forced}", chain
        elif forced in allowed:
            return forced, f"force:{src}={forced}", chain
        else:
            chain.append(f"force:{src}={forced} skipped "
                         f"(no {forced} kernel for this op/layout)")
    q_ok = quant_ok and "quant" in allowed
    if qvar in ("1", "on", "true", "yes", "force"):
        if q_ok:
            return "quant", f"blanket:COLL_QUANT={qvar}", chain
        if coll in _QUANT_COLLS:
            chain.append(f"blanket:COLL_QUANT={qvar} skipped "
                         "(op/dtype/layout ineligible)")
    quant_off = qvar in ("0", "off", "false", "no")
    floor = int(_var.get("coll_quant_min_bytes", 1 << 20))
    source = str(_var.get("coll_nccl_rules", "") or "").strip().lower()
    if source == "learned":
        # the cost-model source reads the perf ledger, which the port
        # does not have yet
        raise NotImplementedError(_LACKING["learned"])
    if source and source != "static":
        raise ValueError(f"coll_nccl_rules is {source!r} "
                         "(want 'learned', 'static' or empty)")
    if platform == "cpu":
        # sweep-derived (BENCH_SWEEP_cpu_8dev.json): dense alltoall
        # staged wins 1KB-16MB/rank on the CPU fabric; all else native
        pick = "staged" if (coll == "alltoall"
                            and nbytes < (32 << 20)) else "native"
    else:
        pick = "native"       # staging crosses the host bridge
    if pick not in allowed:
        pick = "native"
    reason = f"default:platform={platform}"

    def _veto_of(mode: str, rule: str) -> Optional[str]:
        """Gates shared by plain and plane-keyed rows.  The quant floor
        deliberately does NOT veto hier+quant: only the scattered
        1/n_inner fraction is quantized there, so the flat-arm latency
        calculus behind the floor does not carry over."""
        if mode in ("quant", "hier+quant"):
            if quant_off:
                return f"off:COLL_QUANT={qvar} (vetoed {rule})"
            if not (q_ok if mode == "quant" else quant_ok):
                return f"ineligible:op/dtype/layout (vetoed {rule})"
            if mode == "quant" and nbytes < floor:
                return (f"floor:coll_quant_min_bytes={floor}"
                        f">{nbytes} (vetoed {rule})")
            if mode == "quant" and _quant_pads_past_native(
                    coll, nbytes, ndev, dtype):
                return (f"ineligible:quant:pad-past-native "
                        f"(block padding exceeds native bytes at "
                        f"{nbytes}B; vetoed {rule})")
        if mode in ("hier", "hier+quant") and not hier_ok:
            return f"ineligible:hier:{hier_why} (vetoed {rule})"
        return None

    # two-lane walk: plain rows accumulate as before; '<coll>@<plane>'
    # rows matching the comm's plane accumulate separately and override
    # the plain lane at the end (vetoes included — a vetoed plane row's
    # reason still beats a plain row's pick)
    p_pick: Optional[str] = None
    p_reason: Optional[str] = None
    for c, mn, mb, mode in rules:
        base_coll, _, row_plane = c.partition("@")
        if base_coll != coll or ndev < mn or nbytes < mb:
            continue
        if row_plane and row_plane != (plane or ""):
            continue
        rule = f"rule:{c} {mn} {mb} {mode}"
        veto = _veto_of(mode, rule)
        if veto is not None:
            # vetoed rule: keep the prior pick, but the veto IS the
            # deciding word unless a later rule overrides it
            chain.append(veto)
            if row_plane:
                p_reason = veto
            else:
                reason = veto
            continue
        if mode not in ("hier", "hier+quant") and mode not in allowed:
            chain.append(f"{rule} skipped (no {mode} kernel)")
            continue
        if row_plane:
            p_pick, p_reason = mode, rule
        else:
            pick, reason = mode, rule
        chain.append(rule)
    if p_reason is not None:
        reason = p_reason
    if p_pick is not None:
        pick = p_pick
    return pick, reason, chain


# numpy reduction kernels for the staged arm (standard MPI ops only; a
# custom op keeps the native path regardless of decision)
_NP_FOLD = {"sum": np.add.reduce, "max": np.maximum.reduce,
            "min": np.minimum.reduce, "prod": np.multiply.reduce}


def _staged_allgather(h: np.ndarray) -> np.ndarray:
    """Host allgather on the canonical layout (staged arm of both
    allgather and gather — MPI promises only the root's row for gather)."""
    flat = h.reshape((-1,) + h.shape[2:]) if h.ndim > 2 else h.reshape(-1)
    return np.broadcast_to(flat[None], (h.shape[0],) + flat.shape)


def _staged_allgatherv(h: np.ndarray, counts) -> np.ndarray:
    """Host allgatherv on the padded canonical layout (also the gatherv
    staged arm)."""
    cat = np.concatenate([h[i, :int(c)] for i, c in enumerate(counts)])
    return np.broadcast_to(cat[None], (h.shape[0],) + cat.shape)


class NcclModule(CollModule):
    def __init__(self, comm) -> None:
        from ..parallel.hierarchy import hier_axes
        self.dc = comm.device_comm
        self.dc.spc = getattr(comm.ctx, "spc", None)
        self.host = TunedModule(comm)   # fallback for host buffers
        self._comm = comm
        self._rules = _load_device_rules()
        self._platform = self.dc.device.type
        # two-tier context, fixed at attach: whether the comm's axes span
        # a fast inner and a slow outer level (the hier arms' eligibility),
        # and the plane that keys '<coll>@<plane>' rows
        self._kinds = comm.device_kinds
        self._plane = comm.device_plane
        self._hier_inner, self._hier_outer, self._hier_why = hier_axes(
            self.dc.mesh, self.dc.axis, kinds=self._kinds)

    @property
    def spc(self):
        return getattr(self._comm.ctx, "spc", None)

    # -- decision (native NCCL collective vs measured host staging) ---------

    _ALL_ARMS = ("native", "staged", "quant")

    def _mode(self, coll: str, x, op: Op = None,
              allowed=_ALL_ARMS, weights=None, extra=None) -> str:
        """Pick per (collective, PER-RANK bytes) with the JAX module's
        arguments, so the pick is the one the JAX package would make.
        Every device dispatch funnels through here exactly once: one audit
        record per collective.  ``weights`` (the alltoallv counts matrix)
        and ``extra`` (additional decision-event fields) ride to the
        audit."""
        rows = max(x.shape[0], 1)
        nbytes = x.numel() * x.element_size() // rows
        quant_ok = coll in _QUANT_COLLS and quantizable(op or SUM, x.dtype)
        hier_ok, hier_why = self._hier_eligible(coll, op)
        pick, reason, chain = decide_mode(
            coll, nbytes, self.dc.n, self._platform, self._rules, allowed,
            quant_ok=quant_ok, dtype=x.dtype, op=op, plane=self._plane,
            hier_ok=hier_ok, hier_why=hier_why)
        self._audit(coll, x, op, pick, reason, chain, nbytes,
                    weights=weights, extra=extra)
        return pick

    def _hier_eligible(self, coll: str, op: Op = None) -> tuple:
        """(ok, why-not) for the hierarchical arm on this entry: only
        allreduce has a hierarchical form, the comm must span a real
        two-tier axis split (``hier_axes``), and the stages are sums."""
        if coll != "allreduce":
            return False, "entry has no hierarchical kernel"
        if self._hier_inner is None:
            return False, self._hier_why
        if (op or SUM).name != "sum":
            return False, (f"op {(op or SUM).name} has no hierarchical "
                           "reduce (psum stages are sum-only)")
        return True, ""

    def _hier_wire(self, x, quant: bool) -> dict:
        """``hier_wire_bytes`` of one hierarchical allreduce of this
        rank's payload (a row of x)."""
        from ..parallel.hierarchy import hier_wire_bytes
        from ..parallel.mesh import axis_size
        rows = max(x.shape[0], 1)
        return hier_wire_bytes(
            max(x.numel() // rows, 1), x.dtype,
            axis_size(self.dc.mesh, self._hier_inner),
            axis_size(self.dc.mesh, self._hier_outer), quant=quant)

    # modeled wire-byte collectives: coll -> ring model name
    _WIRE_MODEL = {"allreduce": "allreduce",
                   "reduce_scatter_block": "reduce_scatter",
                   "reduce_scatter": "reduce_scatter",
                   "allgather": "allgather"}

    def _audit(self, coll: str, x, op: Op, arm: str, reason: str,
               chain: list, nbytes: int, weights=None, extra=None) -> None:
        """ONE audit record per device-dispatched collective: the arm count
        and the per-rank wire bytes (the HAN stage math for a hierarchical
        arm, coll/quant's ring model of the native or quantized arm where
        there is one, else the per-rank payload); then the simulated-DCN
        charge when the shim is on (a hierarchical arm pays its outer
        stage, a flat arm the DCN fraction of its ring's wire); then,
        each behind its plane's flag, the perf annotation, the traffic
        attribution of the same wire figure and the decision event."""
        from .. import perf, trace, traffic
        from ..parallel import simdcn
        wire = nbytes
        ratio = None
        hier_split = None
        model = self._WIRE_MODEL.get(coll)
        if arm in ("hier", "hier+quant"):
            # the HAN stage math is the wire model: inner RS + AG at
            # (ni-1)/ni each, outer allreduce on the scattered 1/ni
            # fraction (quantized for hier+quant)
            hw = self._hier_wire(x, quant=(arm == "hier+quant"))
            wire, ratio = hw["total_bytes"], hw["ratio"]
            hier_split = (self._hier_inner, self._hier_outer,
                          hw["inner_stage_bytes"], hw["outer_bytes"],
                          hw["outer_native_bytes"])
        elif model is not None:
            rows = max(x.shape[0], 1)
            try:
                wb = wire_bytes(model, max(x.numel() // rows, 1),
                                self.dc.n, x.dtype)
            except (ValueError, TypeError):
                wb = None
            if wb is not None:
                ratio = wb["ratio"]
                if arm in ("native", "quant"):
                    wire = wb[f"{arm}_bytes"]
        spc = self.spc
        if spc is not None:
            spc.inc(f"coll_arm_{arm}_count")
            spc.inc("coll_wire_bytes", wire)
        if simdcn.us_per_mib() > 0:
            if hier_split is not None:
                simdcn.charge(hier_split[3])
            elif arm != "staged":
                simdcn.charge(int(wire * simdcn.ring_dcn_fraction(
                    self.dc.mesh, self.dc.axis, kinds=self._kinds)))
        if perf.enabled:
            # annotate the in-flight timing entry (coll/framework's
            # dispatch wrapper) with the executed arm + audited per-rank
            # wire bytes; only annotated samples fold into the model
            perf.note_arm(arm, nbytes=wire, ndev=self.dc.n)
        if traffic.enabled:
            # per-edge attribution of the SAME wire figure the pvar just
            # banked — the conservation invariant's other half
            traffic.note_coll(self.dc, coll, arm, wire, weights=weights,
                              hier=hier_split)
        if trace.enabled:
            bucket = 1 << max(int(nbytes) - 1, 0).bit_length()
            extra = dict(extra or {})
            if hier_split is not None:
                extra.update({"hier_inner": hier_split[0],
                              "hier_outer": hier_split[1],
                              "hier_inner_bytes": 2 * hier_split[2],
                              "hier_outer_bytes": hier_split[3]})
            trace.decision(
                coll, arm=arm, reason=reason, verdict=None,
                nbytes=nbytes, rank=self._comm.ctx.rank,
                shape_bucket=bucket, shape=tuple(x.shape),
                dtype=_dtype_name(x.dtype),
                reduce_op=getattr(op, "name", None),
                ndev=self.dc.n, wire_bytes=wire, quant_ratio=ratio,
                chain=list(chain), **extra)

    # -- the staged arm: D2H, host exchange, numpy fold, H2D ----------------

    def _stage_out(self, x) -> np.ndarray:
        """The explicit D2H half of the staged arm (spc-accounted): this
        process's rows as a host array."""
        h = accelerator.current().memcpy_d2h(x)
        spc = self.spc
        if spc is not None:
            spc.inc("device_stage_out_bytes", h.nbytes)
            spc.inc("coll_staged_fallbacks")
        return h

    def _stage_all(self, x) -> np.ndarray:
        """Every process's rows on the host, (R, *elem): the D2H of this
        process's rows, then tuned's allgather of them over the
        communicator (in a world of one nothing crosses)."""
        h = self._stage_out(x)
        if self._comm.size == 1:
            return h
        got = self.host.allgather(self._comm, np.ascontiguousarray(h))
        return np.asarray(got).reshape((-1,) + h.shape[1:])

    def _stage_in(self, full: np.ndarray, like):
        """H2D of this process's rows of the canonical (R, ...) result onto
        ``like``'s device."""
        r = like.shape[0]
        mine = np.ascontiguousarray(full[self.dc.pos * r:
                                         (self.dc.pos + 1) * r])
        spc = self.spc
        if spc is not None:
            spc.inc("device_stage_in_bytes", mine.nbytes)
        return accelerator.current().memcpy_h2d(mine, like=like)

    def _to_host(self, x):
        """Host view of a maybe-device buffer: non-canonical layouts keep
        the host algorithm chain; ONE accounting path with _stage_out."""
        return self._stage_out(x) if _is_device(x) else x

    def _rows_ok(self, x, need_ndim: int) -> bool:
        """Canonical-layout gate: a device tensor with rows of its own."""
        return _is_device(x) and x.dim() >= need_ndim and x.shape[0] > 0

    def _R(self, x) -> int:
        """Rows of the canonical array: this process's rows × processes."""
        return x.shape[0] * self.dc.n

    # -- entries -------------------------------------------------------------

    def allreduce(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = op or SUM
        if not _is_device(sendbuf):
            return self.host.allreduce(comm, sendbuf, recvbuf, op)
        mode = self._mode("allreduce", sendbuf, op,
                          allowed=self._ALL_ARMS
                          if op.name in _NP_FOLD
                          else ("native", "quant"))
        if mode in ("hier", "hier+quant"):
            return self._hier_allreduce(sendbuf, op,
                                        quant=(mode == "hier+quant"))
        if mode == "quant":
            return self.dc.quant.allreduce(sendbuf, op)
        if mode == "staged":
            h = self._stage_all(sendbuf)
            red = _NP_FOLD[op.name](h, axis=0)
            return self._stage_in(np.broadcast_to(red, h.shape), sendbuf)
        return self.dc.allreduce(sendbuf, op)

    def _hier_allreduce(self, x, op: Op, quant: bool):
        """The two-tier HAN arm on this process's rows (r, *e): the local
        fold, then reduce_scatter over the inner level → allreduce over
        the outer level on the scattered 1/n_inner (quantized when
        ``quant``) → allgather over the inner level, every row the sum.
        Reached only when the decision said so: a two-tier comm, op sum."""
        from ..parallel.collectives import _repeat_rows
        from ..parallel.hierarchy import (hierarchical_psum,
                                          hierarchical_psum_quant)
        from ..parallel.mesh import axis_size
        dc = self.dc
        inner, outer = self._hier_inner, self._hier_outer
        red = dc._fold_local(x, op)
        flat = red.reshape(-1)
        if quant:
            out = hierarchical_psum_quant(
                flat, inner, outer, axis_size(dc.mesh, outer), mesh=dc.mesh)
        else:
            out = hierarchical_psum(flat, inner, outer, mesh=dc.mesh)
        return _repeat_rows(out.reshape(red.shape), x.shape[0])

    def reduce(self, comm, sendbuf, recvbuf=None, op: Op = None,
               root: int = 0):
        op = op or SUM
        if not _is_device(sendbuf):
            return self.host.reduce(comm, sendbuf, recvbuf, op, root)
        mode = self._mode("reduce", sendbuf, op,
                          allowed=("native", "staged")
                          if op.name in _NP_FOLD else ("native",))
        if mode == "staged":
            h = self._stage_all(sendbuf)
            red = _NP_FOLD[op.name](h, axis=0)
            return self._stage_in(np.broadcast_to(red, h.shape), sendbuf)
        return self.dc.reduce(sendbuf, op, root)

    def bcast(self, comm, buf, root: int = 0):
        if not _is_device(buf):
            return self.host.bcast(comm, buf, root)
        if self._mode("bcast", buf) == "staged":
            h = self._stage_all(buf)
            return self._stage_in(np.broadcast_to(h[root], h.shape), buf)
        return self.dc.bcast(buf, root)

    def allgather(self, comm, sendbuf, recvbuf=None):
        if not _is_device(sendbuf):
            return self.host.allgather(comm, sendbuf, recvbuf)
        mode = self._mode("allgather", sendbuf,
                          allowed=self._ALL_ARMS if sendbuf.dim() >= 2
                          else ("native", "staged"))
        if mode == "quant":
            return self.dc.quant.allgather(sendbuf)
        if mode == "staged":
            return self._stage_in(
                _staged_allgather(self._stage_all(sendbuf)), sendbuf)
        return self.dc.allgather(sendbuf)

    def alltoall(self, comm, sendbuf, recvbuf=None):
        if not _is_device(sendbuf):
            return self.host.alltoall(comm, sendbuf, recvbuf)
        if self._mode("alltoall", sendbuf) == "staged":
            h = self._stage_all(sendbuf)            # (R, R, b, *e)
            return self._stage_in(np.swapaxes(h, 0, 1), sendbuf)
        return self.dc.alltoall(sendbuf)

    def reduce_scatter_block(self, comm, sendbuf, recvbuf=None,
                             op: Op = None):
        op = op or SUM
        if not _is_device(sendbuf):
            return self.host.reduce_scatter_block(comm, sendbuf, recvbuf, op)
        mode = self._mode("reduce_scatter_block", sendbuf, op,
                          allowed=self._ALL_ARMS
                          if op.name in _NP_FOLD
                          else ("native", "quant"))
        if mode == "quant":
            return self.dc.quant.reduce_scatter(sendbuf, op)
        if mode == "staged":
            h = self._stage_all(sendbuf)            # (R, R*b, *e)
            R = h.shape[0]
            b = h.shape[1] // R
            red = _NP_FOLD[op.name](h, axis=0)
            return self._stage_in(red.reshape((R, b) + h.shape[2:]),
                                  sendbuf)
        return self.dc.reduce_scatter(sendbuf, op)

    def scan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = op or SUM
        if not _is_device(sendbuf):
            return self.host.scan(comm, sendbuf, recvbuf, op)
        mode = self._mode("scan", sendbuf, op,
                          allowed=("native", "staged")
                          if op.name in ("sum", "prod") else ("native",))
        if mode == "staged":
            h = self._stage_all(sendbuf)
            fn = np.cumsum if op.name == "sum" else np.cumprod
            return self._stage_in(fn(h, axis=0), sendbuf)
        return self.dc.scan(sendbuf, op)

    def exscan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = op or SUM
        if not _is_device(sendbuf):
            return self.host.exscan(comm, sendbuf, recvbuf, op)
        mode = self._mode("exscan", sendbuf, op,
                          allowed=("native", "staged")
                          if op.name == "sum" else ("native",))
        if mode == "staged":
            h = self._stage_all(sendbuf)
            out = np.zeros_like(h)
            out[1:] = np.cumsum(h, axis=0)[:-1]
            return self._stage_in(out, sendbuf)
        return self.dc.scan(sendbuf, op, exclusive=True)

    def barrier(self, comm):
        # host ranks agree, devices quiesce
        self.host.barrier(comm)
        self.dc.barrier()

    # -- neighbourhood collectives: they need communicator topologies ------

    def _no_topo(self, comm, sendbuf, name: str):
        if _is_device(sendbuf):
            raise NotImplementedError(
                f"{name} on a device tensor needs communicator topologies "
                f"(topo.cart_create), which are not ported yet (ROADMAP P7, "
                f"what waits)")

    def neighbor_allgather(self, comm, sendbuf, recvbuf=None):
        self._no_topo(comm, sendbuf, "neighbor_allgather")
        return self.host.basic.neighbor_allgather(comm, sendbuf, recvbuf)

    def neighbor_allgatherv(self, comm, sendbuf, recvbuf=None, counts=None,
                            displs=None):
        self._no_topo(comm, sendbuf, "neighbor_allgatherv")
        return self.host.basic.neighbor_allgatherv(comm, sendbuf, recvbuf,
                                                   counts, displs)

    def neighbor_alltoall(self, comm, sendbuf, recvbuf=None):
        self._no_topo(comm, sendbuf, "neighbor_alltoall")
        return self.host.basic.neighbor_alltoall(comm, sendbuf, recvbuf)

    # -- ragged / rooted entries: NATIVE when the caller presents the
    # canonical padded layout (DeviceComm docstring), staged-host fallback
    # otherwise (coll_base_alltoallv.c:194, coll_base_allgatherv.c:95,
    # coll_base_gather.c:41, coll_base_scatter.c:63 are the reference's
    # host algorithms).

    def allgatherv(self, comm, sendbuf, recvbuf=None, counts=None,
                   displs=None):
        if (counts is not None and displs is None and recvbuf is None
                and self._rows_ok(sendbuf, 2)
                and len(counts) == self._R(sendbuf)
                and sendbuf.shape[1] >= max(int(c) for c in counts)):
            if self._mode("allgatherv", sendbuf) == "staged":
                return self._stage_in(_staged_allgatherv(
                    self._stage_all(sendbuf), counts), sendbuf)
            return self.dc.allgatherv(sendbuf, counts)
        return self.host.allgatherv(comm, self._to_host(sendbuf), recvbuf,
                                    counts, displs)

    def gather(self, comm, sendbuf, recvbuf=None, root: int = 0):
        if recvbuf is None and self._rows_ok(sendbuf, 2):
            if self._mode("gather", sendbuf) == "staged":
                # shared helper, NOT self.allgather: its own decision
                # would override this entry's staged pick
                return self._stage_in(
                    _staged_allgather(self._stage_all(sendbuf)), sendbuf)
            return self.dc.gather(sendbuf, root)
        return self.host.gather(comm, self._to_host(sendbuf), recvbuf, root)

    def gatherv(self, comm, sendbuf, recvbuf=None, counts=None, displs=None,
                root: int = 0):
        if (counts is not None and displs is None and recvbuf is None
                and self._rows_ok(sendbuf, 2)
                and len(counts) == self._R(sendbuf)
                and sendbuf.shape[1] >= max(int(c) for c in counts)):
            if self._mode("gatherv", sendbuf) == "staged":
                return self._stage_in(_staged_allgatherv(
                    self._stage_all(sendbuf), counts), sendbuf)
            return self.dc.gatherv(sendbuf, counts, root)
        return self.host.basic.gatherv(comm, self._to_host(sendbuf), recvbuf,
                                       counts, displs, root)

    def scatter(self, comm, sendbuf, recvbuf=None, root: int = 0):
        if (recvbuf is None and self._rows_ok(sendbuf, 3)
                and self._R(sendbuf) == sendbuf.shape[1]):
            if self._mode("scatter", sendbuf) == "staged":
                h = self._stage_all(sendbuf)       # (R, R, b, *e)
                return self._stage_in(h[root], sendbuf)
            return self.dc.scatter(sendbuf, root)
        return self.host.scatter(comm, self._to_host(sendbuf), recvbuf, root)

    def scatterv(self, comm, sendbuf, recvbuf, counts, displs=None,
                 root: int = 0):
        if (recvbuf is None and displs is None
                and self._rows_ok(sendbuf, 3)
                and self._R(sendbuf) == sendbuf.shape[1]
                and len(counts) == self._R(sendbuf)
                and sendbuf.shape[2] >= max(int(c) for c in counts)):
            if self._mode("scatterv", sendbuf) == "staged":
                h = self._stage_all(sendbuf)
                return self._stage_in(h[root], sendbuf)
            return self.dc.scatterv(sendbuf, counts, root)
        return self.host.basic.scatterv(comm, self._to_host(sendbuf),
                                        recvbuf, counts, displs, root)

    @staticmethod
    def _check_recvcounts(C, recvcounts):
        if recvcounts is None:
            return
        RC = np.asarray(recvcounts)
        # accept either the per-destination totals vector or the stacked
        # per-rank matrix (row j = what j receives from each source, C.T)
        ok = (np.array_equal(RC, C.T) if RC.ndim == 2
              else np.array_equal(RC.ravel(), C.sum(axis=0)))
        if not ok:
            raise ValueError(
                "alltoallv: recvcounts disagree with sendcounts "
                f"({recvcounts} vs column sums "
                f"{C.sum(axis=0).tolist()})")

    def alltoallv(self, comm, sendbuf, recvbuf, sendcounts, recvcounts,
                  sdispls=None, rdispls=None):
        C = np.asarray(sendcounts)
        if (recvbuf is None and sdispls is None and rdispls is None
                and C.ndim == 2 and C.shape[0] == C.shape[1]
                and self._rows_ok(sendbuf, 2) and sendbuf.dim() in (2, 3)
                and (sendbuf.dim() == 2
                     or sendbuf.shape[1] != self._R(sendbuf))
                and self._R(sendbuf) == C.shape[0]
                and sendbuf.shape[1] >= int(C.sum(axis=1).max())):
            # DENSE-ROWS form — MPI's actual buffer layout (contiguous
            # sends in destination order, default displacements), with
            # optional trailing elem dims; the one ambiguous 3-D shape
            # (L == R) keeps the block interpretation below
            self._check_recvcounts(C, recvcounts)
            plan = self.dc.a2av_plan(
                (self._R(sendbuf),) + tuple(sendbuf.shape[1:]), C)
            if self._mode("alltoallv", sendbuf, weights=C,
                          extra={"a2av_slice_cap": plan["slice_cap"],
                                 "a2av_scan_steps": plan["scan_steps"]},
                          ) == "staged":
                h = self._stage_all(sendbuf)           # (R, L, *e)
                out_cap = self.dc._bucket(
                    int(C.sum(axis=0).max()) if C.size else 1)
                return self._stage_in(
                    self.dc.compact_from_rows(h, C, out_cap), sendbuf)
            out, _tot = self.dc.alltoallv_from_rows(sendbuf, C)
            return out
        if (recvbuf is None and sdispls is None and rdispls is None
                and C.ndim == 2 and C.shape[0] == C.shape[1]
                and self._rows_ok(sendbuf, 3)
                and self._R(sendbuf) == sendbuf.shape[1] == C.shape[0]
                and sendbuf.shape[2] >= int(C.max())):
            self._check_recvcounts(C, recvcounts)
            if self._mode("alltoallv", sendbuf, weights=C) == "staged":
                h = self._stage_all(sendbuf)       # (R, R, cap, *e)
                out_cap = self.dc._bucket(
                    int(C.sum(axis=0).max()) if h.shape[0] else 1)
                return self._stage_in(
                    self.dc.compact_ragged_blocks(h, C, out_cap), sendbuf)
            out, _tot = self.dc.alltoallv(sendbuf, C)
            return out
        return self.host.alltoallv(comm, self._to_host(sendbuf), recvbuf,
                                   sendcounts, recvcounts, sdispls, rdispls)

    def reduce_scatter(self, comm, sendbuf, recvbuf, counts, op: Op = None):
        op = op or SUM
        if (recvbuf is None and self._rows_ok(sendbuf, 2)
                and len(counts) == self._R(sendbuf)
                and int(np.sum(counts)) == sendbuf.shape[1]):
            cs = [int(c) for c in counts]
            allowed = ["native"]
            if op.name in _NP_FOLD:
                allowed.append("staged")
            if len(set(cs)) == 1 and cs[0] > 0:
                allowed.append("quant")   # ragged counts: no quant layout
            mode = self._mode("reduce_scatter", sendbuf, op,
                              allowed=tuple(allowed))
            if mode == "quant":
                out = self.dc.quant.reduce_scatter(sendbuf, op)
                cap = self.dc._bucket(cs[0])
                if cap != cs[0]:   # reduce_scatter_v's padded cap
                    pad = [0, 0] * (out.dim() - 2) + [0, cap - cs[0]]
                    out = torch.nn.functional.pad(out, pad)
                return out
            if mode == "staged":
                h = self._stage_all(sendbuf)       # (R, total, *e)
                red = _NP_FOLD[op.name](h, axis=0)
                cap = self.dc._bucket(max(cs))
                out = np.zeros((h.shape[0], cap) + h.shape[2:], h.dtype)
                off = 0
                for i, c in enumerate(cs):
                    out[i, :c] = red[off:off + c]
                    off += c
                return self._stage_in(out, sendbuf)
            return self.dc.reduce_scatter_v(sendbuf, counts, op)
        return self.host.reduce_scatter(comm, self._to_host(sendbuf),
                                        recvbuf, counts, op)


@component("coll", "nccl", priority=80)
class NcclColl(Component):
    name = "nccl"

    def query(self, comm):
        if getattr(comm, "device_comm", None) is None:
            return None, None
        return self.priority, NcclModule(comm)
