"""comm-lint: AST rules encoding the port's plane contracts.

The port's copy of ``ompi_tpu/analysis/lint.py``, pointed at
``ompi_tpu_torch/``.  Off-the-shelf linters know Python; they do not know
that a raw ``torch.distributed`` collective bypasses the observability
planes, that a manually
recorded trace span silently vanishes when the timed call raises, or
that the decision layer's reason strings are a parseable grammar the
trace analyzer replays.  Each rule below states one such invariant,
carries a fix-hint, and can be waived per line with a *justified*
comment::

    # comm-lint: disable=CL001 <why this site is exempt>

A waiver without a justification does not waive (the why IS the
contract: six months later nobody remembers which exemptions were
load-bearing).  Multiple codes: ``disable=CL001,CL002 <why>``.  The
comment waives findings on its own line, or — as a standalone comment
— on the next code line.

Rule catalog (the reference's ``docs/static-analysis.md`` has the long
rationale):

* **CL001** raw ``torch.distributed`` collective or point-to-point call
  outside the dispatch-engine layer (``coll/nccl``, ``DeviceComm`` and
  the audited wrappers) — bypasses decision audit, traffic attribution
  and perf sampling.
* **CL002** manual ``trace.record_span`` whose timed region can raise
  before the span is recorded (no ``status=error`` close on the
  exception path) — a raising sync loses its span and the perf model
  inherits an open-ended latency.
* **CL003** pvar registered in a plane's ``PVARS``/``_PVARS`` but not
  listed in ``spc.COUNTERS`` — ``spc.get``/``snapshot`` read through
  the plane registries by COUNTERS membership, so an unlisted pvar is
  invisible to pvar_read_all/Prometheus.
* **CL004** disabled-path guard doing more than one attribute read —
  the plane contract is ONE module-attribute read on the disabled
  path (``<plane>.enabled`` first in any ``and``-chain; never
  ``_var.get("<plane>_enabled")`` at a call site).
* **CL005** decision-reason literal outside the audited grammar
  (``force:|blanket:|rule:|floor:|off:|ineligible:|default:|learned:``)
  — the trace analyzer's drift check parses these prefixes.
* **CL006** one-sided window put/accumulate outside an RMA epoch — no
  completion or ordering guarantee without fence/lock/PSCW.
* **CL007** the policy-plane attribution contract: every
  ``trace.decision(...)`` audit-event constructor must thread a
  ``verdict=`` cause (``verdict=None`` is the explicit operator-forced
  spelling), and every sentry verdict dict must carry ``plane`` and
  ``severity`` keys — an unattributed decision or an envelope-less
  verdict is invisible to ``comm_doctor --policy``.
* **CL008** the request-plane stitching contract: every span recorded
  inside the serving request path (``ompi_tpu_torch/serving/``) must carry a
  ``rid=`` tag in its args — an untagged span is invisible to the
  per-request span-tree stitching and the critical-path analyzer.
  Batch-scoped spans (one decode step covers every live request) waive
  with the why.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "CL001": "raw collective/shard_map call outside the dispatch engine",
    "CL002": "trace span not closed on the exception path",
    "CL003": "pvar registered but not read-through in spc.get/snapshot",
    "CL004": "disabled-path guard does more than one attribute read",
    "CL005": "decision reason outside the audited grammar",
    "CL006": "one-sided window op reachable outside an RMA epoch",
    "CL007": "decision without a verdict= cause / verdict without "
             "plane+severity",
    "CL008": "serving request-path span without a rid= tag",
}

_HINTS: Dict[str, str] = {
    "CL001": "dispatch through the engine layer (DeviceComm / coll.xla / "
             "the audited wrappers), or attribute the comm at the eager "
             "boundary (traffic.note_*) and waive with the why",
    "CL002": "wrap the timed region in try/except BaseException recording "
             "the span with args={'status': 'error'} before re-raising "
             "(or use the `with trace.span(...)` context manager, which "
             "closes tagged spans itself)",
    "CL003": "add the pvar to spc.COUNTERS — get()/snapshot() read "
             "through each plane's PVARS by COUNTERS membership, so an "
             "unlisted name never reaches pvar_read_all/Prometheus",
    "CL004": "make the plane gate the FIRST operand (`<plane>.enabled "
             "and ...`) and never re-read the var registry at call "
             "sites — the disabled path must cost one attribute read",
    "CL005": "start the reason with one of force:/blanket:/rule:/floor:/"
             "off:/ineligible:/default:/learned: — the trace analyzer's "
             "decision-drift check parses the prefix",
    "CL006": "open an epoch first (fence / lock / lock_all / start+post) "
             "— a one-sided op outside an epoch has no completion or "
             "ordering guarantee",
    "CL007": "thread the causing verdict through the audit event "
             "(verdict=<cause>, or the explicit verdict=None for an "
             "operator-forced decision), and give every sentry verdict "
             "dict the bus envelope keys 'plane' and 'severity' — "
             "comm_doctor --policy renders only attributed decisions",
    "CL008": "tag the span's args with the owning request (rid=...) so "
             "the request plane's span-tree stitching can group it; a "
             "genuinely batch-scoped span (one decode step serves every "
             "live request) waives with the why",
}

# -- CL001 vocabulary --------------------------------------------------------

# the raw torch.distributed collectives and point-to-point calls
_RAW_COLLS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "scatter", "gather", "reduce", "batch_isend_irecv",
    "all_gather_object", "broadcast_object_list", "isend", "irecv",
    "send", "recv",
})

# the dispatch/engine layer: modules whose JOB is to issue raw
# collectives, each with decision/traffic/perf integration (or, for
# coll_tune, whose job is to MEASURE the raw arms that feed
# DEVICE_RULES).  Matched as path suffixes.
_CL001_ENGINE_SUFFIXES = (
    "ompi_tpu_torch/coll/nccl.py",
    "ompi_tpu_torch/coll/quant.py",
    "ompi_tpu_torch/parallel/collectives.py",
    "ompi_tpu_torch/parallel/hierarchy.py",
    "ompi_tpu_torch/parallel/reshard.py",
    "ompi_tpu_torch/parallel/overlap.py",
    "ompi_tpu_torch/ops/collective_matmul.py",
    "ompi_tpu_torch/serving/fused.py",
    "ompi_tpu_torch/tools/coll_tune.py",
)

# -- CL002 vocabulary --------------------------------------------------------

# calls assumed non-raising between t0 and record_span (timers, the
# tracer itself, cheap builtins); anything else can raise and lose the
# span
_CL002_SAFE_CALLS = frozenset({
    "perf_counter", "record_span", "instant", "monotonic", "time",
    "len", "sum", "min", "max", "int", "float", "round", "repr",
    "str", "dict", "list", "tuple", "bool", "format", "get", "items",
    "keys", "values", "describe", "append", "inc",
})
# the trace engine itself defines the span machinery
_CL002_ENGINE_SUFFIXES = ("ompi_tpu_torch/trace/__init__.py",)

# -- CL004 vocabulary --------------------------------------------------------

_PLANES = ("trace", "traffic", "perf", "numerics", "health", "policy",
           "history")
_PLANE_ENABLED_VARS = frozenset(f"{p}_enabled" for p in _PLANES)

# -- CL005 vocabulary --------------------------------------------------------

_REASON_PREFIXES = ("force:", "blanket:", "rule:", "floor:", "off:",
                    "ineligible:", "default:", "learned:")

# -- CL007 vocabulary --------------------------------------------------------

# the decision constructor's home (defines the signature, is not a call
# site) and the engine that BUILDS the verdict= payload it threads
_CL007_ENGINE_SUFFIXES = ("ompi_tpu_torch/trace/__init__.py",)
# names whose dict construction is held to the bus-envelope contract
_CL007_VERDICT_NAMES = re.compile(r"(^|_)verdicts?$")

# -- CL008 vocabulary --------------------------------------------------------

# the serving request path: every span these modules record narrates a
# request's lifecycle, so the request plane's stitching needs the rid tag
_CL008_PATH_FRAGMENT = "ompi_tpu_torch/serving/"

# -- CL006 vocabulary --------------------------------------------------------

_RMA_OPS = frozenset({"put", "accumulate", "get_accumulate",
                      "fetch_and_op", "compare_and_swap"})
_EPOCH_OPENERS = frozenset({"fence", "lock", "lock_all", "start", "post"})
# SHMEM's contract is an always-exposed symmetric heap with
# fence/quiet ordering — not MPI window epochs — so its put/get layer
# is exempt wholesale rather than line-waived
_CL006_EXEMPT_SUFFIXES = ("ompi_tpu_torch/shmem/",)

_WAIVER_RE = re.compile(
    r"#\s*comm-lint:\s*disable=((?:CL\d{3})(?:\s*,\s*CL\d{3})*)\s*(.*)")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    msg: str
    hint: str = ""
    waived: bool = False
    waiver: str = ""

    def format(self) -> str:
        tag = f" [waived: {self.waiver}]" if self.waived else ""
        return (f"{self.path}:{self.line}: {self.rule} {self.msg}{tag}"
                + (f"\n    hint: {self.hint}" if self.hint and
                   not self.waived else ""))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _attr_chain(node) -> str:
    """'a.b.c' for nested attributes, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _finding(rule: str, path: str, node, msg: str) -> Finding:
    return Finding(rule=rule, path=path, line=getattr(node, "lineno", 1),
                   msg=msg, hint=_HINTS[rule])


# ---------------------------------------------------------------------------
# per-rule passes
# ---------------------------------------------------------------------------

def _dist_spellings(tree: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """The module aliases of ``torch.distributed`` in this file (``dist``
    of ``import torch.distributed as dist``, ``torch.distributed``
    itself) and the bare names a ``from torch.distributed import ...``
    bound to a raw collective (alias -> collective)."""
    mods, bare = {"torch.distributed"}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    mods.add(a.asname or a.name)
                elif (node.module == "torch.distributed"
                      and a.name in _RAW_COLLS):
                    bare[a.asname or a.name] = a.name
    return mods, bare


def _cl001(tree: ast.AST, path: str) -> List[Finding]:
    if any(_norm(path).endswith(s) for s in _CL001_ENGINE_SUFFIXES):
        return []
    mods, bare = _dist_spellings(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name):
            name = bare.get(node.func.id)
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _RAW_COLLS
              and _attr_chain(node.func.value) in mods):
            # only torch.distributed's spellings: a different receiver
            # (dc.allgather, comm.send) IS the engine path
            name = node.func.attr
        else:
            name = None
        if name is not None:
            out.append(_finding(
                "CL001", path, node,
                f"raw torch.distributed.{name} outside the dispatch "
                "engine — bypasses decision audit and traffic "
                "attribution"))
    return out


def _cl002(tree: ast.AST, path: str) -> List[Finding]:
    if any(_norm(path).endswith(s) for s in _CL002_ENGINE_SUFFIXES):
        return []
    out = []
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        spans = [n for n in ast.walk(fn)
                 if isinstance(n, ast.Call)
                 and _call_name(n) == "record_span"]
        if not spans:
            continue
        # protection map: line ranges of try-bodies whose handlers
        # either record an error span or do not re-raise (flow still
        # reaches the span call)
        protected: List[Tuple[int, int]] = []
        finally_lines: List[Tuple[int, int]] = []
        handler_lines: List[Tuple[int, int]] = []
        for t in ast.walk(fn):
            if not isinstance(t, ast.Try):
                continue
            for h in t.handlers:
                handler_lines.append((h.lineno, h.end_lineno or h.lineno))
                records = any(isinstance(c, ast.Call)
                              and _call_name(c) == "record_span"
                              for b in h.body for c in ast.walk(b))
                reraises = any(isinstance(c, ast.Raise)
                               for b in h.body for c in ast.walk(b))
                if records or not reraises:
                    body_end = max((b.end_lineno or b.lineno)
                                   for b in t.body)
                    protected.append((t.body[0].lineno, body_end))
            if t.finalbody:
                finally_lines.append(
                    (t.finalbody[0].lineno,
                     t.finalbody[-1].end_lineno
                     or t.finalbody[-1].lineno))

        def _in(ranges, line):
            return any(a <= line <= b for a, b in ranges)

        for call in spans:
            if _in(finally_lines, call.lineno) or _in(handler_lines,
                                                      call.lineno):
                continue          # already on an exception-safe path
            if len(call.args) < 3 or not isinstance(call.args[2],
                                                    ast.Name):
                continue          # t_begin not a plain name: synthetic
            t0 = call.args[2].id
            t0_line = None
            for n in ast.walk(fn):
                if (isinstance(n, ast.Assign) and n.lineno < call.lineno
                        and any(isinstance(x, ast.Name) and x.id == t0
                                for x in n.targets)):
                    t0_line = max(t0_line or 0, n.lineno)
            if t0_line is None:
                continue
            risky = []
            for n in ast.walk(fn):
                if (isinstance(n, ast.Call)
                        and t0_line < n.lineno < call.lineno
                        and _call_name(n) not in _CL002_SAFE_CALLS
                        and not _in(protected, n.lineno)
                        and not _in(handler_lines, n.lineno)):
                    risky.append(n)
            if risky:
                out.append(_finding(
                    "CL002", path, call,
                    f"span recorded at line {call.lineno} is lost if "
                    f"the call at line {risky[0].lineno} "
                    f"({_call_name(risky[0])}) raises — no "
                    "status=error close on the exception path"))
    return out


def _collect_pvars(tree: ast.AST) -> List[Tuple[int, str]]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id in ("PVARS", "_PVARS")
                   for t in node.targets):
            continue
        v = node.value
        if isinstance(v, (ast.Tuple, ast.List)):
            for e in v.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.append((e.lineno, e.value))
        elif isinstance(v, ast.Dict):
            for k in v.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.append((k.lineno, k.value))
    return out


def _collect_counters(tree: ast.AST) -> Optional[Set[str]]:
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "COUNTERS"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            names = set()
            for elt in node.value.elts:
                if (isinstance(elt, (ast.Tuple, ast.List)) and elt.elts
                        and isinstance(elt.elts[0], ast.Constant)):
                    names.add(elt.elts[0].value)
                elif isinstance(elt, ast.Constant):
                    names.add(elt.value)
            return names
    return None


def _cl003(trees: Dict[str, ast.AST]) -> List[Finding]:
    counters: Optional[Set[str]] = None
    for path, tree in trees.items():
        if _norm(path).endswith("spc.py") or "COUNTERS" in \
                {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 for t in n.targets if isinstance(t, ast.Name)}:
            c = _collect_counters(tree)
            if c:
                counters = c if counters is None else counters | c
    if counters is None:
        return []                 # no registry in this file set
    out = []
    for path, tree in trees.items():
        if _collect_counters(tree):
            continue              # the registry module itself
        for line, name in _collect_pvars(tree):
            if name not in counters:
                out.append(Finding(
                    rule="CL003", path=path, line=line,
                    msg=f"pvar {name!r} registered here is not in "
                        "spc.COUNTERS — invisible to get()/snapshot()/"
                        "pvar_read_all/Prometheus",
                    hint=_HINTS["CL003"]))
    return out


def _cl004(tree: ast.AST, path: str) -> List[Finding]:
    npath = _norm(path)
    own_plane = next((p for p in _PLANES
                      if f"ompi_tpu_torch/{p}/" in npath
                      or npath.endswith(f"ompi_tpu_torch/{p}.py")), None)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            for i, operand in enumerate(node.values):
                if i == 0:
                    continue
                for sub in ast.walk(operand):
                    if (isinstance(sub, ast.Attribute)
                            and sub.attr == "enabled"
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id in _PLANES):
                        out.append(_finding(
                            "CL004", path, node,
                            f"{sub.value.id}.enabled is operand "
                            f"#{i + 1} of an and-chain — the disabled "
                            "path pays every earlier operand before "
                            "the gate short-circuits"))
        if isinstance(node, ast.Call) and _call_name(node) == "get":
            chain = _attr_chain(node.func)
            if chain.split(".")[0] not in ("_var", "var", "registry"):
                continue
            if (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value in _PLANE_ENABLED_VARS):
                plane = node.args[0].value[:-len("_enabled")]
                if plane != own_plane:
                    out.append(_finding(
                        "CL004", path, node,
                        f"_var.get({node.args[0].value!r}) at a call "
                        "site — the registry lookup costs far more "
                        f"than the one-attribute read {plane}.enabled "
                        "the plane exports"))
    return out


def _literal_prefix(node) -> Optional[str]:
    """Leading literal text of a Constant-str or JoinedStr, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return None


def _cl005(tree: ast.AST, path: str) -> List[Finding]:
    out = []

    def _check(node, text: Optional[str]) -> None:
        if text is None:
            return
        if not text.startswith(_REASON_PREFIXES):
            out.append(_finding(
                "CL005", path, node,
                f"decision reason {text[:40]!r}... does not start with "
                f"a grammar prefix ({'|'.join(_REASON_PREFIXES)})"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "reason":
                    _check(kw.value, _literal_prefix(kw.value))
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "reason"
                   for t in node.targets):
                _check(node, _literal_prefix(node.value))
    return out


def _cl007(tree: ast.AST, path: str) -> List[Finding]:
    if any(_norm(path).endswith(s) for s in _CL007_ENGINE_SUFFIXES):
        return []
    out = []

    def _dict_keys(node) -> Optional[Set[str]]:
        """Constant keys of a dict literal or dict(...) call, else None."""
        if isinstance(node, ast.Dict):
            return {k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
        if isinstance(node, ast.Call) and _call_name(node) == "dict":
            return {kw.arg for kw in node.keywords if kw.arg}
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) == "decision":
            chain = _attr_chain(node.func)
            # only the audit constructor's spellings (trace.decision /
            # _trace.decision); a different receiver is not the event
            if chain.split(".")[0] not in ("trace", "_trace") \
                    and chain != "decision":
                continue
            if not any(kw.arg == "verdict" for kw in node.keywords):
                out.append(_finding(
                    "CL007", path, node,
                    "decision audit event without a verdict= cause — "
                    "pass the causing verdict, or the explicit "
                    "verdict=None for an operator-forced decision"))
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if not any(_CL007_VERDICT_NAMES.search(n) for n in names):
                continue
            keys = _dict_keys(node.value)
            if keys is None or "kind" not in keys:
                continue              # not a sentry verdict construction
            missing = [k for k in ("plane", "severity") if k not in keys]
            if missing:
                out.append(_finding(
                    "CL007", path, node,
                    f"sentry verdict dict missing the bus envelope "
                    f"key(s) {missing} — every verdict must carry "
                    "plane + severity for the policy bus"))
    return out


def _cl008(tree: ast.AST, path: str) -> List[Finding]:
    if _CL008_PATH_FRAGMENT not in _norm(path):
        return []
    out = []

    def _dict_keys(node) -> Optional[Set[str]]:
        """Constant keys of a dict literal or dict(...) call, else None."""
        if isinstance(node, ast.Dict):
            return {k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
        if isinstance(node, ast.Call) and _call_name(node) == "dict":
            return {kw.arg for kw in node.keywords if kw.arg}
        return None

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node) == "record_span"):
            continue
        chain = _attr_chain(node.func)
        # only the trace recorder's spellings (trace.record_span /
        # _trace.record_span); a different receiver is not the event
        if chain.split(".")[0] not in ("trace", "_trace") \
                and chain != "record_span":
            continue
        args_kw = next((kw.value for kw in node.keywords
                        if kw.arg == "args"), None)
        if args_kw is None and len(node.args) >= 6:
            args_kw = node.args[5]
        if args_kw is None:
            out.append(_finding(
                "CL008", path, node,
                "request-path span recorded with no args= at all — "
                "it cannot carry the rid= tag the request plane "
                "stitches span trees on"))
            continue
        keys = _dict_keys(args_kw)
        if keys is not None and "rid" not in keys:
            out.append(_finding(
                "CL008", path, node,
                "request-path span args without a rid= tag — the "
                "per-request span tree and critical-path analyzer "
                "cannot attribute it"))
    return out


def _cl006(tree: ast.AST, path: str) -> List[Finding]:
    npath = _norm(path)
    if any(s in npath for s in _CL006_EXEMPT_SUFFIXES):
        return []
    out = []
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        # window-like receivers: named *win* or assigned from a
        # window-constructing call
        windowish: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign):
                src = n.value
                ctor = _call_name(src) if isinstance(src, ast.Call) else ""
                if "window" in ctor.lower() or ctor == "win_create":
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            windowish.add(t.id)

        def _is_window(recv) -> bool:
            name = (recv.id if isinstance(recv, ast.Name)
                    else recv.attr if isinstance(recv, ast.Attribute)
                    else "")
            return "win" in name.lower() or name in windowish

        opened_before: Dict[str, int] = {}
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)]
        calls.sort(key=lambda c: c.lineno)
        for c in calls:
            recv = c.func.value
            if not _is_window(recv):
                continue
            rname = (recv.id if isinstance(recv, ast.Name) else recv.attr)
            if c.func.attr in _EPOCH_OPENERS:
                opened_before.setdefault(rname, c.lineno)
            elif c.func.attr in _RMA_OPS:
                if rname not in opened_before \
                        or opened_before[rname] > c.lineno:
                    out.append(_finding(
                        "CL006", path, c,
                        f"{rname}.{c.func.attr}() with no epoch opened "
                        "on this window earlier in the function "
                        "(fence/lock/lock_all/start/post)"))
    return out


# ---------------------------------------------------------------------------
# waivers + entry points
# ---------------------------------------------------------------------------

def _waivers(src: str) -> Dict[int, Tuple[Set[str], str]]:
    """line -> (codes, justification); a standalone waiver comment also
    covers the next line."""
    out: Dict[int, Tuple[Set[str], str]] = {}
    lines = src.splitlines()
    for i, line in enumerate(lines, 1):
        m = _WAIVER_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",")}
        why = m.group(2).strip()
        out[i] = (codes, why)
        if line.lstrip().startswith("#"):
            out[i + 1] = (codes, why)
    return out


def _apply_waivers(findings: List[Finding], src_by_path: Dict[str, str]
                   ) -> List[Finding]:
    waivers = {p: _waivers(s) for p, s in src_by_path.items()}
    out = []
    for f in findings:
        w = waivers.get(f.path, {}).get(f.line)
        if w and f.rule in w[0]:
            codes, why = w
            if why:
                f.waived, f.waiver = True, why
            else:
                f.msg += " (waiver present but has NO justification — "\
                         "the why is required)"
        out.append(f)
    return out


def lint_sources(src_by_path: Dict[str, str]) -> List[Finding]:
    """Lint a {path: source} mapping (the testable core)."""
    trees: Dict[str, ast.AST] = {}
    findings: List[Finding] = []
    for path, src in src_by_path.items():
        try:
            trees[path] = ast.parse(src)
        except SyntaxError as exc:
            findings.append(Finding(
                rule="CL000", path=path, line=exc.lineno or 1,
                msg=f"syntax error: {exc.msg}"))
    for path, tree in trees.items():
        findings += _cl001(tree, path)
        findings += _cl002(tree, path)
        findings += _cl004(tree, path)
        findings += _cl005(tree, path)
        findings += _cl006(tree, path)
        findings += _cl007(tree, path)
        findings += _cl008(tree, path)
    findings += _cl003(trees)
    findings = _apply_waivers(findings, src_by_path)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint files/directories (recursing into ``*.py``)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        else:
            files.append(p)
    srcs = {}
    for f in sorted(set(files)):
        with open(f) as fh:
            srcs[f] = fh.read()
    return lint_sources(srcs)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="repo-invariant comm-lint (rules CL001-CL008; "
                    "waive per line with '# comm-lint: disable=CLnnn "
                    "<why>')")
    ap.add_argument("paths", nargs="*", default=["ompi_tpu_torch"])
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings")
    ns = ap.parse_args(argv)
    findings = lint_paths(ns.paths or ["ompi_tpu_torch"])
    live = [f for f in findings if not f.waived]
    shown = findings if ns.show_waived else live
    for f in shown:
        print(f.format())
    n_waived = sum(1 for f in findings if f.waived)
    print(f"comm-lint: {len(live)} finding(s), {n_waived} waived")
    return 1 if live else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
