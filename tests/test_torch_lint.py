"""The port's comm-lint (``ompi_tpu_torch.analysis.lint``) against the JAX
package's, on the CPU.

The reference's ``TestLint`` cases (``tests/test_analysis.py:406-501``)
in the port's vocabulary: CL001 flags a raw ``torch.distributed``
collective or point-to-point call outside the port's dispatch engine
(``coll/nccl``, ``DeviceComm``, the audited wrappers) and stays quiet in
it; CL002–CL008 keep their rules on ``ompi_tpu_torch/`` paths; a waiver
without a why does not waive.  The rule catalog and the fix hints are the
reference's dicts, the same sources give the same findings where the
rule does not name the package, and the shipped tree lints clean.
"""

import os

import pytest

from ompi_tpu.analysis import lint as j_lint
from ompi_tpu_torch.analysis import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(findings, waived=False):
    return [f.rule for f in findings if f.waived == waived]


_SPAN_BAD = '''
import time
from ompi_tpu_torch import trace

def build_it(build, key):
    t0 = time.perf_counter()
    fn = build()
    trace.record_span("build", "compile", t0, time.perf_counter())
    return fn
'''

_SPAN_GOOD = '''
import time
from ompi_tpu_torch import trace

def build_it(build, key):
    t0 = time.perf_counter()
    try:
        fn = build()
    except BaseException:
        trace.record_span("build", "compile", t0, time.perf_counter(),
                          args={"status": "error"})
        raise
    trace.record_span("build", "compile", t0, time.perf_counter())
    return fn
'''

_RAW = ("import torch.distributed as dist\n"
        "def f(x):\n"
        "    dist.{call}\n")

RAW_CALLS = {
    "all_reduce": "all_reduce(x)",
    "all_gather_into_tensor": "all_gather_into_tensor(x, x)",
    "reduce_scatter_tensor": "reduce_scatter_tensor(x, x)",
    "all_to_all_single": "all_to_all_single(x, x)",
    "broadcast": "broadcast(x, src=0)",
    "scatter": "scatter(x, [x], src=0)",
    "batch_isend_irecv": "batch_isend_irecv([])",
    "all_gather_object": "all_gather_object([None], x)",
    "isend": "isend(x, 1)",
    "irecv": "irecv(x, 1)",
    "send": "send(x, 1)",
    "recv": "recv(x, 1)",
}


@pytest.mark.parametrize("name", sorted(RAW_CALLS))
def test_cl001_raw_collective(name):
    src = _RAW.format(call=RAW_CALLS[name])
    out = lint.lint_sources({"ompi_tpu_torch/newmod.py": src})
    assert _codes(out) == ["CL001"]
    assert f"torch.distributed.{name}" in out[0].msg


def test_cl001_spellings():
    src = ("import torch\n"
           "import torch.distributed\n"
           "from torch import distributed as D\n"
           "from torch.distributed import all_reduce as ar\n"
           "def f(x, dc, comm):\n"
           "    torch.distributed.all_reduce(x)\n"
           "    D.broadcast(x, 0)\n"
           "    ar(x)\n"
           "    dc.allreduce(x)\n"             # the engine path
           "    comm.send(x, 1)\n"             # a receiver, not the module
           "    send(x)\n")                    # not torch.distributed's
    out = lint.lint_sources({"ompi_tpu_torch/newmod.py": src})
    assert [(f.rule, f.line) for f in out] == [("CL001", 6), ("CL001", 7),
                                               ("CL001", 8)]


@pytest.mark.parametrize("path", list(lint._CL001_ENGINE_SUFFIXES))
def test_cl001_engine_layer_exempt(path):
    src = _RAW.format(call="all_reduce(x)")
    assert lint.lint_sources({path: src}) == []


def test_cl002_unprotected_span():
    out = lint.lint_sources({"ompi_tpu_torch/newmod.py": _SPAN_BAD})
    assert _codes(out) == ["CL002"]


def test_cl002_protected_span_clean():
    assert lint.lint_sources({"ompi_tpu_torch/newmod.py": _SPAN_GOOD}) == []


def test_cl003_unlisted_pvar():
    spc = 'COUNTERS = [("listed_total", "d")]\n'
    plane = 'PVARS = ("listed_total", "ghost_total")\n'
    out = lint.lint_sources({"ompi_tpu_torch/spc.py": spc,
                             "ompi_tpu_torch/plane.py": plane})
    assert _codes(out) == ["CL003"]
    assert "ghost_total" in out[0].msg


def test_cl004_gate_not_first():
    src = ("from ompi_tpu_torch import traffic\n"
           "def f(x):\n"
           "    if x > 0 and traffic.enabled:\n"
           "        pass\n")
    out = lint.lint_sources({"ompi_tpu_torch/newmod.py": src})
    assert _codes(out) == ["CL004"]


def test_cl004_registry_read_at_call_site():
    src = ("from ompi_tpu_torch.core import var as _var\n"
           "def f():\n"
           "    return _var.get('perf_enabled')\n")
    out = lint.lint_sources({"ompi_tpu_torch/newmod.py": src})
    assert _codes(out) == ["CL004"]
    # the plane's own module may read its var (it defines .enabled)
    assert lint.lint_sources({"ompi_tpu_torch/perf/__init__.py": src}) == []


def test_cl005_reason_grammar():
    bad = "def f(audit):\n    audit(reason='because I said so')\n"
    ok = "def f(audit):\n    audit(reason='rule:allreduce@dcn')\n"
    assert _codes(lint.lint_sources(
        {"ompi_tpu_torch/m.py": bad})) == ["CL005"]
    assert lint.lint_sources({"ompi_tpu_torch/m.py": ok}) == []


def test_cl006_epoch_discipline():
    bad = "def f(win, x):\n    win.put(x, 1)\n"
    ok = ("def f(win, x):\n"
          "    win.fence()\n"
          "    win.put(x, 1)\n"
          "    win.fence()\n")
    assert _codes(lint.lint_sources(
        {"ompi_tpu_torch/m.py": bad})) == ["CL006"]
    assert lint.lint_sources({"ompi_tpu_torch/m.py": ok}) == []


def test_cl007_decision_needs_verdict():
    bad = ("from ompi_tpu_torch import trace\n"
           "def f():\n"
           "    trace.decision('allreduce', arm='native', "
           "reason='rule:x', nbytes=4)\n")
    ok = bad.replace("nbytes=4)", "nbytes=4, verdict=None)")
    assert _codes(lint.lint_sources(
        {"ompi_tpu_torch/m.py": bad})) == ["CL007"]
    assert lint.lint_sources({"ompi_tpu_torch/m.py": ok}) == []
    # the constructor's home is not a call site
    assert lint.lint_sources({"ompi_tpu_torch/trace/__init__.py": bad}) == []


def test_cl008_request_path_span_needs_rid():
    bad = ("from ompi_tpu_torch import trace\n"
           "def f(t0, t1):\n"
           "    trace.record_span('serve:x', 'serve', t0, t1, "
           "args={'slot': 1})\n")
    ok = bad.replace("{'slot': 1}", "{'slot': 1, 'rid': 7}")
    assert _codes(lint.lint_sources(
        {"ompi_tpu_torch/serving/m.py": bad})) == ["CL008"]
    assert lint.lint_sources({"ompi_tpu_torch/serving/m.py": ok}) == []
    assert lint.lint_sources({"ompi_tpu_torch/m.py": bad}) == []


def test_waiver_with_justification():
    src = ("import torch.distributed as dist\n"
           "def f(x):\n"
           "    dist.all_reduce(x)  "
           "# comm-lint: disable=CL001 measured eager reference\n")
    out = lint.lint_sources({"ompi_tpu_torch/m.py": src})
    assert _codes(out) == [] and _codes(out, True) == ["CL001"]
    assert out[0].waiver == "measured eager reference"


def test_standalone_waiver_covers_next_line():
    src = ("import torch.distributed as dist\n"
           "def f(x):\n"
           "    # comm-lint: disable=CL001,CL005 the host table\n"
           "    dist.all_gather_object([None], x)\n")
    out = lint.lint_sources({"ompi_tpu_torch/m.py": src})
    assert _codes(out) == [] and out[0].waiver == "the host table"


def test_waiver_without_justification_stays():
    src = ("import torch.distributed as dist\n"
           "def f(x):\n"
           "    dist.all_reduce(x)  # comm-lint: disable=CL001\n")
    out = lint.lint_sources({"ompi_tpu_torch/m.py": src})
    assert _codes(out) == ["CL001"]
    assert "NO justification" in out[0].msg


def test_catalog_and_hints_equal_reference():
    assert lint.RULES == j_lint.RULES
    assert lint._HINTS == j_lint._HINTS
    assert lint._REASON_PREFIXES == j_lint._REASON_PREFIXES
    assert lint._PLANES == j_lint._PLANES


@pytest.mark.parametrize("src", [_SPAN_BAD, _SPAN_GOOD,
                                 'COUNTERS = [("a", "d")]\nPVARS = ("b",)\n',
                                 "def f(audit):\n    audit(reason='x:y')\n",
                                 "def f(win, x):\n    win.put(x, 1)\n"])
def test_package_neutral_rules_equal_reference(src):
    """CL002–CL006 on the same source under each package's path give the
    same findings (messages and lines)."""
    def rows(mod, pkg):
        return [(f.rule, f.line, f.msg, f.hint)
                for f in mod.lint_sources({f"{pkg}/m.py": src})]
    assert rows(lint, "ompi_tpu_torch") == rows(j_lint, "ompi_tpu")


def test_shipped_tree_is_clean():
    findings = lint.lint_paths([os.path.join(ROOT, "ompi_tpu_torch")])
    live = [f for f in findings if not f.waived]
    assert live == [], "\n".join(f.format() for f in live)
    # every waiver carries its why
    assert all(f.waiver for f in findings if f.waived)


def test_main_exit_codes(tmp_path, capsys):
    pkg = tmp_path / "ompi_tpu_torch"
    pkg.mkdir()
    good = pkg / "good.py"
    good.write_text(_RAW.format(
        call="all_reduce(x)  # comm-lint: disable=CL001 measured reference"))
    assert lint.main([str(good)]) == 0
    bad = pkg / "bad.py"
    bad.write_text(_RAW.format(call="all_reduce(x)"))
    assert lint.main([str(bad)]) == 1
    assert "CL001" in capsys.readouterr().out
