"""Standalone DEVICE_RULES validator — the single parser behind the
dispatch-time loader AND CI.

The rules-file grammar ('<coll>[@<plane>] <min_ndev> <min_bytes> <mode>')
covers the device tier, the plane-keyed rows and the learned-ledger
provenance headers (coll_tune --from-ledger).  An exactly-duplicated row
would otherwise make the later row win decide_mode's walk silently.
This module is the one grammar authority:

* ``parse_text`` / ``parse_file`` — strict parse shared by the loader:
  every historic ValueError (bad row shape, unknown mode, unknown
  plane) keeps its message, and an exact duplicate key
  ``(coll[@plane], min_ndev, min_bytes)`` is now a loud ValueError
  naming BOTH lines.
* ``validate_file`` — the CI arm (make comm-lint): parse errors plus
  non-fatal lint warnings (hier rows that are not plane-keyed,
  malformed provenance headers).

The validator stays import-light, loadable by the lint CLI
and by coll/nccl's import path without cycles.

The port's copy of ``ompi_tpu/analysis/rules.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# every mode any decision point can name (coll/nccl reads its _MODES
# from here, so the two vocabularies cannot drift apart)
MODES = ("native", "staged", "quant", "bidir", "hier", "hier+quant")
# plane vocabulary for '<coll>@<plane>' rows (parallel/hierarchy's
# classify_axes split, incl. the topo_sim_dcn_axes override)
PLANES = ("ici", "dcn")

# provenance headers emitted by machine rule-writers (coll_tune
# --device / --from-ledger, bench.py --selfdrive's policy plane): a
# '# learned from ...' comment is a machine-written claim about where
# the rows came from, so its shape is part of the file contract
_PROVENANCE_PREFIX = "# learned from "
_PROVENANCE_SOURCES = ("PERF_LEDGER", "policy")

Row = Tuple[str, int, int, str]


@dataclass
class RulesReport:
    """validate_file's result: rows when the file parses, else the
    parse error; warnings never fail the loader, only inform CI."""
    path: str
    rows: List[Row] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def parse_text(text: str, path: str = "<rules>") -> List[Row]:
    """Parse rules text into (coll, min_ndev, min_bytes, mode) rows.

    Raises ValueError on the first malformed row — including an exact
    duplicate ``(coll[@plane], min_ndev, min_bytes)`` key, which names
    both offending lines (before this validator the later row silently
    won the decide_mode walk)."""
    rules: List[Row] = []
    seen = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            coll, min_ndev, min_bytes, mode = line.split()
            min_ndev, min_bytes = int(min_ndev), int(min_bytes)
        except ValueError as exc:
            raise ValueError(
                f"{path}:{lineno}: bad device rule {line!r} "
                "(want '<coll>[@<plane>] <min_ndev> <min_bytes> "
                f"<native|staged>'): {exc}") from None
        if "@" in coll:
            base, plane = coll.split("@", 1)
            if not base or plane not in PLANES:
                raise ValueError(
                    f"{path}:{lineno}: unknown plane in "
                    f"{coll!r} (want '<coll>@<plane>' with "
                    f"plane one of {', '.join(PLANES)})")
        if mode not in MODES:
            raise ValueError(
                f"{path}:{lineno}: unknown device mode {mode!r} "
                f"(want one of {', '.join(MODES)})")
        key = (coll, min_ndev, min_bytes)
        if key in seen:
            first_line, first_mode = seen[key]
            raise ValueError(
                f"{path}:{lineno}: duplicate device rule for "
                f"{coll!r} (min_ndev={min_ndev}, min_bytes={min_bytes}): "
                f"line {first_line} already set mode {first_mode!r}, "
                f"line {lineno} sets {mode!r} — delete one (the loader "
                "no longer lets the later row win silently)")
        seen[key] = (lineno, mode)
        rules.append((coll, min_ndev, min_bytes, mode))
    return rules


def parse_file(path: str) -> List[Row]:
    """Strict parse of a rules file (the loader's entry point).

    A *named but missing* file is a loud error — misconfiguration must
    be distinguishable from no configuration (the reference's
    dynamic-file loader reports a missing file,
    coll_tuned_dynamic_file.c:58)."""
    if not os.path.exists(path):
        raise ValueError(
            f"coll_xla_dynamic_rules names a missing file: {path!r}")
    with open(path) as fh:
        return parse_text(fh.read(), path)


def validate_file(path: str) -> RulesReport:
    """CI validation: strict parse + non-fatal grammar lint.

    Warnings (do not fail the dispatch-time loader):
      * a ``hier``/``hier+quant`` mode on a row that is NOT plane-keyed
        — the arm needs a two-tier axis split (``hier_axes``), so a
        base row also matches single-plane comms where the arm is
        always vetoed ``ineligible:hier:...``; plane-keying the row
        (``<coll>@dcn``) states the eligibility precondition in the
        grammar itself.
      * a ``# learned from ...`` provenance header naming an unknown
        source (coll_tune writes ``# learned from PERF_LEDGER <path>``;
        anything else is a hand-edit masquerading as machine output).
    """
    rep = RulesReport(path=path)
    try:
        rep.rows = parse_file(path)
    except ValueError as exc:
        rep.errors.append(str(exc))
        return rep
    for coll, min_ndev, min_bytes, mode in rep.rows:
        if mode in ("hier", "hier+quant") and "@" not in coll:
            rep.warnings.append(
                f"{path}: rule '{coll} {min_ndev} {min_bytes} {mode}' "
                f"picks the {mode!r} arm without a plane key — the arm "
                "is only eligible on two-tier comms (hier_axes), so a "
                f"base row also matches comms where it is always "
                f"vetoed; prefer '{coll}@dcn'")
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            s = line.strip()
            if not s.startswith(_PROVENANCE_PREFIX):
                continue
            rest = s[len(_PROVENANCE_PREFIX):]
            if not any(rest.startswith(src) for src in _PROVENANCE_SOURCES):
                rep.warnings.append(
                    f"{path}:{lineno}: provenance header names unknown "
                    f"source {rest.split()[0] if rest.split() else ''!r} "
                    f"(known: {', '.join(_PROVENANCE_SOURCES)})")
    return rep


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m ompi_tpu_torch.analysis.rules [path ...]`` — validate
    rules files for CI; nonzero exit on any parse error."""
    import argparse

    ap = argparse.ArgumentParser(
        description="DEVICE_RULES validator (grammar, mode/plane "
                    "vocabulary, duplicate rows, provenance headers)")
    ap.add_argument("paths", nargs="*", default=["DEVICE_RULES.txt"],
                    help="rules files to validate")
    ns = ap.parse_args(argv)
    rc = 0
    for path in (ns.paths or ["DEVICE_RULES.txt"]):
        rep = validate_file(path)
        for w in rep.warnings:
            print(f"warning: {w}")
        for e in rep.errors:
            print(f"error: {e}")
            rc = 1
        if rep.ok:
            print(f"{path}: {len(rep.rows)} rule row(s) ok"
                  + (f", {len(rep.warnings)} warning(s)"
                     if rep.warnings else ""))
    return rc


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
