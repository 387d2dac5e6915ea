"""Analysis: the static collective verifier (``commgraph``), the
repo-invariant comm-lint (``lint``) and the DEVICE_RULES grammar
(``rules``), shared by coll/nccl's dispatch-time loader and CI.

The port's copy of ``ompi_tpu/analysis/__init__.py``:

* ``commgraph`` — extract the collective program of a callable (the
  ``c10d`` ops one eager run issues) or of a compiled reshard plan into a
  ``CommGraph``, run the SPMD well-formedness checks (sequence matching
  between ranks, ppermute bijections, hier axis cover, device->host
  reads), and predict per-collective wire bytes with the same models the
  traffic plane charges — ``verify()`` cross-checks the static figure
  against the runtime attribution byte for byte.
* ``lint`` — AST comm-lint over the tree: rules CL001–CL008 encode the
  plane contracts.
* ``rules`` — the DEVICE_RULES grammar authority.

``rules`` and ``lint`` are import-light (no torch); ``commgraph`` imports
torch only inside its functions, and every name loads lazily so
``coll/nccl -> analysis.rules`` stays a cheap import edge.
"""

from __future__ import annotations

_COMMGRAPH_NAMES = (
    "CollRecord", "CommGraph", "Issue", "VerifyReport",
    "extract", "from_reshard_plan", "verify", "verify_action",
)
_LINT_NAMES = ("Finding", "lint_paths", "lint_sources", "RULES")

__all__ = list(_COMMGRAPH_NAMES) + list(_LINT_NAMES) + ["rules"]


def __getattr__(name: str):
    import importlib
    if name in ("rules", "lint", "commgraph"):
        return importlib.import_module(f".{name}", __name__)
    if name in _COMMGRAPH_NAMES:
        return getattr(importlib.import_module(".commgraph", __name__), name)
    if name in _LINT_NAMES:
        return getattr(importlib.import_module(".lint", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
