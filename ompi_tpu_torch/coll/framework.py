"""Collectives framework: per-communicator function table + selection.

≙ ompi/mca/coll: the module attached to each communicator is a table of
collective entry points (coll.h:531 — blocking, nonblocking, persistent);
components are queried per communicator and stacked per-function: for every
entry point, the highest-priority component that implements it wins, with
lower-priority components as fallback (coll_base_comm_select.c:233,385,456 —
the subtle contract SURVEY.md calls out).

Components in-tree:
  * ``selfcoll`` — trivial size-1 communicators (≙ coll/self)
  * ``basic``    — linear/correctness algorithms (≙ coll/basic)
  * ``tuned``    — algorithm library + size-based decision rules
                   (≙ coll/base + coll/tuned)
  * ``nccl``     — NCCL device collectives for communicators with a device
                   mesh attached (replaces coll/accelerator host staging),
                   the port's ``coll/xla``

The port's copy of ``ompi_tpu/coll/framework.py``.  The dispatch wrapper
keeps the spc counts and the eager ``i*`` wrappers; its trace, monitoring,
numerics, health and perf interposition comes with ROADMAP P16, and ULFM's
revoked-communicator check with P14.  ``nbc``, ``adapt``, ``inter`` and
``quant`` are later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.component import frameworks
from ..core.output import output, show_help

# the full entry-point inventory (blocking set; i*/persistent variants are
# derived wrappers — see CollTable.__getattr__)
COLL_FUNCTIONS = [
    "allgather", "allgatherv", "allreduce", "alltoall", "alltoallv",
    "alltoallw", "barrier", "bcast", "exscan", "gather", "gatherv",
    "reduce", "reduce_scatter", "reduce_scatter_block", "scan", "scatter",
    "scatterv", "reduce_local",
    # neighborhood collectives (cart/graph topologies, ≙ coll/basic neighbor_*)
    "neighbor_allgather", "neighbor_allgatherv", "neighbor_alltoall",
    "neighbor_alltoallv", "neighbor_alltoallw",
]


class CollModule:
    """Base class for per-communicator collective modules. Implement any
    subset of COLL_FUNCTIONS as methods fn(comm, ...)."""

    def enabled(self, name: str) -> bool:
        return hasattr(self, name)


class CollTable:
    """The per-communicator dispatch table with per-function fallback."""

    def __init__(self, entries: Dict[str, "CollModule"],
                 stack: List[tuple]) -> None:
        self._entries = entries
        self.stack = stack       # [(priority, component_name, module)]

    def provider(self, name: str) -> Optional[str]:
        """Which component serves this entry point (tpu_info introspection)."""
        mod = self._entries.get(name)
        return getattr(mod, "_component_name", None) if mod else None

    def __getattr__(self, name: str):
        entries = object.__getattribute__(self, "_entries")
        if name in entries:
            fn = getattr(entries[name], name)

            def counted(comm, *a, **kw):
                if a and getattr(comm, "device_comm", None) is None:
                    _refuse_device(comm, name, a[0])
                spc = getattr(comm.ctx, "spc", None)
                if spc is not None:
                    spc.inc("collectives")
                    if name == "barrier":
                        spc.inc("barriers")
                return fn(comm, *a, **kw)

            return counted
        # nonblocking variants: i<name> falls back to eager execution wrapped
        # in a completed request when no component provides a true schedule
        if name.startswith("i") and name[1:] in entries:
            blocking = getattr(entries[name[1:]], name[1:])

            def nb(comm, *a, **kw):
                from ..p2p.request import CompletedRequest
                result = blocking(comm, *a, **kw)
                req = CompletedRequest()
                req.result = result
                return req

            return nb
        raise AttributeError(f"no collective entry point {name!r}")


def _refuse_device(comm, name: str, buf) -> None:
    """A device tensor on a communicator with no device mesh would reach
    the host algorithms, whose ``np.asarray`` would hide a copy (or fail on
    a CUDA tensor): refuse it, naming the way to the device path."""
    from .. import accelerator

    if accelerator.check_addr(buf) is not None:
        raise TypeError(
            f"{name} on communicator {comm.name}: a device tensor on a "
            f"communicator with no device mesh; attach one with "
            f"parallel.attach_mesh(comm, mesh, axis), or stage the buffer "
            f"to the host yourself")


def _ensure_components() -> None:
    """Import the in-tree component modules (registration happens at import).

    Selection must not depend on package import order: a thread can reach
    this module through sys.modules while another thread is still executing
    ``coll/__init__.py``, before the component imports there have run — the
    analog of the reference opening a framework's components before any
    selection (mca_base_framework.c:161)."""
    import importlib
    for m in ("basic", "selfcoll", "tuned", "nccl"):
        importlib.import_module(f"{__package__}.{m}")


def attach_coll(comm) -> None:
    """Select and attach the coll table for a new communicator
    (≙ mca_coll_base_comm_select)."""
    _ensure_components()
    rows = frameworks.framework("coll").select_all(comm)
    if not rows:
        show_help.show("no-component", "coll", "coll_select", "")
        raise RuntimeError("no coll components available")
    entries: Dict[str, CollModule] = {}
    for pri, component, module in sorted(rows, key=lambda r: r[0]):
        # ascending priority: higher priorities overwrite → win per-function
        if module is None:
            continue
        module._component_name = component.name
        for fn in COLL_FUNCTIONS:
            if module.enabled(fn):
                entries[fn] = module
            # true non-blocking schedules (coll/nbc) outrank the derived
            # eager i* wrappers in CollTable.__getattr__
            if module.enabled("i" + fn):
                entries["i" + fn] = module
    comm.coll = CollTable(entries, sorted(rows, key=lambda r: -r[0]))
    output.verbose(10, "coll",
                   f"comm {comm.name}: " +
                   ", ".join(f"{f}→{m._component_name}"
                             for f, m in sorted(entries.items())))
