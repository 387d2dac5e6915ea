"""ICI/DCN plane classification for mesh edges + per-plane rollups.

The port's copy of ``ompi_tpu/traffic/planes.py``.  The axis-level
inference is ``parallel.mesh.classify_axes`` (the HAN intra/inter split);
the edge-level rule is the same signal one hop finer: a directed edge is
``dcn`` when its endpoints live on different HOSTS, else ``ici``.  The
reference compares process indices, which here would call every edge
``dcn``: the port runs one process per card, and the cards of one host
talk over NVLink.  The host of every world rank comes from one
all-gather that ``mesh.make_mesh`` takes (collective, every rank of the
world reaches it), never from inside an audit, which only some ranks
reach.  Staged-arm bytes never reach an edge and roll into the
pseudo-plane ``host``.

Per-plane byte splits are also stashed into the in-flight perf timing
entry (``perf.note_planes``) so the cost model banks plane-keyed cells
``<coll>@<plane>`` next to the flat ones.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from .matrix import Edge, grid

# per-mesh host tables, held as long as their mesh lives
_HOST_CACHE: "weakref.WeakKeyDictionary[Any, List[Any]]" = \
    weakref.WeakKeyDictionary()


def _hosts(mesh: Any) -> List[Any]:
    """Host id per flat grid position: a mesh's own ``hosts`` table when
    it carries one (fake grids in tests), else the world's host table
    (``mesh.world_hosts``) indexed by the grid's ranks; one host for all
    when the world's table was never taken (no ``make_mesh`` ran)."""
    own = getattr(mesh, "hosts", None)
    if own is not None:
        return list(own)
    got = _HOST_CACHE.get(mesh)
    if got is None:
        from ..parallel.mesh import world_hosts
        table = world_hosts()
        ranks = np.asarray(mesh.mesh).reshape(-1)
        if table is None:
            return [0] * ranks.size
        got = _HOST_CACHE[mesh] = [table[int(r)] for r in ranks]
    return got


def _sim_slabs(mesh: Any) -> List[Any]:
    """Per-flat-position slice id under the sim-DCN override: the
    coordinate tuple along the overridden axes (uncached — the override
    can change mid-process)."""
    from ..parallel.mesh import sim_dcn_axes
    sim = sim_dcn_axes()
    if not sim:
        return []
    shape, names = grid(mesh)
    dims = [i for i, a in enumerate(names) if a in sim]
    if not dims:
        return []
    return [tuple(np.unravel_index(i, shape)[k] for k in dims)
            for i in range(int(np.prod(shape)))]


def plane_fn(mesh: Any) -> Callable[[int, int], str]:
    """(src, dst) -> 'ici' | 'dcn' for global flat grid positions.
    An edge is 'dcn' when its endpoints live on different hosts OR on
    opposite sides of a simulated slice boundary (``topo_sim_dcn_axes``)
    — the edge-level view of classify_axes."""
    hosts = _hosts(mesh)
    slabs = _sim_slabs(mesh)

    def plane_of(src: int, dst: int) -> str:
        if hosts[src] != hosts[dst]:
            return "dcn"
        if slabs and slabs[src] != slabs[dst]:
            return "dcn"
        return "ici"

    return plane_of


def plane_split(parts: Sequence[Tuple[Edge, int]],
                plane_of: Callable[[int, int], str]) -> Dict[str, int]:
    """{'ici': bytes, 'dcn': bytes} rollup of one spread."""
    out: Dict[str, int] = {}
    for (s, d), b in parts:
        p = plane_of(s, d)
        out[p] = out.get(p, 0) + int(b)
    return out
