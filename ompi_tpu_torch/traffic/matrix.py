"""Per-edge traffic matrix — collective geometry onto directed mesh edges
(the port's copy of ``ompi_tpu/traffic/matrix.py``).

The attribution unit is the audited PER-RANK wire-byte count: the exact
value coll/nccl's audit adds to the ``coll_wire_bytes`` pvar is spread —
exactly, to the byte — over the directed edges the algorithm's schedule
uses, so ``sum(edge bytes) == coll_wire_bytes`` is an invariant over any
window where every wire-counted call was also attributed (the bench
``--traffic`` probe pins it end-to-end). Spreading the per-rank figure
(rather than the physical sum over all ranks) keeps the matrix on the
same normalization as every other byte surface in the repo — the busbw
factors, the perf ledger, the monitoring matrices.

Edge endpoints are GLOBAL flat positions into the mesh's grid (C order;
on a ``torch.distributed`` ``DeviceMesh`` the grid ``mesh.mesh`` holds
world ranks, so position i is the i-th rank of the row-major fill), and
multi-axis meshes attribute each axis-collective to the edges of every
line along that axis.  All helpers duck-type the mesh (``.mesh`` grid +
``.mesh_dim_names``) so tests can pin geometry on fake grids without a
world.

Distribution is exact integer apportionment (largest-remainder): the
conservation invariant never drifts by rounding, so any nonzero
``traffic_unattributed_bytes`` is a genuine attribution bug (an unknown
collective, an empty edge set), never float noise.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]          # (src, dst) global flat device positions


def grid(mesh: Any) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of a mesh's grid."""
    return (tuple(int(d) for d in np.asarray(mesh.mesh).shape),
            tuple(mesh.mesh_dim_names))


def _axis_lines(mesh: Any, axis) -> np.ndarray:
    """(n_lines, axis_size) of global flat grid positions: one row per
    line along ``axis`` (every combination of the other axes' coords).
    A TUPLE of axis names is the row-major flattened super-axis — the
    ring a flat collective over a two-tier comm actually schedules."""
    shape, names = grid(mesh)
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    src = tuple(names.index(a) for a in axes)
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    idx = np.moveaxis(idx, src, tuple(range(-len(src), 0)))
    size = 1
    for a in axes:
        size *= shape[names.index(a)]
    return idx.reshape(-1, size)


def ring_edges(mesh: Any, axis: str, direction: str = "fwd") -> List[Edge]:
    """Directed wrap-around ring edges along ``axis`` for every line.
    ``fwd``: i -> i+1, ``rev``: i -> i-1, ``bidir``: both half-rings
    (the two ICI directions the bidirectional schedules drive)."""
    edges: List[Edge] = []
    for line in _axis_lines(mesh, axis):
        n = len(line)
        if n < 2:
            continue
        if direction in ("fwd", "bidir"):
            edges += [(int(line[i]), int(line[(i + 1) % n]))
                      for i in range(n)]
        if direction in ("rev", "bidir"):
            edges += [(int(line[i]), int(line[(i - 1) % n]))
                      for i in range(n)]
    return edges


def bipartite_edges(mesh: Any, axis: str) -> List[Edge]:
    """Every ordered (src, dst) pair along each line, self-pairs
    excluded — the all-to-all block. Pair order is nested (src-major)
    per line so per-pair weight vectors line up."""
    edges: List[Edge] = []
    for line in _axis_lines(mesh, axis):
        n = len(line)
        edges += [(int(line[i]), int(line[j]))
                  for i in range(n) for j in range(n) if i != j]
    return edges


def perm_edges(mesh: Any, axis: str,
               pairs: Sequence[Tuple[int, int]]) -> List[Edge]:
    """An explicit ppermute's (src_pos, dst_pos) pairs along ``axis``,
    replicated over every line; self-pairs carry no wire and drop."""
    edges: List[Edge] = []
    for line in _axis_lines(mesh, axis):
        edges += [(int(line[s]), int(line[d]))
                  for (s, d) in pairs if s != d]
    return edges


def a2a_weights(counts: np.ndarray, n_lines: int = 1) -> List[float]:
    """Off-diagonal weights of an alltoallv counts matrix in
    :func:`bipartite_edges` pair order, tiled per line."""
    C = np.asarray(counts, dtype=float)
    n = C.shape[0]
    w = [float(C[i, j]) for i in range(n) for j in range(n) if i != j]
    return w * max(int(n_lines), 1)


def spread(total: int, edges: Sequence[Edge],
           weights: Optional[Sequence[float]] = None
           ) -> List[Tuple[Edge, int]]:
    """Apportion ``total`` bytes over ``edges`` exactly (largest
    remainder): the returned parts always sum to ``total`` when any
    positively-weighted edge exists, else to 0."""
    total = int(total)
    if total <= 0 or not edges:
        return []
    if weights is None:
        w = [1.0] * len(edges)
    else:
        w = [max(float(x), 0.0) for x in weights]
    tw = sum(w)
    if tw <= 0:
        return []
    raw = [total * x / tw for x in w]
    base = [int(r) for r in raw]
    rem = total - sum(base)
    # deterministic: biggest fractional remainders first, index-stable
    order = sorted(range(len(raw)), key=lambda i: (base[i] - raw[i], i))
    for i in order[:rem]:
        base[i] += 1
    return [(edges[i], base[i]) for i in range(len(edges)) if base[i]]


class TrafficMatrix:
    """Thread-safe per-edge byte aggregate + the conservation ledger."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._edges: Dict[Edge, int] = {}
        self._edge_plane: Dict[Edge, str] = {}
        self._planes: Dict[str, int] = {}
        self._per_coll: Dict[str, int] = {}
        self.ops = 0                 # attribution calls accepted
        self.asked_bytes = 0         # wire bytes handed to charge()
        self.placed_bytes = 0        # bytes that landed on edges/host
        self.unattributed_bytes = 0  # asked - placed (attribution bugs)

    # ---- ingestion -------------------------------------------------

    def charge(self, coll: str, wire: int,
               parts: Sequence[Tuple[Edge, int]],
               plane_of: Callable[[int, int], str]) -> int:
        """Fold one collective's spread; the per-op conservation check
        lives HERE: any byte of ``wire`` the parts do not cover is
        banked as unattributed, never silently dropped."""
        wire = int(wire)
        placed = 0
        with self._lock:
            for (s, d), b in parts:
                e = (int(s), int(d))
                self._edges[e] = self._edges.get(e, 0) + int(b)
                plane = self._edge_plane.get(e)
                if plane is None:
                    plane = self._edge_plane[e] = plane_of(e[0], e[1])
                self._planes[plane] = self._planes.get(plane, 0) + int(b)
                placed += int(b)
            self._per_coll[coll] = self._per_coll.get(coll, 0) + placed
            self.ops += 1
            self.asked_bytes += wire
            self.placed_bytes += placed
            if placed != wire:
                self.unattributed_bytes += wire - placed
        return placed

    def charge_host(self, coll: str, wire: int) -> None:
        """Staged-arm bytes: they cross the host bridge, not mesh links
        — rolled into the 'host' plane with no edge entries."""
        wire = int(wire)
        with self._lock:
            self._planes["host"] = self._planes.get("host", 0) + wire
            self._per_coll[coll] = self._per_coll.get(coll, 0) + wire
            self.ops += 1
            self.asked_bytes += wire
            self.placed_bytes += wire

    def charge_unattributed(self, coll: str, wire: int) -> None:
        with self._lock:
            self.ops += 1
            self.asked_bytes += int(wire)
            self.unattributed_bytes += int(wire)

    # ---- queries ---------------------------------------------------

    def edge_count(self) -> int:
        return len(self._edges)

    def edge_bytes_total(self) -> int:
        with self._lock:
            return sum(self._edges.values())

    def rows(self) -> List[Dict[str, Any]]:
        """Per-edge rows, hottest first."""
        with self._lock:
            items = sorted(self._edges.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            return [{"src": s, "dst": d, "bytes": b,
                     "plane": self._edge_plane.get((s, d), "ici")}
                    for (s, d), b in items]

    def plane_totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._planes)

    def per_coll(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._per_coll)

    def snapshot_edges(self) -> List[Tuple[Edge, int, str]]:
        """(edge, bytes, plane) triples for the sentry — one lock hop."""
        with self._lock:
            return [((s, d), b, self._edge_plane.get((s, d), "ici"))
                    for (s, d), b in self._edges.items()]

    def to_json(self) -> Dict[str, Any]:
        return {"edges": self.rows(), "planes": self.plane_totals(),
                "per_coll": self.per_coll(), "ops": self.ops,
                "attributed_bytes": self.placed_bytes,
                "unattributed_bytes": self.unattributed_bytes}

    def clear(self) -> None:
        with self._lock:
            self._edges.clear()
            self._edge_plane.clear()
            self._planes.clear()
            self._per_coll.clear()
            self.ops = 0
            self.asked_bytes = 0
            self.placed_bytes = 0
            self.unattributed_bytes = 0
