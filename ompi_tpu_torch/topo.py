"""Process topologies (the port's copy of the descriptors of
``ompi_tpu/topo.py``): what the device neighbourhood collectives read —
dims, periods and neighbour lists.  The communicator-level constructors
(``cart_create`` and the rest) are not ported yet: the MPI surface came
without them, and coll/nccl's neighbourhood entries refuse device tensors
until they come (ROADMAP P7, what waits)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class CartTopo:
    """Cartesian topology (MPI_Cart_create); row-major rank layout."""

    def __init__(self, dims: Sequence[int], periods: Sequence[bool]) -> None:
        self.dims = list(dims)
        self.periods = list(periods)
        if len(self.dims) != len(self.periods):
            raise ValueError("dims and periods must have the same length")
        self.size = int(np.prod(self.dims)) if self.dims else 1

    def coords(self, rank: int) -> List[int]:
        out = []
        for d in reversed(self.dims):
            out.append(rank % d)
            rank //= d
        return list(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for c, d, p in zip(coords, self.dims, self.periods):
            if c < 0 or c >= d:
                if not p:
                    raise ValueError(f"coordinate {c} out of range for "
                                     f"non-periodic dim of size {d}")
                c %= d
            rank = rank * d + c
        return rank

    def shift(self, rank: int, dim: int, disp: int = 1
              ) -> Tuple[Optional[int], Optional[int]]:
        """MPI_Cart_shift → (source, dest); None ≙ MPI_PROC_NULL at a
        non-periodic boundary."""
        c = self.coords(rank)

        def at(offset):
            cc = list(c)
            cc[dim] += offset
            if not self.periods[dim] and not (0 <= cc[dim] < self.dims[dim]):
                return None
            return self.rank_of(cc)
        return at(-disp), at(disp)

    def neighbors(self, rank: int) -> List[int]:
        """Neighbour order fixed by the standard: for each dim, -1 then +1."""
        out = []
        for dim in range(len(self.dims)):
            src, dst = self.shift(rank, dim, 1)
            out.extend([src, dst])
        return [n for n in out if n is not None]

    def in_neighbors(self, rank: int) -> List[int]:
        return self.neighbors(rank)

    def out_neighbors(self, rank: int) -> List[int]:
        return self.neighbors(rank)


class GraphTopo:
    """General graph topology (MPI_Graph_create): undirected adjacency in
    the classic compressed format, index[i] = end of rank i's edges."""

    def __init__(self, index: Sequence[int], edges: Sequence[int]) -> None:
        self.index = list(index)
        self.edges = list(edges)
        self.size = len(self.index)

    def neighbors(self, rank: int) -> List[int]:
        lo = self.index[rank - 1] if rank > 0 else 0
        return self.edges[lo:self.index[rank]]

    in_neighbors = neighbors
    out_neighbors = neighbors


__all__ = ["CartTopo", "GraphTopo"]
