"""Linear correctness-first collective algorithms (≙ ompi/mca/coll/basic).

Every entry point of the coll table, implemented with straight-line p2p —
the fallback component every communicator can rely on, and the semantic
reference the tuned/xla components are tested against (the reference uses
coll/basic the same way: always available, lowest useful priority).

Buffer conventions (host path): numpy arrays; ``sendbuf=None`` means
MPI_IN_PLACE (operate in recvbuf). Vector variants take per-rank counts and
displacements in *elements*.

The port's copy of ``ompi_tpu/coll/basic.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.component import Component, component
from ..op import Op, reduce_local_host
from ..p2p.request import wait_all
from .framework import CollModule

# reserved tag space: -100.. (user tags ≥ 0; comm mgmt -10..; coll -100..)
T_BCAST = -101
T_REDUCE = -102
T_GATHER = -103
T_SCATTER = -104
T_ALLGATHER = -105
T_ALLTOALL = -106
T_BARRIER = -107
T_SCAN = -108
T_RSCAT = -109
T_NEIGHBOR = -110


def _inplace(sendbuf, recvbuf):
    if sendbuf is None:
        return np.asarray(recvbuf).copy()
    return np.asarray(sendbuf)


class BasicModule(CollModule):
    """Linear algorithms. One instance per communicator."""

    # -- data movement ------------------------------------------------------

    def bcast(self, comm, buf, root: int = 0):
        buf = np.asarray(buf)
        if comm.size == 1:
            return buf
        if comm.rank == root:
            reqs = [comm.isend(buf, dst, T_BCAST)
                    for dst in range(comm.size) if dst != root]
            wait_all(reqs)
        else:
            comm.recv(buf, root, T_BCAST)
        return buf

    def gather(self, comm, sendbuf, recvbuf=None, root: int = 0):
        sendbuf = np.asarray(sendbuf)
        if comm.rank == root:
            if recvbuf is None:
                recvbuf = np.empty((comm.size,) + sendbuf.shape, sendbuf.dtype)
            rb = recvbuf.reshape((comm.size, -1))
            rb[root] = sendbuf.reshape(-1)
            reqs = [comm.irecv(rb[src], src, T_GATHER)
                    for src in range(comm.size) if src != root]
            wait_all(reqs)
            return recvbuf
        comm.send(sendbuf, root, T_GATHER)
        return None

    def gatherv(self, comm, sendbuf, recvbuf=None,
                counts: Optional[Sequence[int]] = None,
                displs: Optional[Sequence[int]] = None, root: int = 0):
        sendbuf = np.asarray(sendbuf)
        if comm.rank == root:
            assert counts is not None
            if displs is None:
                displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
            if recvbuf is None:
                total = max(d + c for d, c in zip(displs, counts))
                recvbuf = np.empty(total, sendbuf.dtype)
            flat = recvbuf.reshape(-1)
            reqs = []
            for src in range(comm.size):
                view = flat[displs[src]:displs[src] + counts[src]]
                if src == root:
                    view[:] = sendbuf.reshape(-1)[:counts[src]]
                else:
                    reqs.append(comm.irecv(view, src, T_GATHER))
            wait_all(reqs)
            return recvbuf
        comm.send(sendbuf, root, T_GATHER)
        return None

    def scatter(self, comm, sendbuf, recvbuf=None, root: int = 0):
        if comm.rank == root:
            sendbuf = np.asarray(sendbuf)
            parts = sendbuf.reshape((comm.size, -1))
            if recvbuf is None:
                recvbuf = np.empty_like(parts[0])
            reqs = [comm.isend(parts[dst], dst, T_SCATTER)
                    for dst in range(comm.size) if dst != root]
            recvbuf.reshape(-1)[:] = parts[root]
            wait_all(reqs)
            return recvbuf
        if recvbuf is None:
            raise ValueError("non-root scatter needs recvbuf")
        comm.recv(recvbuf, root, T_SCATTER)
        return recvbuf

    def scatterv(self, comm, sendbuf, recvbuf,
                 counts: Optional[Sequence[int]] = None,
                 displs: Optional[Sequence[int]] = None, root: int = 0):
        if comm.rank == root:
            sendbuf = np.asarray(sendbuf).reshape(-1)
            assert counts is not None
            if displs is None:
                displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
            reqs = []
            for dst in range(comm.size):
                view = sendbuf[displs[dst]:displs[dst] + counts[dst]]
                if dst == root:
                    recvbuf.reshape(-1)[:len(view)] = view
                else:
                    reqs.append(comm.isend(view, dst, T_SCATTER))
            wait_all(reqs)
            return recvbuf
        comm.recv(recvbuf, root, T_SCATTER)
        return recvbuf

    def allgather(self, comm, sendbuf, recvbuf=None):
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty((comm.size,) + sendbuf.shape, sendbuf.dtype)
        self.gather(comm, sendbuf, recvbuf if comm.rank == 0 else None, root=0)
        self.bcast(comm, recvbuf, root=0)
        return recvbuf

    def allgatherv(self, comm, sendbuf, recvbuf=None,
                   counts: Optional[Sequence[int]] = None,
                   displs: Optional[Sequence[int]] = None):
        sendbuf = np.asarray(sendbuf)
        assert counts is not None
        if displs is None:
            displs = list(np.concatenate([[0], np.cumsum(counts)[:-1]]))
        if recvbuf is None:
            total = max(d + c for d, c in zip(displs, counts))
            recvbuf = np.empty(total, sendbuf.dtype)
        self.gatherv(comm, sendbuf, recvbuf if comm.rank == 0 else None,
                     counts, displs, root=0)
        self.bcast(comm, recvbuf, root=0)
        return recvbuf

    def alltoall(self, comm, sendbuf, recvbuf=None):
        sendbuf = np.asarray(sendbuf)
        parts = sendbuf.reshape((comm.size, -1))
        if recvbuf is None:
            recvbuf = np.empty_like(sendbuf)
        rparts = recvbuf.reshape((comm.size, -1))
        rparts[comm.rank] = parts[comm.rank]
        reqs = []
        for peer in range(comm.size):
            if peer == comm.rank:
                continue
            reqs.append(comm.irecv(rparts[peer], peer, T_ALLTOALL))
            reqs.append(comm.isend(parts[peer], peer, T_ALLTOALL))
        wait_all(reqs)
        return recvbuf

    def alltoallv(self, comm, sendbuf, recvbuf,
                  sendcounts: Sequence[int], recvcounts: Sequence[int],
                  sdispls: Optional[Sequence[int]] = None,
                  rdispls: Optional[Sequence[int]] = None):
        sendbuf = np.asarray(sendbuf).reshape(-1)
        if sdispls is None:
            sdispls = list(np.concatenate([[0], np.cumsum(sendcounts)[:-1]]))
        if rdispls is None:
            rdispls = list(np.concatenate([[0], np.cumsum(recvcounts)[:-1]]))
        flat = recvbuf.reshape(-1)
        me = comm.rank
        flat[rdispls[me]:rdispls[me] + recvcounts[me]] = \
            sendbuf[sdispls[me]:sdispls[me] + sendcounts[me]]
        reqs = []
        for peer in range(comm.size):
            if peer == me:
                continue
            rv = flat[rdispls[peer]:rdispls[peer] + recvcounts[peer]]
            reqs.append(comm.irecv(rv, peer, T_ALLTOALL))
            sv = sendbuf[sdispls[peer]:sdispls[peer] + sendcounts[peer]]
            reqs.append(comm.isend(sv, peer, T_ALLTOALL))
        wait_all(reqs)
        return recvbuf

    def alltoallw(self, comm, sendbufs: List[np.ndarray],
                  recvbufs: List[np.ndarray]):
        """Per-peer buffers with independent types (list-of-arrays form)."""
        me = comm.rank
        recvbufs[me][...] = sendbufs[me]
        reqs = []
        for peer in range(comm.size):
            if peer == me:
                continue
            reqs.append(comm.irecv(recvbufs[peer], peer, T_ALLTOALL))
            reqs.append(comm.isend(sendbufs[peer], peer, T_ALLTOALL))
        wait_all(reqs)
        return recvbufs

    # -- reductions ---------------------------------------------------------

    def reduce(self, comm, sendbuf, recvbuf=None, op: Op = None,
               root: int = 0):
        from .. import op as _op
        op = op or _op.SUM
        send = _inplace(sendbuf, recvbuf)
        if comm.rank == root:
            # gather all contributions, fold strictly in rank order —
            # required for non-commutative ops and reproducibility
            # (≙ in-order algorithms, coll_base_reduce.c:514)
            contribs = [np.empty_like(send) for _ in range(comm.size)]
            reqs = [comm.irecv(contribs[src], src, T_REDUCE)
                    for src in range(comm.size) if src != root]
            contribs[root][...] = send
            wait_all(reqs)
            acc = contribs[0].copy()
            for src in range(1, comm.size):
                acc = op.host(acc, contribs[src])   # acc = acc OP x_src
            if recvbuf is None:
                recvbuf = np.empty_like(send)
            recvbuf[...] = acc
            return recvbuf
        comm.send(send, root, T_REDUCE)
        return None

    def allreduce(self, comm, sendbuf, recvbuf=None, op: Op = None):
        send = _inplace(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        self.reduce(comm, send, recvbuf if comm.rank == 0 else None, op, root=0)
        self.bcast(comm, recvbuf, root=0)
        return recvbuf

    def reduce_scatter_block(self, comm, sendbuf, recvbuf=None, op: Op = None):
        sendbuf = np.asarray(sendbuf)
        parts = sendbuf.reshape((comm.size, -1))
        full = np.empty_like(sendbuf) if comm.rank == 0 else None
        self.reduce(comm, sendbuf, full, op, root=0)
        if recvbuf is None:
            recvbuf = np.empty_like(parts[0])
        self.scatter(comm, full, recvbuf, root=0)
        return recvbuf

    def reduce_scatter(self, comm, sendbuf, recvbuf, counts: Sequence[int],
                       op: Op = None):
        sendbuf = np.asarray(sendbuf).reshape(-1)
        full = np.empty_like(sendbuf) if comm.rank == 0 else None
        self.reduce(comm, sendbuf, full, op, root=0)
        self.scatterv(comm, full, recvbuf, counts, root=0)
        return recvbuf

    def scan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        from .. import op as _op
        op = op or _op.SUM
        send = _inplace(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        acc = send.copy()
        if comm.rank > 0:
            prev = np.empty_like(send)
            comm.recv(prev, comm.rank - 1, T_SCAN)
            acc = op.host(prev, acc)
        recvbuf[...] = acc
        if comm.rank < comm.size - 1:
            comm.send(acc, comm.rank + 1, T_SCAN)
        return recvbuf

    def exscan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        from .. import op as _op
        op = op or _op.SUM
        send = _inplace(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        if comm.rank == 0:
            acc = send.copy()
            if comm.size > 1:
                comm.send(acc, 1, T_SCAN)
        else:
            prev = np.empty_like(send)
            comm.recv(prev, comm.rank - 1, T_SCAN)
            recvbuf[...] = prev
            if comm.rank < comm.size - 1:
                comm.send(op.host(prev, send.copy()), comm.rank + 1, T_SCAN)
        return recvbuf

    def reduce_local(self, comm, invec, inoutvec, op: Op = None):
        from .. import op as _op
        reduce_local_host(op or _op.SUM, np.asarray(invec), inoutvec)
        return inoutvec

    # -- synchronization ----------------------------------------------------

    def barrier(self, comm):
        token = np.zeros(0, np.uint8)
        if comm.rank == 0:
            for src in range(1, comm.size):
                comm.recv(token, src, T_BARRIER)
            reqs = [comm.isend(token, dst, T_BARRIER)
                    for dst in range(1, comm.size)]
            wait_all(reqs)
        else:
            comm.send(token, 0, T_BARRIER)
            comm.recv(token, 0, T_BARRIER)

    # -- neighborhood (cart/graph topologies; ≙ coll/basic neighbor_*) ------

    def _neighbors(self, comm):
        topo = getattr(comm, "topo", None)
        if topo is None:
            raise RuntimeError("neighborhood collective on comm without topology")
        return topo.in_neighbors(comm.rank), topo.out_neighbors(comm.rank)

    def neighbor_allgather(self, comm, sendbuf, recvbuf=None):
        indeg, outdeg = self._neighbors(comm)
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty((len(indeg),) + sendbuf.shape, sendbuf.dtype)
        reqs = [comm.irecv(recvbuf[i], src, T_NEIGHBOR)
                for i, src in enumerate(indeg)]
        reqs += [comm.isend(sendbuf, dst, T_NEIGHBOR) for dst in outdeg]
        wait_all(reqs)
        return recvbuf

    def neighbor_allgatherv(self, comm, sendbuf, recvbuf, counts, displs=None):
        indeg, outdeg = self._neighbors(comm)
        sendbuf = np.asarray(sendbuf)
        if displs is None:
            displs = list(np.concatenate([[0], np.cumsum(counts)[:-1]]))
        if recvbuf is None:
            # same allocate-on-None contract as neighbor_allgather: size
            # by the furthest write (user displs may leave gaps)
            total = max((int(d) + int(c) for d, c in zip(displs, counts)),
                        default=0)
            recvbuf = np.empty(total, sendbuf.dtype)
        flat = recvbuf.reshape(-1)
        reqs = [comm.irecv(flat[displs[i]:displs[i] + counts[i]], src, T_NEIGHBOR)
                for i, src in enumerate(indeg)]
        reqs += [comm.isend(sendbuf, dst, T_NEIGHBOR) for dst in outdeg]
        wait_all(reqs)
        return recvbuf

    def neighbor_alltoall(self, comm, sendbuf, recvbuf=None):
        indeg, outdeg = self._neighbors(comm)
        sendbuf = np.asarray(sendbuf)
        parts = sendbuf.reshape((len(outdeg), -1))
        if recvbuf is None:
            recvbuf = np.empty((len(indeg), parts.shape[1]), sendbuf.dtype)
        rparts = recvbuf.reshape((len(indeg), -1))
        reqs = [comm.irecv(rparts[i], src, T_NEIGHBOR)
                for i, src in enumerate(indeg)]
        reqs += [comm.isend(parts[i], dst, T_NEIGHBOR)
                 for i, dst in enumerate(outdeg)]
        wait_all(reqs)
        return recvbuf

    def neighbor_alltoallv(self, comm, sendbuf, recvbuf, sendcounts, recvcounts,
                           sdispls=None, rdispls=None):
        indeg, outdeg = self._neighbors(comm)
        sendbuf = np.asarray(sendbuf).reshape(-1)
        if sdispls is None:
            sdispls = list(np.concatenate([[0], np.cumsum(sendcounts)[:-1]]))
        if rdispls is None:
            rdispls = list(np.concatenate([[0], np.cumsum(recvcounts)[:-1]]))
        flat = recvbuf.reshape(-1)
        reqs = [comm.irecv(flat[rdispls[i]:rdispls[i] + recvcounts[i]],
                           src, T_NEIGHBOR)
                for i, src in enumerate(indeg)]
        reqs += [comm.isend(sendbuf[sdispls[i]:sdispls[i] + sendcounts[i]],
                            dst, T_NEIGHBOR)
                 for i, dst in enumerate(outdeg)]
        wait_all(reqs)
        return recvbuf

    def neighbor_alltoallw(self, comm, sendbufs, recvbufs):
        indeg, outdeg = self._neighbors(comm)
        reqs = [comm.irecv(recvbufs[i], src, T_NEIGHBOR)
                for i, src in enumerate(indeg)]
        reqs += [comm.isend(sendbufs[i], dst, T_NEIGHBOR)
                 for i, dst in enumerate(outdeg)]
        wait_all(reqs)
        return recvbufs


@component("coll", "basic", priority=10)
class BasicColl(Component):
    name = "basic"

    def query(self, comm):
        return self.priority, BasicModule()
