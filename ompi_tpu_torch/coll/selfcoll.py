"""Trivial collectives for size-1 communicators (≙ ompi/mca/coll/self).

The port's copy of ``ompi_tpu/coll/selfcoll.py``.
"""

from __future__ import annotations

import numpy as np

from ..core.component import Component, component
from ..op import Op
from .framework import CollModule


class SelfModule(CollModule):
    def barrier(self, comm):
        pass

    def bcast(self, comm, buf, root: int = 0):
        return buf

    def reduce(self, comm, sendbuf, recvbuf=None, op: Op = None, root: int = 0):
        send = np.asarray(sendbuf if sendbuf is not None else recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        recvbuf[...] = send
        return recvbuf

    def allreduce(self, comm, sendbuf, recvbuf=None, op: Op = None):
        return self.reduce(comm, sendbuf, recvbuf, op)

    def gather(self, comm, sendbuf, recvbuf=None, root: int = 0):
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty((1,) + sendbuf.shape, sendbuf.dtype)
        recvbuf.reshape(1, -1)[0] = sendbuf.reshape(-1)
        return recvbuf

    def allgather(self, comm, sendbuf, recvbuf=None):
        return self.gather(comm, sendbuf, recvbuf)

    def scatter(self, comm, sendbuf, recvbuf=None, root: int = 0):
        parts = np.asarray(sendbuf).reshape(1, -1)
        if recvbuf is None:
            recvbuf = np.empty_like(parts[0])
        recvbuf.reshape(-1)[:] = parts[0]
        return recvbuf

    def alltoall(self, comm, sendbuf, recvbuf=None):
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(sendbuf)
        recvbuf[...] = sendbuf
        return recvbuf

    def scan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        return self.reduce(comm, sendbuf, recvbuf, op)


@component("coll", "self", priority=75)
class SelfColl(Component):
    name = "self"

    def query(self, comm):
        if getattr(comm, "size", 0) == 1:
            return self.priority, SelfModule()
        return None, None
