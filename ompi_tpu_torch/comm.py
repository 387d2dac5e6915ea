"""Communicators and groups (≙ ompi/communicator + ompi/group).

A Communicator is a (group, context-id) pair with a per-communicator
collectives table attached at creation — exactly the reference's model
(comm → c_coll table, ompi/mca/coll/coll.h:531; selection
coll_base_comm_select.c:233).

Context-id (CID) allocation: the reference agrees on the next free CID with a
non-blocking allreduce over the parent (ompi/communicator/comm_cid.c:544
``ompi_comm_nextcid``). Here one allgather carries every member's
(color, key, world_rank, cid_counter); each rank then carves the groups and
assigns CIDs by identical local computation — the agreed base is the MAX of
all counters. Intercommunicators agree the same way per side, with a
leader-to-leader exchange bridging the two groups. Internal traffic uses
reserved negative tags so it can never match user receives (user tags ≥ 0).

The port's copy of ``ompi_tpu/comm.py``.  Intercommunicators (they need
``coll/inter``) and persistent requests are later slices and raise
``NotImplementedError`` naming them; ULFM's revoke and failed-peer checks
come with ROADMAP P14.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from .core import var as _var
from .p2p.request import ANY_SOURCE, ANY_TAG, Request

_var.register("comm", "", "default_timeout", 60.0, type=float, level=3,
              help="Seconds an internal comm-construction handshake "
                   "(intercomm create/split leader exchange) waits for "
                   "the remote side before raising TimeoutError. Raise "
                   "it on slow control planes; the health watchdog "
                   "observes these waits independently.")

# reserved internal tags (user tags must be ≥ 0). Other reserved bands:
# coll/nbc -200..-999, part -3000.., io -400000..; the intercomm handshake
# gets its own band so user-supplied disambiguation tags can't wander into
# another subsystem's range.
TAG_INTER_COLL = -14
TAG_INTERCOMM_BASE = -50000        # handshake band: -50000 .. -50999
TAG_INTER_SPLIT = -51001           # intercomm split leader exchange

# intercomm rooted-collective sentinels (≙ MPI_ROOT / MPI_PROC_NULL)
ROOT = -3
PROC_NULL = -2

_INTER = ("intercommunicators need coll/inter, which is not ported yet "
          "(ROADMAP P7, what waits)")
_PERSISTENT = ("persistent requests (p2p/persistent.py) are not ported yet "
               "(ROADMAP P7, what waits)")


def _host_key() -> str:
    """Shared-memory host identity: hostname qualified with the kernel boot
    id (the shm transport's key in the JAX package)."""
    import socket

    try:
        with open("/proc/sys/kernel/random/boot_id") as fh:
            boot = fh.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}#{boot}"


_GROUP_SEQ_LOCK = threading.Lock()


class Group:
    """An ordered set of world ranks (≙ ompi/group)."""

    def __init__(self, world_ranks: Sequence[int]) -> None:
        self.world_ranks: List[int] = list(world_ranks)
        self._index = {w: i for i, w in enumerate(self.world_ranks)}

    @property
    def size(self) -> int:
        return len(self.world_ranks)

    def rank_of_world(self, world_rank: int) -> int:
        return self._index.get(world_rank, -1)

    def world_of_rank(self, rank: int) -> int:
        return self.world_ranks[rank]

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.world_ranks[r] for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        return Group([w for i, w in enumerate(self.world_ranks) if i not in drop])

    def union(self, other: "Group") -> "Group":
        seen = list(self.world_ranks)
        seen += [w for w in other.world_ranks if w not in self._index]
        return Group(seen)

    def intersection(self, other: "Group") -> "Group":
        o = set(other.world_ranks)
        return Group([w for w in self.world_ranks if w in o])

    def difference(self, other: "Group") -> "Group":
        o = set(other.world_ranks)
        return Group([w for w in self.world_ranks if w not in o])

    def translate_ranks(self, ranks: Sequence[int], other: "Group") -> List[int]:
        return [other.rank_of_world(self.world_ranks[r]) for r in ranks]


class Communicator:
    def __init__(self, ctx, group: Group, cid: int, name: str = "comm",
                 remote_group: Optional[Group] = None,
                 local_comm: Optional["Communicator"] = None) -> None:
        self.ctx = ctx
        self.group = group
        self.cid = cid
        self.name = name
        self.rank = group.rank_of_world(ctx.rank)
        self.size = group.size
        # intercommunicator state (≙ ompi/communicator/comm.c intercomms):
        # remote_group set → p2p addresses the remote group; local_comm is
        # the intracomm this side was built from (the reference keeps the
        # same c_local_comm handle inside every intercomm)
        self.remote_group = remote_group
        self.local_comm = local_comm
        self._cid_counter = cid * 1024 + 1   # namespace child cids per comm
        self._lock = threading.Lock()
        self.coll = None       # per-communicator collectives table (coll/)
        self.attributes: dict = {}           # keyval → value (MPI attrs)
        self.errhandler = None               # None = ERRORS_ARE_FATAL (raise)
        self.device_comm = None              # parallel.attach_mesh sets it
        self.device_plane = None             # "ici" | "dcn", ditto
        self.device_kinds = None             # {axis: "ici" | "dcn"}, ditto
        self._attach_coll()

    @property
    def is_inter(self) -> bool:
        return self.remote_group is not None

    @property
    def remote_size(self) -> int:
        return self.remote_group.size if self.remote_group else 0

    # -- construction -------------------------------------------------------

    @classmethod
    def _world(cls, ctx) -> "Communicator":
        return cls(ctx, Group(getattr(ctx, "world_ranks", range(ctx.size))),
                   cid=getattr(ctx, "world_cid", 0), name="world")

    def _attach_coll(self) -> None:
        if self.is_inter:
            raise NotImplementedError(_INTER)
        from .coll.framework import attach_coll
        attach_coll(self)

    # -- p2p in group-rank space -------------------------------------------
    # On an intercommunicator, peer ranks index the REMOTE group (MPI
    # semantics: send(dst) on an intercomm goes to remote rank dst).

    def _world_dst(self, rank: int) -> int:
        if self.is_inter:
            return self.remote_group.world_of_rank(rank)
        return self.group.world_of_rank(rank)

    def _peer_group(self) -> Group:
        return self.remote_group if self.is_inter else self.group

    def isend(self, buf, dst: int, tag: int = 0, **kw) -> Request:
        return self.ctx.p2p.isend(buf, self._world_dst(dst), tag, self.cid,
                                  **kw)

    def irecv(self, buf, src: int = ANY_SOURCE, tag: int = ANY_TAG, **kw) -> Request:
        wsrc = src if src == ANY_SOURCE else self._world_dst(src)
        req = self.ctx.p2p.irecv(buf, wsrc, tag, self.cid, **kw)

        def fix_source(r):
            if r.status.source >= 0:
                r.status.source = self._peer_group().rank_of_world(
                    r.status.source)
        req.add_completion_callback(fix_source)
        return req

    def send(self, buf, dst: int, tag: int = 0, **kw) -> None:
        self.isend(buf, dst, tag, **kw).wait()

    def recv(self, buf, src: int = ANY_SOURCE, tag: int = ANY_TAG, **kw):
        return self.irecv(buf, src, tag, **kw).wait()

    def send_init(self, buf, dst: int, tag: int = 0, **kw):
        """MPI_Send_init: persistent requests are a later slice."""
        raise NotImplementedError(_PERSISTENT)

    def ssend_init(self, buf, dst: int, tag: int = 0, **kw):
        raise NotImplementedError(_PERSISTENT)

    def recv_init(self, buf, src: int = ANY_SOURCE, tag: int = ANY_TAG,
                  **kw):
        """MPI_Recv_init: persistent requests are a later slice."""
        raise NotImplementedError(_PERSISTENT)

    def sendrecv(self, sendbuf, dst: int, recvbuf, src: int,
                 sendtag: int = 0, recvtag: int = ANY_TAG):
        rreq = self.irecv(recvbuf, src, recvtag)
        sreq = self.isend(sendbuf, dst, sendtag)
        st = rreq.wait()
        sreq.wait()
        return st

    def probe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG, timeout=None):
        wsrc = src if src == ANY_SOURCE else self._world_dst(src)
        st = self.ctx.p2p.probe(wsrc, tag, self.cid, timeout=timeout)
        if st and st["source"] >= 0:
            st["source"] = self._peer_group().rank_of_world(st["source"])
        return st

    def iprobe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG):
        wsrc = src if src == ANY_SOURCE else self._world_dst(src)
        st = self.ctx.p2p.iprobe(wsrc, tag, self.cid)
        if st and st["source"] >= 0:
            st["source"] = self._peer_group().rank_of_world(st["source"])
        return st

    # -- matched probe (MPI_Mprobe family, ≙ ompi/message/) -----------------

    def _fix_msg(self, msg):
        if msg is not None and msg.status["source"] >= 0:
            msg.status["source"] = self._peer_group().rank_of_world(
                msg.status["source"])
        return msg

    def improbe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG):
        wsrc = src if src == ANY_SOURCE else self._world_dst(src)
        return self._fix_msg(self.ctx.p2p.improbe(wsrc, tag, self.cid))

    def mprobe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG,
               timeout=None):
        wsrc = src if src == ANY_SOURCE else self._world_dst(src)
        return self._fix_msg(self.ctx.p2p.mprobe(wsrc, tag, self.cid,
                                                 timeout=timeout))

    def imrecv(self, msg, buf, **kw) -> Request:
        req = self.ctx.p2p.imrecv(msg, buf, **kw)

        def fix_source(r):   # world rank → comm rank, like irecv
            if r.status.source >= 0:
                r.status.source = self._peer_group().rank_of_world(
                    r.status.source)
        req.add_completion_callback(fix_source)
        return req

    def mrecv(self, msg, buf, **kw):
        return self.imrecv(msg, buf, **kw).wait()

    # -- management: dup / split / create (≙ ompi/communicator/comm.c) ------

    def dup(self, name: Optional[str] = None) -> "Communicator":
        child = self.split(color=0, key=self.rank,
                           name=name or f"{self.name}.dup")
        self._copy_attrs_to(child)       # MPI: attrs propagate on dup only
        return child

    def split(self, color: int, key: int = 0,
              name: Optional[str] = None) -> Optional["Communicator"]:
        """MPI_Comm_split. color=None (undefined) → no new communicator.

        CID allocation rides the same collective the reference uses
        (nonblocking-allreduce agreement, comm_cid.c:544
        ``ompi_comm_nextcid``): ONE allgather carries (color, key,
        world_rank, cid_counter) from every member; each rank then computes
        the identical group carve and CID assignment locally — the agreed
        base is the MAX of everyone's counter, so diverged counters (e.g.
        after a shrink only survivors saw) re-converge. No root, no serial
        O(p) message chain, no probe timeout path (round-1 weak #5)."""
        if getattr(self.ctx, "spc", None) is not None:
            self.ctx.spc.inc("comm_splits")
        undef = -(1 << 62)
        color_wire = undef if color is None else int(color)
        mine = np.array([color_wire, int(key), self.ctx.rank,
                         self._cid_counter], np.int64)
        rows = np.asarray(self.coll.allgather(self, mine))    # (size, 4)
        base_cid = int(rows[:, 3].max())
        colors = sorted({int(c) for c in rows[:, 0] if c != undef})
        with self._lock:
            self._cid_counter = max(self._cid_counter, base_cid + len(colors))
        if color is None:
            return None
        cid = base_cid + colors.index(int(color))
        # members of my color, ordered by (key, parent rank) per MPI
        members = sorted(
            (int(rows[r, 1]), r) for r in range(self.size)
            if int(rows[r, 0]) == int(color))
        world_ranks = [int(rows[r, 2]) for _k, r in members]
        return self._inherit(Communicator(self.ctx, Group(world_ranks), cid,
                                          name or f"{self.name}.split"))

    def _inherit(self, child: "Communicator") -> "Communicator":
        """New communicators inherit the parent's error handler (MPI-4
        §9.5; attributes propagate only on dup — _copy_attrs_to)."""
        child.errhandler = self.errhandler
        return child

    def create_intercomm(self, local_leader: int, bridge_comm: "Communicator",
                         remote_leader: int, tag: int = 0,
                         name: Optional[str] = None) -> "Communicator":
        """MPI_Intercomm_create: a later slice."""
        raise NotImplementedError(_INTER)

    def merge(self, high: bool = False,
              name: Optional[str] = None) -> "Communicator":
        """MPI_Intercomm_merge: a later slice."""
        raise NotImplementedError(_INTER)

    # -- attributes & error handlers (≙ ompi/attribute, ompi/errhandler) ----

    _keyval_seq = [1000]
    _keyval_fns: dict = {}

    @classmethod
    def create_keyval(cls, copy_fn=None, delete_fn=None) -> int:
        """MPI_Comm_create_keyval; copy_fn(old_comm, keyval, value) → value
        propagated on dup() (return None to drop, MPI's flag=0)."""
        cls._keyval_seq[0] += 1
        kv = cls._keyval_seq[0]
        cls._keyval_fns[kv] = (copy_fn, delete_fn)
        return kv

    @classmethod
    def free_keyval(cls, keyval: int) -> None:
        cls._keyval_fns.pop(keyval, None)

    def set_attr(self, keyval: int, value) -> None:
        self.attributes[keyval] = value

    def get_attr(self, keyval: int):
        return self.attributes.get(keyval)

    def delete_attr(self, keyval: int) -> None:
        v = self.attributes.pop(keyval, None)
        fns = self._keyval_fns.get(keyval)
        if v is not None and fns and fns[1]:
            fns[1](self, keyval, v)

    def _copy_attrs_to(self, child: "Communicator") -> None:
        for kv, v in self.attributes.items():
            copy_fn = (self._keyval_fns.get(kv) or (None, None))[0]
            if copy_fn is None:
                continue            # MPI default: not propagated
            new = copy_fn(self, kv, v)
            if new is not None:
                child.attributes[kv] = new

    def set_errhandler(self, handler) -> None:
        """handler(comm, exc) — called by call_errhandler; None restores
        ERRORS_ARE_FATAL (exceptions propagate)."""
        self.errhandler = handler

    def call_errhandler(self, exc: Exception) -> None:
        if self.errhandler is None:
            raise exc
        self.errhandler(self, exc)

    def create_from_group(self, group: Group, name: str = "subcomm"
                          ) -> Optional["Communicator"]:
        """MPI_Comm_create semantics via split."""
        in_group = group.rank_of_world(self.ctx.rank) >= 0
        return self.split(color=0 if in_group else None, key=self.rank,
                          name=name)

    def create_group(self, group: Group, tag: int = 0,
                     name: str = "groupcomm") -> Optional["Communicator"]:
        """MPI_Comm_create_group: like create_from_group but collective
        over the GROUP's members only — non-members need not call; a
        straggler outside the group can't stall creation. The CID is
        LEADER-ALLOCATED (the group's first world rank hands out
        monotonically from its own per-process sequence) and carries the
        leader's rank, so any two such comms differ: same leader → the
        sequence separates them, different leaders → the rank field does.
        ``tag`` isolates the agreement traffic of concurrent calls (the
        reference's tag-scoped path), not the CID value."""
        me = group.rank_of_world(self.ctx.rank)
        if me < 0:
            return None
        base = -600000 - (tag % 1000) * 4
        n = len(group.world_ranks)
        with _GROUP_SEQ_LOCK:     # ctx-level seq: per-comm locks differ
            seq = getattr(self.ctx, "_group_cid_seq", 0)
            self.ctx._group_cid_seq = seq + 1
        props = np.zeros(n, np.int64)
        props[me] = seq
        right = group.world_ranks[(me + 1) % n]
        left = group.world_ranks[(me - 1) % n]
        for step in range(n - 1):
            s = (me - step) % n
            d = (me - step - 1) % n
            inbox = np.zeros(1, np.int64)
            self.ctx.p2p.sendrecv(props[s:s + 1], right, inbox, left,
                                  base, base, cid=self.cid)
            props[d] = inbox[0]
        # band 2^36: above any plausible split lineage (generation-k split
        # cids grow as 1024^k — gen 3 ≈ 2^31) yet compact enough that
        # children namespacing cid*1024+k survive three more generations
        # in int64 (the same depth budget every cid band here has)
        cid = (1 << 36) | ((group.world_ranks[0] & 0x3FFF) << 16) \
            | (int(props[0]) & 0xFFFF)
        return self._inherit(Communicator(
            self.ctx, Group(list(group.world_ranks)), cid, name))

    def split_type(self, split_type: str = "shared", key: int = 0,
                   name: str = "nodecomm") -> "Communicator":
        """MPI_Comm_split_type(COMM_TYPE_SHARED): one communicator per
        shared-memory host (the HAN/hierarchy building block). Host
        identity = the shm transport's host key when available, else
        hostname+boot-id."""
        if split_type != "shared":
            raise ValueError(f"unknown split_type {split_type!r}")
        me = _host_key().encode()[:64]
        pad = np.zeros(64, np.uint8)
        pad[:len(me)] = np.frombuffer(me, np.uint8)
        keys = np.asarray(self.coll.allgather(self, pad)).reshape(
            self.size, 64)
        uniq = sorted({bytes(k) for k in keys})
        color = uniq.index(bytes(keys[self.rank]))
        # pass key through untouched: split() already tie-breaks equal keys
        # by parent rank, and rewriting an explicit key=0 would break MPI's
        # lowest-key-first ordering
        return self.split(color=color, key=key, name=name)

    def idup(self, name: Optional[str] = None):
        """MPI_Comm_idup — executed eagerly (legal: nonblocking calls may
        complete immediately); returns a completed request carrying the
        new communicator on ``.result``."""
        from .p2p.request import CompletedRequest
        return CompletedRequest(result=self.dup(name))

    def abort(self, code: int = 1, msg: str = "") -> None:
        """MPI_Abort: tear the whole job down (the comm argument is
        advisory in practice in the reference too — mpirun kills the job).
        Routed through the control plane so every rank learns."""
        self.ctx.abort(code, msg or f"MPI_Abort on {self.name}")

    def barrier(self) -> None:
        self.coll.barrier(self)

    def free(self) -> None:
        pass

    def __repr__(self) -> str:
        return (f"Communicator({self.name}, cid={self.cid}, "
                f"rank={self.rank}/{self.size})")
