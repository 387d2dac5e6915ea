"""Optimized host collective algorithms + decision rules.

≙ the reference's algorithm library ompi/mca/coll/base/ (SURVEY.md Appendix A)
plus coll/tuned's decision machinery (coll_tuned_decision_fixed.c:55-104,
dynamic rules file coll_tuned_dynamic_file.c:58).

Algorithms implemented (reference file:line for the original; the full
SURVEY.md Appendix A inventory — linear/in-order baselines live in
coll/basic.py):
  allreduce: nonoverlapping reduce+bcast (coll_base_allreduce.c:57),
             recursive-doubling (:133), ring (:344),
             segmented/pipelined ring (:621),
             Rabenseifner reduce-scatter+allgather (:973),
             allgather+local-reduce (:1267)
  bcast:     pipeline (coll_base_bcast.c:277), chain (:305),
             binomial tree (:333), split-binary tree (:361),
             knomial (:720), scatter+allgather[-ring] (:774/:951)
  reduce:    chain (coll_base_reduce.c:384), pipeline (:414),
             binomial tree (:476), in-order binary for
             non-commutative ops (:514), Rabenseifner
             reduce-scatter+gather (:811), knomial (:1166)
  allgather: recursive-doubling (coll_base_allgather.c:85),
             sparbit (:227), ring (:330), neighbor-exchange (:456),
             two-procs (:570), [k-]bruck (:767),
             direct-messaging (:930)
  allgatherv: bruck (coll_base_allgatherv.c:95), sparbit (:259),
             ring (:371), neighbor-exchange (:498), two-procs (:643)
  alltoall:  pairwise (coll_base_alltoall.c:180), bruck (:239),
             linear-sync (:378), two-procs (:537)
  alltoallv: pairwise (coll_base_alltoallv.c:194)
  reduce_scatter: recursive-halving (coll_base_reduce_scatter.c:132),
             ring (:456), butterfly any-size/any-counts (:691)
  reduce_scatter_block: recursive-halving (:132 adapted),
             recursive-doubling (coll_base_reduce_scatter_block.c:197),
             butterfly (:691)
  barrier:   double-ring (coll_base_barrier.c:116),
             recursive-doubling/bruck (:188/:269), two-procs (:307),
             tree (:427)
  gather:    binomial (coll_base_gather.c:41), linear-sync (:208)
  scatter:   binomial (coll_base_scatter.c:63), non-blocking linear (:289)
  scan/exscan: recursive-doubling prefix (coll_base_scan.c:157)

Selection: fixed size/msg-size rules, overridable per-collective with the
``coll_tuned_<name>_algorithm`` variable and via a dynamic rules file named
by ``coll_tuned_dynamic_rules`` (lines: ``<coll> <min_comm> <min_bytes>
<algorithm>``, later lines win — the user-tunable escape hatch the reference
ships for cluster-specific tuning).

Non-commutative ops fall back to the in-order linear algorithms
(≙ coll_base_reduce.c:514 in-order binary for non-commutative).

The port's copy of ``ompi_tpu/coll/tuned.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..core import var as _var
from ..core.component import Component, component
from ..op import Op
from ..p2p.request import wait_all
from .basic import BasicModule, T_ALLGATHER, T_ALLTOALL, T_BARRIER, T_BCAST, \
    T_GATHER, T_REDUCE, T_RSCAT, T_SCAN, T_SCATTER, _inplace
from .framework import CollModule


def _sum_default(op):
    from .. import op as _op
    op = op or _op.SUM
    if op.name == "avg":
        # decision plumbing for the quantized device tier: AVG has no
        # pairwise fold, so no host algorithm can carry it — only the
        # device plane's coll/quant arm (which finalizes sum/size) can.
        raise ValueError(
            "AVG reductions are only implemented by the quantized device "
            "tier (coll/quant); host buffers must use SUM and divide, or "
            "move to the device plane")
    return op


# ---------------------------------------------------------------------------
# allreduce algorithms
# ---------------------------------------------------------------------------

def allreduce_recursive_doubling(comm, send: np.ndarray, recv: np.ndarray,
                                 op: Op) -> None:
    """coll_base_allreduce.c:133 — log2(p) rounds, full vector each round.
    Best for small messages. Non-power-of-2 handled with the standard
    fold-in/fold-out of extra ranks."""
    size, rank = comm.size, comm.rank
    recv[...] = send
    pof2 = 1 << (size.bit_length() - 1)
    rem = size - pof2
    tmp = np.empty_like(recv)
    # fold extras: ranks [0, 2*rem) pair up (even sends to odd)
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.send(recv, rank + 1, T_REDUCE)
            newrank = -1
        else:
            comm.recv(tmp, rank - 1, T_REDUCE)
            recv[...] = op.host(tmp, recv)
            newrank = rank // 2
    else:
        newrank = rank - rem
    if newrank >= 0:
        mask = 1
        while mask < pof2:
            peer_new = newrank ^ mask
            peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
            comm.sendrecv(recv, peer, tmp, peer, T_REDUCE, T_REDUCE)
            if op.commutative or peer < rank:
                recv[...] = op.host(tmp, recv)
            else:
                recv[...] = op.host(recv.copy(), tmp)
            mask <<= 1
    # unfold
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.recv(recv, rank + 1, T_REDUCE)
        else:
            comm.send(recv, rank - 1, T_REDUCE)


def _ring_bounds(n: int, size: int) -> np.ndarray:
    """Chunk boundaries of the ring schedule (np.array_split convention:
    the first n%size chunks get the extra element) — the ONE partitioning
    both ring allreduce variants and their allgather phases share."""
    base, extra = divmod(n, size)
    sizes = np.full(size, base, np.int64)
    sizes[:extra] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def _ring_allgather_phase(comm, flat: np.ndarray, bounds: np.ndarray,
                          tag: int) -> None:
    """The p-1 allgather rounds shared by ring and segmented-ring
    allreduce: each step forwards the chunk received last step."""
    size, rank = comm.size, comm.rank
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        s = (rank + 1 - step) % size
        r = (rank - step) % size
        inbox = np.empty(int(bounds[r + 1] - bounds[r]), flat.dtype)
        comm.sendrecv(flat[bounds[s]:bounds[s + 1]], right, inbox, left,
                      tag, tag)
        flat[bounds[r]:bounds[r + 1]] = inbox


def allreduce_ring(comm, send: np.ndarray, recv: np.ndarray, op: Op) -> None:
    """coll_base_allreduce.c:344 — reduce-scatter ring then allgather ring;
    bandwidth-optimal 2(p-1)/p·n bytes per rank. The identical neighbor-
    exchange schedule ring attention uses (SURVEY.md §5.7)."""
    size, rank = comm.size, comm.rank
    recv[...] = send
    if size == 1:
        return
    flat = recv.reshape(-1)
    bounds = _ring_bounds(flat.size, size)
    right, left = (rank + 1) % size, (rank - 1) % size
    # reduce-scatter phase
    for step in range(size - 1):
        s = (rank - step) % size
        r = (rank - step - 1) % size
        inbox = np.empty(int(bounds[r + 1] - bounds[r]), flat.dtype)
        comm.sendrecv(flat[bounds[s]:bounds[s + 1]], right, inbox, left,
                      T_REDUCE, T_REDUCE)
        seg = flat[bounds[r]:bounds[r + 1]]
        seg[...] = op.host(inbox, seg)
    _ring_allgather_phase(comm, flat, bounds, T_ALLGATHER)


def allreduce_rabenseifner(comm, send: np.ndarray, recv: np.ndarray,
                           op: Op) -> None:
    """coll_base_allreduce.c:973 — recursive-halving reduce-scatter followed
    by recursive-doubling allgather; best large-message algorithm on trees."""
    size, rank = comm.size, comm.rank
    recv[...] = send
    if size == 1:
        return
    flat = recv.reshape(-1)
    pof2 = 1 << (size.bit_length() - 1)
    rem = size - pof2
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.send(flat, rank + 1, T_REDUCE)
            newrank = -1
        else:
            tmp = np.empty_like(flat)
            comm.recv(tmp, rank - 1, T_REDUCE)
            flat[...] = op.host(tmp, flat)
            newrank = rank // 2
    else:
        newrank = rank - rem

    def block_span(nr: int, down_to_mask: int):
        """Span nr holds after the halving decisions for masks ≥ down_to_mask
        (halving may be uneven when the vector doesn't split in two exactly,
        so spans must be recomputed per rank, never assumed equal)."""
        blo, bhi = 0, flat.size
        m = pof2 >> 1
        while m >= down_to_mask:
            mid = blo + (bhi - blo) // 2
            if nr & m:
                blo = mid
            else:
                bhi = mid
            m >>= 1
        return blo, bhi

    if newrank >= 0:
        # recursive halving reduce-scatter over pof2 ranks
        mask = pof2 >> 1
        lo, hi = 0, flat.size
        while mask > 0:
            peer_new = newrank ^ mask
            peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
            mid = lo + (hi - lo) // 2
            if newrank & mask:
                keep_lo, keep_hi = mid, hi
                send_lo, send_hi = lo, mid
            else:
                keep_lo, keep_hi = lo, mid
                send_lo, send_hi = mid, hi
            inbox = np.empty(keep_hi - keep_lo, flat.dtype)
            comm.sendrecv(flat[send_lo:send_hi], peer, inbox, peer,
                          T_RSCAT, T_RSCAT)
            seg = flat[keep_lo:keep_hi]
            if op.commutative or peer < rank:
                seg[...] = op.host(inbox, seg)
            else:
                seg[...] = op.host(seg.copy(), inbox)
            lo, hi = keep_lo, keep_hi
            mask >>= 1
        # recursive doubling allgather, retracing in reverse; the peer's
        # current span is its own halving-path block, which can differ from
        # ours by one element per level on non-power-of-two vector sizes
        mask = 1
        while mask < pof2:
            peer_new = newrank ^ mask
            peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
            plo, phi = block_span(peer_new, mask)
            inbox = np.empty(phi - plo, flat.dtype)
            comm.sendrecv(flat[lo:hi], peer, inbox, peer,
                          T_ALLGATHER, T_ALLGATHER)
            flat[plo:phi] = inbox
            lo, hi = min(lo, plo), max(hi, phi)
            mask <<= 1
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.recv(flat, rank + 1, T_BCAST)
        else:
            comm.send(flat, rank - 1, T_BCAST)


def allreduce_segmented_ring(comm, send: np.ndarray, recv: np.ndarray,
                             op: Op, segsize: int) -> None:
    """coll_base_allreduce.c:621 — ring reduce-scatter+allgather where each
    per-step chunk transfer is pipelined in ``segsize``-byte segments: the
    next segment's sendrecv is posted (isend+irecv) before the current
    segment's reduction runs, overlapping wire time with compute. This is
    the segmented/pipelined discipline the whole coll/base library applies
    to large messages (segsize parameters throughout, SURVEY.md §5.7)."""
    size, rank = comm.size, comm.rank
    recv[...] = send
    if size == 1:
        return
    flat = recv.reshape(-1)
    seg_items = max(1, segsize // flat.dtype.itemsize)
    bounds = _ring_bounds(flat.size, size)
    right, left = (rank + 1) % size, (rank - 1) % size

    def spans(chunk):
        lo, hi = int(bounds[chunk]), int(bounds[chunk + 1])
        return [(s, min(s + seg_items, hi)) for s in range(lo, hi, seg_items)] \
            or [(lo, lo)]

    # reduce-scatter phase, depth-2 pipelined per chunk
    for step in range(size - 1):
        s_spans = spans((rank - step) % size)
        r_spans = spans((rank - step - 1) % size)
        n = max(len(s_spans), len(r_spans))
        inboxes = [np.empty(b - a, flat.dtype) for a, b in r_spans]
        sreqs, rreqs = {}, {}

        def post(j):
            if j < len(r_spans):
                rreqs[j] = comm.irecv(inboxes[j], left, T_REDUCE)
            if j < len(s_spans):
                a, b = s_spans[j]
                sreqs[j] = comm.isend(flat[a:b], right, T_REDUCE)

        post(0)
        for j in range(n):
            post(j + 1)             # next segment in flight…
            if j in rreqs:
                rreqs[j].wait()     # …while this one reduces
                a, b = r_spans[j]
                seg = flat[a:b]
                seg[...] = op.host(inboxes[j], seg)
            if j in sreqs:
                sreqs[j].wait()
    # allgather phase: pure copy — single-segment pipelining gains nothing
    _ring_allgather_phase(comm, flat, bounds, T_ALLGATHER)


# ---------------------------------------------------------------------------
# bcast / reduce trees
# ---------------------------------------------------------------------------

def _binomial_children(rank: int, size: int, root: int):
    """Binomial tree rooted at root (≙ coll_base_topo.c:331 bmtree)."""
    vrank = (rank - root) % size
    children = []
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + root) % size
            return parent, children
        child = vrank | mask
        if child < size:
            children.append((child + root) % size)
        mask <<= 1
    return None, children


def bcast_binomial(comm, buf: np.ndarray, root: int) -> None:
    """coll_base_bcast.c:333."""
    parent, children = _binomial_children(comm.rank, comm.size, root)
    if parent is not None:
        comm.recv(buf, parent, T_BCAST)
    reqs = [comm.isend(buf, c, T_BCAST) for c in reversed(children)]
    wait_all(reqs)


def bcast_scatter_allgather(comm, buf: np.ndarray, root: int) -> None:
    """coll_base_bcast.c:774 — binomial scatter then ring allgather;
    bandwidth-optimal for large messages."""
    size, rank = comm.size, comm.rank
    flat = buf.reshape(-1)
    counts = [len(c) for c in np.array_split(np.arange(flat.size), size)]
    displs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    vrank = (rank - root) % size
    # binomial scatter of segments
    parent, _children = _binomial_children(rank, size, root)
    mask = 1 << max(0, size.bit_length() - 1)
    # receive my subtree's span from parent
    def span(vr, m):
        lo = displs[vr]
        hi_rank = min(size - 1, vr + m - 1)
        hi = displs[hi_rank] + counts[hi_rank]
        return lo, hi
    if parent is not None:
        m = 1
        while not (vrank & m):
            m <<= 1
        lo, hi = span(vrank, m)
        comm.recv(flat[lo:hi], parent, T_BCAST)
    m = 1
    while m < size:
        if vrank & m:
            break
        m <<= 1
    m >>= 1
    while m >= 1:
        vchild = vrank | m
        if vchild < size:
            lo, hi = span(vchild, m)
            comm.send(flat[lo:hi], (vchild + root) % size, T_BCAST)
        m >>= 1
    # ring allgather of segments
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        sv = (vrank - step) % size
        rv = (vrank - step - 1) % size
        s_lo, s_hi = displs[sv], displs[sv] + counts[sv]
        r_lo, r_hi = displs[rv], displs[rv] + counts[rv]
        inbox = np.empty(r_hi - r_lo, flat.dtype)
        comm.sendrecv(flat[s_lo:s_hi], right, inbox, left,
                      T_ALLGATHER, T_ALLGATHER)
        flat[r_lo:r_hi] = inbox


def _segments(flat: np.ndarray, segsize: int):
    seg_items = max(1, segsize // flat.dtype.itemsize)
    return [flat[i:i + seg_items] for i in range(0, flat.size, seg_items)] \
        or [flat]


def bcast_pipeline(comm, buf: np.ndarray, root: int, segsize: int,
                   chains: int = 1) -> None:
    """coll_base_bcast.c:277 (pipeline) / :305 (chain): non-root ranks form
    ``chains`` chains hanging off the root; the message streams down each
    chain in segsize segments, every rank forwarding segment j to its child
    while segment j+1 is still arriving (all receives pre-posted). pipeline
    = chain with chains=1."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    flat = buf.reshape(-1)
    segs = _segments(flat, segsize)
    chains = max(1, min(chains, size - 1))
    clen = -(-(size - 1) // chains)          # ceil chain length
    if rank == root:
        heads = [(root + 1 + c * clen) % size
                 for c in range(chains) if c * clen < size - 1]
        sreqs = []
        for s in segs:
            for h in heads:
                sreqs.append(comm.isend(s, h, T_BCAST))
        wait_all(sreqs)
        return
    idx = (rank - root) % size - 1           # position among non-root ranks
    pos = idx % clen
    parent = root if pos == 0 else (rank - 1 + size) % size
    nxt = idx + 1
    child = None
    if pos + 1 < clen and nxt < size - 1:
        child = (rank + 1) % size
    rreqs = [comm.irecv(s, parent, T_BCAST) for s in segs]
    sreqs = []
    for j, s in enumerate(segs):
        rreqs[j].wait()
        if child is not None:
            sreqs.append(comm.isend(s, child, T_BCAST))
    wait_all(sreqs)


def _knomial_tree(rank: int, size: int, root: int, radix: int):
    """K-nomial tree (≙ coll_base_topo.c:479 kmtree): a vrank's parent
    clears its least-significant nonzero base-radix digit; its children add
    d*mask for every level below that digit."""
    vrank = (rank - root) % size
    children = []
    mask = 1
    parent = None
    while mask < size:
        digit = (vrank // mask) % radix
        if digit:
            parent = ((vrank - digit * mask) + root) % size
            break
        for d in range(1, radix):
            child = vrank + d * mask
            if child < size:
                children.append((child + root) % size)
        mask *= radix
    return parent, children


def bcast_knomial(comm, buf: np.ndarray, root: int, radix: int) -> None:
    """coll_base_bcast.c:720 — radix-k binomial tree: shallower than
    binomial (log_k p rounds) at the cost of k-1 sends per internal node;
    wins for small messages where latency dominates."""
    parent, children = _knomial_tree(comm.rank, comm.size, root,
                                     max(2, radix))
    if parent is not None:
        comm.recv(buf, parent, T_BCAST)
    # farthest (largest-subtree) children first, like the reference
    reqs = [comm.isend(buf, c, T_BCAST) for c in reversed(children)]
    wait_all(reqs)


def reduce_inorder_binary(comm, send: np.ndarray, recv: Optional[np.ndarray],
                          op: Op, root: int) -> Optional[np.ndarray]:
    """coll_base_reduce.c:514 — in-order binary tree for NON-commutative
    ops: the reduction combines rank ranges strictly as
    op(ranks lo..mid-1, ranks mid..hi), so the result equals the canonical
    left-to-right fold regardless of tree shape."""
    rank = comm.rank

    def reduce_range(lo: int, hi: int):
        """Value of fold(lo..hi), landing on rank lo; None elsewhere."""
        if lo == hi:
            return send.copy() if rank == lo else None
        mid = (lo + hi + 1) // 2
        if rank < mid:
            v = reduce_range(lo, mid - 1)
            if rank == lo:
                tmp = np.empty_like(send)
                comm.recv(tmp, mid, T_REDUCE)
                return op.host(v, tmp)        # left range before right range
            return None
        v = reduce_range(mid, hi)
        if rank == mid:
            comm.send(v, lo, T_REDUCE)
        return None

    acc = reduce_range(0, comm.size - 1)
    if root != 0:                        # relocate the fold to the root
        if rank == 0:
            comm.send(acc, root, T_REDUCE)
            return None
        if rank == root:
            acc = np.empty_like(send)
            comm.recv(acc, 0, T_REDUCE)
    if rank != root:
        return None
    if recv is None:
        recv = np.empty_like(send)
    recv[...] = acc
    return recv


def reduce_binomial(comm, send: np.ndarray, recv: Optional[np.ndarray],
                    op: Op, root: int) -> Optional[np.ndarray]:
    """coll_base_reduce.c:476 — commutative ops only (callers guard)."""
    acc = send.copy()
    rank, size = comm.rank, comm.size
    vrank = (rank - root) % size
    tmp = np.empty_like(acc)
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + root) % size
            comm.send(acc, parent, T_REDUCE)
            return None
        vchild = vrank | mask
        if vchild < size:
            comm.recv(tmp, (vchild + root) % size, T_REDUCE)
            acc = op.host(tmp, acc)
        mask <<= 1
    if recv is None:
        recv = np.empty_like(send)
    recv[...] = acc
    return recv


def reduce_pipeline(comm, send: np.ndarray, recv: Optional[np.ndarray],
                    op: Op, root: int, segsize: int) -> Optional[np.ndarray]:
    """coll_base_reduce.c:414 — segmented chain toward the root: each rank
    receives its child's partial segment, folds it (own value as the LEFT
    operand, so the fold is associativity-equivalent to the canonical
    order), and forwards — segment k+1 arrives while segment k reduces.
    Like every segmented algorithm, valid for ELEMENTWISE ops only (all
    MPI predefined ops are; whole-buffer user ops go through the in-order
    tree instead)."""
    size, rank = comm.size, comm.rank
    vrank = (rank - root) % size
    acc = np.asarray(send).copy()
    flat = acc.reshape(-1)
    segs = _segments(flat, segsize)
    child = ((vrank + 1) + root) % size if vrank + 1 < size else None
    parent = ((vrank - 1) + root) % size if vrank > 0 else None
    rreqs = []
    if child is not None:
        inboxes = [np.empty_like(s) for s in segs]
        rreqs = [comm.irecv(b, child, T_REDUCE) for b in inboxes]
    sreqs = []
    for j, s in enumerate(segs):
        if child is not None:
            rreqs[j].wait()
            s[...] = op.host(s.copy(), inboxes[j])   # own left, child right
        if parent is not None:
            sreqs.append(comm.isend(s, parent, T_REDUCE))
    wait_all(sreqs)
    if rank != root:
        return None
    if recv is None:
        recv = np.empty_like(np.asarray(send))
    recv[...] = acc
    return recv


def gather_binomial(comm, send: np.ndarray, recv: Optional[np.ndarray],
                    root: int) -> Optional[np.ndarray]:
    """coll_base_gather.c:41 — binomial tree: each internal node forwards
    its whole contiguous vrank-subtree block in one message (log p rounds,
    vs p-1 messages at the linear root)."""
    size, rank = comm.size, comm.rank
    vrank = (rank - root) % size
    row = np.asarray(send).reshape(-1)
    # scratch = only MY subtree (lowbit(vrank) rows; the root holds all):
    # a leaf allocates 1 row, not O(p·n) (r2 review finding)
    subtree = size if vrank == 0 else min(vrank & -vrank, size - vrank)
    work = np.empty((subtree, row.size), row.dtype)
    work[0] = row
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + root) % size
            comm.send(work[:min(mask, size - vrank)], parent, T_GATHER)
            return None
        vchild = vrank | mask
        if vchild < size:
            cnt = min(mask, size - vchild)
            comm.recv(work[mask:mask + cnt], (vchild + root) % size,
                      T_GATHER)
        mask <<= 1
    if recv is None:
        recv = np.empty((size,) + np.asarray(send).shape, row.dtype)
    out = recv.reshape(size, -1)
    for v in range(size):            # un-rotate vrank order → global ranks
        out[(v + root) % size] = work[v]
    return recv


def scatter_binomial(comm, send: Optional[np.ndarray], recv: np.ndarray,
                     root: int) -> np.ndarray:
    """coll_base_scatter.c:63 — the gather tree reversed: the root peels
    off subtree blocks; each internal node forwards its children's."""
    size, rank = comm.size, comm.rank
    vrank = (rank - root) % size
    recv = np.asarray(recv)
    blk = recv.reshape(-1).size
    if vrank == 0:
        parts = np.asarray(send).reshape(size, -1)
        work = np.empty((size, blk), parts.dtype)
        for g in range(size):        # rotate global ranks → vrank order
            work[(g - root) % size] = parts[g]
    else:
        # my subtree block arrives from the parent in one message
        sub = 1
        while not (vrank & sub):
            sub <<= 1
        cnt = min(sub, size - vrank)
        work = np.empty((cnt, blk), recv.dtype)
        parent = ((vrank & ~sub) + root) % size
        comm.recv(work, parent, T_SCATTER)
    mask = 1
    while mask < size and not (vrank & mask):
        mask <<= 1
    m = mask >> 1
    while m >= 1:                    # forward sub-blocks, farthest first
        vchild = vrank | m
        if vchild < size:
            cnt = min(m, size - vchild)
            comm.send(np.ascontiguousarray(work[m:m + cnt]),
                      (vchild + root) % size, T_SCATTER)
        m >>= 1
    recv.reshape(-1)[:] = work[0]
    return recv


def barrier_double_ring(comm) -> None:
    """coll_base_barrier.c:116 — the token circles twice; 2p messages but
    only nearest-neighbor links (the topology-friendliest barrier)."""
    size, rank = comm.size, comm.rank
    token = np.zeros(0, np.uint8)
    right, left = (rank + 1) % size, (rank - 1) % size
    for _round in range(2):
        if rank == 0:
            comm.send(token, right, T_BARRIER)
            comm.recv(token, left, T_BARRIER)
        else:
            comm.recv(token, left, T_BARRIER)
            comm.send(token, right, T_BARRIER)


def allgatherv_ring(comm, send: np.ndarray, recv: np.ndarray,
                    counts: Sequence[int], displs: Sequence[int]) -> None:
    """coll_base_allgatherv.c:371 — the ring schedule with per-rank block
    sizes; p-1 neighbor exchanges instead of the basic component's p-1
    point-to-point pairs per rank."""
    size, rank = comm.size, comm.rank
    flat = recv.reshape(-1)
    flat[displs[rank]:displs[rank] + counts[rank]] = \
        np.asarray(send).reshape(-1)
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        s = (rank - step) % size
        d = (rank - step - 1) % size
        inbox = np.empty(counts[d], flat.dtype)
        comm.sendrecv(flat[displs[s]:displs[s] + counts[s]], right,
                      inbox, left, T_ALLGATHER, T_ALLGATHER)
        flat[displs[d]:displs[d] + counts[d]] = inbox


# ---------------------------------------------------------------------------
# allgather / alltoall / reduce_scatter / barrier
# ---------------------------------------------------------------------------

def allgather_recursive_doubling(comm, send: np.ndarray,
                                 recv: np.ndarray) -> None:
    """coll_base_allgather.c:85 — power-of-2 comms."""
    size, rank = comm.size, comm.rank
    parts = recv.reshape(size, -1)
    parts[rank] = send.reshape(-1)
    mask = 1
    while mask < size:
        peer = rank ^ mask
        block = (rank // mask) * mask
        peer_block = (peer // mask) * mask
        outbox = parts[block:block + mask]
        inbox = np.empty_like(parts[peer_block:peer_block + mask])
        comm.sendrecv(outbox, peer, inbox, peer, T_ALLGATHER, T_ALLGATHER)
        parts[peer_block:peer_block + mask] = inbox
        mask <<= 1


def allgather_ring(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_allgather.c:330 — the uniform-counts case of the ring
    schedule (one implementation, see allgatherv_ring)."""
    n = recv.reshape(comm.size, -1).shape[1]
    allgatherv_ring(comm, send, recv, [n] * comm.size,
                    [i * n for i in range(comm.size)])


def allgather_bruck(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_allgather.c:767 (k=2 Bruck): log2(p) rounds, any p."""
    size, rank = comm.size, comm.rank
    parts = recv.reshape(size, -1)
    # local rotation: my block first
    work = np.empty_like(parts)
    work[0] = send.reshape(-1)
    have = 1
    dist = 1
    while dist < size:
        peer_to = (rank - dist) % size
        peer_from = (rank + dist) % size
        blkcount = min(have, size - have)
        inbox = np.empty((blkcount, parts.shape[1]), parts.dtype)
        comm.sendrecv(work[:blkcount], peer_to, inbox, peer_from,
                      T_ALLGATHER, T_ALLGATHER)
        work[have:have + blkcount] = inbox[:min(blkcount, size - have)]
        have += blkcount
        dist <<= 1
    # un-rotate: work[i] holds block (rank + i) mod size
    for i in range(size):
        parts[(rank + i) % size] = work[i]


def alltoall_pairwise(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_alltoall.c:180 — p-1 exchange rounds with xor/offset pairing."""
    size, rank = comm.size, comm.rank
    sp = send.reshape(size, -1)
    rp = recv.reshape(size, -1)
    rp[rank] = sp[rank]
    for step in range(1, size):
        sendto = (rank + step) % size
        recvfrom = (rank - step) % size
        comm.sendrecv(sp[sendto], sendto, rp[recvfrom], recvfrom,
                      T_ALLTOALL, T_ALLTOALL)


def alltoall_bruck(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_alltoall.c:239 — log2(p) rounds for small messages."""
    size, rank = comm.size, comm.rank
    sp = send.reshape(size, -1)
    # phase 1: local rotation so block i is for rank (rank+i)%size
    work = np.roll(sp, -rank, axis=0).copy()
    pof = 1
    while pof < size:
        mask_blocks = [i for i in range(size) if i & pof]
        outbox = work[mask_blocks].copy()
        inbox = np.empty_like(outbox)
        comm.sendrecv(outbox, (rank + pof) % size, inbox, (rank - pof) % size,
                      T_ALLTOALL, T_ALLTOALL)
        work[mask_blocks] = inbox
        pof <<= 1
    # phase 3: inverse rotation + reversal
    rp = recv.reshape(size, -1)
    for i in range(size):
        rp[(rank - i) % size] = work[i]


def reduce_scatter_block_recursive_halving(comm, send: np.ndarray,
                                           recv: np.ndarray, op: Op) -> None:
    """coll_base_reduce_scatter.c:132 adapted to equal blocks (pof2 only)."""
    size, rank = comm.size, comm.rank
    flat = send.reshape(-1).copy()
    blk = flat.size // size
    lo, hi = 0, flat.size
    mask = size >> 1
    while mask > 0:
        peer = rank ^ mask
        mid = lo + (hi - lo) // 2
        if rank & mask:
            keep_lo, keep_hi, send_lo, send_hi = mid, hi, lo, mid
        else:
            keep_lo, keep_hi, send_lo, send_hi = lo, mid, mid, hi
        inbox = np.empty(keep_hi - keep_lo, flat.dtype)
        comm.sendrecv(flat[send_lo:send_hi], peer, inbox, peer,
                      T_RSCAT, T_RSCAT)
        seg = flat[keep_lo:keep_hi]
        if op.commutative or peer < rank:
            seg[...] = op.host(inbox, seg)
        else:
            seg[...] = op.host(seg.copy(), inbox)
        lo, hi = keep_lo, keep_hi
        mask >>= 1
    recv.reshape(-1)[:] = flat[rank * blk:(rank + 1) * blk]


def allgather_neighbor_exchange(comm, send: np.ndarray,
                                recv: np.ndarray) -> None:
    """coll_base_allgather.c:456 — even comm sizes: p/2 rounds alternating
    between the two ring neighbors; each round forwards the pair of blocks
    learned in the previous round. Half the rounds of ring for the same
    per-round payload shape."""
    size, rank = comm.size, comm.rank
    parts = recv.reshape(size, -1)
    parts[rank] = send.reshape(-1)
    sched = _neighbor_exchange_schedule(size)[rank]
    for peer, send_blocks, recv_blocks in sched:
        outbox = parts[send_blocks].copy()
        inbox = np.empty((len(recv_blocks), parts.shape[1]), parts.dtype)
        comm.sendrecv(outbox, peer, inbox, peer, T_ALLGATHER, T_ALLGATHER)
        parts[recv_blocks] = inbox


_NE_SCHED_CACHE: dict = {}


def _neighbor_exchange_schedule(size: int):
    """Per-rank [(peer, send_block_ids, recv_block_ids)] for the
    neighbor-exchange rounds; deterministic, cached per comm size."""
    sched = _NE_SCHED_CACHE.get(size)
    if sched is not None:
        return sched
    recent = {r: [r] for r in range(size)}
    sched = {r: [] for r in range(size)}
    for step in range(size // 2):
        peers = {}
        for r in range(size):
            if (r % 2 == 0) == (step % 2 == 0):
                peers[r] = (r + 1) % size
            else:
                peers[r] = (r - 1) % size
        nxt = {}
        for r in range(size):
            p = peers[r]
            sched[r].append((p, list(recent[r]), list(recent[p])))
            nxt[r] = [r, p] if step == 0 else list(recent[p])
        recent = nxt
    _NE_SCHED_CACHE[size] = sched
    return sched


def reduce_scatter_butterfly(comm, send: np.ndarray, recv: np.ndarray,
                             counts: Sequence[int], displs: Sequence[int],
                             op: Op) -> None:
    """coll_base_reduce_scatter.c:691 — butterfly for ANY comm size and
    arbitrary per-rank counts: non-power-of-two remainders fold their full
    vector into a partner first, the 2^k survivors run recursive vector
    halving along original-block boundaries, then folded-out ranks get
    their block back."""
    size, rank = comm.size, comm.rank
    flat = np.asarray(send).reshape(-1).astype(send.dtype, copy=True)
    total = flat.size
    pof2 = 1 << (size.bit_length() - 1)
    rem = size - pof2
    myview = recv.reshape(-1)
    if rank < 2 * rem:
        if rank % 2 == 0:           # folds out; receives its block at the end
            comm.send(flat, rank + 1, T_RSCAT)
            comm.recv(myview, rank + 1, T_RSCAT)
            return
        tmp = np.empty_like(flat)
        comm.recv(tmp, rank - 1, T_RSCAT)
        flat[...] = op.host(tmp, flat)
        newrank = rank // 2
    else:
        newrank = rank - rem

    def start_block(nr: int) -> int:      # first original block nr represents
        return 2 * nr if nr < rem else nr + rem

    def bound(g: int) -> int:             # element offset of group boundary g
        return total if g >= pof2 else int(displs[start_block(g)])

    glo, ghi = 0, pof2
    mask = pof2 >> 1
    while mask > 0:
        peer_new = newrank ^ mask
        peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
        gmid = glo + mask
        if newrank & mask:
            keep = (gmid, ghi)
            send_rng = (glo, gmid)
        else:
            keep = (glo, gmid)
            send_rng = (gmid, ghi)
        k_lo, k_hi = bound(keep[0]), bound(keep[1])
        s_lo, s_hi = bound(send_rng[0]), bound(send_rng[1])
        inbox = np.empty(k_hi - k_lo, flat.dtype)
        comm.sendrecv(flat[s_lo:s_hi], peer, inbox, peer, T_RSCAT, T_RSCAT)
        seg = flat[k_lo:k_hi]
        seg[...] = op.host(inbox, seg)
        glo, ghi = keep
        mask >>= 1
    # newrank now holds the reduced segment for its original block(s)
    b0 = start_block(newrank)
    if newrank < rem:                     # deliver the even partner's block
        comm.send(flat[displs[b0]:displs[b0] + counts[b0]], rank - 1, T_RSCAT)
        b0 += 1
    myview[:] = flat[displs[b0]:displs[b0] + counts[b0]]


def reduce_scatter_block_butterfly(comm, send: np.ndarray,
                                   recv: np.ndarray, op: Op) -> None:
    """coll_base_reduce_scatter.c:691, equal-block case (see
    reduce_scatter_butterfly for the general-counts engine)."""
    size = comm.size
    blk = np.asarray(send).reshape(-1).size // size
    reduce_scatter_butterfly(comm, send, recv, [blk] * size,
                             [i * blk for i in range(size)], op)


def barrier_recursive_doubling(comm) -> None:
    """coll_base_barrier.c:188; bruck (:269) handles non-pof2 the same way
    here because sendrecv pairs are symmetric per round."""
    size, rank = comm.size, comm.rank
    token = np.zeros(0, np.uint8)
    mask = 1
    while mask < size:
        to = (rank + mask) % size
        frm = (rank - mask) % size
        comm.sendrecv(token, to, token, frm, T_BARRIER, T_BARRIER)
        mask <<= 1


def scan_recursive_doubling(comm, send: np.ndarray, recv: np.ndarray,
                            op: Op, exclusive: bool) -> None:
    """coll_base_scan.c:157 — log2(p) rounds; ok for non-commutative because
    partner ordering is preserved."""
    size, rank = comm.size, comm.rank
    total = send.copy()        # running op over my prefix window
    have_prefix = False
    prefix = np.empty_like(send)
    tmp = np.empty_like(send)
    mask = 1
    while mask < size:
        lo_peer = rank - mask
        hi_peer = rank + mask
        reqs = []
        if hi_peer < size:
            reqs.append(comm.isend(total, hi_peer, T_SCAN))
        if lo_peer >= 0:
            comm.recv(tmp, lo_peer, T_SCAN)
            if have_prefix:
                prefix[...] = op.host(tmp, prefix)
            else:
                prefix[...] = tmp
                have_prefix = True
            total = op.host(tmp.copy(), total)
        wait_all(reqs)
        mask <<= 1
    if exclusive:
        if have_prefix:
            recv[...] = prefix
    else:
        recv[...] = op.host(prefix, send.copy()) if have_prefix else send


# ---------------------------------------------------------------------------
# block-exchange schedule engine (shared by sparbit / bruck / k-bruck /
# neighbor-exchange allgather[v] variants)
# ---------------------------------------------------------------------------

import threading
from collections import OrderedDict

_BLOCK_SCHED_CACHE: OrderedDict = OrderedDict()
_BLOCK_SCHED_CACHE_MAX = 32   # LRU bound — see scaling note below
# run_ranks ranks are threads in one process, and they all hit the cache
# during block-exchange collectives — the LRU reorder/evict pair must not
# race (a concurrent evict between get and move_to_end would KeyError)
_BLOCK_SCHED_LOCK = threading.Lock()


def _block_schedule(size: int, distances: tuple, radix: int):
    """Precompute a deterministic block-exchange schedule: in the round for
    distance d, every rank sends to (rank - j*d) % size for j in 1..radix-1
    all blocks it holds that the receiver neither holds nor has been
    promised earlier this round, and symmetrically receives from
    (rank + j*d).  Built by simulating all ranks at once, so both endpoints
    of every message agree on its block list (and size) by construction —
    the same determinism argument as the neighbor-exchange schedule.

    Distance-halving distances give sparbit (coll_base_allgather.c:227),
    distance-doubling gives Bruck without the final rotation (:767 /
    allgatherv :95) — blocks travel addressed by their ORIGINAL indices, so
    no rotation pass is needed and per-rank counts may vary freely.

    Scaling: simulating all ranks costs O(p²·log p·radix) time and O(p²)
    memory per distinct (size, distances, radix) — fine for TPU-host comm
    sizes (tens of ranks); the decision tables route very large comms to
    ring/recursive-doubling variants first. The cache is a small LRU so
    many distinct comm sizes in one job cannot accumulate unboundedly."""
    key = (size, distances, radix)
    with _BLOCK_SCHED_LOCK:
        cached = _BLOCK_SCHED_CACHE.get(key)
        if cached is not None:
            _BLOCK_SCHED_CACHE.move_to_end(key)
            return cached
    have = {r: {r} for r in range(size)}
    order = {r: [r] for r in range(size)}   # deterministic block ordering
    rounds = {r: [] for r in range(size)}
    for d in distances:
        snap_order = {r: list(order[r]) for r in range(size)}
        snap_have = {r: set(have[r]) for r in range(size)}
        promised = {r: set() for r in range(size)}
        entry = {r: ([], []) for r in range(size)}
        for j in range(1, radix):
            for r in range(size):
                frm = (r + j * d) % size
                if frm == r:
                    continue
                rb = [b for b in snap_order[frm]
                      if b not in snap_have[r] and b not in promised[r]]
                if not rb:
                    continue
                promised[r].update(rb)
                entry[r][1].append((frm, rb))     # my recv
                entry[frm][0].append((r, rb))     # the matching send
        for r in range(size):
            rounds[r].append(entry[r])
            for _frm, rb in entry[r][1]:
                for b in rb:
                    have[r].add(b)
                    order[r].append(b)
    assert all(len(have[r]) == size for r in range(size)), \
        "block schedule incomplete"
    with _BLOCK_SCHED_LOCK:
        _BLOCK_SCHED_CACHE[key] = rounds
        while len(_BLOCK_SCHED_CACHE) > _BLOCK_SCHED_CACHE_MAX:
            _BLOCK_SCHED_CACHE.popitem(last=False)
    return rounds


def _run_block_schedule(comm, rounds, get, tag) -> None:
    """Execute one rank's schedule; ``get(b)`` returns the (already-sized)
    destination view for block b — sends concatenate current views, recvs
    scatter back into them."""
    for sends, recvs in rounds:
        rinfo = []
        for frm, blocks in recvs:
            views = [get(b).reshape(-1) for b in blocks]
            inbox = np.empty(int(sum(v.size for v in views)),
                             views[0].dtype)
            rinfo.append((comm.irecv(inbox, frm, tag), views, inbox))
        sreqs = []
        for to, blocks in sends:
            out = get(blocks[0]).reshape(-1) if len(blocks) == 1 else \
                np.concatenate([get(b).reshape(-1) for b in blocks])
            sreqs.append(comm.isend(out, to, tag))
        for req, views, inbox in rinfo:
            req.wait()
            off = 0
            for v in views:
                v[...] = inbox[off:off + v.size]
                off += v.size
        wait_all(sreqs)


def _doubling_distances(size: int, radix: int = 2) -> tuple:
    d, out = 1, []
    while d < size:
        out.append(d)
        d *= radix
    return tuple(out)


def allgather_sparbit(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_allgather.c:227 — sparbit: distance-HALVING block
    exchanges, ceil(log2 p) rounds for any p, no Bruck-style final
    rotation (blocks are addressed by their original indices)."""
    size, rank = comm.size, comm.rank
    parts = recv.reshape(size, -1)
    parts[rank] = send.reshape(-1)
    dists = tuple(reversed(_doubling_distances(size)))
    rounds = _block_schedule(size, dists, 2)[rank]
    _run_block_schedule(comm, rounds, lambda b: parts[b], T_ALLGATHER)


def allgather_kbruck(comm, send: np.ndarray, recv: np.ndarray,
                     radix: int) -> None:
    """coll_base_allgather.c:767 — radix-k Bruck: ceil(log_k p) rounds,
    up to k-1 peers per round (distance-doubling in base k); shallower
    than k=2 when latency dominates and ports allow concurrent sends."""
    size, rank = comm.size, comm.rank
    radix = max(2, radix)
    parts = recv.reshape(size, -1)
    parts[rank] = send.reshape(-1)
    rounds = _block_schedule(size, _doubling_distances(size, radix),
                             radix)[rank]
    _run_block_schedule(comm, rounds, lambda b: parts[b], T_ALLGATHER)


def allgather_two_procs(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_allgather.c:570 — the 2-rank special case: one sendrecv."""
    rank = comm.rank
    parts = recv.reshape(2, -1)
    parts[rank] = send.reshape(-1)
    peer = 1 - rank
    comm.sendrecv(parts[rank], peer, parts[peer], peer,
                  T_ALLGATHER, T_ALLGATHER)


def allgather_direct(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_allgather.c:930 — direct messaging: p-1 concurrent
    isend/irecv pairs; one round, maximal port pressure."""
    size, rank = comm.size, comm.rank
    parts = recv.reshape(size, -1)
    parts[rank] = send.reshape(-1)
    reqs = []
    for peer in range(size):
        if peer == rank:
            continue
        reqs.append(comm.irecv(parts[peer], peer, T_ALLGATHER))
        reqs.append(comm.isend(parts[rank], peer, T_ALLGATHER))
    wait_all(reqs)


def _v_accessor(flat: np.ndarray, counts: Sequence[int],
                displs: Sequence[int]):
    return lambda b: flat[int(displs[b]):int(displs[b]) + int(counts[b])]


def allgatherv_bruck(comm, send: np.ndarray, recv: np.ndarray,
                     counts: Sequence[int], displs: Sequence[int]) -> None:
    """coll_base_allgatherv.c:95 — Bruck with per-rank counts; the
    original-index addressing of the schedule engine removes the final
    rotation the reference needs."""
    size, rank = comm.size, comm.rank
    flat = recv.reshape(-1)
    acc = _v_accessor(flat, counts, displs)
    acc(rank)[...] = np.asarray(send).reshape(-1)
    rounds = _block_schedule(size, _doubling_distances(size), 2)[rank]
    _run_block_schedule(comm, rounds, acc, T_ALLGATHER)


def allgatherv_sparbit(comm, send: np.ndarray, recv: np.ndarray,
                       counts: Sequence[int], displs: Sequence[int]) -> None:
    """coll_base_allgatherv.c:259 — sparbit with per-rank counts."""
    size, rank = comm.size, comm.rank
    flat = recv.reshape(-1)
    acc = _v_accessor(flat, counts, displs)
    acc(rank)[...] = np.asarray(send).reshape(-1)
    dists = tuple(reversed(_doubling_distances(size)))
    rounds = _block_schedule(size, dists, 2)[rank]
    _run_block_schedule(comm, rounds, acc, T_ALLGATHER)


def allgatherv_neighbor_exchange(comm, send: np.ndarray, recv: np.ndarray,
                                 counts: Sequence[int],
                                 displs: Sequence[int]) -> None:
    """coll_base_allgatherv.c:498 — even comm sizes (caller guards)."""
    size, rank = comm.size, comm.rank
    flat = recv.reshape(-1)
    acc = _v_accessor(flat, counts, displs)
    acc(rank)[...] = np.asarray(send).reshape(-1)
    rounds = [([(peer, sb)], [(peer, rb)])
              for peer, sb, rb in _neighbor_exchange_schedule(size)[rank]]
    _run_block_schedule(comm, rounds, acc, T_ALLGATHER)


def allgatherv_two_procs(comm, send: np.ndarray, recv: np.ndarray,
                         counts: Sequence[int],
                         displs: Sequence[int]) -> None:
    """coll_base_allgatherv.c:643."""
    rank = comm.rank
    flat = recv.reshape(-1)
    acc = _v_accessor(flat, counts, displs)
    acc(rank)[...] = np.asarray(send).reshape(-1)
    peer = 1 - rank
    comm.sendrecv(acc(rank), peer, acc(peer), peer,
                  T_ALLGATHER, T_ALLGATHER)


# ---------------------------------------------------------------------------
# remaining allreduce / bcast / reduce variants
# ---------------------------------------------------------------------------

def allreduce_nonoverlapping(comm, send: np.ndarray, recv: np.ndarray,
                             op: Op) -> None:
    """coll_base_allreduce.c:57 — reduce to rank 0 then bcast; the plain
    composition the overlapped algorithms are measured against."""
    reduce_binomial(comm, send, recv if comm.rank == 0 else None, op, 0)
    bcast_binomial(comm, recv, 0)


def allreduce_allgather_reduce(comm, send: np.ndarray, recv: np.ndarray,
                               op: Op) -> None:
    """coll_base_allreduce.c:1267 — allgather every contribution then fold
    locally in strict rank order: p·n bytes, but a canonical fold, so valid
    for ANY op including non-commutative ones."""
    size = comm.size
    gath = np.empty((size,) + send.shape, send.dtype)
    allgather_bruck(comm, send, gath)
    acc = gath[0].copy()
    for i in range(1, size):
        acc = op.host(acc, gath[i])
    recv[...] = acc


def bcast_split_binary(comm, buf: np.ndarray, root: int) -> None:
    """coll_base_bcast.c:361 — split-binary tree: the message is halved;
    each half is binomial-bcast down one of the two subtrees hanging off
    the root, then mirror ranks of the two subtrees swap halves pairwise
    (every rank sends ~n/2 + receives n, vs n down every tree edge)."""
    size, rank = comm.size, comm.rank
    flat = buf.reshape(-1)
    if size <= 3 or flat.size < 2:
        return bcast_binomial(comm, buf, root)
    mid = flat.size // 2
    halves = (flat[:mid], flat[mid:])
    vrank = (rank - root) % size
    nL = size // 2                      # |left group| ≥ |right group|
    grp = [list(range(1, nL + 1)), list(range(nL + 1, size))]

    def gmap(side: int, idx: int) -> int:
        return (grp[side][idx] + root) % size

    if vrank == 0:
        reqs = [comm.isend(halves[s], gmap(s, 0), T_BCAST)
                for s in (0, 1) if grp[s]]
        wait_all(reqs)
        return
    side = 0 if vrank <= nL else 1
    idx = vrank - 1 if side == 0 else vrank - 1 - nL
    m = len(grp[side])
    parent, children = _binomial_children(idx, m, 0)
    my = halves[side]
    src = root if parent is None else gmap(side, parent)
    comm.recv(my, src, T_BCAST)
    reqs = [comm.isend(my, gmap(side, c), T_BCAST) for c in reversed(children)]
    other = 1 - side
    mo = len(grp[other])
    if idx < mo:
        partner = gmap(other, idx)
        comm.sendrecv(my, partner, halves[other], partner,
                      T_ALLGATHER, T_ALLGATHER)
    else:
        # |L| = |R|+1: the odd left member gets the other half from the
        # last right-group rank (which serves two left partners)
        comm.recv(halves[other], gmap(other, mo - 1), T_ALLGATHER)
    mL, mR = len(grp[0]), len(grp[1])
    if side == 1 and idx == mR - 1 and mL > mR:
        comm.send(my, gmap(0, mL - 1), T_ALLGATHER)
    wait_all(reqs)


def reduce_chain(comm, send: np.ndarray, recv: Optional[np.ndarray], op: Op,
                 root: int, segsize: int, fanout: int) -> Optional[np.ndarray]:
    """coll_base_reduce.c:384 — ``fanout`` independent segmented chains;
    each chain pipelines partial folds toward its head, heads stream their
    segments to the root, which folds across chains (commutative ops only —
    the dispatcher guards)."""
    size, rank = comm.size, comm.rank
    vrank = (rank - root) % size
    fanout = max(1, min(fanout, size - 1))
    clen = -(-(size - 1) // fanout)
    acc = np.asarray(send).copy()
    flat = acc.reshape(-1)
    segs = _segments(flat, segsize)
    if vrank == 0:
        heads = list(range(0, size - 1, clen))
        inbox = {h: [np.empty_like(s) for s in segs] for h in heads}
        rreqs = {h: [comm.irecv(b, (h + 1 + root) % size, T_REDUCE)
                     for b in inbox[h]] for h in heads}
        for j, s in enumerate(segs):
            for h in heads:
                rreqs[h][j].wait()
                s[...] = op.host(inbox[h][j], s)
        if recv is None:
            recv = np.empty_like(np.asarray(send))
        recv[...] = acc
        return recv
    idx = vrank - 1
    pos = idx % clen
    parent = root if pos == 0 else (idx - 1 + 1 + root) % size
    child = (idx + 1 + 1 + root) % size \
        if (pos + 1 < clen and idx + 1 < size - 1) else None
    rreqs, inboxes = [], []
    if child is not None:
        inboxes = [np.empty_like(s) for s in segs]
        rreqs = [comm.irecv(b, child, T_REDUCE) for b in inboxes]
    sreqs = []
    for j, s in enumerate(segs):
        if child is not None:
            rreqs[j].wait()
            s[...] = op.host(inboxes[j], s)
        sreqs.append(comm.isend(s, parent, T_REDUCE))
    wait_all(sreqs)
    return None


def reduce_knomial(comm, send: np.ndarray, recv: Optional[np.ndarray], op: Op,
                   root: int, radix: int) -> Optional[np.ndarray]:
    """coll_base_reduce.c:1166 — radix-k tree reduce: log_k p rounds
    (commutative ops only — the dispatcher guards)."""
    parent, children = _knomial_tree(comm.rank, comm.size, root,
                                     max(2, radix))
    acc = np.asarray(send).copy()
    tmp = np.empty_like(acc)
    for c in reversed(children):
        comm.recv(tmp, c, T_REDUCE)
        acc = op.host(tmp, acc)
    if parent is not None:
        comm.send(acc, parent, T_REDUCE)
        return None
    if recv is None:
        recv = np.empty_like(np.asarray(send))
    recv[...] = acc
    return recv


def _halving_span(nr: int, down_to_mask: int, n: int, pof2: int):
    """Span held after recursive-halving decisions for masks ≥ down_to_mask
    (spans must be recomputed per rank: halving an odd-length span is
    uneven)."""
    blo, bhi = 0, n
    m = pof2 >> 1
    while m >= down_to_mask:
        mid = blo + (bhi - blo) // 2
        if nr & m:
            blo = mid
        else:
            bhi = mid
        m >>= 1
    return blo, bhi


def reduce_rabenseifner(comm, send: np.ndarray, recv: Optional[np.ndarray],
                        op: Op, root: int) -> Optional[np.ndarray]:
    """coll_base_reduce.c:811 — recursive-halving reduce-scatter followed
    by a binomial gather of the spans onto the pof2 survivor holding
    newrank 0, which forwards the result to the root when different (the
    reference grafts the root into the gather tree; the single extra
    n-byte hop here trades that bookkeeping away). Commutative only."""
    size, rank = comm.size, comm.rank
    flat = np.asarray(send).reshape(-1).copy()
    pof2 = 1 << (size.bit_length() - 1)
    rem = size - pof2
    holder = 1 if rem > 0 else 0         # original rank of newrank 0
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm.send(flat, rank + 1, T_REDUCE)
            newrank = -1
        else:
            tmp = np.empty_like(flat)
            comm.recv(tmp, rank - 1, T_REDUCE)
            flat[...] = op.host(tmp, flat)
            newrank = rank // 2
    else:
        newrank = rank - rem
    if newrank >= 0:
        mask = pof2 >> 1
        lo, hi = 0, flat.size
        while mask > 0:
            peer_new = newrank ^ mask
            peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
            mid = lo + (hi - lo) // 2
            if newrank & mask:
                keep_lo, keep_hi, send_lo, send_hi = mid, hi, lo, mid
            else:
                keep_lo, keep_hi, send_lo, send_hi = lo, mid, mid, hi
            inbox = np.empty(keep_hi - keep_lo, flat.dtype)
            comm.sendrecv(flat[send_lo:send_hi], peer, inbox, peer,
                          T_RSCAT, T_RSCAT)
            seg = flat[keep_lo:keep_hi]
            seg[...] = op.host(inbox, seg)
            lo, hi = keep_lo, keep_hi
            mask >>= 1
        # binomial gather of spans toward newrank 0
        mask = 1
        while mask < pof2:
            if newrank & mask:
                peer_new = newrank ^ mask
                peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
                comm.send(flat[lo:hi], peer, T_GATHER)
                break
            peer_new = newrank | mask
            if peer_new < pof2:
                peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
                plo, phi = _halving_span(peer_new, mask, flat.size, pof2)
                comm.recv(flat[plo:phi], peer, T_GATHER)
                lo, hi = min(lo, plo), max(hi, phi)
            mask <<= 1
    if rank == holder and root != holder:
        comm.send(flat, root, T_REDUCE)
    if rank == root:
        if root != holder:
            comm.recv(flat, holder, T_REDUCE)
        if recv is None:
            recv = np.empty_like(np.asarray(send))
        recv.reshape(-1)[:] = flat
        return recv
    return None


# ---------------------------------------------------------------------------
# alltoall[v] variants
# ---------------------------------------------------------------------------

def alltoall_linear_sync(comm, send: np.ndarray, recv: np.ndarray,
                         max_outstanding: int) -> None:
    """coll_base_alltoall.c:378 — linear with a bounded window of
    outstanding isend/irecv pairs: the next peer's pair is posted only as
    an earlier one completes (flow control at large fan-out)."""
    from ..p2p.request import wait_any
    size, rank = comm.size, comm.rank
    sp = send.reshape(size, -1)
    rp = recv.reshape(size, -1)
    rp[rank] = sp[rank]
    window = max(1, max_outstanding)
    pending: list = []
    for step in range(1, size):
        peer = (rank + step) % size
        while len(pending) >= 2 * window:
            pending.pop(wait_any(pending))
        pending.append(comm.irecv(rp[peer], peer, T_ALLTOALL))
        pending.append(comm.isend(sp[peer], peer, T_ALLTOALL))
    wait_all(pending)


def alltoall_two_procs(comm, send: np.ndarray, recv: np.ndarray) -> None:
    """coll_base_alltoall.c:537."""
    rank = comm.rank
    sp = send.reshape(2, -1)
    rp = recv.reshape(2, -1)
    rp[rank] = sp[rank]
    peer = 1 - rank
    comm.sendrecv(sp[peer], peer, rp[peer], peer, T_ALLTOALL, T_ALLTOALL)


def alltoallv_pairwise(comm, sendbuf: np.ndarray, recvbuf: np.ndarray,
                       sendcounts: Sequence[int], recvcounts: Sequence[int],
                       sdispls: Sequence[int],
                       rdispls: Sequence[int]) -> None:
    """coll_base_alltoallv.c:194 — p-1 offset-paired exchange rounds; one
    in-flight message per rank per round instead of the linear variant's
    2(p-1) concurrent requests."""
    size, rank = comm.size, comm.rank
    sflat = np.asarray(sendbuf).reshape(-1)
    rflat = recvbuf.reshape(-1)
    rflat[rdispls[rank]:rdispls[rank] + recvcounts[rank]] = \
        sflat[sdispls[rank]:sdispls[rank] + sendcounts[rank]]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step) % size
        comm.sendrecv(sflat[sdispls[to]:sdispls[to] + sendcounts[to]], to,
                      rflat[rdispls[frm]:rdispls[frm] + recvcounts[frm]],
                      frm, T_ALLTOALL, T_ALLTOALL)


# ---------------------------------------------------------------------------
# reduce_scatter (per-rank counts) variants
# ---------------------------------------------------------------------------

def reduce_scatter_ring(comm, send: np.ndarray, recv: np.ndarray,
                        counts: Sequence[int], displs: Sequence[int],
                        op: Op) -> None:
    """coll_base_reduce_scatter.c:456 — ring: block b circles from rank
    b+1 around to its owner, accumulating a contribution at every hop;
    bandwidth-optimal, p-1 neighbor rounds (commutative only)."""
    size, rank = comm.size, comm.rank
    flat = np.asarray(send).reshape(-1).copy()
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        s = (rank - step - 1) % size
        d = (rank - step - 2) % size
        inbox = np.empty(int(counts[d]), flat.dtype)
        comm.sendrecv(flat[displs[s]:displs[s] + counts[s]], right,
                      inbox, left, T_RSCAT, T_RSCAT)
        seg = flat[displs[d]:displs[d] + counts[d]]
        seg[...] = op.host(inbox, seg)
    recv.reshape(-1)[:] = flat[displs[rank]:displs[rank] + counts[rank]]


def reduce_scatter_recursive_halving(comm, send: np.ndarray,
                                     recv: np.ndarray,
                                     counts: Sequence[int],
                                     displs: Sequence[int], op: Op) -> None:
    """coll_base_reduce_scatter.c:132 — power-of-two comms, arbitrary
    counts: vector halving along rank-block boundaries."""
    size, rank = comm.size, comm.rank
    flat = np.asarray(send).reshape(-1).copy()
    total = flat.size

    def bound(b: int) -> int:
        return total if b >= size else int(displs[b])

    lo_b, hi_b = 0, size
    mask = size >> 1
    while mask > 0:
        peer = rank ^ mask
        mid_b = lo_b + (hi_b - lo_b) // 2
        if rank & mask:
            keep, send_rng = (mid_b, hi_b), (lo_b, mid_b)
        else:
            keep, send_rng = (lo_b, mid_b), (mid_b, hi_b)
        inbox = np.empty(bound(keep[1]) - bound(keep[0]), flat.dtype)
        comm.sendrecv(flat[bound(send_rng[0]):bound(send_rng[1])], peer,
                      inbox, peer, T_RSCAT, T_RSCAT)
        seg = flat[bound(keep[0]):bound(keep[1])]
        if op.commutative or peer < rank:
            seg[...] = op.host(inbox, seg)
        else:
            seg[...] = op.host(seg.copy(), inbox)
        lo_b, hi_b = keep
        mask >>= 1
    recv.reshape(-1)[:] = flat[displs[rank]:displs[rank] + counts[rank]]


def reduce_scatter_block_recursive_doubling(comm, send: np.ndarray,
                                            recv: np.ndarray, op: Op) -> None:
    """coll_base_reduce_scatter_block.c:197 — power-of-two comms: log p
    xor-paired rounds over a shrinking alive-set of blocks; each round a
    rank ships the alive blocks belonging to its peer's half and folds the
    ones arriving for its own."""
    size, rank = comm.size, comm.rank
    parts = send.reshape(size, -1).copy()
    alive = list(range(size))
    mask = 1
    while mask < size:
        peer = rank ^ mask
        sel = [b for b in alive if (b & mask) == (peer & mask)]
        keep = [b for b in alive if (b & mask) == (rank & mask)]
        inbox = np.empty((len(keep), parts.shape[1]), parts.dtype)
        comm.sendrecv(np.ascontiguousarray(parts[sel]), peer, inbox, peer,
                      T_RSCAT, T_RSCAT)
        if op.commutative or peer < rank:
            parts[keep] = op.host(inbox, parts[keep])
        else:
            parts[keep] = op.host(parts[keep].copy(), inbox)
        alive = keep
        mask <<= 1
    recv.reshape(-1)[:] = parts[rank]


# ---------------------------------------------------------------------------
# remaining barrier / gather / scatter variants
# ---------------------------------------------------------------------------

def barrier_tree(comm) -> None:
    """coll_base_barrier.c:427 — binomial gather-up then release-down."""
    rank, size = comm.rank, comm.size
    token = np.zeros(0, np.uint8)
    parent, children = _binomial_children(rank, size, 0)
    for c in children:
        comm.recv(token, c, T_BARRIER)
    if parent is not None:
        comm.send(token, parent, T_BARRIER)
        comm.recv(token, parent, T_BARRIER)
    for c in children:
        comm.send(token, c, T_BARRIER)


def barrier_two_procs(comm) -> None:
    """coll_base_barrier.c:307."""
    token = np.zeros(0, np.uint8)
    peer = 1 - comm.rank
    comm.sendrecv(token, peer, token, peer, T_BARRIER, T_BARRIER)


def gather_linear_sync(comm, send: np.ndarray, recv: Optional[np.ndarray],
                       root: int) -> Optional[np.ndarray]:
    """coll_base_gather.c:208 — root-paced linear gather: each rank sends
    only after the root's zero-byte go-ahead, bounding unexpected-message
    buildup at the root for large payloads."""
    size, rank = comm.size, comm.rank
    token = np.zeros(0, np.uint8)
    if rank != root:
        comm.recv(token, root, T_GATHER)
        comm.send(np.asarray(send), root, T_GATHER)
        return None
    if recv is None:
        recv = np.empty((size,) + np.asarray(send).shape,
                        np.asarray(send).dtype)
    out = recv.reshape(size, -1)
    out[root] = np.asarray(send).reshape(-1)
    for src in range(size):
        if src == root:
            continue
        comm.send(token, src, T_GATHER)
        comm.recv(out[src], src, T_GATHER)
    return recv


def scatter_linear_nb(comm, send: Optional[np.ndarray], recv: np.ndarray,
                      root: int) -> np.ndarray:
    """coll_base_scatter.c:289 — non-blocking linear: the root posts all
    p-1 isends at once instead of serializing them."""
    size, rank = comm.size, comm.rank
    recv = np.asarray(recv)
    if rank == root:
        parts = np.asarray(send).reshape(size, -1)
        reqs = [comm.isend(parts[p], p, T_SCATTER)
                for p in range(size) if p != root]
        recv.reshape(-1)[:] = parts[root]
        wait_all(reqs)
    else:
        comm.recv(recv.reshape(-1), root, T_SCATTER)
    return recv


# ---------------------------------------------------------------------------
# the tuned module: decision rules + dispatch
# ---------------------------------------------------------------------------

_var.register("coll", "tuned", "dynamic_rules", "", type=str, level=4,
              help="Path to a dynamic rules file: lines of "
                   "'<coll> <min_comm_size> <min_bytes> <algorithm>'.")

for _coll, _algs in {
    "allreduce": "recursive_doubling|ring|segmented_ring|rabenseifner"
                 "|nonoverlapping|allgather_reduce",
    "bcast": "binomial|knomial|pipeline|chain|scatter_allgather"
             "|split_binary",
    "reduce": "binomial|inorder_binary|pipeline|chain|knomial|rabenseifner",
    "allgather": "recursive_doubling|ring|neighbor_exchange|bruck|sparbit"
                 "|k_bruck|two_procs|direct|linear",
    "alltoall": "pairwise|bruck|linear_sync|two_procs|linear",
    "alltoallv": "pairwise|linear",
    "reduce_scatter": "nonoverlapping|ring|recursive_halving|butterfly",
    "reduce_scatter_block": "recursive_halving|butterfly"
                            "|recursive_doubling",
    "gather": "binomial|linear|linear_sync",
    "scatter": "binomial|linear|linear_nb",
    "allgatherv": "ring|linear|bruck|sparbit|neighbor_exchange|two_procs",
    "barrier": "recursive_doubling|double_ring|tree|two_procs|bruck",
    "scan": "recursive_doubling|linear",
    "exscan": "recursive_doubling|linear",
}.items():
    _var.register("coll", "tuned", f"{_coll}_algorithm", "", type=str, level=3,
                  help=f"Force the {_coll} algorithm ({_algs}; empty = auto).")

# segmentation / tree-shape knobs (≙ coll_tuned_*_segment_size / radix /
# chains MCA vars). Defaults below come from the recorded host sweep in
# TUNE_SWEEP.json (tools/coll_tune.py), not guesses.
_var.register("coll", "tuned", "allreduce_segsize", 256 << 10, type=int,
              level=4, help="Segment bytes for segmented-ring allreduce.")
_var.register("coll", "tuned", "reduce_segsize", 256 << 10, type=int,
              level=4, help="Segment bytes for pipeline reduce.")
_var.register("coll", "tuned", "bcast_segsize", 128 << 10, type=int,
              level=4, help="Segment bytes for pipeline/chain bcast.")
_var.register("coll", "tuned", "bcast_chains", 4, type=int, level=4,
              help="Number of chains for chain bcast.")
_var.register("coll", "tuned", "bcast_knomial_radix", 4, type=int, level=4,
              help="Radix for knomial bcast.")
_var.register("coll", "tuned", "reduce_knomial_radix", 4, type=int, level=4,
              help="Radix for knomial reduce.")
_var.register("coll", "tuned", "reduce_chain_fanout", 4, type=int, level=4,
              help="Number of chains for chain reduce.")
_var.register("coll", "tuned", "allgather_kbruck_radix", 4, type=int, level=4,
              help="Radix for k-Bruck allgather.")
_var.register("coll", "tuned", "alltoall_sync_requests", 8, type=int, level=4,
              help="Outstanding isend/irecv pairs for linear-sync alltoall.")


def _load_dynamic_rules():
    path = _var.get("coll_tuned_dynamic_rules", "")
    rules = []
    if path and os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                coll, min_comm, min_bytes, alg = line.split()
                rules.append((coll, int(min_comm), int(min_bytes), alg))
    return rules


class TunedModule(CollModule):
    """Per-communicator tuned module; falls back to BasicModule for entry
    points without a tuned algorithm (per-function stacking does the same at
    the framework level; the inner fallback keeps semantics like in-order
    reduction in one place)."""

    def __init__(self, comm) -> None:
        self.basic = BasicModule()
        self._rules = _load_dynamic_rules()

    def _pick(self, coll: str, comm, nbytes: int, default: str) -> str:
        forced = _var.get(f"coll_tuned_{coll}_algorithm", "")
        if forced:
            return forced
        pick = default
        for c, mc, mb, alg in self._rules:
            if c == coll and comm.size >= mc and nbytes >= mb:
                pick = alg
        return pick

    # -- allreduce (decision table ≙ coll_tuned_decision_fixed.c:69-104) ----

    def allreduce(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = _sum_default(op)
        send = _inplace(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        if comm.size == 1:
            recvbuf[...] = send
            return recvbuf
        if not op.commutative:
            return self.basic.allreduce(comm, send, recvbuf, op)
        nbytes = send.nbytes
        # thresholds from the recorded sweep (TUNE_SWEEP.json, 4 ranks):
        # rd wins ≤16K (1268µs vs ring 2122µs @16K), ring the mid band
        # (4291µs vs rd 7360µs @256K), segmented ring the largest sizes
        # (19.7ms vs ring 30.7ms @2M); rabenseifner never won on this host
        # but stays selectable for multi-core deployments
        default = ("recursive_doubling" if nbytes <= (1 << 16) else
                   ("ring" if nbytes <= (1 << 20) else "segmented_ring"))
        alg = self._pick("allreduce", comm, nbytes, default)
        if send.size < comm.size and alg not in ("nonoverlapping",
                                                 "allgather_reduce"):
            alg = "recursive_doubling"  # tiny vectors can't be scattered
        if alg == "ring":
            allreduce_ring(comm, send, recvbuf, op)
        elif alg == "segmented_ring":
            allreduce_segmented_ring(
                comm, send, recvbuf, op,
                int(_var.get("coll_tuned_allreduce_segsize", 256 << 10)))
        elif alg == "rabenseifner":
            allreduce_rabenseifner(comm, send, recvbuf, op)
        elif alg == "nonoverlapping":
            allreduce_nonoverlapping(comm, send, recvbuf, op)
        elif alg == "allgather_reduce":
            allreduce_allgather_reduce(comm, send, recvbuf, op)
        else:
            allreduce_recursive_doubling(comm, send, recvbuf, op)
        return recvbuf

    def bcast(self, comm, buf, root: int = 0):
        buf = np.asarray(buf)
        if comm.size == 1:
            return buf
        nbytes = buf.nbytes
        # sweep-driven (TUNE_SWEEP.json, 4 ranks): knomial wins the latency
        # regime on the full-library sweep (shallower tree, no segment
        # bookkeeping); pipeline keeps the bandwidth regime — its wire/
        # compute overlap cannot show on the 1-core sweep box (where
        # knomial also "wins" large) but is the structural choice once
        # ranks own cores
        default = "knomial" if nbytes <= (1 << 13) else "pipeline"
        alg = self._pick("bcast", comm, nbytes, default)
        if alg == "scatter_allgather" and buf.size >= comm.size:
            bcast_scatter_allgather(comm, buf, root)
        elif alg == "split_binary":
            bcast_split_binary(comm, buf, root)
        elif alg in ("pipeline", "chain"):
            bcast_pipeline(
                comm, buf, root,
                int(_var.get("coll_tuned_bcast_segsize", 128 << 10)),
                chains=1 if alg == "pipeline"
                else int(_var.get("coll_tuned_bcast_chains", 4)))
        elif alg == "knomial":
            bcast_knomial(comm, buf, root,
                          int(_var.get("coll_tuned_bcast_knomial_radix", 4)))
        else:
            bcast_binomial(comm, buf, root)
        return buf

    def reduce(self, comm, sendbuf, recvbuf=None, op: Op = None, root: int = 0):
        op = _sum_default(op)
        send = _inplace(sendbuf, recvbuf)
        if comm.size == 1:
            if recvbuf is None:
                recvbuf = np.empty_like(send)
            recvbuf[...] = send
            return recvbuf
        if not op.commutative:
            # in-order binary tree keeps the canonical fold order at
            # log(p) depth (vs the linear gather fallback)
            return reduce_inorder_binary(comm, send, recvbuf, op, root)
        # sweep (TUNE_SWEEP.json, 4 ranks, ONE core): knomial wins small
        # (shallow tree), binomial the middle, in-order binary the large
        # regime (balanced log-depth tree with one fold per node — valid
        # for commutative ops too, and the recorded winner ≥256K); the
        # pipeline/chain overlap needs ranks on their own cores to pay
        # off, so they stay selectable, not default
        default = ("knomial" if send.nbytes <= (1 << 11) else
                   ("binomial" if send.nbytes <= (1 << 17)
                    else "inorder_binary"))
        alg = self._pick("reduce", comm, send.nbytes, default)
        if alg == "inorder_binary":
            return reduce_inorder_binary(comm, send, recvbuf, op, root)
        if alg == "pipeline":
            return reduce_pipeline(
                comm, send, recvbuf, op, root,
                int(_var.get("coll_tuned_reduce_segsize", 256 << 10)))
        if alg == "chain":
            return reduce_chain(
                comm, send, recvbuf, op, root,
                int(_var.get("coll_tuned_reduce_segsize", 256 << 10)),
                int(_var.get("coll_tuned_reduce_chain_fanout", 4)))
        if alg == "knomial":
            return reduce_knomial(
                comm, send, recvbuf, op, root,
                int(_var.get("coll_tuned_reduce_knomial_radix", 4)))
        if alg == "rabenseifner":
            return reduce_rabenseifner(comm, send, recvbuf, op, root)
        return reduce_binomial(comm, send, recvbuf, op, root)

    def gather(self, comm, sendbuf, recvbuf=None, root: int = 0):
        if comm.size == 1:
            return self.basic.gather(comm, sendbuf, recvbuf, root)
        # sweep: binomial wins the latency regime, linear the bandwidth one
        # (interior nodes re-forward subtree data the linear root receives
        # once)
        alg = self._pick("gather", comm, np.asarray(sendbuf).nbytes,
                         "binomial" if np.asarray(sendbuf).nbytes <= (1 << 13)
                         else "linear")
        if alg == "linear":
            return self.basic.gather(comm, sendbuf, recvbuf, root)
        if alg == "linear_sync":
            return gather_linear_sync(comm, np.asarray(sendbuf), recvbuf,
                                      root)
        return gather_binomial(comm, np.asarray(sendbuf), recvbuf, root)

    def scatter(self, comm, sendbuf, recvbuf=None, root: int = 0):
        if comm.size == 1:
            return self.basic.scatter(comm, sendbuf, recvbuf, root)
        if recvbuf is None:
            if comm.rank != root:
                raise ValueError("non-root scatter needs recvbuf")
            sb = np.asarray(sendbuf)
            recvbuf = np.empty(sb.reshape((comm.size, -1)).shape[1:],
                               sb.dtype)
        # sweep: linear won at every size on 4 ranks (forwarding doubles
        # interior bytes); binomial stays selectable for large rank counts
        # where the root's p-1 sends become the bottleneck
        alg = self._pick("scatter", comm,
                         np.asarray(recvbuf).nbytes, "linear")
        if alg == "binomial":
            return scatter_binomial(comm, sendbuf, recvbuf, root)
        if alg == "linear_nb":
            return scatter_linear_nb(comm, sendbuf, recvbuf, root)
        return self.basic.scatter(comm, sendbuf, recvbuf, root)

    def allgatherv(self, comm, sendbuf, recvbuf=None, counts=None,
                   displs=None):
        if counts is None or comm.size == 1:
            return self.basic.allgatherv(comm, sendbuf, recvbuf, counts,
                                         displs)
        nbytes = int(np.sum(counts)) * np.asarray(sendbuf).dtype.itemsize
        alg = self._pick("allgatherv", comm, nbytes, "ring")
        if alg == "linear":
            return self.basic.allgatherv(comm, sendbuf, recvbuf, counts,
                                         displs)
        if displs is None:
            displs = list(np.concatenate([[0], np.cumsum(counts)[:-1]]))
        if recvbuf is None:
            # size by the furthest write, not sum(counts): user displs may
            # leave gaps (same contract as the basic module)
            total = max(int(d) + int(c) for d, c in zip(displs, counts))
            recvbuf = np.empty(total, np.asarray(sendbuf).dtype)
        if alg == "bruck":
            allgatherv_bruck(comm, np.asarray(sendbuf), recvbuf, counts,
                             displs)
        elif alg == "sparbit":
            allgatherv_sparbit(comm, np.asarray(sendbuf), recvbuf, counts,
                               displs)
        elif alg == "neighbor_exchange" and comm.size % 2 == 0:
            allgatherv_neighbor_exchange(comm, np.asarray(sendbuf), recvbuf,
                                         counts, displs)
        elif alg == "two_procs" and comm.size == 2:
            allgatherv_two_procs(comm, np.asarray(sendbuf), recvbuf, counts,
                                 displs)
        else:
            allgatherv_ring(comm, np.asarray(sendbuf), recvbuf, counts,
                            displs)
        return recvbuf

    def allgather(self, comm, sendbuf, recvbuf=None):
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty((comm.size,) + sendbuf.shape, sendbuf.dtype)
        if comm.size == 1:
            recvbuf.reshape(1, -1)[0] = sendbuf.reshape(-1)
            return recvbuf
        nbytes = sendbuf.nbytes
        pof2 = (comm.size & (comm.size - 1)) == 0
        even = comm.size % 2 == 0
        # sweep (TUNE_SWEEP.json winners: 64B bruck, 1K rd, 16K-256K
        # direct, 2M k_bruck): bruck tiny, recursive-doubling small-pof2,
        # direct messaging the mid band on small comms (one round, p-1
        # concurrent pairs), k-Bruck large on small comms (at p=4,radix=4
        # it is single-round direct with block coalescing). DEVIATION for
        # large comms: ring/neighbor-exchange despite never winning the
        # 4-rank sweep — p-1 concurrent pairs oversubscribe ports as p
        # grows, and the neighbor schedules are the topology-friendly
        # structural choice there (coll_base_allgather.c rationale)
        default = ("bruck" if nbytes <= 256
                   else ("recursive_doubling" if pof2 and nbytes <= (1 << 11)
                         else ("direct" if comm.size <= 8
                               and nbytes <= (1 << 18)
                               else ("k_bruck" if comm.size <= 8
                                     else ("bruck" if nbytes <= 4096
                                           # log p rounds, one msg/round —
                                           # no port pressure; keeps the
                                           # latency band off p-1 rings
                                           else ("neighbor_exchange" if even
                                                 else "ring"))))))
        alg = self._pick("allgather", comm, nbytes, default)
        if alg == "recursive_doubling" and pof2:
            allgather_recursive_doubling(comm, sendbuf, recvbuf)
        elif alg == "bruck":
            allgather_bruck(comm, sendbuf, recvbuf)
        elif alg == "sparbit":
            allgather_sparbit(comm, sendbuf, recvbuf)
        elif alg == "k_bruck":
            allgather_kbruck(
                comm, sendbuf, recvbuf,
                int(_var.get("coll_tuned_allgather_kbruck_radix", 4)))
        elif alg == "two_procs" and comm.size == 2:
            allgather_two_procs(comm, sendbuf, recvbuf)
        elif alg == "direct":
            allgather_direct(comm, sendbuf, recvbuf)
        elif alg == "linear":
            return self.basic.allgather(comm, sendbuf, recvbuf)
        elif alg == "neighbor_exchange" and even:
            allgather_neighbor_exchange(comm, sendbuf, recvbuf)
        else:
            allgather_ring(comm, sendbuf, recvbuf)
        return recvbuf

    def alltoall(self, comm, sendbuf, recvbuf=None):
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(sendbuf)
        if comm.size == 1:
            recvbuf[...] = sendbuf
            return recvbuf
        nbytes = sendbuf.nbytes // comm.size   # per-destination bytes
        # sweep (TUNE_SWEEP.json, 4 ranks, winners keyed by TOTAL buffer;
        # per-dest = total/4): bruck wins the measured tiny point
        # (16 B/dest), plain linear the middle (256 B–4 KB/dest),
        # linear_sync the bandwidth regime (≥64 KB/dest — windowed flow
        # control beats the lockstep pairwise rounds). The bruck/linear
        # cutoff at 64 B/dest sits mid-gap between the two measured
        # points; pairwise stays selectable for large rank counts where
        # 2(p-1) outstanding requests oversubscribe
        default = ("bruck" if nbytes <= 64 else
                   ("linear" if nbytes <= (1 << 13) else "linear_sync"))
        alg = self._pick("alltoall", comm, nbytes, default)
        if alg == "bruck":
            alltoall_bruck(comm, sendbuf, recvbuf)
        elif alg == "linear_sync":
            alltoall_linear_sync(
                comm, sendbuf, recvbuf,
                int(_var.get("coll_tuned_alltoall_sync_requests", 8)))
        elif alg == "two_procs" and comm.size == 2:
            alltoall_two_procs(comm, sendbuf, recvbuf)
        elif alg == "linear":
            return self.basic.alltoall(comm, sendbuf, recvbuf)
        else:
            alltoall_pairwise(comm, sendbuf, recvbuf)
        return recvbuf

    def alltoallv(self, comm, sendbuf, recvbuf,
                  sendcounts, recvcounts, sdispls=None, rdispls=None):
        if comm.size == 1:
            return self.basic.alltoallv(comm, sendbuf, recvbuf, sendcounts,
                                        recvcounts, sdispls, rdispls)
        nbytes = int(np.sum(sendcounts)) * \
            np.asarray(sendbuf).dtype.itemsize
        alg = self._pick("alltoallv", comm, nbytes, "pairwise")
        if alg == "linear":
            return self.basic.alltoallv(comm, sendbuf, recvbuf, sendcounts,
                                        recvcounts, sdispls, rdispls)
        if sdispls is None:
            sdispls = list(np.concatenate([[0], np.cumsum(sendcounts)[:-1]]))
        if rdispls is None:
            rdispls = list(np.concatenate([[0], np.cumsum(recvcounts)[:-1]]))
        alltoallv_pairwise(comm, sendbuf, recvbuf, sendcounts, recvcounts,
                           sdispls, rdispls)
        return recvbuf

    def reduce_scatter(self, comm, sendbuf, recvbuf, counts, op: Op = None):
        op = _sum_default(op)
        sendbuf = np.asarray(sendbuf)
        if comm.size == 1 or not op.commutative:
            return self.basic.reduce_scatter(comm, sendbuf, recvbuf, counts,
                                             op)
        counts = [int(c) for c in counts]
        displs = list(np.concatenate([[0], np.cumsum(counts)[:-1]])
                      .astype(int))
        if recvbuf is None:
            recvbuf = np.empty(counts[comm.rank], sendbuf.dtype)
        pof2 = (comm.size & (comm.size - 1)) == 0
        nbytes = sendbuf.nbytes
        # sweep (TUNE_SWEEP.json, 4 ranks): recursive-halving wins small,
        # butterfly wins ≥16K at every size incl. 2M (fewer rounds than the
        # ring's p-1 for the same O(n) bytes); ring stays selectable for
        # topologies where only neighbor links are cheap
        default = ("recursive_halving" if (pof2 and nbytes <= (1 << 13))
                   else "butterfly")
        alg = self._pick("reduce_scatter", comm, nbytes, default)
        if alg == "nonoverlapping":
            return self.basic.reduce_scatter(comm, sendbuf, recvbuf, counts,
                                             op)
        if alg == "recursive_halving" and pof2:
            reduce_scatter_recursive_halving(comm, sendbuf, recvbuf, counts,
                                             displs, op)
        elif alg == "butterfly" or (alg == "recursive_halving" and not pof2):
            reduce_scatter_butterfly(comm, sendbuf, recvbuf, counts, displs,
                                     op)
        else:
            reduce_scatter_ring(comm, sendbuf, recvbuf, counts, displs, op)
        return recvbuf

    def reduce_scatter_block(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = _sum_default(op)
        sendbuf = np.asarray(sendbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(sendbuf.reshape(comm.size, -1)[0])
        pof2 = (comm.size & (comm.size - 1)) == 0
        if comm.size == 1:
            recvbuf.reshape(-1)[:] = sendbuf.reshape(-1)
            return recvbuf
        if not op.commutative or sendbuf.size % comm.size != 0:
            return self.basic.reduce_scatter_block(comm, sendbuf, recvbuf, op)
        alg = self._pick("reduce_scatter_block", comm, sendbuf.nbytes,
                         "recursive_halving" if pof2 else "butterfly")
        if alg == "recursive_doubling" and pof2:
            reduce_scatter_block_recursive_doubling(comm, sendbuf, recvbuf,
                                                    op)
        elif alg == "butterfly" or not pof2:
            reduce_scatter_block_butterfly(comm, sendbuf, recvbuf, op)
        else:
            reduce_scatter_block_recursive_halving(comm, sendbuf, recvbuf, op)
        return recvbuf

    def barrier(self, comm):
        if comm.size <= 1:
            return
        alg = self._pick("barrier", comm, 0, "recursive_doubling")
        if alg == "double_ring":
            barrier_double_ring(comm)
        elif alg == "tree":
            barrier_tree(comm)
        elif alg == "two_procs" and comm.size == 2:
            barrier_two_procs(comm)
        else:
            # recursive_doubling; "bruck" (coll_base_barrier.c:269) is the
            # same +mask/-mask pairing here (see barrier_recursive_doubling)
            barrier_recursive_doubling(comm)

    def scan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = _sum_default(op)
        send = _inplace(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        # sweep: rd wins only the latency regime; the linear chain moves
        # n bytes per rank once vs rd's n·log p (wins ≥1K on the sweep)
        if self._pick("scan", comm, send.nbytes,
                      "recursive_doubling" if send.nbytes < 1024
                      else "linear") == "linear":
            return self.basic.scan(comm, send, recvbuf, op)
        scan_recursive_doubling(comm, send, recvbuf, op, exclusive=False)
        return recvbuf

    def exscan(self, comm, sendbuf, recvbuf=None, op: Op = None):
        op = _sum_default(op)
        send = _inplace(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(send)
        if self._pick("exscan", comm, send.nbytes,
                      "recursive_doubling") == "linear":
            return self.basic.exscan(comm, send, recvbuf, op)
        scan_recursive_doubling(comm, send, recvbuf, op, exclusive=True)
        return recvbuf


@component("coll", "tuned", priority=30)
class TunedColl(Component):
    name = "tuned"

    def query(self, comm):
        return self.priority, TunedModule(comm)
