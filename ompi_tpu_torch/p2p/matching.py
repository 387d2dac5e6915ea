"""MPI message matching (≙ ompi/mca/pml/ob1/pml_ob1_recvfrag.c:453 matching
and the posted/unexpected queues in pml_ob1_recvreq.c).

Per (communicator-id) context: a list of posted receives and a list of
unexpected messages. Matching rules are MPI's: (source, tag) with
ANY_SOURCE/ANY_TAG wildcards, FIFO within a (src, cid) channel — enforced by
per-channel sequence numbers so multi-transport arrival can never reorder a
match (the reference relies on single-BTL ordering plus hdr_seq;
pml_ob1_hdr.h match header carries ctx/src/tag/seq).

The port's copy of ``ompi_tpu/p2p/matching.py``, without the PERUSE
events (ROADMAP P16).
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .request import ANY_SOURCE, ANY_TAG


def _tag_matches(posted_tag: int, msg_tag: int) -> bool:
    """ANY_TAG matches user tags (≥ 0) only — never the reserved negative
    internal tags (comm management, collectives), exactly like MPI where
    wildcards cannot match reserved-tag traffic."""
    if posted_tag == ANY_TAG:
        return msg_tag >= 0
    return posted_tag == msg_tag


class Posted:
    __slots__ = ("src", "tag", "on_match", "req")

    def __init__(self, src: int, tag: int, on_match: Callable,
                 req: Any = None) -> None:
        self.src = src
        self.tag = tag
        self.on_match = on_match
        self.req = req        # owning Request (FT: failed-peer completion)


class Unexpected:
    __slots__ = ("src", "tag", "seq", "kind", "header", "payload")

    def __init__(self, src: int, tag: int, seq: int, kind: str,
                 header: Dict[str, Any], payload: bytes) -> None:
        self.src = src
        self.tag = tag
        self.seq = seq
        self.kind = kind
        self.header = header
        self.payload = payload


class MatchingEngine:
    def __init__(self) -> None:
        self.spc = None     # optional Counters (set by the pml)
        # cid → posted receives in post order
        self._posted: Dict[int, List[Posted]] = defaultdict(list)
        # cid → src → ordered unexpected frames
        self._unexpected: Dict[int, Dict[int, deque]] = defaultdict(
            lambda: defaultdict(deque))
        # expected next sequence per (cid, src); frames out of order are held
        self._next_seq: Dict[Tuple[int, int], int] = defaultdict(int)
        self._held: Dict[Tuple[int, int], Dict[int, Unexpected]] = defaultdict(dict)

    # -- receive side -------------------------------------------------------

    def post_recv(self, cid: int, src: int, tag: int,
                  on_match: Callable, req: Any = None) -> Optional[Posted]:
        """Try to match an already-arrived message first; else enqueue.

        on_match(unexpected | None) is called immediately when an unexpected
        frame matches; returns the Posted entry if queued.
        """
        match = self._find_unexpected(cid, src, tag)
        if match is not None:
            on_match(match)
            return None
        p = Posted(src, tag, on_match, req)
        self._posted[cid].append(p)
        return p

    def fail_src(self, src: int, err: Exception,
                 any_source_cids=frozenset(),
                 pending_err: Exception | None = None) -> None:
        """Complete every posted receive naming ``src`` with ``err`` (ULFM:
        operations on a failed peer must not hang). ANY_SOURCE receives on
        the communicators in ``any_source_cids`` (those whose group contains
        the failed rank, minus already-acked failures — computed by the
        caller, which knows the cid→comm map) are NOT completed: they get
        ``pending_err`` as a one-shot MPIX_ERR_PROC_FAILED_PENDING and stay
        posted, still able to match survivors' messages after
        failure_ack."""
        for cid, lst in self._posted.items():
            for p in [p for p in lst if p.src == src]:
                lst.remove(p)
                if p.req is not None:
                    p.req.complete(err)
            if cid in any_source_cids:
                for p in lst:
                    if p.src == ANY_SOURCE and p.req is not None:
                        p.req.set_pending(pending_err or err)

    def cancel(self, cid: int, posted: Posted) -> bool:
        lst = self._posted.get(cid, [])
        if posted in lst:
            lst.remove(posted)
            return True
        return False

    def _find_unexpected(self, cid: int, src: int, tag: int) -> Optional[Unexpected]:
        buckets = self._unexpected.get(cid)
        if not buckets:
            return None
        sources = [src] if src != ANY_SOURCE else sorted(buckets.keys())
        for s in sources:
            q = buckets.get(s)
            if not q:
                continue
            for i, u in enumerate(q):
                if _tag_matches(tag, u.tag):
                    del q[i]
                    return u
            # only the head of each channel may match out of post order for
            # same-tag traffic; scanning deeper is fine because seq ordering
            # already serialized insertion
        return None

    # -- arrival side -------------------------------------------------------

    def arrived(self, cid: int, src: int, tag: int, seq: int, kind: str,
                header: Dict[str, Any], payload: bytes) -> None:
        """A MATCH/RNDV frame arrived; deliver in sequence order."""
        key = (cid, src)
        if seq != self._next_seq[key]:
            self._held[key][seq] = Unexpected(src, tag, seq, kind, header, payload)
            return
        self._deliver(cid, Unexpected(src, tag, seq, kind, header, payload))
        self._next_seq[key] += 1
        held = self._held.get(key)
        while held and self._next_seq[key] in held:
            u = held.pop(self._next_seq[key])
            self._deliver(cid, u)
            self._next_seq[key] += 1

    def _deliver(self, cid: int, u: Unexpected) -> None:
        for i, p in enumerate(self._posted.get(cid, [])):
            if (p.src == ANY_SOURCE or p.src == u.src) and \
               _tag_matches(p.tag, u.tag):
                del self._posted[cid][i]
                if self.spc is not None:
                    self.spc.inc("matches_posted")
                p.on_match(u)
                return
        if self.spc is not None:
            self.spc.inc("unexpected_arrivals")
        self._unexpected[cid][u.src].append(u)

    # -- probe --------------------------------------------------------------

    def probe(self, cid: int, src: int, tag: int,
              remove: bool = False) -> Optional[Unexpected]:
        """Non-destructive lookup (MPI_Iprobe); with ``remove`` the matched
        message is DEQUEUED — the MPI_Mprobe discipline: once matched into a
        message handle it can no longer match any other receive
        (≙ ompi/message/message.h matched-message objects)."""
        if remove:   # one matching walk to maintain: reuse the dequeue path
            return self._find_unexpected(cid, src, tag)
        buckets = self._unexpected.get(cid)
        if not buckets:
            return None
        sources = [src] if src != ANY_SOURCE else sorted(buckets.keys())
        for s in sources:
            for u in buckets.get(s, ()):
                if _tag_matches(tag, u.tag):
                    return u
        return None
