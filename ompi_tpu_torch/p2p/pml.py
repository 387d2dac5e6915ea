"""Point-to-point protocol engine (≙ pml/ob1, ompi/mca/pml/ob1/).

Implements MPI send/recv semantics over the byte transports:
  * eager protocol for payloads ≤ the transport's eager_limit — one MATCH
    frame, sender completes locally (pml_ob1_isend.c:249,297 send_inline
    fast path);
  * rendezvous for large payloads — RNDV header, receiver matches and ACKs,
    sender streams FRAGs of max_send_size (wire protocol kinds mirror
    pml_ob1_hdr.h:43-52 MATCH/RNDV/ACK/FRAG);
  * matching with wildcards + per-channel sequence numbers (matching.py);
  * ``sync=True`` forces rendezvous regardless of size — MPI_Ssend semantics
    (completion implies the receive was matched).

Payloads are packed/unpacked through the datatype convertor; contiguous
numpy buffers take the single-copy fast path. Device (CUDA) tensors are
detected through the accelerator framework (``accelerator.check_addr``,
≙ accelerator.h:171) and staged explicitly, as ``pml_ob1_accelerator``
does: a send packs on the card where the datatype allows (an index gather),
then copies the packed stream to the host once; a receive lands in a host
staging buffer and is copied into the destination tensor once complete.
Each staged byte is counted in ``device_stage_out_bytes`` /
``device_stage_in_bytes``; no ``np.asarray`` of a device tensor hides a
copy.  Torch tensors are mutable, so a receive writes into the caller's
tensor (and also sets ``request.result`` to it).  Bulk device data takes
the coll/nccl component; p2p staging is for the control-scale messages MPI
apps send between device computations.

The port's copy of ``ompi_tpu/p2p/pml.py``.  Left out: the CMA single-copy
rendezvous (it needs ``native/``), the device channel between threaded
ranks (``p2p/devchan.py``, ROADMAP P15), ULFM's ``fail_peer`` (P14), the
native pml's fragment-sink hooks and the PERUSE events (P16).
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import accelerator as _accel
from ..core.output import show_help
from ..core.progress import ProgressEngine
from ..datatype import Convertor, Datatype, from_numpy
from . import transport as T
from .matching import MatchingEngine, Unexpected
from .request import ANY_SOURCE, ANY_TAG, Request


class TruncateError(RuntimeError):
    pass


def _guarded(fn):
    """Serialize a pml entry point against the async progress thread when
    runtime_async_progress is on (engine.guard set); free when off — the
    default FUNNELED contract stays unlocked."""
    import functools

    @functools.wraps(fn)
    def wrapped(self, *a, **kw):
        g = self._g
        if g is None:
            return fn(self, *a, **kw)
        with g:
            return fn(self, *a, **kw)

    return wrapped


def _capacity_count(nbytes: int, dt: Datatype) -> int:
    """How many datatype elements fit in nbytes — extent-aware: element i
    occupies [i*extent, i*extent + span) where span is the used byte range
    (≙ opal_datatype true extent accounting). Using size here would
    overcount strided types and let the convertor write past the buffer."""
    if not dt.size:
        return 0
    if dt.is_contiguous:
        return nbytes // dt.size
    span = max(s.offset + s.nbytes for s in dt.segments)
    n = nbytes // dt.extent
    if nbytes - n * dt.extent >= span:
        n += 1
    return n


def _buffer_args(buf, datatype: Optional[Datatype], count: Optional[int]
                 ) -> Tuple[np.ndarray, Datatype, int]:
    arr = np.asarray(buf)
    if datatype is None:
        datatype = from_numpy(arr.dtype)
        if count is None:
            count = arr.size
    elif count is None:
        count = _capacity_count(arr.nbytes, datatype)
    return arr, datatype, count


class _SendState:
    __slots__ = ("req", "data", "dst", "offset", "keep")

    def __init__(self, req: Request, data: Optional[bytes], dst: int,
                 keep=None) -> None:
        self.req = req
        self.data = data      # packed bytes; None until the ACK (lazy pack)
        self.dst = dst
        self.offset = 0
        self.keep = keep      # the user array, packed when the ACK comes


class _RecvState:
    __slots__ = ("req", "conv", "received", "total", "finish", "src")

    def __init__(self, req: Request, conv, total: int,
                 finish=None, src: int = -1) -> None:
        self.req = req
        self.conv = conv
        self.received = 0
        self.total = total
        self.finish = finish     # device staging upload, run at completion
        self.src = src           # streaming peer


class _PackedSink:
    """Convertor-shaped accumulator for device receives: frags land in a
    host bytearray; the single H2D + device scatter happens at completion
    (pml device path, ≙ pml_ob1_accelerator.c staging protocol)."""

    def __init__(self, total: int) -> None:
        self.data = bytearray(total)
        self.position = 0

    def set_position(self, position: int) -> None:
        self.position = position

    def unpack(self, payload: bytes) -> int:
        self.data[self.position:self.position + len(payload)] = payload
        self.position += len(payload)
        return len(payload)


class Message:
    """A matched message handle (≙ ompi/message/message.h: MPI_Message).
    Holds the dequeued Unexpected until mrecv/imrecv consumes it exactly
    once."""

    __slots__ = ("status", "_u")

    def __init__(self, u: Unexpected) -> None:
        self._u = u
        self.status = {"source": u.src, "tag": u.tag,
                       "count": u.header["size"]}

    def consume(self) -> Unexpected:
        if self._u is None:
            raise RuntimeError("message already received (MPI_MESSAGE_NULL)")
        u, self._u = self._u, None
        return u


class P2P:
    """One instance per rank process."""

    def __init__(self, bootstrap, layer: T.TransportLayer,
                 engine: ProgressEngine, spc=None) -> None:
        from ..spc import Counters

        self.bootstrap = bootstrap
        self.rank = bootstrap.rank
        self.layer = layer
        self.engine = engine
        self.spc = spc if spc is not None else Counters()
        self.matching = MatchingEngine()
        self.matching.spc = self.spc
        self._g = engine.guard          # async-progress serialization
        self._send_seq: Dict[Tuple[int, int], int] = defaultdict(int)
        self._sreq = itertools.count(1)
        self._rreq = itertools.count(1)
        self._pending_send: Dict[int, _SendState] = {}
        self._pending_recv: Dict[int, _RecvState] = {}
        for t in layer.transports:
            t.dispatch[T.AM_P2P] = self._am_handler
            engine.register(t.progress)

    # -- send ---------------------------------------------------------------

    @_guarded
    def isend(self, buf, dst: int, tag: int = 0, cid: int = 0,
              datatype: Optional[Datatype] = None, count: Optional[int] = None,
              sync: bool = False) -> Request:
        info = _accel.check_addr(buf)
        raw = None            # contiguous host array, packed lazily
        if info is not None:   # explicit device staging, never np.asarray
            if datatype is not None and count is None:
                count = _capacity_count(info.nbytes, datatype)
            data = _accel.current().stage_out(buf, datatype, count)
            self.spc.inc("device_stage_out_bytes", len(data))
        else:
            arr, dt, cnt = _buffer_args(buf, datatype, count)
            if cnt and dt.is_contiguous and arr.flags["C_CONTIGUOUS"] \
                    and dt.size * cnt == arr.nbytes:
                raw = arr      # pack lazily; rendezvous may never copy it
                data = None
            else:
                data = Convertor(arr, dt, cnt).pack() if cnt else b""
        req = Request()
        req._ctx = self
        nbytes = raw.nbytes if raw is not None else len(data)
        req.status.source = self.rank
        req.status.tag = tag
        req.status.count = nbytes
        seq = self._send_seq[(cid, dst)]
        self._send_seq[(cid, dst)] = seq + 1
        transport = self.layer.for_peer(dst)
        self.spc.inc("isends")
        self.spc.inc("bytes_sent", nbytes)
        if not sync and nbytes <= transport.eager_limit:
            self.spc.inc("eager_sends")
            hdr = {"k": "match", "cid": cid, "tag": tag, "seq": seq,
                   "size": nbytes}
            transport.send(dst, T.AM_P2P, hdr,
                           raw.tobytes() if raw is not None else data)
            req.complete()   # eager: locally complete once buffered
            return req
        self.spc.inc("rndv_sends")
        sreq = next(self._sreq)
        self._pending_send[sreq] = _SendState(req, data, dst, keep=raw)
        hdr = {"k": "rndv", "cid": cid, "tag": tag, "seq": seq,
               "size": nbytes, "sreq": sreq}
        transport.send(dst, T.AM_P2P, hdr, b"")
        return req

    def send(self, buf, dst: int, tag: int = 0, cid: int = 0,
             datatype: Optional[Datatype] = None, count: Optional[int] = None,
             sync: bool = False) -> None:
        self.spc.inc("sends")
        self.isend(buf, dst, tag, cid, datatype, count, sync).wait()

    # -- recv ---------------------------------------------------------------

    @_guarded
    def irecv(self, buf, src: int = ANY_SOURCE, tag: int = ANY_TAG,
              cid: int = 0, datatype: Optional[Datatype] = None,
              count: Optional[int] = None) -> Request:
        req, on_match = self._recv_handler(buf, datatype, count)
        posted = self.matching.post_recv(cid, src, tag, on_match, req=req)
        if posted is None:
            self.spc.inc("matches_unexpected")
        else:
            req._posted_ref = (self.matching, cid, posted)
        return req

    def _recv_handler(self, buf, datatype: Optional[Datatype],
                      count: Optional[int]):
        """(request, on_match) pair shared by irecv and imrecv — everything
        that happens once a message matches this receive."""
        dinfo = _accel.check_addr(buf)
        if dinfo is not None:
            # device destination: stage packed stream on host, upload once
            dt = datatype if datatype is not None else from_numpy(dinfo.dtype)
            cnt = count if count is not None else (
                buf.numel() if datatype is None
                else _capacity_count(dinfo.nbytes, dt))
            arr = None
        else:
            arr, dt, cnt = _buffer_args(buf, datatype, count)
        req = Request()
        req._ctx = self
        self.spc.inc("recvs")

        def deliver(data: bytes) -> None:
            req.result = _accel.current().stage_in(data, buf, dt, cnt)
            self.spc.inc("device_stage_in_bytes", len(data))

        def on_match(u: Unexpected) -> None:
            self.spc.inc("bytes_recvd", u.header["size"])
            capacity = dt.size * cnt
            req.status.source = u.src
            req.status.tag = u.tag
            if u.header["size"] > capacity:
                show_help.show("truncate", capacity, u.header["size"],
                               u.tag, u.src)
                if u.kind == "rndv":
                    # NACK (rreq < 0) so the sender's request still completes
                    # — truncation is a receiver-side error in MPI
                    self.layer.send(u.src, T.AM_P2P,
                                    {"k": "ack", "sreq": u.header["sreq"],
                                     "rreq": -1}, b"")
                req.complete(TruncateError(
                    f"recv buffer {capacity}B < message {u.header['size']}B"))
                return
            if u.kind == "match":
                if dinfo is not None:
                    deliver(u.payload)
                elif u.payload:
                    Convertor(arr, dt, cnt).unpack(u.payload)
                req.status.count = len(u.payload)
                req.complete()
            else:  # rendezvous
                # fragment path: ACK with a recv-request id, collect FRAGs
                rreq = next(self._rreq)
                if dinfo is not None:
                    sink = _PackedSink(u.header["size"])
                    state = _RecvState(req, sink, u.header["size"],
                                       finish=lambda: deliver(bytes(sink.data)),
                                       src=u.src)
                else:
                    state = _RecvState(req, Convertor(arr, dt, cnt),
                                       u.header["size"], src=u.src)
                self._pending_recv[rreq] = state
                req.status.count = u.header["size"]
                if u.header["size"] == 0:
                    del self._pending_recv[rreq]
                    if state.finish is not None:
                        state.finish()
                    req.complete()
                    # still ACK so the sender's request completes
                self.layer.send(u.src, T.AM_P2P,
                                {"k": "ack", "sreq": u.header["sreq"],
                                 "rreq": rreq}, b"")

        return req, on_match

    # -- matched probe (≙ MPI_Mprobe/Mrecv, ompi/message/) ------------------

    @_guarded
    def improbe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG,
                cid: int = 0) -> Optional["Message"]:
        """Match-and-dequeue: the returned Message can no longer match any
        other receive on this rank (MPI_Improbe)."""
        self.spc.inc("probes")
        self.engine.progress()
        u = self.matching.probe(cid, src, tag, remove=True)
        return None if u is None else Message(u)

    def mprobe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG,
               cid: int = 0, timeout: Optional[float] = None) -> "Message":
        box: list = []

        def check() -> bool:
            m = self.improbe(src, tag, cid)
            if m is not None:
                box.append(m)
                return True
            return False

        self.engine.wait_until(check, timeout=timeout)
        if not box:
            raise TimeoutError("mprobe: no matching message")
        return box[0]

    @_guarded
    def imrecv(self, msg: "Message", buf,
               datatype: Optional[Datatype] = None,
               count: Optional[int] = None) -> Request:
        """Receive the matched message into ``buf`` (MPI_Imrecv)."""
        u = msg.consume()
        req, on_match = self._recv_handler(buf, datatype, count)
        on_match(u)
        return req

    def mrecv(self, msg: "Message", buf,
              datatype: Optional[Datatype] = None,
              count: Optional[int] = None):
        return self.imrecv(msg, buf, datatype, count).wait()

    @_guarded
    def cancel_recv(self, req: Request) -> bool:
        """Withdraw a still-posted receive (MPI_Cancel for recvs; used by
        blocking ANY_SOURCE recv to avoid leaking a zombie post when it
        converts PROC_FAILED_PENDING to fail-stop)."""
        ref = req._posted_ref
        if ref is None or req.done:
            return False
        matching, cid, posted = ref
        ok = matching.cancel(cid, posted)
        if ok:
            req.status.cancelled = True
        return ok

    def recv(self, buf, src: int = ANY_SOURCE, tag: int = ANY_TAG, cid: int = 0,
             datatype: Optional[Datatype] = None, count: Optional[int] = None):
        return self.irecv(buf, src, tag, cid, datatype, count).wait()

    def sendrecv(self, sendbuf, dst: int, recvbuf, src: int,
                 sendtag: int = 0, recvtag: int = ANY_TAG, cid: int = 0):
        rreq = self.irecv(recvbuf, src, recvtag, cid)
        sreq = self.isend(sendbuf, dst, sendtag, cid)
        status = rreq.wait()
        sreq.wait()
        return status

    # -- probe --------------------------------------------------------------

    @_guarded
    def iprobe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG, cid: int = 0):
        self.spc.inc("probes")
        self.engine.progress()
        u = self.matching.probe(cid, src, tag)
        if u is None:
            return None
        st = {"source": u.src, "tag": u.tag, "count": u.header["size"]}
        return st

    def probe(self, src: int = ANY_SOURCE, tag: int = ANY_TAG, cid: int = 0,
              timeout: Optional[float] = None):
        result = {}

        def check() -> bool:
            r = self.iprobe(src, tag, cid)
            if r:
                result.update(r)
                return True
            return False

        self.engine.wait_until(check, timeout=timeout)
        return result or None

    # -- active-message handler (≙ recv_frag callbacks) ---------------------

    def _am_handler(self, src: int, header: Dict[str, Any], payload: bytes) -> None:
        k = header["k"]
        if k in ("match", "rndv"):
            self.matching.arrived(header["cid"], src, header["tag"],
                                  header["seq"], k, header, payload)
        elif k == "ack":
            self._handle_ack(src, header["sreq"], header["rreq"])
        elif k == "frag":
            self._handle_frag(header["rreq"], header["off"], payload)
        else:
            raise RuntimeError(f"unknown p2p frame kind {k!r}")

    def _handle_ack(self, src: int, sreq: int, rreq: int) -> None:
        state = self._pending_send.pop(sreq, None)
        if state is None:
            return
        if rreq < 0:             # receiver matched but discarded (truncate)
            state.req.complete()
        else:
            self._stream_frags(src, rreq, state)

    def _handle_frag(self, rreq: int, off: int, payload: bytes) -> None:
        state = self._pending_recv.get(rreq)
        if state is None:
            return
        state.conv.set_position(off)
        state.conv.unpack(payload)
        state.received += len(payload)
        if state.received >= state.total:
            del self._pending_recv[rreq]
            if state.finish is not None:
                state.finish()
            state.req.complete()

    def _stream_frags(self, dst: int, rreq: int, state: _SendState) -> None:
        if state.data is None and state.keep is not None:
            state.data = state.keep.tobytes()   # pack at the ACK
        data = state.data
        if not data:
            state.req.complete()
            return
        # one path a peer: the port's transports are self and tcp, and only
        # one reaches a peer (bml/r2 striping returns with shm, ROADMAP P7);
        # a transport error completes the send request with it
        transport = self.layer.for_peer(dst)
        try:
            self._send_range(dst, rreq, data, transport)
            transport.confirm(dst)    # surface async transport errors NOW
        except Exception as exc:
            self.layer.mark_failed(dst, transport)
            state.req.complete(exc)
            return
        state.req.complete()   # sender side done once handed to transport

    def _send_range(self, dst: int, rreq: int, data, transport) -> None:
        """Stream the message as max_send_size fragments."""
        chunk = transport.max_send_size
        for off in range(0, len(data), chunk):
            transport.send(dst, T.AM_P2P, {"k": "frag", "rreq": rreq,
                                           "off": off},
                           data[off:off + chunk])
