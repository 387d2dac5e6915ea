"""TCP transport (≙ btl/tcp, opal/mca/btl/tcp/btl_tcp_component.c:1253).

Event-driven non-blocking sockets pumped from the progress engine. Design
points kept from the reference:
  * listen address published through the modex at init, lazy connect on first
    send (the reference creates endpoints connection-less at add_procs and
    connects on demand);
  * all I/O is non-blocking: sends append to a per-connection out-queue and
    drain when the socket is writable — two ranks blasting large fragments at
    each other can never deadlock in sendall;
  * per-direction ordering: the initiating side of a connection is the only
    sender on it (simplex pairs), so frames to a given peer arrive in send
    order — which the matching layer's non-overtaking guarantee rides on.

This is the data plane for host-side traffic; device payloads ride NCCL
through the coll/nccl component instead.

The port's copy of ``ompi_tpu/p2p/tcp.py``.
"""

from __future__ import annotations

import selectors
import socket
import struct
import time
from collections import deque
from typing import Any, Dict, Optional

from ..core.component import component
from ..core.output import output
from . import transport as T
from . import wire

# stream framing: [u32 frame_len][u32 hdr_len][wire header][payload]
_HDR = struct.Struct("!II")
_READ_WRITE = selectors.EVENT_READ | selectors.EVENT_WRITE


def _whole_frame(buf: bytearray) -> bool:
    """True when ``buf`` starts with a complete frame."""
    return (len(buf) >= _HDR.size
            and len(buf) >= _HDR.size + _HDR.unpack_from(buf)[0])


def _advertised_host() -> str:
    """The address peers should dial: loopback for single-host jobs, the
    best-weighted interface toward the coordinator for multi-host (DCN)
    jobs (reachable.py ≙ opal/mca/reachable/weighted), falling back to a
    kernel routing probe when enumeration finds nothing."""
    import os

    coord = os.environ.get("OMPI_TPU_COORD", "")
    host = coord.rpartition(":")[0]
    if not host or host.startswith("127.") or host == "localhost":
        return "127.0.0.1"
    # the kernel routing table is authoritative when it has an answer: a
    # UDP connect names the source interface that actually routes toward
    # the coordinator (weighting must never override routing — a private
    # storage NIC may score high yet be unreachable from the peers)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect((host, 1))
        return probe.getsockname()[0]
    except OSError:
        pass
    finally:
        probe.close()
    # no route answer (resolver down, UDP filtered): fall back to the
    # weighted interface ladder, then the hostname
    from .reachable import best_address
    picked = best_address(host)
    if picked is not None and not picked.startswith("127."):
        return picked
    return socket.gethostbyname(socket.gethostname())


class _Conn:
    def __init__(self, sock: socket.socket) -> None:
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = deque()      # of memoryview
        self.out_bytes = 0
        self.peer: Optional[int] = None   # known for rx conns after HELLO


@component("transport", "tcp", priority=10)
class TcpTransport(T.Transport):
    name = "tcp"

    def __init__(self) -> None:
        super().__init__()
        self.rank = -1
        self.size = 0
        self._bootstrap = None
        self._sel = selectors.DefaultSelector()
        self._listener: Optional[socket.socket] = None
        self._tx: Dict[int, _Conn] = {}      # peer → conn I initiated
        self._rx: list[_Conn] = []           # conns initiated by peers
        self._addrs: Dict[int, tuple] = {}
        self._poll_skip = 0
        self.failed_peers: set = set()       # peers with dropped traffic (FT hook)

    # -- lifecycle ----------------------------------------------------------

    def init_job(self, bootstrap) -> None:
        self.rank, self.size = bootstrap.rank, bootstrap.size
        self._bootstrap = bootstrap
        self._listener = socket.create_server(("0.0.0.0", 0))
        self._listener.setblocking(False)
        self._sel.register(self._listener, selectors.EVENT_READ, ("accept", None))
        bootstrap.put("transport_tcp_addr",
                      (_advertised_host(), self._listener.getsockname()[1]))

    def reachable(self, peer: int) -> bool:
        return 0 <= peer < self.size

    def _addr_of(self, peer: int) -> tuple:
        addr = self._addrs.get(peer)
        if addr is None:
            addr = tuple(self._bootstrap.get(peer, "transport_tcp_addr"))
            self._addrs[peer] = addr
        return addr

    def _tx_conn(self, peer: int) -> _Conn:
        conn = self._tx.get(peer)
        if conn is None:
            sock = socket.create_connection(self._addr_of(peer))
            conn = _Conn(sock)
            conn.peer = peer
            self._tx[peer] = conn
            self._sel.register(sock, selectors.EVENT_READ, ("tx", conn))
            self._enqueue(conn, wire.encode_hello(self.rank), b"")
        return conn

    # -- tx -----------------------------------------------------------------

    def _enqueue(self, conn: _Conn, hdr: bytes, payload) -> None:
        n = len(hdr) + len(payload)
        conn.outbuf.append(memoryview(_HDR.pack(n, len(hdr)) + hdr))
        if len(payload):
            conn.outbuf.append(memoryview(payload) if not isinstance(
                payload, memoryview) else payload)
        conn.out_bytes += n + _HDR.size
        self._flush(conn)

    def send(self, peer: int, tag: int, header: Dict[str, Any], payload: bytes) -> None:
        # Failed peers keep the historical silent-drop semantics (AM reply
        # paths run inside the progress loop with no handler for a raise);
        # the pml's fragment stream learns about failures through confirm().
        self._enqueue(self._tx_conn(peer), wire.encode(tag, header), payload)

    def _absorb_rx(self) -> None:
        """Pull bytes off every readable socket into its inbuf WITHOUT
        parsing or delivery. confirm()'s drain loop calls this so a peer
        in the same situation can empty ITS kernel tx window (mutual
        large sends would otherwise deadlock on full buffers) — and
        because nothing is dispatched, there is no re-entrant AM handling;
        the next progress() pass parses what landed here."""
        for key, _mask in self._sel.select(timeout=0):
            kind, conn = key.data
            if kind == "accept":
                continue               # leave accepts to progress()
            try:
                while True:
                    chunk = conn.sock.recv(1 << 18)
                    if not chunk:
                        break          # EOF — progress() will close it
                    conn.inbuf.extend(chunk)
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                pass

    def confirm(self, peer: int) -> None:
        """Drain the peer's outbuf to the kernel, raising if the
        connection failed — the synchronous error surface of the pml's
        fragment stream:
        _flush swallows OSError asynchronously (send() only ENQUEUES), so
        a fragment range is only 'handed to the transport' once this
        returns (≙ the reference btl's des_cbfunc completion callback).

        The stall deadline is a NO-PROGRESS window, not a total cap: any
        bytes the kernel accepts push it out, so a slow-but-alive peer
        (small windows, congested loopback) is never misdiagnosed as
        failed (only a connection making zero forward progress for the
        full window raises, and the pml then retires the path)."""
        conn = self._tx.get(peer)
        stall_window = 30.0
        deadline = time.monotonic() + stall_window
        last_out = conn.out_bytes if conn is not None else 0
        while conn is not None and conn.outbuf:
            if peer in self.failed_peers:
                break
            self._flush(conn)
            if conn.out_bytes < last_out:      # forward progress → extend
                last_out = conn.out_bytes
                deadline = time.monotonic() + stall_window
            if conn.outbuf:
                if time.monotonic() > deadline:
                    raise OSError(
                        f"tcp to rank {peer}: no forward progress for "
                        f"{stall_window:.0f}s ({conn.out_bytes} bytes "
                        "stuck)")
                self._absorb_rx()      # keep rx moving: no mutual-send
                time.sleep(0.0002)     # deadlock on full kernel buffers
        if peer in self.failed_peers:
            raise OSError(f"tcp connection to rank {peer} has failed")

    def _flush(self, conn: _Conn) -> int:
        sent = 0
        while conn.outbuf:
            mv = conn.outbuf[0]
            try:
                n = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as exc:
                output.error("transport",
                             f"tcp send to rank {conn.peer} failed, dropping "
                             f"{conn.out_bytes} queued bytes: {exc}")
                conn.outbuf.clear()
                conn.out_bytes = 0
                self.failed_peers.add(conn.peer)
                return sent
            sent += n
            conn.out_bytes -= n
            if n == len(mv):
                conn.outbuf.popleft()
            else:
                conn.outbuf[0] = mv[n:]
        return sent

    # -- rx / progress ------------------------------------------------------

    def progress(self) -> int:
        # A rank whose traffic all rides shm still pays this select()
        # syscall every poll. With zero established connections the only
        # thing to catch is a first accept — check that every 8th poll.
        # (connect() itself succeeds against the listen backlog, so this
        # only delays processing of the first frames; kept small because
        # idle polls can each block ~0.5 ms in the shm doorbell.)
        if not self._tx and not self._rx:
            self._poll_skip = (self._poll_skip + 1) % 8
            if self._poll_skip:
                return 0
        events = 0
        for key, _mask in self._sel.select(timeout=0):
            kind, conn = key.data
            if kind == "accept":
                try:
                    sock, _ = self._listener.accept()
                except OSError:
                    continue
                c = _Conn(sock)
                self._rx.append(c)
                self._sel.register(sock, selectors.EVENT_READ, ("rx", c))
                continue
            events += self._drain(conn)
        # frames absorbed during confirm() sit in inbufs with no further
        # socket readability to re-trigger select — parse them now
        for conn in list(self._rx) + list(self._tx.values()):
            if conn.inbuf:
                events += self._parse(conn)
        # drain pending sends even when sockets never became readable
        for conn in self._tx.values():
            if conn.outbuf:
                self._flush(conn)
        return events

    def _drain(self, conn: _Conn) -> int:
        eof = False
        try:
            while True:
                chunk = conn.sock.recv(1 << 18)
                if not chunk:
                    # peer closed — frames already buffered (sent just before
                    # the close) must still be parsed and delivered below
                    eof = True
                    break
                conn.inbuf.extend(chunk)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            eof = True
        delivered = self._parse(conn)
        if eof:
            self._close(conn)
        return delivered

    def _parse(self, conn: _Conn) -> int:
        delivered = 0
        buf = conn.inbuf
        while len(buf) >= _HDR.size:
            n, hlen = _HDR.unpack_from(buf)
            if len(buf) < _HDR.size + n:
                break
            tag, header = wire.decode(
                memoryview(buf)[_HDR.size:_HDR.size + hlen])
            payload = bytes(buf[_HDR.size + hlen:_HDR.size + n])
            del buf[:_HDR.size + n]
            if tag is wire.HELLO:
                conn.peer = header["rank"]
            else:
                self.deliver(conn.peer, tag, header, payload)
                delivered += 1
        return delivered

    def _close(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn in self._rx:
            self._rx.remove(conn)
        for peer, c in list(self._tx.items()):
            if c is conn:
                del self._tx[peer]

    def pending_count(self, exclude: frozenset = frozenset()) -> int:
        return sum(1 for p, c in self._tx.items()
                   if c.outbuf and p not in exclude)

    def has_activity(self) -> bool:
        """True when live connections exist — the runtime caps doorbell
        blocking then, since tcp peers cannot ring a local semaphore."""
        return bool(self._tx or self._rx)

    def idle_wait(self, timeout: float) -> None:
        """Block in the selector until a connection or the listener turns
        readable (or ``timeout``) — the progress engine's idle hook, this
        transport's doorbell: a waiting rank wakes when its frame lands
        instead of polling between blind sleeps. A whole frame already in
        an inbuf (absorbed by ``confirm``, not yet parsed) needs progress,
        not sleep, so the hook only cedes the core then; a partial one
        waits for the rest of its bytes like any other. Connections with
        frames still queued to send also wake it when they turn
        writable."""
        conns = list(self._rx) + list(self._tx.values())
        if any(_whole_frame(c.inbuf) for c in conns):
            time.sleep(0)
            return
        pending = [c for c in self._tx.values() if c.outbuf]
        for c in pending:
            self._sel.modify(c.sock, _READ_WRITE, ("tx", c))
        try:
            self._sel.select(timeout=timeout)
        finally:
            for c in pending:
                self._sel.modify(c.sock, selectors.EVENT_READ, ("tx", c))

    def finalize(self) -> None:
        for conn in list(self._tx.values()) + list(self._rx):
            if conn.sock.fileno() < 0:
                continue
            # best-effort flush of queued frames before teardown
            conn.sock.setblocking(True)
            try:
                while conn.outbuf:
                    self._flush(conn)
            except OSError:
                pass
            self._close(conn)
        if self._listener is not None:
            try:
                self._sel.unregister(self._listener)
            except (KeyError, ValueError):
                pass
            self._listener.close()
