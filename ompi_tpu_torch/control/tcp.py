"""TCP coordinator: the out-of-band control plane for multi-process jobs.

Plays the role PMIx + prted play in the reference (SURVEY.md §3.1 — the PMIx
client↔daemon unix socket): rank processes connect to one coordinator
(run inside the ``tpurun`` launcher, control/launch.py ≙ mpirun→prterun,
ompi/tools/mpirun/main.c:33) and speak a tiny length-prefixed msgpack-style
protocol: HELLO / PUT / GET / FENCE / EVENT / POLL / ABORT / FIN.

GET blocks server-side until the peer has published the key — the modex
"direct fetch" behavior (pmix-internal.h OPAL_MODEX_RECV semantics).

The port's copy of ``ompi_tpu/control/tcp.py``.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from .bootstrap import Bootstrap, BootstrapError

_HDR = struct.Struct("!I")


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _HDR.size)
    (n,) = _HDR.unpack(hdr)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class Coordinator:
    """The launcher-side server. One thread per rank connection (N ≤ O(100))."""

    def __init__(self, size: int, job_id: str = "job0", host: str = "127.0.0.1") -> None:
        self.size = size
        self.job_id = job_id
        self.kv: Dict[Tuple[int, str], Any] = {}
        self.cond = threading.Condition()
        self.fence_count = 0
        self.fence_gen = 0
        self.events: List[List[Dict[str, Any]]] = [[] for _ in range(size)]
        self.aborted: Optional[Tuple[int, int, str]] = None
        self.finished = 0
        self._srv = socket.create_server((host, 0))
        self.address = self._srv.getsockname()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        try:
            while True:
                conn, _ = self._srv.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
                t.start()
                # prune finished handlers so long jobs with transient
                # connections don't accumulate dead Thread objects
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
        except OSError:
            return  # server closed

    def _serve(self, conn: socket.socket) -> None:
        rank = -1
        try:
            while True:
                msg = recv_msg(conn)
                op = msg[0]
                if op == "HELLO":
                    rank = msg[1]
                    send_msg(conn, ("OK", self.size, self.job_id))
                elif op == "PUT":
                    _, r, key, value = msg
                    with self.cond:
                        self.kv[(r, key)] = value
                        self.cond.notify_all()
                    send_msg(conn, ("OK",))
                elif op == "GET":
                    _, peer, key, timeout = msg
                    with self.cond:
                        ok = self.cond.wait_for(
                            lambda: (peer, key) in self.kv or self.aborted,
                            timeout=timeout)
                        if self.aborted:
                            send_msg(conn, ("ABORTED", self.aborted))
                        elif not ok:
                            send_msg(conn, ("TIMEOUT",))
                        else:
                            send_msg(conn, ("OK", self.kv[(peer, key)]))
                elif op == "FENCE":
                    _, r, timeout = msg
                    with self.cond:
                        gen = self.fence_gen
                        self.fence_count += 1
                        if self.fence_count == self.size:
                            self.fence_count = 0
                            self.fence_gen += 1
                            self.cond.notify_all()
                            send_msg(conn, ("OK",))
                        else:
                            ok = self.cond.wait_for(
                                lambda: self.fence_gen > gen
                                or self.aborted,
                                timeout=timeout)
                            if self.aborted:
                                send_msg(conn, ("ABORTED", self.aborted))
                            elif not ok:
                                send_msg(conn, ("TIMEOUT",))
                            else:
                                send_msg(conn, ("OK",))
                elif op == "EVENT":
                    _, r, event = msg
                    with self.cond:
                        for i in range(self.size):
                            if i != r:
                                self.events[i].append(dict(event))
                    send_msg(conn, ("OK",))
                elif op == "POLL":
                    _, r = msg
                    with self.cond:
                        out, self.events[r] = self.events[r], []
                    send_msg(conn, ("OK", out))
                elif op == "ABORT":
                    _, r, code, text = msg
                    with self.cond:
                        self.aborted = (r, code, text)
                        self.cond.notify_all()
                    send_msg(conn, ("OK",))
                elif op == "ABORTQ":
                    # launcher-side poll: has anyone aborted the job? (the
                    # cross-launcher propagation path — remote launchers
                    # kill their local ranks when this turns non-None)
                    with self.cond:
                        send_msg(conn, ("OK", self.aborted))
                elif op == "FIN":
                    with self.cond:
                        self.finished += 1
                        self.cond.notify_all()
                    send_msg(conn, ("OK",))
                    return
        except (ConnectionError, EOFError, OSError):
            return

    def wait_finished(self, timeout: float = None) -> bool:
        with self.cond:
            return self.cond.wait_for(
                lambda: self.finished >= self.size or self.aborted,
                timeout=timeout)

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass


class TcpBootstrap(Bootstrap):
    process_scoped = True
    """Rank-side client: one persistent connection, RPCs serialized under a
    lock (rank-side callers are single-threaded; subsystems needing async
    notification — e.g. the failure detector — open their own TcpBootstrap)."""

    def __init__(self, address: Tuple[str, int], rank: int) -> None:
        self.rank = rank
        self._addr = tuple(address)
        self._lock = threading.Lock()
        self._sock = self._connect()
        with self._lock:
            send_msg(self._sock, ("HELLO", rank))
            resp = recv_msg(self._sock)
        if resp[0] != "OK":
            raise BootstrapError(f"coordinator refused: {resp}")
        self.size, self.job_id = resp[1], resp[2]

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _rpc(self, msg: Tuple) -> Tuple:
        with self._lock:
            send_msg(self._sock, msg)
            resp = recv_msg(self._sock)
        if resp[0] == "ABORTED":
            raise BootstrapError(f"job aborted: {resp[1]}")
        if resp[0] == "TIMEOUT":
            raise BootstrapError(f"control-plane op timed out: {msg[0]}")
        return resp

    def put(self, key: str, value: Any) -> None:
        self._rpc(("PUT", self.rank, key, value))

    def get(self, peer: int, key: str, timeout: float = 30.0) -> Any:
        return self._rpc(("GET", peer, key, timeout))[1]

    def fence(self, timeout: float = 60.0) -> None:
        self._rpc(("FENCE", self.rank, timeout))

    @property
    def coord_address(self) -> Tuple[str, int]:
        return self._addr

    def publish_event(self, event: Dict[str, Any]) -> None:
        self._rpc(("EVENT", self.rank, event))

    def poll_events(self) -> List[Dict[str, Any]]:
        return self._rpc(("POLL", self.rank))[1]

    def abort(self, code: int = 1, msg: str = "") -> None:
        try:
            self._rpc(("ABORT", self.rank, code, msg))
        except BootstrapError:
            pass

    def finalize(self) -> None:
        try:
            self._rpc(("FIN", self.rank))
        except (BootstrapError, ConnectionError, OSError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
