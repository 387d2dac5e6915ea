"""Byte-transport framework (≙ the BTL, opal/mca/btl/btl.h:1172).

A transport moves opaque frames (header dict + payload bytes) between ranks.
Kept from the reference's BTL contract:
  * ``eager_limit`` / ``max_send_size`` per-transport tunables
    (btl.h:1176,1179) registered as variables;
  * active-message dispatch: received frames carry a *tag* that indexes a
    process-global callback table (btl.h:626
    ``mca_btl_base_active_message_trigger``) — the p2p protocol, one-sided,
    and FT heartbeats each own a tag;
  * components register into the ``transport`` framework and are selected
    per-peer by priority/reachability (≙ BML r2, ompi/mca/bml/bml.h:57-72).

Transports in-tree: ``self`` (loopback), ``tcp`` (DCN analog), ``shm``
(shared-memory ring buffers; native C++ fast path in native/shmbox.cpp).

The port's copy of ``ompi_tpu/p2p/transport.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

from ..core import var as _var
from ..core.component import Component
from ..core.progress import _NULL_GUARD as _null_guard

# Active-message tags (≙ mca_btl_base_active_message_trigger indices)
AM_P2P = 1          # matched point-to-point protocol (p2p/pml.py)
AM_OSC = 2          # one-sided windows
AM_FT = 3           # failure-detector heartbeats
AM_COLL = 4         # collective internals (host path)


class Transport(Component):
    """Per-job transport *module*; the registered singleton acts as the
    component whose query() instantiates a fresh module (the reference's
    component-vs-module split, docs/mca.rst:14-28)."""

    def __init__(self) -> None:
        self.eager_limit = _var.register(
            "transport", self.name or "base", "eager_limit", 65536, type=int,
            level=4, help="Max bytes sent eagerly in one frame.").value
        self.max_send_size = _var.register(
            "transport", self.name or "base", "max_send_size", 1 << 20, type=int,
            level=4, help="Max fragment size for pipelined sends.").value
        # per-rank active-message dispatch: tag → cb(src, header, payload);
        # installed by the runtime Context before init_job
        self.dispatch: Dict[int, Callable[[int, Dict[str, Any], bytes], None]] = {}

    def deliver(self, src: int, tag: int, header: Dict[str, Any], payload: bytes) -> None:
        cb = self.dispatch.get(tag)
        if cb is None:
            raise RuntimeError(f"no active-message handler for tag {tag}")
        cb(src, header, payload)

    def query(self, scope: Any = None):
        """Create a fresh module instance (per rank/job)."""
        inst = type(self)()
        inst.priority = self.priority
        return self.priority, inst

    def init_job(self, bootstrap) -> None:
        """Wire up using the control plane (publish/lookup addresses)."""

    def reachable(self, peer: int) -> bool:
        raise NotImplementedError

    def send(self, peer: int, tag: int, header: Dict[str, Any], payload: bytes) -> None:
        """Enqueue a frame; delivery is asynchronous. Must be orderable:
        frames to the same peer+tag arrive in send order (MPI non-overtaking
        depends on this, like single-BTL ordering in the reference)."""
        raise NotImplementedError

    def progress(self) -> int:
        return 0

    def confirm(self, peer: int) -> None:
        """Block until frames previously accepted for ``peer`` are handed
        off (or raise on a failed path). Transports whose send() already
        guarantees handoff (shm rings, loopback) need nothing here; tcp
        overrides it to drain its outbuf and surface async errors."""

    def pending_count(self, exclude: frozenset = frozenset()) -> int:
        """Frames accepted by send() but not yet on the wire, not counting
        peers in ``exclude`` (dead ranks never drain their ring). Finalize
        must progress until every transport reports 0 — the reference spins
        opal_progress inside every blocking point for the same reason
        (opal/runtime/opal_progress.c:216)."""
        return 0

    def finalize(self) -> None:
        pass


class TransportLayer:
    """Per-peer transport choice (≙ BML r2's per-peer BTL arrays,
    bml_r2.c).

    The highest-priority transport that reports the peer reachable OWNS
    the peer: every control/ordered frame rides it (per-channel FIFO stays
    trivially correct, like single-BTL ordering), and ``mark_failed``
    retires it after an error mid-stream.  Striping fragment trains across
    several transports (bml.h:57-72) waits for a second transport that
    reaches a peer (shm, ROADMAP P7).
    """

    def __init__(self, transports: List[Transport]) -> None:
        self.transports = sorted(transports, key=lambda t: -t.priority)
        self._by_peer: Dict[int, Transport] = {}
        self._failed: Dict[int, set] = {}
        self._lock = threading.Lock()
        self.guard = None     # async-progress RLock (Context wires it)

    def for_peer(self, peer: int) -> Transport:
        with self._lock:
            t = self._by_peer.get(peer)
            if t is None:
                failed = self._failed.get(peer, ())
                for cand in self.transports:
                    if cand.name not in failed and cand.reachable(peer):
                        t = cand
                        break
                if t is None:
                    raise RuntimeError(f"no transport reaches rank {peer}")
                self._by_peer[peer] = t
            return t

    def mark_failed(self, peer: int, transport: Transport) -> None:
        """Retire a transport for a peer (error mid-stream): for_peer
        re-selects from the survivors."""
        with self._lock:
            self._failed.setdefault(peer, set()).add(transport.name)
            self._by_peer.pop(peer, None)

    def send(self, peer: int, tag: int, header: Dict[str, Any], payload: bytes = b"") -> None:
        # guard: serialize against the async progress thread when enabled
        with self.guard or _null_guard:
            self.for_peer(peer).send(peer, tag, header, payload)

    def transport_matrix(self) -> Dict[int, str]:
        """Which transport serves each wired peer (≙ hook/comm_method's
        transport matrix dump, hook_comm_method_fns.c:25)."""
        with self._lock:
            return {p: t.name for p, t in self._by_peer.items()}
