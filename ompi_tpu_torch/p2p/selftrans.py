"""Loopback transport (≙ btl/self): immediate in-process delivery.

The port's copy of ``ompi_tpu/p2p/selftrans.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict

from ..core.component import component
from . import transport as T


@component("transport", "self", priority=100)
class SelfTransport(T.Transport):
    name = "self"

    def __init__(self) -> None:
        super().__init__()
        self.rank = -1
        self._queue: deque = deque()

    def init_job(self, bootstrap) -> None:
        self.rank = bootstrap.rank

    def reachable(self, peer: int) -> bool:
        return peer == self.rank

    def send(self, peer: int, tag: int, header: Dict[str, Any], payload: bytes) -> None:
        assert peer == self.rank
        # queued (not delivered inline) so send() never re-enters matching
        self._queue.append((tag, header, payload))

    def progress(self) -> int:
        n = 0
        while self._queue:
            tag, header, payload = self._queue.popleft()
            self.deliver(self.rank, tag, header, payload)
            n += 1
        return n
