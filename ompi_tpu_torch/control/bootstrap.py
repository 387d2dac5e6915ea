"""Bootstrap control plane — identity, modex KV exchange, fence, events.

This is the deliberately tiny API Open MPI keeps between the library and its
runtime (PMIx client: reference opal/mca/pmix/pmix-internal.h:247-401 —
``OPAL_MODEX_SEND_STRING`` / ``OPAL_MODEX_RECV*`` / fence — plus the PMIx
event handlers the ULFM code registers, ompi/instance/instance.c:440-466).
Keeping it this small is what makes the launcher separable (SURVEY.md §3.4).

Two implementations:
  * ``LocalBootstrap``  — in-process, for threaded ranks (the reference's
    single-host testing stance, SURVEY.md §4) and for singleton init;
  * ``TcpBootstrap`` (control/tcp.py) — rank processes connect to a
    coordinator over TCP; used by the ``tpurun`` launcher.  It also
    carries the device plane's rendezvous address (``torch_store``).

The port's copy of ``ompi_tpu/control/bootstrap.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class BootstrapError(RuntimeError):
    pass


class Bootstrap:
    # True when one OS process hosts exactly this rank (tpurun children):
    # MPI_Abort may then terminate the process. False for in-process
    # (threaded) ranks, where killing the process would take out peers.
    process_scoped = False
    """Abstract control plane for one rank."""

    rank: int
    size: int
    job_id: str

    def put(self, key: str, value: Any) -> None:
        """Publish a (key → value) for this rank (≙ OPAL_MODEX_SEND)."""
        raise NotImplementedError

    def get(self, peer: int, key: str, timeout: float = 30.0) -> Any:
        """Fetch peer's published value, blocking until available
        (≙ OPAL_MODEX_RECV)."""
        raise NotImplementedError

    def fence(self, timeout: float = 60.0) -> None:
        """All-ranks barrier; publishes become globally visible after
        (≙ PMIx_Fence — the only collective in startup, instance.c:529-596)."""
        raise NotImplementedError

    def abort(self, code: int = 1, msg: str = "") -> None:
        raise NotImplementedError

    def publish_event(self, event: Dict[str, Any]) -> None:
        """Broadcast an event to every rank (≙ PMIx_Notify_event)."""
        raise NotImplementedError

    def poll_events(self) -> List[Dict[str, Any]]:
        """Drain pending events for this rank."""
        raise NotImplementedError

    def finalize(self) -> None:
        pass


class _LocalJob:
    """Shared state for all LocalBootstrap ranks of one in-process job."""

    def __init__(self, size: int, job_id: str) -> None:
        self.size = size
        self.job_id = job_id
        self.kv: Dict[Tuple[int, str], Any] = {}
        self.cond = threading.Condition()
        self.fence_count = 0
        self.fence_gen = 0
        self.events: List[List[Dict[str, Any]]] = [[] for _ in range(size)]
        self.aborted: Optional[Tuple[int, int, str]] = None


class LocalBootstrap(Bootstrap):
    def __init__(self, job: _LocalJob, rank: int) -> None:
        self._job = job
        self.rank = rank
        self.size = job.size
        self.job_id = job.job_id

    @staticmethod
    def create_job(size: int, job_id: str = "local") -> List["LocalBootstrap"]:
        job = _LocalJob(size, job_id)
        return [LocalBootstrap(job, r) for r in range(size)]

    def put(self, key: str, value: Any) -> None:
        with self._job.cond:
            self._job.kv[(self.rank, key)] = value
            self._job.cond.notify_all()

    def get(self, peer: int, key: str, timeout: float = 30.0) -> Any:
        with self._job.cond:
            ok = self._job.cond.wait_for(
                lambda: (peer, key) in self._job.kv or self._job.aborted,
                timeout=timeout,
            )
            if self._job.aborted:
                raise BootstrapError(f"job aborted: {self._job.aborted}")
            if not ok:
                raise BootstrapError(
                    f"modex get timed out: rank {self.rank} waiting for "
                    f"({peer}, {key!r})")
            return self._job.kv[(peer, key)]

    def fence(self, timeout: float = 60.0) -> None:
        job = self._job
        with job.cond:
            gen = job.fence_gen
            job.fence_count += 1
            if job.fence_count == job.size:
                job.fence_count = 0
                job.fence_gen += 1
                job.cond.notify_all()
                return
            ok = job.cond.wait_for(
                lambda: job.fence_gen > gen or job.aborted, timeout=timeout)
            if job.aborted:
                raise BootstrapError(f"job aborted: {job.aborted}")
            if not ok:
                raise BootstrapError(f"fence timed out on rank {self.rank}")

    def abort(self, code: int = 1, msg: str = "") -> None:
        with self._job.cond:
            self._job.aborted = (self.rank, code, msg)
            self._job.cond.notify_all()

    def publish_event(self, event: Dict[str, Any]) -> None:
        with self._job.cond:
            for r in range(self.size):
                if r != self.rank:
                    self._job.events[r].append(dict(event))
            self._job.cond.notify_all()

    def poll_events(self) -> List[Dict[str, Any]]:
        with self._job.cond:
            out = self._job.events[self.rank]
            self._job.events[self.rank] = []
            return out
