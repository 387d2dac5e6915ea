"""Progress engine — the global polling loop.

Re-design of opal/runtime/opal_progress.c:216-241: components (transports,
nonblocking-collective schedules, failure detector) register callbacks; any
thread blocked on a request completion spins in ``progress()`` which polls
every registered callback. High/low priority tiers are kept from the
reference: low-priority callbacks (e.g. connection management, heartbeats)
run only every Nth call, like libevent being pumped every 8th call.

Completion of host-side p2p is polled here; device-side collectives
complete on their CUDA stream, outside this engine.

The port's copy of ``ompi_tpu/core/progress.py``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List

_LOW_PRIORITY_INTERVAL = 8

_NULL_GUARD = contextlib.nullcontext()   # reusable, reentrant no-op guard


class ProgressEngine:
    def __init__(self) -> None:
        self._high: List[Callable[[], int]] = []
        self._low: List[Callable[[], int]] = []
        self._lock = threading.RLock()
        self.polls = 0                  # lifetime pass count (SPC + low-pri gate)
        self.time_waiting = 0.0         # seconds inside wait_until (SPC)
        self.idle_wait: Callable[[float], None] | None = None
        # blocking idle hook (e.g. the shm transport's doorbell): when a
        # wait loop goes idle, block here instead of sleeping blind
        #
        # guard: None under the default FUNNELED contract (exactly one
        # thread drives the engine, unlocked). With async progress
        # (runtime_async_progress, ≙ the reference's opt-in progress
        # thread) this is an RLock serializing the progress thread against
        # the owner thread's library entry points — progress() takes it,
        # and the pml/TransportLayer entry points take it too.
        self.guard: threading.RLock | None = None

    def register(self, fn: Callable[[], int], low_priority: bool = False) -> None:
        with self._lock:
            (self._low if low_priority else self._high).append(fn)

    def unregister(self, fn: Callable[[], int]) -> None:
        with self._lock:
            for lst in (self._high, self._low):
                if fn in lst:
                    lst.remove(fn)

    def progress(self) -> int:
        """One pass over callbacks; returns number of completed events."""
        events = 0
        with self._lock:
            high = list(self._high)
            self.polls += 1
            low = list(self._low) if self.polls % _LOW_PRIORITY_INTERVAL == 0 else []
        with self.guard or _NULL_GUARD:
            for fn in high:
                events += fn() or 0
            for fn in low:
                events += fn() or 0
        return events

    def wait_until(self, cond: Callable[[], bool], timeout: float | None = None) -> bool:
        """Spin in progress() until cond() — the ompi_request_wait_completion
        pattern (reference ompi/request/request.h:129 wait loop)."""
        start = time.monotonic()
        deadline = None if timeout is None else start + timeout
        idle = 0
        try:
            while not cond():
                if self.progress() == 0:
                    idle += 1
                    # Back off fast: on a busy host the *peer* needs our
                    # timeslice to produce the frame we're waiting for, so
                    # spinning delays our own completion. First yield, then
                    # block on the idle hook (doorbell) so the sender can
                    # wake us in µs rather than a scheduler quantum.
                    if idle > 4:
                        if self.idle_wait is not None:
                            self.idle_wait(0.0005)
                        else:
                            time.sleep(0.0001)
                    elif idle > 1:
                        time.sleep(0)     # sched_yield
                else:
                    idle = 0
                if deadline is not None and time.monotonic() > deadline:
                    return cond()
            return True
        finally:
            self.time_waiting += time.monotonic() - start


_tls = threading.local()
progress_engine = ProgressEngine()     # initial process-wide default engine
_process_default = progress_engine


def get_engine() -> ProgressEngine:
    """The calling thread's engine — per-rank in threaded multi-rank jobs
    (thread-local), the process default otherwise (so worker threads a user
    spawns after init() poll the context's engine, not an empty one)."""
    return getattr(_tls, "engine", _process_default)


def set_engine(engine: ProgressEngine | None) -> None:
    _tls.engine = engine if engine is not None else _process_default


def set_process_engine(engine: ProgressEngine) -> None:
    """Make `engine` the fallback for threads with no thread-local binding —
    called by runtime.init() for the process-level (singleton/tpurun) path."""
    global _process_default
    _process_default = engine


def adopt_engine(engine: ProgressEngine) -> None:
    """Bind `engine` to the calling thread, and make it the process fallback
    if only the pristine placeholder was installed so far. Called from
    Context.__init__: a Context constructed directly (without runtime.init)
    must still drive ITS engine from blocking waits — the placeholder has no
    transport callbacks registered, so waiting on it deadlocks on the first
    rendezvous (the reference never has this problem because opal_progress
    is a process-wide singleton, opal_progress.c:216)."""
    global _process_default
    _tls.engine = engine
    if _process_default is progress_engine:
        _process_default = engine


def progress() -> int:
    return get_engine().progress()
