"""Completion objects (≙ ompi/request/request.h:129 + wait/test engines).

The port's copy of ``ompi_tpu/p2p/request.py``, without the PERUSE events
and the health plane's flight recorder (ROADMAP P16).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from ..core.progress import get_engine

ANY_SOURCE = -1
ANY_TAG = -1


class Status:
    __slots__ = ("source", "tag", "count", "error", "cancelled")

    def __init__(self) -> None:
        self.source = ANY_SOURCE
        self.tag = ANY_TAG
        self.count = 0
        self.error = 0
        self.cancelled = False


class Request:
    """A pending communication. Completion is driven by the progress engine."""

    __slots__ = ("done", "status", "error", "result", "_on_complete", "_ctx",
                 "pending_error", "_posted_ref")

    def __init__(self) -> None:
        self.done = False
        self.status = Status()
        self.error: Optional[Exception] = None
        self.result: Any = None       # collective/value-carrying completions
        self._on_complete: List[Callable[["Request"], None]] = []
        self._ctx: Any = None
        self._posted_ref: Any = None  # (matching, cid, Posted) while queued
        # ULFM MPIX_ERR_PROC_FAILED_PENDING: raised once by wait/test while
        # the request STAYS active (an ANY_SOURCE recv interrupted by a peer
        # failure can still complete from survivors after failure_ack)
        self.pending_error: Optional[Exception] = None

    def set_pending(self, err: Exception) -> None:
        if not self.done:
            self.pending_error = err

    def add_completion_callback(self, cb: Callable[["Request"], None]) -> None:
        if self.done:
            cb(self)
        else:
            self._on_complete.append(cb)

    def complete(self, error: Optional[Exception] = None) -> None:
        if self.done:
            return
        self.error = error
        self.done = True
        for cb in self._on_complete:
            cb(self)
        self._on_complete.clear()

    def test(self) -> bool:
        if not self.done:
            get_engine().progress()
        if not self.done and self.pending_error is not None:
            err, self.pending_error = self.pending_error, None
            raise err
        return self.done

    def wait(self, timeout: Optional[float] = None) -> Status:
        get_engine().wait_until(
            lambda: self.done or self.pending_error is not None,
            timeout=timeout)
        if not self.done and self.pending_error is not None:
            # request remains active; the caller acks the failure and may
            # wait again (ULFM PROC_FAILED_PENDING discipline)
            err, self.pending_error = self.pending_error, None
            raise err
        if not self.done:
            raise TimeoutError("request did not complete")
        if self.error is not None:
            raise self.error
        return self.status


class CompletedRequest(Request):
    def __init__(self, count: int = 0, result: Any = None) -> None:
        super().__init__()
        self.done = True
        self.status.count = count
        self.result = result


def _settled(r: Request) -> bool:
    return r.done or r.pending_error is not None


def wait_all(requests: List[Request], timeout: Optional[float] = None) -> List[Status]:
    get_engine().wait_until(lambda: all(_settled(r) for r in requests),
                            timeout=timeout)
    out = []
    for r in requests:
        if not r.done and r.pending_error is not None:
            # PROC_FAILED_PENDING must surface here too — an ANY_SOURCE recv
            # interrupted by a peer failure would otherwise hang waitall
            err, r.pending_error = r.pending_error, None
            raise err
        if not r.done:
            raise TimeoutError("waitall: request did not complete")
        if r.error is not None:
            raise r.error
        out.append(r.status)
    return out


def wait_any(requests: List[Request], timeout: Optional[float] = None) -> int:
    get_engine().wait_until(lambda: any(_settled(r) for r in requests),
                            timeout=timeout)
    for i, r in enumerate(requests):
        if r.done:
            if r.error is not None:
                raise r.error
            return i
    for r in requests:
        if r.pending_error is not None:
            err, r.pending_error = r.pending_error, None
            raise err
    raise TimeoutError("waitany: no request completed")


class GeneralizedRequest(Request):
    """MPI_Grequest_start/complete (MPI-4 §3.9): user-level operations that
    complete through the MPI request machinery. The user marks completion
    with ``grequest_complete()``; the query callback then fills the status
    (exactly once — hooked at the completion layer so EVERY wait flavor,
    wait/test/wait_all/wait_any, observes it) and the free callback
    releases the user's resources. Cancellation routes to the user's
    cancel function; per MPI, whether a cancel succeeded is reported by
    the USER's query_fn setting ``status.cancelled``."""

    __slots__ = ("_query_fn", "_free_fn", "_cancel_fn", "_queried")

    def __init__(self, query_fn=None, free_fn=None, cancel_fn=None) -> None:
        super().__init__()
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn
        self._queried = False
        self.add_completion_callback(self._grequest_collect)

    def _grequest_collect(self, _req) -> None:
        if self._queried:
            return
        self._queried = True
        if self._query_fn is not None:
            self._query_fn(self.status)
        if self._free_fn is not None:
            self._free_fn()

    def grequest_complete(self) -> None:
        """The user's operation finished (MPI_Grequest_complete)."""
        self.complete()

    def cancel(self) -> None:
        if self._cancel_fn is not None:
            self._cancel_fn(self.done)


def grequest_start(query_fn=None, free_fn=None,
                   cancel_fn=None) -> GeneralizedRequest:
    """MPI_Grequest_start."""
    return GeneralizedRequest(query_fn, free_fn, cancel_fn)
