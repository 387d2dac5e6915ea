"""Output streams and aggregated user-facing diagnostics.

Re-design of:
  * opal/util/output.c (1043 LoC) — per-subsystem verbosity-gated streams;
  * opal/util/show_help.c (471 LoC) — de-duplicated, aggregated help messages.

Per-subsystem verbosity is an MCA variable ``<subsys>__verbose`` resolved
through the var system, so ``OMPI_TPU_coll_verbose=20`` works like the
reference's ``OMPI_MCA_coll_base_verbose``.

The port's copy of ``ompi_tpu/core/output.py``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Set

from . import var as _var


class Output:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._levels: Dict[str, int] = {}
        self._stream = sys.stderr

    def _level(self, subsys: str) -> int:
        lvl = self._levels.get(subsys)
        if lvl is None:
            v = _var.register(subsys, "", "verbose", 0, type=int, level=8,
                              help=f"Verbosity for subsystem '{subsys}' (0..100).")
            lvl = int(v.value)
            self._levels[subsys] = lvl
        return lvl

    def set_verbosity(self, subsys: str, level: int) -> None:
        with self._lock:
            self._levels[subsys] = level

    def verbose(self, level: int, subsys: str, msg: str) -> None:
        if self._level(subsys) >= level:
            rank = os.environ.get("OMPI_TPU_RANK", "?")
            with self._lock:
                print(f"[{time.strftime('%H:%M:%S')}][rank {rank}][{subsys}] {msg}",
                      file=self._stream, flush=True)

    def error(self, subsys: str, msg: str) -> None:
        rank = os.environ.get("OMPI_TPU_RANK", "?")
        with self._lock:
            print(f"[rank {rank}][{subsys}] ERROR: {msg}", file=self._stream, flush=True)


output = Output()


class ShowHelp:
    """Aggregated, de-duplicated diagnostics (opal/util/show_help.c).

    The reference reads message templates from help-*.txt catalogs; we keep the
    catalog inline (topic → template) and preserve the two load-bearing
    behaviors: de-duplication of repeated topics, and a single well-formatted
    banner so errors are recognizable.
    """

    CATALOG: Dict[str, str] = {
        "no-component": "No usable component found for framework '%s'.\n"
                        "Check the '%s_select' variable (current: '%s').",
        "bootstrap-timeout": "Timed out waiting for %s peers to join job '%s'.\n"
                             "Check that all ranks were launched and can reach the\n"
                             "coordinator at %s.",
        "peer-failed": "Peer rank %s appears to have failed (no heartbeat for %.1fs).\n"
                       "Communicator operations may raise RevokedError.",
        "truncate": "Message truncated: receive buffer of %d bytes is smaller than\n"
                    "the %d-byte incoming message (tag %s from rank %s).",
    }

    def __init__(self) -> None:
        self._seen: Set[str] = set()
        self._lock = threading.Lock()

    def show(self, topic: str, *args, dedup: bool = True) -> str:
        with self._lock:
            body = self.CATALOG.get(topic, topic)
            try:
                body = body % args if args else body
            except TypeError:
                body = f"{body} {args!r}"
            text = (
                "--------------------------------------------------------------------------\n"
                + body
                + "\n--------------------------------------------------------------------------"
            )
            if dedup and topic in self._seen:
                return body
            self._seen.add(topic)
            print(text, file=sys.stderr, flush=True)
            return body


show_help = ShowHelp()
