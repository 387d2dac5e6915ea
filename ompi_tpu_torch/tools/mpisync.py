"""Cross-rank clock synchronization for trace alignment (the port's copy
of ``ompi_tpu/tools/mpisync.py``).

≙ ompi/tools/mpisync (mpigclock.c): every rank measures its clock offset
against rank 0 with ping-pong rounds, taking the sample with the MINIMUM
round-trip (the echo least perturbed by scheduling — mpigclock's RTT
filter), offset = remote_midpoint_time - local_midpoint. The offsets let
per-rank SPC/monitoring timestamps merge into one global timeline
(``trace.merge``), and the winning RTT bounds how well: the true offset
lies within ±best_rtt/2 of the estimate, so merge reports it as the
per-rank alignment confidence.

Library: ``offsets = clock_sync(comm)`` (every rank's offset vs rank 0,
seconds; bcast to all) or ``offsets, best_rtt = clock_sync_ex(comm)``
for the confidence bound alongside. CLI: ``tpurun -np N -m
ompi_tpu_torch.tools.mpisync`` prints the table on rank 0.  The ping-pong
runs over the communicator's host point-to-point (numpy buffers), so it
needs no device plane.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

SYNC_TAG = 733            # user-tag space; callers pick quiescent moments
DEFAULT_ROUNDS = 25


def _measure_offset(comm, peer: int, rounds: int) -> Tuple[float, float]:
    """Rank 0 side: (offset of ``peer``'s clock relative to ours, the
    winning round-trip time that offset was sampled under)."""
    best_rtt = float("inf")
    best_off = 0.0
    remote = np.zeros(1, np.float64)
    for _ in range(rounds):
        t0 = time.monotonic()
        comm.send(np.zeros(1, np.float64), peer, SYNC_TAG)
        comm.recv(remote, peer, SYNC_TAG)
        t1 = time.monotonic()
        rtt = t1 - t0
        if rtt < best_rtt:
            best_rtt = rtt
            best_off = float(remote[0]) - (t0 + t1) / 2.0
    return best_off, best_rtt


def clock_sync_ex(comm, rounds: int = DEFAULT_ROUNDS
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Collective: returns, on every rank, ``(offsets, best_rtt)`` —
    per-rank clock offsets (seconds, relative to rank 0; offsets[0] == 0)
    and the minimum round-trip each offset was sampled under (the ±rtt/2
    alignment-confidence bound; best_rtt[0] == 0).

    A size-1 communicator needs no ping-pong (there is no peer clock to
    align): both tables are trivially zero and no traffic is sent.
    """
    if comm.size == 1:
        return np.zeros(1, np.float64), np.zeros(1, np.float64)
    table = np.zeros((2, comm.size), np.float64)
    if comm.rank == 0:
        for peer in range(1, comm.size):
            table[0, peer], table[1, peer] = _measure_offset(
                comm, peer, rounds)
    else:
        ping = np.zeros(1, np.float64)
        for _ in range(rounds):
            comm.recv(ping, 0, SYNC_TAG)
            comm.send(np.array([time.monotonic()], np.float64), 0, SYNC_TAG)
    table = np.asarray(comm.coll.bcast(comm, table, root=0))
    return table[0], table[1]


def clock_sync(comm, rounds: int = DEFAULT_ROUNDS) -> np.ndarray:
    """Collective: returns, on every rank, the per-rank clock offsets
    (seconds, relative to rank 0; offsets[0] == 0)."""
    return clock_sync_ex(comm, rounds)[0]


def main(argv: Optional[list] = None) -> int:
    from .. import runtime

    ctx = runtime.init()
    comm = ctx.comm_world
    offsets, rtts = clock_sync_ex(comm)
    if ctx.rank == 0:
        print("mpisync clock offsets vs rank 0 (seconds; ±best_rtt/2):")
        for r, (off, rtt) in enumerate(zip(offsets, rtts)):
            print(f"  rank {r:4d}  {off:+.6e}  ±{rtt / 2:.6e}")
    runtime.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
