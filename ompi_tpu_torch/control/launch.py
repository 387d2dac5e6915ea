"""``tpurun`` — the launcher (≙ mpirun → prterun → prted, SURVEY.md §3.4).

The reference's mpirun is a thin wrapper that locates and execs PRRTE's
prterun (ompi/tools/mpirun/main.c:33); the real work — spawning ranks and
wiring them to the control plane — happens in the runtime. Here the launcher
itself hosts the coordinator (control/tcp.py) and fork/execs one Python
process per rank with the environment contract:

    OMPI_TPU_RANK / OMPI_TPU_SIZE / OMPI_TPU_COORD (host:port) /
    OMPI_TPU_JOB / OMPI_TPU_LOCAL_RANK / OMPI_TPU_NUM_LOCAL

``--mca name value`` CLI assignments are forwarded as OMPI_TPU_<name> env
vars, preserving the reference's source-precedence semantics (§5.6).

Rank-per-card (north star, BASELINE.json): ``--gpus-per-rank N`` binds each
rank to its own card(s) by setting ``CUDA_VISIBLE_DEVICES`` to the rank's
share of the cards the launcher itself was given (its own
``CUDA_VISIBLE_DEVICES``, else every card of the host): local rank r takes
entries [r·N, (r+1)·N) of that list, and a job that needs more cards than
the list holds is refused (the counterpart of the JAX package's
``--chips-per-rank`` and ``TPU_VISIBLE_DEVICES``).  The rank then sees its
first card as ``cuda:0``, and ``OMPI_TPU_BOUND_CARDS`` tells the device
plane so.  ``--device-plane cpu`` instead asks for the gloo plane on CPU
tensors — the test fabric, and the only way to get it.  Ranks then call
``parallel.device_plane.init_device_plane(ctx)`` to join
``torch.distributed`` across the job (the rendezvous address travels
through the modex).

Multi-host (the DVM-less pattern): run one tpurun per host —
``tpurun -np 8 --num-hosts 2 --host-index 0 app.py`` on the head (hosts
the coordinator, prints its address) and ``... --host-index 1
--coordinator HEAD:PORT app.py`` on each worker. Ranks split into
contiguous per-host spans; the head's coordinator stays up until every
rank (local and remote) reports finished. Inter-host rank traffic takes
the tcp transport automatically (shm's host-key reachability declines
cross-host peers).

The port's copy of ``ompi_tpu/control/launch.py``.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
from typing import Dict, List

from .tcp import Coordinator


def visible_cards(base: Dict[str, str]) -> List[str]:
    """The cards a launcher may hand out: its inherited
    ``CUDA_VISIBLE_DEVICES`` (a scheduler's or another launcher's choice),
    else every card the CUDA runtime sees."""
    inherited = base.get("CUDA_VISIBLE_DEVICES")
    if inherited is not None:
        return [c.strip() for c in inherited.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


def build_env(base: Dict[str, str], rank: int, size: int, coord: str,
              job: str, mca: List[str], gpus_per_rank: int = 0,
              device_plane: str = "none", bind_to: str = "none",
              local_rank: int | None = None,
              num_local: int | None = None) -> Dict[str, str]:
    env = dict(base)
    local_rank = rank if local_rank is None else local_rank
    num_local = size if num_local is None else num_local
    if bind_to != "none":
        # CPU binding (≙ PRRTE --map-by package --bind-to core): the rank
        # applies its cpuset at Context init (hwtopo.apply_env_binding);
        # the plan is over THIS HOST's local ranks
        from ..core import hwtopo
        cpus = hwtopo.bind_plan(num_local, bind_to)[local_rank]
        if cpus:
            env["OMPI_TPU_BIND_CPUS"] = ",".join(map(str, cpus))
    env["OMPI_TPU_RANK"] = str(rank)
    env["OMPI_TPU_SIZE"] = str(size)
    env["OMPI_TPU_COORD"] = coord
    env["OMPI_TPU_JOB"] = job
    env["OMPI_TPU_LOCAL_RANK"] = str(local_rank)
    env["OMPI_TPU_NUM_LOCAL"] = str(num_local)
    if device_plane == "cpu":
        # test fabric: init_device_plane(ctx) joins the gloo plane on CPU
        # tensors instead of NCCL on the card
        env["OMPI_TPU_DEVICE_PLANE"] = "cpu"
    elif gpus_per_rank > 0:
        # card binding (≙ PRRTE binding, ompi_rte.c:536): the CUDA runtime
        # exposes only the listed cards, so this rank's first is cuda:0
        have = visible_cards(base)
        first = local_rank * gpus_per_rank
        if first + gpus_per_rank > len(have):
            raise ValueError(
                f"--gpus-per-rank {gpus_per_rank}: local rank {local_rank} "
                f"needs cards [{first}, {first + gpus_per_rank}) of the "
                f"{len(have)} this launcher was given ({have})")
        cards = ",".join(have[first:first + gpus_per_rank])
        env["CUDA_VISIBLE_DEVICES"] = cards
        env["OMPI_TPU_BOUND_CARDS"] = cards
    for assign in mca:
        name, _, value = assign.partition("=")
        env[f"OMPI_TPU_{name}"] = value
    return env


def _notify_coordinator(coord_str: str, abort: bool, rank: int, code: int,
                        fins: int) -> None:
    """Worker-launcher side of failure propagation: ABORT wakes every
    blocked fence/get job-wide (non-recovery — mpirun semantics), FIN per
    dead rank lets the head's wait_finished converge (recovery mode).
    Best-effort: the coordinator may already be gone."""
    import socket as _socket

    from .tcp import recv_msg, send_msg

    host, _, port = coord_str.rpartition(":")

    def _one(msg) -> None:
        try:
            with _socket.create_connection((host, int(port)),
                                           timeout=5) as conn:
                send_msg(conn, msg)
                recv_msg(conn)
        except OSError:
            pass

    if abort:
        _one(("ABORT", rank, code, "rank failed on worker host"))
    else:
        for _ in range(fins):
            _one(("FIN",))


class _AbortPoller:
    """Worker-launcher watch on the coordinator's abort state over ONE
    persistent connection (ABORTQ does not terminate the server's per-
    connection loop, so a single connection serves the whole job — no
    per-poll connect/thread churn on the head). A vanished coordinator is
    NOT an abort: the head closes it after a healthy job too, and ranks
    learn of a dead coordinator through their own bootstrap connections."""

    def __init__(self, coord_str: str) -> None:
        host, _, port = coord_str.rpartition(":")
        self._addr = (host, int(port))
        self._conn = None

    def query(self):
        import socket as _socket

        from .tcp import recv_msg, send_msg

        try:
            if self._conn is None:
                self._conn = _socket.create_connection(self._addr, timeout=2)
            send_msg(self._conn, ("ABORTQ",))
            reply = recv_msg(self._conn)
            self.unreachable = 0
            return reply[1] if reply and reply[0] == "OK" else None
        except OSError:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
            # a vanished coordinator is ambiguous: healthy jobs end with
            # the head closing it too. One miss is not an abort; SUSTAINED
            # unreachability while our ranks still run means the head died
            # hard (launcher SIGKILL) and the job is lost — the caller
            # checks this counter.
            self.unreachable = getattr(self, "unreachable", 0) + 1
            return None

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurun", description="Launch an N-rank ompi_tpu_torch job.")
    ap.add_argument("-np", "-n", dest="np", type=int, required=True,
                    help="number of ranks")
    ap.add_argument("--mca", action="append", nargs=2, default=[],
                    metavar=("NAME", "VALUE"),
                    help="set variable NAME to VALUE for all ranks")
    ap.add_argument("--timeout", type=float, default=None,
                    help="kill the job after this many seconds")
    ap.add_argument("--gpus-per-rank", type=int, default=0,
                    help="bind each rank to this many cards via "
                         "CUDA_VISIBLE_DEVICES (0 = no binding)")
    ap.add_argument("--device-plane", choices=["none", "cpu"], default="none",
                    help="'cpu' puts the device plane on gloo and CPU "
                         "tensors (multi-process test fabric)")
    ap.add_argument("--bind-to", choices=["none", "core", "package"],
                    default="none",
                    help="bind each rank's CPUs (≙ mpirun --bind-to): "
                         "'core' spreads ranks across packages then cores, "
                         "'package' gives each rank a whole package")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="multi-host job: total participating hosts; ranks "
                         "are split into contiguous per-host spans (run one "
                         "tpurun per host — the DVM-less pattern)")
    ap.add_argument("--host-index", type=int, default=0,
                    help="this host's index in [0, num_hosts)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="join an existing coordinator (worker launchers; "
                         "host 0 prints its address at startup)")
    ap.add_argument("--enable-recovery", action="store_true",
                    help="ULFM mode (≙ prte --enable-recovery): a failed "
                         "rank does NOT take the job down; survivors run "
                         "detector/revoke/shrink recovery. Job exit code is "
                         "0 if any rank exits 0.")
    ap.add_argument("-m", dest="module", default=None,
                    help="run a python module as the program (like python "
                         "-m); everything after the module name goes to it")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="program and args (a python script or executable)")
    if argv is None:
        argv = sys.argv[1:]
    # argparse.REMAINDER only engages at the first positional, so module
    # arguments like `-m mod --flag` would be rejected — split manually:
    # everything after `-m <module>` belongs to the module, verbatim
    module_rest: List[str] = []
    if "-m" in argv:
        i = argv.index("-m")
        module_rest = argv[i + 2:]
        argv = argv[:i + 2]
    args = ap.parse_args(argv)
    args.command = args.command + module_rest
    if not args.command and not args.module:
        ap.error("no command given")
    if args.device_plane == "cpu" and args.gpus_per_rank > 0:
        ap.error("--device-plane cpu and --gpus-per-rank conflict "
                 "(the CPU fabric has no cards to bind)")

    if not (0 <= args.host_index < args.num_hosts):
        ap.error("--host-index must be in [0, num_hosts)")
    if args.coordinator is None and args.host_index != 0:
        ap.error("worker launchers (host-index > 0) need --coordinator")

    # contiguous per-host rank spans (≙ PRRTE's by-node mapping): host i
    # owns [base, base+span) where the first np%num_hosts hosts get one
    # extra rank
    per, extra = divmod(args.np, args.num_hosts)
    span = per + (1 if args.host_index < extra else 0)
    base = args.host_index * per + min(args.host_index, extra)
    if span == 0:
        ap.error(f"host {args.host_index} has no ranks (np={args.np}, "
                 f"num_hosts={args.num_hosts})")
    if args.gpus_per_rank > 0:
        have = visible_cards(dict(os.environ))
        if span * args.gpus_per_rank > len(have):
            ap.error(f"{span} ranks × --gpus-per-rank {args.gpus_per_rank} "
                     f"need {span * args.gpus_per_rank} cards; this "
                     f"launcher was given {len(have)} ({have})")

    coord = None
    if args.coordinator is None:
        # head launcher hosts the coordinator; bind wide + advertise a
        # routable address for multi-host jobs. The job id derives from
        # the coordinator port on BOTH sides so worker launchers agree
        # without extra plumbing.
        bind = "0.0.0.0" if args.num_hosts > 1 else "127.0.0.1"
        coord = Coordinator(size=args.np, job_id="pending", host=bind)
        port = coord.address[1]
        coord.job_id = f"tpurun-{port}"
        if args.num_hosts > 1:
            from ..p2p.reachable import best_address
            adv = best_address(None) or "127.0.0.1"
            print(f"tpurun: coordinator at {adv}:{port} "
                  f"(workers: --coordinator {adv}:{port})", flush=True)
        else:
            adv = "127.0.0.1"
        coord_str = f"{adv}:{port}"
        job_id = coord.job_id
    else:
        coord_str = args.coordinator
        job_id = f"tpurun-{coord_str.rpartition(':')[2]}"
    mca = [f"{n}={v}" for n, v in args.mca]

    cmd = args.command
    if args.module:
        cmd = [sys.executable, "-m", args.module] + cmd
    elif cmd[0].endswith(".py"):
        cmd = [sys.executable] + cmd

    procs: List[subprocess.Popen] = []
    env_base = dict(os.environ)
    # children import ompi_tpu_torch from this checkout
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env_base["PYTHONPATH"] = pkg_root + os.pathsep + env_base.get("PYTHONPATH", "")
    for rank in range(base, base + span):
        env = build_env(env_base, rank, args.np, coord_str, job_id,
                        mca, args.gpus_per_rank, args.device_plane,
                        args.bind_to, local_rank=rank - base,
                        num_local=span)
        procs.append(subprocess.Popen(cmd, env=env))

    def kill_all(sig=signal.SIGTERM):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    exit_code = 0
    timed_out = False
    poller = (None if coord is not None or args.num_hosts <= 1
              else _AbortPoller(coord_str))
    first_failed_rank = None
    try:
        remaining = list(procs)
        import time
        deadline = None if args.timeout is None else time.monotonic() + args.timeout
        term_at = None          # when SIGTERM went out (escalate to KILL)
        abort_check_at = time.monotonic()
        while remaining:
            # abort watch: MPI_Abort or another host's rank failure →
            # kill our local ranks too, like mpirun taking the whole job
            # down. The head (or single-host launcher) checks its
            # coordinator object; workers poll over a persistent
            # connection every ~0.5 s.
            if not args.enable_recovery and term_at is None \
                    and (coord is not None or poller is not None) \
                    and time.monotonic() - abort_check_at > 0.5:
                abort_check_at = time.monotonic()
                ab = (coord.aborted if coord is not None
                      else poller.query())
                if ab is None and poller is not None \
                        and getattr(poller, "unreachable", 0) >= 10:
                    ab = (-1, 1, "coordinator unreachable for 5s with "
                          "local ranks still running (head died?)")
                if ab is not None:
                    print(f"tpurun: job aborted by rank {ab[0]} "
                          f"(code {ab[1]}): {ab[2]}", file=sys.stderr)
                    exit_code = exit_code or int(ab[1]) or 1
                    kill_all()
                    term_at = time.monotonic()
            for p in list(remaining):
                rc = p.poll()
                if rc is None:
                    continue
                remaining.remove(p)
                if rc != 0 and exit_code == 0:
                    exit_code = rc
                    first_failed_rank = base + procs.index(p)
                    if not args.enable_recovery:
                        # a failed rank takes the job down, like mpirun
                        kill_all()
                        term_at = time.monotonic()
                        if coord is not None:
                            # head's own rank failed: mark the job aborted
                            # so worker launchers' polls see it
                            with coord.cond:
                                if coord.aborted is None:
                                    coord.aborted = (first_failed_rank, rc,
                                                     "rank failed")
                                coord.cond.notify_all()
            if term_at is not None and time.monotonic() - term_at > 5.0:
                # a rank ignored SIGTERM (e.g. wedged in a native collective
                # init) — escalate so the job always terminates
                kill_all(signal.SIGKILL)
                term_at = None
            if deadline is not None and time.monotonic() > deadline:
                print("tpurun: timeout — killing job", file=sys.stderr)
                kill_all(signal.SIGKILL)
                timed_out = True
                exit_code = exit_code or 124
                break
            time.sleep(0.02)
    except KeyboardInterrupt:
        kill_all(signal.SIGKILL)
        exit_code = 130
    finally:
        # cross-launcher failure propagation: without this, a rank crash on
        # one host leaves the other hosts' ranks asleep in fence/get
        # forever (single-host never has the gap — one launcher sees every
        # exit). Dead ranks also count as finished so the head's grace
        # wait converges under --enable-recovery.
        n_failed = sum(1 for p in procs
                       if p.returncode not in (None, 0))
        fail_rank = first_failed_rank if first_failed_rank is not None \
            else base
        if coord is not None:
            if n_failed and not args.enable_recovery:
                with coord.cond:
                    if coord.aborted is None:
                        coord.aborted = (fail_rank, exit_code, "rank failed")
                    coord.cond.notify_all()
            elif n_failed:
                with coord.cond:
                    coord.finished += n_failed
                    coord.cond.notify_all()
            if args.num_hosts > 1 and not timed_out:
                # local ranks are done but remote hosts' ranks may still be
                # finalizing through this coordinator — hold it open until
                # every rank reports (or a grace timeout)
                coord.wait_finished(timeout=60)
                if coord.aborted is not None:
                    # hold the abort state visible for at least one worker
                    # poll interval so remote launchers learn WHY before
                    # the port disappears
                    import time as _t
                    _t.sleep(1.5)
                # a remote-host failure discovered during the grace wait
                # must reach the head's exit status (the mpirun analog)
                if coord.aborted is not None and exit_code == 0 \
                        and not args.enable_recovery:
                    exit_code = int(coord.aborted[1]) or 1
                    print(f"tpurun: job aborted by rank "
                          f"{coord.aborted[0]} (code {coord.aborted[1]}): "
                          f"{coord.aborted[2]}", file=sys.stderr)
            coord.close()
        else:
            if poller is not None:
                poller.close()
            if n_failed:
                _notify_coordinator(coord_str,
                                    abort=not args.enable_recovery,
                                    rank=fail_rank, code=exit_code or 1,
                                    fins=n_failed)
    if args.enable_recovery and not timed_out and exit_code != 130 \
            and any(p.returncode == 0 for p in procs):
        exit_code = 0          # survivors recovered; that IS success
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
