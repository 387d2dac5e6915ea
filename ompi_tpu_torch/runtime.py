"""Runtime init/finalize — wires control plane, transports, p2p, collectives.

Re-design of the reference's staged bring-up (SURVEY.md §3.1):
ompi_mpi_init (ompi/runtime/ompi_mpi_init.c:302) →
ompi_mpi_instance_init_common (ompi/instance/instance.c:347): RTE/PMIx init,
framework opens, modex + fence, then COMM_WORLD construction. Here:

    Context(bootstrap):
      1. per-rank progress engine (≙ opal_progress init)
      2. open/select transport modules, publish addresses   (≙ btl add_procs)
      3. bootstrap.fence()                                   (≙ PMIx fence —
         the ONLY collective in startup, instance.c:529-596)
      4. p2p protocol engine                                 (≙ pml select)
      5. COMM_WORLD with the coll framework's per-comm table (≙ comm_init_mpi3)

A Context is one *rank*. Multi-process jobs have one per process (tpurun
environment contract); threaded single-host jobs create N in one process —
the reference's single-host test stance (SURVEY.md §4). The singleton path
(no launcher env) gives a size-1 world, like singleton MPI init.

Thread level: FUNNELED — exactly one thread per Context may call into
p2p/coll (the matching engine, transports, and selector are driven from that
thread's progress loop, unlocked). Multiple Contexts in one process (threaded
ranks) are fully independent.

The port's copy of ``ompi_tpu/runtime.py``: ``Context``, ``init``,
``finalize`` and ``run_ranks``.  Left out: the native pml
(``maybe_native``), the shm transport, the memchecker, the health plane,
the init/finalize hooks and monitoring (ROADMAP P16, P19), async progress
(it comes with one-sided windows) and the interlib registry.

Threaded ranks share one process, and ``torch.distributed`` has one world
a process, so a Context that shares its process with other ranks
(``shares_process``) cannot join the device plane: ``attach_mesh`` refuses
it, naming the one-process-per-rank model of ``tpurun``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from .control import Bootstrap, LocalBootstrap, from_environment
from .core.component import frameworks
from .core.output import output
from .core.progress import ProgressEngine, set_engine
from .p2p import selftrans, tcp  # noqa: F401  (register transports)
from .p2p.pml import P2P
from .p2p.transport import TransportLayer


class Context:
    def __init__(self, bootstrap: Optional[Bootstrap] = None) -> None:
        self.bootstrap = bootstrap if bootstrap is not None else from_environment()
        self.rank = self.bootstrap.rank
        # "world" = this job's ranks (a dynamically spawned child's own
        # world at an offset of the global rank space comes with dpm)
        self.size = self.bootstrap.size
        self.world_ranks = list(range(self.size))
        self.world_cid = 0
        # CPU binding (≙ PRRTE applying the hwloc cpuset before app start):
        # the launcher computes per-rank cpusets (--bind-to) and passes
        # them down; a rank binds itself first thing so every thread it
        # spawns (progress, io worker) inherits the set
        from .core import hwtopo
        self.bound_cpus = hwtopo.apply_env_binding()
        self.engine = ProgressEngine()
        self.am_table: dict = {}
        mods = []
        for pri, comp, mod in frameworks.framework("transport").select_all(self):
            mod.dispatch = self.am_table
            mod.init_job(self.bootstrap)
            mods.append(mod)
        if not mods:
            raise RuntimeError("no transport components available")
        self.bootstrap.fence()
        # block idle waits in the first transport that can announce its own
        # arrivals (≙ the reference's shm doorbell hook; tcp's selector here)
        owner = next((t for t in mods if hasattr(t, "idle_wait")), None)
        if owner is not None:
            self.engine.idle_wait = owner.idle_wait
        self.layer = TransportLayer(mods)
        from .spc import Counters
        self.spc = Counters()
        self.p2p = P2P(self.bootstrap, self.layer, self.engine, spc=self.spc)
        self._comm_world = None
        self.finalized = False
        # blocking waits on this thread must pump THIS context's engine even
        # when the user constructs Context directly instead of runtime.init()
        from .core.progress import adopt_engine
        adopt_engine(self.engine)

    @property
    def shares_process(self) -> bool:
        """True for a threaded rank: other ranks of its job live in this
        process (run_ranks), so it cannot own the process's device plane."""
        return isinstance(self.bootstrap, LocalBootstrap) and self.size > 1

    @property
    def comm_world(self):
        """COMM_WORLD, built lazily (imports the comm layer on first use)."""
        if self._comm_world is None:
            from .comm import Communicator
            self._comm_world = Communicator._world(self)
        return self._comm_world

    def finalize(self) -> None:
        if self.finalized:
            return
        self.finalized = True
        from .core import var as _var
        self.spc._v["progress_polls"] = self.engine.polls
        self.spc._v["time_in_wait"] = self.engine.time_waiting
        if _var.get("spc_dump_enabled", False):
            self.spc.dump(self.rank)
        # Drain transports before fencing: frames parked when a socket
        # was full must reach the wire, or a
        # peer still blocked in recv never completes. The reference runs
        # opal_progress inside every blocking point for exactly this
        # (opal/runtime/opal_progress.c:216); finalize is a blocking point.
        # Frames destined to failed ranks are not waited on (their ring
        # never drains), and an idle spin yields so a 1-core host can run
        # the peers whose progress we're waiting for.
        import time as _time
        dead = frozenset(getattr(self, "failed", ()))
        deadline = _time.monotonic() + 10.0
        while any(t.pending_count(dead) for t in self.layer.transports):
            if self.engine.progress() == 0:
                _time.sleep(0.0005)
            if _time.monotonic() > deadline:
                output.verbose(
                    1, "runtime",
                    "finalize: transports still have pending frames after "
                    "10s; proceeding to fence anyway")
                break
        try:
            self.bootstrap.fence()
        except Exception as exc:
            output.verbose(1, "runtime", f"finalize fence failed: {exc}")
        for t in self.layer.transports:
            t.finalize()
        self.bootstrap.finalize()

    def abort(self, code: int = 1, msg: str = "") -> None:
        """MPI_Abort semantics: notify the control plane (so the launcher
        and fence/get-blocked peers learn), then — when this process hosts
        exactly this rank — terminate it (MPI_Abort does not return,
        ompi/mpi/c/abort.c). Threaded in-process ranks (run_ranks) only
        notify: killing the host process would take out peer ranks and the
        harness; their LocalBootstrap wakes peers instead.

        Exit-status clamp: POSIX statuses are 8-bit, and an abort must
        never look like success, so the reported status is
        ``(code & 0xFF) or 1`` — errorcode 0 and any multiple of 256 both
        surface as status 1. Launcher-side consumers comparing statuses to
        the original errorcode should compare mod 256 (0 ≙ 1)."""
        try:
            self.bootstrap.abort(code, msg)
        finally:
            if getattr(self.bootstrap, "process_scoped", False):
                import os as _os
                # exit statuses are 8-bit: clamp so an abort can never
                # report success (e.g. code 256 -> status 0)
                _os._exit((int(code) & 0xFF) or 1)

    # -- control-plane events (the canonical poll point) ---------------------

    def push_event(self, ev: dict) -> None:
        """Re-queue an event another consumer drained but doesn't own."""
        if not hasattr(self, "_event_backlog"):
            self._event_backlog = []
        self._event_backlog.append(ev)

    def poll_events(self) -> list:
        """Backlogged + freshly-arrived control-plane events. Consumers that
        drain events they don't own must push_event() them back."""
        out = getattr(self, "_event_backlog", [])
        self._event_backlog = []
        out.extend(self.bootstrap.poll_events())
        return out


_process_ctx: Optional[Context] = None


def init(bootstrap: Optional[Bootstrap] = None) -> Context:
    """Process-level init (≙ MPI_Init). Idempotent."""
    global _process_ctx
    if _process_ctx is None or _process_ctx.finalized:
        _process_ctx = Context(bootstrap)
        set_engine(_process_ctx.engine)
        # worker threads the user spawns must poll this engine too
        from .core.progress import set_process_engine
        set_process_engine(_process_ctx.engine)
    return _process_ctx


def finalize() -> None:
    global _process_ctx
    if _process_ctx is not None:
        _process_ctx.finalize()
        _process_ctx = None


_job_seq = 0


def run_ranks(n: int, fn: Callable[[Context], object],
              timeout: float = 60.0) -> List[object]:
    """Run ``fn(ctx)`` on n threaded ranks wired through a LocalBootstrap —
    the in-process analog of ``tpurun -np n`` used by the test suite
    (SURVEY.md §4: the reference tests multi-rank logic single-host)."""
    import os

    from .control.bootstrap import LocalBootstrap

    global _job_seq
    _job_seq += 1
    boots = LocalBootstrap.create_job(
        n, job_id=f"thr{os.getpid()}n{_job_seq}")
    results: List[object] = [None] * n
    errors: List[BaseException | None] = [None] * n

    def runner(r: int) -> None:
        ctx = None
        try:
            ctx = Context(boots[r])
            set_engine(ctx.engine)
            results[r] = fn(ctx)
        except BaseException as exc:  # noqa: BLE001 — surfaced to caller
            errors[r] = exc
            boots[r].abort(1, f"rank {r}: {exc!r}")
        finally:
            if ctx is not None:
                try:
                    ctx.finalize()
                except Exception:
                    pass
            set_engine(None)

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError("run_ranks: rank thread did not finish")
    for r, exc in enumerate(errors):
        if exc is not None:
            raise exc
    return results
