"""The port's launcher, ``python -m ompi_tpu_torch.tools.tpurun``: one
process per rank over the tcp transport, the environment contract of the
JAX package's ``tpurun`` (``OMPI_TPU_RANK``/``SIZE``/``COORD``/...,
``--mca`` forwarding), and a failed rank failing the job.  The programs are
the JAX package's examples with ``ompi_tpu`` → ``ompi_tpu_torch``."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RING = """
    import sys
    import time

    import numpy as np

    from ompi_tpu_torch import runtime

    ctx = runtime.init()
    me, n = ctx.rank, ctx.size
    nxt, prv = (me + 1) % n, (me - 1) % n
    buf = np.zeros(1, np.int32)
    t0 = time.perf_counter()
    if me == 0:
        buf[0] = 10
        ctx.p2p.send(buf, dst=nxt, tag=201)
    while True:
        ctx.p2p.recv(buf, src=prv, tag=201)
        if me == 0:
            buf[0] -= 1
        ctx.p2p.send(buf, dst=nxt, tag=201)
        if buf[0] == 0:
            break
    if me == 0:
        ctx.p2p.recv(buf, src=prv, tag=201)
        dt = time.perf_counter() - t0
        print(f"rank 0 done: 10 laps x {n} hops in {dt*1e3:.2f} ms "
              f"({dt*1e6/(10*n):.1f} us/hop)", flush=True)
    runtime.finalize()
"""


def _tpurun(tmp_path, body, np_, extra=(), env_extra=None, timeout=120):
    prog = tmp_path / "prog.py"
    prog.write_text(textwrap.dedent(body))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np",
         str(np_), "--timeout", str(timeout - 20), *extra, str(prog)],
        env=env, capture_output=True, text=True, timeout=timeout,
        cwd=str(tmp_path))


def test_ring_np4(tmp_path):
    r = _tpurun(tmp_path, RING, 4)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "done: 10 laps" in r.stdout


def test_hello_settings_reach_ranks_and_cpu_plane_is_inert(tmp_path):
    """``--mca`` and an ``OMPI_TPU_*`` variable reach every rank's variable
    registry; ``--device-plane cpu`` without ``init_device_plane(ctx)``
    joins nothing, and host buffers keep the host algorithms."""
    body = """
        import numpy as np
        import torch
        import torch.distributed as dist

        from ompi_tpu_torch import accelerator, runtime
        from ompi_tpu_torch.core import var

        ctx = runtime.init()
        comm = ctx.comm_world
        got = comm.coll.allreduce(comm, np.full(4, ctx.rank + 1.0))
        assert np.all(got == 3.0), got
        assert comm.coll.provider("allreduce") == "tuned"
        assert not dist.is_initialized()
        assert accelerator.check_addr(torch.zeros(2)) is None
        print(f"Hello, world, I am {ctx.rank} of {ctx.size}: "
              f"alg={var.get('coll_tuned_allreduce_algorithm')} "
              f"mode={var.get('coll_nccl_mode')}", flush=True)
        runtime.finalize()
    """
    r = _tpurun(tmp_path, body, 2,
                extra=("--device-plane", "cpu", "--mca",
                       "coll_tuned_allreduce_algorithm", "ring"),
                env_extra={"OMPI_TPU_coll_nccl_mode": "staged"})
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    for rank in range(2):
        assert (f"Hello, world, I am {rank} of 2: alg=ring mode=staged"
                in r.stdout), r.stdout


def test_failed_rank_fails_job(tmp_path):
    body = """
        import sys

        from ompi_tpu_torch import runtime

        ctx = runtime.init()
        if ctx.rank == 1:
            sys.exit(1)
        ctx.comm_world.barrier()
    """
    r = _tpurun(tmp_path, body, 2)
    assert r.returncode != 0, (r.stdout[-2000:], r.stderr[-2000:])


def test_card_binding_and_the_device_plane_agree(monkeypatch):
    """--gpus-per-rank binds a rank's cards through CUDA_VISIBLE_DEVICES;
    the device plane then takes the first visible card, whatever the
    rank's local index."""
    from ompi_tpu_torch.control.launch import build_env
    from ompi_tpu_torch.parallel import device_plane

    env = build_env({"CUDA_VISIBLE_DEVICES": "0,1,2,3,4,5,6,7"}, rank=6,
                    size=8, coord="127.0.0.1:1", job="j", mca=[],
                    gpus_per_rank=2, local_rank=2, num_local=4)
    assert env["CUDA_VISIBLE_DEVICES"] == "4,5"
    assert env["OMPI_TPU_BOUND_CARDS"] == "4,5"
    assert env["OMPI_TPU_LOCAL_RANK"] == "2"
    assert "OMPI_TPU_DEVICE_PLANE" not in env
    monkeypatch.setenv("OMPI_TPU_BOUND_CARDS", "4,5")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert device_plane._local_rank(6) == 0
    cpu = build_env({}, rank=0, size=2, coord="127.0.0.1:1", job="j",
                    mca=["coll_nccl_mode=staged"], device_plane="cpu")
    assert cpu["OMPI_TPU_DEVICE_PLANE"] == "cpu"
    assert cpu["OMPI_TPU_coll_nccl_mode"] == "staged"
    assert "CUDA_VISIBLE_DEVICES" not in cpu


def test_card_binding_takes_the_inherited_cards(monkeypatch):
    """A launcher given cards 4-7 hands out those cards, never card 0, and
    refuses a job that needs more than it was given; with nothing
    inherited it hands out every card the runtime sees."""
    import torch

    from ompi_tpu_torch.control.launch import build_env

    bind = lambda base, local_rank: build_env(
        base, rank=local_rank, size=2, coord="127.0.0.1:1", job="j",
        mca=[], gpus_per_rank=2, local_rank=local_rank, num_local=2)
    given = {"CUDA_VISIBLE_DEVICES": "4,5,6,7"}
    assert bind(given, 0)["CUDA_VISIBLE_DEVICES"] == "4,5"
    assert bind(given, 1)["CUDA_VISIBLE_DEVICES"] == "6,7"
    assert bind(given, 1)["OMPI_TPU_BOUND_CARDS"] == "6,7"
    with pytest.raises(ValueError, match="needs cards"):
        bind(given, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert bind({}, 1)["CUDA_VISIBLE_DEVICES"] == "2,3"
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "3",
         "--gpus-per-rank", "1", "prog.py"],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="4,5",
                 PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")),
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "given 2" in r.stderr, r.stderr


def test_cpu_plane_and_card_binding_conflict():
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "1",
         "--device-plane", "cpu", "--gpus-per-rank", "1", "prog.py"],
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")),
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "conflict" in r.stderr, r.stderr
