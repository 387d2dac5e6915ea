"""The port's device plane: its operators, ``init_device_plane``, the mesh,
what refuses to run, and the rank-per-process regime.

  * ``ompi_tpu_torch.op`` against ``ompi_tpu.op``: every operator's fold on
    the same numpy inputs.
  * ``init_device_plane(device=None)`` without CUDA raises and joins no
    world; a ``DeviceComm`` on a cuda mesh without CUDA raises; a tensor
    on a group of the wrong backend raises.
  * ``make_mesh``'s ``-1`` axis and its size check, ``classify_axes`` on a
    one-host world (and its simulated-DCN override), and a second
    ``init_device_plane`` joining nothing, in a gloo world of 8 processes.
  * One rank a process (n = R = 8), the r = 1 paths: ``allreduce``,
    ``alltoall``, ``ring_shift``, ``scan``, ``alltoallv`` (blocks and dense
    rows), ``push_row`` and the cartesian exchanges on the reference's 2x4
    torus and ring of 8, against the JAX ``DeviceComm`` on 8 devices
    (bitwise, f32 sums to ``rtol=1e-6``).
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ompi_tpu import op as jops  # noqa: E402
from ompi_tpu import topo as jtopo  # noqa: E402
from ompi_tpu.parallel import DeviceComm, make_mesh  # noqa: E402

from ompi_tpu_torch import op as tops  # noqa: E402
from ompi_tpu_torch.parallel import collectives as coll  # noqa: E402
from ompi_tpu_torch.parallel import device_plane  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

N = 8

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


# -- operators ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["SUM", "PROD", "MAX", "MIN", "LAND", "LOR",
                                  "LXOR", "BAND", "BOR", "BXOR", "REPLACE",
                                  "NO_OP"])
def test_op_folds_like_the_reference(name):
    rng = np.random.default_rng(0)
    a = rng.integers(-5, 6, size=(4, 3)).astype(np.int32)
    b = rng.integers(-5, 6, size=(4, 3)).astype(np.int32)
    want = getattr(jops, name)(a, b)
    got = getattr(tops, name)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    if name in ("SUM", "PROD", "MAX", "MIN"):
        af, bf = a.astype(np.float32) / 3, b.astype(np.float32) / 7
        np.testing.assert_array_equal(
            getattr(tops, name)(torch.from_numpy(af),
                                torch.from_numpy(bf)).numpy(),
            getattr(jops, name)(af, bf))


def test_op_native_reductions():
    """NCCL's four reductions carry their ReduceOp; the rest fold."""
    import torch.distributed as dist
    native = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
              "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    for name in ("SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND",
                 "BOR", "BXOR", "REPLACE", "NO_OP", "MAXLOC", "MINLOC",
                 "AVG"):
        o = getattr(tops, name)
        assert o.name == getattr(jops, name).name
        assert o.dist_op == native.get(o.name)


@pytest.mark.parametrize("name", ["MAXLOC", "MINLOC"])
def test_loc_ops(name):
    v1 = np.array([3.0, 1.0, 2.0, 2.0])
    i1 = np.array([0, 0, 5, 1])
    v2 = np.array([1.0, 4.0, 2.0, 2.0])
    i2 = np.array([1, 1, 3, 4])
    dt = jops.loc_dtype(np.float64)
    a, b = np.zeros(4, dt), np.zeros(4, dt)
    a["v"], a["i"], b["v"], b["i"] = v1, i1, v2, i2
    want = getattr(jops, name)(a, b)
    gv, gi = getattr(tops, name)(
        (torch.from_numpy(v1), torch.from_numpy(i1)),
        (torch.from_numpy(v2), torch.from_numpy(i2)))
    np.testing.assert_array_equal(gv.numpy(), want["v"])
    np.testing.assert_array_equal(gi.numpy(), want["i"])


def test_user_op_avg_and_reduce_local():
    op = tops.Op.create(lambda a, b: a - b, commutative=False)
    assert (op.name, op.commutative, op.dist_op) == ("user", False, None)
    with pytest.raises(NotImplementedError):
        tops.AVG(torch.ones(2), torch.ones(2))
    inout = torch.tensor([1.0, 5.0])
    tops.reduce_local(tops.MAX, torch.tensor([3.0, 2.0]), inout)
    np.testing.assert_array_equal(inout.numpy(), [3.0, 5.0])


# -- what refuses to run ------------------------------------------------------


def test_init_device_plane_without_cuda_raises():
    import torch.distributed as dist
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_plane.init_device_plane(rank=0, world_size=1,
                                       store=dist.HashStore())
    assert not device_plane.device_plane_active()
    with pytest.raises(ValueError, match="unsupported device"):
        device_plane.init_device_plane(rank=0, world_size=1,
                                       store=dist.HashStore(), device="mps")
    assert not dist.is_initialized()


def test_cudaless_device_comm_refuses():
    """A comm on a cuda mesh with no CUDA device raises at once, before it
    touches a group, whether it spans one axis or a tuple of them (a
    tuple-axis comm runs: ``tests/test_torch_hier.py``); a tuple out of
    the mesh's axis order, or naming an axis the mesh lacks, is refused
    before any group too."""
    mesh = types.SimpleNamespace(device_type="cuda",
                                 mesh_dim_names=("x", "y"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coll.DeviceComm(mesh, "x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coll.DeviceComm(mesh, ("x", "y"))
    cpu = types.SimpleNamespace(device_type="cpu", mesh_dim_names=("x", "y"))
    with pytest.raises(ValueError, match="axis order"):
        coll.DeviceComm(cpu, ("y", "x"))
    with pytest.raises(ValueError, match="distinct axes"):
        coll.DeviceComm(cpu, ("x", "z"))


@pytest.mark.parametrize("device_type,backend,ok", [
    ("cuda", "nccl", True), ("cpu", "gloo", True),
    ("cuda", "gloo", False), ("cpu", "nccl", False)])
def test_backend_pairing(device_type, backend, ok):
    """A CUDA tensor on a non-NCCL group raises (no quiet host staging)."""
    if ok:
        coll._check_backend(device_type, backend)
    else:
        with pytest.raises(RuntimeError):
            coll._check_backend(device_type, backend)


# -- an 8-process gloo world -------------------------------------------------


@pytest.fixture(scope="module")
def eight():
    pool = W.Pool(N)
    jdc = DeviceComm(make_mesh({"x": N}), "x")
    yield pool, jdc
    pool.close()


def test_make_mesh(eight):
    pool, _ = eight
    for axes, want in (({"dp": 2, "tp": -1}, ("ok", {"dp": 2, "tp": 4})),
                       ({"a": -1, "b": 2, "c": 2},
                        ("ok", {"a": 2, "b": 2, "c": 2}))):
        assert pool.run("mesh_errors", axes) == [want] * N
    for axes in ({"x": 3}, {"a": 3, "b": -1}):
        for kind, msg in pool.run("mesh_errors", axes):
            assert kind == "ValueError" and "needs" in msg and "have 8" in msg


def test_classify_axes_one_host(eight):
    """Every rank is its own process on one host: every axis is 'ici'
    (the reference's process test would say 'dcn'), unless simulated."""
    pool, _ = eight
    axes = {"dp": 2, "tp": 4}
    assert pool.run("classify", axes) == [{"dp": "ici", "tp": "ici"}] * N
    assert pool.run("classify", axes, "dp") == \
        [{"dp": "dcn", "tp": "ici"}] * N


def test_second_init_joins_nothing(eight):
    pool, _ = eight
    assert pool.run("plane") == [("cpu", True, N)] * N


def port(pool, method, x, *args, **kw):
    res = pool.run("call", method, np.asarray(x), *args, **kw)
    if isinstance(res[0], tuple):
        return np.concatenate([r[0] for r in res]), res[0][1]
    return np.concatenate(res)


def ref(jdc, method, x, *args, **kw):
    out = getattr(jdc, method)(jdc.from_ranks(list(x)), *args, **kw)
    if isinstance(out, tuple):
        return np.asarray(jax.device_get(out[0])), out[1]
    return np.asarray(jax.device_get(out))


@pytest.mark.parametrize("name", ["sum", "max", "band"])
def test_r1_allreduce(eight, name):
    pool, jdc = eight
    x = (np.arange(N * 6, dtype=np.int32).reshape(N, 6) * 5) % 11
    if name != "band":
        x = x.astype(np.float32) - 3.5
    got = port(pool, "allreduce", x, op=name)
    np.testing.assert_allclose(
        got, ref(jdc, "allreduce", x, getattr(jops, name.upper())),
        rtol=1e-6)


def test_r1_alltoall(eight):
    pool, jdc = eight
    x = np.arange(N * N * 3, dtype=np.float32).reshape(N, N, 3)
    got = port(pool, "alltoall", x)
    np.testing.assert_array_equal(got, ref(jdc, "alltoall", x))
    np.testing.assert_array_equal(got, np.swapaxes(x, 0, 1))


@pytest.mark.parametrize("shift,steps", [(1, 1), (-3, 1), (6, 3)])
def test_r1_ring_shift(eight, shift, steps):
    pool, jdc = eight
    x = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    got = port(pool, "ring_shift", x, shift=shift, steps=steps)
    np.testing.assert_array_equal(
        got, ref(jdc, "ring_shift", x, shift=shift, steps=steps))


@pytest.mark.parametrize("exclusive", [False, True])
def test_r1_scan(eight, exclusive):
    pool, jdc = eight
    x = np.stack([np.array([i + 1.0, 0.5 * i], np.float32) for i in range(N)])
    got = port(pool, "scan", x, exclusive=exclusive)
    np.testing.assert_allclose(got, ref(jdc, "scan", x, jops.SUM, exclusive),
                               rtol=1e-6)


def test_r1_push_row(eight):
    pool, jdc = eight
    x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    got = port(pool, "push_row", x, 7, 2)
    np.testing.assert_array_equal(got, ref(jdc, "push_row", x, 7, 2))


def test_r1_alltoallv(eight):
    pool, jdc = eight
    rng = np.random.default_rng(7)
    C = rng.integers(0, 4, size=(N, N))
    cap = int(C.max())
    x = rng.normal(size=(N, N, cap)).astype(np.float32)
    got, recv = port(pool, "alltoallv", x, C)
    want, jrecv = ref(jdc, "alltoallv", x, C)
    assert recv == jrecv
    np.testing.assert_array_equal(got, want)
    rows = rng.normal(size=(N, int(C.sum(1).max()))).astype(np.float32)
    got, _ = port(pool, "alltoallv_from_rows", rows, C, slice_cap=2)
    want, _ = ref(jdc, "alltoallv_from_rows", rows, C, slice_cap=2)
    np.testing.assert_array_equal(got, want)


def test_r1_neighbor_allgather_2d_torus(eight):
    pool, jdc = eight
    jt = jtopo.CartTopo([2, 4], [True, True])
    x = np.stack([np.full(3, float(i), np.float32) for i in range(N)])
    got = port(pool, "neighbor_allgather_cart", x,
               topo=("cart", [2, 4], [True, True]))
    np.testing.assert_array_equal(
        got, ref(jdc, "neighbor_allgather_cart", x, jt))
    for i in range(N):
        for j, nb in enumerate(jt.neighbors(i)):
            np.testing.assert_array_equal(got[i, j], x[nb])


def test_r1_neighbor_alltoall_1d_ring(eight):
    pool, jdc = eight
    jt = jtopo.CartTopo([N], [True])
    x = np.stack([np.stack([np.full(2, 100.0 * i, np.float32),
                            np.full(2, 100.0 * i + 1, np.float32)])
                  for i in range(N)])
    got = port(pool, "neighbor_alltoall_cart", x, topo=("cart", [N], [True]))
    np.testing.assert_array_equal(
        got, ref(jdc, "neighbor_alltoall_cart", x, jt))
    for i in range(N):
        np.testing.assert_array_equal(got[i, 0], x[(i - 1) % N, 1])
        np.testing.assert_array_equal(got[i, 1], x[(i + 1) % N, 0])
