"""The port's DeviceComm core and named-axis primitives against the JAX
package's, on the CPU.

The same numpy inputs go to the JAX ``DeviceComm`` on the virtual CPU mesh
of n devices and to the port's ``DeviceComm`` in a gloo world of n
processes, R = 8 rank rows in both: n = 1 (all rows in one process, the
single-card regime), 2 and 4 (r = R/n rows each, the local-fold paths).
The rank-per-process regime (n = 8) runs in
``test_torch_device_coll_plane.py``.  Collectives that only move data are
compared bitwise; f32 reductions to ``rtol=1e-6``; bf16 to ``rtol=1e-2``,
as ``tests/test_device_coll.py`` holds them.

Cases of ``tests/test_device_coll.py`` left out here, and why:
  * ``test_executable_cache_reuse`` tests the JAX package's compiled-program
    cache; the port compiles nothing (its index-map cache is tested with
    the ragged collectives);
  * ``test_xla_module_native_v_dispatch``, ``test_comm_integration_device_
    dispatch``, ``test_staged_fallback_entries_account_and_work``,
    ``test_intercomm_device_collectives_two_meshes`` and the
    ``TestDeviceDecision`` class go through ``coll/xla``'s decision layer,
    the communicator and ``DEVICE_RULES``/``coll_tune``: ROADMAP P4, P7 and
    P18;
  * ``Test32RanksOn8Devices`` holds R = 32: the port's row layout is the
    same code at any R, held here at R = 8 in four regimes.
Where the JAX ``DeviceComm`` cannot run a case (its ``Op.fn`` are numpy
functions, which fail under tracing: the logical and bitwise ops with more
than one row a device, a user op, and ``scan`` with max or min), the port is held
to the MPI result computed in numpy.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu import op as jops  # noqa: E402
from ompi_tpu.parallel import DeviceComm, make_mesh  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

N = 8

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}proc")
def world(request):
    """(gloo pool of n processes, JAX DeviceComm on n devices)."""
    n = request.param
    pool = W.Pool(n)
    jdc = DeviceComm(make_mesh({"x": n}, devices=jax.devices()[:n]), "x")
    yield pool, jdc
    pool.close()


def port(pool, method, x, *args, **kw):
    """The global result: every process's rows, in rank order."""
    return np.concatenate(pool.run("call", method, np.asarray(x), *args,
                                   **kw))


def ref(jdc, method, x, *args, **kw):
    out = getattr(jdc, method)(jdc.from_ranks(list(x)), *args, **kw)
    return np.asarray(jax.device_get(out))


def test_allreduce_sum(world):
    pool, jdc = world
    x = np.stack([np.full(16, float(i + 1), np.float32) for i in range(N)])
    got = port(pool, "allreduce", x)
    np.testing.assert_allclose(got, ref(jdc, "allreduce", x), rtol=1e-6)
    np.testing.assert_allclose(got, np.full((N, 16), 36.0), rtol=1e-6)


@pytest.mark.parametrize("name", ["max", "min", "prod"])
def test_allreduce_ops(world, name):
    pool, jdc = world
    x = np.stack([np.linspace(i, i + 1, 8).astype(np.float32)
                  for i in range(N)])
    got = port(pool, "allreduce", x, op=name)
    want = ref(jdc, "allreduce", x, getattr(jops, name.upper()))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    npfn = {"max": np.maximum, "min": np.minimum, "prod": np.multiply}[name]
    np.testing.assert_allclose(got[3], functools.reduce(npfn, x), rtol=1e-6)


@pytest.mark.parametrize("name", ["band", "bor", "bxor", "land", "lor",
                                  "lxor"])
def test_allreduce_logical_bitwise(world, name):
    """The ops NCCL lacks: all-gather and fold, as the reference's
    preduce; against numpy (see the module docstring)."""
    pool, _ = world
    x = (np.arange(N * 4, dtype=np.int32).reshape(N, 4) * 7) % 5
    got = port(pool, "allreduce", x, op=name)
    if name in ("band", "bor"):
        f = np.bitwise_and if name == "band" else np.bitwise_or
        want = functools.reduce(f, x)
    elif name in ("bxor", "lxor"):
        # the reference folds both xors bitwise (collectives.py:113-117)
        want = functools.reduce(np.bitwise_xor, x)
    elif name == "land":
        want = np.all(x.astype(bool), axis=0).astype(x.dtype)
    else:
        want = np.any(x.astype(bool), axis=0).astype(x.dtype)
    np.testing.assert_array_equal(got, np.broadcast_to(want, x.shape))


def test_allreduce_user_op(world):
    """A user op (a + b + 1) folds all R rows: their sum + R - 1."""
    pool, _ = world
    x = np.stack([np.full(3, float(i), np.float32) for i in range(N)])
    got = np.concatenate(pool.run("call_user_op", "allreduce", x))
    want = x.sum(axis=0) + (N - 1)
    np.testing.assert_allclose(got, np.broadcast_to(want, x.shape),
                               rtol=1e-6)


def test_reduce_is_allreduce(world):
    pool, jdc = world
    x = np.stack([np.full(5, float(i), np.float32) for i in range(N)])
    np.testing.assert_allclose(port(pool, "reduce", x, root=3),
                               ref(jdc, "reduce", x, root=3), rtol=1e-6)


def test_bcast(world):
    pool, jdc = world
    x = np.stack([np.full(4, float(i), np.float32) for i in range(N)])
    got = port(pool, "bcast", x, root=5)
    np.testing.assert_array_equal(got, ref(jdc, "bcast", x, root=5))
    np.testing.assert_array_equal(got, np.full((N, 4), 5.0))


def test_allgather(world):
    pool, jdc = world
    x = np.stack([np.array([i, 10 * i], np.int32) for i in range(N)])
    got = port(pool, "allgather", x)
    np.testing.assert_array_equal(got, ref(jdc, "allgather", x))
    np.testing.assert_array_equal(got[5], x.reshape(-1))


def test_allgather_dedup(world):
    """One gathered copy per process: dim 0 of the global result is the
    position on the axis; dedup_to_ranks gives every rank its view."""
    pool, jdc = world
    x = np.stack([np.array([i, 10 * i], np.int32) for i in range(N)])
    got = port(pool, "allgather_dedup", x)
    want = ref(jdc, "allgather_dedup", x)
    assert got.shape == want.shape == (pool.world, 2 * N)
    np.testing.assert_array_equal(got, want)
    for views in pool.run("host_views", "dedup_to_ranks", x, N):
        assert len(views) == N
        for v in views:
            np.testing.assert_array_equal(v, x.reshape(-1))


def test_to_ranks_roundtrip(world):
    """from_ranks keeps this process's rows; to_ranks gives every process
    all R rows back."""
    pool, _ = world
    x = np.random.default_rng(1).normal(size=(N, 3, 2)).astype(np.float32)
    for rows in pool.run("host_views", "to_ranks", x):
        np.testing.assert_array_equal(np.stack(rows), x)


@pytest.mark.parametrize("name", ["sum", "max"])
def test_reduce_scatter(world, name):
    pool, jdc = world
    x = np.stack([np.arange(N * 3, dtype=np.float32) * (i + 1) * (-1) ** i
                  for i in range(N)])
    got = port(pool, "reduce_scatter", x, op=name)
    np.testing.assert_allclose(
        got, ref(jdc, "reduce_scatter", x, getattr(jops, name.upper())),
        rtol=1e-6)
    total = x.sum(axis=0) if name == "sum" else x.max(axis=0)
    np.testing.assert_allclose(got.reshape(-1), total, rtol=1e-6)


def test_reduce_scatter_user_op(world):
    pool, _ = world
    x = np.stack([np.arange(N * 2, dtype=np.float32) + i for i in range(N)])
    got = np.concatenate(pool.run("call_user_op", "reduce_scatter", x))
    np.testing.assert_allclose(got.reshape(-1), x.sum(axis=0) + (N - 1),
                               rtol=1e-6)


def test_alltoall(world):
    pool, jdc = world
    x = np.stack([np.stack([np.full(2, 100 * i + j, np.int32)
                            for j in range(N)]) for i in range(N)])
    got = port(pool, "alltoall", x)
    np.testing.assert_array_equal(got, ref(jdc, "alltoall", x))
    np.testing.assert_array_equal(got, np.swapaxes(x, 0, 1))


@pytest.mark.parametrize("shift,steps", [(1, 1), (3, 1), (-2, 1), (4, 2)])
def test_ring_shift(world, shift, steps):
    pool, jdc = world
    x = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    got = port(pool, "ring_shift", x, shift=shift, steps=steps)
    np.testing.assert_array_equal(
        got, ref(jdc, "ring_shift", x, shift=shift, steps=steps))
    np.testing.assert_array_equal(got, np.roll(x, shift, axis=0))


@pytest.mark.parametrize("src,dst", [(6, 1), (2, 3), (4, 4)])
def test_push_row(world, src, dst):
    pool, jdc = world
    x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    got = port(pool, "push_row", x, src, dst)
    np.testing.assert_array_equal(got, ref(jdc, "push_row", x, src, dst))
    want = x.copy()
    want[dst] = x[src]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sum", "prod"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan(world, name, exclusive):
    pool, jdc = world
    x = np.stack([np.array([float(i + 1), 2.0 - i], np.float32)
                  for i in range(N)])
    got = port(pool, "scan", x, op=name, exclusive=exclusive)
    np.testing.assert_allclose(
        got, ref(jdc, "scan", x, getattr(jops, name.upper()), exclusive),
        rtol=1e-6)
    if name == "sum":
        inc = np.cumsum(x, axis=0)
        want = np.concatenate([np.zeros_like(x[:1]), inc[:-1]]) \
            if exclusive else inc
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", ["max", "min"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_max_min(world, name, exclusive):
    """max and min, against numpy: the reference traces np.maximum and
    np.minimum in its scan and fails."""
    pool, _ = world
    x = np.stack([np.array([float((5 * i) % 7), -float(i)], np.float32)
                  for i in range(N)])
    got = port(pool, "scan", x, op=name, exclusive=exclusive)
    ufunc = np.maximum if name == "max" else np.minimum
    inc = ufunc.accumulate(x, axis=0)
    first = np.full_like(x[:1], -np.inf if name == "max" else np.inf)
    want = np.concatenate([first, inc[:-1]]) if exclusive else inc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_user_op(world, exclusive):
    """A user op (a + b + 1) takes the gather-and-scan path."""
    pool, _ = world
    x = np.stack([np.array([float(i), 1.0 - i], np.float32)
                  for i in range(N)])
    got = np.concatenate(pool.run("call_user_op", "scan", x,
                                  exclusive=exclusive))
    inc = np.cumsum(x, axis=0) + np.arange(N, dtype=np.float32)[:, None]
    # a user op has no identity: exclusive row 0 is zeros, as in the
    # reference
    want = np.concatenate([np.zeros_like(x[:1]), inc[:-1]]) \
        if exclusive else inc
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_barrier(world):
    pool, _ = world
    assert pool.run("barrier") == list(range(pool.world))


def test_bfloat16_allreduce(world):
    """bfloat16 reduces natively (NCCL/gloo), to the reference's 1e-2."""
    pool, jdc = world
    x = np.stack([np.ones(128, np.float32) * (i + 1) for i in range(N)])
    got = port(pool, "allreduce", x, dtype="bfloat16")
    want = ref(jdc, "allreduce", x.astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    np.testing.assert_allclose(got[0], np.full(128, 36.0), rtol=1e-2)


def test_bfloat16_reduce_scatter_and_alltoall(world):
    pool, jdc = world
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, N * 4)).astype(np.float32)
    got = port(pool, "reduce_scatter", x, dtype="bfloat16")
    want = ref(jdc, "reduce_scatter", x.astype(jnp.bfloat16))
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-2,
                               atol=1e-2)
    y = x.reshape(N, N, 4)
    got = port(pool, "alltoall", y, dtype="bfloat16")
    want = ref(jdc, "alltoall", y.astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_canonicalize(world):
    """Each process's shard on ``dim`` becomes its (1, *local) row; the
    global result is the reference's (n, *local)."""
    pool, jdc = world
    n = pool.world
    full = np.arange(3 * 4 * n, dtype=np.float32).reshape(3, 4 * n)
    want = np.asarray(jax.device_get(jdc.canonicalize(
        jax.device_put(full, jax.sharding.NamedSharding(
            jdc.mesh, jax.sharding.PartitionSpec(None, "x"))), 1)))
    got = np.concatenate(pool.run("canonical", full, 1))
    assert got.shape == want.shape == (n, 3, 4)
    np.testing.assert_array_equal(got, want)


# -- named-axis primitives, one tensor a process --------------------------


def prim(pool, name, x, *args, **kw):
    return np.stack(pool.run("primitive", name, np.asarray(x), *args, **kw))


def test_primitive_reductions(world):
    pool, _ = world
    n = pool.world
    x = np.stack([np.array([i + 1, -i, 3], np.float32) for i in range(n)])
    np.testing.assert_allclose(prim(pool, "psum", x),
                               np.broadcast_to(x.sum(0), x.shape))
    np.testing.assert_array_equal(prim(pool, "pmax", x),
                                  np.broadcast_to(x.max(0), x.shape))
    np.testing.assert_array_equal(prim(pool, "pmin", x),
                                  np.broadcast_to(x.min(0), x.shape))
    xi = np.stack([np.array([6, 3, 5 + i], np.int32) for i in range(n)])
    np.testing.assert_array_equal(
        prim(pool, "preduce", xi, op="band"),
        np.broadcast_to(functools.reduce(np.bitwise_and, xi), xi.shape))


def test_primitive_gather_scatter_bcast(world):
    pool, _ = world
    n = pool.world
    x = np.arange(n * n * 2, dtype=np.float32).reshape(n, n * 2)
    np.testing.assert_array_equal(prim(pool, "all_gather_axis", x),
                                  np.broadcast_to(x.reshape(-1),
                                                  (n, n * n * 2)))
    np.testing.assert_array_equal(
        prim(pool, "all_gather_axis", x, tiled=False),
        np.broadcast_to(x, (n,) + x.shape))
    np.testing.assert_array_equal(prim(pool, "reduce_scatter_axis", x),
                                  x.sum(0).reshape(n, 2))
    np.testing.assert_array_equal(prim(pool, "pbcast", x, root=n - 1),
                                  np.broadcast_to(x[-1], x.shape))


def test_primitive_all_to_all_padded(world):
    """A split dim n does not divide is zero-padded to the next multiple."""
    pool, _ = world
    n = pool.world
    L = 2 * n + 1
    x = np.stack([np.arange(L * 2, dtype=np.float32).reshape(L, 2) + 100 * p
                  for p in range(n)])
    got = prim(pool, "all_to_all_axis", x, split_dim=0, concat_dim=1)
    c = -(-L // n)
    pad = np.concatenate([x, np.zeros((n, c * n - L, 2), np.float32)], 1)
    for p in range(n):
        want = np.concatenate([pad[k, p * c:(p + 1) * c] for k in range(n)],
                              axis=1)
        np.testing.assert_array_equal(got[p], want)


def test_primitive_ppermute_and_ring(world):
    pool, _ = world
    n = pool.world
    x = np.stack([np.full(3, float(p), np.float32) for p in range(n)])
    # a partial permutation: members no pair sends to get zeros
    perm = [(0, n - 1)]
    got = prim(pool, "ppermute", x, perm)
    want = np.zeros_like(x)
    want[n - 1] = x[0]
    np.testing.assert_array_equal(got, want)
    got = prim(pool, "ring_shift", x, n, shift=1)
    np.testing.assert_array_equal(got, np.roll(x, 1, axis=0))
    if n % 2 == 0:
        got = prim(pool, "ring_shift", x, n, shift=2, steps=2)
        np.testing.assert_array_equal(got, np.roll(x, 2, axis=0))
