"""The port's ragged, rooted and neighbourhood collectives against the JAX
package's ``DeviceComm``, on the CPU.

As in ``test_torch_device_coll.py``: the same numpy inputs go to the JAX
``DeviceComm`` on n virtual CPU devices and to the port's in a gloo world
of n processes (n = 1, 2, 4), R = 8 rank rows; data-moving collectives are
compared bitwise and f32 reductions to ``rtol=1e-6``.  The neighbourhood
collectives need one row a process, so they run at n = R = 4 (the
topologies of the reference's 4-device cases); the 8-rank torus and ring
run in ``test_torch_device_coll_plane.py``.

Cases of ``tests/test_device_coll.py`` that change meaning or are left out:
  * ``test_allgatherv_cache_shared_across_counts`` and
    ``test_alltoallv_cache_shared_across_routing`` check that one compiled
    program serves many counts patterns; the port compiles nothing, and
    what it caches is the index maps of each pattern (an LRU of 64, as the
    reference's): here a repeated pattern hits and the cache stays bounded;
  * ``test_halo_exchange_via_coll_dispatch``,
    ``test_nonperiodic_cart_takes_graph_path``,
    ``test_graph_topology_device_exchange``, ``test_graph_neighbor_
    alltoall``, ``test_open_cart_neighbor_alltoall_via_graph_path`` and
    ``test_graph_neighbor_allgatherv_ragged_rows`` reach these methods
    through ``coll/xla``'s neighbourhood dispatch (ROADMAP P4/P7); the same
    topologies and inputs call the ``DeviceComm`` methods directly here;
  * ``test_unservable_canonical_raises_not_hangs`` tests that dispatch's
    guard for a dist-graph topology (P4/P7); the port's own guard, in- and
    out-lists that disagree, is tested instead;
  * ``TestCommLevelDenseRowsAlltoallv`` is the communicator-level route into
    ``alltoallv_from_rows`` (P7); the method itself is held here.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ompi_tpu import op as jops  # noqa: E402
from ompi_tpu import topo as jtopo  # noqa: E402
from ompi_tpu.parallel import DeviceComm, make_mesh  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

N = 8

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}proc")
def world(request):
    n = request.param
    pool = W.Pool(n)
    jdc = DeviceComm(make_mesh({"x": n}, devices=jax.devices()[:n]), "x")
    yield pool, jdc
    pool.close()


def port(pool, method, x, *args, **kw):
    return np.concatenate(pool.run("call", method, np.asarray(x), *args,
                                   **kw))


def port_pair(pool, method, x, *args, **kw):
    """(global first result, the second) of a method returning a pair."""
    res = pool.run("call", method, np.asarray(x), *args, **kw)
    assert all(r[1] == res[0][1] for r in res)
    return np.concatenate([r[0] for r in res]), res[0][1]


def ref(jdc, method, x, *args, **kw):
    out = getattr(jdc, method)(jdc.from_ranks(list(x)), *args, **kw)
    if isinstance(out, tuple):
        return np.asarray(jax.device_get(out[0])), out[1]
    return np.asarray(jax.device_get(out))


def _ragged_rows(seed=0):
    rng = np.random.default_rng(seed)
    counts = [int(c) for c in rng.integers(1, 6, size=N)]
    rows = [np.arange(c, dtype=np.float32) + 100.0 * i
            for i, c in enumerate(counts)]
    return rows, counts


def ragged(pool, method, rows, *args):
    res = pool.run("call_ragged", method, rows, *args)
    counts = res[0][0]
    return (counts, np.concatenate([r[1] for r in res]),
            np.concatenate([r[2] for r in res]))


def test_allgatherv_native(world):
    pool, jdc = world
    rows, counts = _ragged_rows()
    got_counts, padded, got = ragged(pool, "allgatherv", rows)
    jx, jcounts = jdc.pad_ragged(rows)
    assert got_counts == jcounts == counts
    np.testing.assert_array_equal(padded, np.asarray(jax.device_get(jx)))
    want = np.asarray(jax.device_get(jdc.allgatherv(jx, counts)))
    assert got.shape == want.shape == (N, sum(counts))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[4], np.concatenate(rows))


def test_unpad_ragged(world):
    pool, _ = world
    rows, _ = _ragged_rows(seed=2)
    for views in pool.run("host_views", "unpad_ragged", rows):
        for got, want in zip(views, rows):
            np.testing.assert_array_equal(got, want)


def test_gatherv_native(world):
    pool, jdc = world
    rows, counts = _ragged_rows(seed=3)
    _, _, got = ragged(pool, "gatherv", rows, 2)
    jx, _ = jdc.pad_ragged(rows)
    want = np.asarray(jax.device_get(jdc.gatherv(jx, counts, root=2)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], np.concatenate(rows))


def test_gather(world):
    pool, jdc = world
    x = np.stack([np.array([i, -i], np.float32) for i in range(N)])
    np.testing.assert_array_equal(port(pool, "gather", x, root=1),
                                  ref(jdc, "gather", x, root=1))


def test_allgatherv_index_maps_cached(world):
    """A repeated counts pattern reuses its index map; a new one adds one."""
    pool, _ = world
    x = np.ones((N, 4), np.float32)
    c1 = [2, 4, 2, 4, 2, 4, 2, 4]
    c2 = [4, 2, 4, 2, 4, 2, 4, 2]
    for seen in pool.run("cache_entries", "allgatherv", x, [c1, c1, c2, c2]):
        assert seen[0] == seen[1] and seen[2] == seen[3]
        assert seen[2] >= seen[1]


def test_scatter_native(world):
    pool, jdc = world
    root = 3
    x = np.zeros((N, N, 2), np.float32)
    x[root] = np.stack([np.full((2,), 10.0 * j, np.float32)
                        for j in range(N)])
    got = port(pool, "scatter", x, root=root)
    np.testing.assert_array_equal(got, ref(jdc, "scatter", x, root=root))
    np.testing.assert_array_equal(got, x[root])


def test_scatterv_native(world):
    pool, jdc = world
    root = 1
    counts = [1, 2, 3, 4, 1, 2, 3, 4]
    x = np.zeros((N, N, 4), np.float32)
    for j, c in enumerate(counts):
        x[root, j, :c] = np.arange(c) + 10.0 * j
    got = port(pool, "scatterv", x, counts, root=root)
    np.testing.assert_array_equal(
        got, ref(jdc, "scatterv", x, counts, root=root))
    for j, c in enumerate(counts):
        np.testing.assert_array_equal(got[j, :c], np.arange(c) + 10.0 * j)


def _a2av_blocks(seed=7):
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 4, size=(N, N))
    cap = int(C.max())
    x = np.zeros((N, N, cap), np.float32)
    for i in range(N):
        for j in range(N):
            x[i, j, :C[i, j]] = 1000 * i + 10 * j + np.arange(C[i, j])
    return x, C


def test_alltoallv_native(world):
    pool, jdc = world
    x, C = _a2av_blocks()
    got, recv = port_pair(pool, "alltoallv", x, C)
    want, jrecv = ref(jdc, "alltoallv", x, C)
    assert recv == jrecv == [int(t) for t in C.sum(axis=0)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, DeviceComm.compact_ragged_blocks(x, C, got.shape[1]))


def test_alltoallv_elem_dims_and_empty_blocks(world):
    """A trailing feature dim, and a counts matrix with whole zero rows
    and columns (ranks that send or receive nothing)."""
    pool, jdc = world
    rng = np.random.default_rng(12)
    C = rng.integers(0, 3, size=(N, N))
    C[2, :] = 0
    C[:, 5] = 0
    cap = max(1, int(C.max()))
    x = rng.normal(size=(N, N, cap, 3)).astype(np.float32)
    got, recv = port_pair(pool, "alltoallv", x, C)
    want, jrecv = ref(jdc, "alltoallv", x, C)
    assert recv == jrecv
    np.testing.assert_array_equal(got, want)


def test_alltoallv_index_maps_cached_and_bounded(world):
    """The MoE regime: routing changes every step.  A repeated routing
    hits its cached maps; the cache never holds more than 64 patterns."""
    pool, _ = world
    base = np.array([1, 2, 3, 2, 1, 2, 3, 2])
    x = np.ones((N, N, 4), np.float32)
    pats = [np.stack([np.roll(base, i + s) for i in range(N)])
            for s in (0, 1, 0, 1)]
    for seen in pool.run("cache_entries", "alltoallv", x, pats):
        assert seen[2] == seen[1] and seen[3] == seen[1]
    rng = np.random.default_rng(0)
    many = [rng.integers(0, 4, size=(N, N)) for _ in range(70)]
    for seen in pool.run("cache_entries", "alltoallv", x, many):
        assert max(seen) <= 64


def test_reduce_scatter_v_native(world):
    pool, jdc = world
    counts = [1, 2, 3, 2, 1, 2, 3, 2]
    x = np.stack([np.arange(sum(counts), dtype=np.float32) * (i + 1)
                  for i in range(N)])
    got = port(pool, "reduce_scatter_v", x, counts)
    np.testing.assert_allclose(got, ref(jdc, "reduce_scatter_v", x, counts),
                               rtol=1e-6)
    summed = x.sum(axis=0)
    displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for i, (d, c) in enumerate(zip(displs, counts)):
        np.testing.assert_allclose(got[i, :c], summed[d:d + c], rtol=1e-6)
        np.testing.assert_array_equal(got[i, c:], 0.0)


@pytest.mark.parametrize("name", ["max", "band"])
def test_reduce_scatter_v_other_ops(world, name):
    """max (native) against the reference; band (gathered and folded)
    against numpy, the reference being unable to trace its np op."""
    pool, jdc = world
    counts = [2, 2, 2, 2, 2, 2, 2, 2]
    if name == "max":
        x = np.stack([np.arange(16, dtype=np.float32) * (-1) ** i
                      for i in range(N)])
        got = port(pool, "reduce_scatter_v", x, counts, op="max")
        np.testing.assert_array_equal(
            got, ref(jdc, "reduce_scatter_v", x, counts, jops.MAX))
        want = x.max(axis=0)
    else:
        x = np.stack([(np.arange(16, dtype=np.int32) * (i + 3)) % 13
                      for i in range(N)])
        got = port(pool, "reduce_scatter_v", x, counts, op="band")
        want = np.bitwise_and.reduce(x, axis=0)
    np.testing.assert_array_equal(got.reshape(-1), want)


@pytest.mark.parametrize("slice_cap", [None, 2, 3, 64])
def test_alltoallv_from_rows_matches_block_form(world, slice_cap):
    pool, jdc = world
    rng = np.random.default_rng(11)
    per = 5
    vbase = [(per - 2) if j % 2 == 0 else (per + 2) for j in range(N)]
    C = np.stack([np.roll(vbase, -i) for i in range(N)])
    rows = rng.normal(size=(N, int(C.sum(axis=1).max()))).astype(np.float32)
    got, counts = port_pair(pool, "alltoallv_from_rows", rows, C,
                            slice_cap=slice_cap)
    want, jcounts = ref(jdc, "alltoallv_from_rows", rows, C,
                        slice_cap=slice_cap)
    assert counts == jcounts
    np.testing.assert_array_equal(got, want)
    cap = DeviceComm._bucket(int(C.max()))
    blocks, _ = port_pair(pool, "alltoallv",
                          DeviceComm.pack_ragged_blocks(rows, C, cap), C)
    np.testing.assert_array_equal(got, blocks)


def test_alltoallv_from_rows_with_elem_dims(world):
    pool, jdc = world
    rng = np.random.default_rng(3)
    C = rng.integers(0, 4, size=(N, N))
    L = max(1, int(C.sum(axis=1).max()))
    rows = rng.normal(size=(N, L, 4)).astype(np.float32)
    got, _ = port_pair(pool, "alltoallv_from_rows", rows, C, slice_cap=2)
    want, _ = ref(jdc, "alltoallv_from_rows", rows, C, slice_cap=2)
    np.testing.assert_array_equal(got, want)


def test_alltoallv_from_rows_cache_not_stale_across_caps(world):
    """Same shapes and slice_cap, a larger max count: more slices, and no
    reuse of the maps of the first pattern."""
    pool, _ = world
    C1 = np.ones((N, N), np.int64)
    np.fill_diagonal(C1, 2)
    C2 = np.ones((N, N), np.int64)
    np.fill_diagonal(C2, 3)
    L = int(C2.sum(axis=1).max())
    rows = np.random.default_rng(5).normal(size=(N, L)).astype(np.float32)
    port_pair(pool, "alltoallv_from_rows", rows, C1, slice_cap=2)
    got, _ = port_pair(pool, "alltoallv_from_rows", rows, C2, slice_cap=2)
    np.testing.assert_array_equal(
        got, DeviceComm.compact_from_rows(rows, C2, got.shape[1]))


def test_a2av_plan(world):
    """The plan's shape math equals the reference's, with the slice cap
    given, from OMPI_TPU_coll_a2av_slice_cap, and by the heuristic."""
    pool, jdc = world
    C = np.random.default_rng(4).integers(0, 300, size=(N, N))
    shape = (N, int(C.sum(axis=1).max()), 2)
    for cap in (None, 7):
        assert pool.run("a2av_plan", shape, C, cap)[0] == \
            jdc.a2av_plan(shape, C, cap)


def test_a2av_plan_env_var(monkeypatch):
    """The variable keeps the reference's name; garbage raises naming it.
    The plan is shape math: a comm that was never joined to a world
    answers it, in this process."""
    from ompi_tpu_torch.parallel import collectives as coll
    assert coll.SLICE_CAP_ENV == "OMPI_TPU_coll_a2av_slice_cap"
    dc = coll.DeviceComm.__new__(coll.DeviceComm)
    C = np.full((N, N), 100)
    monkeypatch.setenv(coll.SLICE_CAP_ENV, "16")
    plan = dc.a2av_plan((N, 800), C)
    assert plan["slice_cap"] == 16 and plan["scan_steps"] == 8
    monkeypatch.setenv(coll.SLICE_CAP_ENV, "lots")
    with pytest.raises(ValueError, match=coll.SLICE_CAP_ENV):
        dc.a2av_plan((N, 800), C)


def test_row_gather(world):
    pool, jdc = world
    rng = np.random.default_rng(8)
    x = rng.normal(size=(N, 6, 2)).astype(np.float32)
    idx = rng.integers(-1, 6, size=(N, 9)).astype(np.int32)
    got = port(pool, "row_gather", x, idx)
    np.testing.assert_array_equal(got, ref(jdc, "row_gather", x, idx))


# -- neighbourhood collectives: one row a process (n = R = 4) ---------------


@pytest.fixture(scope="module")
def four():
    pool = W.Pool(4)
    jdc = DeviceComm(make_mesh({"x": 4}, devices=jax.devices()[:4]), "x")
    yield pool, jdc
    pool.close()


def _both(kind, a, b):
    j = jtopo.CartTopo(a, b) if kind == "cart" else jtopo.GraphTopo(a, b)
    return j, (kind, a, b)


def test_neighbor_allgather_cart_2x2_torus(four):
    pool, jdc = four
    jt, spec = _both("cart", [2, 2], [True, True])
    x = np.stack([np.arange(2, dtype=np.float32) + 10 * i for i in range(4)])
    got = port(pool, "neighbor_allgather_cart", x, topo=spec)
    np.testing.assert_array_equal(
        got, ref(jdc, "neighbor_allgather_cart", x, jt))
    for i in range(4):
        for j, nb in enumerate(jt.neighbors(i)):
            np.testing.assert_array_equal(got[i, j], x[nb])


def test_neighbor_alltoall_cart_ring(four):
    pool, jdc = four
    jt, spec = _both("cart", [4], [True])
    x = np.stack([np.stack([np.full(2, 100.0 * i, np.float32),
                            np.full(2, 100.0 * i + 1, np.float32)])
                  for i in range(4)])
    got = port(pool, "neighbor_alltoall_cart", x, topo=spec)
    np.testing.assert_array_equal(
        got, ref(jdc, "neighbor_alltoall_cart", x, jt))
    for i in range(4):
        np.testing.assert_array_equal(got[i, 0], x[(i - 1) % 4, 1])
        np.testing.assert_array_equal(got[i, 1], x[(i + 1) % 4, 0])


def test_non_periodic_cart_raises(four):
    pool, _ = four
    x = np.zeros((4, 2), np.float32)
    for kind, msg in pool.run("raises", "neighbor_allgather_cart", x,
                              topo=("cart", [4], [False])):
        assert kind == "ValueError" and "periodic" in msg


def test_cart_needs_rank_per_process(world):
    """R = 8 rows on fewer processes: the reference's layout check."""
    pool, _ = world
    x = np.zeros((N, 2), np.float32)
    for kind, msg in pool.run("raises", "neighbor_allgather_cart", x,
                              topo=("cart", [N], [True])):
        assert kind == "ValueError" and "rank-per-position" in msg


@pytest.mark.parametrize("kind,a,b", [
    ("cart", [4], [False]),                               # open chain
    ("graph", [2, 4, 5, 6], [1, 2, 0, 3, 0, 1]),          # 0-1, 0-2, 1-3
    ("cart", [4], [True])])                               # ring
def test_neighbor_allgather_graph(four, kind, a, b):
    """Ragged degrees: zeros past each rank's degree."""
    pool, jdc = four
    jt, spec = _both(kind, a, b)
    x = np.stack([np.full(3, 10.0 * i, np.float32) for i in range(4)])
    got = port(pool, "neighbor_allgather_graph", x, topo=spec)
    np.testing.assert_array_equal(
        got, ref(jdc, "neighbor_allgather_graph", x, jt))
    for i in range(4):
        nbrs = jt.in_neighbors(i)
        for j, nb in enumerate(nbrs):
            np.testing.assert_array_equal(got[i, j], x[nb])
        np.testing.assert_array_equal(got[i, len(nbrs):], 0.0)


def test_neighbor_allgather_graph_ragged_rows(four):
    """Padded ragged rows travel whole over a ring's neighbourhood."""
    pool, jdc = four
    jt, spec = _both("cart", [4], [True])
    rows = [np.arange(i + 1, dtype=np.float32) + 10 * i for i in range(4)]
    x = np.zeros((4, 4), np.float32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
    got = port(pool, "neighbor_allgather_graph", x, topo=spec)
    for j in range(4):
        for k, src in enumerate(jt.in_neighbors(j)):
            np.testing.assert_array_equal(got[j, k, :len(rows[src])],
                                          rows[src])
            np.testing.assert_array_equal(got[j, k, len(rows[src]):], 0.0)


@pytest.mark.parametrize("kind,a,b", [
    ("graph", [2, 4, 5, 6], [1, 3, 0, 2, 1, 0]),          # 0-1, 0-3, 1-2
    ("cart", [4], [False])])
def test_neighbor_alltoall_graph(four, kind, a, b):
    pool, jdc = four
    jt, spec = _both(kind, a, b)
    K, bsz = 2, 3
    x = np.stack([np.stack([np.full(bsz, 100.0 * i + 10 * p, np.float32)
                            for p in range(K)]) for i in range(4)])
    got = port(pool, "neighbor_alltoall_graph", x, topo=spec)
    np.testing.assert_array_equal(
        got, ref(jdc, "neighbor_alltoall_graph", x, jt))
    for j in range(4):
        nbrs = jt.in_neighbors(j)
        for k, src in enumerate(nbrs):
            p = jt.out_neighbors(src).index(j)
            np.testing.assert_array_equal(got[j, k], x[src, p])
        np.testing.assert_array_equal(got[j, len(nbrs):], 0.0)


def test_neighbor_alltoall_graph_checks(four):
    """Too few blocks, repeated edges and disagreeing in/out lists raise."""
    pool, _ = four
    x = np.zeros((4, 1, 2), np.float32)
    for kind, msg in pool.run("raises", "neighbor_alltoall_graph", x,
                              topo=("graph", [2, 4, 5, 6],
                                    [1, 3, 0, 2, 1, 0])):
        assert kind == "ValueError" and "out-degree" in msg
    x = np.zeros((4, 2, 2), np.float32)
    for kind, msg in pool.run("raises", "neighbor_alltoall_graph", x,
                              topo=("graph", [2, 3, 4, 5],
                                    [1, 1, 0, 0, 0])):
        assert kind == "ValueError" and "repeated" in msg
    for kind, msg in pool.run("raises", "neighbor_alltoall_graph", x,
                              topo=("lists", [[1], [], [], []],
                                    [[], [], [], []])):
        assert kind == "ValueError" and "disagree" in msg


def test_bfloat16_ragged(world):
    pool, jdc = world
    x, C = _a2av_blocks(seed=9)
    got, _ = port_pair(pool, "alltoallv", x, C, dtype="bfloat16")
    want, _ = ref(jdc, "alltoallv", x.astype(jnp.bfloat16), C)
    np.testing.assert_array_equal(got, want.astype(np.float32))
