"""The port's ring_attention against the JAX package's, on the CPU.

The same numpy inputs go to the JAX ``ring_attention`` on the virtual CPU
mesh and to the port's in a gloo world of 8 processes, each holding its
sequence shard.  Tolerances are the JAX package's own for the same cases:
the f32 output to rtol 2e-4 / atol 2e-5 and its gradients to rtol 5e-3 /
atol 5e-4 (``tests/test_parallel.py``), the ``block_impl="pallas"`` hops
(K1's plain version here, the Pallas kernel in interpret mode there) to
2e-4 (``tests/test_ops.py``).  The bf16 case is held to 2e-2: both sides
round the scores, p and the merged partials to bf16 (2^-8 each), in
different orders.

The JAX side compiles three programs: the f32 ring at sp = 8 (outputs and
gradients, causal and not), the Pallas ring at sp = 4 and the bf16 ring.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ompi_tpu.parallel import make_mesh  # noqa: E402
from ompi_tpu.parallel.ring import ring_attention  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

B, S, H, D = 2, 64, 8, 16          # seq 64 over 8 processes: 8 each
PALLAS_SHAPE = (2, 64, 2, 16)      # tests/test_ops.py's, over sp = 4
PALLAS_AXES = {"sp": 4, "dp": 2}   # the batch replicated over dp
CAUSAL = [False, True]

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(8)
    yield p
    p.close()


def _assemble(blocks, coords, axes, full_shape):
    """The whole array from every process's (b, s, h, d) block: the
    sequence cut over sp; the batch whole (replicated over any other
    axis, whose copies must agree)."""
    out = np.full(full_shape, np.nan, np.float32)
    s = full_shape[1] // axes["sp"]
    for block, c in zip(blocks, coords):
        sl = out[:, c["sp"] * s:(c["sp"] + 1) * s]
        if not np.isnan(sl).all():
            np.testing.assert_array_equal(sl, block)
        sl[...] = block
    return out


def _port(pool, axes, *args, **kwargs):
    coords = pool.run("_torch_mesh_worker:coords", axes)
    outs = pool.run("_torch_mesh_worker:ring", axes, *args, **kwargs)
    shape = args[0].shape
    if kwargs.get("cot") is None:
        return _assemble(outs, coords, axes, shape)
    return [_assemble([o[i] for o in outs], coords, axes, shape)
            for i in range(4)]


def _sharded(mesh, *xs):
    return [jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "sp")))
            for x in xs]


@pytest.fixture(scope="module")
def f32_case():
    """Inputs, and the JAX ring's outputs and gradients of sum(out · cot)
    at sp = 8, causal and not, from one compiled program."""
    q, k, v, cot = _inputs((B, S, H, D), 0)
    mesh = make_mesh({"sp": 8})

    def both(q, k, v, cot):
        res = []
        for causal in CAUSAL:
            out, vjp = jax.vjp(lambda *a: ring_attention(
                *a, mesh, "sp", causal=causal), q, k, v)
            res.append((out,) + vjp(cot))
        return res

    want = jax.jit(both)(*_sharded(mesh, q, k, v, cot))
    return (q, k, v, cot), [[np.asarray(x) for x in r] for r in want]


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_matches_jax(pool, f32_case, causal):
    (q, k, v, _), want = f32_case
    got = _port(pool, {"sp": 8}, q, k, v, causal)
    np.testing.assert_allclose(got, want[int(causal)][0], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_grads_match_jax(pool, f32_case, causal):
    (q, k, v, cot), want = f32_case
    got = _port(pool, {"sp": 8}, q, k, v, causal, cot=cot)
    np.testing.assert_allclose(got[0], want[int(causal)][0], rtol=2e-4,
                               atol=2e-5)
    for name, g, w in zip("qkv", got[1:], want[int(causal)][1:]):
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-4,
                                   err_msg=f"d{name}")


@pytest.fixture(scope="module")
def pallas_case():
    """The JAX ring with the Pallas hop (interpret mode), sp = 4, causal
    and not, from one compiled program."""
    q, k, v = _inputs(PALLAS_SHAPE, 3, n=3)
    mesh = make_mesh({"sp": 4, "dp": -1})

    def both(q, k, v):
        return [ring_attention(q, k, v, mesh, "sp", causal=c,
                               block_impl="pallas") for c in CAUSAL]

    want = jax.jit(both)(*(jnp.asarray(x) for x in (q, k, v)))
    return (q, k, v), [np.asarray(w) for w in want]


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_pallas_matches_jax(pool, pallas_case, causal):
    (q, k, v), want = pallas_case
    got = _port(pool, PALLAS_AXES, q, k, v, causal, block_impl="pallas")
    np.testing.assert_allclose(got, want[int(causal)], rtol=2e-4, atol=2e-4)


def test_ring_attention_bf16_matches_jax(pool):
    q, k, v = _inputs((B, S, H, D), 5, n=3)
    mesh = make_mesh({"sp": 8})
    # the casts on the host, so that the ring is the one program compiled
    qb, kb, vb = _sharded(mesh, *(x.astype(jnp.bfloat16)
                                  for x in (q, k, v)))
    want = np.asarray(ring_attention(qb, kb, vb, mesh, "sp", causal=True)
                      ).astype(np.float32)
    # the port rounds the same f32 draws to bf16
    got = _port(pool, {"sp": 8}, q, k, v, True, dtype="bfloat16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_ring_attention_pallas_refuses_autograd(pool):
    """Forward only, as the reference: a gradient through the K1 hop
    raises instead of running."""
    (q,) = _inputs((B, S, H, D), 6, n=1)
    msgs = pool.run("_torch_mesh_worker:ring_pallas_grad_refused",
                    {"sp": 8}, q)
    assert all(m is not None and "forward only" in m for m in msgs)
