"""The port's AdamW (ompi_tpu_torch.optim) against optax.adamw, the JAX
package's optimizer, on the CPU: the same parameter tree and gradients,
made with numpy from a seed, through five steps.

f32 moments agree to 1e-6 relative on the parameters (the same f32
operations in the same order; the bias corrections 1 − bᵗ may differ in
the last bit between numpy's and XLA's power).  With a bf16 first moment
both round b1·mu to bf16 before adding (1−b1)·g in f32, and cast mu to
bf16 after the bias correction, so the parameters agree to the same
bound and mu agrees exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ompi_tpu_torch import optim


def _tree(rng):
    shape = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": shape(16, 8), "final_norm": shape(8),
            "layers": [{"w": shape(8, 4), "b": shape(4)},
                       {"w": shape(8, 4), "b": shape(4)}]}


def _to_torch(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    tx = optax.adamw(1e-2, mu_dtype=jnp.dtype(mu_dtype))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = _to_torch(params)
    tstate = optim.adamw_init(tparams, mu_dtype)
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        optim.adamw_update(tparams, optim.tree_leaves(_to_torch(g)),
                           tstate, 1e-2)
    assert tstate["count"] == 5 == int(jstate[0].count)
    for got, want in zip(optim.tree_leaves(tparams),
                         jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    for got, want in zip(optim.tree_leaves(tstate["mu"]),
                         jax.tree.leaves(jstate[0].mu)):
        assert got.dtype == getattr(torch, mu_dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=1e-6,
                                   atol=1e-8)


def test_adamw_updates_in_place():
    params = _to_torch(_tree(np.random.default_rng(1)))
    state = optim.adamw_init(params)
    before = [p.data_ptr() for p in optim.tree_leaves(params)]
    moments = [m.data_ptr() for m in optim.tree_leaves(state["mu"])]
    optim.adamw_update(params, [torch.ones_like(p) for p in
                                optim.tree_leaves(params)], state, 1e-3)
    assert [p.data_ptr() for p in optim.tree_leaves(params)] == before
    assert [m.data_ptr() for m in optim.tree_leaves(state["mu"])] == moments


def test_opt_state_from_numpy_keeps_dtypes_and_order():
    rng = np.random.default_rng(2)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    tx = optax.adamw(1e-3, mu_dtype=jnp.bfloat16)
    state = tx.init(params)
    _, state = tx.update(jax.tree.map(jnp.ones_like, params), state, params)
    got = optim.opt_state_from_numpy(jax.tree.map(np.asarray, state),
                                     device="cpu")
    assert got["count"] == 1
    for g, w in zip(optim.tree_leaves(got["mu"]),
                    jax.tree.leaves(state[0].mu)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    for g, w in zip(optim.tree_leaves(got["nu"]),
                    jax.tree.leaves(state[0].nu)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adamw_refuses_mismatched_trees():
    params = _to_torch(_tree(np.random.default_rng(3)))
    state = optim.adamw_init(params)
    with pytest.raises(ValueError, match="grads"):
        optim.adamw_update(params, [torch.zeros(1)], state, 1e-3)
    with pytest.raises(ValueError, match="mu_dtype"):
        optim.adamw_init(params, "float16")
