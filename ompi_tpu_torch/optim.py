"""AdamW for the port, as plain functions on tensors.

The JAX package has no module of its own for this: its train step calls
``optax.adamw(learning_rate, mu_dtype=cfg.opt_moment_dtype)``.  This module
is that transformation, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, and weight_decay 1e-4, where torch's own AdamW defaults to
1e-2) and its order of operations:

    mu ← b1·mu + (1−b1)·g          (b1·mu in mu's dtype, b1 included: a
                                    bf16 mu takes b1 = 0.8984375; the sum
                                    in f32)
    nu ← b2·nu + (1−b2)·g²         (f32)
    t  = count + 1
    u  = (mu / (1−b1ᵗ)) / (sqrt(nu / (1−b2ᵗ)) + eps) + wd·p
    p  ← p − lr·u,  and mu is cast to its dtype after the bias correction.

The state is ``{"count": int, "mu": tree, "nu": tree}``, the trees shaped
like the parameters (dicts and lists of tensors).  ``adamw_update``
updates the parameters and the moments in place: PyTorch's counterpart of
the JAX step's ``donate_argnums=(0, 1)``, so a step holds no second copy
of the parameters or of the state.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from .device import DeviceLike, resolve_device

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4
_MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree) -> Any:
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, item) for item in tree]
    return fn(tree)


def adamw_init(params, mu_dtype: str = "float32") -> dict:
    """Zero moments shaped like ``params``: mu in ``mu_dtype``, nu in f32."""
    if mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu_dtype {mu_dtype!r} (expected one of "
                         f"{tuple(_MU_DTYPES)})")
    dt = _MU_DTYPES[mu_dtype]
    return {"count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "nu": tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)}


@torch.no_grad()
def adamw_update(params, grads: List[torch.Tensor], state: dict,
                 learning_rate: float) -> None:
    """One AdamW step, in place on ``params`` and ``state``; ``grads`` in
    the order of ``tree_leaves(params)``."""
    ps, ms, ns = (tree_leaves(t) for t in (params, state["mu"], state["nu"]))
    if not len(ps) == len(grads) == len(ms) == len(ns):
        raise ValueError(f"{len(ps)} params, {len(grads)} grads, "
                         f"{len(ms)} mu, {len(ns)} nu")
    count = state["count"] + 1
    # 1 − bᵗ in float32, as optax computes it from its int32 count
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
    # optax's weak-typed b1 takes mu's dtype before the product
    b1 = {dt: float(torch.tensor(B1, dtype=dt))
          for dt in {m.dtype for m in ms}}
    for p, g, mu, nu in zip(ps, grads, ms, ns):
        g = g.float()
        mu_new = torch.mul(g, 1 - B1).add_(mu * b1[mu.dtype])
        nu.mul_(B2).add_(g.square().mul_(1 - B2))
        u = (mu_new / bc1).div_((nu / bc2).sqrt_().add_(EPS))
        u.add_(p * WEIGHT_DECAY)
        p.add_(u.mul_(-learning_rate))
        mu.copy_(mu_new)
    state["count"] = count


def opt_state_from_numpy(state, device: DeviceLike = None) -> dict:
    """optax's adamw state, as numpy arrays (``jax.tree.map(np.asarray,
    opt_state)``), as the port's, on ``device`` (``None`` = cuda).  optax's
    state is a tuple whose first entry holds ``count``, ``mu`` and ``nu``;
    mu keeps its dtype (bf16 or f32), nu is f32."""
    dev = resolve_device(device)
    adam = state if hasattr(state, "mu") else state[0]

    def tensor(a):
        a = np.asarray(a)
        dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        return torch.from_numpy(a.astype(np.float32)).to(dev, dt)

    return {"count": int(np.asarray(adam.count)),
            "mu": tree_map(tensor, adam.mu), "nu": tree_map(tensor, adam.nu)}
