"""Reduction operators (the port's copy of ``ompi_tpu/op.py``).

An ``Op`` names an MPI reduction and carries ``fn(invec, inoutvec)``, which
folds two torch tensors.  Where NCCL has the reduction (sum, product, min,
max), ``dist_op`` holds its ``torch.distributed.ReduceOp`` and the device
collectives hand it to NCCL; every other op (the logical and bitwise ops,
user ops) is folded by ``fn`` after an all-gather, since NCCL has no
bitwise reduction.  ``dist_op`` takes the place of the JAX package's
``jax_name``.

MAXLOC and MINLOC fold (value, index) pairs given as tuples of tensors;
torch has no structured dtype for them.

``host_fn`` is the same fold on numpy arrays, the body of the JAX package's
``op.py``: the host collective algorithms (coll/basic, coll/tuned) fold
numpy buffers through ``Op.host``, where MAXLOC and MINLOC pairs are
structured arrays of ``loc_dtype``.  A user op (``Op.create``) has one
``fn``, used on whatever buffers it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Op:
    name: str
    fn: Callable[[Any, Any], Any]        # (in, inout) → result
    commutative: bool = True
    dist_op: Optional[Any] = None        # torch.distributed.ReduceOp
    host_fn: Optional[Callable[[Any, Any], Any]] = None   # numpy body

    def __call__(self, invec, inoutvec):
        return self.fn(invec, inoutvec)

    def host(self, invec: np.ndarray, inoutvec: np.ndarray) -> np.ndarray:
        """The fold on numpy buffers (the host algorithms' entry)."""
        return (self.host_fn or self.fn)(invec, inoutvec)

    @staticmethod
    def create(fn: Callable[[Any, Any], Any], commutative: bool = True,
               name: str = "user") -> "Op":
        return Op(name, fn, commutative)


def _logical(tfn):
    return lambda a, b: tfn(a.bool(), b.bool()).to(a.dtype)


def _np_logical(npfn):
    return lambda a, b: npfn(a.astype(bool), b.astype(bool)).astype(a.dtype)


SUM = Op("sum", lambda a, b: b + a, dist_op=dist.ReduceOp.SUM)
PROD = Op("prod", lambda a, b: b * a, dist_op=dist.ReduceOp.PRODUCT)
MAX = Op("max", torch.maximum, dist_op=dist.ReduceOp.MAX,
         host_fn=lambda a, b: np.maximum(a, b))
MIN = Op("min", torch.minimum, dist_op=dist.ReduceOp.MIN,
         host_fn=lambda a, b: np.minimum(a, b))
LAND = Op("land", _logical(torch.logical_and),
          host_fn=_np_logical(np.logical_and))
LOR = Op("lor", _logical(torch.logical_or),
         host_fn=_np_logical(np.logical_or))
LXOR = Op("lxor", _logical(torch.logical_xor),
          host_fn=_np_logical(np.logical_xor))
BAND = Op("band", torch.bitwise_and,
          host_fn=lambda a, b: np.bitwise_and(a, b))
BOR = Op("bor", torch.bitwise_or, host_fn=lambda a, b: np.bitwise_or(a, b))
BXOR = Op("bxor", torch.bitwise_xor,
          host_fn=lambda a, b: np.bitwise_xor(a, b))
REPLACE = Op("replace", lambda a, b: a)        # MPI_REPLACE (for one-sided)
NO_OP = Op("no_op", lambda a, b: b)            # MPI_NO_OP  (for one-sided)


def _loc(better):
    def fold(a, b):
        (av, ai), (bv, bi) = a, b
        take_a = better(av, bv) | ((av == bv) & (ai < bi))
        return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)
    return fold


def _np_maxloc(a, b):
    # value/index pairs as structured arrays with fields 'v' and 'i'
    take_a = (a["v"] > b["v"]) | ((a["v"] == b["v"]) & (a["i"] < b["i"]))
    return np.where(take_a, a, b)


def _np_minloc(a, b):
    take_a = (a["v"] < b["v"]) | ((a["v"] == b["v"]) & (a["i"] < b["i"]))
    return np.where(take_a, a, b)


MAXLOC = Op("maxloc", _loc(torch.gt), host_fn=_np_maxloc)
MINLOC = Op("minloc", _loc(torch.lt), host_fn=_np_minloc)


def _avg_pairwise(a, b):
    raise NotImplementedError(
        "AVG has no pairwise fold (MPI itself has no MPI_AVG); only "
        "collectives that know the communicator size implement it.")


# Mean-reduction op for gradient sync. Deliberately NOT foldable: any path
# that would silently compute a sum for it fails loudly instead.
AVG = Op("avg", _avg_pairwise)


def quantizable(op: Op, dtype) -> bool:
    """Whether the block-quantized device tier may carry (op, dtype): float
    operands (a torch or numpy dtype) under SUM/AVG only.  Integer and bool
    operands have no scale to quantize against, MAX/MIN/PROD do not
    commute with per-block rescaling, and MAXLOC/MINLOC pairs carry exact
    indices."""
    if op.name not in ("sum", "avg"):
        return False
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    dt = np.dtype(dtype)
    return dt.names is None and (np.issubdtype(dt, np.floating)
                                 or dt.name == "bfloat16")


def loc_dtype(value_dtype) -> np.dtype:
    """Structured dtype for MAXLOC/MINLOC pairs on the host
    (≙ MPI_DOUBLE_INT etc.)."""
    return np.dtype([("v", np.dtype(value_dtype)), ("i", np.int64)])


def reduce_local(op: Op, invec: torch.Tensor, inoutvec: torch.Tensor) -> None:
    """In place, inoutvec = op(invec, inoutvec) (MPI_Reduce_local)."""
    inoutvec.copy_(op(invec, inoutvec))


def reduce_local_host(op: Op, invec: np.ndarray,
                      inoutvec: np.ndarray) -> None:
    """``reduce_local`` on numpy buffers, through the op's host body."""
    np.copyto(inoutvec, op.host(invec, inoutvec))


__all__ = ["Op", "SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND",
           "BOR", "BXOR", "REPLACE", "NO_OP", "MAXLOC", "MINLOC", "AVG",
           "loc_dtype", "quantizable", "reduce_local", "reduce_local_host"]
