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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Op:
    name: str
    fn: Callable[[Any, Any], Any]        # (in, inout) → result
    commutative: bool = True
    dist_op: Optional[Any] = None        # torch.distributed.ReduceOp

    def __call__(self, invec, inoutvec):
        return self.fn(invec, inoutvec)

    @staticmethod
    def create(fn: Callable[[Any, Any], Any], commutative: bool = True,
               name: str = "user") -> "Op":
        return Op(name, fn, commutative)


def _logical(tfn):
    return lambda a, b: tfn(a.bool(), b.bool()).to(a.dtype)


SUM = Op("sum", lambda a, b: b + a, dist_op=dist.ReduceOp.SUM)
PROD = Op("prod", lambda a, b: b * a, dist_op=dist.ReduceOp.PRODUCT)
MAX = Op("max", torch.maximum, dist_op=dist.ReduceOp.MAX)
MIN = Op("min", torch.minimum, dist_op=dist.ReduceOp.MIN)
LAND = Op("land", _logical(torch.logical_and))
LOR = Op("lor", _logical(torch.logical_or))
LXOR = Op("lxor", _logical(torch.logical_xor))
BAND = Op("band", torch.bitwise_and)
BOR = Op("bor", torch.bitwise_or)
BXOR = Op("bxor", torch.bitwise_xor)
REPLACE = Op("replace", lambda a, b: a)        # MPI_REPLACE (for one-sided)
NO_OP = Op("no_op", lambda a, b: b)            # MPI_NO_OP  (for one-sided)


def _loc(better):
    def fold(a, b):
        (av, ai), (bv, bi) = a, b
        take_a = better(av, bv) | ((av == bv) & (ai < bi))
        return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)
    return fold


MAXLOC = Op("maxloc", _loc(torch.gt))
MINLOC = Op("minloc", _loc(torch.lt))


def _avg_pairwise(a, b):
    raise NotImplementedError(
        "AVG has no pairwise fold (MPI itself has no MPI_AVG); only "
        "collectives that know the communicator size implement it.")


# Mean-reduction op for gradient sync. Deliberately NOT foldable: any path
# that would silently compute a sum for it fails loudly instead.
AVG = Op("avg", _avg_pairwise)


def reduce_local(op: Op, invec: torch.Tensor, inoutvec: torch.Tensor) -> None:
    """In place, inoutvec = op(invec, inoutvec) (MPI_Reduce_local)."""
    inoutvec.copy_(op(invec, inoutvec))


__all__ = ["Op", "SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND",
           "BOR", "BXOR", "REPLACE", "NO_OP", "MAXLOC", "MINLOC", "AVG",
           "reduce_local"]
