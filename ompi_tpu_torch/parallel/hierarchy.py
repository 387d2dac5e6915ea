"""Hierarchical (two-level) collectives — the HAN analog.

The port's copy of ``ompi_tpu/parallel/hierarchy.py`` (≙ ompi/mca/coll/han:
a collective split into an intra-node stage and an inter-node stage over
sub-communicators, coll_han_allreduce.c:92, coll_han_subcomms.c).  The
levels are mesh axes: ``inner`` rides the fast plane (NVLink within a
host; ICI in the reference), ``outer`` the slow one (between hosts; DCN).
The bandwidth shape is HAN's: reduce-scatter inner → allreduce outer on
1/n_inner of the data → allgather inner, so the slow hops carry only the
scattered fraction.

Each stage is one NCCL collective (gloo on the CPU tests' plane) on this
rank's line of the level's axis: ``mesh.axes_group(mesh, (axis,))``, the
mesh's own group of that axis, made once per mesh by every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .collectives import _check_backend, _group_of
from .mesh import axis_size, classify_axes

# classify_axes is re-exported here as the public topology-inference entry
# point: hier_axes and auto_levels key off the same fast/slow axis split
__all__ = ["classify_axes", "hierarchical_psum", "hierarchical_psum_quant",
           "hierarchical_allreduce", "auto_levels", "hier_axes",
           "hier_wire_bytes"]


def _pad_to_inner(x: torch.Tensor, ni: int):
    """Zero-pad dim 0 to a multiple of the inner level's size (exact for a
    sum: the pad rows reduce to zero and are sliced off after the
    allgather).  Returns (padded, original_len)."""
    orig = x.shape[0]
    pad = (-orig) % ni
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.contiguous(), orig


def _stages(x: torch.Tensor, inner, outer, mesh, outer_stage):
    """reduce_scatter over ``inner``, ``outer_stage(scattered, group)``,
    allgather over ``inner``; dim 0 padded to the inner size and cut
    back."""
    gi, go = _group_of(inner, mesh), _group_of(outer, mesh)
    for g in (gi, go):
        _check_backend(x.device.type, dist.get_backend(g))
    ni = dist.get_world_size(gi)
    x, orig = _pad_to_inner(x, ni)
    scattered = x.new_empty((x.shape[0] // ni,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(scattered, x, op=dist.ReduceOp.SUM, group=gi)
    reduced = outer_stage(scattered, go).contiguous()
    out = x.new_empty(x.shape)
    dist.all_gather_into_tensor(out, reduced, group=gi)
    return out[:orig] if out.shape[0] != orig else out


def hierarchical_psum(x: torch.Tensor, inner, outer,
                      mesh=None) -> torch.Tensor:
    """This rank's ``x`` summed over both levels (process groups, or axis
    names of ``mesh``): reduce-scatter over ``inner``, allreduce over
    ``outer``, allgather over ``inner``.  Dim 0 of any length:
    non-divisible shapes (real gradient flats) are zero-padded to a
    multiple of the inner size and sliced back after the allgather."""
    def outer_sum(t, group):
        dist.all_reduce(t, group=group)
        return t
    return _stages(x, inner, outer, mesh, outer_sum)


def hierarchical_psum_quant(x: torch.Tensor, inner, outer, n_outer: int,
                            block: Optional[int] = None,
                            mesh=None) -> torch.Tensor:
    """The ``hier+quant`` composition: the same HAN shape, but the OUTER
    allreduce rides the block-quantized tier (``coll/quant.psum_quant``)
    while both inner stages stay native: the two-rounding quantization
    error is paid only where the wire-byte cut buys time, on top of the
    n_inner× hierarchical reduction."""
    from ..coll.quant import psum_quant

    return _stages(x, inner, outer, mesh,
                   lambda t, group: psum_quant(t, group, n_outer,
                                               block=block))


def hierarchical_allreduce(x: torch.Tensor, mesh, inner: str,
                           outer: str) -> torch.Tensor:
    """Two-level allreduce over both axes of a mesh: this rank's buffer
    in (the reference's row (i, j) of its (n_outer, n_inner, *elem)
    array), the global sum out."""
    from .. import traffic
    if traffic.enabled:
        # inner RS/AG rings + the outer ring on the scattered 1/n_inner
        # fraction — the per-plane rollup shows the HAN bandwidth shape
        traffic.note_hierarchical(mesh, inner, outer, x.nbytes)
    flat = x.reshape(-1)
    return hierarchical_psum(flat, inner, outer, mesh).reshape(x.shape)


def auto_levels(mesh, kinds: Optional[Dict[str, str]] = None):
    """Pick (inner, outer) from topology: fast axes inner, slow axes outer
    (``classify_axes``, collective over the world unless ``kinds`` is
    given); falls back to (last, first) axis on flat meshes."""
    kinds = classify_axes(mesh) if kinds is None else kinds
    ici = [a for a, k in kinds.items() if k == "ici"]
    dcn = [a for a, k in kinds.items() if k == "dcn"]
    if ici and dcn:
        return ici[-1], dcn[0]
    names = list(mesh.mesh_dim_names)
    return names[-1], names[0]


def hier_axes(mesh, axis, kinds: Optional[Dict[str, str]] = None):
    """Eligibility probe for the ``hier`` decision arm: given the axis (or
    axis tuple) a DeviceComm spans, return ``(inner, outer, None)`` when
    the comm is genuinely two-tier — at least one ICI level and one DCN
    level (``classify_axes``, including the ``topo_sim_dcn_axes``
    override), both larger than 1 — else ``(None, None, why)`` where
    ``why`` is the ineligibility reason the decision audit records
    (``ineligible:hier:<why>``).  Unlike :func:`auto_levels` this never
    invents a split on a flat mesh.  ``kinds`` is the axes'
    classification when the caller has it (``attach_mesh`` classifies the
    comm's own axes); without it the whole mesh is classified, which is
    collective over the world."""
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if len(axes) < 2:
        return None, None, "single-axis comm (no inner/outer levels)"
    kinds = classify_axes(mesh) if kinds is None else kinds
    dcn = [a for a in axes if kinds.get(a) == "dcn"]
    ici = [a for a in axes if kinds.get(a) == "ici"]
    if not dcn:
        return None, None, "single-plane mesh (no DCN axis among " \
            f"{axes})"
    if not ici:
        return None, None, "no ICI axis to scatter over (all of " \
            f"{axes} cross DCN)"
    inner, outer = ici[-1], dcn[0]
    if axis_size(mesh, inner) < 2:
        return None, None, f"degenerate inner level {inner!r} (size 1)"
    if axis_size(mesh, outer) < 2:
        return None, None, f"degenerate outer level {outer!r} (size 1)"
    return inner, outer, None


def hier_wire_bytes(count: int, dtype, ni: int, no: int,
                    quant: bool = False, block: Optional[int] = None,
                    scale_dtype=None) -> dict:
    """Per-rank wire bytes of one hierarchical allreduce of ``count``
    elements of ``dtype`` (torch or numpy): the inner reduce-scatter and
    allgather each move (ni-1)/ni of the buffer over the fast plane, the
    outer allreduce moves 2(no-1)/no of the SCATTERED 1/ni fraction over
    the slow plane.  With ``quant`` the outer figure is
    ``coll/quant.wire_bytes``' (int8 payload + per-block scales).  The one
    source of the decision audit's and the simulated-DCN shim's figures."""
    from ..coll.quant import _itemsize, wire_bytes

    nbytes = int(count) * _itemsize(dtype)
    inner_stage = int((ni - 1) / ni * nbytes) if ni > 1 else 0
    outer_native = int(2 * (no - 1) / no * (nbytes // ni)) if no > 1 else 0
    outer = outer_native
    ratio = None
    if quant and no > 1:
        wb = wire_bytes("allreduce", max(int(count) // ni, 1), no, dtype,
                        block, scale_dtype)
        outer = wb["quant_bytes"]
        ratio = (outer / outer_native) if outer_native else None
    return {"inner_bytes": 2 * inner_stage,      # RS + AG stages
            "inner_stage_bytes": inner_stage,
            "outer_bytes": outer,
            "outer_native_bytes": outer_native,
            "total_bytes": 2 * inner_stage + outer,
            "ratio": ratio}
