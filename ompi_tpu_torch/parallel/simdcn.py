"""parallel/simdcn — the simulated-DCN delay shim.

Counterpart of ``ompi_tpu/parallel/simdcn.py``.  One host's cards are one
flat plane: every arm sees the same fabric, so an arm whose value is
moving fewer bytes over the SLOW plane can never win a wall-clock sweep
there.  The shim makes the simulated slow plane cost something: when
``topo_sim_dcn_us_per_mib`` is nonzero, the callers charge a host-side
sleep proportional to the bytes they move across a simulated DCN boundary
(axes named by ``OMPI_TPU_topo_sim_dcn_axes``, the override
``mesh.classify_axes`` honours).

The model is a bandwidth-proportional penalty with no contention: its
only job is to order arms the way a two-tier fabric would.  Its callers
in the port: the fleet's KV-page migration (``serving/fleet``), charged
when the fleet axis classifies as DCN; the decision layer's audit
(``coll/nccl``: a hierarchical arm pays its outer stage's bytes, a flat
arm the DCN fraction of its ring's wire); and the serving engine's decode
audit.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..core import var as _var
from .mesh import axis_size, classify_axes, sim_dcn_axes

_var.register("topo", "sim", "dcn_us_per_mib", 0.0, type=float, level=4,
              help="Simulated-DCN delay shim: host-side microseconds "
                   "charged per MiB that crosses a simulated DCN "
                   "boundary (parallel/simdcn; 0 = shim off).")

AxisLike = Union[str, Tuple[str, ...]]

# ring-geometry DCN fraction per (mesh id, axis) — meshes are long-lived
# and few
_FRAC_CACHE: Dict[tuple, float] = {}
_FRAC_CACHE_MAX = 32


def axis_tuple(axis: AxisLike) -> Tuple[str, ...]:
    """Normalize a DeviceComm axis (one name or a tuple) to a tuple."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def us_per_mib() -> float:
    """Configured shim cost (0.0 = shim off)."""
    try:
        return float(_var.get("topo_sim_dcn_us_per_mib", 0.0))
    except (TypeError, ValueError):
        return 0.0


def ring_dcn_fraction(mesh, axis: AxisLike,
                      kinds: Optional[Dict[str, str]] = None) -> float:
    """Fraction of the axis ring's hops that cross a DCN boundary.

    The ring runs over the flattened (row-major) product of the named
    axes, and a hop crosses DCN when the coordinate changes along any
    DCN-classified axis (hosts, or the sim override).  ``kinds`` is the
    axes' classification where the caller holds it (a communicator
    classifies its own axes when it is made); without it the first call
    for a mesh classifies every axis, which is collective over the world
    (``classify_axes``): every rank makes it, in the same order."""
    key = (id(mesh), axis_tuple(axis), tuple(sorted(sim_dcn_axes())))
    got = _FRAC_CACHE.get(key)
    if got is not None:
        return got
    axes = axis_tuple(axis)
    kinds = classify_axes(mesh) if kinds is None else kinds
    sizes = [axis_size(mesh, a) for a in axes]
    n = int(np.prod(sizes))
    dcn_dims = [k for k, a in enumerate(axes) if kinds.get(a) == "dcn"]
    frac = 0.0
    if n >= 2 and dcn_dims:
        cross = 0
        for i in range(n):
            ci = np.unravel_index(i, sizes)
            cj = np.unravel_index((i + 1) % n, sizes)
            if any(ci[k] != cj[k] for k in dcn_dims):
                cross += 1
        frac = cross / n
    if len(_FRAC_CACHE) >= _FRAC_CACHE_MAX:
        _FRAC_CACHE.clear()
    _FRAC_CACHE[key] = frac
    return frac


def penalty_us(dcn_bytes: int, us_mib: Optional[float] = None) -> float:
    """Modeled delay for ``dcn_bytes`` crossing the simulated boundary."""
    us = us_per_mib() if us_mib is None else us_mib
    if us <= 0 or dcn_bytes <= 0:
        return 0.0
    return dcn_bytes / float(1 << 20) * us


def charge(dcn_bytes: int) -> None:
    """Sleep the modeled delay (no-op when the shim is off)."""
    us = penalty_us(int(dcn_bytes))
    if us > 0:
        time.sleep(us * 1e-6)


def clear_cache() -> None:
    """Test helper: the fraction cache keys on mesh identity, but the
    classification behind it moves with the sim override."""
    _FRAC_CACHE.clear()


__all__ = ["axis_tuple", "us_per_mib", "ring_dcn_fraction", "penalty_us",
           "charge", "clear_cache"]
