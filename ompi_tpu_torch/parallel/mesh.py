"""Device meshes over the world's processes.

Counterpart of ``ompi_tpu/parallel/mesh.py``.  A JAX mesh arranges devices;
here every rank is its own process owning one device, so a mesh arranges
the world's ranks.  ``make_mesh`` builds a ``torch.distributed``
``DeviceMesh`` with named dimensions, which gives each axis its own process
group (``mesh.get_group(name)``): the group a ``DeviceComm`` on that axis
talks over.

The GSPMD sharding of the reference that ``shard_params`` uses
(``sharded``) becomes ``Sharding``: where the reference places a global
array and lets XLA address its blocks, each process here holds its own
block, cut from the whole tensor (``local``) or put back together from
every member's block (``gather``).
"""

from __future__ import annotations

import os
import socket
import weakref
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .collectives import all_gather_axis

# The simulated slow plane, read from the JAX package's variable: axis
# names listed here classify as 'dcn' whatever the hosts say.
SIM_DCN_ENV = "OMPI_TPU_topo_sim_dcn_axes"


def sim_dcn_axes() -> FrozenSet[str]:
    """Axis names the sim-DCN override forces to 'dcn' (empty = off)."""
    raw = os.environ.get(SIM_DCN_ENV, "")
    return frozenset(a.strip() for a in raw.split(",") if a.strip())


# The host of every world rank (a small int id per distinct host name),
# taken once per world by make_mesh: the traffic plane classifies an edge
# ICI or DCN by it, from inside audits that must not gather.
_WORLD_HOSTS: Dict[int, list] = {}


def _world_key() -> int:
    return id(dist.distributed_c10d._get_default_group())


def world_hosts() -> Optional[list]:
    """Host id per world rank, or None before any ``make_mesh`` of this
    world (no gather happens here)."""
    if not dist.is_initialized():
        return None
    return _WORLD_HOSTS.get(_world_key())


def _take_world_hosts() -> None:
    """Collective (every rank of the world): all-gather the host names
    once per world."""
    key = _world_key()
    if key in _WORLD_HOSTS:
        return
    hosts = [None] * dist.get_world_size()
    # comm-lint: disable=CL001 the host table: one all-gather of each rank's host name (a Python object, no device payload) that feeds the traffic plane's ICI/DCN split; mesh bookkeeping, not a collective of the program
    dist.all_gather_object(hosts, socket.gethostname())
    ids = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    _WORLD_HOSTS.clear()
    _WORLD_HOSTS[key] = [ids[h] for h in hosts]


def make_mesh(axes: Dict[str, int]) -> DeviceMesh:
    """A named mesh over every rank of the world, e.g.
    ``make_mesh({"dp": 2, "tp": 4})``; ranks fill it in row-major order.

    Axis sizes must multiply to the world size; pass ``-1`` for at most
    one axis to absorb the remainder (like a reshape).  The mesh's device
    type follows the backend: ``cuda`` under NCCL, else ``cpu``.  Every
    rank of the world calls it (each axis's process group is made
    collectively; the first mesh of a world also gathers every rank's
    host, which the traffic plane's ICI/DCN split reads)."""
    world = dist.get_world_size()
    names, sizes = list(axes.keys()), list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} ranks, "
            f"have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))
    _take_world_hosts()
    return mesh


def axis_index_of(mesh: DeviceMesh, axis: str, rank: int) -> int:
    """Which position along ``axis`` a (global) rank occupies."""
    coords = np.argwhere(mesh.mesh.numpy() == rank)
    return int(coords[0][mesh.mesh_dim_names.index(axis)])


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Members along ``axis``; 1 for an axis the mesh lacks (the reference
    replicates over it: ``shard_params``' ``fit``)."""
    names = mesh.mesh_dim_names
    return int(mesh.mesh.shape[names.index(axis)]) if axis in names else 1


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This process's position along ``axis``; 0 for an axis it lacks."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


# One group per (mesh, axes): made collectively on first use, reused after.
_AXES_GROUPS: "weakref.WeakKeyDictionary[DeviceMesh, dict]" = \
    weakref.WeakKeyDictionary()


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group over the product of ``axes``: the ranks that
    differ from this one only along them, in the mesh's row-major order.
    One axis is the mesh's own group of that axis (``get_group``).  The
    first call for a mesh and a set of several axes makes every such group
    of the mesh, so every rank makes that call, in the same order."""
    names = mesh.mesh_dim_names
    key = tuple(a for a in names if a in axes)
    if len(key) == 1:
        return mesh.get_group(key[0])
    groups = _AXES_GROUPS.setdefault(mesh, {})
    if key not in groups:
        keep = [names.index(a) for a in key]
        rest = [i for i in range(len(names)) if i not in keep]
        width = int(np.prod([mesh.mesh.shape[i] for i in keep]))
        ranks = np.transpose(mesh.mesh.numpy(), rest + keep)
        me = dist.get_rank()
        for row in ranks.reshape(-1, width):
            group = dist.new_group(row.tolist(),
                                   group_desc="axes_" + "_".join(key))
            if me in row:
                groups[key] = group
    return groups[key]


def axes_position(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This process's row-major index over ``axes`` in the order given
    (outer to inner): a tuple axis's rank order."""
    pos = 0
    for a in axes:
        pos = pos * axis_size(mesh, a) + axis_rank(mesh, a)
    return pos


def group_order(mesh: DeviceMesh, axes: Sequence[str]) -> np.ndarray:
    """For the product group of ``axes`` (``axes_group``, ranks in the
    mesh's order), ``perm[j]``: the group rank of the member at row-major
    index j over ``axes`` in the order given.  The identity when ``axes``
    follow the mesh's order."""
    names = mesh.mesh_dim_names
    in_mesh = [a for a in names if a in axes]
    sizes = [axis_size(mesh, a) for a in axes]
    perm = np.empty(int(np.prod(sizes)), np.int64)
    for j in range(perm.size):
        coord = dict(zip(axes, np.unravel_index(j, sizes)))
        g = 0
        for a in in_mesh:
            g = g * axis_size(mesh, a) + int(coord[a])
        perm[j] = g
    return perm


def classify_axes(mesh: DeviceMesh, axis=None) -> Dict[str, str]:
    """Classify each axis as 'ici' (its ranks share a host) or 'dcn' (it
    crosses hosts), the han intra/inter split.  Every rank here is its own
    process, so the reference's test, whether an axis crosses a process,
    would call every axis 'dcn'; the hosts are compared instead, from an
    all-gather of every rank's host name.  An axis is 'dcn' when moving
    along it changes the host on ANY line of the mesh.  The
    ``OMPI_TPU_topo_sim_dcn_axes`` override names simulated slow axes.
    Collective: every rank of the world calls it.

    With ``axis`` (one name or a tuple), only those axes are classified,
    each from a gather over its own group (this rank's line of it): the
    form ``attach_mesh`` uses, where only the communicator's ranks take
    part."""
    sim = sim_dcn_axes()
    if axis is not None:
        out = {}
        for a in ((axis,) if isinstance(axis, str) else tuple(axis)):
            group = mesh.get_group(a)
            hosts = [None] * dist.get_world_size(group)
            # comm-lint: disable=CL001 the host table: one all-gather of each rank's host name (a Python object, no device payload) that feeds the traffic plane's ICI/DCN split; mesh bookkeeping, not a collective of the program
            dist.all_gather_object(hosts, socket.gethostname(), group=group)
            crosses = a in sim or len(set(hosts)) > 1
            out[a] = "dcn" if crosses else "ici"
        return out
    hosts = [None] * dist.get_world_size()
    # comm-lint: disable=CL001 the host table: one all-gather of each rank's host name (a Python object, no device payload) that feeds the traffic plane's ICI/DCN split; mesh bookkeeping, not a collective of the program
    dist.all_gather_object(hosts, socket.gethostname())
    ids = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    ranks = mesh.mesh.numpy()
    host_of = np.vectorize(lambda r: ids[hosts[r]])(ranks)
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        moved = np.moveaxis(host_of, i, 0)
        crosses = name in sim or bool((moved != moved[:1]).any())
        out[name] = "dcn" if crosses else "ici"
    return out


class Sharding:
    """A tensor laid out over a mesh as ``NamedSharding(mesh, P(*spec))``
    lays it out: dim i is cut into equal blocks over the axis ``spec[i]``
    names (None or past the spec: whole), and this process holds the
    block at its position on each named axis."""

    def __init__(self, mesh: DeviceMesh, spec: Tuple[Optional[str], ...]):
        for axis in spec:
            if axis is not None and axis not in mesh.mesh_dim_names:
                raise ValueError(f"axis {axis!r} is not one of the mesh's "
                                 f"{mesh.mesh_dim_names}")
        self.mesh, self.spec = mesh, tuple(spec)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This process's block of the whole tensor, as a tensor of its
        own."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = axis_size(self.mesh, axis)
            if full.shape[dim] % n:
                raise ValueError(f"dim {dim} ({full.shape[dim]}) does not "
                                 f"divide over the {n} members of {axis!r}")
            size = full.shape[dim] // n
            full = full.narrow(dim, axis_rank(self.mesh, axis) * size, size)
        return full.clone(memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every member's block (collective over the
        named axes)."""
        for dim, axis in enumerate(self.spec):
            if axis is None or axis_size(self.mesh, axis) == 1:
                continue
            moved = local.movedim(dim, 0).contiguous()
            local = all_gather_axis(moved, axis, mesh=self.mesh).movedim(
                0, dim)
        return local.clone(memory_format=torch.contiguous_format)


def sharded(mesh: DeviceMesh, *spec: Optional[str]) -> Sharding:
    return Sharding(mesh, spec)


__all__ = ["make_mesh", "axis_index_of", "axis_size", "axis_rank",
           "axes_group", "axes_position", "group_order", "classify_axes",
           "sim_dcn_axes", "world_hosts", "Sharding", "sharded"]
