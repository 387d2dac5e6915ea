"""Device meshes over the world's processes.

Counterpart of ``ompi_tpu/parallel/mesh.py``.  A JAX mesh arranges devices;
here every rank is its own process owning one device, so a mesh arranges
the world's ranks.  ``make_mesh`` builds a ``torch.distributed``
``DeviceMesh`` with named dimensions, which gives each axis its own process
group (``mesh.get_group(name)``): the group a ``DeviceComm`` on that axis
talks over.

The GSPMD shardings of the reference (``replicated``, ``sharded``,
``shard_leading``) have no counterpart yet; they come with the flagship on
a mesh (ROADMAP P6).
"""

from __future__ import annotations

import os
import socket
from typing import Dict, FrozenSet

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The simulated slow plane, read from the JAX package's variable: axis
# names listed here classify as 'dcn' whatever the hosts say.
SIM_DCN_ENV = "OMPI_TPU_topo_sim_dcn_axes"


def sim_dcn_axes() -> FrozenSet[str]:
    """Axis names the sim-DCN override forces to 'dcn' (empty = off)."""
    raw = os.environ.get(SIM_DCN_ENV, "")
    return frozenset(a.strip() for a in raw.split(",") if a.strip())


def make_mesh(axes: Dict[str, int]) -> DeviceMesh:
    """A named mesh over every rank of the world, e.g.
    ``make_mesh({"dp": 2, "tp": 4})``; ranks fill it in row-major order.

    Axis sizes must multiply to the world size; pass ``-1`` for at most
    one axis to absorb the remainder (like a reshape).  The mesh's device
    type follows the backend: ``cuda`` under NCCL, else ``cpu``.  Every
    rank of the world calls it (each axis's process group is made
    collectively)."""
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
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def axis_index_of(mesh: DeviceMesh, axis: str, rank: int) -> int:
    """Which position along ``axis`` a (global) rank occupies."""
    coords = np.argwhere(mesh.mesh.numpy() == rank)
    return int(coords[0][mesh.mesh_dim_names.index(axis)])


def classify_axes(mesh: DeviceMesh) -> Dict[str, str]:
    """Classify each axis as 'ici' (its ranks share a host) or 'dcn' (it
    crosses hosts), the han intra/inter split.  Every rank here is its own
    process, so the reference's test, whether an axis crosses a process,
    would call every axis 'dcn'; the hosts are compared instead, from an
    all-gather of every rank's host name.  An axis is 'dcn' when moving
    along it changes the host on ANY line of the mesh.  The
    ``OMPI_TPU_topo_sim_dcn_axes`` override names simulated slow axes.
    Collective: every rank of the world calls it."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    ids = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    ranks = mesh.mesh.numpy()
    host_of = np.vectorize(lambda r: ids[hosts[r]])(ranks)
    sim = sim_dcn_axes()
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        moved = np.moveaxis(host_of, i, 0)
        crosses = name in sim or bool((moved != moved[:1]).any())
        out[name] = "dcn" if crosses else "ici"
    return out


__all__ = ["make_mesh", "axis_index_of", "classify_axes",
           "sim_dcn_axes"]
