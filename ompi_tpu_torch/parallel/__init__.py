from .collectives import DeviceComm
from .device_plane import device_plane_active, init_device_plane
from .mesh import classify_axes, make_mesh
from .ring import attention_reference, ring_attention

__all__ = ["DeviceComm", "attach_mesh", "attention_reference",
           "classify_axes", "device_plane_active", "init_device_plane",
           "make_mesh", "ring_attention"]


def attach_mesh(comm, mesh, axis) -> None:
    """Give a communicator a device mesh axis, enabling the coll/nccl
    component (re-runs coll selection so nccl outranks the host
    components).  The port's copy of the JAX package's ``attach_mesh``
    for one axis: the axis's processes must be the communicator's ranks,
    in order (rank i of the comm is position i on the axis).  Tuple axes
    (P13), the topology-only attach (``axis=None``) and intercommunicators
    (``coll/inter``) are later slices."""
    import torch.distributed as dist

    if getattr(comm.ctx, "shares_process", False):
        raise RuntimeError(
            "attach_mesh: a threaded rank (runtime.run_ranks) shares its "
            "process with its job's other ranks, and torch.distributed has "
            "one world a process: device collectives run one process per "
            "rank (tpurun)")
    if comm.is_inter:
        raise NotImplementedError(
            "attach_mesh on an intercommunicator needs coll/inter, which "
            "is not ported yet (ROADMAP P7, what waits)")
    if axis is None or isinstance(axis, (tuple, list)):
        raise NotImplementedError(
            "attach_mesh takes one axis name; the topology-only attach and "
            "tuple axes come with ROADMAP P13")
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's {names}")
    ax_size = int(mesh.mesh.shape[names.index(axis)])
    if ax_size != comm.size:
        raise ValueError(
            f"mesh axis {axis!r} has {ax_size} devices but "
            f"comm {comm.name} has {comm.size} ranks")
    group = mesh.get_group(axis)
    members = [dist.get_global_rank(group, i) for i in range(ax_size)]
    if members != list(comm.group.world_ranks):
        raise ValueError(
            f"mesh axis {axis!r} holds world ranks {members}, comm "
            f"{comm.name} ranks {comm.group.world_ranks}: rank i of the "
            f"comm must be position i on the axis")
    comm.device_mesh = mesh
    comm.device_axis = axis
    comm.device_comm = DeviceComm(mesh, axis)
    # the plane that keys '<coll>@<plane>' rules rows, fixed at attach
    comm.device_plane = classify_axes(mesh, axis)[axis]
    from ..coll.framework import attach_coll

    attach_coll(comm)
