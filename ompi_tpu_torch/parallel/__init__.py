from .collectives import DeviceComm
from .device_plane import device_plane_active, init_device_plane
from .mesh import classify_axes, make_mesh
from .ring import attention_reference, ring_attention

__all__ = ["DeviceComm", "attach_mesh", "attention_reference",
           "classify_axes", "device_plane_active", "init_device_plane",
           "make_mesh", "ring_attention"]


def attach_mesh(comm, mesh, axis) -> None:
    """Give a communicator a device mesh axis, or a tuple of axes, enabling
    the coll/nccl component (re-runs coll selection so nccl outranks the
    host components).  The port's copy of the JAX package's
    ``attach_mesh``: the axis's (or the axes' product's) processes must be
    the communicator's ranks, in order (rank i of the comm is position i
    on the axis, row-major over a tuple).  The comm's plane, which keys
    ``<coll>@<plane>`` rules rows, is ``"dcn"`` when any of its axes
    classifies so.  A tuple's product groups are made collectively, so
    every rank of the mesh attaches (its own comm) in the same order.  The
    topology-only attach (``axis=None``) and intercommunicators
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
    if axis is None:
        raise NotImplementedError(
            "attach_mesh takes an axis name or a tuple of them; the "
            "topology-only attach (axis=None) is not ported yet")
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    names = mesh.mesh_dim_names
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {names}")
    dc = DeviceComm(mesh, axis)
    if dc.n != comm.size:
        raise ValueError(
            f"mesh axis {axis!r} has {dc.n} devices but "
            f"comm {comm.name} has {comm.size} ranks")
    members = [dist.get_global_rank(dc.group, i) for i in range(dc.n)]
    if members != list(comm.group.world_ranks):
        raise ValueError(
            f"mesh axis {axis!r} holds world ranks {members}, comm "
            f"{comm.name} ranks {comm.group.world_ranks}: rank i of the "
            f"comm must be position i on the axis")
    comm.device_mesh = mesh
    comm.device_axis = dc.axis
    comm.device_comm = dc
    # the axes' classification and the plane that keys '<coll>@<plane>'
    # rules rows, fixed at attach (each axis classified on its own line,
    # so only the comm's ranks take part)
    comm.device_kinds = classify_axes(mesh, axes)
    comm.device_plane = ("dcn" if "dcn" in comm.device_kinds.values()
                         else "ici")
    from ..coll.framework import attach_coll

    attach_coll(comm)
