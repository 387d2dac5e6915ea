"""Worker functions for ``tests/test_torch_commgraph.py``: the port's
``analysis.commgraph`` on gloo worlds (``_torch_coll_worker.Pool``).

Each function runs in every rank of the pool's world, gets the pool's
``DeviceComm`` first, and returns plain Python (records as tuples, reports
as ``VerifyReport.to_json()``).  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ompi_tpu_torch import optim, traffic
from ompi_tpu_torch.analysis import commgraph as cg
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.op import MAX
from ompi_tpu_torch.parallel import overlap
from ompi_tpu_torch.parallel.collectives import DeviceComm
from ompi_tpu_torch.parallel.mesh import axis_rank, make_mesh

_MESHES: dict = {}


def _mesh(axes):
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes))
    return _MESHES[key]


def _rows(g: cg.CommGraph) -> list:
    return [(r.op, r.axes, r.dtype, r.shape, r.nbytes, r.trips, r.perm,
             r.path, r.control) for r in g.records]


def _issues(issues) -> list:
    return [(i.kind, i.severity, i.msg) for i in issues]


def _seq_shards(mesh, axis, *arrays):
    """This member's sequence block (dim 1) of each whole array."""
    n, my = mesh.mesh.shape[mesh.mesh_dim_names.index(axis)], axis_rank(
        mesh, axis)
    out = []
    for a in arrays:
        s = a.shape[1] // n
        out.append(torch.from_numpy(np.ascontiguousarray(
            a[:, my * s:(my + 1) * s])))
    return out


def _clean():
    traffic.reset()
    traffic.disable()


def ring(dc, q, k, v):
    """ring_attention on {"sp": n}: the extracted records with the perm
    assembled over the sp group, the checks, the verify report, and the
    planted fault — a ring charging one hop fewer — verified again."""
    from ompi_tpu_torch.parallel import ring as ring_mod
    mesh = _mesh({"sp": dist.get_world_size()})
    group = mesh.get_group("sp")
    qs, ks, vs = _seq_shards(mesh, "sp", q, k, v)

    def fn(a, b, c):
        return ring_mod.ring_attention(a, b, c, mesh, axis="sp")

    try:
        g = cg.extract(fn, qs, ks, vs, source="ring", mesh=mesh, comm=group)
        rep = cg.verify(fn, (qs, ks, vs), mesh,
                        coll_map={"ring_attention": "ppermute"},
                        source="ring", comm=group)
        real = traffic.note_ring

        def short(mesh_, axis, nbytes, coll, direction="fwd"):
            if coll == "ring_attention":
                nbytes -= ks.nbytes + vs.nbytes
            return real(mesh_, axis, nbytes, coll, direction)

        traffic.note_ring = short
        try:
            planted = cg.verify(fn, (qs, ks, vs), mesh,
                                coll_map={"ring_attention": "ppermute"},
                                source="ring-short")
        finally:
            traffic.note_ring = real
        return {"records": _rows(g), "issues": _issues(g.check(mesh)),
                "report": rep.to_json(), "planted": planted.to_json(),
                "shard_bytes": ks.nbytes + vs.nbytes}
    finally:
        _clean()


def ulysses(dc, q, k, v):
    """ulysses_attention on {"sp": n}: records and the verify report."""
    from ompi_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = _mesh({"sp": dist.get_world_size()})
    qs, ks, vs = _seq_shards(mesh, "sp", q, k, v)

    def fn(a, b, c):
        return ulysses_attention(a, b, c, mesh, axis="sp")

    try:
        g = cg.extract(fn, qs, ks, vs, source="ulysses", mesh=mesh,
                       comm=mesh.get_group("sp"))
        rep = cg.verify(fn, (qs, ks, vs), mesh,
                        coll_map={"ulysses": "all_to_all"},
                        source="ulysses")
        return {"records": _rows(g), "all_to_all_bytes": g.all_to_all_bytes(),
                "issues": _issues(g.check(mesh)), "report": rep.to_json()}
    finally:
        _clean()


def grad_sync(dc, mode, params, batch):
    """make_grad_sync(mode) on {"dp": n}: records (the loss average a
    control record), psum_ring_bytes and the verify report.  "bucketed"
    issues its buckets from leaf hooks inside the backward."""
    mesh = _mesh({"dp": dist.get_world_size()})
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}

    def local_loss(pp, t):
        return torch.mean((t @ pp["w"] + pp["b"]) ** 2)

    vg = overlap.make_grad_sync(mode, mesh, local_loss)
    b = torch.from_numpy(batch)
    try:
        g = cg.extract(vg, p, b, source=mode, mesh=mesh,
                       comm=mesh.get_group("dp"))
        rep = cg.verify(vg, (p, b), mesh, coll_map={"grad_sync": "psum_ring"},
                        source=mode)
        return {"records": _rows(g), "psum_ring": g.psum_ring_bytes(mesh),
                "issues": _issues(g.check(mesh)), "report": rep.to_json()}
    finally:
        _clean()


def train_step(dc, cfg_kw, tree, tokens):
    """The port's train step (grad_sync "perleaf") on {"dp": n}: the
    static grad-sync figure, the verify report, the flat parameter
    bytes, and how many records the backward issued."""
    cfg = tfm.Config(**{**cfg_kw, "dtype": getattr(torch, cfg_kw["dtype"])})
    mesh = _mesh({"dp": dist.get_world_size()})
    params = tfm.shard_params(tfm.params_from_numpy(tree, device="cpu"),
                              mesh, cfg)
    init_opt, step = tfm.make_train_step(cfg, mesh, device="cpu")
    state = init_opt(params)
    t = torch.from_numpy(tokens)
    try:
        g = cg.extract(step, params, state, t, source="train-step",
                       mesh=mesh, comm=dist.group.WORLD)
        rep = cg.verify(step, (params, state, t), mesh,
                        coll_map={"grad_sync": "psum_ring"},
                        source="train-step")
        flat = sum(int(x.numel() * x.element_size())
                   for x in optim.tree_leaves(params))
        return {"psum_ring": g.psum_ring_bytes(mesh), "flat": flat,
                "ops": sorted({r.op for r in g.records}),
                "issues": _issues(g.check(mesh)), "report": rep.to_json()}
    finally:
        _clean()


def control(dc):
    """The port's control payloads: a loss average (``overlap.pmean`` of
    a scalar) and the scheduler's MAX agreement (``DeviceComm.allreduce``
    of one row): their records, the static wire models and what the
    traffic plane charged for them."""
    mesh = _mesh({"dp": dist.get_world_size()})
    group = mesh.get_group("dp")
    agree = DeviceComm(mesh, "dp")

    def fn():
        loss = overlap.pmean(torch.tensor(1.5), group, agree.n)
        clock = agree.allreduce(torch.tensor([[float(agree.pos)]],
                                             dtype=torch.float64), MAX)
        return loss, clock

    try:
        traffic.enable()
        before = traffic.matrix.per_coll()
        g = cg.extract(fn, source="control", mesh=mesh)
        after = traffic.matrix.per_coll()
        return {"records": _rows(g), "psum_ring": g.psum_ring_bytes(mesh),
                "gather_scatter": g.gather_scatter_bytes(mesh),
                "charged": {k: after.get(k, 0) - before.get(k, 0)
                            for k in set(after) | set(before)}}
    finally:
        _clean()


def host_read(dc):
    """A scalar read in the middle of a device path is a host transfer."""
    x = torch.ones(4)

    def fn():
        y = agree_sum(x)
        if float(y.sum()) > 0:
            return y * 2
        return y

    def agree_sum(t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    g = cg.extract(fn, source="host-read", mesh=_mesh({"x": dist.get_world_size()}))
    return {"host": list(g.host_transfers),
            "issues": _issues(g.check())}


def divergent(dc, odd_rank):
    """Rank ``odd_rank`` issues one extra allreduce (on a group of its
    own, so the run completes): the between-ranks matching names it."""
    mesh = _mesh({"x": dist.get_world_size()})
    solo = dist.new_group([odd_rank])
    me = dist.get_rank()

    def fn():
        x = torch.ones(4)
        dist.all_reduce(x)
        if me == odd_rank:
            dist.all_reduce(x, group=solo)
        return x

    g = cg.extract(fn, source="divergent", mesh=mesh,
                   comm=dist.group.WORLD)
    same = cg.extract(lambda: dist.all_reduce(torch.ones(4)),
                      mesh=mesh, comm=dist.group.WORLD)
    return {"issues": _issues(g.check(mesh)),
            "divergent": list(g.divergent_ranks),
            "clean": _issues(same.check(mesh))}


def reshard(dc, axes, shape, src, dst):
    """A port ``compile_plan`` lifted by ``from_reshard_plan`` and verified
    against ``Resharder.run`` of this rank's block."""
    from ompi_tpu_torch.parallel.reshard import Resharder, compile_plan
    mesh = _mesh(dict(axes))
    plan = compile_plan(shape, np.float32, src, dst, mesh)
    g = cg.from_reshard_plan(plan)
    rs = Resharder(mesh)
    host = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    x = torch.from_numpy(np.ascontiguousarray(
        rs_block(host, mesh, src)))
    try:
        rep = cg.verify(lambda: None, (), mesh, graph=g,
                        coll_map={"reshard": "reshard"},
                        runner=lambda: rs.run(x, src, dst,
                                              global_shape=shape))
        return {"records": _rows(g), "reshard_bytes": g.reshard_bytes(),
                "plan_wire": plan.wire_bytes,
                "issues": _issues(g.check(mesh)), "report": rep.to_json()}
    finally:
        _clean()


def rs_block(host, mesh, spec):
    """This rank's block of ``host`` under ``spec`` (axes divide evenly)."""
    out = host
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]
        c = host.shape[d] // n
        pos = axis_rank(mesh, axis)
        out = np.take(out, range(pos * c, (pos + 1) * c), axis=d)
    return out
