"""The port's MPI surface (``runtime``, ``comm``, ``coll/tuned``,
``coll/basic``, ``p2p``, ``datatype``) against the JAX package's, through
threaded ranks (``runtime.run_ranks``).

Each case runs one rank function, written against the shared MPI-style
API, under both packages on the same seeded numpy inputs: the per-rank
results must be bitwise equal (the same host algorithm runs on the same
bytes).  The host surface imports no JAX on the port's side; the JAX
package is only the reference here.
"""

import selectors
import socket
import time

import numpy as np
import pytest

from ompi_tpu import op as j_op
from ompi_tpu import runtime as j_rt
from ompi_tpu.core import var as j_var
from ompi_tpu.datatype import FLOAT32 as J_FLOAT32
from ompi_tpu.datatype import Datatype as JDatatype
from ompi_tpu.p2p import ANY_SOURCE as J_ANY
from ompi_tpu_torch import op as t_op
from ompi_tpu_torch import runtime as t_rt
from ompi_tpu_torch.core import var as t_var
from ompi_tpu_torch.datatype import FLOAT32 as T_FLOAT32
from ompi_tpu_torch.datatype import Datatype as TDatatype
from ompi_tpu_torch.p2p import ANY_SOURCE as T_ANY

# what a rank function needs of its package
JAX = {"rt": j_rt, "op": j_op, "var": j_var, "any": J_ANY,
       "dt": JDatatype, "f32": J_FLOAT32}
PORT = {"rt": t_rt, "op": t_op, "var": t_var, "any": T_ANY,
        "dt": TDatatype, "f32": T_FLOAT32}


def _both(n, make_fn):
    """Run make_fn(pkg) on n threaded ranks of each package; return the
    two per-rank result lists."""
    return (j_rt.run_ranks(n, make_fn(JAX)),
            t_rt.run_ranks(n, make_fn(PORT)))


def _assert_bitwise(ref, got):
    assert type(ref) is type(got), (type(ref), type(got))
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            _assert_bitwise(a, b)
    elif isinstance(ref, dict):
        assert ref.keys() == got.keys()
        for k in ref:
            _assert_bitwise(ref[k], got[k])
    elif isinstance(ref, np.ndarray):
        assert ref.dtype == got.dtype and ref.shape == got.shape
        assert ref.tobytes() == got.tobytes()
    else:
        assert ref == got


def _rows(seed, n, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


# -- point to point ----------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_send_recv_isend_irecv(size):
    rows = _rows(1, size, (300,))
    big = _rows(2, size, (40000,))          # past the eager limit: rndv

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            right, left = (c.rank + 1) % c.size, (c.rank - 1) % c.size
            got = np.zeros(300, np.float32)
            req = c.irecv(got, left, tag=7)
            c.isend(rows[c.rank], right, tag=7).wait()
            req.wait()
            got_big = np.zeros(40000, np.float32)
            if c.rank == 0:
                c.send(big[0], 1, tag=9)
            elif c.rank == 1:
                c.recv(got_big, 0, tag=9)
            st = c.sendrecv(rows[c.rank], right, np.zeros(300, np.float32),
                            left, sendtag=2, recvtag=2)
            return got, got_big, (st.source, st.tag, st.count)
        return fn

    _assert_bitwise(*_both(size, make))


def test_large_sendrecv_under_idle_wait():
    """Both ranks exchange 4 MB at once: fragments cross while each rank's
    waits block in its transport's idle hook."""
    big = _rows(3, 2, (1 << 20,))

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            got = np.zeros(1 << 20, np.float32)
            c.sendrecv(big[c.rank], 1 - c.rank, got, 1 - c.rank,
                       sendtag=4, recvtag=4)
            return got
        return fn

    ref, got = _both(2, make)
    _assert_bitwise(ref, got)
    _assert_bitwise(got, big[::-1])


def test_tcp_idle_wait_blocks_until_whole_frame():
    """The tcp idle hook cedes the core only for a whole frame on hand; a
    partial one blocks until more bytes land, and a queued send wakes it
    when its socket turns writable."""
    from ompi_tpu_torch.p2p import tcp

    t = tcp.TcpTransport()
    srv = socket.create_server(("127.0.0.1", 0))
    out_peer = socket.create_connection(srv.getsockname())
    rx = tcp._Conn(srv.accept()[0])
    in_peer = socket.create_connection(srv.getsockname())
    tx = tcp._Conn(in_peer)
    tx_far = srv.accept()[0]
    t._rx.append(rx)
    t._sel.register(rx.sock, selectors.EVENT_READ, ("rx", rx))
    t._tx[1] = tx
    t._sel.register(tx.sock, selectors.EVENT_READ, ("tx", tx))

    def waited(timeout):
        t0 = time.monotonic()
        t.idle_wait(timeout)
        return time.monotonic() - t0

    try:
        frame = tcp._HDR.pack(1000, 0) + bytes(1000)
        rx.inbuf.extend(frame[:500])
        assert waited(0.05) >= 0.04          # partial frame: blocks
        rx.inbuf.extend(frame[500:])
        assert waited(5.0) < 1.0             # whole frame: no sleep
        rx.inbuf.clear()
        out_peer.sendall(b"x")
        assert waited(5.0) < 1.0             # readable socket wakes it
        rx.sock.recv(16)
        tx.outbuf.append(memoryview(b"queued"))
        assert waited(5.0) < 1.0             # writable socket wakes it
        assert t._sel.get_key(tx.sock).events == selectors.EVENT_READ
        tx.outbuf.clear()
        assert waited(0.05) >= 0.04          # nothing to do: blocks
    finally:
        t._sel.close()
        for s in (srv, out_peer, rx.sock, in_peer, tx_far):
            s.close()


def test_any_source_and_probe():
    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            if c.rank == 0:
                seen = []
                for _ in range(c.size - 1):
                    st = c.probe(pkg["any"], 5)
                    buf = np.zeros(st["count"] // 8, np.int64)
                    c.recv(buf, st["source"], 5)
                    seen.append((st["source"], buf.tolist()))
                return sorted(seen)
            c.send(np.arange(c.rank + 1, dtype=np.int64) * c.rank, 0, 5)
            return c.iprobe(pkg["any"], 5)
        return fn

    _assert_bitwise(*_both(3, make))


def test_vector_datatype_pack_unpack():
    src = np.arange(32, dtype=np.float32)

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            vec = pkg["dt"].vector(count=8, blocklength=1, stride=2,
                                   base=pkg["f32"]).commit()
            if c.rank == 0:
                c.send(src, 1, tag=1, datatype=vec, count=2)
                return None
            dst = np.full(32, -1.0, np.float32)
            c.recv(dst, 0, tag=1, datatype=vec, count=2)
            return dst
        return fn

    _assert_bitwise(*_both(2, make))


# -- collectives -------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("opname", ["SUM", "MAX"])
def test_allreduce(size, opname):
    rows = _rows(3, size, (257,))

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            return c.coll.allreduce(c, rows[c.rank],
                                    op=getattr(pkg["op"], opname))
        return fn

    _assert_bitwise(*_both(size, make))


def test_allreduce_maxloc():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 5, (3, 6)).astype(np.float64)

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            pair = np.zeros(6, pkg["op"].loc_dtype(np.float64))
            pair["v"] = vals[c.rank]
            pair["i"] = c.rank
            return c.coll.allreduce(c, pair, op=pkg["op"].MAXLOC)
        return fn

    _assert_bitwise(*_both(3, make))


@pytest.mark.parametrize("coll,alg", [
    ("allreduce", "recursive_doubling"), ("allreduce", "ring"),
    ("allreduce", "rabenseifner"), ("bcast", "binomial"),
    ("bcast", "pipeline"), ("allgather", "ring"), ("allgather", "bruck"),
    ("alltoall", "pairwise"), ("reduce_scatter_block", "recursive_halving"),
])
def test_forced_tuned_algorithms(coll, alg):
    """The coll_tuned_<coll>_algorithm force picks the same algorithm in
    both packages, so the folds run in the same order."""
    size, count = 4, 1000
    rows = _rows(5, size, (count,), np.float64)

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            x = rows[c.rank]
            if coll == "allreduce":
                return c.coll.allreduce(c, x)
            if coll == "bcast":
                return c.coll.bcast(c, x.copy(), root=2)
            if coll == "allgather":
                return c.coll.allgather(c, x[:10])
            if coll == "alltoall":
                return c.coll.alltoall(c, x[:8].reshape(size, 2))
            return c.coll.reduce_scatter_block(c, x[:16])
        return fn

    name = f"coll_tuned_{coll}_algorithm"
    for reg in (j_var, t_var):
        reg.registry.set_cli(name, alg)
    try:
        _assert_bitwise(*_both(size, make))
    finally:
        for reg in (j_var, t_var):
            reg.registry.set_cli(name, "")
            reg.registry.reset_cache()


@pytest.mark.parametrize("size", [2, 4])
def test_rooted_and_vector_collectives(size):
    rows = _rows(6, size, (24,))
    counts = [i + 1 for i in range(size)]

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            x = rows[c.rank]
            red = c.coll.reduce(c, x, root=1)
            out = {"bcast": c.coll.bcast(c, x.copy(), root=size - 1),
                   # MPI defines the result at the root only
                   "reduce": red if c.rank == 1 else None,
                   "allgather": c.coll.allgather(c, x[:5]),
                   "alltoall": c.coll.alltoall(c, x[:2 * size].reshape(
                       size, 2)),
                   "reduce_scatter_block": c.coll.reduce_scatter_block(
                       c, x[:3 * size]),
                   "gather": c.coll.gather(c, x[:4], root=0),
                   "scatter": c.coll.scatter(
                       c, x[:3 * size].reshape(size, 3),
                       np.zeros(3, np.float32), root=1),
                   "allgatherv": c.coll.allgatherv(
                       c, x[:counts[c.rank]], counts=counts),
                   "scan": c.coll.scan(c, x)}
            ex = c.coll.exscan(c, x)
            out["exscan"] = ex if c.rank > 0 else None   # rank 0: undefined
            sendcounts = [(c.rank + j) % size + 1 for j in range(size)]
            recvcounts = [(j + c.rank) % size + 1 for j in range(size)]
            sendbuf = x[:sum(sendcounts)]
            out["alltoallv"] = c.coll.alltoallv(
                c, sendbuf, np.zeros(sum(recvcounts), np.float32),
                sendcounts, recvcounts)
            c.coll.barrier(c)
            return out
        return fn

    _assert_bitwise(*_both(size, make))


def test_split_and_dup():
    rows = _rows(7, 4, (16,))

    def make(pkg):
        def fn(ctx):
            c = ctx.comm_world
            sub = c.split(color=c.rank % 2, key=-c.rank)
            dup = c.dup()
            return (sub.rank, sub.size, sub.group.world_ranks,
                    sub.coll.allreduce(sub, rows[c.rank]),
                    dup.rank, dup.size,
                    dup.coll.allgather(dup, rows[c.rank][:2]))
        return fn

    _assert_bitwise(*_both(4, make))
