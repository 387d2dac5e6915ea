"""``comm.coll`` entries on device rows, shared by the port's and the JAX
package's programs of ``test_torch_coll_nccl``.

``canonical(R)`` makes every entry's input as the JAX package's canonical
(R, *elem) numpy array (row i is rank i's buffer), from a seed; ``run``
calls each entry of ``comm.coll`` on this process's rows [lo, hi) of them,
through the package's own ``dev_in`` (rows → device buffer) and
``dev_out`` (device result → this process's rows as numpy).  It imports
numpy only, so the port's programs load no JAX through it.
"""

import numpy as np

# the device component's entries, in the order run() calls them
ENTRIES = ("allreduce", "allreduce_max", "reduce", "bcast", "allgather",
           "alltoall", "reduce_scatter_block", "scan", "exscan",
           "allgatherv", "gather", "gatherv", "scatter", "scatterv",
           "alltoallv", "reduce_scatter")
# entries that only move data: held bitwise; the rest fold floats
MOVES = ("bcast", "allgather", "alltoall", "allgatherv", "gather",
         "gatherv", "scatter", "scatterv", "alltoallv", "allreduce_max")


def canonical(R: int, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    counts = [(i % 3) + 1 for i in range(R)]            # ragged, cap 4
    agv = np.zeros((R, 4), np.float32)
    for i, c in enumerate(counts):
        agv[i, :c] = f32(c)
    C = rng.integers(0, 3, (R, R))                      # alltoallv counts
    L = int(C.sum(axis=1).max()) + 1
    return {"x": f32(R, 16), "ag": f32(R, 2, 4), "a2a": f32(R, R, 3),
            "rsb": f32(R, 2 * R), "agv": agv, "counts": counts,
            "sc": f32(R, R, 2), "scv": f32(R, R, 4), "a2av": f32(R, L),
            "C": C, "rs": f32(R, 2 * R), "q": f32(R, 1000)}


def run(comm, ops, data: dict, lo: int, hi: int, dev_in, dev_out) -> dict:
    """Every entry once, on this process's rows → {entry: rows}."""
    def d(key):
        return dev_in(np.ascontiguousarray(data[key][lo:hi]))

    c, cc = comm, comm.coll
    counts, C = data["counts"], data["C"]
    out = {
        "allreduce": cc.allreduce(c, d("x"), op=ops.SUM),
        "allreduce_max": cc.allreduce(c, d("x"), op=ops.MAX),
        "reduce": cc.reduce(c, d("x"), op=ops.SUM, root=0),
        "bcast": cc.bcast(c, d("x"), root=1),
        "allgather": cc.allgather(c, d("ag")),
        "alltoall": cc.alltoall(c, d("a2a")),
        "reduce_scatter_block": cc.reduce_scatter_block(c, d("rsb")),
        "scan": cc.scan(c, d("x")),
        "exscan": cc.exscan(c, d("x")),
        "allgatherv": cc.allgatherv(c, d("agv"), counts=counts),
        "gather": cc.gather(c, d("ag"), root=0),
        "gatherv": cc.gatherv(c, d("agv"), counts=counts, root=0),
        "scatter": cc.scatter(c, d("sc"), root=1),
        "scatterv": cc.scatterv(c, d("scv"), None, [2] * len(counts),
                                root=1),
        "alltoallv": cc.alltoallv(c, d("a2av"), None, C, C.sum(axis=0)),
        "reduce_scatter": cc.reduce_scatter(c, d("rs"), None,
                                            [2] * len(counts)),
    }
    cc.barrier(c)
    return {k: dev_out(v) for k, v in out.items()}
