"""The port's two-tier collectives (``ompi_tpu_torch/parallel/hierarchy``,
tuple-axis ``DeviceComm`` and ``coll/nccl``'s ``hier`` and ``hier+quant``
arms) against the JAX package's, on the CPU.

The port runs one gloo process a rank in a world of 8, an outer 2 × inner 4
mesh with the outer axis classified slow by the simulated-DCN override
(``OMPI_TPU_topo_sim_dcn_axes=outer``, the reference's
``topo_sim_dcn_axes``); the JAX package runs the same mesh on 8 virtual
CPU devices.  The same numpy inputs go to both.

* ``classify_axes``, ``hier_axes`` (its ineligibility strings word for
  word) and ``auto_levels`` over the shapes of ``tests/test_hier.py``.
* ``hier_wire_bytes`` equal over a grid, quant included.
* ``decide_mode`` with the two-tier context equal to ``coll/xla``'s over a
  grid of collectives, sizes, planes, eligibility, forces and rules rows
  (a per-entry force of an impossible hier raises in both).
* ``hierarchical_allreduce`` against the JAX one, counts 8, 7, 5 and 1 (the
  inner size 4 divides only the first): f32 to rtol 1e-6 / atol 1e-6 (the
  frameworks sum in other orders); bf16 against the f32 sum of the
  bf16-rounded inputs to 1e-2 (the stages round to bf16, 2^-8);
  ``hierarchical_psum_quant`` against the JAX one in a ``shard_map`` with
  the replication check off, within one int8 step of the largest block
  scale (the codec is the same; the f32 accumulations may round apart).
* Every flat method of a tuple-axis ``DeviceComm`` against the JAX
  ``DeviceComm`` on the same tuple: f32 to rtol 1e-6 (integer-valued
  inputs, so the sums are exact and bitwise), and the tuple refusals.
* ``coll/nccl``'s allreduce on the two-tier comm: forced hier and
  hier+quant on a count the inner size does not divide (the reference's
  ``test_non_divisible_count``: 1e-6 and 2e-2), the audit's arm counts
  and wire equal to ``hier_wire_bytes``' total, a plane rule choosing hier,
  the simulated-DCN charge (the outer bytes for hier, the DCN fraction of
  the ring for native, equal to the reference's ``ring_dcn_fraction``); a
  MAX allreduce refused the hier arm with the reference's reason; forced
  hier on a flat comm raising as ``tests/test_hier.py`` does.
"""

import itertools
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.coll import xla as j_xla  # noqa: E402
from ompi_tpu.core import var as j_var  # noqa: E402
from ompi_tpu.jaxcompat import shard_map  # noqa: E402
from ompi_tpu.parallel import DeviceComm as JDeviceComm  # noqa: E402
from ompi_tpu.parallel import classify_axes as j_classify  # noqa: E402
from ompi_tpu.parallel import make_mesh, simdcn as j_simdcn  # noqa: E402
from ompi_tpu.parallel import hierarchy as j_hier  # noqa: E402
from ompi_tpu_torch.coll import nccl as t_nccl  # noqa: E402
from ompi_tpu_torch.core import var as t_var  # noqa: E402
from ompi_tpu_torch.parallel import hierarchy as t_hier  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

AXES = {"outer": 2, "inner": 4}
TUPLE = ("outer", "inner")
pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(8)
    yield p
    p.close()


def _jsim(sim):
    """The reference's override (its variable; the port's workers read
    the environment)."""
    if sim:
        j_var.registry.set_cli("topo_sim_dcn_axes", sim)
    else:
        j_var.registry.clear_cli("topo_sim_dcn_axes")
    j_var.registry.reset_cache()
    j_simdcn.clear_cache()


@pytest.fixture
def jsim():
    yield _jsim
    _jsim(None)


# -- classification and eligibility ------------------------------------------

@pytest.mark.parametrize("shape,sim,comm", [
    ((2, 4), None, TUPLE),            # single-plane mesh
    ((2, 4), "outer", TUPLE),         # eligible
    ((4, 2), "outer", TUPLE),         # eligible
    ((2, 4), "outer", ("inner",)),    # single-axis comm
    ((2, 4), "outer,inner", TUPLE),   # no ICI axis
    ((1, 8), "outer", TUPLE)])        # degenerate outer
def test_levels_match_jax(pool, jsim, shape, sim, comm):
    axes = dict(zip(("outer", "inner"), shape))
    jsim(sim)
    jmesh = make_mesh(axes)
    comm_arg = comm if len(comm) > 1 else comm[0]
    want = {"classify": j_classify(jmesh),
            "hier_axes": list(j_hier.hier_axes(jmesh, comm_arg)),
            "auto_levels": list(j_hier.auto_levels(jmesh))}
    for got in pool.run("_torch_p13_worker:levels", axes, sim, comm_arg):
        assert got["classify"] == want["classify"]
        assert got["own"] == {a: want["classify"][a] for a in comm}
        assert got["hier_axes"] == want["hier_axes"]
        assert got["auto_levels"] == want["auto_levels"]


def test_hier_wire_bytes_match_jax():
    import torch
    n = 0
    for count, (jdt, tdt), ni, no, quant, block in itertools.product(
            (1, 7, 1024, 1 << 18, (1 << 20) + 3),
            ((np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)),
            (1, 2, 4, 8), (1, 2, 4), (False, True), (None, 64)):
        want = j_hier.hier_wire_bytes(count, jdt, ni, no, quant=quant,
                                      block=block)
        assert t_hier.hier_wire_bytes(count, tdt, ni, no, quant=quant,
                                      block=block) == want
        assert t_hier.hier_wire_bytes(count, jdt, ni, no, quant=quant,
                                      block=block) == want
        n += 1
    assert n == 5 * 2 * 4 * 3 * 2 * 2


# -- the decision with the two-tier context -----------------------------------

@pytest.fixture
def hier_rules(tmp_path):
    rows = tmp_path / "hier.txt"
    rows.write_text(textwrap.dedent("""\
        allreduce 1 0 native
        allreduce@dcn 2 0 hier
        allreduce 8 1048576 hier+quant
        grad_sync 1 0 hier
        grad_sync@ici 1 33554432 quant
        grad_sync@dcn 8 0 hier+quant
        """))
    return str(rows)


def _both(name, value):
    j_var.registry.set_cli(f"coll_xla_{name}", value)
    t_var.registry.set_cli(f"coll_nccl_{name}", value)
    for reg in (j_var, t_var):
        reg.registry.reset_cache()


def _clear(name):
    j_var.registry.clear_cli(f"coll_xla_{name}")
    t_var.registry.clear_cli(f"coll_nccl_{name}")
    for reg in (j_var, t_var):
        reg.registry.reset_cache()


def _decide(mod, platform, coll, nbytes, ndev, rules, kw):
    try:
        return mod.decide_mode(coll, nbytes, ndev, platform, rules,
                               ("native", "staged", "quant"),
                               dtype=np.float32, **kw)
    except ValueError as e:
        return ("ValueError", str(e).replace("coll_xla", "coll_nccl"))


@pytest.mark.parametrize("force", [
    None, ("allreduce_mode", "hier"), ("mode", "hier+quant"),
    ("grad_sync_mode", "hier"), ("mode", "hier")])
def test_decide_mode_with_hier_matches_jax(force, hier_rules):
    rows = {"none": ([], []),
            "hier": (j_xla._load_device_rules(hier_rules),
                     t_nccl._load_device_rules(hier_rules))}
    if force is not None:
        _both(*force)
    try:
        n = 0
        for coll, nbytes, ndev, plane, hier_ok, quant_ok, rules in \
                itertools.product(("allreduce", "grad_sync", "bcast"),
                                  (0, 1 << 10, 1 << 20, 64 << 20), (2, 8),
                                  (None, "ici", "dcn"), (False, True),
                                  (False, True), rows):
            kw = dict(plane=plane, hier_ok=hier_ok, quant_ok=quant_ok,
                      hier_why="" if hier_ok else
                      "single-plane mesh (no DCN axis among "
                      "('dpo', 'dp'))")
            want = _decide(j_xla, "tpu", coll, nbytes, ndev,
                           rows[rules][0], kw)
            got = _decide(t_nccl, "cuda", coll, nbytes, ndev,
                          rows[rules][1], kw)
            if want[0] != "ValueError":
                want = (want[0], want[1].replace("coll_xla", "coll_nccl")
                        .replace("platform=tpu", "platform=cuda"),
                        [c.replace("coll_xla", "coll_nccl") for c in want[2]])
            assert got == want, (coll, nbytes, ndev, plane, hier_ok,
                                 quant_ok, rules)
            n += 1
        assert n == 3 * 4 * 2 * 3 * 2 * 2 * 2
    finally:
        if force is not None:
            _clear(force[0])


# -- the hierarchical psum ----------------------------------------------------

def _jax_hier(jmesh, x):
    from jax.sharding import NamedSharding
    xd = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(*TUPLE)))
    return np.asarray(j_hier.hierarchical_allreduce(xd, jmesh, "inner",
                                                    "outer"))


@pytest.mark.parametrize("length", [8, 7, 5, 1])
def test_hierarchical_allreduce_matches_jax(pool, jsim, length):
    jsim("outer")
    jmesh = make_mesh(AXES)
    x = np.random.default_rng(length).standard_normal(
        (2, 4, length)).astype(np.float32)
    want = _jax_hier(jmesh, x)
    np.testing.assert_allclose(want, np.broadcast_to(x.sum((0, 1)),
                                                     x.shape),
                               rtol=1e-5, atol=1e-5)
    for got in pool.run("_torch_p13_worker:hier_psum", AXES, x):
        np.testing.assert_allclose(got, want[0, 0], rtol=1e-6, atol=1e-6)


def test_hierarchical_allreduce_bf16(pool):
    import torch
    x = np.random.default_rng(3).standard_normal((2, 4, 37)).astype(
        np.float32)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    want = xb.sum((0, 1))
    for got in pool.run("_torch_p13_worker:hier_psum", AXES, x,
                        dtype="bfloat16"):
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("length,block", [(1024, 64), (1000, 64),
                                          (7, None)])
def test_hierarchical_psum_quant_matches_jax(pool, jsim, length, block):
    jsim("outer")
    jmesh = make_mesh(AXES)
    x = np.random.default_rng(length).standard_normal(
        (2, 4, length)).astype(np.float32)

    def local(xs):
        flat = xs.reshape(-1)
        return j_hier.hierarchical_psum_quant(
            flat, "inner", "outer", 2, block=block).reshape(xs.shape)
    fn = jax.jit(shard_map(local, mesh=jmesh, in_specs=P(*TUPLE),
                           out_specs=P(*TUPLE), check_vma=False))
    want = np.asarray(fn(jnp.asarray(x)))
    exact = x.sum((0, 1))
    step = np.abs(exact).max() / 127
    for got in pool.run("_torch_p13_worker:hier_psum", AXES, x, quant=True,
                        block=block):
        np.testing.assert_allclose(got, want[0, 0], rtol=0,
                                   atol=1.01 * step)
        # and the codec's own error model against the exact sum: two
        # roundings, each within half a step of its block's scale
        assert np.abs(got - exact).max() <= 2 * step


# -- tuple-axis DeviceComm ----------------------------------------------------

COMM_CASES = [
    ("allreduce", (16, 5), (), {}),
    ("allreduce", (16, 5), (), {"op": "max"}),
    ("bcast", (8, 6), (5,), {}),
    ("allgather", (8, 2, 3), (), {}),
    ("reduce_scatter", (8, 16, 2), (), {}),
    ("alltoall", (8, 8, 2), (), {}),
    ("scan", (8, 4), (), {}),
    ("ring_shift", (16, 3), (3,), {}),
    ("push_row", (8, 4), (2, 6), {}),
]


@pytest.mark.parametrize("method,shape,args,kw", COMM_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(COMM_CASES)])
def test_tuple_device_comm_matches_jax(pool, method, shape, args, kw):
    from ompi_tpu.op import MAX
    x = np.random.default_rng(len(shape)).integers(
        -50, 50, shape).astype(np.float32)
    jmesh = make_mesh(AXES)
    jdc = JDeviceComm(jmesh, TUPLE)
    jkw = {"op": MAX} if kw.get("op") == "max" else {}
    want = np.asarray(getattr(jdc, method)(jdc.from_ranks(list(x)), *args,
                                           **jkw))
    out = pool.run("_torch_p13_worker:comm_call", AXES, TUPLE, method, x,
                   *args, **kw)
    r = shape[0] // 8
    assert sorted(pos for _, n, pos in out) == list(range(8))
    for rows, n, pos in out:
        assert n == 8
        np.testing.assert_allclose(rows, want[pos * r:(pos + 1) * r],
                                   rtol=1e-6)


def test_tuple_device_comm_refusals(pool):
    for got in pool.run("_torch_p13_worker:comm_refusals", AXES):
        assert "mesh's axis order" in got["reversed"]
        assert "'zz'" in got["unknown"] or "zz" in got["unknown"]
        assert "single named axis" in got["cart"]


# -- coll/nccl's hier arms ----------------------------------------------------

@pytest.mark.parametrize("arm,tol", [("hier", 1e-6), ("hier+quant", 2e-2)])
def test_forced_hier_arm_non_divisible(pool, arm, tol):
    """7 floats a rank over inner 4: the padded path, through the module."""
    y = (np.arange(8 * 7, dtype=np.float32).reshape(8, 7) / 7.0)
    ref = np.broadcast_to(y.sum(0, keepdims=True), y.shape)
    hw = j_hier.hier_wire_bytes(7, np.float32, ni=4, no=2,
                                quant=arm == "hier+quant")
    for out, lv, counts, charged in pool.run(
            "_torch_p13_worker:nccl_allreduce", AXES, "outer", TUPLE, y,
            force=arm):
        np.testing.assert_allclose(out, ref[:1], rtol=tol, atol=tol)
        assert lv == ["inner", "outer", "dcn"]
        assert counts[f"coll_arm_{arm}_count"] == 1
        assert counts["coll_wire_bytes"] == hw["total_bytes"]
        assert charged == []                 # the shim is off


def test_hier_audit_charges_and_rules(pool, tmp_path):
    rules = tmp_path / "rules.txt"
    rules.write_text("allreduce 1 0 native\nallreduce@dcn 1 0 hier\n")
    x = np.ones((8, 1 << 12), np.float32)
    hw = j_hier.hier_wire_bytes(1 << 12, np.float32, ni=4, no=2)
    # a plane rule decides hier; with the shim on it charges the outer
    # stage's bytes only
    for out, lv, counts, charged in pool.run(
            "_torch_p13_worker:nccl_allreduce", AXES, "outer", TUPLE, x,
            rules=str(rules), us_per_mib=1.0):
        np.testing.assert_allclose(out, 8.0, rtol=1e-6)
        assert counts["coll_arm_hier_count"] == 1
        assert charged == [hw["outer_bytes"]]
    # native, forced, on the same dcn plane: the DCN fraction of its ring
    _jsim("outer")
    try:
        frac = j_simdcn.ring_dcn_fraction(make_mesh(AXES), TUPLE)
    finally:
        _jsim(None)
    wire = 2 * 7 * (1 << 12) * 4 // 8
    for out, lv, counts, charged in pool.run(
            "_torch_p13_worker:nccl_allreduce", AXES, "outer", TUPLE, x,
            force="native", us_per_mib=1.0):
        assert counts["coll_wire_bytes"] == wire
        assert charged == [int(wire * frac)]


def test_hier_refusals(pool):
    x = np.ones((8, 4), np.float32)
    # a MAX allreduce: the hier arm refused with the reference's reason
    for got in pool.run("_torch_p13_worker:nccl_allreduce", AXES, "outer",
                        TUPLE, x, force="hier", op="max"):
        assert got[0] == "ValueError"
        assert "op max has no hierarchical reduce" in got[1]
    # no override: an all-ICI mesh, a per-entry force must fail loudly
    # (tests/test_hier.py:385-392), and a one-axis comm too
    for comm in (TUPLE, ("inner",)):
        for got in pool.run("_torch_p13_worker:nccl_allreduce", AXES, None,
                            comm, x, force="hier"):
            assert got[0] == "ValueError" and "ineligible" in got[1]
    # the decision itself (tests/test_hier.py:240-247)
    t_var.registry.set_cli("coll_nccl_allreduce_mode", "hier")
    try:
        with pytest.raises(ValueError, match="ineligible"):
            t_nccl.decide_mode("allreduce", 1 << 20, 8, "cpu", [],
                               ("native", "staged", "quant"),
                               hier_ok=False, hier_why="single-plane mesh")
    finally:
        t_var.registry.clear_cli("coll_nccl_allreduce_mode")
        t_var.registry.reset_cache()
