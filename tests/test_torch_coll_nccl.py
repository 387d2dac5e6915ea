"""The port's device collective component, ``coll/nccl``, against the JAX
package's ``coll/xla``.

* ``decide_mode`` returns the JAX package's (arm, reason, chain) over a
  grid of collectives × per-rank bytes × device counts × platforms ×
  planes × force variables × rules files (``DEVICE_RULES.txt`` and
  temporary ones with plane rows), ``"cuda"`` standing for the JAX
  package's non-CPU platform and ``coll_nccl_*`` for ``coll_xla_*``.
* The rules source the port lacks raises, naming its slice; the quant,
  bidir and hierarchical arms are decided as the JAX package decides
  them.
* ``tpurun -np 2 --device-plane cpu``: ``comm.coll.<entry>`` on device
  rows selects ``nccl`` (``xla`` there) and gives the JAX package's
  per-rank results and arm counts; the staged arm runs across processes.
* The single-card regime (one process, R = 8 rows) beside the JAX
  package's single controller (8 devices): default and forced-staged
  arms, results, arm counts and staged bytes.
* The refusals: a threaded rank cannot join the device plane or attach a
  mesh, and without CUDA ``init_device_plane(ctx)`` raises unless the CPU
  plane was asked for.
"""

import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ompi_tpu.coll import xla as j_xla
from ompi_tpu.core import var as j_var
from ompi_tpu_torch.coll import nccl as t_nccl
from ompi_tpu_torch.core import var as t_var

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
sys.path.insert(0, TESTS)
import _torch_nccl_prog as prog  # noqa: E402

SIZES = (0, 1 << 10, 1 << 20, 31 << 20, 64 << 20)


def _map(text: str) -> str:
    """The port's names for the JAX package's: variables and platform."""
    return text.replace("coll_xla", "coll_nccl").replace("platform=tpu",
                                                         "platform=cuda")


def _set(name: str, value: str) -> None:
    j_var.registry.set_cli(f"coll_xla_{name}", value)
    t_var.registry.set_cli(f"coll_nccl_{name}", value)


def _clear(names) -> None:
    for n in names:
        j_var.registry.clear_cli(f"coll_xla_{n}")
        t_var.registry.clear_cli(f"coll_nccl_{n}")
    for reg in (j_var, t_var):
        reg.registry.clear_cli("COLL_QUANT")
        reg.registry.reset_cache()


@pytest.fixture
def rules_files(tmp_path):
    plane = tmp_path / "plane.txt"
    plane.write_text(textwrap.dedent("""\
        # plain and plane-keyed rows, native/staged and the arms the port
        # lacks (vetoed with quant_ok/hier_ok false)
        allreduce 1 0 staged
        allreduce 2 1048576 native
        allreduce@dcn 1 0 staged
        allreduce@ici 8 33554432 quant
        alltoall 1 0 native
        alltoall@ici 2 1024 staged
        bcast 1 1024 staged
        allgather@dcn 2 0 hier
        reduce_scatter_block 1 0 quant
        scan 1 1048576 staged
        alltoallv 2 0 staged
        gatherv@dcn 1 0 native
        """))
    plain = tmp_path / "plain.txt"
    plain.write_text("reduce 1 0 staged\nscatter 8 0 staged\n"
                     "allgatherv 1 32505856 staged\n")
    return {"none": None, "DEVICE_RULES": os.path.join(REPO,
                                                       "DEVICE_RULES.txt"),
            "plane": str(plane), "plain": str(plain)}


@pytest.mark.parametrize("force", [
    None, ("allreduce_mode", "staged"), ("mode", "staged"),
    ("mode", "native"), ("alltoall_mode", "native"),
    ("COLL_QUANT", "off")])
def test_decide_mode_matches_jax(force, rules_files):
    # each package parses the files with its own grammar module
    rows_j = {k: j_xla._load_device_rules(p) if p else []
              for k, p in rules_files.items()}
    rows_t = {k: t_nccl._load_device_rules(p) if p else []
              for k, p in rules_files.items()}
    if force is not None:
        if force[0] == "COLL_QUANT":
            for reg in (j_var, t_var):
                reg.registry.set_cli("COLL_QUANT", force[1])
                reg.registry.reset_cache()
        else:
            _set(*force)
    try:
        n = 0
        for coll, nbytes, ndev, (j_plat, t_plat), plane, rules in \
                itertools.product(j_xla._DECIDED, SIZES, (1, 2, 8),
                                  (("cpu", "cpu"), ("tpu", "cuda")),
                                  ("ici", "dcn"), rules_files):
            for allowed in (("native", "staged"), ("native",)):
                kw = dict(quant_ok=False, hier_ok=False,
                          hier_why="single-axis comm (no inner/outer "
                                   "levels)", plane=plane)
                ref = j_xla.decide_mode(coll, nbytes, ndev, j_plat,
                                        rows_j[rules], allowed, **kw)
                got = t_nccl.decide_mode(coll, nbytes, ndev, t_plat,
                                         rows_t[rules], allowed, **kw)
                want = (ref[0], _map(ref[1]), [_map(c) for c in ref[2]])
                assert got == want, (coll, nbytes, ndev, t_plat, plane,
                                     rules, allowed)
                n += 1
        assert n == 15 * 5 * 3 * 2 * 2 * 4 * 2
    finally:
        _clear(["allreduce_mode", "mode", "alltoall_mode"])


def test_rules_files_parse_alike(rules_files, tmp_path):
    for path in rules_files.values():
        if path:
            assert (t_nccl._load_device_rules(path)
                    == j_xla._load_device_rules(path))
    bad = tmp_path / "bad.txt"
    bad.write_text("allreduce@nvlink 1 0 native\n")
    with pytest.raises(ValueError, match="nvlink"):
        t_nccl._load_device_rules(str(bad))


@pytest.mark.parametrize("arm,slice_", [
    ("quant", "P8"), ("hier", "P13"), ("hier+quant", "P13"),
    ("bidir", "P9")])
def test_lacking_arms_raise_naming_their_slice(arm, slice_):
    """Every arm the JAX package runs now runs in the port, brought by the
    slice ``slice_`` names (quant with P8, bidir with P9, hier and
    hier+quant with P13): a per-entry force gives the JAX package's
    decision.  The hierarchical arms are gated by the comm's two-tier
    context: forced on an eligible comm they are picked, forced on a
    one-axis comm they raise the JAX package's ValueError (ineligible),
    never native; the module that runs them is held in
    ``tests/test_torch_hier.py``."""
    coll = "collmm" if arm == "bidir" else "allreduce"
    allowed = (("native", "bidir") if arm == "bidir"
               else ("native", "staged", "quant"))
    hier = arm in ("hier", "hier+quant")
    _set(f"{coll}_mode", arm)
    try:
        if hier:
            with pytest.raises(ValueError, match="ineligible"):
                t_nccl.decide_mode("allreduce", 4096, 2, "cuda", [],
                                   allowed, quant_ok=True, hier_ok=False,
                                   hier_why="single-axis comm")
        want = j_xla.decide_mode(coll, 4096, 2, "tpu", [], allowed,
                                 quant_ok=arm != "bidir", dtype=np.float32,
                                 plane="dcn" if hier else None,
                                 hier_ok=hier)
        got = t_nccl.decide_mode(coll, 4096, 2, "cuda", [], allowed,
                                 quant_ok=arm != "bidir", dtype=np.float32,
                                 plane="dcn" if hier else None,
                                 hier_ok=hier)
        assert got == (want[0], _map(want[1]), want[2])
        assert got[0] == arm
    finally:
        _clear([f"{coll}_mode"])


def test_learned_rules_raise_naming_p18():
    t_var.registry.set_cli("coll_nccl_rules", "learned")
    try:
        with pytest.raises(NotImplementedError, match="P18"):
            t_nccl.decide_mode("allreduce", 4096, 2, "cuda", [],
                               ("native", "staged"))
    finally:
        t_var.registry.clear_cli("coll_nccl_rules")


# -- programs under tpurun ---------------------------------------------------

PROGRAM = """
    import json
    import sys

    import numpy as np

    sys.path.insert(0, {tests!r})
    import _torch_nccl_prog as prog

    PKG, R_PER, OUT = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if PKG == "port":
        import torch

        from ompi_tpu_torch import op as ops
        from ompi_tpu_torch import runtime
        from ompi_tpu_torch.core import var
        from ompi_tpu_torch.parallel import (attach_mesh, init_device_plane,
                                             make_mesh)
    else:
        from ompi_tpu import op as ops
        from ompi_tpu import runtime
        from ompi_tpu.core import var
        from ompi_tpu.parallel import (attach_mesh, init_device_plane,
                                       make_mesh)

    ctx = runtime.init()
    init_device_plane(ctx)
    comm = ctx.comm_world
    if PKG == "port":
        # a device tensor on a communicator with no mesh is refused
        try:
            comm.coll.allreduce(comm, torch.ones(2, 4))
            raise SystemExit("a device tensor reached the host algorithms")
        except TypeError as exc:
            assert "attach_mesh" in str(exc), exc
        mesh = make_mesh({{"x": ctx.size}})
    else:
        import jax
        mesh = make_mesh({{"x": len(jax.devices())}})
    attach_mesh(comm, mesh, "x")
    dc = comm.device_comm
    R = R_PER * ctx.size
    data = prog.canonical(R)
    lo, hi = ctx.rank * R_PER, (ctx.rank + 1) * R_PER
    if PKG == "port":
        dev_in = lambda a: torch.from_numpy(a).to(dc.device)
        dev_out = lambda t: t.cpu().numpy()
    else:
        dev_in, dev_out = dc.from_local, dc.to_local
    KEYS = ("coll_arm_native_count", "coll_arm_staged_count",
            "coll_arm_quant_count", "device_stage_out_bytes",
            "coll_staged_fallbacks")
    res = prog.run(comm, ops, data, lo, hi, dev_in, dev_out)
    counts = {{k: ctx.spc._v.get(k, 0) for k in KEYS}}
    info = {{"counts": counts,
             "providers": sorted({{comm.coll.provider(e) for e in
                                  prog.ENTRIES if e != "allreduce_max"}})}}
    if PKG == "port" and ctx.size > 1:
        # the staged arm across processes (the JAX package's needs one
        # controller): alltoall's own CPU default, below 32 MB a rank
        var.registry.set_override("coll_nccl_alltoall_mode", "")
        before = dict(ctx.spc._v)
        got = dev_out(comm.coll.alltoall(comm, dev_in(data["a2a"][lo:hi])))
        want = np.swapaxes(data["a2a"], 0, 1)[lo:hi]
        assert np.array_equal(got, want)
        info["staged_a2a"] = {{k: ctx.spc._v.get(k, 0) - before.get(k, 0)
                              for k in KEYS}}
    if PKG == "port" and ctx.size > 1:
        # device tensors through the host p2p: staged explicitly and
        # counted, a strided datatype packed and unpacked on the device
        from ompi_tpu_torch.datatype import FLOAT32, Datatype
        right, left = (ctx.rank + 1) % ctx.size, (ctx.rank - 1) % ctx.size
        before = dict(ctx.spc._v)
        mine = dev_in(data["x"][lo:hi])
        got = torch.zeros_like(mine)
        req = comm.irecv(got, left, tag=3)
        comm.send(mine, right, tag=3)
        req.wait()
        assert torch.equal(got, dev_in(data["x"][(lo - R_PER) % R:][:R_PER]))
        vec = Datatype.vector(count=4, blocklength=1, stride=2,
                              base=FLOAT32).commit()
        strided = torch.full((16,), -1.0)
        req = comm.irecv(strided, left, tag=4, datatype=vec, count=2)
        comm.send(mine.reshape(-1)[:16], right, tag=4, datatype=vec,
                  count=2)
        req.wait()
        src = data["x"][(lo - R_PER) % R].reshape(-1)[:16]
        want = np.full(16, -1.0, np.float32)
        idx = [0, 2, 4, 6, 7, 9, 11, 13]      # the extent is 7 floats
        want[idx] = src[idx]
        assert np.array_equal(strided.numpy(), want), strided
        info["p2p_staged"] = {{k: ctx.spc._v.get(k, 0) - before.get(k, 0)
                              for k in ("device_stage_out_bytes",
                                        "device_stage_in_bytes")}}
    # the quant arm, forced: both packages run it on the same rows
    force = "coll_nccl_" if PKG == "port" else "coll_xla_"
    before = dict(ctx.spc._v)
    var.registry.set_override(force + "allreduce_mode", "quant")
    res["allreduce_quant"] = dev_out(comm.coll.allreduce(
        comm, dev_in(data["q"][lo:hi])))
    var.registry.reset_cache()
    info["quant_counts"] = {{k: ctx.spc._v.get(k, 0) - before.get(k, 0)
                            for k in KEYS + ("coll_wire_bytes",)}}
    if PKG == "port":
        # a forced hier on this one-axis comm: the JAX package's
        # ineligibility, never a silent native
        var.registry.set_override("coll_nccl_allreduce_mode", "hier")
        try:
            comm.coll.allreduce(comm, dev_in(data["x"][lo:hi]))
            raise SystemExit("a forced hier ran")
        except ValueError as exc:
            assert "ineligible: single-axis comm" in str(exc), exc
        var.registry.reset_cache()
    if R_PER > 1:
        # the single-card regime: every entry again on the staged arm
        before = dict(ctx.spc._v)
        var.registry.set_override(force + "mode", "staged")
        staged = prog.run(comm, ops, data, lo, hi, dev_in, dev_out)
        info["staged_counts"] = {{k: ctx.spc._v.get(k, 0) - before.get(k, 0)
                                  for k in KEYS}}
        res.update({{"staged_" + k: v for k, v in staged.items()}})
    np.savez(f"{{OUT}}/{{PKG}}_{{ctx.rank}}.npz", **res)
    with open(f"{{OUT}}/{{PKG}}_{{ctx.rank}}.json", "w") as fh:
        json.dump(info, fh)
    runtime.finalize()
"""


def _tpurun(tmp_path, pkg, np_, r_per, mca=()):
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(PROGRAM.format(tests=TESTS)))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if pkg == "jax":
        env.pop("JAX_PLATFORMS", None)      # the launcher sets the plane
        env["XLA_FLAGS"] = ""
    tool = "ompi_tpu_torch" if pkg == "port" else "ompi_tpu"
    extra = [a for name, val in mca for a in ("--mca", name, val)]
    r = subprocess.run(
        [sys.executable, "-m", f"{tool}.tools.tpurun", "-np", str(np_),
         "--timeout", "100", "--device-plane", "cpu", *extra, str(script),
         pkg, str(r_per), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert r.returncode == 0, (pkg, r.stdout[-3000:], r.stderr[-3000:])
    out = []
    for rank in range(np_):
        with open(tmp_path / f"{pkg}_{rank}.json") as fh:
            info = json.load(fh)
        out.append((dict(np.load(tmp_path / f"{pkg}_{rank}.npz")), info))
    return out


def _hold(ref: dict, got: dict) -> None:
    """Per entry: bitwise where data only moves, 1e-6 for f32 sums."""
    assert ref.keys() == got.keys()
    for k in ref:
        a, b = ref[k], got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.replace("staged_", "") in prog.MOVES or k.startswith("staged_"):
            # the staged arm folds with the same numpy call in both
            assert a.tobytes() == b.tobytes(), k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_two_process_component_matches_jax(tmp_path):
    """Both packages' programs under tpurun -np 2 on the same rows.  Dense
    alltoall is forced native in both: the JAX package's CPU default puts
    it on the staged arm, which its multi-process plane cannot fetch; the
    port's staged arm runs it across processes (checked against numpy)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    ref = _tpurun(jdir, "jax", 2, 1,
                  mca=[("coll_xla_alltoall_mode", "native")])
    got = _tpurun(tdir, "port", 2, 1,
                  mca=[("coll_nccl_alltoall_mode", "native")])
    for (jres, jinfo), (tres, tinfo) in zip(ref, got):
        _hold(jres, tres)
        assert jinfo["providers"] == ["xla"]
        assert tinfo["providers"] == ["nccl"]
        assert jinfo["counts"] == tinfo["counts"]
        assert tinfo["counts"]["coll_arm_native_count"] == len(prog.ENTRIES)
        # the forced quant arm: one count and the same modeled wire bytes
        assert jinfo["quant_counts"] == tinfo["quant_counts"]
        assert tinfo["quant_counts"]["coll_arm_quant_count"] == 1
        assert tinfo["staged_a2a"]["coll_arm_staged_count"] == 1
        assert tinfo["staged_a2a"]["device_stage_out_bytes"] == 2 * 3 * 4
        # one 16-float row, then 8 floats of the strided type, each way
        assert tinfo["p2p_staged"] == {"device_stage_out_bytes": 64 + 32,
                                       "device_stage_in_bytes": 64 + 32}


def test_single_card_regime_matches_single_controller(tmp_path):
    """One process holding R = 8 rows beside the JAX package's single
    controller over 8 devices: the default arms (alltoall staged on the
    CPU platform, all else native) and every entry forced staged."""
    import jax

    from ompi_tpu import op as j_ops
    from ompi_tpu import runtime as j_rt
    from ompi_tpu.parallel import attach_mesh, make_mesh

    R = 8
    data = prog.canonical(R)
    keys = ("coll_arm_native_count", "coll_arm_staged_count",
            "coll_arm_quant_count", "device_stage_out_bytes",
            "coll_staged_fallbacks")

    def fn(ctx):
        comm = ctx.comm_world
        attach_mesh(comm, make_mesh({"x": R}), "x")
        dc = comm.device_comm
        dev_out = lambda a: np.asarray(jax.device_get(a))
        res = prog.run(comm, j_ops, data, 0, R, dc.from_local, dev_out)
        counts = {k: ctx.spc._v.get(k, 0) for k in keys}
        before = dict(ctx.spc._v)
        j_var.registry.set_override("coll_xla_allreduce_mode", "quant")
        res["allreduce_quant"] = dev_out(comm.coll.allreduce(
            comm, dc.from_local(data["q"])))
        j_var.registry.reset_cache()
        quant = {k: ctx.spc._v.get(k, 0) - before.get(k, 0)
                 for k in keys + ("coll_wire_bytes",)}
        before = dict(ctx.spc._v)
        j_var.registry.set_override("coll_xla_mode", "staged")
        staged = prog.run(comm, j_ops, data, 0, R, dc.from_local, dev_out)
        res.update({"staged_" + k: v for k, v in staged.items()})
        return res, {"counts": counts, "quant_counts": quant,
                     "staged_counts": {k: ctx.spc._v.get(k, 0) - before.get(k, 0)
                                       for k in keys}}

    try:
        jres, jinfo = j_rt.run_ranks(1, fn, timeout=240)[0]
    finally:
        j_var.registry.reset_cache()
    (tres, tinfo), = _tpurun(tmp_path, "port", 1, R)
    # forced quant: the single controller quantizes across its 8 devices,
    # the single card folds its 8 rows in f32 and quantizes nothing
    want = np.broadcast_to(data["q"].sum(0, dtype=np.float32), (R, 1000))
    np.testing.assert_allclose(tres.pop("allreduce_quant"), want, rtol=1e-6,
                               atol=1e-6)
    got = jres.pop("allreduce_quant")
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    _hold(jres, tres)
    assert tinfo["providers"] == ["nccl"]
    assert jinfo["counts"] == tinfo["counts"]
    assert tinfo["counts"]["coll_arm_staged_count"] == 1        # alltoall
    assert jinfo["staged_counts"] == tinfo["staged_counts"]
    for info in (jinfo, tinfo):
        assert info["quant_counts"]["coll_arm_quant_count"] == 1
        assert info["quant_counts"]["coll_arm_native_count"] == 0
    assert tinfo["quant_counts"]["coll_wire_bytes"] == 0     # n = 1
    assert tinfo["staged_counts"]["coll_arm_native_count"] == 0
    assert tinfo["staged_counts"]["device_stage_out_bytes"] > 0


def test_threaded_ranks_cannot_join_the_device_plane():
    from ompi_tpu_torch import runtime
    from ompi_tpu_torch.parallel import attach_mesh, init_device_plane

    def fn(ctx):
        assert ctx.shares_process
        with pytest.raises(RuntimeError, match="one process per rank"):
            init_device_plane(ctx, device="cpu")
        with pytest.raises(RuntimeError, match="one process per rank"):
            attach_mesh(ctx.comm_world, None, "x")
        return True

    assert runtime.run_ranks(2, fn) == [True, True]


def test_no_cuda_plane_raises_unless_cpu_was_asked():
    import torch
    import torch.distributed as dist

    from ompi_tpu_torch import runtime
    from ompi_tpu_torch.parallel import init_device_plane

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")

    def fn(ctx):
        assert not ctx.shares_process
        with pytest.raises(RuntimeError, match="CUDA"):
            init_device_plane(ctx)
        return dist.is_initialized()

    assert runtime.run_ranks(1, fn) == [False]
