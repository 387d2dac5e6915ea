"""The port's reshard (``ompi_tpu_torch/parallel/reshard.py``) and
``convert_params`` against the JAX package's, on the CPU.

Plans: the port's ``compile_plan`` and the reference's
``Resharder(mesh).plan`` (host math only: no reference plan is executed)
give the same steps, ``describe()`` strings, wire and peak bytes, shard
bytes and bound over a table covering every step of the grammar, on 1-D
meshes of 2, 4 and 8 virtual devices and two 2-D ones, including the
seven serving weights of ``tests/test_serving.py``.  One step departs:
the port's ``device_put`` gathers and slices, so its wire and peak bytes
are the port's own (checked against their closed form here).

Execution: in gloo worlds of 2 and 4 each (src, dst) pair of
``tests/test_reshard.py``'s round trip, the ``device_put`` fallback
(ragged, and forced by the peak bound) and, on a 2 × 2 mesh, the
ppermute steps, run on each rank's block; the blocks, put together,
equal the numpy source bitwise.  The expected arrays come from numpy.

``convert_params`` at ``tests/test_serving.py``'s CFG: the round trip is
bitwise, and the decode shards equal the reference's
``convert_params(…, to="decode")`` shards device by device (``wqkv``
through ``_qkv_by_heads``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.models import transformer as jax_tfm  # noqa: E402
from ompi_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from ompi_tpu.parallel.reshard import (  # noqa: E402
    Resharder as JaxResharder, compile_plan as jax_compile_plan)

from ompi_tpu_torch.models import transformer as tfm  # noqa: E402
from ompi_tpu_torch.parallel.reshard import (ReshardError,  # noqa: E402
                                             compile_plan)

import _torch_coll_worker as W  # noqa: E402
from _torch_serve_worker import block  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

CFG_KW = dict(vocab=512, d_model=128, n_layers=2, n_heads=8, head_dim=16,
              d_ff=256)
SHAPE = (64, 48)


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    devs = np.array(jax.devices()[:n]).reshape(tuple(axes.values()))
    return Mesh(devs, tuple(axes))


def _plan_cases():
    cases = []
    for n in (2, 4, 8):
        m = {"x": n}
        for src, dst in [(("x", None), (None, "x")),
                         ((None, "x"), ("x", None)),
                         (("x", None), (None, None)),
                         ((None, None), ("x", None)),
                         (("x", None), ("x", None)),
                         ((None, "x"), (None, None))]:
            cases.append((m, SHAPE, src, dst))
        cases.append((m, (7, 10), ("x", None), (None, "x")))      # ragged
    cases += [({"a": 2, "b": 2}, SHAPE, ("a", None), ("b", None)),
              ({"a": 2, "b": 2}, SHAPE, ("a", "b"), ("b", "a")),
              ({"a": 2, "b": 2}, SHAPE, (None, None), ("a", "b")),
              ({"x": 4, "y": 2}, SHAPE, (("x", "y"), None),
               (None, ("x", "y"))),
              ({"x": 4, "y": 2}, SHAPE, ("x", "y"), (None, None)),
              ({"x": 4, "y": 2}, SHAPE, (("x", "y"), None), ("x", None)),
              ({"x": 4, "y": 2}, SHAPE, (("x", "y"), None), ("y", "x"))]
    return cases


def _device_put_cost(shape, src, dst, sizes, itemsize=4):
    """The port's device_put figures in closed form for at most one
    sharded dim a side: a ring all-gather of the padded source blocks,
    then the gathered array beside the larger block."""
    def count(a):
        grp = () if a is None else a if isinstance(a, tuple) else (a,)
        return int(np.prod([sizes[x] for x in grp]))

    n_src, n_dst = [count(a) for a in src], [count(a) for a in dst]
    pad = [-(-s // n) for s, n in zip(shape, n_src)]
    src_b = itemsize * int(np.prod(pad))
    m = int(np.prod(n_src))
    full = src_b * m
    dst_b = itemsize * int(np.prod([-(-s // n)
                                    for s, n in zip(shape, n_dst)]))
    return src_b * (m - 1), full + max(src_b if m > 1 else 0, dst_b)


def _same_plan(mine, ref):
    assert mine.describe() == ref.describe()
    for name in ("src_shard_bytes", "dst_shard_bytes", "bound_bytes",
                 "dtype", "shape"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert bool(mine.fallback_reason) == bool(ref.fallback_reason)
    assert [s.axes for s in mine.steps] == [s.axes for s in ref.steps]
    assert [s.perm for s in mine.steps] == [s.perm for s in ref.steps]
    if [s.op for s in mine.steps] != ["device_put"]:
        assert mine.wire_bytes == ref.wire_bytes
        assert mine.peak_bytes == ref.peak_bytes
        assert [s.wire_bytes for s in mine.steps] == [
            s.wire_bytes for s in ref.steps]


@pytest.mark.parametrize("axes,shape,src,dst", _plan_cases())
def test_plan_equals_reference(axes, shape, src, dst):
    ref = JaxResharder(_jax_mesh(axes)).plan(shape, jnp.float32, P(*src),
                                             P(*dst))
    mine = compile_plan(shape, np.float32, src, dst, axes)
    _same_plan(mine, ref)
    if [s.op for s in mine.steps] == ["device_put"]:
        wire, peak = _device_put_cost(shape, src, dst, axes)
        assert (mine.wire_bytes, mine.peak_bytes) == (wire, peak)
        assert mine.steps[0].wire_bytes == wire


def test_plan_grammar_covered():
    ops = {s.describe().split("[")[0]
           for a, sh, src, dst in _plan_cases()
           for s in compile_plan(sh, np.float32, src, dst, a).steps}
    assert ops == {"all_to_all", "all_gather", "slice", "ppermute",
                   "device_put"}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_peak_bound_fallback_equals_reference(n):
    """factor 1.0 fits no step: both compilers replace the plan by
    device_put (the port's peak is its own, above the bound)."""
    axes = {"x": n}
    src, dst = ("x", None), (None, None)
    ref = jax_compile_plan(SHAPE, np.float32, P(*src), P(*dst),
                           _jax_mesh(axes), peak_factor=1.0)
    mine = compile_plan(SHAPE, np.float32, src, dst, axes, peak_factor=1.0)
    _same_plan(mine, ref)
    assert mine.describe() == ["device_put"] and "peak" in \
        mine.fallback_reason
    assert (mine.wire_bytes, mine.peak_bytes) == _device_put_cost(
        SHAPE, src, dst, axes)
    assert mine.peak_bytes > mine.bound_bytes


def test_bf16_plan_equals_reference():
    axes = {"x": 4}
    ref = JaxResharder(_jax_mesh(axes)).plan(SHAPE, jnp.bfloat16,
                                             P("x", None), P(None, "x"))
    mine = compile_plan(SHAPE, torch.bfloat16, ("x", None), (None, "x"),
                        axes)
    _same_plan(mine, ref)
    assert mine.dtype == "bfloat16"


def test_plan_rejects_bad_specs():
    with pytest.raises(ReshardError):
        compile_plan(SHAPE, np.float32, ("nope", None), (None, None),
                     {"x": 8})
    with pytest.raises(ReshardError):
        compile_plan(SHAPE, np.float32, (None, None), ("x", "x"), {"x": 8})


# tests/test_serving.py:189-202: the serving weights' plans, pinned
SERVE_PINS = {"embed": ["all_to_all[tp:0->1]"], "wo": ["all_to_all[tp:0->1]"],
              "w_down": ["all_to_all[tp:0->1]"], "wqkv": [], "w_gate": [],
              "w_up": [], "attn_norm": [], "final_norm": []}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_serving_weight_plans(n):
    jcfg = jax_tfm.Config(dtype=jnp.float32, **CFG_KW)
    cfg = tfm.Config(dtype=torch.float32, **CFG_KW)
    d, h = CFG_KW["d_model"], CFG_KW["n_heads"] * CFG_KW["head_dim"]
    shapes = {"embed": (CFG_KW["vocab"], d), "wo": (h, d),
              "w_down": (CFG_KW["d_ff"], d), "wqkv": (d, 3 * h),
              "w_gate": (d, CFG_KW["d_ff"]), "w_up": (d, CFG_KW["d_ff"]),
              "attn_norm": (d,), "final_norm": (d,)}
    jrs = JaxResharder(_jax_mesh({"tp": n}))
    jt, jd = jax_tfm.param_specs(jcfg), jax_tfm.decode_param_specs(jcfg)
    mt, md = tfm.param_specs(cfg), tfm.decode_param_specs(cfg)
    for name, shape in shapes.items():
        pick = lambda tree: tree.get(name, tree["layers"][0].get(name))
        ref = jrs.plan(shape, jnp.float32, pick(jt), pick(jd))
        mine = compile_plan(shape, np.float32, pick(mt), pick(md),
                            {"tp": n})
        _same_plan(mine, ref)
        assert mine.describe() == SERVE_PINS[name], name
        if not SERVE_PINS[name]:
            assert mine.wire_bytes == 0


# -- execution in gloo worlds -------------------------------------------------

@pytest.fixture(scope="module")
def pool2():
    p = W.Pool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = W.Pool(4)
    yield p
    p.close()


ROUND_TRIP = [(("x", None), (None, "x")), ((None, "x"), ("x", None)),
              (("x", None), (None, None)), ((None, None), ("x", None))]


def _assemble(results, i, host, sizes, dst):
    """Every rank's block of case i, checked against numpy's, put back
    together into the whole array."""
    full = np.full(host.size, np.nan, np.float32)
    where = np.arange(host.size).reshape(host.shape)
    for r in results:
        got, coords = r[i]["out"], r[i]["coords"]
        np.testing.assert_array_equal(got, block(host, sizes, coords, dst))
        full[block(where, sizes, coords, dst).reshape(-1)] = got.reshape(-1)
    return full.reshape(host.shape)


def _check(results, cases, host, sizes, steps=None):
    for i, (src, dst) in enumerate(cases):
        full = _assemble(results, i, host, sizes, dst)
        np.testing.assert_array_equal(full, host)
        for r in results:
            row = r[i]
            assert row["fresh"]
            assert row["arms"] == len(row["steps"])
            assert row["wire"] == row["plan_wire"]
            if steps is not None:
                assert row["steps"] == steps[i], (src, dst)


@pytest.mark.parametrize("world", [2, 4])
def test_round_trip_bitwise(world, pool2, pool4):
    pool = {2: pool2, 4: pool4}[world]
    host = np.arange(64 * world * 6, dtype=np.float32).reshape(
        8 * world, 48)
    axes = {"x": world}
    res = pool.run("_torch_serve_worker:reshard_cases", axes, host,
                   ROUND_TRIP)
    _check(res, ROUND_TRIP, host, axes,
           [["all_to_all[x:0->1]"], ["all_to_all[x:1->0]"],
            ["all_gather[x@0]"], ["slice[x@0]"]])
    for r in res:
        assert r[-1] == {"plans": 4, "plan_hits": 4}


@pytest.mark.parametrize("world", [2, 4])
def test_device_put_bitwise(world, pool2, pool4):
    """The fallback, ragged (7 rows over the ranks) and forced by a
    peak bound of 1.0 on an even layout."""
    pool = {2: pool2, 4: pool4}[world]
    axes = {"x": world}
    host = np.arange(70, dtype=np.float32).reshape(7, 10) - 35.5
    cases = [(("x", None), (None, "x")), ((None, "x"), ("x", None))]
    res = pool.run("_torch_serve_worker:reshard_cases", axes, host, cases)
    _check(res, cases, host, axes, [["device_put"]] * 2)
    even = np.arange(8 * world * 12, dtype=np.float32).reshape(8 * world,
                                                               12)
    cases = [(("x", None), (None, None)), (("x", None), (None, "x"))]
    res = pool.run("_torch_serve_worker:reshard_cases", axes, even, cases,
                   peak_factor=1.0)
    _check(res, cases, even, axes, [["device_put"]] * 2)
    wire, _ = _device_put_cost(even.shape, *cases[0], axes)
    assert res[0][0]["wire"] == wire


def test_two_axis_steps_bitwise(pool4):
    axes = {"a": 2, "b": 2}
    host = np.arange(64 * 48, dtype=np.float32).reshape(64, 48)
    cases = [(("a", None), ("b", None)), (("a", "b"), ("b", "a")),
             (("b", None), ("a", None)), (("b", "a"), ("a", "b")),
             (("a", "b"), (None, None)), ((None, None), ("a", "b")),
             ((None, "a"), ("b", None))]
    res = pool4.run("_torch_serve_worker:reshard_cases", axes, host, cases)
    _check(res, cases, host, axes,
           [["ppermute[a~b@0]"], ["ppermute[a@0~b@1]"], ["ppermute[b~a@0]"],
            ["ppermute[b@0~a@1]"], ["all_gather[a@0]", "all_gather[b@1]"],
            ["slice[a@0]", "slice[b@1]"], ["slice[b@0]", "all_gather[a@1]"]])
    bf = pool4.run("_torch_serve_worker:reshard_cases", axes,
                   host / 7, cases[:2], dtype="bfloat16")
    want = torch.from_numpy(host / 7).bfloat16().float().numpy()
    _check(bf, cases[:2], want, axes)


TUPLE_CASES = [((("a", "b"), None), (None, None)),
               ((None, None), (("a", "b"), None)),
               ((("a", "b"), None), (None, ("a", "b"))),
               ((("b", "a"), None), (None, None)),
               ((("b", "a"), None), (("a", "b"), None)),
               (("a", "b"), (("a", "b"), None)),
               ((("a", "b"), None), ("b", "a")),
               ((("b", "a"), None), (None, ("b", "a")))]


def test_tuple_axes_refused(pool4):
    """A dim sharded over a tuple of axes now runs: the blocks, put
    together, equal the numpy source bitwise and the steps are the
    reference's plan's (a tuple in either axis order, the all-to-all over
    the product group included).  A tuple-sharded dim its product does
    not divide is refused, naming the reason."""
    axes = {"a": 2, "b": 2}
    host = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    jmesh = _jax_mesh(axes)
    want = [jax_compile_plan(host.shape, np.float32, src, dst,
                             jmesh).describe() for src, dst in TUPLE_CASES]
    res = pool4.run("_torch_serve_worker:reshard_cases", axes, host,
                    TUPLE_CASES)
    _check(res, TUPLE_CASES, host, axes, want)
    msgs = pool4.run("_torch_serve_worker:reshard_tuple_refused", axes,
                     np.zeros((6, 3), np.float32))
    assert all(m is not None and "must divide" in m for m in msgs)


# -- convert_params against the reference -------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tfm.Config(dtype=jnp.float32, **CFG_KW)
    jparams = jax_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _jax_decode_shards(jcfg, jparams, n):
    """Every device's shard of each leaf after the reference's
    convert_params(to="decode"), in mesh order."""
    mesh = jax_make_mesh({"tp": n}, devices=jax.devices()[:n])
    dec = jax_tfm.convert_params(jax_tfm.shard_params(jparams, mesh, jcfg),
                                 mesh, jcfg, to="decode")
    order = list(mesh.devices.flat)

    def shards(a):
        got = sorted(a.addressable_shards, key=lambda s: order.index(
            s.device))
        return [np.asarray(s.data) for s in got]

    out = {"embed": shards(dec["embed"]),
           "final_norm": shards(dec["final_norm"])}
    for i, layer in enumerate(dec["layers"]):
        out.update({f"layers.{i}.{k}": shards(v) for k, v in layer.items()})
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_convert_params(world, weights, pool2, pool4):
    jcfg, jparams, tree = weights
    pool = {2: pool2, 4: pool4}[world]
    res = pool.run("_torch_serve_worker:convert", {"tp": world},
                   dict(CFG_KW), tree)
    ref = _jax_decode_shards(jcfg, jparams, world)
    for rank, r in enumerate(res):
        for name, leaf in r["train"].items():
            np.testing.assert_array_equal(r["back"][name], leaf)
        for name, shards in ref.items():
            want = shards[rank]
            if name.endswith("wqkv"):
                full = torch.from_numpy(np.concatenate(shards, axis=1))
                cut = tfm._qkv_by_heads(full, world).numpy()
                want = np.split(cut, world, axis=1)[rank]
            np.testing.assert_array_equal(r["decode"][name], want, name)
