"""The port's block-quantized tier (``ompi_tpu_torch/coll/quant.py``)
against the JAX package's ``coll/quant``, on the CPU.

* The codecs: the same numpy inputs give bitwise-equal int8 payloads and
  scales (f32 and bf16 scales) and dequantized values, for unit-scale
  blocks, all-zero blocks, an outlier block and subnormal blocks.
* ``psum_quant`` and ``QuantDeviceComm``'s allreduce, reduce_scatter and
  allgather in gloo worlds of 2 and 4 processes holding R = 8 rows,
  against the JAX package's on 2 and 4 virtual devices holding the same 8
  rows: every output element within one int8 step of its block's scale in
  the JAX result (the last quantization's step, amax / 127; the inputs are
  the same, so a difference can only come from a sum taken in another
  order landing on another rounding), and the reference's own bounds
  against the exact f32 result (``tests/test_quant_coll.py``: 1e-2 of the
  largest value, 3e-2 in bf16, SNR >= 30 dB).
* ``wire_bytes`` and ``padded_len`` equal the JAX package's.
* The cases of the reference's ``TestQuantDecision`` through
  ``coll/nccl.decide_mode``, which gives the JAX package's decisions.
* The guard rails: non-SUM/AVG ops and non-float dtypes raise.

XLA's CPU backend flushes subnormal floats to zero; PyTorch's CPU kernels
keep them unless ``torch.set_flush_denormal(True)``.  The subnormal case is
held bitwise with flushing on, as XLA runs, and without it to the
reference's own bound (finite, within 1e-38 of the exact sum).
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ompi_tpu import op as j_ops  # noqa: E402
from ompi_tpu.coll import quant as j_quant  # noqa: E402
from ompi_tpu.coll import xla as j_xla  # noqa: E402
from ompi_tpu.core import var as j_var  # noqa: E402
from ompi_tpu.parallel import DeviceComm, make_mesh  # noqa: E402
from ompi_tpu_torch import op as t_ops  # noqa: E402
from ompi_tpu_torch.coll import nccl as t_nccl  # noqa: E402
from ompi_tpu_torch.coll import quant as t_quant  # noqa: E402
from ompi_tpu_torch.core import var as t_var  # noqa: E402

import _torch_coll_worker as W  # noqa: E402

R = 8
pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def _rows(count, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (R, count)).astype(np.float32)


# -- the codecs ------------------------------------------------------------------

def _codec_input(case):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    if case == "zero blocks":
        x[:, :512] = 0.0
    elif case == "outlier":
        x[0, 10] = 1.0e4
    elif case == "subnormal":
        x[1] = 1e-40
        x[2, :256] = -3e-39
    return x


def _bits(a) -> np.ndarray:
    """A numpy or torch array's bytes as unsigned integers (bf16 too)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _codecs_both(x, block, scale_dtype):
    jq, js = j_quant.quantize_blocks(jnp.asarray(x), block, getattr(
        jnp, scale_dtype))
    jb = j_quant.dequantize_blocks(jq, js, block)
    tq, ts = t_quant.quantize_blocks(torch.from_numpy(x), block, scale_dtype)
    tb = t_quant.dequantize_blocks(tq, ts, block)
    return (np.asarray(jq), np.asarray(js), np.asarray(jb)), (tq, ts, tb)


@pytest.mark.parametrize("case,block,scale_dtype", list(itertools.product(
    ("unit", "zero blocks", "outlier", "subnormal"), (64, 256),
    ("float32", "bfloat16"))))
def test_codecs_bitwise(case, block, scale_dtype):
    x = _codec_input(case)
    flush = case == "subnormal"
    if flush:
        torch.set_flush_denormal(True)        # as XLA's CPU backend runs
    try:
        (jq, js, jb), (tq, ts, tb) = _codecs_both(x, block, scale_dtype)
    finally:
        if flush:
            torch.set_flush_denormal(False)
    assert tq.dtype == torch.int8 and tq.shape == x.shape
    assert str(ts.dtype) == f"torch.{scale_dtype}"
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(_bits(tb), _bits(jb))
    if case == "zero blocks":
        assert not tb[:, :512].any()
    if flush:
        # subnormals kept: finite and within the reference's bound
        tq, ts = t_quant.quantize_blocks(torch.from_numpy(x), block,
                                         scale_dtype)
        back = t_quant.dequantize_blocks(tq, ts, block).numpy()
        assert np.isfinite(back).all()
        sub = np.concatenate([back[1] - x[1], back[2, :256] - x[2, :256]])
        assert np.abs(sub).max() <= 1e-38


def test_quantize_roundtrip_error_model():
    """The reference's error model: |x - deq(q(x))| <= amax/250 + 1e-7 a
    block."""
    x = np.random.default_rng(9).standard_normal((4, 1024)).astype(
        np.float32)
    q, s = t_quant.quantize_blocks(torch.from_numpy(x), 256)
    err = (t_quant.dequantize_blocks(q, s, 256).numpy() - x).__abs__()
    amax = np.abs(x).reshape(4, 4, 256).max(axis=-1)
    assert (err.reshape(4, 4, 256).max(axis=-1) <= amax / 250.0 + 1e-7).all()


# -- wire accounting -------------------------------------------------------------

@pytest.mark.parametrize("coll", ["allreduce", "reduce_scatter",
                                  "allgather"])
def test_wire_bytes_and_padded_len_match_jax(coll):
    for count, n, block, (jdt, tdt), sdt in itertools.product(
            (1, 64, 1000, 1 << 18, 3 << 20), (1, 2, 4, 8), (32, 64, 256),
            ((np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
             (np.float16, torch.float16)), ("float32", "bfloat16")):
        want = j_quant.wire_bytes(coll, count, n, jdt, block, sdt)
        assert t_quant.wire_bytes(coll, count, n, tdt, block, sdt) == want
        assert t_quant.wire_bytes(coll, count, n, np.dtype(jdt), block,
                                  sdt) == want
        assert (t_quant.padded_len(count, n, block)
                == j_quant.padded_len(count, n, block))
    wb = t_quant.wire_bytes(coll, 1 << 18, 8, torch.float32)
    assert wb["ratio"] <= 0.3 and wb["quant_bytes"] < wb["native_bytes"]
    with pytest.raises(ValueError):
        t_quant.wire_bytes("alltoall", 1024, 8, torch.float32)


# -- guard rails -----------------------------------------------------------------

@pytest.mark.parametrize("op", ["MAX", "MIN", "PROD", "BAND", "MAXLOC",
                                "MINLOC"])
def test_reject_non_sum_ops(op):
    with pytest.raises(ValueError):
        j_quant.check_quantizable(getattr(j_ops, op), np.float32)
    with pytest.raises(ValueError, match="SUM/AVG"):
        t_quant.check_quantizable(getattr(t_ops, op), torch.float32)


@pytest.mark.parametrize("np_dtype,t_dtype", [
    (np.int32, torch.int32), (np.int8, torch.int8), (np.bool_, torch.bool)])
def test_reject_non_float_dtypes(np_dtype, t_dtype):
    for dt in (np_dtype, t_dtype):
        with pytest.raises(ValueError, match="no scale"):
            t_quant.check_quantizable(t_ops.SUM, dt)
        assert not t_ops.quantizable(t_ops.SUM, dt)
    assert t_ops.quantizable(t_ops.AVG, torch.bfloat16)
    assert t_ops.quantizable(t_ops.SUM, jnp.bfloat16)


def test_bad_scale_dtype():
    with pytest.raises(ValueError):
        j_quant._params(256, "float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_quant._params(256, "float16")
    with pytest.raises(ValueError, match="block"):
        t_quant._params(0, None)


# -- the decision layer (the reference's TestQuantDecision cases) ----------------

# (name, port and JAX settings without their prefix, rules file rows,
#  (collective, bytes a rank, devices, dtype))
DECISIONS = [
    ("default is exact", {}, "", ("allreduce", 64 * 4, 8, np.float32)),
    ("per-entry force", {"allreduce_mode": "quant"}, "",
     ("allreduce", 64 * 4, 8, np.float32)),
    ("blanket on, float", {"COLL_QUANT": "on"}, "",
     ("allreduce", 64 * 4, 8, np.float32)),
    ("blanket on, int rides exact", {"COLL_QUANT": "on"}, "",
     ("allreduce", 16 * 4, 8, np.int32)),
    ("rules respect the size floor", {}, "allreduce 1 0 quant\n",
     ("allreduce", 64 * 4, 8, np.float32)),
    ("rules pick quant over the floor",
     {"quant_min_bytes": "1024", "quant_block": "64"},
     "allreduce 1 0 quant\n", ("allreduce", 2048, 8, np.float32)),
    ("padding past native vetoes", {"quant_min_bytes": "1024"},
     "allreduce 1 0 quant\n", ("allreduce", 2048, 8, np.float32)),
    ("blanket off vetoes rules",
     {"quant_min_bytes": "1024", "COLL_QUANT": "off"},
     "allreduce 1 0 quant\n", ("allreduce", 2048, 8, np.float32)),
    ("grad_sync buckets by rule", {}, "grad_sync 2 1048576 quant\n",
     ("grad_sync", 4 << 20, 4, np.float32)),
]


def _setting(name):
    if name == "COLL_QUANT":
        return name, name
    if name.startswith("quant_"):
        return f"coll_{name}", f"coll_{name}"
    return f"coll_xla_{name}", f"coll_nccl_{name}"


@pytest.mark.parametrize("name,settings,rules,call", DECISIONS,
                         ids=[d[0] for d in DECISIONS])
def test_decision_matches_jax(name, settings, rules, call, tmp_path):
    path = tmp_path / "rules.txt"
    path.write_text(rules)
    coll, nbytes, ndev, np_dtype = call
    t_dtype = torch.from_numpy(np.zeros(1, np_dtype)).dtype
    try:
        for key, value in settings.items():
            j_name, t_name = _setting(key)
            j_var.registry.set_cli(j_name, value)
            t_var.registry.set_cli(t_name, value)
        for reg in (j_var, t_var):
            reg.registry.reset_cache()
        rows_j = j_xla._load_device_rules(str(path)) if rules else []
        rows_t = t_nccl._load_device_rules(str(path)) if rules else []
        quant_ok = np.issubdtype(np_dtype, np.floating)
        allowed = ("native", "staged", "quant")
        want = j_xla.decide_mode(coll, nbytes, ndev, "tpu", rows_j, allowed,
                                 quant_ok=quant_ok, dtype=np_dtype,
                                 op=j_ops.SUM)
        got = t_nccl.decide_mode(coll, nbytes, ndev, "cuda", rows_t, allowed,
                                 quant_ok=quant_ok, dtype=t_dtype,
                                 op=t_ops.SUM)
        swap = lambda r: r.replace("coll_xla", "coll_nccl").replace(
            "platform=tpu", "platform=cuda")
        assert got == (want[0], swap(want[1]), [swap(c) for c in want[2]])
        expect = {"default is exact": "native", "per-entry force": "quant",
                  "blanket on, float": "quant",
                  "blanket on, int rides exact": "native",
                  "rules respect the size floor": "native",
                  "rules pick quant over the floor": "quant",
                  "padding past native vetoes": "native",
                  "blanket off vetoes rules": "native",
                  "grad_sync buckets by rule": "quant"}[name]
        assert got[0] == expect
    finally:
        for key in settings:
            j_name, t_name = _setting(key)
            j_var.registry.clear_cli(j_name)
            t_var.registry.clear_cli(t_name)
        for reg in (j_var, t_var):
            reg.registry.reset_cache()


def test_per_entry_force_bad_dtype_raises():
    t_var.registry.set_cli("coll_nccl_allreduce_mode", "quant")
    t_var.registry.reset_cache()
    try:
        with pytest.raises(ValueError, match="no scale"):
            t_nccl.decide_mode("allreduce", 64, 8, "cuda", [],
                               ("native", "staged", "quant"),
                               quant_ok=False, dtype=torch.int32)
    finally:
        t_var.registry.clear_cli("coll_nccl_allreduce_mode")
        t_var.registry.reset_cache()


# -- the collectives, in gloo worlds ---------------------------------------------

@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    pool = W.Pool(n)
    jdc = DeviceComm(make_mesh({"x": n}, devices=jax.devices()[:n]), "x")
    yield n, pool, jdc
    pool.close()


def _jax(jdc, method, host, dtype=None, **kw):
    x = jnp.asarray(host)
    if dtype is not None:
        x = x.astype(dtype)
    x = jax.device_put(x, jdc.sharding())
    return np.asarray(jax.device_get(getattr(jdc.quant, method)(x, **kw)),
                      np.float32)


def _gather(results, n):
    """The processes' rows of the result (each process its R/n rows), as
    the global (R, ...) array."""
    return np.concatenate([r[0] for r in results], axis=0)


def _within_one_step(got, want, block):
    """|got - want| <= amax / 127 of want's block, each element, over the
    flattened rows padded to whole blocks."""
    flat_g = got.reshape(got.shape[0], -1)
    flat_w = want.reshape(want.shape[0], -1)
    L = flat_w.shape[1]
    pad = -L % block
    w = np.pad(flat_w, ((0, 0), (0, pad))).reshape(R, -1, block)
    g = np.pad(flat_g, ((0, 0), (0, pad))).reshape(R, -1, block)
    step = np.abs(w).max(axis=-1, keepdims=True) / 127.0
    return np.all(np.abs(g - w) <= step * (1 + 1e-5) + 1e-7)


def _rel_err(got, ref):
    scale = float(np.max(np.abs(ref))) or 1.0
    return float(np.max(np.abs(got.astype(np.float64) - ref))) / scale


def _snr_db(got, ref):
    noise = float(np.sum((got.astype(np.float64) - ref) ** 2))
    return 10 * np.log10(float(np.sum(ref.astype(np.float64) ** 2))
                         / max(noise, 1e-30))


# (name, method, input count a row, kwargs, block, bound against exact)
CASES = [
    ("allreduce b64", "allreduce", 4096, {"block": 64}, 64, 1e-2),
    ("allreduce b256", "allreduce", 4096, {}, 256, 1e-2),
    ("allreduce ragged", "allreduce", 1000, {}, 256, 1e-2),
    ("allreduce avg", "allreduce", 1024, {"op": "avg"}, 256, 1.5e-2),
    ("allreduce bf16 scales", "allreduce", 2048,
     {"scale_dtype": "bfloat16"}, 256, 2e-2),
    ("reduce_scatter", "reduce_scatter", R * 512, {}, 256, 1e-2),
    ("allgather", "allgather", 256, {}, 256, 1e-2),
]


@pytest.mark.parametrize("name,method,count,kw,block,bound", CASES,
                         ids=[c[0] for c in CASES])
def test_quant_device_comm_matches_jax(world, name, method, count, kw,
                                       block, bound):
    n, pool, jdc = world
    host = _rows(count, seed=count + block)
    if method == "allgather":
        host = host.reshape(R, 1, count)
    jkw = dict(kw)
    if "op" in jkw:
        jkw["op"] = j_ops.AVG
    want = _jax(jdc, method, host, **jkw)
    res = pool.run("_torch_sync_worker:quant_call", method, host, **kw)
    got = _gather(res, n)
    assert all(c == 1 for _, c in res)       # device_quant_collectives
    assert got.shape == want.shape
    assert _within_one_step(got, want, block)
    exact = {"allreduce": lambda h: np.broadcast_to(
                 h.sum(0, dtype=np.float32)
                 / (R if kw.get("op") == "avg" else 1), h.shape),
             "reduce_scatter": lambda h: h.sum(0, dtype=np.float32).reshape(
                 R, -1),
             "allgather": lambda h: np.broadcast_to(h.reshape(1, -1),
                                                    (R, h.size))}[method]
    ref = exact(host)
    assert _rel_err(got.reshape(ref.shape), ref) <= bound
    if method == "allreduce" and "op" not in kw:
        assert _snr_db(got[0], ref[0]) >= 30.0


def test_quant_bf16_operands_match_jax(world):
    n, pool, jdc = world
    host = _rows(2048, seed=1)
    want = _jax(jdc, "allreduce", host, jnp.bfloat16)
    got = _gather(pool.run("_torch_sync_worker:quant_call", "allreduce",
                           host, dtype="bfloat16"), n)
    ref = host.sum(0, dtype=np.float32)
    # bf16's own 8-bit mantissa on top of the two roundings (the
    # reference's 3e-2), and at most one bf16 step apart from the JAX
    # result, which rounds the same f32 values to bf16
    assert _rel_err(got[0], ref) <= 3e-2
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)


def test_psum_quant_matches_jax(world):
    """The gradient-sync primitive inside the test's own shard_map (the
    reference's test_psum_quant_inside_shard_map), at n devices, against
    the port's psum_quant on each process's vector."""
    from jax.sharding import PartitionSpec as P

    from ompi_tpu.jaxcompat import shard_map

    n, pool, jdc = world
    host = np.random.default_rng(6).standard_normal((n, 300)).astype(
        np.float32)

    def body(x):
        return j_quant.psum_quant(x[0], "x", n, avg=True, block=64)[None]

    fn = jax.jit(shard_map(body, mesh=jdc.mesh, in_specs=P("x"),
                           out_specs=P("x")))
    want = np.asarray(jax.device_get(fn(jnp.asarray(host))))
    got = np.stack(pool.run("_torch_sync_worker:psum_quant", host, True, 64))
    assert got.shape == want.shape
    step = np.abs(want).max() / 127.0
    assert np.abs(got - want).max() <= step
    ref = host.mean(axis=0, dtype=np.float32)
    for row in got:
        assert _rel_err(row, ref) <= 1e-2


def test_engine_rejects_int_input_and_bad_op(world):
    n, pool, _ = world
    for method, x, kw in (
            ("allreduce", np.ones((R, 256), np.int32), {"dtype": "int32"}),
            ("reduce_scatter", np.ones((R, R * 4), np.int32),
             {"dtype": "int32"}),
            ("allreduce", np.ones((R, 256), np.float32), {"op": "max"})):
        for msg in pool.run("_torch_sync_worker:quant_raises", method, x,
                            **kw):
            assert msg is not None and "SUM/AVG" in msg
