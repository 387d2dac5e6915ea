"""coll/quant — block-quantized device collectives (the EQuARX tier).

The port's copy of ``ompi_tpu/coll/quant.py``.  Large reductions on the
device plane are wire-bound: the native arm moves every payload at full
operand precision.  Symmetric per-block int8 quantization (EQuARX,
arXiv:2506.17615) cuts the bytes on the wire to about a quarter for f32:

  allreduce       quantize -> all_to_all of the int8 payload and scales
                  (each peer's contribution dequantized and accumulated
                  in f32) -> requantize -> all_gather -> dequantize
  reduce_scatter  the same first phase, no all_gather (the result stays
                  the f32 accumulation of the dequantized contributions)
  allgather       quantize once -> all_gather payload + scales ->
                  dequantize

Every transfer carries the int8 payload plus one scale per ``block``
elements (default 256, f32 scales): ``(1 + scale_bytes/block) / itemsize``
of the native bytes (``wire_bytes`` is the exact accounting).

Error model: one quantization step errs by at most ``amax_block / 254``
per element (round to nearest even over [-127, 127]).  The allreduce
rounds each original contribution once and the reduced chunk once more,
two roundings whatever the device count.  All-zero blocks are exact
(scale 0 maps to q 0); an outlier widens only its own block's step.

Only SUM and AVG over float operands are expressible (``op.quantizable``
is the one gate); anything else raises ``ValueError``.

Where the JAX package runs each collective as a cached ``shard_map``
program, the port issues the same NCCL collectives on the axis's process
group (gloo on the CPU tests' plane): ``all_to_all_single`` and
``all_gather_into_tensor`` of the int8 payload and of the scales, the
codec and the f32 accumulation as torch ops.  Nothing here is a kernel:
the reference wrote the codec in jnp.  With tracing on, each quantized
collective of ``QuantDeviceComm`` records the reference's span
(``quant:allreduce``, ``quant:reduce_scatter``, ``quant:allgather``)
with its EQuARX accounting (``_span_args``), under this process's world
rank.  The reference's numerics hook comes with ROADMAP P16b.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..core import var as _var
from ..op import SUM, Op, quantizable
from ..parallel.collectives import _check_backend, _group_of, _repeat_rows

_var.register("coll", "quant", "block", 256, type=int, level=3,
              help="Elements per quantization block (one scale each).")
_var.register("coll", "quant", "scale_dtype", "float32", type=str, level=4,
              help="Dtype of the per-block scales on the wire "
                   "(float32|bfloat16).")

# int8 symmetric range: round() maps to [-127, 127] so the grid is
# symmetric (no -128 asymmetry) and amax round-trips exactly
_QMAX = 127.0
_SCALE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dtype) -> str:
    """'float32', 'bfloat16', ... for a torch or numpy dtype (or name)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name if not isinstance(dtype, str) else dtype


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if _dtype_name(dtype) == "bfloat16":
        return 2
    return np.dtype(dtype).itemsize


def check_quantizable(op: Op, dtype) -> None:
    """Reject (op, dtype) combos the quantized tier cannot carry."""
    if quantizable(op, dtype):
        return
    if op.name in ("maxloc", "minloc"):
        why = "MAXLOC/MINLOC pairs carry exact indices"
    elif op.name not in ("sum", "avg"):
        why = f"op {op.name!r} does not commute with per-block rescaling"
    else:
        why = f"dtype {_dtype_name(dtype)!r} has no scale to quantize"
    raise ValueError(
        f"quantized collectives support SUM/AVG over float operands only: "
        f"{why} (op={op.name!r}, dtype={_dtype_name(dtype)})")


def _params(block, scale_dtype):
    """(block, scale dtype as a torch dtype), from the arguments or the
    ``coll_quant_*`` variables."""
    block = int(block if block is not None
                else _var.get("coll_quant_block", 256))
    if block < 1:
        raise ValueError(f"quantization block must be >= 1, got {block}")
    sdt = scale_dtype if scale_dtype is not None \
        else _var.get("coll_quant_scale_dtype", "float32")
    name = _dtype_name(sdt)
    if name not in _SCALE_DTYPES:
        raise ValueError(
            f"scale_dtype must be float32 or bfloat16, got {name}")
    return block, _SCALE_DTYPES[name]


# -- pure block codecs --------------------------------------------------------

def quantize_blocks(x: torch.Tensor, block: int, scale_dtype=None):
    """(..., L) with L % block == 0 -> (int8 (..., L), scales (..., L/block)).

    Symmetric per-block quantization: scale = amax/127 computed in f32;
    all-zero blocks get scale 0 and decode exactly to zero."""
    scale_dtype = _params(block, scale_dtype)[1]
    xb = x.reshape(x.shape[:-1] + (x.shape[-1] // block, block))
    xf = xb.float()
    amax = xf.abs().amax(dim=-1)                          # (..., nblk)
    # a true division on every device: CUDA divides by a Python scalar
    # as a product with its reciprocal, which rounds differently
    scale = amax / torch.full_like(amax, _QMAX)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8).reshape(x.shape), scale.to(scale_dtype)


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, block: int,
                      dtype=None) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`; accumulation stays in f32
    unless ``dtype`` narrows it at the end."""
    qb = q.reshape(q.shape[:-1] + (q.shape[-1] // block, block))
    x = (qb.float() * scale.float()[..., None]).reshape(q.shape)
    return x if dtype is None else x.to(dtype)


# -- the wire phases, on a process group --------------------------------------

def _bytes(t: torch.Tensor) -> torch.Tensor:
    """bf16 scales travel as bytes (every backend has uint8)."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Tiled all_to_all over dim 0: row j goes to member j, row j of the
    result came from member j."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(_bytes(out), _bytes(t), group=group)
    return out


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(_bytes(out).view(-1), _bytes(t).view(-1),
                                group=group)
    return out


def _reduce_scatter_quant(chunks: torch.Tensor, group, n: int, block: int,
                          scale_dtype) -> torch.Tensor:
    """chunks: (n, C) f32 with C % block == 0 -> (C,) f32: this member's
    fully reduced chunk (member d owns chunk d).

    The local contributions are quantized exactly once, the int8 payload
    and scales cross in one all_to_all each, and every peer's
    contribution is dequantized and accumulated in f32: one rounding on
    the data path whatever n is."""
    if n == 1:
        return chunks[0]
    q, s = quantize_blocks(chunks, block, scale_dtype)
    q, s = _all_to_all(q, group), _all_to_all(s, group)
    return torch.sum(dequantize_blocks(q, s, block), dim=0)


def _all_gather_quant(x: torch.Tensor, group, n: int, block: int,
                      scale_dtype) -> torch.Tensor:
    """x: (C,) f32 with C % block == 0 -> (n, C) f32: row j = member j's
    vector, moved over the wire as int8 + scales."""
    q, s = quantize_blocks(x, block, scale_dtype)
    if n == 1:
        return dequantize_blocks(q[None], s[None], block)
    return dequantize_blocks(_all_gather(q, group, n),
                             _all_gather(s, group, n), block)


def psum_quant(x: torch.Tensor, axis, n: int, avg: bool = False,
               block: int = None, scale_dtype=None, op: Op = None,
               mesh=None) -> torch.Tensor:
    """Block-quantized allreduce of this member's ``x`` over ``axis`` (a
    process group, or an axis name of ``mesh``) of ``n`` members: the
    gradient-sync primitive.

    quantize -> all_to_all wire phase (peer contributions dequantized and
    accumulated in f32) -> requantize -> all_gather -> dequantize.  The
    flattened tensor is zero-padded to whole (n x block) units."""
    if op is not None:
        check_quantizable(op, x.dtype)
        avg = avg or op.name == "avg"
    block, sdt = _params(block, scale_dtype)
    if n == 1:
        return x / n if avg else x
    group = _group_of(axis, mesh)
    _check_backend(x.device.type, dist.get_backend(group))
    shape, dtype = x.shape, x.dtype
    L = x.numel()
    Lpad = padded_len(L, n, block)
    flat = x.reshape(-1).float()
    if Lpad != L:
        flat = torch.nn.functional.pad(flat, (0, Lpad - L))
    acc = _reduce_scatter_quant(flat.reshape(n, Lpad // n), group, n, block,
                                sdt)
    if avg:
        acc = acc / n
    full = _all_gather_quant(acc, group, n, block, sdt)   # (n, C)
    return full.reshape(-1)[:L].reshape(shape).to(dtype)


# -- wire-byte accounting -----------------------------------------------------

def padded_len(count: int, n: int, block: int) -> int:
    """Flattened per-rank element count after padding to whole
    (n x block) units (what actually travels)."""
    unit = n * block
    return unit * max(1, math.ceil(int(count) / unit))


def wire_bytes(coll: str, count: int, n: int, dtype, block: int = None,
               scale_dtype=None) -> dict:
    """Exact per-device wire bytes of the quantized vs native arm for
    ``count`` elements of ``dtype`` (torch or numpy) over ``n`` devices.

    Ring costs: allreduce = 2(n-1) chunk transfers, reduce_scatter and
    allgather (n-1).  The quantized chunk carries the int8 payload and one
    scale per block; the native chunk full-precision elements."""
    block, sdt = _params(block, scale_dtype)
    esize = _itemsize(dtype)
    ssize = sdt.itemsize
    hops = {"allreduce": 2 * (n - 1), "reduce_scatter": n - 1,
            "allgather": n - 1}.get(coll)
    if hops is None:
        raise ValueError(f"no quantized arm for collective {coll!r}")
    chunk = padded_len(count, n, block) // n
    quant = hops * chunk * (1 + ssize / block)
    native = hops * math.ceil(int(count) / n) * esize
    return {"quant_bytes": int(round(quant)), "native_bytes": int(native),
            "ratio": quant / native if native else float("inf")}


def _span_args(wb: dict, block: int, sdt, roundings: int,
               requantize_count: int) -> dict:
    """Trace payload for one quantized execution: the EQuARX accounting
    (wire bytes, block config, how many stochastic roundings touch each
    element, whether an accumulated value is requantized)."""
    ratio = wb["ratio"]
    return {"wire_bytes": wb["quant_bytes"],
            "native_bytes": wb["native_bytes"],
            "ratio": round(ratio, 4) if math.isfinite(ratio) else None,
            "block": block, "scale_dtype": _dtype_name(sdt),
            "roundings": roundings, "requantize_count": requantize_count}


def grad_bucket_span_args(nbytes: int, n: int, dtype, block: int = None,
                          scale_dtype=None) -> dict:
    """EQuARX accounting for ONE quantized grad-sync bucket of ``nbytes``
    raw gradient bytes allreduced over ``n`` devices — the detail payload
    of parallel/overlap's per-bucket decision events.  psum_quant rounds
    each element twice (quantize + the post-accumulate requantize) and
    requantizes the accumulated value once, hence the fixed counts."""
    block, sdt = _params(block, scale_dtype)
    count = max(1, int(nbytes) // _itemsize(dtype))
    wb = wire_bytes("allreduce", count, n, dtype, block, sdt)
    return _span_args(wb, block, sdt, roundings=2, requantize_count=1)


def _span(name: str, coll: str, count: int, n: int, dtype, block: int,
          sdt, roundings: int, requantize_count: int):
    """The reference's ``quant:<coll>`` span around one quantized
    execution when tracing is on, else a null context."""
    if not trace.enabled:
        return contextlib.nullcontext()
    return trace.span(name, "quant", rank=dist.get_rank(), args=_span_args(
        wire_bytes(coll, count, n, dtype, block, sdt), block, sdt,
        roundings=roundings, requantize_count=requantize_count))


# -- the canonical-layout engine (DeviceComm's entry points) ------------------

class QuantDeviceComm:
    """Quantized collectives over a DeviceComm's axis, on its layout: each
    process holds its r rows of the canonical (R, *elem) array (reached as
    ``dc.quant``)."""

    def __init__(self, dc) -> None:
        self.dc = dc

    @staticmethod
    def _fold32(xs: torch.Tensor) -> torch.Tensor:
        # local rows fold in f32 before any wire quantization, so the r
        # co-resident ranks' contribution is exact
        return torch.sum(xs.float(), dim=0)

    @staticmethod
    def _padded(x: torch.Tensor, L: int, Lpad: int) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        if Lpad != L:
            flat = torch.nn.functional.pad(flat, (0, Lpad - L))
        return flat

    def _spc(self, name: str) -> None:
        if self.dc.spc is not None:
            self.dc.spc.inc(name)

    def allreduce(self, x: torch.Tensor, op: Op = SUM, block: int = None,
                  scale_dtype=None) -> torch.Tensor:
        """(r, *e) -> (r, *e): every row <- quantized op over all rows."""
        check_quantizable(op, x.dtype)
        block, sdt = _params(block, scale_dtype)
        dc, n = self.dc, self.dc.n
        r, elem = dc._rows(x), tuple(x.shape[1:])
        R = r * n
        L = int(np.prod(elem)) if elem else 1
        Lpad = padded_len(L, n, block)
        avg = op.name == "avg"
        self._spc("device_quant_collectives")
        # allreduce = quantized reduce_scatter ring (accumulate in f32,
        # requantize once) + quantized allgather
        with _span("quant:allreduce", "allreduce", L, n, x.dtype, block,
                   sdt, 2, 1):
            folded = self._fold32(self._padded(x, L, Lpad))
            if n == 1:
                out = folded / R if avg else folded
            else:
                acc = _reduce_scatter_quant(folded.reshape(n, Lpad // n),
                                            dc.group, n, block, sdt)
                if avg:
                    # average over CONTRIBUTIONS: R ranks in all, r of
                    # them folded locally in each process
                    acc = acc / R
                out = _all_gather_quant(acc, dc.group, n, block,
                                        sdt).reshape(-1)
        return _repeat_rows(out[:L].to(x.dtype).reshape(elem), r)

    def reduce_scatter(self, x: torch.Tensor, op: Op = SUM,
                       block: int = None, scale_dtype=None) -> torch.Tensor:
        """(r, R*b, *e) -> (r, b, *e): row i = quantized-reduced block i
        (the first wire phase alone: the f32 accumulation of the
        dequantized contributions, never requantized)."""
        check_quantizable(op, x.dtype)
        block, sdt = _params(block, scale_dtype)
        dc, n = self.dc, self.dc.n
        r = dc._rows(x)
        R = r * n
        if x.dim() < 2 or x.shape[1] % R:
            raise ValueError(
                f"reduce_scatter needs dim 1 divisible by {R} rows, "
                f"got {tuple(x.shape)}")
        b, elem = x.shape[1] // R, tuple(x.shape[2:])
        E = int(np.prod(elem)) if elem else 1
        # pad per CHUNK (a chunk = one process's r result rows) so the
        # process boundaries survive the padding
        C = r * b * E
        Cpad = block * max(1, math.ceil(C / block))
        avg = op.name == "avg"
        self._spc("device_quant_collectives")
        # the ring phase alone: one rounding an element, the accumulation
        # stays f32 (never requantized)
        with _span("quant:reduce_scatter", "reduce_scatter", R * b * E, n,
                   x.dtype, block, sdt, 1, 0):
            chunks = self._fold32(x.reshape(r, R * b * E)).reshape(n, C)
            if Cpad != C:
                chunks = torch.nn.functional.pad(chunks, (0, Cpad - C))
            acc = _reduce_scatter_quant(chunks, dc.group, n, block, sdt)
        if avg:
            acc = acc / R     # R contributions (r folded locally x n)
        return acc[:C].to(x.dtype).reshape((r, b) + elem)

    def allgather(self, x: torch.Tensor, block: int = None,
                  scale_dtype=None) -> torch.Tensor:
        """(r, b, *e) -> (r, R*b, *e): every row = concat of all rows,
        each contribution quantized exactly once on the wire."""
        check_quantizable(SUM, x.dtype)     # dtype gate only
        if x.dim() < 2:
            raise ValueError(
                f"allgather needs the canonical (R, b, *e) layout, "
                f"got shape {tuple(x.shape)}")
        block, sdt = _params(block, scale_dtype)
        dc, n = self.dc, self.dc.n
        r = dc._rows(x)
        R = r * n
        b, e = x.shape[1], tuple(x.shape[2:])
        L = b * (int(np.prod(e)) if e else 1)    # elements per rank row
        Lpad = block * max(1, math.ceil(L / block))
        self._spc("device_quant_collectives")
        flat = self._padded(x, L, Lpad).reshape(-1)      # r rows end to end
        # each contribution quantized exactly once on the wire
        with _span("quant:allgather", "allgather", L, n, x.dtype, block,
                   sdt, 1, 0):
            full = _all_gather_quant(flat.float(), dc.group, n, block, sdt)
        full = full.reshape(R, Lpad)[:, :L].to(x.dtype)
        return _repeat_rows(full.reshape((R * b,) + e), r)


__all__ = ["check_quantizable", "quantize_blocks", "dequantize_blocks",
           "psum_quant", "padded_len", "wire_bytes",
           "grad_bucket_span_args", "QuantDeviceComm"]
