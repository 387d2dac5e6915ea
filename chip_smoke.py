#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi) and properties;
  2. build   — nvcc builds every kernel under ompi_tpu_torch/csrc/; the
               ptxas report of every kernel is read (registers, spills and
               serialised wgmma: either fails) and the bf16 forward and
               backward tiles (rows, threads, shared memory) are printed;
  3. kernels — each kernel against its plain PyTorch version on the card:
               K1 over K1_CASES and the merge contract, K2 and K3 over
               BWD_CASES row by row (each case also shows that the check
               rejects a planted fault on the kernel's own last tile), and
               flash_mha's gradients through autograd against autograd
               through the dense attention_reference;
  4. flash_attention — K4 against its plain version over K4_CASES and
               K4_VIEWS (strided (b, s, h, d) views; each case also shows
               that the check rejects a planted fault on its last BQ rows);
               SDPA's top-left causal alignment for s_q != s_k checked;
               flash_attention at full flagship width, (4, 2048, 16, 128)
               bf16 causal and not, and q (4, 1024, 16, 128) against that
               k/v: each call checked against the plain version and SDPA,
               exactly one K4 and no K1-K3 launch per call, and one
               profiled call holding exactly one device kernel (K4, no
               copy); CUDA-event medians of K4 on folded inputs, the entry
               point on (b, s, h, d), the plain version and SDPA, and a
               torch.profiler breakdown;
  5. forward path — the flagship forward at full flagship_config() width,
               batch 4 x 2048, weights from torch.Generator().manual_seed(0):
               logits checked, K1 launches counted (exactly n_layers per
               forward, no K4 launch), 4 requests answered greedily by
               full-context recompute, and the flash logits held against
               attn="dense";
  6. forward numbers — CUDA-event medians of K1, its plain version, the
               SDPA yardstick and one forward, as JSON lines, and a
               torch.profiler breakdown of one forward's device time;
  7. train path — make_train_step at full width, batch 4 x (2048 + 1),
               remat "dots", AdamW: K1/K2/K3/K4 launches per step counted
               exactly (12/6/6/0), a finite loss that falls over six steps on one
               batch, and attn="dense" from the same weights (losses and
               first-step gradients held to stated bounds, no K1/K2/K3
               launch);
  8. train numbers — CUDA-event medians of K2, K3, their plain versions,
               flash_mha's backward beside SDPA's backward; the train
               step's ms, tokens/s, MFU and peak memory for remat
               none/dots/full and attn="dense"; a torch.profiler breakdown
               of one step, whose K1/K2/K3/K4 launches must be 12/6/6/0.
The last lines are the kernels JSON object, the nvidia-smi line and
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

# Tolerances of the kernel-vs-plain checks, on o/l over rows that see a key
# (elementwise, rtol = atol): f32 takes the same FMA arithmetic in another
# order; bf16 rounds p to bf16 at tile-dependent running maxima (the kernel
# tiles 128 kv columns, 64 at d 256; the plain version 128).  m must agree
# to M_TOL * max|s|.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
M_TOL = 1e-5
# Flash vs dense logits at full width, bf16: relative RMS difference.  Each
# bf16 path rounds scores or probabilities in other places (dense rounds the
# scores themselves to bf16), and each sits ~1.5e-2 from the f32 forward
# at six layers; 4e-2 leaves room for two such independent errors.
FLASH_VS_DENSE_RMS = 4e-2

# (name, dtype, causal, bh, s_q, s_k, d, q_offset, kv_offset)
K1_CASES = [
    ("f32 dense d64", "float32", False, 4, 256, 256, 64, 0, 0),
    ("f32 causal d128", "float32", True, 4, 256, 256, 128, 0, 0),
    ("f32 ragged d64", "float32", True, 3, 77, 77, 64, 0, 0),
    ("f32 d256 sq!=sk", "float32", False, 2, 96, 160, 256, 0, 0),
    ("bf16 dense d64", "bfloat16", False, 4, 256, 256, 64, 0, 0),
    ("bf16 causal d128", "bfloat16", True, 4, 256, 256, 128, 0, 0),
    ("bf16 sq!=sk causal", "bfloat16", True, 4, 128, 320, 128, 192, 0),
    ("bf16 ragged s=200", "bfloat16", True, 4, 200, 200, 128, 0, 0),
    ("bf16 ragged d80", "bfloat16", False, 2, 131, 97, 80, 0, 0),
    ("bf16 d256", "bfloat16", True, 2, 192, 192, 256, 0, 0),
    ("bf16 hop fully visible", "bfloat16", True, 4, 256, 256, 128, 256, 0),
    ("bf16 hop invisible", "bfloat16", True, 4, 256, 256, 128, 0, 256),
    ("bf16 hop partly masked", "bfloat16", True, 4, 256, 256, 128, 0, 32),
    ("f32 hop partly masked", "float32", True, 4, 256, 256, 64, 96, 160),
    # the bf16 tile's edges: BQ = BK = 128 (d <= 128), 64 (d 256)
    ("bf16 s=127 (tile-1)", "bfloat16", True, 4, 127, 127, 128, 0, 0),
    ("bf16 s=129 (tile+1)", "bfloat16", True, 4, 129, 129, 128, 0, 0),
    ("bf16 bh=1 sq=129 sk=127", "bfloat16", False, 1, 129, 127, 128, 0, 0),
    ("bf16 d64 sq=127 sk=129", "bfloat16", True, 2, 127, 129, 64, 0, 0),
    ("bf16 d256 s=65 (tile+1)", "bfloat16", True, 2, 65, 65, 256, 0, 0),
    ("bf16 d256 s=63 (tile-1)", "bfloat16", False, 2, 63, 63, 256, 0, 0),
    ("bf16 hop offsets off the tile", "bfloat16", True, 2, 200, 300, 128,
     77, 13),
    ("bf16 hop off the tile, kv past", "bfloat16", True, 2, 129, 127, 128,
     300, 45),
    ("bf16 flagship shape", "bfloat16", True, 64, 2048, 2048, 128, 0, 0),
]
PATH_CASE = "bf16 flagship shape"

# K2/K3 against their plain versions, row by row (q rows of dq, kv rows of
# dk and dv): |kernel - plain| <= BWD_TOL * max |plain| over the row
# + BWD_ATOL * max |plain| over the tensor.  Per row, because under causal
# masking the rows' gradients shrink down the sequence (the first rows hold
# the tensor's max, the last are ~100x smaller), so a bound on the global
# max would not see a wrong tile near the end.  f32 runs the same FMA
# arithmetic in another order (~1e-6 of a row); bf16 rounds p and ds to
# bf16 from scores summed in another order and rounds the results to bf16
# (one bf16 step is 2^-8 = 3.9e-3 of an element).  BWD_ATOL covers rows
# that are zero up to rounding: dq's first row under causal masking, where
# p = 1 and dp = delta (~1e-7 of the max).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_ATOL = 1e-5
# Every case also plants a fault in the kernel's result, PLANTED_ERR off on
# the last quarter of the live rows and on the kernel's last tile of them
# (K3's q tile for dq, K2's kv tile for dk and dv, from flash_bwd_tile), and
# requires the check to reject both.  Live rows are those a gradient can
# reach: under top-left causal masking kv rows at or past s_q see no query,
# so dk and dv are zero there and a scaled zero is no fault.
PLANTED_ERR = 0.1
# K4 against its plain version: elementwise TOL on the normalised output,
# and a planted fault (PLANTED_ERR on the last BQ rows, the kernel's q
# tile: 128 rows in bf16 at d <= 128, 64 at d 256, F32_TILE_ROWS in f32)
# that the check must reject.  q is drawn at Q_SCALE times unit scale: scores of std ~2, a
# peaked softmax as trained models have, so the outputs are O(1) and a 10%
# fault stands above the elementwise bound, where on the ~0.1 outputs of a
# flat softmax it would not.
Q_SCALE = 2.0
# (name, q dtype, k/v dtype, causal, b, h, s_q, s_k, d)
K4_CASES = [
    ("f32 dense d64", "float32", "float32", False, 2, 2, 256, 256, 64),
    ("f32 causal d128", "float32", "float32", True, 2, 2, 256, 256, 128),
    ("f32 ragged causal s=77", "float32", "float32", True, 1, 3, 77, 77, 64),
    ("f32 causal sq>sk d256", "float32", "float32", True, 2, 1, 320, 128,
     256),
    ("f32 causal sq<sk", "float32", "float32", True, 2, 2, 128, 320, 64),
    ("bf16 dense d64", "bfloat16", "bfloat16", False, 2, 2, 256, 256, 64),
    ("bf16 causal d128", "bfloat16", "bfloat16", True, 2, 2, 256, 256, 128),
    ("bf16 ragged causal s=200", "bfloat16", "bfloat16", True, 2, 2, 200,
     200, 128),
    ("bf16 ragged s=77 d80", "bfloat16", "bfloat16", False, 3, 2, 77, 77,
     80),
    ("bf16 causal d256", "bfloat16", "bfloat16", True, 1, 2, 192, 192, 256),
    ("bf16 causal sq>sk", "bfloat16", "bfloat16", True, 2, 2, 320, 128, 128),
    ("bf16 causal sq<sk", "bfloat16", "bfloat16", True, 2, 2, 128, 320, 128),
    ("bf16 dense sq<sk ragged", "bfloat16", "bfloat16", False, 2, 2, 131,
     320, 128),
    ("mixed bf16 q, f32 k/v", "bfloat16", "float32", True, 2, 2, 256, 256,
     128),
    ("bf16 causal s=129 (tile+1) b=h=1", "bfloat16", "bfloat16", True, 1, 1,
     129, 129, 128),
    ("bf16 dense s=127 (tile-1)", "bfloat16", "bfloat16", False, 2, 3, 127,
     127, 128),
    ("bf16 causal sq=129 sk=127", "bfloat16", "bfloat16", True, 2, 2, 129,
     127, 128),
    ("bf16 causal d256 s=65 (tile+1)", "bfloat16", "bfloat16", True, 1, 2,
     65, 65, 256),
]
# K4 on (b, s, h, d) views as a model passes them, read in place: (name,
# layout, dtype, causal, b, h, s, d).  "packed qkv": q, k and v sliced from
# one (b, s, 3, h, d) tensor; "transposed": (b, h, s, d) tensors seen as
# (b, s, h, d).
K4_VIEWS = [
    ("bf16 packed qkv causal", "packed qkv", "bfloat16", True, 2, 4, 300,
     128),
    ("bf16 packed qkv d80", "packed qkv", "bfloat16", False, 2, 2, 129, 80),
    ("bf16 transposed causal", "transposed", "bfloat16", True, 2, 4, 257,
     128),
    ("f32 packed qkv causal", "packed qkv", "float32", True, 2, 2, 200, 64),
]
F32_TILE_ROWS = 32       # the float32 loops' tile: K1/K4's q tile
                         # (csrc/flash_fwd.cuh), K2's kv and K3's q tile
# flash_attention at full flagship width: (name, causal, s_q) against k/v
# of the flagship's sequence, batch BATCH, its heads and head_dim, bf16.
K4_PATH = [("causal", True, 2048), ("not causal", False, 2048),
           ("cross s_q 1024", False, 1024)]
# (name, dtype, causal, bh, s_q, s_k, d)
BWD_CASES = [
    ("f32 dense d64", "float32", False, 4, 256, 256, 64),
    ("f32 causal d128", "float32", True, 4, 256, 256, 128),
    ("f32 ragged causal d64", "float32", True, 3, 77, 77, 64),
    ("f32 d256 sq!=sk", "float32", False, 2, 96, 160, 256),
    ("bf16 dense d64", "bfloat16", False, 4, 256, 256, 64),
    ("bf16 causal d128", "bfloat16", True, 4, 256, 256, 128),
    ("bf16 sq!=sk d128", "bfloat16", False, 4, 128, 320, 128),
    ("bf16 ragged s=200", "bfloat16", True, 4, 200, 200, 128),
    ("bf16 ragged d80", "bfloat16", False, 2, 131, 97, 80),
    ("bf16 d256 causal", "bfloat16", True, 2, 192, 192, 256),
    # the Hopper kernels' edges (K2: 128 kv rows a block, 64 q rows a step;
    # K3: 128 q rows a block, 64 kv rows a step), d padded to D = 64 or 128
    ("bf16 causal s=127 (tile-1)", "bfloat16", True, 4, 127, 127, 128),
    ("bf16 causal s=129 (tile+1)", "bfloat16", True, 4, 129, 129, 128),
    ("bf16 causal s=255", "bfloat16", True, 4, 255, 255, 128),
    ("bf16 causal d64 s=255", "bfloat16", True, 4, 255, 255, 64),
    ("bf16 causal d80 s=200", "bfloat16", True, 4, 200, 200, 80),
    ("bf16 causal sq<sk", "bfloat16", True, 4, 128, 320, 128),
    ("bf16 causal sq>sk", "bfloat16", True, 4, 320, 128, 128),
    ("bf16 causal sq<sk ragged d64", "bfloat16", True, 2, 129, 257, 64),
    ("bf16 causal sq>sk ragged d80", "bfloat16", True, 2, 257, 129, 80),
    ("bf16 flagship shape", "bfloat16", True, 64, 2048, 2048, 128),
]
# flash_mha's gradients against autograd through the dense reference: f32
# elementwise to 2e-4 (rtol = atol, the figure of tests/test_ops.py); bf16
# at the path's shape against the dense f32 gradients of the same inputs,
# as a relative RMS: the flash path rounds o, p and ds to bf16 (2^-8 each)
# and 1e-2 leaves room for a few such roundings.
GRAD_TOL_F32 = 2e-4
GRAD_RMS_BF16 = 1e-2
# (dtype, (b, s, h, d), causal cases): a moderate f32 size, and the path's
GRAD_CASES = [("float32", (2, 512, 4, 64), (False, True)),
              ("bfloat16", (4, 2048, 16, 128), (True,))]
# The train path, flash against attn="dense" from the same weights and
# batch, bf16: the first three losses to 1e-2 relative, and the first
# step's gradients, all leaves together, to a relative RMS of 0.1.  The
# dense path rounds the scores and the softmax itself to bf16, so its
# forward's logits sit ~1.9e-2 (RMS) from f32 (phase 4 measures it);
# a gradient through six such layers takes a few times that.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_RMS = 0.1
TRAIN_STEPS = 6          # on one repeated batch: the loss must fall
TIMED_STEPS, WARMUP_STEPS = 10, 2
BATCH = 4

# How the profile groups kernels by name (first match wins).
KERNEL_CLASSES = [
    ("K4 attention_sm90", ("attention_sm90", "attention_f32")),
    ("K1 partials_sm90", ("partials_sm90", "partials_f32")),
    ("K2 dkdv", ("dkdv_sm90", "dkdv_kernel")),
    ("K3 dq", ("dq_sm90", "dq_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copies and casts", ("copy_kernel", "bfloat16_copy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
]

# A kernel's time is the median of 20 samples of KERNEL_REPS launches in
# a row: a sub-millisecond kernel timed one launch at a time would also
# count the host's gap before the launch.
KERNEL_REPS = 10

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """The median over n samples of the ms per call of ``reps`` calls in a
    row between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_k1(torch, attention, case):
    """One K1-vs-plain comparison; returns the max abs error of o/l."""
    name, dtype, causal, bh, s_q, s_k, d, q_off, kv_off = case
    gen = torch.Generator(device="cuda").manual_seed(s_q * 1000 + d)
    mk = lambda s: torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=getattr(torch, dtype))
    q, k, v = mk(s_q), mk(s_k), mk(s_k)
    got = attention.flash_attention_partials(
        q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off)
    want = attention.flash_attention_partials_reference(
        q, k, v, causal=causal, q_offset=q_off, kv_offset=kv_off)
    torch.cuda.synchronize()
    rows = q_off + torch.arange(s_q, device="cuda")
    seen = (rows >= kv_off) if causal else torch.ones_like(rows, dtype=bool)
    seen = seen.expand(bh, s_q)
    (o1, m1, l1), (o2, m2, l2) = got, want
    tol = TOL[dtype]
    err = 0.0
    if seen.any():
        n1 = o1[seen] / l1[seen][:, None]
        n2 = o2[seen] / l2[seen][:, None]
        err = float((n1 - n2).abs().max())
        ok_o = bool(((n1 - n2).abs() <= tol + tol * n2.abs()).all())
        scale = 1.0 / math.sqrt(d)
        s_max = float((q.float() @ k.float().transpose(1, 2)).abs().amax()
                      * scale)
        m_err = float((m1[seen] - m2[seen]).abs().max())
        l_err = float(((l1[seen] - l2[seen]).abs()
                       / l2[seen].abs()).max())
        if not (ok_o and m_err <= M_TOL * s_max and l_err <= tol):
            raise AssertionError(
                f"K1 {name}: o/l max err {err:.3g} (tol {tol}), m err "
                f"{m_err:.3g} (tol {M_TOL * s_max:.3g}), l rel err "
                f"{l_err:.3g} (tol {tol})")
    if not bool((m1[~seen] <= -1e29).all() and (m2[~seen] <= -1e29).all()):
        raise AssertionError(f"K1 {name}: a row that sees no key has m > "
                             f"-1e29")
    if not all(bool(torch.isfinite(x[seen]).all()) for x in got):
        raise AssertionError(f"K1 {name}: non-finite output on a seen row")
    return err


def check_merge(torch, attention, ring, dtype):
    """Two kv halves through K1, merged with ring._merge, equal the plain
    version over the whole kv (causal, the second half at kv_offset)."""
    bh, s, d = 8, 512, 128
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                           dtype=getattr(torch, dtype)) for _ in range(3))
    for causal in (False, True):
        h = s // 2
        p1 = attention.flash_attention_partials(q, k[:, :h], v[:, :h],
                                                causal=causal)
        p2 = attention.flash_attention_partials(q, k[:, h:], v[:, h:],
                                                causal=causal, kv_offset=h)
        o, m, l = ring._merge(*p1, *p2)
        wo, wm, wl = attention.flash_attention_partials_reference(
            q, k, v, causal=causal)
        a, b = o / l[..., None], wo / wl[..., None]
        err = float((a - b).abs().max())
        tol = TOL[dtype]
        if not bool(((a - b).abs() <= tol + tol * b.abs()).all()):
            raise AssertionError(f"merge {dtype} causal={causal}: max err "
                                 f"{err:.3g} (tol {tol})")
        log({"phase": "merge", "dtype": dtype, "causal": causal,
             "max_abs_err": err, "tol": tol, "ok": True})


def bwd_args(torch, attention, dtype, causal, bh, s_q, s_k, d):
    """(q, k, v, dO, lse, delta) for K2/K3: random q, k, v, dO, with lse
    and delta from one K1 forward of the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(s_q * 1000 + d + 1)
    mk = lambda s: torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=getattr(torch, dtype))
    q, k, v, do = mk(s_q), mk(s_k), mk(s_k), mk(s_q)
    o, m, l = attention.flash_attention_partials(q, k, v, causal=causal)
    l = l.clamp_min(1e-20)
    of = (o / l[..., None]).to(q.dtype)
    return (q, k, v, do, m + torch.log(l),
            (do.float() * of.float()).sum(dim=-1))


def bound_use(got, want, tol: float) -> float:
    """The largest |got - want| over its row's bound (see BWD_TOL); the
    check passes at <= 1."""
    top = want.abs()
    lim = (tol * top.amax(dim=-1, keepdim=True)
           + BWD_ATOL * top.amax(dim=(-2, -1), keepdim=True))
    return float(((got - want).abs() / lim).max())


def bwd_tile_rows(bwd_lib, dtype: str, d: int):
    """The rows of K2's kv tile (dk, dv) and K3's q tile (dq) at this dtype
    and head dim: the rows a planted fault covers."""
    if dtype == "float32":
        return dict.fromkeys(("dk", "dv", "dq"), F32_TILE_ROWS)
    import ctypes
    out = (ctypes.c_int * 7)()
    bwd_lib.flash_bwd_tile(d, out)
    return {"dk": out[1], "dv": out[1], "dq": out[2]}


def check_bwd(torch, attention, case, tiles):
    """One K2/K3-vs-plain comparison; returns, for each of dq, dk and dv,
    the max abs error, the bound used (bound_use) and what the two planted
    faults read.  ``tiles`` gives each gradient's tile rows
    (bwd_tile_rows)."""
    name, dtype, causal, bh, s_q, s_k, d = case
    args = bwd_args(torch, attention, dtype, causal, bh, s_q, s_k, d)
    dk, dv = attention.flash_mha_bwd_dkdv(*args, causal=causal)
    dq = attention.flash_mha_bwd_dq(*args, causal=causal)
    want_dk, want_dv = attention.flash_mha_bwd_dkdv_reference(*args,
                                                              causal=causal)
    want_dq = attention.flash_mha_bwd_dq_reference(*args, causal=causal)
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype]
    errs, used, planted = {}, {}, {}
    for what, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        got, want = got.float(), want.float()
        errs[what] = float((got - want).abs().max())
        used[what] = bound_use(got, want, tol)
        if not (bool(torch.isfinite(got).all()) and used[what] <= 1):
            raise AssertionError(
                f"K2/K3 {name}: {what} max err {errs[what]:.3g}, "
                f"{used[what]:.3g} of its row's bound, finite="
                f"{bool(torch.isfinite(got).all())}")
        live = got.shape[1]
        if causal and what != "dq":
            live = min(live, s_q)
        rows = tiles[what]
        planted[what] = {"tile_rows": rows}
        for fault, sl in (("last_quarter", slice(live - live // 4, live)),
                          ("last_tile", slice(max(live - rows, 0), live))):
            bad = got.clone()
            bad[:, sl] *= 1 + PLANTED_ERR
            planted[what][fault] = bound_use(bad, want, tol)
            if not planted[what][fault] > 1:
                raise AssertionError(
                    f"K2/K3 {name}: {what} with the {fault} rows "
                    f"{PLANTED_ERR:.0%} off reads {planted[what][fault]:.3g}"
                    f" of the bound; the check would pass it")
    return errs, used, planted


def mha_grads(torch, fn, q, k, v, g):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), g)


def check_grad(torch, attention, ring) -> None:
    """flash_mha through autograd (K1, then delta, K2, K3) against autograd
    through the dense attention_reference."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for dtype, shape, causals in GRAD_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                                  dtype=getattr(torch, dtype))
                      for _ in range(4))
        for causal in causals:
            got = mha_grads(torch, lambda q, k, v: attention.flash_mha(
                q, k, v, causal), q, k, v, g)
            # the dense reference runs in f32 on the same (bf16) values
            want = mha_grads(torch, lambda q, k, v: ring.attention_reference(
                q, k, v, causal=causal), *(x.float() for x in (q, k, v, g)))
            torch.cuda.synchronize()
            for what, a, b in zip(("dq", "dk", "dv"), got, want):
                if dtype == "float32":
                    err = float((a - b).abs().max())
                    ok = bool(((a - b).abs() <= GRAD_TOL_F32
                               + GRAD_TOL_F32 * b.abs()).all())
                    tol = GRAD_TOL_F32
                else:
                    err = rel_rms(a.float(), b)
                    ok, tol = err < GRAD_RMS_BF16, GRAD_RMS_BF16
                log({"phase": "grad_check", "dtype": dtype, "causal": causal,
                     "shape": list(shape), "grad": what,
                     "max_abs_err" if dtype == "float32" else "rel_rms": err,
                     "tol": tol, "ok": ok})
                if not ok:
                    raise AssertionError(f"flash_mha {dtype} causal={causal}"
                                         f" {what}: {err:.3g} (tol {tol})")
            del got, want


def fold(x):
    """(b, s, h, d) -> (b*h, s, d), as the plain version takes them."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def k4_inputs(torch, gen, b, h, s_q, s_k, d, q_dtype, kv_dtype):
    """q (b, s_q, h, d) at Q_SCALE, k and v (b, s_k, h, d) at unit scale."""
    mk = lambda s, dtype, scale=1.0: (torch.randn(
        (b, s, h, d), generator=gen, device="cuda") * scale).to(
        getattr(torch, dtype))
    return mk(s_q, q_dtype, Q_SCALE), mk(s_k, kv_dtype), mk(s_k, kv_dtype)


def elementwise_use(got, want, tol: float) -> float:
    """The largest |got - want| over its bound tol + tol * |want|; the check
    passes at <= 1."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def tile_rows(attention_lib, dtype: str, d: int) -> int:
    """The q tile of K1/K4 at this dtype and head dim: the rows a planted
    fault covers."""
    if dtype == "float32":
        return F32_TILE_ROWS
    import ctypes
    out = (ctypes.c_int * 4)()
    attention_lib.flash_attention_tile(d, out)
    return out[0]


def check_k4(torch, attention, lib, name, dtype, causal, q, k, v):
    """One K4-vs-plain comparison through flash_attention on (b, s, h, d)
    inputs as they lie; returns the max abs error, the share of the bound
    used and what the planted fault on the last BQ rows reads."""
    b, s_q, h, d = q.shape
    out = attention.flash_attention(q, k, v, causal=causal)
    want = attention.flash_attention_reference(fold(q), fold(k), fold(v),
                                               causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    if out.shape != (b, s_q, h, d) or out.dtype != q.dtype or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K4 {name}: output {tuple(out.shape)} "
                             f"{out.dtype}, finite="
                             f"{bool(torch.isfinite(out).all())}")
    got = fold(out).float()
    err = float((got - want.float()).abs().max())
    used = elementwise_use(got, want, tol)
    if not used <= 1:
        raise AssertionError(f"K4 {name}: max err {err:.3g}, {used:.3g} of "
                             f"the bound (tol {tol})")
    rows = tile_rows(lib, dtype, d)
    bad = got.clone()
    bad[:, max(s_q - rows, 0):] *= 1 + PLANTED_ERR
    planted = elementwise_use(bad, want, tol)
    if not planted > 1:
        raise AssertionError(f"K4 {name}: the last {rows} rows "
                             f"{PLANTED_ERR:.0%} off read {planted:.3g} of "
                             f"the bound; the check would pass it")
    return err, used, planted, rows


def k4_view_inputs(torch, gen, layout, dtype, b, h, s, d):
    """q (at Q_SCALE), k and v as (b, s, h, d) views of the given layout."""
    dt = getattr(torch, dtype)
    if layout == "packed qkv":
        x = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
        x[:, :, 0] *= Q_SCALE
        x = x.to(dt)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               * scale for scale in (Q_SCALE, 1.0, 1.0))
    return tuple(x.to(dt).transpose(1, 2) for x in (q, k, v))


def sdpa(torch, q, k, v, causal):
    """SDPA's forward on the (b, h, s, d) views of (b, s, h, d) inputs."""
    t = lambda x: x.transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        t(q), t(k), t(v), is_causal=causal)


def check_sdpa_alignment(torch, attention) -> None:
    """SDPA's is_causal with s_q != s_k against the plain version, whose
    causal mask is aligned at the top left (row i sees the keys j <= i).
    Logged, not required: the yardstick's timed shapes do not depend on
    it (causal at s_q == s_k, cross not causal)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, d = 2, 2, 128
    for s_q, s_k in ((320, 128), (128, 320)):
        q, k, v = k4_inputs(torch, gen, b, h, s_q, s_k, d, "bfloat16",
                            "bfloat16")
        want = attention.flash_attention_reference(fold(q), fold(k),
                                                   fold(v), causal=True)
        got = sdpa(torch, q, k, v, True).reshape(b * h, s_q, d)
        use = elementwise_use(got, want, TOL["bfloat16"])
        log({"phase": "sdpa_alignment", "s_q": s_q, "s_k": s_k,
             "bound_use": use, "top_left": use <= 1})


def visible_pairs(s_q: int, s_k: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves visible, top-left causal."""
    if not causal:
        return s_q * s_k
    return sum(min(i + 1, s_k) for i in range(s_q))


def k4_path(torch, attention, cfg, card):
    """flash_attention at full flagship width over K4_PATH: each call
    checked against the plain version and SDPA, its launches counted, and
    timed.  Returns one row of numbers per shape."""
    b, h, d, s_k = BATCH, cfg.n_heads, cfg.head_dim, cfg.seq
    tol = TOL["bfloat16"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, causal, s_q in K4_PATH:
        q, k, v = k4_inputs(torch, gen, b, h, s_q, s_k, d, "bfloat16",
                            "bfloat16")
        zero_counts(attention)
        out = attention.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        counts = launch_counts(attention)
        if counts != (0, 0, 0, 1):
            raise AssertionError(f"flash_attention {name}: K1/K2/K3/K4 "
                                 f"launches {counts}, want (0, 0, 0, 1)")
        # the device sees exactly one kernel, K4: no fold, copy or cast
        seen = device_kernels(torch, lambda: attention.flash_attention(
            q, k, v, causal=causal))
        log({"phase": "k4_one_kernel", "case": name, "kernels": seen})
        if len(seen) != 1 or seen[0]["count"] != 1 or \
                "attention_sm90" not in seen[0]["name"]:
            raise AssertionError(f"flash_attention {name}: one profiled "
                                 f"call ran {seen}, want K4 alone")
        qf, kf, vf = fold(q), fold(k), fold(v)
        want = attention.flash_attention_reference(qf, kf, vf, causal=causal)
        got = fold(out)
        use = elementwise_use(got, want, tol)
        sdpa_use = elementwise_use(
            sdpa(torch, q, k, v, causal).reshape(b * h, s_q, d), want, tol)
        if out.shape != q.shape or out.dtype != q.dtype or \
                not bool(torch.isfinite(out).all()) or not use <= 1:
            raise AssertionError(
                f"flash_attention {name}: output {tuple(out.shape)} "
                f"{out.dtype}, finite={bool(torch.isfinite(out).all())}, "
                f"{use:.3g} of the bound against the plain version")
        if not sdpa_use <= 1:
            raise AssertionError(f"SDPA {name}: {sdpa_use:.3g} of the bound "
                                 f"against the plain version; it is no "
                                 f"yardstick for this function")
        # K4 on the folded inputs, read as (b·h, s, 1, d)
        one = lambda t: t[:, :, None]
        k4_ms = median_ms(lambda: attention.flash_attention(
            one(qf), one(kf), one(vf), causal=causal), reps=KERNEL_REPS)
        entry_ms = median_ms(lambda: attention.flash_attention(
            q, k, v, causal=causal), reps=KERNEL_REPS)
        plain_ms = median_ms(lambda: attention.flash_attention_reference(
            qf, kf, vf, causal=causal), n=5, warmup=1)
        sdpa_ms = median_ms(lambda: sdpa(torch, q, k, v, causal),
                            reps=KERNEL_REPS)
        # K1 on the same folded inputs: the same tile loop, K1's epilogue
        k1_ms = median_ms(lambda: attention.flash_attention_partials(
            qf, kf, vf, causal=causal), reps=KERNEL_REPS)
        # QK^T and PV over the visible pairs; q, k, v read and o written
        flops = 4 * d * b * h * visible_pairs(s_q, s_k, causal)
        n_bytes = 2 * b * h * d * (2 * s_q + 2 * s_k)
        bound_ms, bound_by = bound(flops, n_bytes)
        row = {"phase": "k4_path", "case": name, "causal": causal,
               "q_shape": list(q.shape), "kv_shape": list(k.shape),
               "launches": counts[3], "max_abs_err": float(
                   (got.float() - want.float()).abs().max()),
               "bound_use": use, "sdpa_bound_use": sdpa_use, "tol": tol,
               "k4_ms": k4_ms, "flash_attention_ms": entry_ms,
               "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
               "k1_same_inputs_ms": k1_ms, "flop": flops,
               "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": bound_by,
               "k4_tflops": flops / k4_ms / 1e9,
               "flash_attention_tflops": flops / entry_ms / 1e9,
               "roofline_share": bound_ms / k4_ms, "card": card}
        log(row)
        rows.append(row)
        if causal:
            profile_run(torch, lambda: attention.flash_attention(
                q, k, v, causal=True), entry_ms, card, "flash_attention")
        del q, k, v, out, want, got, qf, kf, vf
    return rows


def device_kernels(torch, fn):
    """The device kernels of one warm call of ``fn``, by torch.profiler:
    [{"name", "count"}]."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = torch.autograd.DeviceType.CUDA
    return [{"name": e.key[:120], "count": e.count}
            for e in prof.key_averages() if e.device_type == kernels]


KERNEL_NAMES = ("partials_sm90", "attention_sm90", "partials_f32",
                "attention_f32", "dkdv_sm90", "dq_sm90", "dkdv_kernel",
                "dq_kernel")


def ptxas_table(report: str):
    """Registers and spills of every kernel in an nvcc -Xptxas=-v report:
    [{"kernel", "registers", "spill_stores", "spill_loads"}], and the
    count of ptxas's notes that it serialised wgmma instructions."""
    rows, current = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            base = next((k for k in KERNEL_NAMES if k in mangled), mangled)
            ints = re.findall(r"Li(\d+)E", mangled)
            dtype = "bf16" if ("sm90" in base or "bfloat16" in mangled) \
                else "f32"
            current = {"kernel": f"{base}<{dtype}{''.join(',' + i for i in ints)}>"}
            rows.append(current)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return rows, sum("C7512" in line for line in report.splitlines())


def check_ptxas(_build, lib, bwd_lib) -> None:
    """Every kernel's registers and spills from its nvcc report, and the
    bf16 forward tiles (BQ, BK, threads, dynamic shared memory) and backward
    tiles; a spill or a serialised wgmma anywhere fails."""
    import ctypes
    spills, serialised = [], {}
    for src in _build.sources():
        rows, notes = ptxas_table(_build.report(src.stem))
        log({"phase": "ptxas", "source": src.name, "kernels": rows,
             "wgmma_serialised_notes": notes})
        spills += [r["kernel"] for r in rows
                   if r.get("spill_stores", 0) or r.get("spill_loads", 0)]
        if notes:
            serialised[src.name] = notes
    tiles = {}
    for d in (64, 128, 256):
        out = (ctypes.c_int * 4)()
        lib.flash_attention_tile(d, out)
        tiles[d] = dict(zip(("bq", "bk", "threads", "smem_bytes"), out))
    log({"phase": "fwd_tiles", "by_padded_head_dim": tiles})
    # d 64 and 128: the Hopper kernels; d 256: the wmma loop
    tiles = {}
    for d in (64, 128, 256):
        out = (ctypes.c_int * 7)()
        bwd_lib.flash_bwd_tile(d, out)
        tiles[d] = dict(zip(("k2_bq", "k2_bk", "k3_bq", "k3_bk", "threads",
                             "k2_smem_bytes", "k3_smem_bytes"), out))
    log({"phase": "bwd_tiles", "by_padded_head_dim": tiles})
    if spills:
        raise AssertionError(f"ptxas spilled registers in {spills}")
    if serialised:
        raise AssertionError(f"ptxas serialised wgmma in {serialised}")


def profile_run(torch, fn, ref_ms: float, card: str, what: str,
                want_launches=None) -> None:
    """Where one warm run of ``fn`` spends device time: kernel time by name
    from torch.profiler, and the device's idle share of the unprofiled time
    ``ref_ms`` (the profiler's own overhead lengthens the profiled wall
    time, so that is reported but not used).  ``want_launches`` maps
    kernel classes to the launches the run must show."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):            # a warm-up run, then the record
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    # kernels only: an operator's device time repeats its kernels', and
    # the ProfilerStep annotation spans the whole step
    kernels = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == kernels
              and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    by_class = {}
    for e in events:
        cls = next((c for c, marks in KERNEL_CLASSES
                    if any(m in e.key for m in marks)), "other")
        ms, count = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / 1e3,
                         count + e.count)
    out = {"phase": "profile", "what": what, "profiled_wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "unprofiled_ms": ref_ms,
           # no device time seen means the profiler could not trace the
           # card: the share is then not measured, not 100% idle
           "idle_share": 1 - busy_ms / ref_ms if busy_ms else None,
           "card": card,
           "by_class": {c: {"device_ms": ms, "launches": n}
                        for c, (ms, n) in sorted(by_class.items())},
           "top": [{"name": e.key[:90], "count": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in top]}
    log(out)
    for cls, n in (want_launches or {}).items():
        seen = by_class.get(cls, (0.0, 0))[1]
        if seen != n:
            raise AssertionError(f"profile of {what}: {seen} launches of "
                                 f"{cls}, want {n}")


def rel_rms(a, b) -> float:
    return float(((a - b).square().mean() / b.square().mean()).sqrt())


def bound(flops: float, n_bytes: float):
    """The least time the card could take: (bound ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def launch_counts(attention):
    """K1, K2, K3 and K4 launches since the counts were last set to 0."""
    return (attention.launches, attention.dkdv_launches,
            attention.dq_launches, attention.attention_launches)


def zero_counts(attention) -> None:
    attention.launches = attention.dkdv_launches = 0
    attention.dq_launches = attention.attention_launches = 0


def clone_tree(optim, tree):
    return optim.tree_map(lambda t: t.clone(), tree)


def grads_rel_rms(got, want) -> float:
    """Relative RMS over all leaves together."""
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(got, want))
    return math.sqrt(num / sum(float(b.float().square().sum())
                               for b in want))


def run_steps(tfm, cfg, params, tokens, n: int):
    init_opt, step = tfm.make_train_step(cfg, learning_rate=1e-3)
    state, losses = init_opt(params), []
    for _ in range(n):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return losses


def train_path(torch, tfm, optim, attention, cfg, pristine, tokens):
    """The slice's main path: make_train_step at full width.  Returns the
    K1/K2/K3/K4 launches of its first step."""
    n = cfg.n_layers
    init_opt, step = tfm.make_train_step(cfg, learning_rate=1e-3)
    params = clone_tree(optim, pristine)
    state = init_opt(params)
    zero_counts(attention)
    params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    per_step = launch_counts(attention)
    # K1 runs in the forward and again in the remat recompute; K2 and K3
    # once per layer in the backward; K4 is off the path
    want = (2 * n if cfg.remat != "none" else n, n, n, 0)
    if per_step != want:
        raise AssertionError(f"K1/K2/K3/K4 launches in one train step: "
                             f"{per_step}, want {want}")
    losses = [float(loss)]
    for _ in range(TRAIN_STEPS - 1):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    log({"phase": "train_path", "config": dataclasses.asdict(cfg)
         | {"dtype": str(cfg.dtype)}, "batch": BATCH,
         "tokens_shape": list(tokens.shape), "learning_rate": 1e-3,
         "k1_k2_k3_k4_launches_per_step": list(per_step), "losses": losses})
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train losses on one repeated batch: {losses}")
    del params, state

    # attn="dense" from the same weights and batch: no K1/K2/K3 launch
    dense = dataclasses.replace(cfg, attn="dense")
    before = launch_counts(attention)
    dense_losses = run_steps(tfm, dense, clone_tree(optim, pristine), tokens,
                             3)
    # the train step's own value-and-grad, from the pristine weights
    grads = lambda c: tfm.value_and_grad(clone_tree(optim, pristine),
                                         tokens, c)[1]
    g_dense = grads(dense)
    torch.cuda.synchronize()
    if launch_counts(attention) != before:
        raise AssertionError("the dense train path launched a kernel")
    g_flash = grads(cfg)
    rel = grads_rel_rms(g_flash, g_dense)
    g_truth = grads(dataclasses.replace(dense, dtype=torch.float32))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, dense_losses))
    log({"phase": "train_flash_vs_dense", "flash_losses": losses[:3],
         "dense_losses": dense_losses, "loss_max_rel_diff": loss_rel,
         "loss_bound": TRAIN_LOSS_REL, "grad_rel_rms": rel,
         "grad_bound": TRAIN_GRAD_RMS,
         "flash_vs_f32_grad_rel_rms": grads_rel_rms(g_flash, g_truth),
         "dense_vs_f32_grad_rel_rms": grads_rel_rms(g_dense, g_truth)})
    if not (loss_rel < TRAIN_LOSS_REL and rel < TRAIN_GRAD_RMS):
        raise AssertionError(f"flash vs dense train: loss rel diff "
                             f"{loss_rel:.3g} (bound {TRAIN_LOSS_REL}), grad "
                             f"rel RMS {rel:.3g} (bound {TRAIN_GRAD_RMS})")
    return per_step


def time_train(torch, tfm, optim, cfg, pristine, tokens, card,
               profile=False) -> None:
    """Log the median ms of TIMED_STEPS chained train steps after
    WARMUP_STEPS, by CUDA events, with the peak memory of the run."""
    init_opt, step = tfm.make_train_step(cfg, learning_rate=1e-3)
    params = clone_tree(optim, pristine)
    state = init_opt(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        params, state, _ = step(params, state, tokens)
    times = []
    for _ in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss = step(params, state, tokens)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    tokens_per_s = n_tokens / ms * 1e3
    log({"phase": "train_numbers", "attn": cfg.attn, "remat": cfg.remat,
         "step_ms": ms, "step_ms_all": times, "tokens_per_step": n_tokens,
         "tokens_per_s": tokens_per_s,
         "mfu": tokens_per_s * tfm.train_flops_per_token(cfg)
         / PEAK_BF16_FLOPS,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "bytes_before_run": base, "final_loss": float(loss), "card": card})
    if profile:
        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, tokens)
        n = cfg.n_layers
        profile_run(torch, one_step, ms, card, "train_step", {
            "K1 partials_sm90": 2 * n if cfg.remat != "none" else n,
            "K2 dkdv": n, "K3 dq": n, "K4 attention_sm90": 0})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    from ompi_tpu_torch import _build, optim
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import attention
    from ompi_tpu_torch.parallel import ring

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    props = torch.cuda.get_device_properties(0)
    log({"phase": "device", "card": card, "name": props.name,
         "sm_count": props.multi_processor_count,
         "memory_bytes": props.total_memory,
         "capability": f"{props.major}.{props.minor}",
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    log({"phase": "build", "seconds": build_s, "built": sorted(reports),
         "sources": [s.name for s in _build.sources()]})
    check_ptxas(_build, _build.library("flash_attention"),
                _build.library("flash_bwd"))

    # 3. kernels against their plain versions
    path_err = None
    for case in K1_CASES:
        err = check_k1(torch, attention, case)
        log({"phase": "k1_check", "case": case[0], "dtype": case[1],
             "causal": case[2], "shape": list(case[3:7]),
             "offsets": list(case[7:]), "max_abs_err": err,
             "tol": TOL[case[1]], "ok": True})
        if case[0] == PATH_CASE:
            path_err = err
    for dtype in ("float32", "bfloat16"):
        check_merge(torch, attention, ring, dtype)
    bwd_err = None
    bwd_lib = _build.library("flash_bwd")
    for case in BWD_CASES:
        errs, used, planted = check_bwd(
            torch, attention, case, bwd_tile_rows(bwd_lib, case[1], case[6]))
        log({"phase": "k2_k3_check", "case": case[0], "dtype": case[1],
             "causal": case[2], "shape": list(case[3:]), "max_abs_err": errs,
             "row_tol": BWD_TOL[case[1]], "atol_of_max": BWD_ATOL,
             "bound_use": used, "planted_fault_bound_use": planted,
             "ok": True})
        if case[0] == PATH_CASE:
            bwd_err = errs
    check_grad(torch, attention, ring)
    torch.cuda.empty_cache()

    # 4. flash_attention (K4): against its plain version, then its path at
    # full flagship width
    cfg = tfm.flagship_config()
    k4_lib = _build.library("flash_attention")
    for case in K4_CASES:
        name, dtype, kv_dtype, causal, b, h, s_q, s_k, d = case
        gen = torch.Generator(device="cuda").manual_seed(s_q * 1000 + d + 2)
        q, k, v = k4_inputs(torch, gen, b, h, s_q, s_k, d, dtype, kv_dtype)
        err, used, planted, rows = check_k4(torch, attention, k4_lib, name,
                                            dtype, causal, q, k, v)
        log({"phase": "k4_check", "case": name, "dtype": dtype,
             "kv_dtype": kv_dtype, "causal": causal,
             "b_h_sq_sk_d": list(case[4:]), "max_abs_err": err,
             "tol": TOL[dtype], "bound_use": used, "planted_rows": rows,
             "planted_fault_bound_use": planted, "ok": True})
    for name, layout, dtype, causal, b, h, s, d in K4_VIEWS:
        gen = torch.Generator(device="cuda").manual_seed(s * 1000 + d + 4)
        q, k, v = k4_view_inputs(torch, gen, layout, dtype, b, h, s, d)
        err, used, planted, rows = check_k4(torch, attention, k4_lib, name,
                                            dtype, causal, q, k, v)
        log({"phase": "k4_check", "case": name, "layout": layout,
             "dtype": dtype, "causal": causal, "b_h_s_d": [b, h, s, d],
             "q_strides": list(q.stride()), "max_abs_err": err,
             "tol": TOL[dtype], "bound_use": used, "planted_rows": rows,
             "planted_fault_bound_use": planted, "ok": True})
    check_sdpa_alignment(torch, attention)
    k4_rows = k4_path(torch, attention, cfg, card)
    torch.cuda.empty_cache()

    # 5. the forward path at full width
    rng = np.random.default_rng(0)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, cfg.seq)))
    prompts = rng.integers(0, cfg.vocab, (4, cfg.seq - 4)).tolist()
    with torch.inference_mode():
        zero_counts(attention)
        logits = tfm.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_counts = launch_counts(attention)
        per_forward = fwd_counts[0]
        if fwd_counts[1:] != (0, 0, 0):
            raise AssertionError(f"K2/K3/K4 launched in one forward: "
                                 f"{fwd_counts}")
        streams = tfm.greedy(params, prompts, 4, cfg)
        torch.cuda.synchronize()
        launches = attention.launches
        if per_forward != cfg.n_layers or launches != 5 * cfg.n_layers:
            raise AssertionError(
                f"K1 launches: {per_forward} in one forward, {launches} "
                f"over forward + 4 greedy steps; want {cfg.n_layers} per "
                f"forward")
        if logits.shape != (4, cfg.seq, cfg.vocab) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"logits {tuple(logits.shape)} "
                                 f"{logits.dtype}, finite="
                                 f"{bool(torch.isfinite(logits).all())}")
        log({"phase": "main_path", "config": dataclasses.asdict(
            cfg) | {"dtype": str(cfg.dtype)}, "batch": 4,
            "k1_k2_k3_k4_launches_per_forward": list(fwd_counts),
            "k1_launches_main_path": launches})
        for i, (p, s) in enumerate(zip(prompts, streams)):
            log({"phase": "greedy", "request": i, "prompt_len": len(p),
                 "prompt_tail": p[-4:], "tokens": s})

        dense = dataclasses.replace(cfg, attn="dense")
        logits_d = tfm.forward(params, tokens, dense)
        streams_d = tfm.greedy(params, prompts, 4, dense)
        truth = tfm.forward(params, tokens, dataclasses.replace(
            dense, dtype=torch.float32))
        torch.cuda.synchronize()
        if attention.launches != launches:
            raise AssertionError("the dense path launched K1")
        rel = rel_rms(logits, logits_d)
        agree = float((logits.argmax(-1) == logits_d.argmax(-1))
                      .float().mean())
        log({"phase": "flash_vs_dense", "rel_rms": rel,
             "bound": FLASH_VS_DENSE_RMS, "argmax_agree": agree,
             "greedy_streams_equal": sum(a == b for a, b in
                                         zip(streams, streams_d)),
             "flash_vs_f32_rel_rms": rel_rms(logits, truth),
             "dense_vs_f32_rel_rms": rel_rms(logits_d, truth)})
        if not rel < FLASH_VS_DENSE_RMS:
            raise AssertionError(f"flash vs dense logits: relative RMS "
                                 f"{rel:.4g} >= {FLASH_VS_DENSE_RMS}")
        del logits, logits_d, truth

        # 6. numbers, CUDA-event medians
        bh, s, d = 4 * cfg.n_heads, cfg.seq, cfg.head_dim
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        k1_ms = median_ms(lambda: attention.flash_attention_partials(
            q, k, v, causal=True), reps=KERNEL_REPS)
        plain_ms = median_ms(
            lambda: attention.flash_attention_partials_reference(
                q, k, v, causal=True))
        unfold = lambda x: x.reshape(4, cfg.n_heads, s, d)
        sdpa_ms = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                unfold(q), unfold(k), unfold(v), is_causal=True),
            reps=KERNEL_REPS)
        qm, km, vm = (unfold(x).transpose(1, 2) for x in (q, k, v))
        mha_ms = median_ms(lambda: attention.flash_mha(qm, km, vm, True),
                           reps=KERNEL_REPS)
        fwd_ms = median_ms(lambda: tfm.forward(params, tokens, cfg), n=10)
        dense_ms = median_ms(lambda: tfm.forward(params, tokens, dense), n=10)
        profile_run(torch, lambda: tfm.forward(params, tokens, cfg), fwd_ms,
                    card, "forward")

    pairs = bh * s * (s + 1) // 2                # causal, offsets 0
    tile = bh * s * d * 2                        # one bf16 (bh, s, d) tensor
    vec = bh * s * 4                             # one f32 (bh, s) vector
    # K1: q, k, v in; o (f32), m, l out; QK^T and PV
    flops, n_bytes = 4 * d * pairs, 3 * tile + 2 * tile + 2 * vec
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    k1_bound, k1_by = bound(flops, n_bytes)
    for metric, value in (("k1_ms", k1_ms), ("k1_plain_ms", plain_ms),
                          ("sdpa_ms", sdpa_ms), ("flash_mha_ms", mha_ms),
                          ("forward_ms", fwd_ms),
                          ("forward_tokens_per_s", 4 * s / fwd_ms * 1e3),
                          ("forward_dense_ms", dense_ms)):
        log({"phase": "numbers", "metric": metric, "value": value,
             "card": card})
    log({"phase": "numbers", "metric": "k1_bound", "flop": flops,
         "bytes": n_bytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
         "k1_tflops": flops / k1_ms / 1e9, "roofline_share":
         k1_bound / k1_ms, "card": card})

    del params
    torch.cuda.empty_cache()

    # 7. the train path at full width
    pristine = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    train_tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, cfg.seq + 1))).cuda()
    per_step = train_path(torch, tfm, optim, attention, cfg, pristine,
                          train_tokens)
    torch.cuda.empty_cache()

    # 8. train numbers, CUDA-event medians
    args = bwd_args(torch, attention, "bfloat16", True, bh, s, s, d)
    k2_ms = median_ms(lambda: attention.flash_mha_bwd_dkdv(*args,
                                                           causal=True),
                      reps=KERNEL_REPS)
    k3_ms = median_ms(lambda: attention.flash_mha_bwd_dq(*args, causal=True),
                      reps=KERNEL_REPS)
    k2_plain_ms = median_ms(lambda: attention.flash_mha_bwd_dkdv_reference(
        *args, causal=True), n=5, warmup=1)
    k3_plain_ms = median_ms(lambda: attention.flash_mha_bwd_dq_reference(
        *args, causal=True), n=5, warmup=1)
    q, k, v, do = args[:4]
    b4 = lambda x: x.reshape(BATCH, cfg.n_heads, s, d)   # (b, h, s, d)
    qs, ks, vs = (b4(x).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           is_causal=True)
    sdpa_bwd_ms = median_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), b4(do), retain_graph=True), reps=KERNEL_REPS)
    qm, km, vm = (b4(x).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = attention.flash_mha(qm, km, vm, True)
    g = b4(do).transpose(1, 2)
    mha_bwd_ms = median_ms(lambda: torch.autograd.grad(
        out, (qm, km, vm), g, retain_graph=True), reps=KERNEL_REPS)
    del out, qs, ks, vs, qm, km, vm, args
    # the step's two halves at the path: value-and-grad, then AdamW
    params = clone_tree(optim, pristine)
    grads_ms = median_ms(lambda: tfm.value_and_grad(params, train_tokens,
                                                    cfg), n=5)
    grads = list(tfm.value_and_grad(params, train_tokens, cfg)[1])
    state = optim.adamw_init(params, cfg.opt_moment_dtype)
    adamw_ms = median_ms(lambda: optim.adamw_update(params, grads, state,
                                                    1e-3), n=10)
    del params, grads, state
    torch.cuda.empty_cache()
    for remat in ("dots", "none", "full"):
        time_train(
            torch, tfm, optim, dataclasses.replace(cfg, remat=remat),
            pristine, train_tokens, card, profile=remat == "dots")
        torch.cuda.empty_cache()
    time_train(torch, tfm, optim, dataclasses.replace(cfg, attn="dense"),
               pristine, train_tokens, card)

    # K2: q, k, v, dO, lse, delta in; dk, dv out; 4 causal products
    k2_flops, k3_flops = 8 * d * pairs, 6 * d * pairs
    k2_bound, k2_by = bound(k2_flops, 6 * tile + 2 * vec)
    # K3: q, k, v, dO, lse, delta in; dq out; 3 causal products
    k3_bound, k3_by = bound(k3_flops, 5 * tile + 2 * vec)
    for metric, value in (("k2_ms", k2_ms), ("k2_plain_ms", k2_plain_ms),
                          ("k3_ms", k3_ms), ("k3_plain_ms", k3_plain_ms),
                          ("flash_mha_bwd_ms", mha_bwd_ms),
                          ("train_value_and_grad_ms", grads_ms),
                          ("train_adamw_ms", adamw_ms),
                          ("sdpa_bwd_ms", sdpa_bwd_ms),
                          ("k2_bound_ms", k2_bound), ("k3_bound_ms", k3_bound),
                          ("k2_tflops", k2_flops / k2_ms / 1e9),
                          ("k3_tflops", k3_flops / k3_ms / 1e9)):
        log({"phase": "numbers", "metric": metric, "value": value,
             "card": card})
    # like for like: flash_mha's whole backward (fold of dO, delta, K2, K3)
    # against SDPA's on the same (b, h, s, d) inputs
    log({"phase": "numbers", "metric": "bwd_vs_sdpa",
         "flash_mha_bwd_ms": mha_bwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
         "ratio": mha_bwd_ms / sdpa_bwd_ms, "card": card})

    log({"kernels": [
        {"name": "flash_partials", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_partials.cu",
         "replaces": "ompi_tpu/ops/attention.py:248",
         "launches": per_step[0], "max_abs_err": path_err, "ms": k1_ms,
         "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": sdpa_ms, "tflops": flops / k1_ms / 1e9,
         "bound_share": k1_bound / k1_ms},
        {"name": "flash_bwd_dkdv", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ompi_tpu/ops/attention.py:381",
         "launches": per_step[1],
         "max_abs_err": max(bwd_err["dk"], bwd_err["dv"]), "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": sdpa_bwd_ms, "flash_mha_bwd_ms": mha_bwd_ms,
         "tflops": k2_flops / k2_ms / 1e9, "bound_share": k2_bound / k2_ms},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ompi_tpu/ops/attention.py:436",
         "launches": per_step[2], "max_abs_err": bwd_err["dq"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": sdpa_bwd_ms,
         "flash_mha_bwd_ms": mha_bwd_ms, "tflops": k3_flops / k3_ms / 1e9,
         "bound_share": k3_bound / k3_ms},
        # the causal call at full width is K4's path run; its other two
        # shapes are in the k4_path lines
        {"name": "flash_attention", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ompi_tpu/ops/attention.py:139",
         "launches": k4_rows[0]["launches"],
         "launches_per_train_step": per_step[3],
         "max_abs_err": k4_rows[0]["max_abs_err"], "ms": k4_rows[0]["k4_ms"],
         "plain_ms": k4_rows[0]["plain_ms"],
         "bound_ms": k4_rows[0]["bound_ms"],
         "bound_by": k4_rows[0]["bound_by"],
         "library_ms": k4_rows[0]["sdpa_ms"],
         "tflops": k4_rows[0]["k4_tflops"],
         "bound_share": k4_rows[0]["roofline_share"]}]})
    log(card)
    # count: the cards this run used
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
