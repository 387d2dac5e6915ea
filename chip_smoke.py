#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi) and properties;
  2. build   — nvcc builds every kernel under ompi_tpu_torch/csrc/;
  3. kernels — each kernel against its plain PyTorch version on the card,
               over the cases listed in K1_CASES, and the merge contract;
  4. main path — the flagship forward at full flagship_config() width,
               batch 4 x 2048, weights from torch.Generator().manual_seed(0):
               logits checked, K1 launches counted (exactly n_layers per
               forward), 4 requests answered greedily by full-context
               recompute, and the flash logits held against attn="dense";
  5. numbers — CUDA-event medians of K1, its plain version, the SDPA
               yardstick and one forward, as JSON lines, and a
               torch.profiler breakdown of one forward's device time.
The last lines are the kernels JSON object, the nvidia-smi line and
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

# Tolerances of the kernel-vs-plain checks, on o/l over rows that see a key
# (elementwise, rtol = atol): f32 takes the same FMA arithmetic in another
# order; bf16 rounds p to bf16 at tile-dependent running maxima (the kernel
# tiles 64, the plain version 128).  m must agree to M_TOL * max|s|.
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
    ("bf16 flagship shape", "bfloat16", True, 64, 2048, 2048, 128, 0, 0),
]
PATH_CASE = "bf16 flagship shape"

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


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def profile_forward(torch, fn, fwd_ms: float, card: str) -> None:
    """Where one warm forward's device time goes: kernel time by name from
    torch.profiler, and the device's idle share of the unprofiled forward
    time ``fwd_ms`` (the profiler's own overhead lengthens the profiled
    wall time, so that is reported but not used)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):            # a warm-up step, then the record
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
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    log({"phase": "profile", "profiled_wall_ms": wall_ms,
         "device_busy_ms": busy_ms, "forward_ms": fwd_ms,
         # no device time seen means the profiler could not trace the
         # card: the share is then not measured, not 100% idle
         "idle_share": 1 - busy_ms / fwd_ms if busy_ms else None,
         "card": card,
         "top": [{"name": e.key[:90], "count": e.count,
                  "device_ms": e.self_device_time_total / 1e3}
                 for e in top]})


def rel_rms(a, b) -> float:
    return float(((a - b).square().mean() / b.square().mean()).sqrt())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    from ompi_tpu_torch import _build
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
    for name, text in reports.items():
        log(f"nvcc report for {name}:\n{text.strip()}")
    log({"phase": "build", "seconds": build_s,
         "sources": [s.name for s in _build.sources()]})

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

    # 4. the main path at full width
    cfg = tfm.flagship_config()
    rng = np.random.default_rng(0)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, cfg.seq)))
    prompts = rng.integers(0, cfg.vocab, (4, cfg.seq - 4)).tolist()
    with torch.inference_mode():
        attention.launches = 0
        logits = tfm.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        per_forward = attention.launches
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
            "k1_launches_per_forward": per_forward,
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

        # 5. numbers, CUDA-event medians
        bh, s, d = 4 * cfg.n_heads, cfg.seq, cfg.head_dim
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        k1_ms = median_ms(lambda: attention.flash_attention_partials(
            q, k, v, causal=True))
        plain_ms = median_ms(
            lambda: attention.flash_attention_partials_reference(
                q, k, v, causal=True))
        unfold = lambda x: x.reshape(4, cfg.n_heads, s, d)
        sdpa_ms = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                unfold(q), unfold(k), unfold(v), is_causal=True))
        qm, km, vm = (unfold(x).transpose(1, 2) for x in (q, k, v))
        mha_ms = median_ms(lambda: attention.flash_mha(qm, km, vm, True))
        fwd_ms = median_ms(lambda: tfm.forward(params, tokens, cfg), n=10)
        dense_ms = median_ms(lambda: tfm.forward(params, tokens, dense), n=10)
        profile_forward(torch, lambda: tfm.forward(params, tokens, cfg),
                        fwd_ms, card)

    pairs = bh * s * (s + 1) // 2                # causal, offsets 0
    flops = 4 * d * pairs                        # QK^T and PV
    n_bytes = 3 * bh * s * d * 2 + bh * s * d * 4 + 2 * bh * s * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
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
         bound_ms / k1_ms, "card": card})

    log({"kernels": [{
        "name": "flash_partials", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/flash_partials.cu",
        "replaces": "ompi_tpu/ops/attention.py:248",
        "launches": launches, "max_abs_err": path_err, "ms": k1_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sdpa_ms}]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
