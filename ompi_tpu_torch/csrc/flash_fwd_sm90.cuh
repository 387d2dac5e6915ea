// The flash-attention forward tile loop for Hopper (sm_90a) in bf16, shared
// by K1 (flash_partials.cu: un-normalised o, m, l) and K4
// (flash_attention.cu: normalised o).  Each kernel runs `fwd_sm90` and then
// writes its own epilogue from the registers it returns.  float32 keeps its
// exact FMA loop in flash_fwd.cuh.
//
// What bounds it.  At the flagship shape (bh 64, s 2048, d 128, causal) a
// launch does ~69 GFLOP of QK^T and PV against 134-169 MB of traffic: ~70 us
// at the H100's 989 TFLOP/s bf16 against 40-50 us at 3.35 TB/s, so it is
// bounded by operations.  Beside the products, every visible score takes
// an exp on the SFUs and a few f32 operations for the online softmax.
//
// What the design does about it.
//   * Products on the tensor cores through wgmma.  A block of NC
//     warpgroups owns BQ = 64 * NC q rows, 64 per warpgroup.  S = Q K^T is
//     m64nBKk16 with Q and K read from shared memory; O += P V is the
//     register form, P from registers and V from shared memory, so S, P
//     and the f32 o accumulator never leave registers.
//   * The softmax in registers.  A row of a wgmma accumulator lies across
//     the four threads of a quad, so its max takes two shuffles; the row sum
//     stays per thread until the epilogue.  m is kept in log2 units, so one
//     FMA and one ex2 give p; P is rounded to bf16 pairs in place, already
//     laid out as the A fragment of the PV product.  The mask is applied
//     only on tiles that reach past the diagonal or past s_k.
//   * K and V arrive by TMA (128-byte swizzle, the layout the wgmma
//     descriptors read) into a ring of STAGES = 3 tiles; full barriers
//     carry the bytes and empty barriers the warps' release.  Q arrives
//     once per block, also by TMA.  One thread issues the copies, two
//     tiles ahead; the block has no producer warp, because ptxas budgets
//     a block of two warpgroups and a warp as three warpgroups (168
//     registers a thread, too few for S, P and O at d 128), where two
//     warpgroups alone get 255.
//   * The grid is (bh, q tiles) with the q tiles taken in reverse, so under
//     a causal mask the blocks with the most kv tiles start first.
// The two warpgroups overlap only as the SM schedules them: each waits on
// its own products before its softmax.  Overlapping a warpgroup's softmax
// with its own PV product, with or without the two warpgroups taking turns
// at the tensor cores (FlashAttention-3's schedule), measured slower in
// this loop on an H100 (PERF.md), so it is not here.
//
// Semantics kept from the TPU kernel: m starts at the finite -1e30 and a
// masked score is -1e30, so a row that sees no key inside a visible tile
// keeps m = -1e30 and l counts the masked columns (o is garbage a merge
// weights by zero); columns past s_k take no part in max, sum or product;
// the causal tile skip follows the runtime offsets, and a hop whose kv
// shard lies wholly in the future runs no tile (o 0, m -1e30, l 0); l sums
// the f32 p, and p is rounded to bf16 only for the PV product.
//
// Head dims: the loop is built for padded widths D of 64, 128 and 256.  The
// tensor maps zero-fill the columns past d, so they add nothing to S, and
// the epilogues write no column past d.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace sm90 {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The tile of one block at padded head dim D: NC warpgroups of 64 q rows,
// BK kv rows a tile, STAGES tiles of K and V in the ring.  Each tile sits
// in shared memory as 64-column panels of 128-byte rows, as TMA writes
// them with the 128-byte swizzle.
template <int D_, int BK_, int NC_, int STAGES_>
struct Tile {
  static constexpr int D = D_, BK = BK_, NC = NC_, STAGES = STAGES_;
  static constexpr int BQ = 64 * NC, NT = NC * 128, NP = D / 64;
  // the o accumulator as NH wgmma products of width 2 * NO columns
  static constexpr int NH = D > 128 ? D / 128 : 1, NO = (D > 128 ? 128 : D) / 2;
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BK * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL, KV_BYTES = NP * KV_PANEL;
  static constexpr int BARS = Q_BYTES + 2 * STAGES * KV_BYTES;
  // 1024 bytes of slack to align the tiles for the swizzle
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 4 * STAGES);
  static_assert(D % 64 == 0 && BK % 16 == 0, "tile shape");
};

using Tile64 = Tile<64, 128, 2, 3>;
using Tile128 = Tile<128, 128, 2, 3>;
using Tile256 = Tile<256, 64, 1, 3>;

// The problem as the kernels see it: q (b, s_q, h, d) and k, v (b, s_k, h,
// d) through the tensor maps, block bh = b * h + head, causal mask at
// global positions (q_off + row, kv_off + col).
struct Args {
  int h, s_q, s_k, d;
  float scale_log2;  // scale * log2(e)
  int causal, q_off, kv_off;
};

struct Maps {
  CUtensorMap q, k, v;
};

// -- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (d, h, s, b) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); `lbo` is the byte stride
// between 64-column panels (read only for the MN-major V operand).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= Q K^T over one k16 step, m64n64k16, both operands from shared
// memory (K-major, 128-byte swizzle); scale_d 0 overwrites S.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// S (+)= Q K^T over one k16 step, m64n128k16, both operands from shared
// memory (K-major, 128-byte swizzle); scale_d 0 overwrites S.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O += P V over one k16 step, m64n64k16: P from registers (four bf16
// pairs in the accumulator layout of S), V from shared memory, MN-major
// (the transpose bit), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// O += P V over one k16 step, m64n128k16: P from registers (four bf16
// pairs in the accumulator layout of S), V from shared memory, MN-major
// (the transpose bit), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// -- the loop ------------------------------------------------------------------

// What a thread holds after the loop.  Its two rows are row[0]
// and row[1] = row[0] + 8 of the head's q sequence; for row i,
// o[h][4j + 2i + e] is column 128h + 8j + col + e of the un-normalised
// output, m[i] the row max in log2 units (-1e30 while only masked scores
// were seen) and l[i] the row sum.
template <class F>
struct Out {
  float o[F::NH][F::NO];
  float m[2], l[2];
  int row[2];
  int col, b, head, bh;
};

// One online-softmax step on the raw score tile s of this thread's rows.
// The plain path (no mask, scale >= 0) takes the row max on the raw scores
// and p = ex2(s * scale_log2 - m) as one FMA.  The general path scales
// first, then sets -1e30 past the causal limit (column c is visible while
// c <= lim + 8i) and -inf past s_k (c >= kvalid).  p overwrites s and is
// packed into bf16 pairs in the A-fragment order of the PV product; m and
// l move on, and alpha = ex2(m_prev - m) is left for rescaling o.
template <class F>
__device__ __forceinline__ void softmax_step(float (&s)[F::BK / 2], Out<F>& r,
                                             uint32_t (&p)[F::BK / 4],
                                             float (&alpha)[2], float sl,
                                             bool general, int lim,
                                             int kvalid) {
  constexpr int NJ = F::BK / 8;
  const float minus_inf = __int_as_float(0xff800000);
  float mx[2] = {minus_inf, minus_inf};
  if (!general) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + r.col + (e & 1);
        float x = c <= lim + 8 * (e / 2) ? s[4 * j + e] * sl : NEG_INF;
        x = c < kvalid ? x : minus_inf;
        s[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
  }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(r.m[i], general ? mx[i] : mx[i] * sl);
    alpha[i] = ex2(r.m[i] - m_new);
    r.m[i] = m_new;
    neg_m[i] = -m_new;
  }
  const float k = general ? 1.0f : sl;
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[4 * j + e], k, neg_m[e / 2]));
      s[4 * j + e] = pe;
      sum[e / 2] += pe;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) r.l[i] = r.l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int t = 0; t < F::BK / 4; ++t) p[t] = pack_bf16(s[2 * t], s[2 * t + 1]);
}

template <class F>
__device__ __forceinline__ void rescale_o(Out<F>& r, const float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < F::NH; ++h)
#pragma unroll
    for (int j = 0; j < F::NO / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) r.o[h][4 * j + e] *= alpha[e / 2];
}


// The online-softmax forward of one block's q tile against every visible
// kv tile; each thread leaves its rows in `r`.  Must be called with `maps`
// in the kernel's parameter space: TMA reads it there.
template <class F>
__device__ __forceinline__ void fwd_sm90(const Maps& maps, const Args& a,
                                         Out<F>& r) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + F::Q_BYTES;
  const uint32_t sV = sK + F::STAGES * F::KV_BYTES;
  // barriers: q_full, then k_full, v_full, k_empty and v_empty for each
  // stage (K is released once S is done, V once PV is)
  const uint32_t q_full = base + F::BARS;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + F::STAGES + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * F::STAGES + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * F::STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  r.bh = blockIdx.x;
  r.b = r.bh / a.h;
  r.head = r.bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::BQ;
  // causal block skip: kv tiles that start past the block's last row hold
  // nothing visible; a hop whose kv shard lies wholly in the future runs
  // no tile at all
  int n_tiles = (a.s_k + F::BK - 1) / F::BK;
  if (a.causal) {
    const int reach = a.q_off + q0 + min(F::BQ, a.s_q - q0) - 1 - a.kv_off;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / F::BK + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < F::STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), F::NC * 4);  // one arrival per warp
      mbar_init(v_empty(st), F::NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One thread (of the last warpgroup) issues every copy, two tiles
  // ahead, so either warpgroup may run a tile ahead of the other before a
  // copy waits for its release.  Every panel is loaded: columns past d
  // read as zeros.
  const bool loader = threadIdx.x == (F::NC - 1) * 128;
  // tile u into stage u % STAGES, once tile u - STAGES has left it
  auto load_tile = [&](int u) {
    if (u >= n_tiles) return;
    const int st = u % F::STAGES;
    const uint32_t free = ((u / F::STAGES) & 1) ^ 1;
    const uint32_t k_tile = sK + st * F::KV_BYTES;
    const uint32_t v_tile = sV + st * F::KV_BYTES;
    if (u >= F::STAGES) mbar_wait(k_empty(st), free);
    mbar_expect_tx(k_full(st), F::NP * F::KV_PANEL);
    for (int pn = 0; pn < F::NP; ++pn)
      tma_load(k_tile + pn * F::KV_PANEL, &maps.k, k_full(st), 64 * pn,
               r.head, u * F::BK, r.b);
    if (u >= F::STAGES) mbar_wait(v_empty(st), free);
    mbar_expect_tx(v_full(st), F::NP * F::KV_PANEL);
    for (int pn = 0; pn < F::NP; ++pn)
      tma_load(v_tile + pn * F::KV_PANEL, &maps.v, v_full(st), 64 * pn,
               r.head, u * F::BK, r.b);
  };
  // after tile t, tile t + STAGES - 1 goes into the stage tile t - 1 held
  auto refill = [&](int t) {
    if (loader) load_tile(t + F::STAGES - 1);
    __syncwarp();
  };
  if (loader) {
    mbar_expect_tx(q_full, F::NP * F::Q_PANEL);
    for (int pn = 0; pn < F::NP; ++pn)
      tma_load(sQ + pn * F::Q_PANEL, &maps.q, q_full, 64 * pn, r.head, q0,
               r.b);
    for (int u = 0; u < F::STAGES - 1; ++u) load_tile(u);
  }
  __syncwarp();

  const int wg = warp / 4;
  r.row[0] = q0 + wg * 64 + 16 * (warp % 4) + lane / 4;
  r.row[1] = r.row[0] + 8;
  r.col = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < F::NH; ++h)
#pragma unroll
    for (int i = 0; i < F::NO; ++i) r.o[h][i] = 0.0f;
  r.m[0] = r.m[1] = NEG_INF;
  r.l[0] = r.l[1] = 0.0f;
  float s[F::BK / 2];
#pragma unroll
  for (int i = 0; i < F::BK / 2; ++i) s[i] = 0.0f;
  uint32_t p[F::BK / 4];

  const uint32_t q_wg = sQ + wg * 64 * 128;  // this warpgroup's 64 rows
  // the causal limit of row[0] at kv tile 0: column c is visible while
  // c <= lim0 - k0
  const int lim0 = a.causal ? a.q_off + r.row[0] - a.kv_off : (1 << 30);
  const int wg_first = a.q_off + q0 + wg * 64;  // global row of its first row

  // one warp's release of a K or V stage
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto issue_s = [&](int t) {
    const int st = t % F::STAGES;
    const uint32_t k_tile = sK + st * F::KV_BYTES;
    mbar_wait(k_full(st), (t / F::STAGES) & 1);
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::D / 16; ++kk)
      wgmma_ss(s,
               desc_sw128(q_wg + (kk / 4) * F::Q_PANEL + (kk % 4) * 32, 16),
               desc_sw128(k_tile + (kk / 4) * F::KV_PANEL + (kk % 4) * 32, 16),
               kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int t, uint32_t (&pt)[F::BK / 4]) {
    const int st = t % F::STAGES;
    const uint32_t v_tile = sV + st * F::KV_BYTES;
    mbar_wait(v_full(st), (t / F::STAGES) & 1);
#pragma unroll
    for (int h = 0; h < F::NH; ++h) reg_fence(r.o[h]);
    reg_fence(pt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < F::NH; ++h)
        wgmma_rs(r.o[h], pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2],
                 pt[4 * kk + 3],
                 desc_sw128(v_tile + kk * 16 * 128 + 2 * h * F::KV_PANEL,
                            F::KV_PANEL));
    wgmma_commit();
  };
  auto softmax = [&](int t, uint32_t (&pt)[F::BK / 4], float (&alpha)[2]) {
    const int k0 = t * F::BK;
    const bool general =
        a.scale_log2 < 0.0f || k0 + F::BK > a.s_k ||
        (a.causal && a.kv_off + k0 + F::BK - 1 > wg_first);
    softmax_step<F>(s, r, pt, alpha, a.scale_log2, general, lim0 - k0,
                    a.s_k - k0);
  };

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % F::STAGES;
    issue_s(t);
    wgmma_wait_all();
    reg_fence(s);
    release(k_empty(st));
    float alpha[2];
    softmax(t, p, alpha);
    rescale_o(r, alpha);
    issue_pv(t, p);
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < F::NH; ++h) reg_fence(r.o[h]);
    reg_fence(p);
    release(v_empty(st));
    refill(t);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r.l[i] += __shfl_xor_sync(0xffffffffu, r.l[i], 1);
    r.l[i] += __shfl_xor_sync(0xffffffffu, r.l[i], 2);
  }
}

// -- host ----------------------------------------------------------------------

// Codes at or past MAP_ERROR are MAP_ERROR + the CUresult of a refused
// tensor map; below it, cudaError_t.
constexpr int MAP_ERROR = 10000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, found through the runtime, so the
// library needs no link against libcuda.
inline int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A bf16 tensor map over (d, h, s, b), element strides sh, ss and sb, in
// boxes of 64 columns by `rows` rows with the 128-byte swizzle.  Reads
// outside the tensor (rows past s, columns past d) fill with zeros.
inline int make_map(CUtensorMap* map, const void* ptr, int d, int h, int s,
                    int b, long long sh, long long ss, long long sb,
                    int rows) {
  EncodeTiled encode;
  if (const int err = encoder(&encode)) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h,
                              (cuuint64_t)(s > 0 ? s : 1), (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : MAP_ERROR + (int)res;
}

// Element strides (b, s, h) of one (b, s, h, d) operand.
struct Strides {
  long long b, s, h;
};

// The maps of q, k and v for tile F.
template <class F>
int make_maps(Maps* maps, const void* q, const void* k, const void* v, int b,
              int h, int s_q, int s_k, int d, Strides sq, Strides sk,
              Strides sv) {
  if (int err = make_map(&maps->q, q, d, h, s_q, b, sq.h, sq.s, sq.b, F::BQ))
    return err;
  if (int err = make_map(&maps->k, k, d, h, s_k, b, sk.h, sk.s, sk.b, F::BK))
    return err;
  return make_map(&maps->v, v, d, h, s_k, b, sv.h, sv.s, sv.b, F::BK);
}

// Launch `kernel` on `grid` with F's threads and dynamic shared memory on
// `stream`; returns the CUDA error of the launch.
template <class F, class Kernel, class... Params>
int launch(Kernel kernel, dim3 grid, void* stream, Params... params) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, F::NT, F::SMEM, (cudaStream_t)stream>>>(params...);
  return (int)cudaGetLastError();
}

// Call fn with the tile of head dim d (a multiple of 16 in [16, 256]).
template <class Fn>
int with_tile(int d, Fn&& fn) {
  if (d <= 64) return fn(Tile64{});
  if (d <= 128) return fn(Tile128{});
  return fn(Tile256{});
}

// BQ, BK, threads and dynamic shared memory of the tile of head dim d.
inline int tile_of(int d, int* out) {
  return with_tile(d, [&](auto tile) {
    using F = decltype(tile);
    out[0] = F::BQ;
    out[1] = F::BK;
    out[2] = F::NT;
    out[3] = F::SMEM;
    return 0;
  });
}

inline const char* error_string(int err) {
  static char text[96];
  if (err >= MAP_ERROR) {
    snprintf(text, sizeof text,
             "cuTensorMapEncodeTiled refused the map, CUresult %d",
             err - MAP_ERROR);
    return text;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace sm90
