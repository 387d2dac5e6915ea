// The flash-attention backward for Hopper (sm_90a) in bf16 at head dims up
// to 128: K2 (dK, dV of one kv tile) and K3 (dQ of one q tile), included
// by flash_bwd.cu.  The PTX helpers, the 4-D tensor maps and the launch
// conventions are those of the forward loop (flash_fwd_sm90.cuh).
//
// What bounds them.  At the flagship shape (bh 64, s 2048, d 128, causal)
// K2 does four causal products (S^T, dP^T, P^T dO, dS^T Q: 137.5 GFLOP,
// ~139 us at the H100's 989 TFLOP/s) and K3 three (S, dP, dS K: 103.1
// GFLOP, ~104 us), against 169-202 MB of traffic (50-60 us at 3.35 TB/s):
// both are bounded by operations, with one exp per visible score beside.
//
// What the design does about it (FlashAttention-3's backward, with dQ
// kept in a kernel of its own instead of atomics, so every sum is
// deterministic):
//   * K2: one block of two warpgroups owns BK = 128 kv rows, 64 per
//     warpgroup; K and V arrive once by TMA and stay.  The block streams q
//     in tiles of BQ = 64 rows and computes the scores transposed:
//     S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in shared
//     memory (M = kv rows, N = q columns), so P^T and dS^T land in the
//     accumulator layout that is already the A fragment of the next two
//     products: dV += P^T dO and dK += dS^T Q run with A from registers and
//     dO or Q as the MN-major B operand (the transpose bit).  dK and dV
//     are f32 accumulators in registers until the epilogue; P and dS never
//     touch shared memory.  lse and delta belong to the columns, so they
//     travel with each q tile (two 1-D TMA boxes, each started at the
//     16-byte boundary at or before the tile's first value) and each
//     thread reads its columns' values from shared memory.
//   * K3: one block of two warpgroups owns BQ = 128 q rows, 64 per
//     warpgroup; Q and dO arrive once by TMA, lse and delta are the
//     thread's own two rows, read once.  K and V stream through the ring.
//     S = Q K^T and dP = dO V^T are wgmma from shared memory, dS is
//     computed and packed to bf16 in registers, and dQ += dS K runs with
//     dS from registers and K as the MN-major B operand; dQ stays an f32
//     register accumulator.
//   * Q/dO (K2) or K/V (K3) arrive by TMA (128-byte swizzle, the layout the
//     wgmma descriptors read) into a ring of STAGES tiles with full and
//     empty mbarriers; one thread of the trailing warpgroup issues the
//     copies, STAGES - 1 tiles ahead, as in the forward (no producer warp:
//     it would cost the block its 255-register budget).
//   * p = ex2(s * scale * log2(e) - lse * log2(e)): one FMA and one ex2.
//     The mask runs only on tiles that cross the diagonal or the ragged
//     edge.  Under causal masking the grid takes the longest tiles first:
//     K2's kv tile 0 walks every q tile, K3's last q tile every kv tile.
//
// Semantics kept from the TPU kernels and the plain versions: a causally
// masked score gives p = 0 (exp(-1e30 - lse)); TMA fills rows past s_q and
// s_k with zeros, and a zero score is not p = 0, so columns past s_q (K2)
// or s_k (K3) are given p = 0 explicitly, and the lse and delta read past
// s_q (the next head's, or zeros) only ever meet p = 0; p and ds are
// rounded to bf16 before their products, every sum is f32 and is rounded
// to bf16 once in the epilogue; rows past s_k (K2) or s_q (K3) and columns
// past d are not written.  Causal masking is top-left: q row i sees kv
// column j <= i.

#pragma once

#include "flash_fwd_sm90.cuh"

namespace sm90 {
namespace bwd {

using bf16 = __nv_bfloat16;

// K2's tile at padded head dim D: NC = 2 warpgroups of 64 kv rows (BK =
// 128), q streamed in tiles of BQ = 64 rows through STAGES ring slots.
template <int D_, int STAGES_>
struct DkdvTile {
  static constexpr int D = D_, STAGES = STAGES_, NC = 2;
  static constexpr int BK = 64 * NC, BQ = 64, NT = NC * 128, NP = D / 64;
  static constexpr int KV_PANEL = BK * 128, Q_PANEL = BQ * 128;
  static constexpr int KV_BYTES = NP * KV_PANEL, Q_BYTES = NP * Q_PANEL;
  // lse or delta of one q tile: a box of BQ + 4 values from the 16-byte
  // boundary at or before the tile's first value, in a slot of VEC floats
  // (TMA writes shared memory at 128-byte boundaries)
  static constexpr int VEC_BOX = BQ + 4, VEC = (VEC_BOX + 31) / 32 * 32;
  static constexpr int VEC_BYTES = VEC * 4;
  // K, V; Q and dO of each stage; lse and delta of each stage
  static constexpr int BARS =
      2 * KV_BYTES + 2 * STAGES * Q_BYTES + 2 * STAGES * VEC_BYTES;
  // 1024 bytes of slack to align the tiles for the swizzle
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(D == 64 || D == 128, "K2's wgmma path takes D 64 or 128");
};

// K3's tile at padded head dim D: NC = 2 warpgroups of 64 q rows (BQ =
// 128), K and V streamed in tiles of BK rows through STAGES ring slots.
template <int D_, int BK_, int STAGES_>
struct DqTile {
  static constexpr int D = D_, BK = BK_, STAGES = STAGES_, NC = 2;
  static constexpr int BQ = 64 * NC, NT = NC * 128, NP = D / 64;
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BK * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL, KV_BYTES = NP * KV_PANEL;
  // Q, dO; K and V of each stage
  static constexpr int BARS = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 4 * STAGES);
  static_assert((D == 64 || D == 128) && (BK == 64 || BK == 128),
                "K3's wgmma path takes D and BK of 64 or 128");
};

// (bh, s, d) contiguous operands as (b = bh, s, h = 1, d) tensor maps, q
// and dO in BQ-row boxes, k and v in BK-row boxes; lse and delta (K2 only)
// as flat f32 vectors of bh * s_q.
struct BwdMaps {
  Maps qkv;
  CUtensorMap dO, lse, delta;
};

struct BwdArgs {
  int s_q, s_k, d;
  float scale;       // ds = p (dp - delta) scale
  float scale_log2;  // scale * log2(e)
  int causal;
};

// One box of a 1-D tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// One warp's release of a ring slot.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void store_pair(bf16* at, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(lo, hi);
}

// K2: dK and dV of the kv tile blockIdx.y of head blockIdx.x, looping over
// the q tiles that see it.  Each thread holds rows kr and kr + 8 of its
// warpgroup's 64 kv rows; acc[4j + 2i + e] is column 8j + c2 + e of row
// kr + 8i.
template <class F>
__global__ void __launch_bounds__(F::NT, 1)
    dkdv_sm90(const __grid_constant__ BwdMaps maps, const BwdArgs a,
              bf16* __restrict__ dk, bf16* __restrict__ dv) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + F::KV_BYTES;
  const uint32_t sQ = sV + F::KV_BYTES;
  const uint32_t sDO = sQ + F::STAGES * F::Q_BYTES;
  const uint32_t sVec = sDO + F::STAGES * F::Q_BYTES;
  const float* vec = reinterpret_cast<const float*>(smem_raw + (sVec - raw));
  // barriers: kv_full, then full and empty for each stage
  const uint32_t kv_full = base + F::BARS;
  auto full = [&](int st) { return kv_full + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8 * (1 + F::STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int bh = blockIdx.x, k0 = blockIdx.y * F::BK;
  // causal skip: the q loop starts at the first q tile whose last row
  // reaches the kv tile's first column; a kv tile past s_q sees none
  const int n_q = (a.s_q + F::BQ - 1) / F::BQ;
  const int t0 = a.causal ? min(k0 / F::BQ, n_q) : 0;
  const int n_tiles = n_q - t0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < F::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), F::NC * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const bool loader = threadIdx.x == (F::NC - 1) * 128;
  // q tile u of the loop (global tile t0 + u) into stage u % STAGES, once
  // tile u - STAGES has left it
  auto load_tile = [&](int u) {
    if (u >= n_tiles) return;
    const int st = u % F::STAGES;
    if (u >= F::STAGES) mbar_wait(empty(st), ((u / F::STAGES) & 1) ^ 1);
    const int q0 = (t0 + u) * F::BQ;
    const uint32_t bar = full(st);
    mbar_expect_tx(bar, 2 * F::Q_BYTES + 2 * F::VEC_BOX * 4);
    for (int pn = 0; pn < F::NP; ++pn) {
      tma_load(sQ + st * F::Q_BYTES + pn * F::Q_PANEL, &maps.qkv.q, bar,
               64 * pn, 0, q0, bh);
      tma_load(sDO + st * F::Q_BYTES + pn * F::Q_PANEL, &maps.dO, bar,
               64 * pn, 0, q0, bh);
    }
    const uint32_t v = sVec + st * 2 * F::VEC_BYTES;
    const int at = (bh * a.s_q + q0) & ~3;
    tma_load_1d(v, &maps.lse, bar, at);
    tma_load_1d(v + F::VEC_BYTES, &maps.delta, bar, at);
  };
  if (loader && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * F::KV_BYTES);
    for (int pn = 0; pn < F::NP; ++pn) {
      tma_load(sK + pn * F::KV_PANEL, &maps.qkv.k, kv_full, 64 * pn, 0, k0, bh);
      tma_load(sV + pn * F::KV_PANEL, &maps.qkv.v, kv_full, 64 * pn, 0, k0, bh);
    }
    for (int u = 0; u < F::STAGES - 1; ++u) load_tile(u);
  }
  __syncwarp();

  const int kr = k0 + wg * 64 + 16 * (warp % 4) + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int wg_last = k0 + wg * 64 + 63;  // this warpgroup's last kv row
  float dk_acc[F::D / 2], dv_acc[F::D / 2];
#pragma unroll
  for (int x = 0; x < F::D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.0f;
  float s[32], dp[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.0f;
  uint32_t p16[16], ds16[16];
  const uint32_t k_wg = sK + wg * 64 * 128, v_wg = sV + wg * 64 * 128;

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int u = 0; u < n_tiles; ++u) {
    const int st = u % F::STAGES;
    const int q0 = (t0 + u) * F::BQ;
    const uint32_t q_tile = sQ + st * F::Q_BYTES;
    const uint32_t do_tile = sDO + st * F::Q_BYTES;
    mbar_wait(full(st), (u / F::STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 kv rows by 64 q columns
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::D / 16; ++kk)
      wgmma_ss(s, desc_sw128(k_wg + (kk / 4) * F::KV_PANEL + (kk % 4) * 32, 16),
               desc_sw128(q_tile + (kk / 4) * F::Q_PANEL + (kk % 4) * 32, 16),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < F::D / 16; ++kk)
      wgmma_ss(dp,
               desc_sw128(v_wg + (kk / 4) * F::KV_PANEL + (kk % 4) * 32, 16),
               desc_sw128(do_tile + (kk / 4) * F::Q_PANEL + (kk % 4) * 32, 16),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // P^T and dS^T in place.  Column q0 + c (c = 8j + c2 + e) is visible
    // from kv row kr + 8i while c >= kr + 8i - q0 (causal) and c < s_q - q0.
    const float* lse = vec + st * 2 * F::VEC + ((bh * a.s_q + q0) & 3);
    const float* delta = lse + F::VEC;
    const bool general = (a.causal && q0 < wg_last) || q0 + F::BQ > a.s_q;
    const int lim = a.causal ? kr - q0 : -(1 << 30);
    const int qvalid = a.s_q - q0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float neg_lse[2] = {-lse[8 * j + c2] * LOG2E,
                                -lse[8 * j + c2 + 1] * LOG2E};
      const float dl[2] = {delta[8 * j + c2], delta[8 * j + c2 + 1]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          float p = ex2(fmaf(s[x], a.scale_log2, neg_lse[e]));
          if (general) {
            const int c = 8 * j + c2 + e;
            if (c < lim + 8 * i || c >= qvalid) p = 0.0f;
          }
          dp[x] = p * (dp[x] - dl[e]) * a.scale;
          s[x] = p;
        }
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      p16[t] = pack_bf16(s[2 * t], s[2 * t + 1]);
      ds16[t] = pack_bf16(dp[2 * t], dp[2 * t + 1]);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    reg_fence(p16);
    reg_fence(ds16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::BQ / 16; ++kk) {
      wgmma_rs(dv_acc, p16[4 * kk], p16[4 * kk + 1], p16[4 * kk + 2],
               p16[4 * kk + 3],
               desc_sw128(do_tile + kk * 16 * 128, F::Q_PANEL));
      wgmma_rs(dk_acc, ds16[4 * kk], ds16[4 * kk + 1], ds16[4 * kk + 2],
               ds16[4 * kk + 3],
               desc_sw128(q_tile + kk * 16 * 128, F::Q_PANEL));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    reg_fence(p16);
    reg_fence(ds16);
    release(empty(st));
    if (loader) load_tile(u + F::STAGES - 1);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kr + 8 * i;
    if (row >= a.s_k) continue;
    const size_t at = ((size_t)bh * a.s_k + row) * a.d;
#pragma unroll
    for (int j = 0; j < F::D / 8; ++j) {
      const int c = 8 * j + c2;
      if (c < a.d) {
        const int x = 4 * j + 2 * i;
        store_pair(dk + at + c, dk_acc[x], dk_acc[x + 1]);
        store_pair(dv + at + c, dv_acc[x], dv_acc[x + 1]);
      }
    }
  }
}

// K3: dQ of the q tile of head blockIdx.x, the q tiles taken in reverse
// so that under a causal mask the blocks with the most kv tiles start
// first.  Each thread holds rows row and row + 8 of its warpgroup's 64.
template <class F>
__global__ void __launch_bounds__(F::NT, 1)
    dq_sm90(const __grid_constant__ BwdMaps maps, const BwdArgs a,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = sQ + F::Q_BYTES;
  const uint32_t sK = sDO + F::Q_BYTES;
  const uint32_t sV = sK + F::STAGES * F::KV_BYTES;
  // barriers: q_full, then k_full, v_full, k_empty and v_empty for each
  // stage (V is released once dP is done, K once dQ's product is)
  const uint32_t q_full = base + F::BARS;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + F::STAGES + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * F::STAGES + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * F::STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::BQ;
  // causal skip: the kv loop ends at the tile holding the block's last row
  int n_tiles = (a.s_k + F::BK - 1) / F::BK;
  if (a.causal)
    n_tiles = min(n_tiles, (q0 + min(F::BQ, a.s_q - q0) - 1) / F::BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < F::STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), F::NC * 4);
      mbar_init(v_empty(st), F::NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const bool loader = threadIdx.x == (F::NC - 1) * 128;
  auto load_tile = [&](int u) {
    if (u >= n_tiles) return;
    const int st = u % F::STAGES;
    const uint32_t free = ((u / F::STAGES) & 1) ^ 1;
    if (u >= F::STAGES) mbar_wait(k_empty(st), free);
    mbar_expect_tx(k_full(st), F::KV_BYTES);
    for (int pn = 0; pn < F::NP; ++pn)
      tma_load(sK + st * F::KV_BYTES + pn * F::KV_PANEL, &maps.qkv.k,
               k_full(st), 64 * pn, 0, u * F::BK, bh);
    if (u >= F::STAGES) mbar_wait(v_empty(st), free);
    mbar_expect_tx(v_full(st), F::KV_BYTES);
    for (int pn = 0; pn < F::NP; ++pn)
      tma_load(sV + st * F::KV_BYTES + pn * F::KV_PANEL, &maps.qkv.v,
               v_full(st), 64 * pn, 0, u * F::BK, bh);
  };
  if (loader && n_tiles > 0) {
    mbar_expect_tx(q_full, 2 * F::Q_BYTES);
    for (int pn = 0; pn < F::NP; ++pn) {
      tma_load(sQ + pn * F::Q_PANEL, &maps.qkv.q, q_full, 64 * pn, 0, q0, bh);
      tma_load(sDO + pn * F::Q_PANEL, &maps.dO, q_full, 64 * pn, 0, q0, bh);
    }
    for (int u = 0; u < F::STAGES - 1; ++u) load_tile(u);
  }
  __syncwarp();

  const int row = q0 + wg * 64 + 16 * (warp % 4) + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int wg_first = q0 + wg * 64;  // this warpgroup's first q row
  // lse (in log2 units, negated) and delta of rows row and row + 8; rows
  // past s_q read nothing and are not written
  float neg_lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = row + 8 * i < a.s_q;
    const size_t at = (size_t)bh * a.s_q + row + 8 * i;
    neg_lse[i] = live ? -lse[at] * LOG2E : 0.0f;
    dl[i] = live ? delta[at] : 0.0f;
  }
  float dq_acc[F::D / 2];
#pragma unroll
  for (int x = 0; x < F::D / 2; ++x) dq_acc[x] = 0.0f;
  float s[F::BK / 2], dp[F::BK / 2];
#pragma unroll
  for (int x = 0; x < F::BK / 2; ++x) s[x] = dp[x] = 0.0f;
  uint32_t ds16[F::BK / 4];
  const uint32_t q_wg = sQ + wg * 64 * 128, do_wg = sDO + wg * 64 * 128;
  // column c is visible from row + 8i while c <= row + 8i (causal)
  const int lim = a.causal ? row : (1 << 30);

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % F::STAGES;
    const uint32_t phase = (t / F::STAGES) & 1;
    const uint32_t k_tile = sK + st * F::KV_BYTES;
    const uint32_t v_tile = sV + st * F::KV_BYTES;
    const int k0 = t * F::BK;

    // S = Q K^T and dP = dO V^T, 64 q rows by BK kv columns
    mbar_wait(k_full(st), phase);
    mbar_wait(v_full(st), phase);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::D / 16; ++kk)
      wgmma_ss(s, desc_sw128(q_wg + (kk / 4) * F::Q_PANEL + (kk % 4) * 32, 16),
               desc_sw128(k_tile + (kk / 4) * F::KV_PANEL + (kk % 4) * 32, 16),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < F::D / 16; ++kk)
      wgmma_ss(dp,
               desc_sw128(do_wg + (kk / 4) * F::Q_PANEL + (kk % 4) * 32, 16),
               desc_sw128(v_tile + (kk / 4) * F::KV_PANEL + (kk % 4) * 32, 16),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);
    release(v_empty(st));

    // dS in place of S, packed to bf16 pairs as the A fragment of dS K
    const bool general = (a.causal && k0 + F::BK - 1 > wg_first) ||
                         k0 + F::BK > a.s_k;
#pragma unroll
    for (int j = 0; j < F::BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          float p = ex2(fmaf(s[x], a.scale_log2, neg_lse[i]));
          if (general) {
            const int c = k0 + 8 * j + c2 + e;
            if (c > lim + 8 * i || c >= a.s_k) p = 0.0f;
          }
          s[x] = p * (dp[x] - dl[i]) * a.scale;
        }
#pragma unroll
    for (int x = 0; x < F::BK / 4; ++x)
      ds16[x] = pack_bf16(s[2 * x], s[2 * x + 1]);

    // dQ += dS K over the tile's BK kv rows
    reg_fence(dq_acc);
    reg_fence(ds16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::BK / 16; ++kk)
      wgmma_rs(dq_acc, ds16[4 * kk], ds16[4 * kk + 1], ds16[4 * kk + 2],
               ds16[4 * kk + 3],
               desc_sw128(k_tile + kk * 16 * 128, F::KV_PANEL));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dq_acc);
    reg_fence(ds16);
    release(k_empty(st));
    if (loader) load_tile(t + F::STAGES - 1);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= a.s_q) continue;
    bf16* out = dq + ((size_t)bh * a.s_q + r) * a.d;
#pragma unroll
    for (int j = 0; j < F::D / 8; ++j) {
      const int c = 8 * j + c2;
      if (c < a.d)
        store_pair(out + c, dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
    }
  }
}

// -- host --------------------------------------------------------------------

using Dkdv64 = DkdvTile<64, 3>;
using Dkdv128 = DkdvTile<128, 3>;
using Dq64 = DqTile<64, 64, 3>;
using Dq128 = DqTile<128, 64, 3>;

// An f32 tensor map over a flat vector of n values, in boxes of `box`
// values, no swizzle; reads past the end fill with zeros.
inline int make_map_1d(CUtensorMap* map, const void* ptr, long long n,
                       int box) {
  EncodeTiled encode;
  if (const int err = encoder(&encode)) return err;
  const cuuint64_t dims[1] = {(cuuint64_t)(n > 0 ? n : 1)};
  const cuuint64_t strides[1] = {4};  // rank 1 has no stride; not read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : MAP_ERROR + (int)res;
}

template <class F>
int make_bwd_maps(BwdMaps* maps, const void* q, const void* k, const void* v,
                  const void* dO, int bh, int s_q, int s_k, int d) {
  const Strides sq{(long long)s_q * d, d, d}, sk{(long long)s_k * d, d, d};
  if (int err = make_maps<F>(&maps->qkv, q, k, v, bh, 1, s_q, s_k, d, sq,
                             sk, sk))
    return err;
  return make_map(&maps->dO, dO, d, 1, s_q, bh, sq.h, sq.s, sq.b, F::BQ);
}

template <class F>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dO,
                const void* lse, const void* delta, void* dk, void* dv,
                int bh, int s_q, int s_k, int d, float scale, int causal,
                void* stream) {
  // the lse/delta boxes start at bh * s_q + q0, a 32-bit coordinate
  if ((long long)bh * s_q >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  BwdMaps maps{};
  if (int err = make_bwd_maps<F>(&maps, q, k, v, dO, bh, s_q, s_k, d))
    return err;
  const long long n = (long long)bh * s_q;
  if (int err = make_map_1d(&maps.lse, lse, n, F::VEC_BOX)) return err;
  if (int err = make_map_1d(&maps.delta, delta, n, F::VEC_BOX)) return err;
  const BwdArgs a{s_q, s_k, d, scale, scale * LOG2E, causal};
  // one block per (bh, kv tile)
  return launch<F>(dkdv_sm90<F>, dim3(bh, (s_k + F::BK - 1) / F::BK), stream,
                   maps, a, (bf16*)dk, (bf16*)dv);
}

template <class F>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int bh, int s_q,
              int s_k, int d, float scale, int causal, void* stream) {
  BwdMaps maps{};
  if (int err = make_bwd_maps<F>(&maps, q, k, v, dO, bh, s_q, s_k, d))
    return err;
  const BwdArgs a{s_q, s_k, d, scale, scale * LOG2E, causal};
  // one block per (bh, q tile)
  return launch<F>(dq_sm90<F>, dim3(bh, (s_q + F::BQ - 1) / F::BQ), stream,
                   maps, a, (const float*)lse, (const float*)delta,
                   (bf16*)dq);
}

}  // namespace bwd
}  // namespace sm90
