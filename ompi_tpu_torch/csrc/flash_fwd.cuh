// The flash-attention forward tile loop for Hopper (sm_90a), shared by K1
// (flash_partials.cu: un-normalised o, m, l) and K4 (flash_attention.cu:
// normalised o in the input dtype).  Each kernel runs `fwd_tile_loop` and
// then writes its own epilogue from the shared-memory state it returns.
//
// What bounds it.  At the flagship shape (bh 64, s 2048, d 128, bf16,
// causal) a launch does ~69 GFLOP of QK^T and PV products against
// 134-169 MB of traffic (q/k/v read once, the output written once): ~70 us
// of tensor-core time against 40-50 us of HBM time at the H100's published
// peaks, so it is bounded by operations.  The exp of every visible score
// runs on the SFUs beside that.
//
// What the design does about it.  This is the first, simple form:
//   * one block per (q tile, bh); the kv tiles are a loop inside the
//     block (on the TPU they were a sequential grid axis), and the loop
//     stops at the last tile the causal mask leaves visible;
//   * bf16 QK^T and PV run on the tensor cores through nvcuda::wmma
//     (16x16x16, f32 accumulate); float32 inputs take a plain FMA path
//     with no TF32, so f32 stays exact as the TPU kernel promised;
//   * the online-softmax state (m, l, the o accumulator) and the score
//     tile stay in shared memory in f32; p is cast to the storage dtype
//     before the PV product, as the TPU kernel does;
//   * masking uses the finite -1e30 and m starts at -1e30, so a fully
//     masked row inside a visible tile behaves as on the TPU (m stays
//     -1e30, l counts the masked columns, o is garbage that a merge
//     weights by exp(-1e30 - m) = 0);
//   * the ragged edge of s_q and s_k is masked here: columns past s_k take
//     no part in max, sum or product, and the epilogues write no row past
//     s_q.
// The score and accumulator tiles round-trip through shared memory between
// the wmma products and the softmax, and nothing overlaps loads with
// products.  Registers-resident accumulators (mma.sync or wgmma) and a
// TMA/cp.async pipeline are the later work that moves it toward its bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;

// Tile shape per storage type.  bf16: 64x64 tiles fill four warps with
// 16x16 wmma products.  f32: 32x32 keeps d = 256 inside shared memory.
template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BQ = 64, BK = 64, PAD = 8;
};
template <> struct Tile<float> {
  static constexpr int BQ = 32, BK = 32, PAD = 4;
};

__host__ __device__ constexpr size_t round_up(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory layout.  Row strides are padded against bank conflicts and
// keep every 16-row, 16-column wmma sub-tile 32-byte aligned.
template <typename T> struct Layout {
  static constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  int ldt;  // q, k, v tiles (T)
  int lds;  // score tile (f32)
  int ldp;  // probability tile (T)
  int ldo;  // o accumulator (f32)
  size_t q, k, v, s, p, o, m, l, bytes;
  __host__ __device__ explicit Layout(int d) {
    ldt = d + Tile<T>::PAD;
    lds = BK + 4;
    ldp = BK + Tile<T>::PAD;
    ldo = d + 4;
    q = 0;
    k = q + round_up(sizeof(T) * BQ * ldt);
    v = k + round_up(sizeof(T) * BK * ldt);
    s = v + round_up(sizeof(T) * BK * ldt);
    p = s + round_up(sizeof(float) * BQ * lds);
    o = p + round_up(sizeof(T) * BQ * ldp);
    m = o + round_up(sizeof(float) * BQ * ldo);
    l = m + round_up(sizeof(float) * BQ);
    bytes = l + round_up(sizeof(float) * BQ);
  }
};

__device__ inline void from_f32(float x, float* out) { *out = x; }
__device__ inline void from_f32(float x, bf16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ inline float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` rows of d elements into a tile of row stride ld, 16 bytes a
// thread; rows at or past `valid` are zero.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int d, int rows,
                          int valid) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = d / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = (i % per_row) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S = Q K^T (unscaled), bf16 on the tensor cores.
template <int BQ, int BK>
__device__ void qk(const bf16* sQ, const bf16* sK, float* sS, int ldt,
                   int lds, int d) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (BQ / 16) * (BK / 16); t += NW) {
    const int i = t / (BK / 16), j = t % (BK / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + 16 * i * ldt + kk, ldt);
      wmma::load_matrix_sync(b, sK + 16 * j * ldt + kk, ldt);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sS + 16 * i * lds + 16 * j, acc, lds,
                            wmma::mem_row_major);
  }
}

// S = Q K^T (unscaled), f32 by plain FMA (no TF32).
template <int BQ, int BK>
__device__ void qk(const float* sQ, const float* sK, float* sS, int ldt,
                   int lds, int d) {
  for (int i = threadIdx.x; i < BQ * BK; i += NT) {
    const int r = i / BK, c = i % BK;
    float acc = 0.0f;
    for (int kk = 0; kk < d; ++kk)
      acc = fmaf(sQ[r * ldt + kk], sK[c * ldt + kk], acc);
    sS[r * lds + c] = acc;
  }
}

// O += P V, bf16 on the tensor cores, accumulating into the f32 tile.
template <int BQ, int BK>
__device__ void pv(const bf16* sP, const bf16* sV, float* sO, int ldp,
                   int ldt, int ldo, int d) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int nj = d / 16;
  for (int t = warp; t < (BQ / 16) * nj; t += NW) {
    const int i = t / nj, j = t % nj;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, sO + 16 * i * ldo + 16 * j, ldo,
                           wmma::mem_row_major);
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + 16 * i * ldp + kk, ldp);
      wmma::load_matrix_sync(b, sV + kk * ldt + 16 * j, ldt);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sO + 16 * i * ldo + 16 * j, acc, ldo,
                            wmma::mem_row_major);
  }
}

// O += P V, f32 by plain FMA.
template <int BQ, int BK>
__device__ void pv(const float* sP, const float* sV, float* sO, int ldp,
                   int ldt, int ldo, int d) {
  for (int i = threadIdx.x; i < BQ * d; i += NT) {
    const int r = i / d, c = i % d;
    float acc = 0.0f;
    for (int kk = 0; kk < BK; ++kk)
      acc = fmaf(sP[r * ldp + kk], sV[kk * ldt + c], acc);
    sO[r * ldo + c] += acc;
  }
}

// One online-softmax step over a score tile, one warp per row: scale and
// mask the scores, update (m, l), write p in the storage dtype and rescale
// the row of the o accumulator by alpha = exp(m_prev - m_cur).
template <typename T, int BQ, int BK>
__device__ void softmax_step(const float* sS, T* sP, float* sO, float* sM,
                             float* sL, int lds, int ldp, int ldo, int d,
                             float scale, bool causal, int row0, int col0,
                             int kvalid) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += NW) {
    float x[BK / 32];
    float mx = __int_as_float(0xff800000);  // -inf: below any masked score
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      float sc = sS[r * lds + c] * scale;
      if (causal && row0 + r < col0 + c) sc = NEG_INF;
      x[j] = sc;
      if (c < kvalid) mx = fmaxf(mx, sc);
    }
    mx = warp_max(mx);
    const float m_prev = sM[r], l_prev = sL[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_cur);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      const float p = c < kvalid ? expf(x[j] - m_cur) : 0.0f;
      sum += p;
      from_f32(p, &sP[r * ldp + c]);
    }
    sum = warp_sum(sum);
    for (int c = lane; c < d; c += 32) sO[r * ldo + c] *= alpha;
    __syncwarp();
    if (lane == 0) {
      sM[r] = m_cur;
      sL[r] = l_prev * alpha + sum;
    }
  }
}

// What the tile loop leaves in shared memory for the epilogue: the f32 o
// accumulator (row stride ldo) and m, l of this block's q tile, which
// starts at row q0 of head bh and holds qvalid rows.
struct FwdState {
  const float* sO;
  const float* sM;
  const float* sL;
  int ldo, bh, q0, qvalid;
};

// The online-softmax forward of one q tile against every visible kv tile,
// with the causal mask at global positions (q_off + row, kv_off + col).
// Ends on a barrier, so the returned state is complete for every thread.
template <typename T>
__device__ __forceinline__ FwdState fwd_tile_loop(
    unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, int s_q, int s_k, int d, float scale,
    int causal, int q_off, int kv_off) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  const Layout<T> L(d);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qvalid = min(BQ, s_q - q0);
  const size_t q_base = (size_t)bh * s_q * d;
  const size_t k_base = (size_t)bh * s_k * d;

  load_rows(sQ, L.ldt, q + q_base + (size_t)q0 * d, d, BQ, qvalid);
  for (int i = threadIdx.x; i < BQ * L.ldo; i += NT) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    sM[i] = NEG_INF;
    sL[i] = 0.0f;
  }

  // causal block skip: kv tiles that start past this q tile's last row
  // hold nothing visible; on a hop whose kv shard lies wholly in the
  // future the loop runs no tile at all
  int n_tiles = (s_k + BK - 1) / BK;
  if (causal) {
    const int reach = (q_off + q0 + qvalid - 1) - kv_off;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int kvalid = min(BK, s_k - k0);
    __syncthreads();  // the previous tile's products are done with sK/sV/sP
    load_rows(sK, L.ldt, k + k_base + (size_t)k0 * d, d, BK, kvalid);
    load_rows(sV, L.ldt, v + k_base + (size_t)k0 * d, d, BK, kvalid);
    __syncthreads();
    qk<BQ, BK>(sQ, sK, sS, L.ldt, L.lds, d);
    __syncthreads();
    softmax_step<T, BQ, BK>(sS, sP, sO, sM, sL, L.lds, L.ldp, L.ldo, d,
                            scale, causal != 0, q_off + q0, kv_off + k0,
                            kvalid);
    __syncthreads();
    pv<BQ, BK>(sP, sV, sO, L.ldp, L.ldt, L.ldo, d);
  }
  __syncthreads();
  return FwdState{sO, sM, sL, L.ldo, bh, q0, qvalid};
}

// Launch `kernel` with one block per (q tile, bh) and the layout's dynamic
// shared memory on `stream`; returns the CUDA error of the launch.
template <typename T, typename Kernel, typename... Args>
int launch_fwd(Kernel kernel, int bh, int s_q, int d, void* stream,
               Args... args) {
  const Layout<T> L(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + Tile<T>::BQ - 1) / Tile<T>::BQ, bh);
  kernel<<<grid, NT, L.bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
