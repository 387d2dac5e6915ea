// K2 and K3: the flash-attention backward for Hopper (sm_90a).
//
// K2 replaces `_bwd_dkdv_kernel` and K3 replaces `_bwd_dq_kernel` in
// ompi_tpu/ops/attention.py: the FlashAttention-2 backward
// (https://arxiv.org/abs/2307.08691) behind `flash_mha`'s gradient, split in
// two as the JAX package splits it.  Both recompute the probabilities from
// the saved row logsumexp instead of reading an s x s residual:
//   s  = scale * q k^T (f32, causally masked with the finite -1e30)
//   p  = exp(s - lse)                     dp = dO v^T
//   ds = p * (dp - delta) * scale         delta = rowsum(dO * o), given
//   K2: dv = sum_q p^T dO, dk = sum_q ds^T q   for one kv tile
//   K3: dq = sum_kv ds k                       for one q tile
// p and ds are cast to the storage dtype before their products, and every
// sum is an f32 accumulator cast to the storage dtype at the end, as the
// TPU kernels do.  No atomics: dq has its own kernel, so every sum is
// deterministic.  On the TPU the inner loop was the sequential innermost
// grid axis with the accumulator in VMEM scratch; here it is a loop inside
// the block, and the causal skip is K2's loop start and K3's loop end.
//
// What bounds them.  At the flagship shape (bh 64, s 2048, d 128, bf16,
// causal) one causal product is 2 d bh s(s+1)/2 = 34.4 GFLOP.  K2 does four
// (q k^T, dO v^T, p^T dO, ds^T q): 137.5 GFLOP, ~139 us of tensor-core time
// at the H100's published 989 TFLOP/s, against ~202 MB of traffic (~60 us at
// 3.35 TB/s).  K3 does three (q k^T, dO v^T, ds k): 103.1 GFLOP, ~104 us,
// against ~169 MB (~50 us).  Both are bounded by operations, with one exp
// per visible score on the SFUs beside them.
//
// The kernels, chosen by dtype and head dim before the launch:
//   * bf16, d <= 128 (padded to D = 64 or 128 by the tensor maps'
//     zero fill): the Hopper kernels of flash_bwd_sm90.cuh, where their
//     design is set out (wgmma with register-resident accumulators, K2's
//     scores transposed so P^T and dS^T are A fragments in registers, a
//     TMA/mbarrier ring, longest-first causal order);
//   * bf16, 128 < d <= 256: the first, simple form below, nvcuda::wmma
//     16x16x16 products with the score, dp and accumulator tiles in f32 in
//     shared memory, 64 q x 32 kv rows for K2 and 32 q x 64 kv rows for K3
//     so that they fit its 227 KB;
//   * float32: the same loops with plain FMA products (no TF32) on 32 x 32
//     tiles.
// In the simple form rows past s_q and columns past s_k are loaded as
// zeros and given p = 0, so they contribute nothing; rows past the end are
// not written.  Its tiles round-trip through shared memory between the
// products and the elementwise step, and loads do not overlap products.
//
// Interface: plain C, launched on the caller's stream, allocates nothing.
// q, k, v, dO are (bh, s, d) contiguous, lse and delta (bh, s_q) f32.  Each
// entry point returns the error of the launch (see flash_bwd_error_string).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"

namespace bw = sm90::bwd;

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;

// Row padding of the storage-dtype tiles, against bank conflicts; it keeps
// every 16x16 wmma sub-tile 32-byte aligned.
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int V = 8; };
template <> struct Pad<float> { static constexpr int V = 4; };

__host__ __device__ constexpr size_t round_up(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory layout.  K2 (DKDV) carries two f32 accumulators of BK rows
// (dk, dv) and the p tile; K3 one accumulator of BQ rows (dq).
template <typename T, int BQ, int BK, bool DKDV> struct Layout {
  static constexpr int ACC_ROWS = DKDV ? BK : BQ;
  int ldt;  // q, dO, k, v tiles (T)
  int lds;  // score and dp tiles (f32)
  int ldp;  // p and ds tiles (T)
  int ldo;  // accumulators (f32)
  size_t q, dO, k, v, s, dp, p, ds, acc0, acc1, lse, delta, bytes;
  __host__ __device__ explicit Layout(int d) {
    ldt = d + Pad<T>::V;
    lds = BK + 4;
    ldp = BK + Pad<T>::V;
    ldo = d + 4;
    q = 0;
    dO = q + round_up(sizeof(T) * BQ * ldt);
    k = dO + round_up(sizeof(T) * BQ * ldt);
    v = k + round_up(sizeof(T) * BK * ldt);
    s = v + round_up(sizeof(T) * BK * ldt);
    dp = s + round_up(sizeof(float) * BQ * lds);
    p = dp + round_up(sizeof(float) * BQ * lds);
    ds = p + (DKDV ? round_up(sizeof(T) * BQ * ldp) : 0);
    acc0 = ds + round_up(sizeof(T) * BQ * ldp);
    acc1 = acc0 + round_up(sizeof(float) * ACC_ROWS * ldo);
    lse = acc1 + (DKDV ? round_up(sizeof(float) * ACC_ROWS * ldo) : 0);
    delta = lse + round_up(sizeof(float) * BQ);
    bytes = delta + round_up(sizeof(float) * BQ);
  }
};

__device__ inline void from_f32(float x, float* out) { *out = x; }
__device__ inline void from_f32(float x, bf16* out) {
  *out = __float2bfloat16_rn(x);
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

// Load `rows` values of a (bh, s) f32 row vector; entries past `valid` are 0.
__device__ void load_vec(float* dst, const float* src, int rows, int valid) {
  for (int i = threadIdx.x; i < rows; i += NT) dst[i] = i < valid ? src[i] : 0.f;
}

// Write the first `rows` rows of an f32 tile to global memory in T.
template <typename T>
__device__ void store_rows(T* dst, const float* src, int ld, int d,
                           int rows) {
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d, c = i % d;
    from_f32(src[r * ld + c], &dst[(size_t)r * d + c]);
  }
}

// C (M x N, f32) = A (M x K) . B^T, with B stored N x K.
template <int M, int N>
__device__ void mm_abt(const bf16* A, int lda, const bf16* B, int ldb,
                       float* C, int ldc, int K) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += NW) {
    const int i = t / (N / 16), j = t % (N / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + 16 * i * lda + kk, lda);
      wmma::load_matrix_sync(b, B + 16 * j * ldb + kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + 16 * i * ldc + 16 * j, acc, ldc,
                            wmma::mem_row_major);
  }
}

template <int M, int N>
__device__ void mm_abt(const float* A, int lda, const float* B, int ldb,
                       float* C, int ldc, int K) {
  for (int e = threadIdx.x; e < M * N; e += NT) {
    const int r = e / N, c = e % N;
    float acc = 0.0f;
    for (int kk = 0; kk < K; ++kk)
      acc = fmaf(A[r * lda + kk], B[c * ldb + kk], acc);
    C[r * ldc + c] = acc;
  }
}

// C (M x N, f32) += A^T . B, with A stored K x M and B stored K x N.
template <int M, int K>
__device__ void mm_atb_acc(const bf16* A, int lda, const bf16* B, int ldb,
                           float* C, int ldc, int N) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int nj = N / 16;
  for (int t = warp; t < (M / 16) * nj; t += NW) {
    const int i = t / nj, j = t % nj;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + 16 * i * ldc + 16 * j, ldc,
                           wmma::mem_row_major);
    for (int kk = 0; kk < K; kk += 16) {
      // the column-major view of A's rows kk.. is A^T's sub-tile (i, kk)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + kk * lda + 16 * i, lda);
      wmma::load_matrix_sync(b, B + kk * ldb + 16 * j, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + 16 * i * ldc + 16 * j, acc, ldc,
                            wmma::mem_row_major);
  }
}

template <int M, int K>
__device__ void mm_atb_acc(const float* A, int lda, const float* B, int ldb,
                           float* C, int ldc, int N) {
  for (int e = threadIdx.x; e < M * N; e += NT) {
    const int r = e / N, c = e % N;
    float acc = 0.0f;
    for (int kk = 0; kk < K; ++kk)
      acc = fmaf(A[kk * lda + r], B[kk * ldb + c], acc);
    C[r * ldc + c] += acc;
  }
}

// C (M x N, f32) += A . B, with A stored M x K and B stored K x N.
template <int M, int K>
__device__ void mm_ab_acc(const bf16* A, int lda, const bf16* B, int ldb,
                          float* C, int ldc, int N) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int nj = N / 16;
  for (int t = warp; t < (M / 16) * nj; t += NW) {
    const int i = t / nj, j = t % nj;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + 16 * i * ldc + 16 * j, ldc,
                           wmma::mem_row_major);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + 16 * i * lda + kk, lda);
      wmma::load_matrix_sync(b, B + kk * ldb + 16 * j, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + 16 * i * ldc + 16 * j, acc, ldc,
                            wmma::mem_row_major);
  }
}

template <int M, int K>
__device__ void mm_ab_acc(const float* A, int lda, const float* B, int ldb,
                          float* C, int ldc, int N) {
  for (int e = threadIdx.x; e < M * N; e += NT) {
    const int r = e / N, c = e % N;
    float acc = 0.0f;
    for (int kk = 0; kk < K; ++kk)
      acc = fmaf(A[r * lda + kk], B[kk * ldb + c], acc);
    C[r * ldc + c] += acc;
  }
}

// The elementwise step over one (q tile, kv tile) pair: from the raw
// scores s and dp, write ds = p (dp - delta) scale in T and, where sP is
// given (K2), p in T.  Masked scores take -1e30 as on the TPU; rows past
// s_q and columns past s_k take p = 0.
template <typename T, int BQ, int BK>
__device__ void grads_step(const float* sS, const float* sDP, T* sP, T* sDS,
                           const float* sLse, const float* sDelta, int lds,
                           int ldp, float scale, bool causal, int q0, int k0,
                           int qvalid, int kvalid) {
  for (int e = threadIdx.x; e < BQ * BK; e += NT) {
    const int r = e / BK, c = e % BK;
    float s = sS[r * lds + c] * scale;
    if (causal && q0 + r < k0 + c) s = NEG_INF;
    const float p = (r < qvalid && c < kvalid) ? expf(s - sLse[r]) : 0.0f;
    const float ds = p * (sDP[r * lds + c] - sDelta[r]) * scale;
    if (sP != nullptr) from_f32(p, &sP[r * ldp + c]);
    from_f32(ds, &sDS[r * ldp + c]);
  }
}

// K2: dk, dv for one kv tile, looping over the q tiles.
template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int s_q, int s_k, int d, float scale,
                int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T, BQ, BK, true> L(d);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sDO = reinterpret_cast<T*>(smem + L.dO);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  T* sDS = reinterpret_cast<T*>(smem + L.ds);
  float* sDK = reinterpret_cast<float*>(smem + L.acc0);
  float* sDV = reinterpret_cast<float*>(smem + L.acc1);
  float* sLse = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int kvalid = min(BK, s_k - k0);
  const size_t q_base = (size_t)bh * s_q * d;
  const size_t k_base = (size_t)bh * s_k * d + (size_t)k0 * d;

  load_rows(sK, L.ldt, k + k_base, d, BK, kvalid);
  load_rows(sV, L.ldt, v + k_base, d, BK, kvalid);
  for (int i = threadIdx.x; i < BK * L.ldo; i += NT) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }

  // causal skip: q tiles whose last row lies before this kv tile's first
  // column see none of it; a kv tile past s_q sees no q tile at all
  const int n_tiles = (s_q + BQ - 1) / BQ;
  for (int t = causal ? k0 / BQ : 0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    const int qvalid = min(BQ, s_q - q0);
    __syncthreads();  // the previous tile's products are done
    load_rows(sQ, L.ldt, q + q_base + (size_t)q0 * d, d, BQ, qvalid);
    load_rows(sDO, L.ldt, dO + q_base + (size_t)q0 * d, d, BQ, qvalid);
    load_vec(sLse, lse + (size_t)bh * s_q + q0, BQ, qvalid);
    load_vec(sDelta, delta + (size_t)bh * s_q + q0, BQ, qvalid);
    __syncthreads();
    mm_abt<BQ, BK>(sQ, L.ldt, sK, L.ldt, sS, L.lds, d);
    mm_abt<BQ, BK>(sDO, L.ldt, sV, L.ldt, sDP, L.lds, d);
    __syncthreads();
    grads_step<T, BQ, BK>(sS, sDP, sP, sDS, sLse, sDelta, L.lds, L.ldp,
                          scale, causal != 0, q0, k0, qvalid, kvalid);
    __syncthreads();
    mm_atb_acc<BK, BQ>(sP, L.ldp, sDO, L.ldt, sDV, L.ldo, d);
    mm_atb_acc<BK, BQ>(sDS, L.ldp, sQ, L.ldt, sDK, L.ldo, d);
  }
  __syncthreads();
  store_rows(dk + k_base, sDK, L.ldo, d, kvalid);
  store_rows(dv + k_base, sDV, L.ldo, d, kvalid);
}

// K3: dq for one q tile, looping over the kv tiles.
template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int s_q, int s_k, int d, float scale,
              int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T, BQ, BK, false> L(d);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sDO = reinterpret_cast<T*>(smem + L.dO);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  T* sDS = reinterpret_cast<T*>(smem + L.ds);
  float* sDQ = reinterpret_cast<float*>(smem + L.acc0);
  float* sLse = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qvalid = min(BQ, s_q - q0);
  const size_t q_base = (size_t)bh * s_q * d + (size_t)q0 * d;
  const size_t k_base = (size_t)bh * s_k * d;

  load_rows(sQ, L.ldt, q + q_base, d, BQ, qvalid);
  load_rows(sDO, L.ldt, dO + q_base, d, BQ, qvalid);
  load_vec(sLse, lse + (size_t)bh * s_q + q0, BQ, qvalid);
  load_vec(sDelta, delta + (size_t)bh * s_q + q0, BQ, qvalid);
  for (int i = threadIdx.x; i < BQ * L.ldo; i += NT) sDQ[i] = 0.0f;

  // causal skip: kv tiles that start past this q tile's last row
  int n_tiles = (s_k + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + qvalid - 1) / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int kvalid = min(BK, s_k - k0);
    __syncthreads();  // the previous tile's products are done with sK/sDS
    load_rows(sK, L.ldt, k + k_base + (size_t)k0 * d, d, BK, kvalid);
    load_rows(sV, L.ldt, v + k_base + (size_t)k0 * d, d, BK, kvalid);
    __syncthreads();
    mm_abt<BQ, BK>(sQ, L.ldt, sK, L.ldt, sS, L.lds, d);
    mm_abt<BQ, BK>(sDO, L.ldt, sV, L.ldt, sDP, L.lds, d);
    __syncthreads();
    grads_step<T, BQ, BK>(sS, sDP, (T*)nullptr, sDS, sLse, sDelta, L.lds,
                          L.ldp, scale, causal != 0, q0, k0, qvalid, kvalid);
    __syncthreads();
    mm_ab_acc<BQ, BK>(sDS, L.ldp, sK, L.ldt, sDQ, L.ldo, d);
  }
  __syncthreads();
  store_rows(dq + q_base, sDQ, L.ldo, d, qvalid);
}

template <typename T, int BQ, int BK>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dO,
                const void* lse, const void* delta, void* dk, void* dv,
                int bh, int s_q, int s_k, int d, float scale, int causal,
                void* stream) {
  const Layout<T, BQ, BK, true> L(d);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_k + BK - 1) / BK, bh);
  dkdv_kernel<T, BQ, BK><<<grid, NT, L.bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, s_q, s_k, d,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int bh, int s_q,
              int s_k, int d, float scale, int causal, void* stream) {
  const Layout<T, BQ, BK, false> L(d);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + BQ - 1) / BQ, bh);
  dq_kernel<T, BQ, BK><<<grid, NT, L.bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO,
      (const float*)lse, (const float*)delta, (T*)dq, s_q, s_k, d, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16: the Hopper kernels up to d = 128, the wmma loop above it, whose
// accumulator side of the tile (kv for K2, q for K3) is 32 rows to stay
// inside shared memory.
int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dO, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int s_q, int s_k, int d,
                        float scale, int causal, void* stream) {
  if (d <= 64)
    return bw::launch_dkdv<bw::Dkdv64>(q, k, v, dO, lse, delta, dk, dv, bh,
                                       s_q, s_k, d, scale, causal, stream);
  if (d <= 128)
    return bw::launch_dkdv<bw::Dkdv128>(q, k, v, dO, lse, delta, dk, dv, bh,
                                        s_q, s_k, d, scale, causal, stream);
  return launch_dkdv<bf16, 64, 32>(q, k, v, dO, lse, delta, dk, dv, bh, s_q,
                                   s_k, d, scale, causal, stream);
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, int bh, int s_q, int s_k, int d, float scale,
                      int causal, void* stream) {
  if (d <= 64)
    return bw::launch_dq<bw::Dq64>(q, k, v, dO, lse, delta, dq, bh, s_q, s_k,
                                   d, scale, causal, stream);
  if (d <= 128)
    return bw::launch_dq<bw::Dq128>(q, k, v, dO, lse, delta, dq, bh, s_q,
                                    s_k, d, scale, causal, stream);
  return launch_dq<bf16, 32, 64>(q, k, v, dO, lse, delta, dq, bh, s_q, s_k,
                                 d, scale, causal, stream);
}

int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                       const void* dO, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int s_q, int s_k, int d,
                       float scale, int causal, void* stream) {
  return launch_dkdv<float, 32, 32>(q, k, v, dO, lse, delta, dk, dv, bh, s_q,
                                    s_k, d, scale, causal, stream);
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dO, const void* lse, const void* delta,
                     void* dq, int bh, int s_q, int s_k, int d, float scale,
                     int causal, void* stream) {
  return launch_dq<float, 32, 32>(q, k, v, dO, lse, delta, dq, bh, s_q, s_k,
                                  d, scale, causal, stream);
}

// The bf16 tiles at head dim d: out[0..1] K2's q rows a step and kv rows a
// block, out[2..3] K3's q rows a block and kv rows a step, out[4] threads,
// out[5..6] K2's and K3's dynamic shared memory in bytes.
int flash_bwd_tile(int d, int* out) {
  auto put = [&](int k2_bq, int k2_bk, int k3_bq, int k3_bk, size_t k2_smem,
                 size_t k3_smem) {
    const int v[7] = {k2_bq, k2_bk, k3_bq, k3_bk, NT, (int)k2_smem,
                      (int)k3_smem};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
  };
  if (d <= 64)
    return put(bw::Dkdv64::BQ, bw::Dkdv64::BK, bw::Dq64::BQ, bw::Dq64::BK,
               bw::Dkdv64::SMEM, bw::Dq64::SMEM);
  if (d <= 128)
    return put(bw::Dkdv128::BQ, bw::Dkdv128::BK, bw::Dq128::BQ, bw::Dq128::BK,
               bw::Dkdv128::SMEM, bw::Dq128::SMEM);
  return put(64, 32, 32, 64, Layout<bf16, 64, 32, true>(d).bytes,
             Layout<bf16, 32, 64, false>(d).bytes);
}

const char* flash_bwd_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
