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
// TPU kernels do.
//
// What bounds them.  At the flagship shape (bh 64, s 2048, d 128, bf16,
// causal) one causal product is 2 d bh s(s+1)/2 = 34.4 GFLOP.  K2 does four
// (q k^T, dO v^T, p^T dO, ds^T q): 137.5 GFLOP, ~139 us of tensor-core time
// at the H100's published 989 TFLOP/s, against ~202 MB of traffic (~60 us at
// 3.35 TB/s).  K3 does three (q k^T, dO v^T, ds k): 103.1 GFLOP, ~104 us,
// against ~169 MB (~50 us).  Both are bounded by operations, with one exp
// per visible score on the SFUs beside them.
//
// What the design does about it.  This is the first, simple form, in the
// style of K1 (flash_partials.cu):
//   * K2: one block per (kv tile, bh) that loops over the q tiles; K3: one
//     block per (q tile, bh) that loops over the kv tiles.  On the TPU the
//     loop was the sequential innermost grid axis with the accumulator in
//     VMEM scratch.  The causal skip is K2's loop start and K3's loop end.
//     No atomics: dq has its own kernel, so every sum is deterministic;
//   * bf16 products run on the tensor cores through nvcuda::wmma
//     (16x16x16, f32 accumulate); float32 inputs take a plain FMA path with
//     no TF32;
//   * the score, dp and accumulator tiles stay in shared memory in f32.
//     The shared-memory budget (227 KB) sets the tiles: bf16 takes 64x64 up
//     to d = 128 and halves the accumulator's side of the tile above it; f32
//     takes 32x32 so that d = 256 fits (~213 KB for K2);
//   * rows past s_q and columns past s_k are loaded as zeros and given
//     p = 0, so they contribute nothing; rows past the end are not written.
// The tiles round-trip through shared memory between the wmma products
// and the elementwise step, loads do not overlap products, and one block of
// eight warps fills an SM.  Register-resident accumulators (mma.sync or
// wgmma) and a TMA/cp.async pipeline are the later work that moves them
// toward their bounds.
//
// Interface: plain C, launched on the caller's stream, allocates nothing.
// Each entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// bf16 tiles: 64x64 up to d = 128; above it the accumulator's side of the
// tile (kv for K2, q for K3) halves to 32 to stay inside shared memory.
int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dO, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int s_q, int s_k, int d,
                        float scale, int causal, void* stream) {
  if (d <= 128)
    return launch_dkdv<bf16, 64, 64>(q, k, v, dO, lse, delta, dk, dv, bh,
                                     s_q, s_k, d, scale, causal, stream);
  return launch_dkdv<bf16, 64, 32>(q, k, v, dO, lse, delta, dk, dv, bh, s_q,
                                   s_k, d, scale, causal, stream);
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, int bh, int s_q, int s_k, int d, float scale,
                      int causal, void* stream) {
  if (d <= 128)
    return launch_dq<bf16, 64, 64>(q, k, v, dO, lse, delta, dq, bh, s_q, s_k,
                                   d, scale, causal, stream);
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

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
