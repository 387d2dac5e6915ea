// The float32 flash-attention forward tile loop, shared by K1
// (flash_partials.cu: un-normalised o, m, l) and K4 (flash_attention.cu:
// normalised o).  Each kernel runs `fwd_tile_loop` and then writes its own
// epilogue from the shared-memory state it returns.  bf16, the dtype of
// every path, runs the Hopper loop of flash_fwd_sm90.cuh instead.
//
// What bounds it.  float32 takes a plain FMA loop with no TF32, so f32
// stays exact as the TPU kernel promised: it is bounded by the card's f32
// FMA rate (67 TFLOP/s), far below its tensor cores, and is on no path.
//
// The design, kept simple:
//   * one block per (bh, q tile), the q tiles taken in reverse so that
//     under a causal mask the longest blocks start first; the kv tiles are
//     a loop inside the block, stopped at the last tile the causal mask
//     leaves visible;
//   * the online-softmax state (m, l, the o accumulator) and the score
//     tile stay in shared memory in f32;
//   * masking uses the finite -1e30 and m starts at -1e30, so a fully
//     masked row inside a visible tile behaves as on the TPU (m stays
//     -1e30, l counts the masked columns, o is garbage that a merge
//     weights by exp(-1e30 - m) = 0);
//   * the ragged edge of s_q and s_k is masked here: columns past s_k take
//     no part in max, sum or product, and the epilogues write no row past
//     s_q;
//   * the inputs are (b, s, h, d) with any row strides, rows 16-byte
//     aligned, so K4 reads its inputs where they lie.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
// 32x32 tiles keep d = 256 inside shared memory
constexpr int BQ = 32, BK = 32, PAD = 4;

__host__ __device__ constexpr size_t round_up(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory layout; row strides are padded against bank conflicts.
struct Layout {
  int ldt;  // q, k, v tiles
  int lds;  // score tile
  int ldp;  // probability tile
  int ldo;  // o accumulator
  size_t q, k, v, s, p, o, m, l, bytes;
  __host__ __device__ explicit Layout(int d) {
    ldt = d + PAD;
    lds = BK + 4;
    ldp = BK + PAD;
    ldo = d + 4;
    q = 0;
    k = q + round_up(sizeof(float) * BQ * ldt);
    v = k + round_up(sizeof(float) * BK * ldt);
    s = v + round_up(sizeof(float) * BK * ldt);
    p = s + round_up(sizeof(float) * BQ * lds);
    o = p + round_up(sizeof(float) * BQ * ldp);
    m = o + round_up(sizeof(float) * BQ * ldo);
    l = m + round_up(sizeof(float) * BQ);
    bytes = l + round_up(sizeof(float) * BQ);
  }
};

// One (b, s, h, d) operand: element (b, row, head, c) at
// p + b * sb + row * ss + head * sh + c.
struct Src {
  const float* p;
  long long sb, ss, sh;
  __device__ const float* rows(int b, int head, int row0) const {
    return p + b * sb + head * sh + row0 * ss;
  }
};

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

// Copy `rows` rows of d elements, ss apart in the source, into a tile of
// row stride ld, 16 bytes a thread; rows at or past `valid` are zero.
__device__ void load_rows(float* dst, int ld, const float* src, long long ss,
                          int d, int rows, int valid) {
  constexpr int VEC = 4;
  const int per_row = d / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = (i % per_row) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * ss + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S = Q K^T (unscaled) by plain FMA.
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

// O += P V by plain FMA.
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
// mask the scores, update (m, l), write p and rescale the row of the o
// accumulator by alpha = exp(m_prev - m_cur).
__device__ void softmax_step(const float* sS, float* sP, float* sO, float* sM,
                             float* sL, int lds, int ldp, int ldo, int d,
                             float scale, bool causal, int row0, int col0,
                             int kvalid) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += NW) {
    const int c = lane;  // BK == 32: one column a lane
    float sc = sS[r * lds + c] * scale;
    if (causal && row0 + r < col0 + c) sc = NEG_INF;
    float mx = c < kvalid ? sc : __int_as_float(0xff800000);
    mx = warp_max(mx);
    const float m_prev = sM[r], l_prev = sL[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_cur);
    const float p = c < kvalid ? expf(sc - m_cur) : 0.0f;
    sP[r * ldp + c] = p;
    const float sum = warp_sum(p);
    for (int cc = lane; cc < d; cc += 32) sO[r * ldo + cc] *= alpha;
    __syncwarp();
    if (lane == 0) {
      sM[r] = m_cur;
      sL[r] = l_prev * alpha + sum;
    }
  }
}

// What the tile loop leaves in shared memory for the epilogue: the f32 o
// accumulator (row stride ldo) and m, l of this block's q tile, which
// starts at row q0 of head `head` of batch entry b (bh = b * h + head) and
// holds qvalid rows.
struct FwdState {
  const float* sO;
  const float* sM;
  const float* sL;
  int ldo, bh, b, head, q0, qvalid;
};

// The online-softmax forward of one q tile against every visible kv tile,
// with the causal mask at global positions (q_off + row, kv_off + col).
// Ends on a barrier, so the returned state is complete for every thread.
__device__ __forceinline__ FwdState fwd_tile_loop(
    unsigned char* smem, Src q, Src k, Src v, int h, int s_q, int s_k, int d,
    float scale, int causal, int q_off, int kv_off) {
  const Layout L(d);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sK = reinterpret_cast<float*>(smem + L.k);
  float* sV = reinterpret_cast<float*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sP = reinterpret_cast<float*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);

  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qvalid = min(BQ, s_q - q0);

  load_rows(sQ, L.ldt, q.rows(b, head, q0), q.ss, d, BQ, qvalid);
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
    load_rows(sK, L.ldt, k.rows(b, head, k0), k.ss, d, BK, kvalid);
    load_rows(sV, L.ldt, v.rows(b, head, k0), v.ss, d, BK, kvalid);
    __syncthreads();
    qk(sQ, sK, sS, L.ldt, L.lds, d);
    __syncthreads();
    softmax_step(sS, sP, sO, sM, sL, L.lds, L.ldp, L.ldo, d, scale,
                 causal != 0, q_off + q0, kv_off + k0, kvalid);
    __syncthreads();
    pv(sP, sV, sO, L.ldp, L.ldt, L.ldo, d);
  }
  __syncthreads();
  return FwdState{sO, sM, sL, L.ldo, bh, b, head, q0, qvalid};
}

// Launch `kernel` with one block per (bh, q tile) and the layout's dynamic
// shared memory on `stream`; returns the CUDA error of the launch.
template <typename Kernel, typename... Args>
int launch_fwd(Kernel kernel, int bh, int s_q, int d, void* stream,
               Args... args) {
  const Layout L(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s_q + BQ - 1) / BQ);
  kernel<<<grid, NT, L.bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
