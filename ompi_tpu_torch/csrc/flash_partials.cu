// K1: un-normalised flash-attention partials for Hopper (sm_90a).
//
// Replaces `_partials_kernel` in ompi_tpu/ops/attention.py (the Pallas TPU
// kernel behind `flash_attention_partials`): the online-softmax forward of
// one Q shard against one K/V shard, with runtime global (q, kv) position
// offsets driving the causal mask.  It emits the un-normalised o and the
// row max m and denominator l, all float32, so a caller can normalise
// (flash_mha) or merge several kv shards (ring attention).
//
// The tile loop, and what bounds it and what its design does about that,
// are in flash_fwd.cuh, which K4 (flash_attention.cu) shares.  This file
// holds K1's epilogue: o, m and l written as they stand, float32.
//
// Interface: plain C, launched on the caller's stream, allocates nothing.
// Each entry point returns cudaGetLastError() after the launch.

#include "flash_fwd.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
    partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int s_q, int s_k, int d, float scale, int causal,
                    int q_off, int kv_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdState st = fwd_tile_loop<T>(smem, q, k, v, s_q, s_k, d, scale,
                                       causal, q_off, kv_off);
  const size_t q_base = (size_t)st.bh * s_q * d;
  for (int i = threadIdx.x; i < st.qvalid * d; i += NT) {
    const int r = i / d, c = i % d;
    o[q_base + (size_t)(st.q0 + r) * d + c] = st.sO[r * st.ldo + c];
  }
  for (int i = threadIdx.x; i < st.qvalid; i += NT) {
    m_out[(size_t)st.bh * s_q + st.q0 + i] = st.sM[i];
    l_out[(size_t)st.bh * s_q + st.q0 + i] = st.sL[i];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int bh, int s_q, int s_k, int d, float scale, int causal,
           int q_off, int kv_off, void* stream) {
  return launch_fwd<T>(partials_kernel<T>, bh, s_q, d, stream, (const T*)q,
                       (const T*)k, (const T*)v, (float*)o, (float*)m,
                       (float*)l, s_q, s_k, d, scale, causal, q_off, kv_off);
}

}  // namespace

extern "C" {

int flash_partials_bf16(const void* q, const void* k, const void* v, void* o,
                        void* m, void* l, int bh, int s_q, int s_k, int d,
                        float scale, int causal, int q_off, int kv_off,
                        void* stream) {
  return launch<bf16>(q, k, v, o, m, l, bh, s_q, s_k, d, scale, causal,
                      q_off, kv_off, stream);
}

int flash_partials_f32(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, int bh, int s_q, int s_k, int d,
                       float scale, int causal, int q_off, int kv_off,
                       void* stream) {
  return launch<float>(q, k, v, o, m, l, bh, s_q, s_k, d, scale, causal,
                       q_off, kv_off, stream);
}

const char* flash_partials_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
