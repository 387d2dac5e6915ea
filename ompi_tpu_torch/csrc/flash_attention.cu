// K4: normalised flash attention for Hopper (sm_90a).
//
// Replaces `_flash_kernel` in ompi_tpu/ops/attention.py (the Pallas TPU
// kernel behind `flash_attention`): softmax(Q K^T * scale) V over
// (bh, s, d) inputs with both sequences starting at position 0, the
// causal mask optional and aligned at the top left (row i sees the
// columns j <= i, so rows at or past s_k see every column when s_q > s_k).
//
// It runs K1's tile loop (flash_fwd.cuh, where what bounds it and what its
// design does about that are set out) with zero offsets, and its own
// epilogue: the f32 accumulator divided by max(l, 1e-20), as the TPU
// kernel's last kv step does, cast to the storage dtype and written as
// (bh, s_q, d).  No m or l leaves the block and no f32 output goes
// through device memory, so one launch is the whole of the function.
//
// Interface: plain C, launched on the caller's stream, allocates nothing.
// Each entry point returns cudaGetLastError() after the launch.

#include "flash_fwd.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int s_q,
                     int s_k, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdState st = fwd_tile_loop<T>(smem, q, k, v, s_q, s_k, d, scale,
                                       causal, 0, 0);
  const size_t q_base = (size_t)st.bh * s_q * d;
  for (int i = threadIdx.x; i < st.qvalid * d; i += NT) {
    const int r = i / d, c = i % d;
    const float denom = fmaxf(st.sL[r], 1e-20f);
    from_f32(st.sO[r * st.ldo + c] / denom,
             &o[q_base + (size_t)(st.q0 + r) * d + c]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_q, int s_k, int d, float scale, int causal, void* stream) {
  return launch_fwd<T>(attention_kernel<T>, bh, s_q, d, stream, (const T*)q,
                       (const T*)k, (const T*)v, (T*)o, s_q, s_k, d, scale,
                       causal);
}

}  // namespace

extern "C" {

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int bh, int s_q, int s_k, int d,
                         float scale, int causal, void* stream) {
  return launch<bf16>(q, k, v, o, bh, s_q, s_k, d, scale, causal, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int bh, int s_q, int s_k, int d, float scale,
                        int causal, void* stream) {
  return launch<float>(q, k, v, o, bh, s_q, s_k, d, scale, causal, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
