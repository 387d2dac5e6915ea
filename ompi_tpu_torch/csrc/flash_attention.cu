// K4: normalised flash attention for Hopper (sm_90a).
//
// Replaces `_flash_kernel` in ompi_tpu/ops/attention.py (the Pallas TPU
// kernel behind `flash_attention`): softmax(Q K^T * scale) V over
// (b, s, h, d) inputs with both sequences starting at position 0, the
// causal mask optional and aligned at the top left (row i sees the
// columns j <= i, so rows at or past s_k see every column when s_q > s_k).
//
// It runs K1's tile loops (flash_fwd_sm90.cuh for bf16, flash_fwd.cuh for
// float32, where what bounds them and what their design does about that
// are set out) with zero offsets, and its own epilogue: the f32
// accumulator divided by max(l, 1e-20), as the TPU kernel's last kv step
// does, cast to the storage dtype.  q, k and v are read where they lie,
// through their strides, and the output is written as (b, s_q, h, d), so
// no fold, copy or f32 output goes through device memory: one launch is
// the whole of the function.
//
// Interface: plain C, launched on the caller's stream, allocates nothing.
// Strides are in elements, in the order (b, s, h); d is contiguous.  Each
// entry point returns the error of the launch (see
// flash_attention_error_string).

#include "flash_fwd.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

template <class F>
__global__ void __launch_bounds__(F::NT, 1)
    attention_sm90(const __grid_constant__ sm90::Maps maps,
                   const sm90::Args a, __nv_bfloat16* __restrict__ o) {
  sm90::Out<F> r;
  sm90::fwd_sm90<F>(maps, a, r);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r.row[i];
    if (row >= a.s_q) continue;
    const float inv = 1.0f / fmaxf(r.l[i], 1e-20f);
    __nv_bfloat16* orow =
        o + (((size_t)r.b * a.s_q + row) * a.h + r.head) * a.d;
#pragma unroll
    for (int h = 0; h < F::NH; ++h)
#pragma unroll
      for (int j = 0; j < F::NO / 4; ++j) {
        const int c = 128 * h + 8 * j + r.col;
        if (c < a.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(r.o[h][4 * j + 2 * i] * inv,
                                    r.o[h][4 * j + 2 * i + 1] * inv);
      }
  }
}

__global__ void __launch_bounds__(NT)
    attention_f32(Src q, Src k, Src v, float* __restrict__ o, int h, int s_q,
                  int s_k, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdState st = fwd_tile_loop(smem, q, k, v, h, s_q, s_k, d, scale,
                                    causal, 0, 0);
  for (int i = threadIdx.x; i < st.qvalid * d; i += NT) {
    const int r = i / d, c = i % d;
    const float denom = fmaxf(st.sL[r], 1e-20f);
    o[(((size_t)st.b * s_q + st.q0 + r) * h + st.head) * d + c] =
        st.sO[r * st.ldo + c] / denom;
  }
}

}  // namespace

extern "C" {

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int b, int h, int s_q, int s_k, int d,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, void* stream) {
  const sm90::Args a{h, s_q, s_k, d, scale * sm90::LOG2E, causal, 0, 0};
  return sm90::with_tile(d, [&](auto tile) {
    using F = decltype(tile);
    sm90::Maps maps;
    if (int err = sm90::make_maps<F>(&maps, q, k, v, b, h, s_q, s_k, d,
                                     {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                                     {v_sb, v_ss, v_sh}))
      return err;
    // one block per (b * h, q tile)
    return sm90::launch<F>(attention_sm90<F>,
                           dim3(b * h, (s_q + F::BQ - 1) / F::BQ), stream,
                           maps, a, (__nv_bfloat16*)o);
  });
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int b, int h, int s_q, int s_k, int d,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int causal, void* stream) {
  const Src sq{(const float*)q, q_sb, q_ss, q_sh};
  const Src sk{(const float*)k, k_sb, k_ss, k_sh};
  const Src sv{(const float*)v, v_sb, v_ss, v_sh};
  return launch_fwd(attention_f32, b * h, s_q, d, stream, sq, sk, sv,
                    (float*)o, h, s_q, s_k, d, scale, causal);
}

// BQ, BK, threads and dynamic shared memory of the bf16 tile of head dim d
// (K1's tile too: both kernels run one loop).
int flash_attention_tile(int d, int* out) { return sm90::tile_of(d, out); }

const char* flash_attention_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
