// K1: un-normalised flash-attention partials for Hopper (sm_90a).
//
// Replaces `_partials_kernel` in ompi_tpu/ops/attention.py (the Pallas TPU
// kernel behind `flash_attention_partials`): the online-softmax forward of
// one Q shard against one K/V shard, with runtime global (q, kv) position
// offsets driving the causal mask.  It emits the un-normalised o and the
// row max m and denominator l, all float32, so a caller can normalise
// (flash_mha) or merge several kv shards (ring attention).
//
// The tile loops, and what bounds them and what their design does about
// that, are in flash_fwd_sm90.cuh (bf16: wgmma, TMA ring, registers) and
// flash_fwd.cuh (float32: exact FMA), both shared with K4
// (flash_attention.cu).  This file holds K1's epilogues: o, m and l
// written as they stand, float32, m in natural-log units.
//
// Interface: plain C, launched on the caller's stream, allocates nothing.
// q, k, v are (bh, s, d) contiguous.  Each entry point returns the error
// of the launch (see flash_partials_error_string).

#include "flash_fwd.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

template <class F>
__global__ void __launch_bounds__(F::NT, 1)
    partials_sm90(const __grid_constant__ sm90::Maps maps,
                  const sm90::Args a, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out) {
  sm90::Out<F> r;
  sm90::fwd_sm90<F>(maps, a, r);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r.row[i];
    if (row >= a.s_q) continue;
    const size_t at = (size_t)r.bh * a.s_q + row;
    float* orow = o + at * a.d;
#pragma unroll
    for (int h = 0; h < F::NH; ++h)
#pragma unroll
      for (int j = 0; j < F::NO / 4; ++j) {
        const int c = 128 * h + 8 * j + r.col;
        if (c < a.d)
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(r.o[h][4 * j + 2 * i], r.o[h][4 * j + 2 * i + 1]);
      }
    if (r.col == 0) {
      m_out[at] = r.m[i] == sm90::NEG_INF ? sm90::NEG_INF : r.m[i] * sm90::LN2;
      l_out[at] = r.l[i];
    }
  }
}

__global__ void __launch_bounds__(NT)
    partials_f32(Src q, Src k, Src v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int s_q, int s_k, int d, float scale, int causal, int q_off,
                 int kv_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdState st = fwd_tile_loop(smem, q, k, v, 1, s_q, s_k, d, scale,
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

}  // namespace

extern "C" {

int flash_partials_bf16(const void* q, const void* k, const void* v, void* o,
                        void* m, void* l, int bh, int s_q, int s_k, int d,
                        float scale, int causal, int q_off, int kv_off,
                        void* stream) {
  // (bh, s, d) contiguous is (b = bh, s, h = 1, d)
  const sm90::Strides sq{(long long)s_q * d, d, d};
  const sm90::Strides skv{(long long)s_k * d, d, d};
  const sm90::Args a{1, s_q, s_k, d, scale * sm90::LOG2E, causal, q_off,
                     kv_off};
  return sm90::with_tile(d, [&](auto tile) {
    using F = decltype(tile);
    sm90::Maps maps;
    if (int err = sm90::make_maps<F>(&maps, q, k, v, bh, 1, s_q, s_k, d, sq,
                                     skv, skv))
      return err;
    // one block per (bh, q tile)
    return sm90::launch<F>(partials_sm90<F>,
                           dim3(bh, (s_q + F::BQ - 1) / F::BQ), stream, maps,
                           a, (float*)o, (float*)m, (float*)l);
  });
}

int flash_partials_f32(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, int bh, int s_q, int s_k, int d,
                       float scale, int causal, int q_off, int kv_off,
                       void* stream) {
  const Src sq{(const float*)q, (long long)s_q * d, d, 0};
  const Src sk{(const float*)k, (long long)s_k * d, d, 0};
  const Src sv{(const float*)v, (long long)s_k * d, d, 0};
  return launch_fwd(partials_f32, bh, s_q, d, stream, sq, sk, sv, (float*)o,
                    (float*)m, (float*)l, s_q, s_k, d, scale, causal, q_off,
                    kv_off);
}

const char* flash_partials_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
