// Constants and device helpers shared by K6's two attention-backward cores:
// the bf16 core (window_attn_bwd.cu) and the float32 core
// (window_attn_bwd_f32.cu). Both take one block per (window group, head),
// one warp per 16 rows, the bias and dbias tiles staged per warp by
// cp.async, and the same score and probability arithmetic (the score
// functions in core_util.cuh, shared with K2's float32 core).
#pragma once

#include "common.cuh"
#include "core_util.cuh"

namespace flair {

constexpr int BWD_HD = 32;  // head dim

// staged float32 tiles of the bias (and dbias) in each warp's ring: rows
// of RQ_LD floats in pass Q (query rows by keys), RK_LD in pass K (queries
// by the warp's keys), the strides at which the fragments' reads hit
// distinct banks; two stages of a bias and a dbias tile per warp
constexpr int RQ_LD = 24;
constexpr int RK_LD = 20;
constexpr int RING_TILE = 16 * RQ_LD;
constexpr int RING_WARP = 2 * 2 * RING_TILE;

namespace {

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

// put the 16 x 16 float32 tile src[r * stride + c] (rows below nr and
// columns below nc; zero elsewhere) in flight into dst, rows of ld floats,
// by cp.async from the warp's 32 lanes: 16-byte chunks where `vec` (stride
// and nc multiples of 4, src 16-byte aligned), else 4-byte elements
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src, int stride,
                                           int nr, int nc, bool vec, int lane) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = lane + 32 * i, r = ch >> 2, c = (ch & 3) * 4;
      float* d = dst + r * ld + c;
      if (r < nr && c < nc)
        cp_async16(d, src + r * stride + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i, r = e >> 4, c = e & 15;
      float* d = dst + r * ld + c;
      if (r < nr && c < nc)
        cp_async4(d, src + r * stride + c);
      else
        *d = 0.f;
    }
  }
}

// the column sums of a 16 x 32 float32 tile (rows past Tn left out, as
// invalid0 / 1 say for rows g, g + 8) added to this warp's slots `cs`
__device__ __forceinline__ void add_colsums(float* cs, const float (&acc)[4][4], bool in0,
                                            bool in1, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = (in0 ? acc[n][u] : 0.f) + (in1 ? acc[n][2 + u] : 0.f);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) cs[8 * n + 2 * lane + u] += v;
    }
}

// p = RN(a / b) from r = RN(1 / b): q = RN(a r) and one correction step,
// exact (Markstein) whenever r is correctly rounded and a / b is normal
__device__ __forceinline__ float div_r(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

}  // namespace

// K6's float32 core on qkv (bnw * t, 3c) and do (bnw * t, c) -> o, dqkv and
// the per-group dbias and dbqkv partials (window_attn_bwd_f32.cu); with
// `info`, nothing launches and info[0..4] receive its resources at t tokens
int bwd_core_f32(const float* qkv, const float* dout, const float* bias, float* o, float* dqkv,
                 float* dbias_part, float* dbqkv_part, int bnw, int t, int c, int nh, int ws,
                 int ss, int nwh, int nww, int attn_f32, int n_groups, cudaStream_t s, int* info);

}  // namespace flair
