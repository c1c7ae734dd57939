// Residual + LayerNorm rows, one warp per row, shared by K3 (ffn.cu) and K7
// (ffn_bwd.cu, the forward's LN recomputed).
//
// Numerics of ops/pallas/ffn.py _kernel_body :126-131: x2 = x + a rounded to
// the compute dtype, float32 mean and (two-pass) variance. A row's C <= 1024
// values are held in registers, 32 per lane, between the statistics and the
// normalisation, so each input is read once.
#pragma once

#include "common.cuh"

namespace flair {

// v[k] = rnd(xr[i] + ar[i]) for the lane's columns i = lane + 32 k (0 past
// C); mean and rstd = 1 / sqrt(var + eps) of the row, on every lane. CPL
// columns per lane: C <= 32 * CPL.
template <typename T, int CPL = 32>
__device__ __forceinline__ void residual_ln_stats(const T* __restrict__ xr,
                                                  const T* __restrict__ ar, int C, float eps,
                                                  float (&v)[CPL], float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int i = lane + 32 * k;
    v[k] = 0.f;
    if (i < C) {
      v[k] = rnd<T>(to_f<T>(xr[i]) + to_f<T>(ar[i]));
      sum += v[k];
    }
  }
  mean = warp_sum(sum) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int i = lane + 32 * k;
    if (i < C) {
      const float d = v[k] - mean;
      sq += d * d;
    }
  }
  rstd = 1.f / sqrtf(warp_sum(sq) / (float)C + eps);
}

// ln[row] = LN(rnd(x[row] + a[row])) * scale + bias, in T; n rows of C.
template <typename T>
__global__ void __launch_bounds__(256)
ffn_ln_kernel(const T* __restrict__ x, const T* __restrict__ a, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ ln, int C, float eps, long long n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;
  float v[32], mean, rstd;
  residual_ln_stats<T>(x + row * C, a + row * C, C, eps, v, mean, rstd);
  T* dst = ln + row * C;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    if (i < C) dst[i] = from_f<T>((v[k] - mean) * rstd * scale[i] + bias[i]);
  }
}

template <typename T>
void launch_ffn_ln(const T* x, const T* a, const float* scale, const float* bias, T* ln, long long n,
                   int c, float eps, cudaStream_t s) {
  const int threads = 256;
  const long long blocks = (n + threads / 32 - 1) / (threads / 32);
  ffn_ln_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(x, a, scale, bias, ln, c, eps, n);
}

}  // namespace flair
