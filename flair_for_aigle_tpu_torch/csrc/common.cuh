// Shared helpers for the hand-written Hopper kernels of flair_for_aigle_tpu_torch.
//
// Element types: every kernel is a template over T = float or __nv_bfloat16
// (the model's compute dtype). Arithmetic runs in float32; rnd<T>() rounds a
// float32 value to T's precision, which is how the kernels reproduce the
// places where the JAX reference rounds to the compute dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flair {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float32 value to T's precision (identity for T = float)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// exact GELU, 0.5 h (1 + erf(h / sqrt 2)), in float32
__device__ __forceinline__ float gelu_f(float h) {
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[i] = sum_z part[z * n + i] for z in [0, nz), in order: the split-K
// and per-block partials of the GEMMs and of K6's core, summed in a fixed
// order, so that a result repeats exactly from run to run (no atomics)
static __global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                           long long n, int nz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < nz; ++z) s += part[(long long)z * n + i];
  out[i] = s;
}

static inline void launch_sum_partials(const float* part, float* out, long long n, int nz,
                                       cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out, n, nz);
}

}  // namespace flair
