// K3: fused transformer-block tail forward
//   x2 = x + attn (compute dtype); ln = LN(x2) (float32 statistics);
//   h = GELU(rnd(rnd(ln W1^T) + b1)) (exact erf GELU, compute dtype);
//   out = (x2 + b2) + h W2^T   (float32 accumulation over all of hidden).
//
// Replaces flair_for_aigle_tpu/ops/pallas/ffn.py (_kernel_body :120,
// _build_call :152, fused_ln_mlp_residual :481).
//
// Bound on the card: the two GEMMs (4 N C hidden flops) dominate and run on
// the tensor cores (gemm.cuh); the LayerNorm pass is bandwidth-bound. Design:
// three launches — a warp-per-row LayerNorm that writes the normalised rows,
// fc1 with the bias + GELU epilogue, and fc2 whose epilogue recomputes
// x2 = x + attn and adds the residual, so x2 is never stored. The LN output
// (N, C) and the hidden activations (N, hidden) round-trip device memory
// in the compute dtype (the TPU kernel kept them in VMEM; re-fusing is later
// work). The hidden activations are rounded to the compute dtype before
// GELU and fc2 consumes them in that dtype, as the reference does.
#include "common.cuh"
#include "gemm.cuh"

namespace flair {

template <typename T>
__global__ void __launch_bounds__(256)
ffn_ln_kernel(const T* __restrict__ x, const T* __restrict__ a, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ ln, int C, float eps, long long n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * C;
  const T* ar = a + row * C;
  float v[32];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    v[k] = 0.f;
    if (i < C) {
      v[k] = rnd<T>(to_f<T>(xr[i]) + to_f<T>(ar[i]));
      sum += v[k];
    }
  }
  const float mean = warp_sum(sum) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    if (i < C) {
      const float d = v[k] - mean;
      sq += d * d;
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(sq) / (float)C + eps);
  T* dst = ln + row * C;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    if (i < C) dst[i] = from_f<T>((v[k] - mean) * rstd * scale[i] + bias[i]);
  }
}

template <typename T>
int ffn_impl(const void* x, const void* a, const void* lns, const void* lnb, const void* w1,
             const void* b1, const void* w2, const void* b2, void* ln, void* h, void* out,
             int n, int c, int hidden, float eps, cudaStream_t s) {
  const int threads = 256;
  const long long blocks = ((long long)n + threads / 32 - 1) / (threads / 32);
  ffn_ln_kernel<T><<<(unsigned)blocks, threads, 0, s>>>((const T*)x, (const T*)a,
                                                         (const float*)lns, (const float*)lnb,
                                                         (T*)ln, c, eps, n);
  launch_gemm<T, EPI_BIAS_GELU>((const T*)ln, (const T*)w1, (T*)h, n, hidden, c,
                                (const T*)b1, nullptr, nullptr, s);
  launch_gemm<T, EPI_RESID>((const T*)h, (const T*)w2, (T*)out, n, c, hidden, (const T*)b2,
                            (const T*)x, (const T*)a, s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

extern "C" int ffn_fwd(const void* x, const void* a, const void* lns, const void* lnb,
                       const void* w1, const void* b1, const void* w2, const void* b2, void* ln,
                       void* h, void* out, int n, int c, int hidden, float eps, int dtype,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return ffn_impl<float>(x, a, lns, lnb, w1, b1, w2, b2, ln, h, out, n, c, hidden, eps, s);
  return ffn_impl<bf16>(x, a, lns, lnb, w1, b1, w2, b2, ln, h, out, n, c, hidden, eps, s);
}
