// K5: fused swin patch merging forward
//   2x2 neighbourhood gather in timm order [x00, x10, x01, x11] -> LayerNorm
//   over the 4C concat (float32 statistics, two-pass variance) -> LN output
//   rounded to the compute dtype -> bias-free reduction, float32 accumulate,
//   rounded once.
//
// Replaces flair_for_aigle_tpu/ops/pallas/merge.py (_build_call :32,
// fused_patch_merge :120). Input (B, H, W, C) NHWC with H, W even (the odd
// pad stays in the caller, models/swin.py PatchMerging), output
// (B, H/2, W/2, out_c); the reduction weight is the nn.Linear (out_c, 4C).
//
// Bound on the card: the reduction GEMM (2 * 4C * out_c flops per output
// token) runs on the tensor cores (gemm.cuh, A @ W^T); the gather + LN is
// bandwidth-bound (one read of the raster, one write of the LN rows).
// Design: two launches. One block of 128 threads per output token gathers
// its four input tokens (coalesced along the channels), keeps the 4C values
// in registers (<= 32 per thread) for the mean and then the two-pass
// variance (the one-pass E[x^2] - mean^2 form cancels in float32,
// merge.py:44-49) and writes the LN row in the compute dtype; the GEMM sums
// the four segments' products in one float32 accumulator (merge.py:51-58
// sums four float32 partial products; the order of the float32 sum
// differs). The (B*H/2*W/2, 4C) LN rows round-trip device memory (the TPU
// kernel kept them in VMEM; fusing the gather into the GEMM's A-tile load
// is later work).
#include "common.cuh"
#include "gemm.cuh"

namespace flair {

constexpr int MERGE_THREADS = 128;
constexpr int MERGE_MAXV = 32;  // 4C <= 4096

__device__ __forceinline__ float block_sum_128(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[wid] = v;
  __syncthreads();
  return red[0] + red[1] + red[2] + red[3];
}

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_ln_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ ln, int H, int W, int C,
                float eps) {
  __shared__ float red[4];
  const int h2 = H / 2, w2 = W / 2;
  const long long tok = blockIdx.x;
  const long long b = tok / ((long long)h2 * w2);
  const int rem = (int)(tok % ((long long)h2 * w2));
  const int i = rem / w2, j = rem % w2;
  const int C4 = 4 * C;
  float v[MERGE_MAXV];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < MERGE_MAXV; ++k) {
    const int q = threadIdx.x + MERGE_THREADS * k;
    v[k] = 0.f;
    if (q < C4) {
      const int seg = q / C, ch = q % C;
      const int r = 2 * i + (seg & 1), c = 2 * j + (seg >> 1);  // [x00, x10, x01, x11]
      v[k] = to_f<T>(x[((b * H + r) * (long long)W + c) * C + ch]);
      sum += v[k];
    }
  }
  const float mean = block_sum_128(sum, red) / (float)C4;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < MERGE_MAXV; ++k) {
    const int q = threadIdx.x + MERGE_THREADS * k;
    if (q < C4) {
      const float d = v[k] - mean;
      sq += d * d;
    }
  }
  const float rstd = 1.f / sqrtf(block_sum_128(sq, red) / (float)C4 + eps);
  T* dst = ln + tok * C4;
#pragma unroll
  for (int k = 0; k < MERGE_MAXV; ++k) {
    const int q = threadIdx.x + MERGE_THREADS * k;
    if (q < C4) dst[q] = from_f<T>((v[k] - mean) * rstd * scale[q] + bias[q]);
  }
}

template <typename T>
int merge_impl(const void* x, const void* lns, const void* lnb, const void* w, void* ln,
               void* out, int b, int h, int wd, int c, int out_c, float eps, cudaStream_t s) {
  const long long m = (long long)b * (h / 2) * (wd / 2);
  merge_ln_kernel<T><<<(unsigned)m, MERGE_THREADS, 0, s>>>((const T*)x, (const float*)lns,
                                                           (const float*)lnb, (T*)ln, h, wd, c,
                                                           eps);
  launch_gemm<T, EPI_NONE>((const T*)ln, (const T*)w, out, (int)m, out_c, 4 * c, nullptr,
                           nullptr, s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

extern "C" int merge_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w_red, void* ln, void* out, int b, int h, int w, int c,
                         int out_c, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return merge_impl<float>(x, ln_scale, ln_bias, w_red, ln, out, b, h, w, c, out_c, eps, s);
  return merge_impl<bf16>(x, ln_scale, ln_bias, w_red, ln, out, b, h, w, c, out_c, eps, s);
}
