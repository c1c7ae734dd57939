// K4: fused zonal epilogue — x4 align-corners bilinear upsample of the
// stride-4 logits, margin crop, and argmax (uint8, ties to the lowest class)
// or class_prob (round(softmax * 255) per class, uint8).
//
// Replaces flair_for_aigle_tpu/ops/pallas/epilogue.py (_build_argmax_call
// :119 / _body_argmax :51, _build_class_prob_calls :149 / bodies :79, :106,
// upsample_crop_convert :184).
//
// The TPU kernel expresses the upsample as R @ L_k @ C interpolation matmuls
// (an MXU device). Each output pixel only ever touches a 2 x 2 neighbourhood,
// so here one thread per kept output pixel does the two-tap rows then two-tap
// columns interpolation directly in float32, with the same float32 weights
// (host tables built in float64 and rounded, exactly as _interp_matrix does)
// and the same summation order as the matmuls (rows, then columns).
//
// Bound on the card: bandwidth — 4 K logit reads (mostly L1/L2 hits, the
// neighbourhoods overlap) and 1 (argmax) or K (class_prob) byte writes per
// pixel. class_prob keeps the K upsampled values in registers/local memory
// and runs the online softmax statistics of the reference's stats pass
// before the write pass.
#include "common.cuh"

namespace flair {

constexpr int EPI_MAX_K = 64;

template <typename T>
__device__ __forceinline__ float upsample(const T* __restrict__ L, int w4, int ra, int rb,
                                          float wra, float wrb, int ca, int cb, float wca,
                                          float wcb) {
  // (R @ L) first: two row taps at the two source columns, then (.. @ C)
  const float ta = wra * to_f<T>(L[ra * w4 + ca]) + wrb * to_f<T>(L[rb * w4 + ca]);
  const float tb = wra * to_f<T>(L[ra * w4 + cb]) + wrb * to_f<T>(L[rb * w4 + cb]);
  return ta * wca + tb * wcb;
}

template <typename T>
__global__ void __launch_bounds__(256)
epilogue_kernel(const T* __restrict__ logits, const int* __restrict__ rlo,
                const int* __restrict__ rhi, const float* __restrict__ rwlo,
                const float* __restrict__ rwhi, const int* __restrict__ clo,
                const int* __restrict__ chi, const float* __restrict__ cwlo,
                const float* __restrict__ cwhi, uint8_t* __restrict__ out, int B, int K,
                int h4, int w4, int inner, int class_prob) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long npix = (long long)inner * inner;
  if (idx >= (long long)B * npix) return;
  const int b = (int)(idx / npix);
  const int p = (int)(idx % npix);
  const int i = p / inner, j = p % inner;
  const int ra = rlo[i], rb = rhi[i], ca = clo[j], cb = chi[j];
  const float wra = rwlo[i], wrb = rwhi[i], wca = cwlo[j], wcb = cwhi[j];
  const T* base = logits + (long long)b * K * h4 * w4;
  const long long plane = (long long)h4 * w4;
  if (!class_prob) {
    float m = upsample(base, w4, ra, rb, wra, wrb, ca, cb, wca, wcb);
    int arg = 0;
    for (int k = 1; k < K; ++k) {
      const float u = upsample(base + k * plane, w4, ra, rb, wra, wrb, ca, cb, wca, wcb);
      if (u > m) arg = k;
      m = fmaxf(m, u);
    }
    out[(long long)b * npix + p] = (uint8_t)arg;
    return;
  }
  float u[EPI_MAX_K];
  float m = 0.f, s = 1.f;
  for (int k = 0; k < K; ++k) {
    u[k] = upsample(base + k * plane, w4, ra, rb, wra, wrb, ca, cb, wca, wcb);
    if (k == 0) {
      m = u[0];
      s = 1.f;
    } else {
      const float mn = fmaxf(m, u[k]);
      s = s * expf(m - mn) + expf(u[k] - mn);
      m = mn;
    }
  }
  const float inv = 255.f / s;
  for (int k = 0; k < K; ++k) {
    const float q = rintf(expf(u[k] - m) * inv);
    out[((long long)b * K + k) * npix + p] = (uint8_t)(int)q;
  }
}

}  // namespace flair

using namespace flair;

extern "C" int epilogue_fwd(const void* logits, const void* rlo, const void* rhi,
                            const void* rwlo, const void* rwhi, const void* clo,
                            const void* chi, const void* cwlo, const void* cwhi, void* out,
                            int b, int k, int h4, int w4, int inner, int class_prob, int dtype,
                            void* stream) {
  const long long n = (long long)b * inner * inner;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define FLAIR_EPI_ARGS                                                                  \
  (const int*)rlo, (const int*)rhi, (const float*)rwlo, (const float*)rwhi,            \
      (const int*)clo, (const int*)chi, (const float*)cwlo, (const float*)cwhi,        \
      (uint8_t*)out, b, k, h4, w4, inner, class_prob
  if (dtype == 0) {
    epilogue_kernel<float><<<blocks, threads, 0, s>>>((const float*)logits, FLAIR_EPI_ARGS);
  } else {
    epilogue_kernel<bf16><<<blocks, threads, 0, s>>>((const bf16*)logits, FLAIR_EPI_ARGS);
  }
#undef FLAIR_EPI_ARGS
  return (int)cudaGetLastError();
}
