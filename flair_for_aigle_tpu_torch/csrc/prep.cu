// K1: fused swin-block prologue — LayerNorm (float32 statistics) + cyclic
// shift by -ss + zero pad to a window multiple + window partition.
//
// Replaces flair_for_aigle_tpu/ops/pallas/prep.py (_build_call :40,
// fused_ln_shift_partition :146). Input (B, H, W, C) NHWC, output
// (B*nW, ws*ws, C): padded row r of the shifted raster reads source row
// (r + ss) % H (columns alike); rows or columns past H / W are zeros.
//
// Bound on the card: pure bandwidth (one read of the activation, one write
// of the windows; ~10 flops per element). Design: one warp per OUTPUT token,
// so the gather is resolved per token with no shared memory and the window
// partition costs nothing extra; a token's C channels are held in registers
// (C <= 1024, 32 per lane) between the statistics and the normalisation, so
// the input is read once. Reads and writes of a token are contiguous across
// the warp.
#include "common.cuh"

namespace flair {

template <typename T>
__global__ void __launch_bounds__(256)
prep_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ out, int H, int W,
            int C, int ws, int ss, float eps, int nwh, int nww,
            long long n_tokens) {
  const int lane = threadIdx.x & 31;
  const long long tok = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tok >= n_tokens) return;
  const int T_ = ws * ws;
  const long long win = tok / T_;
  const int t = (int)(tok % T_);
  const int nw = nwh * nww;
  const long long b = win / nw;
  const int wrem = (int)(win % nw);
  const int r = (wrem / nww) * ws + t / ws;
  const int c = (wrem % nww) * ws + t % ws;
  T* dst = out + tok * C;
  if (r >= H || c >= W) {
    for (int i = lane; i < C; i += 32) dst[i] = from_f<T>(0.f);
    return;
  }
  const int sr = (r + ss) % H;
  const int sc = (c + ss) % W;
  const T* src = x + ((b * H + sr) * (long long)W + sc) * C;
  float v[32];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    v[k] = 0.f;
    if (i < C) {
      v[k] = to_f<T>(src[i]);
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
  const float var = warp_sum(sq) / (float)C;
  const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    if (i < C) dst[i] = from_f<T>((v[k] - mean) * rstd * scale[i] + bias[i]);
  }
}

}  // namespace flair

using namespace flair;

extern "C" int prep_fwd(const void* x, const void* scale, const void* bias,
                        void* out, int b, int h, int w, int c, int ws, int ss,
                        float eps, int dtype, void* stream) {
  const int hp = h + (ws - h % ws) % ws;
  const int wp = w + (ws - w % ws) % ws;
  const int nwh = hp / ws, nww = wp / ws;
  const long long n_tokens = (long long)b * nwh * nww * ws * ws;
  const int threads = 256;
  const long long blocks = (n_tokens + (threads / 32) - 1) / (threads / 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    prep_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)x, (const float*)scale, (const float*)bias, (float*)out,
        h, w, c, ws, ss, eps, nwh, nww, n_tokens);
  } else {
    prep_kernel<bf16><<<(unsigned)blocks, threads, 0, s>>>(
        (const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)out,
        h, w, c, ws, ss, eps, nwh, nww, n_tokens);
  }
  return (int)cudaGetLastError();
}
