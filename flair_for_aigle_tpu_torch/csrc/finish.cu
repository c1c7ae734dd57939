// K8: fused swin-block finish — window reverse + crop + un-shift (+ss roll)
// + residual + LayerNorm + MLP + residual:
//
//   attn = roll(window_reverse(win)[:, :H, :W], +ss)
//   x2   = rnd(x + attn);  ln = LN(x2) (float32 statistics)
//   out  = (x2 + b2) + GELU(rnd(rnd(ln W1^T) + b1)) W2^T
//
// Replaces flair_for_aigle_tpu/ops/pallas/finish.py (_build_call :41, body
// :52-88, fused_reverse_ln_mlp_residual :166). Windows (B*nW, ws*ws, C) of
// the padded (nwh*ws, nww*ws) grid; shortcut and output (B, H, W, C).
//
// Bound on the card: the two GEMMs (4 N C hidden flops on the tensor cores
// in bf16, SIMT in float32); the gather + LayerNorm pass is bandwidth-bound.
// Design: three launches. A warp-per-row gather + LN pass resolves, for each
// output token (b, r, c), the cropped source row q = (r - ss) mod H and
// column p = (c - ss) mod W — the un-shift is taken modulo the CROPPED size —
// then window (q / ws, p / ws) at in-window token (q % ws) * ws + p % ws, and
// reads that window row directly: the reversed, cropped and rolled raster
// never exists in device memory. It writes the LN rows and x2 (the compute
// dtype's residual sum, rounded before the statistics). fc1 is gemm.cuh's
// bias + GELU epilogue; fc2's epilogue adds x2 + b2 in float32 and rounds
// once. The LN rows, x2 and the (N, hidden) activations round-trip device
// memory in the compute dtype (the TPU kernel kept them in VMEM); fusing
// them is later work.
#include "common.cuh"
#include "gemm.cuh"
#include "ln.cuh"

namespace flair {

template <typename T>
__global__ void __launch_bounds__(256)
finish_ln_kernel(const T* __restrict__ win, const T* __restrict__ x,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ ln, T* __restrict__ x2, int H, int W, int C, int ws, int ss,
                 int nwh, int nww, float eps, long long n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;
  const long long b = row / ((long long)H * W);
  const int rem = (int)(row % ((long long)H * W));
  const int q = (rem / W - ss + H) % H;  // cropped source row
  const int p = (rem % W - ss + W) % W;  // cropped source column
  const long long w_idx = (b * nwh + q / ws) * nww + p / ws;
  const T* ar = win + (w_idx * ws * ws + (q % ws) * ws + p % ws) * C;
  float v[32], mean, rstd;
  residual_ln_stats<T>(x + row * C, ar, C, eps, v, mean, rstd);
  T* dst = ln + row * C;
  T* x2r = x2 + row * C;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    if (i < C) {
      dst[i] = from_f<T>((v[k] - mean) * rstd * scale[i] + bias[i]);
      x2r[i] = from_f<T>(v[k]);
    }
  }
}

template <typename T>
int finish_impl(const void* win, const void* x, const void* lns, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, void* ln, void* x2, void* h,
                void* out, int b, int H, int W, int c, int hidden, int ws, int ss, float eps,
                cudaStream_t s) {
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  const long long n = (long long)b * H * W;
  const int threads = 256;
  const long long blocks = (n + threads / 32 - 1) / (threads / 32);
  finish_ln_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      (const T*)win, (const T*)x, (const float*)lns, (const float*)lnb, (T*)ln, (T*)x2, H, W, c,
      ws, ss, nwh, nww, eps, n);
  launch_gemm<T, EPI_BIAS_GELU>((const T*)ln, (const T*)w1, (T*)h, (int)n, hidden, c,
                                (const T*)b1, nullptr, s);
  launch_gemm<T, EPI_ADD>((const T*)h, (const T*)w2, (T*)out, (int)n, c, hidden, (const T*)b2,
                          (const T*)x2, s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

extern "C" int finish_fwd(const void* win, const void* x, const void* lns, const void* lnb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          void* ln, void* x2, void* h, void* out, int b, int H, int W, int c,
                          int hidden, int ws, int ss, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return finish_impl<float>(win, x, lns, lnb, w1, b1, w2, b2, ln, x2, h, out, b, H, W, c,
                              hidden, ws, ss, eps, s);
  return finish_impl<bf16>(win, x, lns, lnb, w1, b1, w2, b2, ln, x2, h, out, b, H, W, c, hidden,
                           ws, ss, eps, s);
}
