// K7: backward of the fused transformer-block tail (K3's function)
//   out = x2 + fc2(GELU(fc1(LN(x2)))),  x2 = rnd(x + attn)
// for the output gradient g: dx (= dattn), dln_scale, dln_bias, dW1, db1,
// dW2, db2, the weights in the nn.Linear layout (W1 (hidden, C), W2 (C,
// hidden)).
//
// Replaces flair_for_aigle_tpu/ops/pallas/ffn.py (_bwd_body :245,
// _build_bwd_call :297, its LayerNorm epilogue in _kernel_bwd :370-419), in
// that kernel's rounding order:
//   ln  = LN(x2) in the compute dtype (recomputed)
//   h0  = rnd(rnd(ln W1^T) + b1);  h = GELU(h0)
//   dh0 = (g W2) * gelu'(h0) in float32;  db1 = sum dh0;  dh0c = rnd(dh0)
//   dW2 = g^T h,  dW1 = dh0c^T ln,  dln = dh0c W1   (float32 accumulation)
//   db2 = sum g;  dln_scale = sum dln * nrm;  dln_bias = sum dln
//   dx  = rnd(g + rstd (dln s - mean(dln s) - nrm mean(dln s nrm)))
//
// Bound on the card: five GEMMs of 2 N C hidden flops each (tensor cores in
// bf16, SIMT float32 FMAs in float32); the rest is bandwidth.
//
// The TPU kernel ran its grid in order with the hidden chunk outer and kept
// the chunk's float32 dW1 / db1 / dW2 resident in VMEM across the token
// axis. Hopper's blocks run in parallel in no order, so this design (K6's)
// makes every cross-row sum a pass of its own with a fixed order, and no
// atomics: two calls give bit-identical gradients.
//   1. ln: K3's warp-per-row LayerNorm (ln.cuh).
//   2. fc1 GEMM; its epilogue writes h0 and h = GELU(h0).
//   3. dh = g W2 (A B GEMM); its epilogue multiplies by gelu'(h0), writes
//      dh0c, and one float32 column-sum partial of dh0 per 128-row tile.
//   4. dW2 = g^T h, dW1 = dh0c^T ln: A^T B GEMMs split over the N rows into
//      float32 partials, summed in order.
//   5. dln = dh0c W1 in float32.
//   6. One row kernel for the LayerNorm backward (dx) and, per block of rows,
//      the column partials of dln * nrm, dln and g; the partials of 3 and 6
//      are then summed in order.
// ln, h0, h, dh0c (N, C or hidden, compute dtype) and dln (N, C, float32)
// round-trip device memory (the TPU kernel kept them in VMEM); keeping the
// hidden tensors on chip is later work.
#include "common.cuh"
#include "gemm.cuh"
#include "ln.cuh"

namespace flair {

// Rows [blockIdx.x * rows, + rows): dx = rnd(g + LN backward of dln); the
// block's column sums of dln * nrm, dln and g, in row order within each warp
// and warp order within the block, to part[blockIdx.x] (3 C floats).
template <typename T, int CPL>
__global__ void __launch_bounds__(256)
ffn_bwd_ln_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ g,
                  const float* __restrict__ dln, const float* __restrict__ scale,
                  T* __restrict__ dx, float* __restrict__ part, int C, float eps, long long n,
                  int rows) {
  extern __shared__ float red[];  // 3 C
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float ps[CPL], pb[CPL], pg[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) ps[k] = pb[k] = pg[k] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = min(n, r0 + rows);
  for (long long row = r0 + warp; row < r1; row += nwarps) {
    float v[CPL], d[CPL], mean, rstd;
    residual_ln_stats<T, CPL>(x + row * C, a + row * C, C, eps, v, mean, rstd);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int i = lane + 32 * k;
      d[k] = 0.f;
      if (i < C) {
        v[k] = (v[k] - mean) * rstd;  // nrm
        const float dl = dln[row * C + i];
        ps[k] += dl * v[k];
        pb[k] += dl;
        d[k] = dl * scale[i];
        m1 += d[k];
        m2 += d[k] * v[k];
      }
    }
    m1 = warp_sum(m1) / (float)C;
    m2 = warp_sum(m2) / (float)C;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int i = lane + 32 * k;
      if (i < C) {
        const float gv = to_f<T>(g[row * C + i]);
        pg[k] += gv;
        dx[row * C + i] = from_f<T>(gv + rstd * (d[k] - m1 - v[k] * m2));
      }
    }
  }
  // the block's partials, warps added in order
  for (int w = 0; w < nwarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int i = lane + 32 * k;
        if (i < C) {
          red[i] = (w ? red[i] : 0.f) + ps[k];
          red[C + i] = (w ? red[C + i] : 0.f) + pb[k];
          red[2 * C + i] = (w ? red[2 * C + i] : 0.f) + pg[k];
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 3 * C; e += blockDim.x)
    part[(long long)blockIdx.x * 3 * C + e] = red[e];
}

template <typename T, int CPL>
void launch_bwd_ln(const T* x, const T* a, const T* g, const float* dln, const float* scale,
                   T* dx, float* part, int c, float eps, long long n, int rows, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  ffn_bwd_ln_kernel<T, CPL><<<blocks, 256, 3 * c * sizeof(float), s>>>(x, a, g, dln, scale, dx,
                                                                       part, c, eps, n, rows);
}

template <typename T>
int ffn_bwd_impl(const void* x, const void* a, const void* g, const void* lns, const void* lnb,
                 const void* w1, const void* b1, const void* w2, void* ln, void* h0, void* h,
                 void* dh0c, void* db1_part, void* wpart, void* dln, void* row_part, void* dx,
                 void* dvec, void* dw1, void* db1, void* dw2, int n, int c, int hidden,
                 int k_chunk, int rows, float eps, cudaStream_t s) {
  const int n_split = (n + k_chunk - 1) / k_chunk;
  float* part = (float*)wpart;
  launch_ffn_ln<T>((const T*)x, (const T*)a, (const float*)lns, (const float*)lnb, (T*)ln, n, c,
                   eps, s);
  launch_gemm<T, EPI_BIAS_GELU_AUX>((const T*)ln, (const T*)w1, h, n, hidden, c, (const T*)b1,
                                    nullptr, s, 0, h0);
  launch_gemm<T, EPI_DGELU, false, true>((const T*)g, (const T*)w2, dh0c, n, hidden, c, nullptr,
                                         (const T*)h0, s, 0, db1_part);
  launch_gemm<T, EPI_F32, true, true>((const T*)g, (const T*)h, part, c, hidden, n, nullptr,
                                      nullptr, s, k_chunk);
  launch_sum_partials(part, (float*)dw2, (long long)c * hidden, n_split, s);
  launch_gemm<T, EPI_F32, true, true>((const T*)dh0c, (const T*)ln, part, hidden, c, n, nullptr,
                                      nullptr, s, k_chunk);
  launch_sum_partials(part, (float*)dw1, (long long)hidden * c, n_split, s);
  launch_gemm<T, EPI_F32, false, true>((const T*)dh0c, (const T*)w1, dln, n, c, hidden, nullptr,
                                       nullptr, s);
  if (c <= 128) {
    launch_bwd_ln<T, 4>((const T*)x, (const T*)a, (const T*)g, (const float*)dln,
                        (const float*)lns, (T*)dx, (float*)row_part, c, eps, n, rows, s);
  } else if (c <= 256) {
    launch_bwd_ln<T, 8>((const T*)x, (const T*)a, (const T*)g, (const float*)dln,
                        (const float*)lns, (T*)dx, (float*)row_part, c, eps, n, rows, s);
  } else if (c <= 512) {
    launch_bwd_ln<T, 16>((const T*)x, (const T*)a, (const T*)g, (const float*)dln,
                         (const float*)lns, (T*)dx, (float*)row_part, c, eps, n, rows, s);
  } else {
    launch_bwd_ln<T, 32>((const T*)x, (const T*)a, (const T*)g, (const float*)dln,
                         (const float*)lns, (T*)dx, (float*)row_part, c, eps, n, rows, s);
  }
  launch_sum_partials((const float*)row_part, (float*)dvec, 3ll * c, (n + rows - 1) / rows, s);
  launch_sum_partials((const float*)db1_part, (float*)db1, hidden, (n + GEMM_BM - 1) / GEMM_BM,
                      s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

extern "C" int ffn_bwd(const void* x, const void* a, const void* g, const void* lns,
                       const void* lnb, const void* w1, const void* b1, const void* w2, void* ln,
                       void* h0, void* h, void* dh0c, void* db1_part, void* wpart, void* dln,
                       void* row_part, void* dx, void* dvec, void* dw1, void* db1, void* dw2,
                       int n, int c, int hidden, int k_chunk, int rows, float eps, int dtype,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return ffn_bwd_impl<float>(x, a, g, lns, lnb, w1, b1, w2, ln, h0, h, dh0c, db1_part, wpart,
                               dln, row_part, dx, dvec, dw1, db1, dw2, n, c, hidden, k_chunk,
                               rows, eps, s);
  return ffn_bwd_impl<bf16>(x, a, g, lns, lnb, w1, b1, w2, ln, h0, h, dh0c, db1_part, wpart, dln,
                            row_part, dx, dvec, dw1, db1, dw2, n, c, hidden, k_chunk, rows, eps,
                            s);
}
