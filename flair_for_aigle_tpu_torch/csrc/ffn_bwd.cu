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
// Bound on the card: five products of 2 N C hidden operations each, on the
// tensor cores (bf16; float32 as 3xTF32, a third of the tf32 rate); the
// rest is bandwidth.
//
// The TPU kernel ran its grid in order with the hidden chunk outer and kept
// the chunk's float32 dW1 / db1 / dW2 resident in VMEM across the token
// axis. Hopper's blocks run in parallel in no order, so this design (K6's)
// makes every cross-row sum a pass of its own with a fixed order, and no
// atomics: two calls give bit-identical gradients. The five products run on
// gemm_mma.cuh (mma.sync fed by a cp.async ring; float32 as 3xTF32), with
// the tiles and splits of ops/ffn.py _bwd_plan:
//   1. ln: K3's warp-per-row LayerNorm (ln.cuh).
//   2. fc1, C = ln W1^T, MMA_GELU_AUX at K3's fc1 tile (ops/ffn.py
//      mlp_plan): writes h0 and h = GELU(h0), h bit for bit K3's.
//   3. dh = g W2 as C = A W^T on W2's transposed copy (hidden, C), at
//      fc1's tile (the same shape), MMA_DGELU: multiplies by gelu'(h0) (h0
//      read 16 bytes at a time), writes dh0c and one float32 column-sum
//      partial of dh0 per row block of the tile.
//   4. dW2 = g^T h, dW1 = dh0c^T ln: MMA_WGRAD (C = A^T B) into float32
//      split-K partials over the N rows (ops/mma_plan.py wgrad_plan),
//      summed in order.
//   5. dln = dh0c W1 in float32: MMA_PART on W1's transposed copy (C,
//      hidden); where the plan cuts K (few rows, hidden = 4 C long), its
//      partials are summed in order.
//   6. One row kernel for the LayerNorm backward (dx) and, per block of rows,
//      the column partials of dln * nrm, dln and g; the partials of 3 and 6
//      are then summed in order.
// ln, h0, h, dh0c (N, C or hidden, compute dtype) and dln (N, C, float32)
// round-trip device memory (the TPU kernel kept them in VMEM); keeping the
// hidden tensors on chip is later work.
#include "common.cuh"
#include "gemm_mma.cuh"
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
int ffn_bwd_impl(const T* x, const T* a, const T* g, const float* lns, const float* lnb,
                 const T* w1, const T* b1, const T* w1t, const T* w2t, T* ln, T* h0, T* h,
                 T* dh0c, float* db1_part, float* part, float* dln, float* row_part, T* dx,
                 float* dvec, float* dw1, float* db1, float* dw2, int n, int c, int hidden,
                 int tile_h, int tile_w, int k_chunk_w2, int k_chunk_w1, int tile_dln,
                 int k_chunk_dln, int rows, float eps, cudaStream_t s) {
  launch_ffn_ln<T>(x, a, lns, lnb, ln, n, c, eps, s);
  int e = gemm_tile<T, MMA_GELU_AUX>(tile_h, ln, w1, h, n, hidden, c, c, 1, b1, nullptr, nullptr,
                                     s, nullptr, MmaPlainA{}, h0);
  if (!e)
    e = gemm_tile<T, MMA_DGELU>(tile_h, g, w2t, dh0c, n, hidden, c, c, 1, nullptr, nullptr, h0,
                                s, nullptr, MmaPlainA{}, db1_part);
  if (!e) e = gemm_wgrad<T>(tile_w, g, h, part, dw2, c, hidden, n, k_chunk_w2, s);
  if (!e) e = gemm_wgrad<T>(tile_w, dh0c, ln, part, dw1, hidden, c, n, k_chunk_w1, s);
  const int nz_dln = (hidden + k_chunk_dln - 1) / k_chunk_dln;
  if (!e)
    e = gemm_tile<T, MMA_PART>(tile_dln, dh0c, w1t, nz_dln > 1 ? part : dln, n, c, hidden,
                               k_chunk_dln, nz_dln, nullptr, nullptr, nullptr, s, nullptr);
  if (e) return e;
  if (nz_dln > 1) launch_sum_partials(part, dln, (long long)n * c, nz_dln, s);
  if (c <= 128)
    launch_bwd_ln<T, 4>(x, a, g, dln, lns, dx, row_part, c, eps, n, rows, s);
  else if (c <= 256)
    launch_bwd_ln<T, 8>(x, a, g, dln, lns, dx, row_part, c, eps, n, rows, s);
  else if (c <= 512)
    launch_bwd_ln<T, 16>(x, a, g, dln, lns, dx, row_part, c, eps, n, rows, s);
  else
    launch_bwd_ln<T, 32>(x, a, g, dln, lns, dx, row_part, c, eps, n, rows, s);
  launch_sum_partials(row_part, dvec, 3ll * c, (n + rows - 1) / rows, s);
  const int bm = mma_tile_bm(tile_h);
  launch_sum_partials(db1_part, db1, hidden, (n + bm - 1) / bm, s);
  return (int)cudaGetLastError();
}

// the resources of K7's product kernels at tile code `tile`: epi 0 fc1
// (MMA_GELU_AUX), 1 dh (MMA_DGELU), 2 the weight gradients (MMA_WGRAD), 3
// dln (MMA_PART)
template <typename T>
int bwd_gemm_info(int tile, int epi, int* info) {
  switch (epi) {
    case 0:
      return gemm_tile<T, MMA_GELU_AUX>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, nullptr,
                                        nullptr, nullptr, 0, info);
    case 1:
      return gemm_tile<T, MMA_DGELU>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, nullptr,
                                     nullptr, nullptr, 0, info);
    case 2:
      return gemm_wgrad<T>(tile, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 1, 0, info);
    case 3:
      return gemm_tile<T, MMA_PART>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, nullptr,
                                    nullptr, nullptr, 0, info);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flair

using namespace flair;

// tile_h (fc1 and dh), tile_w, tile_dln: ops/mma_plan.py tile codes; part:
// the float32 partials of the weight gradients and of dln (where
// k_chunk_dln < hidden), sized by ops/ffn.py _bwd_plan; db1_part: one row of
// hidden per row block of tile_h
extern "C" int ffn_bwd(const void* x, const void* a, const void* g, const void* lns,
                       const void* lnb, const void* w1, const void* b1, const void* w1t,
                       const void* w2t, void* ln, void* h0, void* h, void* dh0c, void* db1_part,
                       void* part, void* dln, void* row_part, void* dx, void* dvec, void* dw1,
                       void* db1, void* dw2, int n, int c, int hidden, int tile_h, int tile_w,
                       int k_chunk_w2, int k_chunk_w1, int tile_dln, int k_chunk_dln, int rows,
                       float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float *pd = (float*)db1_part, *pp = (float*)part, *pl = (float*)dln, *pr = (float*)row_part;
  float *vd = (float*)dvec, *v1 = (float*)dw1, *vb = (float*)db1, *v2 = (float*)dw2;
  if (dtype == 0) {
    using T = float;
    return ffn_bwd_impl<T>((const T*)x, (const T*)a, (const T*)g, (const float*)lns,
                           (const float*)lnb, (const T*)w1, (const T*)b1, (const T*)w1t,
                           (const T*)w2t, (T*)ln, (T*)h0, (T*)h, (T*)dh0c, pd, pp, pl, pr,
                           (T*)dx, vd, v1, vb, v2, n, c, hidden, tile_h, tile_w,
                           k_chunk_w2, k_chunk_w1, tile_dln, k_chunk_dln, rows, eps, s);
  }
  using T = bf16;
  return ffn_bwd_impl<T>((const T*)x, (const T*)a, (const T*)g, (const float*)lns,
                         (const float*)lnb, (const T*)w1, (const T*)b1, (const T*)w1t,
                         (const T*)w2t, (T*)ln, (T*)h0, (T*)h, (T*)dh0c, pd, pp, pl, pr, (T*)dx,
                         vd, v1, vb, v2, n, c, hidden, tile_h, tile_w, k_chunk_w2,
                         k_chunk_w1, tile_dln, k_chunk_dln, rows, eps, s);
}

// the resources of K7's product kernel with tile code `tile` and product
// `epi` (0 fc1, 1 dh, 2 the weight gradients, 3 dln) in `dtype`: out =
// int[4] registers, local bytes, shared bytes, blocks per SM
extern "C" int ffn_bwd_gemm_info(int dtype, int tile, int epi, int* out) {
  return dtype == 0 ? bwd_gemm_info<float>(tile, epi, out) : bwd_gemm_info<bf16>(tile, epi, out);
}
