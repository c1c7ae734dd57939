// K3: fused transformer-block tail forward
//   x2 = x + attn (compute dtype); ln = LN(x2) (float32 statistics);
//   h = GELU(rnd(rnd(ln W1^T) + b1)) (exact erf GELU, compute dtype);
//   out = (x2 + b2) + h W2^T   (float32 accumulation over all of hidden).
//
// Replaces flair_for_aigle_tpu/ops/pallas/ffn.py (_kernel_body :120,
// _build_call :152, fused_ln_mlp_residual :481).
//
// Bound on the card: the two products, 4 N C hidden operations, against
// 989 TFLOP/s in bf16; in float32 against 67 TFLOP/s (the SIMT peak), or a
// third of the tf32 tensor cores' 495 (3xTF32's three products). Design:
// three launches.
//   - A warp-per-row LayerNorm writes the normalised rows (ln.cuh).
//   - fc1 and fc2 run on gemm_mma.cuh: mma.sync tensor-core tiles fed by a
//     multi-stage cp.async ring, bf16 on m16n8k16 and float32 as 3xTF32 on
//     m16n8k8 (operands split into tf32 halves once per staged tile, by
//     the block). fc1's epilogue adds b1 and applies GELU; fc2's
//     recomputes x2 = x + attn and adds the residual, so x2 is never
//     stored. Both come straight from the accumulator registers.
//   - Each product's tile (bf16: 128 x 128 or 64 x 128 of the output;
//     float32: 64 x 128) and fc2's split of K come from ops/mma_plan.py,
//     from M, N, K and the SM count: the largest tile that gives every SM
//     a block; where even the smallest does not (fc2 at few rows, hidden =
//     4 C long), fc2 splits K into float32 partials that resid_sum_kernel
//     adds in a fixed order before the residual epilogue. Every tile holds
//     two blocks an SM.
// Left as it is, and why:
//   - The LayerNorm launch stays: it is bandwidth-bound, and ln.cuh is
//     shared with K7. The two products are gemm_mma.cuh gemm_mlp, which K8
//     (finish.cu) runs after its gather pass.
//   - The hidden h (N, hidden) round-trips device memory in the compute
//     dtype, as the reference rounds it there. At stage 3 (C = 512, 18 of
//     swin-base's 24 blocks) and batch 16 that is 16384 x 2048 x 2 B = 67 MB
//     each way, about 0.04 ms against about 0.07 ms of products at the bf16
//     peak: those blocks stay bound by their products. Stages 1-2 are bound
//     by h (stage 1: a 537 MB round trip, about 0.16 ms); keeping h on chip
//     for C <= 256 is the next lead for this kernel.
#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln.cuh"

namespace flair {

namespace {

template <typename T>
int ffn_impl(const T* x, const T* a, const float* lns, const float* lnb, const T* w1,
             const T* b1, const T* w2, const T* b2, T* ln, T* h, float* part, T* out, int n,
             int c, int hidden, int tile1, int tile2, int k_chunk2, int nz2, float eps,
             cudaStream_t s) {
  launch_ffn_ln<T>(x, a, lns, lnb, ln, n, c, eps, s);
  const int e = gemm_mlp<T>(ln, w1, b1, w2, b2, x, a, h, part, out, n, c, hidden, tile1, tile2,
                            k_chunk2, nz2, s);
  return e ? e : (int)cudaGetLastError();
}

template <typename T>
int gemm_info(int tile, int epi, int* info) {
  if (epi == MMA_GELU)
    return gemm_tile<T, MMA_GELU>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, nullptr,
                                  nullptr, nullptr, 0, info);
  if (epi == MMA_RESID)
    return gemm_tile<T, MMA_RESID>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, nullptr,
                                   nullptr, nullptr, 0, info);
  return gemm_tile<T, MMA_PART>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, nullptr, nullptr,
                                nullptr, 0, info);
}

}  // namespace

}  // namespace flair

using namespace flair;

// part: fc2's float32 partials (nz2 x n x c) when nz2 > 1, else unused
extern "C" int ffn_fwd(const void* x, const void* a, const void* lns, const void* lnb,
                       const void* w1, const void* b1, const void* w2, const void* b2, void* ln,
                       void* h, void* part, void* out, int n, int c, int hidden, int tile1,
                       int tile2, int k_chunk2, int nz2, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return ffn_impl<float>((const float*)x, (const float*)a, (const float*)lns,
                           (const float*)lnb, (const float*)w1, (const float*)b1,
                           (const float*)w2, (const float*)b2, (float*)ln, (float*)h,
                           (float*)part, (float*)out, n, c, hidden, tile1, tile2, k_chunk2, nz2,
                           eps, s);
  return ffn_impl<bf16>((const bf16*)x, (const bf16*)a, (const float*)lns, (const float*)lnb,
                        (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                        (bf16*)ln, (bf16*)h, (float*)part, (bf16*)out, n, c, hidden, tile1, tile2,
                        k_chunk2, nz2, eps, s);
}

// the resources of K3's GEMM kernel with tile code `tile` and epilogue
// `epi` (0 fc1's GELU, 1 fc2's residual, 2 fc2's split-K partials) in
// `dtype`: out = int[4] registers, local bytes, shared bytes, blocks per SM
extern "C" int ffn_gemm_info(int dtype, int tile, int epi, int* out) {
  return dtype == 0 ? gemm_info<float>(tile, epi, out) : gemm_info<bf16>(tile, epi, out);
}
