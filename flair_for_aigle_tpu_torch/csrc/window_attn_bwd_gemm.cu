// K6's do, dx and weight-gradient products (window_attn_bwd.cu steps 2, 4
// and 5) on gemm_mma.cuh's tensor-core GEMM, in a source of their own so
// that their instantiations compile beside K6's cores.
//
// Replaces the products that the TPU's backward bodies compute inside the
// Pallas kernel: flair_for_aigle_tpu/ops/pallas/window_attn.py :458 (do),
// :517 (dWproj), :522 (dWqkv), :525 (dx), and the head-chunked body's :686,
// :730, :738.
//
//   do     = rnd(g Wproj)      MMA_ROUND on Wproj's transposed copy: the
//   dx     = rnd(dqkv Wqkv)    nn.Linear layout C = A W^T with W = Wproj^T
//                              (C, C), Wqkv^T (C, 3C); the wrapper makes the
//                              copies (4 C^2 elements a call)
//   dWproj = g^T o             MMA_WGRAD, C = A^T B over the B*nW*T rows in
//   dWqkv  = dqkv^T x          float32 split-K partials, summed in order
//
// Bound on the card: 4 m C^2 multiply-adds per product pair over about
// 3 m C elements read a pair, so the products are bound by operations at
// every swin-base stage. do and dx take K2's proj tile (ops/mma_plan.py
// gemm_plan at m x C), the weight gradients the 64 x 128 tile with K cut
// into whole pipeline steps until one wave of resident blocks is full,
// no partial longer than 512 rows (ops/mma_plan.py wgrad_plan,
// WGRAD_ROWS; bf16's 128 x 128 spills in this layout).
// float32 is 3xTF32, about 2^-21 of each product; bf16 is bf16 in,
// float32 accumulate, rounded where the reference rounds (do and dx to the
// compute dtype, the weight gradients kept in float32).
#include "gemm_mma.cuh"
#include "window_attn_bwd.cuh"

namespace flair {

template <typename T>
int bwd_gemm_round(int tile, const T* a, const T* wt, T* out, int m, int n, int k,
                   cudaStream_t s, int* info) {
  return gemm_round<T>(tile, a, wt, out, m, n, k, s, info);
}

template <typename T>
int bwd_gemm_wgrad(int tile, const T* a, const T* b, float* part, float* out, int m, int n, int k,
                   int k_chunk, cudaStream_t s, int* info) {
  return gemm_wgrad<T>(tile, a, b, part, out, m, n, k, k_chunk, s, info);
}

template int bwd_gemm_round<float>(int, const float*, const float*, float*, int, int, int,
                                   cudaStream_t, int*);
template int bwd_gemm_round<bf16>(int, const bf16*, const bf16*, bf16*, int, int, int,
                                  cudaStream_t, int*);
template int bwd_gemm_wgrad<float>(int, const float*, const float*, float*, float*, int, int, int,
                                   int, cudaStream_t, int*);
template int bwd_gemm_wgrad<bf16>(int, const bf16*, const bf16*, float*, float*, int, int, int,
                                  int, cudaStream_t, int*);

}  // namespace flair

using namespace flair;

// One of K6's products alone, for the card tests and the timings: wgrad =
// 0, out = rnd(a w^T), a (m, k), w (n, k) in the compute dtype; wgrad = 1,
// out (m, n) float32 = a^T w, a (k, m), w (k, n), through `part` (the
// partials of k_chunk rows each)
extern "C" int window_attn_bwd_gemm(const void* a, const void* w, void* out, void* part, int m,
                                    int n, int k, int k_chunk, int tile, int wgrad, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0)
    rc = wgrad ? bwd_gemm_wgrad<float>(tile, (const float*)a, (const float*)w, (float*)part,
                                       (float*)out, m, n, k, k_chunk, s, nullptr)
               : bwd_gemm_round<float>(tile, (const float*)a, (const float*)w, (float*)out, m, n,
                                       k, s, nullptr);
  else
    rc = wgrad ? bwd_gemm_wgrad<bf16>(tile, (const bf16*)a, (const bf16*)w, (float*)part,
                                      (float*)out, m, n, k, k_chunk, s, nullptr)
               : bwd_gemm_round<bf16>(tile, (const bf16*)a, (const bf16*)w, (bf16*)out, m, n, k,
                                      s, nullptr);
  return rc ? rc : (int)cudaGetLastError();
}

// the resources of the product's kernel (wgrad 0: MMA_ROUND, 1: MMA_WGRAD)
// at tile code `tile`: registers, local bytes a thread, shared bytes a
// block, resident blocks per SM
extern "C" int window_attn_bwd_gemm_info(int dtype, int tile, int wgrad, int* out) {
  if (dtype == 0)
    return wgrad ? bwd_gemm_wgrad<float>(tile, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 1, 0,
                                         out)
                 : bwd_gemm_round<float>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, out);
  return wgrad ? bwd_gemm_wgrad<bf16>(tile, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 1, 0, out)
               : bwd_gemm_round<bf16>(tile, nullptr, nullptr, nullptr, 0, 0, 0, 0, out);
}
