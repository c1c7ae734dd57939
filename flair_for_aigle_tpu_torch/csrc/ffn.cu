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
// three launches — a warp-per-row LayerNorm that writes the normalised rows
// (ln.cuh), fc1 with the bias + GELU epilogue, and fc2 whose epilogue
// recomputes x2 = x + attn and adds the residual, so x2 is never stored. The
// LN output (N, C) and the hidden activations (N, hidden) round-trip device
// memory in the compute dtype (the TPU kernel kept them in VMEM; re-fusing is
// later work). The hidden activations are rounded to the compute dtype
// before GELU and fc2 consumes them in that dtype, as the reference does.
#include "common.cuh"
#include "gemm.cuh"
#include "ln.cuh"

namespace flair {

template <typename T>
int ffn_impl(const void* x, const void* a, const void* lns, const void* lnb, const void* w1,
             const void* b1, const void* w2, const void* b2, void* ln, void* h, void* out,
             int n, int c, int hidden, float eps, cudaStream_t s) {
  launch_ffn_ln<T>((const T*)x, (const T*)a, (const float*)lns, (const float*)lnb, (T*)ln, n, c,
                   eps, s);
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
