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
// Bound on the card: the reduction, 2 * 4C * out_c operations per output
// token, against the bytes of one read of x and one write of the output.
// Design: one GEMM on gemm_mma.cuh (mma.sync tensor-core tiles fed by a
// 3-stage cp.async ring; float32 as 3xTF32) whose A operand MergeA
// produces from x, so the (B*H/2*W/2, 4C) LN rows never reach device
// memory (the TPU kernel kept them in VMEM, merge.py:37-60):
//   - the gather at copy time: A's 16-byte chunk at column k of row m =
//     (b, i, j) is x[b, 2i + (s & 1), 2j + (s >> 1), k % C], s = k / C
//     (C % 8 == 0: a chunk lies inside one segment);
//   - a block prologue takes each of its rows' float32 mean and rstd over
//     the full 4C (a warp a row, two passes over x, the second from L1 /
//     L2), and each thread normalises the chunks it copied in shared
//     memory before the tensor cores read them, rounded to the compute
//     dtype: the plain version's LN rows, up to the order of the
//     statistics' float32 sums;
//   - the epilogue rounds the float32 accumulator once (MMA_ROUND). Where
//     ops/mma_plan.py gemm_plan(split=True) cuts K (too few tiles for the
//     SMs), the blocks write float32 partials (MMA_PART), each taking its
//     rows' statistics over the full 4C, and sum_round_kernel adds them in
//     the order z = 0, 1, ... and rounds (two calls give the same bits).
//     On the H100's 132 SMs at swin-base@512's merges (1->2, 2->3, 3->4):
//     batch 2 takes 64 x 128 tiles, unsplit, then K cut in 2 and in 3
//     (bf16 and float32 alike); batch 5 (training, float32) and batch 16
//     (zonal, bf16) run one launch each, unsplit. The tile is 64 x 128 in
//     both dtypes (ops/merge.py MERGE_TILES: at 128 x 128 the producer's
//     bf16 kernel spilled 64 bytes past the 128 registers of two blocks an
//     SM).
#include "common.cuh"
#include "gemm_mma.cuh"

namespace flair {

// A of the merge's reduction: row m = (b, i, j) of the (B, H/2, W/2) grid,
// the LayerNorm of x's 2x2 neighbourhood, 4C long
template <typename T> struct MergeA {
  static constexpr bool kLN = true;
  const T* x;
  const float* scale;
  const float* bias;
  int H, W, C;
  float eps;

  // element offset of x[b, 2i, 2j, 0]
  __device__ __forceinline__ long long a_row(int m) const {
    const int w2 = W / 2, hw2 = (H / 2) * w2;
    const int b = m / hw2, rem = m - b * hw2;
    const int i = rem / w2, j = rem - i * w2;
    return (((long long)b * H + 2 * i) * W + 2 * j) * C;
  }
  // segment s of k: [x00, x10, x01, x11] = rows + (s & 1), columns + (s >> 1)
  __device__ __forceinline__ const T* a_src(long long row, int k) const {
    const int s = (k >= C) + (k >= 2 * C) + (k >= 3 * C);
    return x + row + ((long long)(s & 1) * W + (s >> 1)) * C + (k - s * C);
  }
};

// out = rnd(sum_z part[z]), the partials added in the order z = 0, 1, ...;
// one thread eight neighbouring values
template <typename T>
__global__ void __launch_bounds__(256)
    sum_round_kernel(const float* __restrict__ part, int nz, long long mn, T* __restrict__ out) {
  const long long e = 8 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= mn) return;
  float s[8], p[8];
  ld8<float>(part + e, s);
  for (int z = 1; z < nz; ++z) {
    ld8<float>(part + z * mn + e, p);
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] += p[c];
  }
  st8<T>(out + e, s);
}

namespace {

template <typename T>
int merge_impl(const void* x, const void* lns, const void* lnb, const void* w, void* part,
               void* out, int b, int h, int wd, int c, int out_c, int tile, int k_chunk, int nz,
               float eps, cudaStream_t s, int* info) {
  const int m = b * (h / 2) * (wd / 2);
  const MergeA<T> ap{(const T*)x, (const float*)lns, (const float*)lnb, h, wd, c, eps};
  if (nz == 1)
    return gemm_tile<T, MMA_ROUND>(tile, (const T*)x, (const T*)w, out, m, out_c, 4 * c, 4 * c, 1,
                                   nullptr, nullptr, nullptr, s, info, ap);
  const int e = gemm_tile<T, MMA_PART>(tile, (const T*)x, (const T*)w, part, m, out_c, 4 * c,
                                       k_chunk, nz, nullptr, nullptr, nullptr, s, info, ap);
  if (e || info) return e;
  const long long mn = (long long)m * out_c;
  sum_round_kernel<T><<<(unsigned)((mn / 8 + 255) / 256), 256, 0, s>>>((const float*)part, nz,
                                                                        mn, (T*)out);
  return 0;
}

}  // namespace

}  // namespace flair

using namespace flair;

// tile, k_chunk, nz: ops/mma_plan.py gemm_plan(m, out_c, 4c, split=True);
// part: the float32 partials (nz x m x out_c) when nz > 1, else unused
extern "C" int merge_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w_red, void* part, void* out, int b, int h, int w, int c,
                         int out_c, int tile, int k_chunk, int nz, float eps, int dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int e =
      dtype == 0
          ? merge_impl<float>(x, ln_scale, ln_bias, w_red, part, out, b, h, w, c, out_c, tile,
                              k_chunk, nz, eps, s, nullptr)
          : merge_impl<bf16>(x, ln_scale, ln_bias, w_red, part, out, b, h, w, c, out_c, tile,
                             k_chunk, nz, eps, s, nullptr);
  return e ? e : (int)cudaGetLastError();
}

// the resources of the merge's GEMM kernel with tile code `tile`, unsplit
// (split 0: MMA_ROUND) or split (1: MMA_PART), in `dtype`: out = int[4]
// registers, local bytes, shared bytes, blocks per SM
extern "C" int merge_info(int dtype, int tile, int split, int* out) {
  const int nz = split ? 2 : 1;
  return dtype == 0 ? merge_impl<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                                        2, 2, 8, 8, tile, 8, nz, 0.f, 0, out)
                    : merge_impl<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 2,
                                       2, 8, 8, tile, 8, nz, 0.f, 0, out);
}
