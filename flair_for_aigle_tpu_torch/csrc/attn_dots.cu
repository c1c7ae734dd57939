// The window-attention products without softmax, in two layouts: the
// kernels of the port's A/B tool (flair_for_aigle_tpu_torch/tools/
// exp_attn_dots.py).
//
// Replaces tools/exp_attn_dots.py (build :79, pallas_call :80): body_a :44
// (per head, attn_dots_per_head) and body_b :57 (heads grouped into one
// 128-channel panel, attn_dots_grouped). Both compute, for each window and
// each head h (head dim 32):
//   S = Q_h K_h^T  accumulated in float32, rounded to bf16 (no softmax)
//   O_h = S V_h    accumulated in float32, rounded to bf16
// on bf16 (BNW, T, C) q, k, v, writing bf16 (BNW, T, C).
//
// Bound on the card: at the tool's defaults (BNW 1936, T 144, C 128, 4
// heads) the four tensors are 285 MB and the products 20.5 GFLOP, so the
// bytes bound it (0.085 ms at 3.35 TB/s against 0.021 ms of bf16 tensor-core
// work) as long as the scores stay on chip. Design: one warp per 16 query
// rows (9 warps for T = 144). The warp runs S on the tensor cores (wmma
// m16n16k16, bf16 in, float32 accumulate), rounds each 16 x 16 tile to bf16
// into its own 16 x T strip of P in shared memory, then runs P V from that
// strip; the (T, T) scores never reach device memory. T = 144 = 9 x 16
// fits the tiles, so the TPU's lane padding to 256 columns is not carried
// over. q, k, v arrive in shared memory by 16-byte cp.async row copies.
//
//   per head: one block per (group of bw windows, head); it copies the 64-byte
//     head slice of each q, k, v row. 86 KB of shared memory: two blocks per SM.
//   grouped:  one block per (group of bw windows, group of 128 / 32 = 4
//     heads); it copies the 256-byte group row of q, k, v once and runs the
//     group's heads one after another from those panels. 167 KB: one block
//     per SM.
//
// The TPU's body_b builds block-diagonal K and V panels (an MXU-width
// workaround); they are not materialised here: at 4 heads and T = 144 they
// would take 2 x 147 KB. (The TPU body also leaves their off-diagonal and
// pad entries unset, so its output is not finite in interpret mode.)
// Blocks loop over their bw windows without prefetching the next one: a
// first, simple kernel (TMA, wgmma and a load/compute pipeline are later
// work).
#include <mma.h>

#include "common.cuh"

namespace flair {

constexpr int DOTS_HD = 32;     // head dim
constexpr int DOTS_GROUP = 128; // channels of a head group (the TPU's MXU width)
constexpr int DOTS_PAD = 8;     // bf16 padding of each shared-memory row (16 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy t rows of W bf16 channels (row stride c in device memory) into shared
// memory rows of W + DOTS_PAD, in 16-byte chunks, neighbouring threads on
// neighbouring chunks.
template <int W>
__device__ __forceinline__ void load_panel(bf16* dst, const bf16* __restrict__ src, int t, int c) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < t * CH; e += blockDim.x) {
    const int r = e / CH, ch = e % CH;
    cp_async16(dst + r * (W + DOTS_PAD) + ch * 8, src + (long long)r * c + ch * 8);
  }
}

// 8 float32 values rounded to bf16 and stored as one 16-byte write.
__device__ __forceinline__ void store8(bf16* dst, const float* src) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } pk;
#pragma unroll
  for (int i = 0; i < 4; ++i) pk.h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = pk.u;
}

// One warp, 16 query rows of one head: Q points at the warp's first row of
// the head's columns (row stride lq), K and V at the head's columns (lk,
// lv); P is the warp's 16 x t bf16 strip (lp), scr its 16 x 16 float32
// scratch; out points at the warp's first output row of the head (row
// stride c).
__device__ __forceinline__ void head_rows(const bf16* Q, int lq, const bf16* K, int lk,
                                          const bf16* V, int lv, bf16* P, int lp, float* scr,
                                          bf16* __restrict__ out, int c, int t) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31;
  const int rr = lane >> 1, cc = (lane & 1) * 8;  // this lane's 8 values of a 16 x 16 tile
  for (int jt = 0; jt < t / 16; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DOTS_HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Q + kk, lq);
      wmma::load_matrix_sync(fb, K + jt * 16 * lk + kk, lk);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    store8(P + rr * lp + jt * 16 + cc, scr + rr * 16 + cc);
    __syncwarp();
  }
#pragma unroll
  for (int nt = 0; nt < DOTS_HD / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kt = 0; kt < t / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, P + kt * 16, lp);
      wmma::load_matrix_sync(fb, V + kt * 16 * lv + nt * 16, lv);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    store8(out + (long long)rr * c + nt * 16 + cc, scr + rr * 16 + cc);
    __syncwarp();
  }
}

// shared memory of a block whose q, k, v panels are w channels wide
__host__ __device__ inline size_t dots_smem_bytes(int w, int t) {
  return (3ull * t * (w + DOTS_PAD) + (size_t)t * (t + DOTS_PAD)) * sizeof(bf16) +
         (size_t)(t / 16) * 256 * sizeof(float);
}

// W = DOTS_HD: per head (blockIdx.y = head); W = DOTS_GROUP: grouped
// (blockIdx.y = head group, its W / DOTS_HD heads in turn).
template <int W>
__global__ void __launch_bounds__(288)
attn_dots_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int t, int c, int bw) {
  constexpr int L = W + DOTS_PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lp = t + DOTS_PAD;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + t * L;
  bf16* Vs = Ks + t * L;
  bf16* Ps = Vs + t * L;
  const int wid = threadIdx.x >> 5, r0 = wid * 16;
  float* scr = reinterpret_cast<float*>(Ps + t * lp) + wid * 256;
  for (int i = 0; i < bw; ++i) {
    const long long w = (long long)blockIdx.x * bw + i;
    const long long base = w * t * c + (long long)blockIdx.y * W;
    load_panel<W>(Qs, q + base, t, c);
    load_panel<W>(Ks, k + base, t, c);
    load_panel<W>(Vs, v + base, t, c);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int hh = 0; hh < W / DOTS_HD; ++hh) {
      const int off = hh * DOTS_HD;
      head_rows(Qs + r0 * L + off, L, Ks + off, L, Vs + off, L, Ps + r0 * lp, lp, scr,
                out + base + (long long)r0 * c + off, c, t);
    }
    __syncthreads();  // the next window's copies overwrite the panels
  }
}

template <int W>
int attn_dots_launch(const void* q, const void* k, const void* v, void* out, int bnw, int t,
                     int c, int bw, cudaStream_t s) {
  const size_t smem = dots_smem_bytes(W, t);
  cudaFuncSetAttribute(attn_dots_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn_dots_kernel<W><<<dim3(bnw / bw, c / W), t / 16 * 32, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, t, c, bw);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

// q, k, v, out: bf16 (bnw, t, c), contiguous; t % 16 == 0 and t <= 144;
// c = 32 nh; bnw % bw == 0. Grouped: c % 128 == 0.
extern "C" int attn_dots_per_head(const void* q, const void* k, const void* v, void* out, int bnw,
                                  int t, int c, int nh, int bw, void* stream) {
  (void)nh;  // c / DOTS_HD
  return attn_dots_launch<DOTS_HD>(q, k, v, out, bnw, t, c, bw, (cudaStream_t)stream);
}

extern "C" int attn_dots_grouped(const void* q, const void* k, const void* v, void* out, int bnw,
                                 int t, int c, int nh, int bw, void* stream) {
  (void)nh;  // c / DOTS_HD
  return attn_dots_launch<DOTS_GROUP>(q, k, v, out, bnw, t, c, bw, (cudaStream_t)stream);
}
