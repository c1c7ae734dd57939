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
// rows (9 warps for T = 144), on mma.sync.m16n8k16 (bf16 in, float32
// accumulate) with ldmatrix fragments (Q and K by ldmatrix, V by
// ldmatrix.trans). There is no softmax, so no row of scores is ever held
// whole: the warp streams its 16 rows over the keys 16 at a time. S for 16
// keys is two m16n8 accumulator tiles; rounded to bf16 pairs they are
// exactly the A fragment of P V's m16n8k16 (the n8 tiles' columns are the
// k16 fragment's), and O += P V for those 16 keys follows at once. S and P
// live only in registers: no float32 scratch, no P strip in shared memory.
// O sums the keys' chunks in order, as the reference's one product does;
// the output leaves by a quad transpose as 16-byte stores. T = 144 = 9 x 16
// fits the tiles, so the TPU's lane padding to 256 columns is not carried
// over. q, k, v arrive in shared memory by 16-byte cp.async row copies.
//
//   per head: one block per (group of bw windows, head); it copies the
//     64-byte head slice of each q, k, v row into rows padded to 80 bytes
//     (ldmatrix's 8 rows a phase on distinct banks), in two stages: the
//     next window's copies are in flight while the current window computes.
//     69 KB of shared memory: three blocks per SM.
//   grouped:  one block per (group of bw windows, group of 128 / 32 = 4
//     heads); it copies the 256-byte group row of q, k, v once and runs the
//     group's heads one after another from those panels. The rows are not
//     padded: the 16-byte chunk c of row r lies at chunk c ^ (r & 7) (XOR
//     swizzle), again on distinct banks. 108 KB, one stage: two blocks per
//     SM, one computing while the other copies.
//
// The TPU's body_b builds block-diagonal K and V panels (an MXU-width
// workaround); they are not materialised here: at 4 heads and T = 144 they
// would take 2 x 147 KB. (The TPU body also leaves their off-diagonal and
// pad entries unset, so its output is not finite in interpret mode.)
#include "common.cuh"
#include "core_util.cuh"

namespace flair {

constexpr int DOTS_HD = 32;      // head dim
constexpr int DOTS_GROUP = 128;  // channels of a head group (the TPU's MXU width)
constexpr int DOTS_T = 144;      // tokens of the tool's window (its threads: T / 16 warps)

// per head (W = DOTS_HD): rows of W + 8 bf16 and two stages; grouped: rows
// of W, swizzled, and one stage
template <int W> __host__ __device__ constexpr int dots_ld() { return W == DOTS_HD ? W + 8 : W; }
template <int W> __host__ __device__ constexpr int dots_stages() { return W == DOTS_HD ? 2 : 1; }
// resident blocks per SM the design promises (__launch_bounds__)
template <int W> __host__ __device__ constexpr int dots_blocks() { return W == DOTS_HD ? 3 : 2; }

// the element offset of row r, column col (a multiple of 8) of a panel
template <int W> __device__ __forceinline__ int panel_at(int r, int col) {
  if constexpr (W == DOTS_HD)
    return r * dots_ld<W>() + col;
  else
    return r * W + (((col >> 3) ^ (r & 7)) << 3);
}

// Copy t rows of W bf16 channels (row stride c in device memory) into a
// panel, in 16-byte chunks, neighbouring threads on neighbouring chunks.
template <int W>
__device__ __forceinline__ void load_panel(bf16* dst, const bf16* __restrict__ src, int t, int c) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < t * CH; e += blockDim.x) {
    const int r = e / CH, ch = e % CH;
    cp_async16(dst + panel_at<W>(r, ch * 8), src + (long long)r * c + ch * 8);
  }
}

// One warp, 16 query rows r0.. of the head at columns hoff.. of the Q, K,
// V panels: S and P in registers, 16 keys at a time; out points at the
// warp's first output row at the panels' first column (row stride c).
template <int W>
__device__ __forceinline__ void head_rows(const bf16* Q, const bf16* K, const bf16* V, int hoff,
                                          int r0, bf16* __restrict__ out, int c, int t,
                                          int lane) {
  uint32_t qa[2][4];  // A fragments of the 16 rows: head dims 0-15, 16-31
  const int ar = r0 + (lane & 15), ac = hoff + (lane >> 4) * 8;
  ldsm_x4(qa[0], Q + panel_at<W>(ar, ac));
  ldsm_x4(qa[1], Q + panel_at<W>(ar, ac + 16));
  float o[4][4] = {};  // O: n8 tiles of head dims 0-7, ..., 24-31
#pragma unroll 3
  for (int kc = 0; kc < t; kc += 16) {
    float s[2][4] = {};  // S of keys kc.. kc + 7, kc + 8.. kc + 15
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t b[4];  // keys kc + 8n.., head dims 0-7, 8-15, 16-23, 24-31
      ldsm_x4(b, K + panel_at<W>(kc + 8 * n + (lane & 7), hoff + (lane >> 3) * 8));
      mma_16816(s[n], qa[0], b[0], b[1]);
      mma_16816(s[n], qa[1], b[2], b[3]);
    }
    // the two n8 tiles rounded to bf16: the k16 A fragment of P V
    const uint32_t p[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      uint32_t b[4];  // keys kc.. kc + 15, head dims 16 hv.. 16 hv + 15
      ldsm_x4_trans(b, V + panel_at<W>(kc + (lane & 15), hoff + 16 * hv + (lane >> 4) * 8));
      mma_16816(o[2 * hv], p, b[0], b[1]);
      mma_16816(o[2 * hv + 1], p, b[2], b[3]);
    }
  }
  // rows g and g + 8: each quad's four n8 tiles transposed, so that lane t
  // holds head dims 8 t .. 8 t + 7, one 16-byte store
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    uint32_t v[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) v[n] = pack_bf16(o[n][2 * hf], o[n][2 * hf + 1]);
    quad_transpose(v, tq);
    *reinterpret_cast<uint4*>(out + (long long)(g + 8 * hf) * c + hoff + 8 * tq) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// shared memory of a block whose q, k, v panels are W channels wide
template <int W> __host__ __device__ constexpr size_t dots_smem_bytes(int t) {
  return (size_t)dots_stages<W>() * 3 * t * dots_ld<W>() * sizeof(bf16);
}

// W = DOTS_HD: per head (blockIdx.x = head); W = DOTS_GROUP: grouped
// (blockIdx.x = head group, its W / DOTS_HD heads in turn); blockIdx.y =
// window group, so that the blocks of one window's heads run side by side
// and read its rows whole. Window i of
// the block's bw goes to stage i % NS; per head (NS = 2) window i + 1's
// copies are in flight while window i computes, grouped (NS = 1) copies
// window i once window i - 1 is done.
template <int W>
__global__ void __launch_bounds__(DOTS_T / 16 * 32, dots_blocks<W>())
    attn_dots_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int t, int c, int bw) {
  constexpr int NS = dots_stages<W>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* panels = reinterpret_cast<bf16*>(smem_raw);
  const int panel = t * dots_ld<W>();  // elements of one panel
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const long long w0 = (long long)blockIdx.y * bw;
  const int col0 = blockIdx.x * W;
  auto load = [&](int i) {
    bf16* st = panels + (i % NS) * 3 * panel;
    const long long base = (w0 + i) * t * c + col0;
    load_panel<W>(st, q + base, t, c);
    load_panel<W>(st + panel, k + base, t, c);
    load_panel<W>(st + 2 * panel, v + base, t, c);
    cp_async_commit();
  };
  load(0);
  for (int i = 0; i < bw; ++i) {
    if (NS == 1 && i > 0) load(i);
    if (NS == 2 && i + 1 < bw) {
      load(i + 1);
      cp_async_wait<1>();  // window i's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* st = panels + (i % NS) * 3 * panel;
    bf16* o = out + (w0 + i) * t * c + col0 + (long long)r0 * c;
#pragma unroll 1
    for (int hh = 0; hh < W / DOTS_HD; ++hh)
      head_rows<W>(st, st + panel, st + 2 * panel, hh * DOTS_HD, r0, o, c, t, lane);
    __syncthreads();  // the copies of window i + NS overwrite this stage
  }
}

// launch (or, with `info`, write the kernel's resources at T = t there:
// core_util.cuh kernel_info)
template <int W>
int attn_dots_launch(const void* q, const void* k, const void* v, void* out, int bnw, int t,
                     int c, int bw, cudaStream_t s, int* info = nullptr) {
  const auto kernel = attn_dots_kernel<W>;
  const size_t smem = dots_smem_bytes<W>(t);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (info) return kernel_info(kernel, t / 16 * 32, smem, info);
  kernel<<<dim3(c / W, bnw / bw), t / 16 * 32, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, t, c, bw);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

// q, k, v, out: bf16 (bnw, t, c), contiguous, 16-byte aligned; t = 144;
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

// the kernel's registers, local (spill) bytes a thread, shared bytes a
// block and resident blocks per SM at the tool's T = 144 (grouped: 0 per
// head, 1 grouped)
extern "C" int attn_dots_info(int grouped, int* out) {
  return grouped ? attn_dots_launch<DOTS_GROUP>(nullptr, nullptr, nullptr, nullptr, 0, DOTS_T, 0,
                                                1, 0, out)
                 : attn_dots_launch<DOTS_HD>(nullptr, nullptr, nullptr, nullptr, 0, DOTS_T, 0, 1,
                                             0, out);
}
