// K2: fused swin window attention forward.
//
// Replaces flair_for_aigle_tpu/ops/pallas/window_attn.py (_kernel_body :173,
// _build_call :290, fused_window_attention :973). Per window:
//   qkv = x Wqkv^T + b  ->  per head  s = q k^T * scale + rel-pos bias
//   (+ shift mask -100 where the 3x3 band ids differ)  ->  softmax  ->  P V
//   -> head merge -> out = o Wproj^T + b
// Softmax follows the reference body exactly:
//   attn_f32 = 1: float32 scores; e = exp(min(s, 80) - 30) (static shift,
//     clamp), denominator sum(e) + 1e-37, P = e rounded to the compute dtype,
//     normalisation deferred past P V.
//   attn_f32 = 0: scores rounded to the compute dtype after each op
//     (the Pallas order: f32 dot -> cast -> * scale -> + bias -> + mask),
//     per-row max, e = exp(s - max) in the compute dtype, denominator the
//     float32 sum rounded to the compute dtype, deferred normalisation.
//
// Three launches: the qkv GEMM and the proj GEMM around the attention core.
// Both projections are gemm_mma.cuh's tensor-core GEMM (mma.sync fed by a
// cp.async ring; bf16, or float32 as 3xTF32) with its MMA_BIAS epilogue,
// out = rnd(rnd(x W^T) + b), straight from the accumulators; each
// product's tile comes from ops/mma_plan.py (the largest that gives every
// SM a block). The (B*nW, T, 3C) qkv tensor and the pre-projection output
// round-trip device memory between them (kept in VMEM by the TPU kernel;
// re-fusing them is later work).
//
// The bf16 core (attn_core_bf16_kernel). At T = 144, head dim 32, one
// (window, head) reads 27 KB of q, k, v, writes 9 KB of o and does 2.7 MFLOP
// of products: 74 operations per byte against the card's 295 in bf16, so the
// core is bound by its bytes as long as the (T, T) scores never leave the SM.
// Design: one block per (window, head), one warp per 16 query rows (TP / 16
// warps, T padded to TP = 16 * ceil(T / 16)).
//   - q, k, v arrive by 16-byte cp.async into shared memory rows of 80 bytes
//     (64 + 16 of padding: the eight rows of an ldmatrix hit disjoint banks);
//     34.6 KB per block at T = 144, with a byte per key of its shift bands.
//   - S = Q K^T on mma.sync.m16n8k16 (bf16 in, float32 accumulate), one
//     16 x 8 n-tile of the warp's 16 x TP strip at a time, A and B fragments
//     by ldmatrix.x4 (K's rows are B's columns). A thread holds rows g, g + 8
//     and keys 2t, 2t + 1 of each n-tile (g = lane / 4, t = lane % 4).
//   - Scale, bias and shift mask apply to each tile as it leaves the tensor
//     cores. The bias is read from device memory (a head's (T, T) tile stays
//     in L2), two tiles ahead; the mask comes from the key's band byte.
//     attn_f32 = 0 runs on bf16 pairs (mul/add/sub/max.bf16x2 with explicit
//     round-to-nearest: one rounding per op, as the reference rounds each
//     float32 op to bf16, and no fusing of a mul and an add). Each tile then
//     stays as two bf16 pairs a thread: with attn_f32 = 0 the scores, exact
//     in bf16, until the row max is known; with attn_f32 = 1 the
//     probabilities, whose float32 row sum runs meanwhile. The strip is
//     TP / 8 x 2 registers a thread (36 at T = 144), not TP / 2 floats: two
//     blocks of 18 warps leave 96 registers a thread (5 warps share one
//     scheduler's 16K). Row max and sum reduce over the 4 threads of a quad.
//   - P V with P straight from those registers: the pairs of two
//     neighbouring n-tiles are one k-16 A fragment of m16n8k16. V's B
//     fragments by ldmatrix.x4.trans. O is 16 x 32 a warp, 16 floats a
//     thread; divided by the denominator, rounded, staged through the warp's
//     own q rows and stored in 16-byte rows.
//   - __launch_bounds__(32 * TP / 16, 2): two blocks per SM, no spill.
// No (T, T) tile touches shared memory. The float32 core
// (attn_core_f32_kernel, window_attn_f32.cu) keeps this skeleton with both
// products on the tensor cores as 3xTF32, the scores streamed one 16 x 8
// key tile at a time into O.
#include <type_traits>

#include "common.cuh"
#include "core_util.cuh"
#include "gemm_mma.cuh"

namespace flair {

constexpr int ATTN_HD = 32;        // swin v1 head dim (embed_dim / heads) at every size
constexpr int CORE_LD = ATTN_HD + 8;  // bf16 core: shared row stride in elements (80 bytes)

// the float32 core on qkv (bnw * t, 3c) -> o (bnw * t, c)
// (window_attn_f32.cu); with `info`, nothing launches and info[0..3]
// receive its resources at t tokens
int attn_core_f32(const float* qkv, const float* bias, float* o, int bnw, int t, int c, int nh,
                  int ws, int ss, int nwh, int nww, int attn_f32, cudaStream_t s, int* info);

// bf16 core: S and P in mma.sync registers (see the note at the top)
template <int NQ, bool F32>
__global__ void __launch_bounds__(32 * NQ, 2)
    attn_core_bf16_kernel(const bf16* __restrict__ qkv, const void* __restrict__ bias_v,
                          bf16* __restrict__ o, int Tn, int C, int ws, int ss, int nwh, int nww,
                          float scale) {
  using BiasT = typename std::conditional<F32, float, bf16>::type;
  constexpr int TP = 16 * NQ;  // padded tokens
  constexpr int NT = 2 * NQ;   // 8-key n-tiles of the score strip
  constexpr int HD = ATTN_HD, LD = CORE_LD;
  __shared__ __align__(128) bf16 sm[3][TP * LD];  // q, k, v
  __shared__ uint8_t bands[TP];  // per key: bit 0 its row band is 2, bit 1 its column band is 2
  const BiasT* bias = reinterpret_cast<const BiasT*>(bias_v);
  const int w = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)w * Tn;

  // q, k, v rows of this (window, head): four 16-byte chunks each, rows
  // past Tn zero (their P entries are 0, and 0 * garbage may not be); q and
  // k in a first group, v in a second that lands while S is computed
  for (int part = 0; part < 3; ++part) {
    for (int e = threadIdx.x; e < TP * 4; e += blockDim.x) {
      const int t = e >> 2, ch = e & 3;
      bf16* dst = &sm[part][t * LD + ch * 8];
      if (t < Tn)
        cp_async16(dst, qkv + (row0 + t) * (3 * C) + part * C + h * HD + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (part) cp_async_commit();
  }
  const int lim = ws - ss;  // band 1 below it, band 2 from it
  for (int t = threadIdx.x; t < TP; t += blockDim.x)
    bands[t] = (uint8_t)((t >= lim * ws) | (t % ws >= lim) << 1);
  cp_async_wait<1>();  // q, k
  __syncthreads();

  // S = Q K^T one 16 x 8 n-tile at a time; each tile's scores leave the
  // accumulators as bf16 pairs: p[j][hf] holds row r0 + g + 8 hf, keys
  // 8 j + 2 tq and 8 j + 2 tq + 1 (the lower in the low half)
  // Q's A fragment of head dims 0-15 stays in registers; that of dims 16-31
  // is loaded again for each tile (4 registers fewer, no spill at T = 144)
  uint32_t qa0[4];
  ldsm_x4(qa0, &sm[0][(r0 + (lane & 15)) * LD + (lane >> 4) * 8]);
  const int widx = w % (nwh * nww);
  const bool li = ss > 0 && widx / nww == nwh - 1;
  const bool lj = ss > 0 && widx % nww == nww - 1;
  const bool even = (Tn & 1) == 0;
  const uint32_t scale2 = pack_bf16(scale, scale);  // the reference's bf16 scalar
  const BiasT* bhead = bias + (long long)h * Tn * Tn;
  int brow[2];  // bias row offsets; rows past Tn read row 0 (finite, never written)
  // shift mask: a key's bands differ from row i's where (its band bits ^
  // row i's) & sel is not 0, sel = the bands compared in this window (bit 0
  // last row of the grid, bit 1 last column); both bytes of a key pair at once
  const uint32_t sel = (li ? 0x0101u : 0u) | (lj ? 0x0202u : 0u);
  uint32_t rowb[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = r0 + g + 8 * hf;
    brow[hf] = i < Tn ? i * Tn : 0;
    rowb[hf] = bands[i] * 0x0101u;
  }
  uint32_t p[NT][2];
  float sum[2] = {0.f, 0.f}, dn[2];
  uint32_t mx2[2] = {BF16X2_NEG_INF, BF16X2_NEG_INF};
  constexpr int PF = 2;  // tiles of bias in flight ahead of the one in use
  typename std::conditional<F32, uint2, uint32_t>::type bb[NT][2];
#pragma unroll
  for (int j = 0; j < PF && j < NT; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) bb[j][hf] = bias_bits(bhead + brow[hf], 8 * j + 2 * tq, Tn, even);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j + PF < NT) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        bb[j + PF][hf] = bias_bits(bhead + brow[hf], 8 * (j + PF) + 2 * tq, Tn, even);
    }
    uint32_t kb[4];  // keys 8j..8j+7 by head dims 0-7, 8-15, 16-23, 24-31
    ldsm_x4(kb, &sm[1][(8 * j + (lane & 7)) * LD + (lane >> 3) * 8]);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t qa1[4];
    ldsm_x4(qa1, &sm[0][(r0 + (lane & 15)) * LD + 16 + (lane >> 4) * 8]);
    mma_16816(acc, qa0, kb[0], kb[1]);
    mma_16816(acc, qa1, kb[2], kb[3]);
    const int jj = 8 * j + 2 * tq;
    const uint32_t keyb = sel ? *reinterpret_cast<const uint16_t*>(&bands[jj]) : 0u;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t mask = 0;  // -100 in each bf16 half whose key's bands differ from the row's
      if (sel) {
        const uint32_t d = (keyb ^ rowb[hf]) & sel;
        mask = (d & 0xffu ? BF16_MINUS_100 : 0u) | (d >> 8 ? BF16_MINUS_100 << 16 : 0u);
      }
      if constexpr (F32) {
        // float32 scores, static shift: e and the row sum right away
        float e[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float x = acc[2 * hf + u] * scale + __uint_as_float(u ? bb[j][hf].y : bb[j][hf].x);
          if (mask >> (16 * u) & 0xffffu) x += -100.f;
          e[u] = jj + u < Tn ? expf(fminf(x, 80.f) - 30.f) : 0.f;
          sum[hf] += e[u];
        }
        p[j][hf] = pack_bf16(e[0], e[1]);
      } else {
        // bf16 scores on bf16 pairs: each op rounds once, as the float32 op
        // rounded to bf16 does (the exact result of a bf16 product fits a
        // float, and so does a bf16 sum unless the smaller term sits below
        // the larger's rounding); kept exact until the row max is known
        uint32_t xb = mul_bf16x2(pack_bf16(acc[2 * hf], acc[2 * hf + 1]), scale2);
        xb = add_bf16x2(xb, bb[j][hf]);
        if (sel) xb = add_bf16x2(xb, mask);
        if (jj + 1 >= Tn)  // keys past Tn: -inf
          xb = jj >= Tn ? BF16X2_NEG_INF : (xb & 0xffffu) | (BF16X2_NEG_INF & 0xffff0000u);
        mx2[hf] = max_bf16x2(mx2[hf], xb);
        p[j][hf] = xb;
      }
    }
  }
  if constexpr (!F32) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = fmaxf(bf16_lo(mx2[hf]), bf16_hi(mx2[hf]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const uint32_t m2 = pack_bf16(mx, mx);  // exact: mx is a bf16 value
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // e = rnd(exp(rnd(s - max))); -inf past Tn: e = 0
        const uint32_t d = sub_bf16x2(p[j][hf], m2);
        const uint32_t e = pack_bf16(expf(bf16_lo(d)), expf(bf16_hi(d)));
        sum[hf] += bf16_lo(e);
        sum[hf] += bf16_hi(e);
        p[j][hf] = e;
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
    dn[hf] = F32 ? sum[hf] + 1e-37f : rnd<bf16>(rnd<bf16>(sum[hf]) + 1e-37f);
  }

  // O = P V: the pairs of n-tiles 2kk, 2kk + 1 are the A fragment of keys
  // 16kk..16kk+15
  cp_async_wait<0>();  // v
  __syncthreads();
  float oacc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NQ; ++kk) {
    const uint32_t pa[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
    const bf16* vp = &sm[2][(16 * kk + (lane & 15)) * LD + (lane >> 4) * 8];
    uint32_t vb[4];
    ldsm_x4_trans(vb, vp);  // head dims 0-7, 8-15
    mma_16816(oacc[0], pa, vb[0], vb[1]);
    mma_16816(oacc[1], pa, vb[2], vb[3]);
    ldsm_x4_trans(vb, vp + 16);  // head dims 16-23, 24-31
    mma_16816(oacc[2], pa, vb[0], vb[1]);
    mma_16816(oacc[3], pa, vb[2], vb[3]);
  }

  // o = O / denominator: staged through the warp's own q rows (read only
  // by this warp, and done with), then 16-byte rows at the head's offset
  __syncwarp();
  bf16* stage = &sm[0][r0 * LD];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<uint32_t*>(&stage[g * LD + 8 * n + 2 * tq]) =
        pack_bf16(oacc[n][0] / dn[0], oacc[n][1] / dn[0]);
    *reinterpret_cast<uint32_t*>(&stage[(g + 8) * LD + 8 * n + 2 * tq]) =
        pack_bf16(oacc[n][2] / dn[1], oacc[n][3] / dn[1]);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 64; e += 32) {
    const int r = e >> 2, ch = e & 3, i = r0 + r;
    if (i < Tn)
      *reinterpret_cast<uint4*>(o + (row0 + i) * C + h * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(&stage[r * LD + ch * 8]);
  }
}


template <int NQ, bool F32>
int bf16_core_nq(const bf16* qkv, const void* bias, bf16* o, int bnw, int t, int c, int nh,
                 int ws, int ss, int nwh, int nww, cudaStream_t stream, int* info) {
  if (info) return kernel_info(attn_core_bf16_kernel<NQ, F32>, 32 * NQ, 0, info);
  const float scale = 1.f / sqrtf((float)ATTN_HD);
  attn_core_bf16_kernel<NQ, F32><<<dim3(bnw, nh), 32 * NQ, 0, stream>>>(
      qkv, bias, o, t, c, ws, ss, nwh, nww, scale);
  return 0;
}

template <bool F32>
int bf16_core(const bf16* qkv, const void* bias, bf16* o, int bnw, int t, int c, int nh, int ws,
              int ss, int nwh, int nww, cudaStream_t stream, int* info) {
#define FLAIR_CORE_NQ(NQ) \
  case NQ:                \
    return bf16_core_nq<NQ, F32>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, stream, info);
  switch ((t + 15) / 16) {
    FLAIR_CORE_NQ(1)
    FLAIR_CORE_NQ(2)
    FLAIR_CORE_NQ(3)
    FLAIR_CORE_NQ(4)
    FLAIR_CORE_NQ(5)
    FLAIR_CORE_NQ(6)
    FLAIR_CORE_NQ(7)
    FLAIR_CORE_NQ(8)
    FLAIR_CORE_NQ(9)
  }
#undef FLAIR_CORE_NQ
  return (int)cudaErrorInvalidValue;  // T > 144
}

// the core on qkv (bnw * t, 3c) -> o (bnw * t, c); with `info`, nothing
// launches and info[0..3] receive the core kernel's resources
template <typename T>
int attn_core(const T* qkv, const void* bias, T* o, int bnw, int t, int c, int nh, int ws,
              int ss, int nwh, int nww, int attn_f32, cudaStream_t s, int* info = nullptr) {
  if constexpr (std::is_same<T, float>::value) {
    return attn_core_f32(qkv, (const float*)bias, o, bnw, t, c, nh, ws, ss, nwh, nww, attn_f32,
                         s, info);
  } else {
    return attn_f32 ? bf16_core<true>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, s, info)
                    : bf16_core<false>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, s, info);
  }
}

template <typename T>
int window_attn_impl(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                     const void* bproj, const void* bias, void* qkv, void* o, void* out,
                     int bnw, int t, int c, int nh, int ws, int ss, int nwh, int nww,
                     int attn_f32, int tile_qkv, int tile_proj, cudaStream_t s) {
  const int m = bnw * t;
  int rc = gemm_bias<T>(tile_qkv, (const T*)x, (const T*)wqkv, (const T*)bqkv, (T*)qkv, m, 3 * c,
                        c, s);
  if (!rc)
    rc = attn_core<T>((const T*)qkv, bias, (T*)o, bnw, t, c, nh, ws, ss, nwh, nww, attn_f32, s);
  if (!rc)
    rc = gemm_bias<T>(tile_proj, (const T*)o, (const T*)wproj, (const T*)bproj, (T*)out, m, c, c,
                      s);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

// tile_qkv, tile_proj: the projections' tile codes (ops/mma_plan.py)
extern "C" int window_attn_fwd(const void* x, const void* wqkv, const void* bqkv,
                               const void* wproj, const void* bproj, const void* bias,
                               void* qkv, void* o, void* out, int bnw, int t, int c, int nh,
                               int ws, int ss, int nwh, int nww, int attn_f32, int tile_qkv,
                               int tile_proj, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return window_attn_impl<float>(x, wqkv, bqkv, wproj, bproj, bias, qkv, o, out, bnw, t, c,
                                   nh, ws, ss, nwh, nww, attn_f32, tile_qkv, tile_proj, s);
  return window_attn_impl<bf16>(x, wqkv, bqkv, wproj, bproj, bias, qkv, o, out, bnw, t, c, nh,
                                ws, ss, nwh, nww, attn_f32, tile_qkv, tile_proj, s);
}

// the resources of the projections' GEMM kernel (gemm_mma.cuh, MMA_BIAS)
// with tile code `tile` in `dtype`: out = int[4] registers, local bytes,
// shared bytes, blocks per SM (K6's qkv recompute instantiates the same
// kernel in window_attn_bwd.cu)
extern "C" int window_attn_gemm_info(int dtype, int tile, int* out) {
  return dtype == 0 ? gemm_bias<float>(tile, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, out)
                    : gemm_bias<bf16>(tile, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, out);
}

// the attention core alone: qkv (bnw * t, 3c) -> o (bnw * t, c)
extern "C" int window_attn_core(const void* qkv, const void* bias, void* o, int bnw, int t,
                                int c, int nh, int ws, int ss, int nwh, int nww, int attn_f32,
                                int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = dtype == 0 ? attn_core<float>((const float*)qkv, bias, (float*)o, bnw, t, c, nh,
                                               ws, ss, nwh, nww, attn_f32, s)
                            : attn_core<bf16>((const bf16*)qkv, bias, (bf16*)o, bnw, t, c, nh,
                                              ws, ss, nwh, nww, attn_f32, s);
  return rc ? rc : (int)cudaGetLastError();
}

// the core kernel's registers, local (spill) bytes a thread, shared bytes a
// block and resident blocks per SM at t tokens
extern "C" int window_attn_core_info(int t, int attn_f32, int dtype, int* out) {
  if (dtype == 0)
    return attn_core<float>(nullptr, nullptr, nullptr, 0, t, 0, 0, 0, 0, 0, 0, attn_f32, 0, out);
  return attn_core<bf16>(nullptr, nullptr, nullptr, 0, t, 0, 0, 0, 0, 0, 0, attn_f32, 0, out);
}
