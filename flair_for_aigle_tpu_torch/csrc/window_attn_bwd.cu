// K6: fused swin window attention backward.
//
// Replaces flair_for_aigle_tpu/ops/pallas/window_attn.py: the monolithic
// backward (_bwd_kernel_body :422, _build_bwd_call :534) and its
// head-chunked variant (_bwd_chunked_body :631, _build_bwd_chunked_call
// :751). The chunked grid existed only to fit the TPU's VMEM at C = 512 /
// 1024; here one design serves every width, so neither grid nor the
// compile-probe chain (:819-883) is ported.
//
// Given the forward's raw inputs (x, Wqkv, bqkv, Wproj, bias) and the
// output gradient g, flash-style (nothing but the inputs was saved):
//   1. qkv = rnd(rnd(x Wqkv^T) + bqkv)          (gemm_mma.cuh, MMA_BIAS, with
//      the tile K2's forward takes at the same M: the qkv K2 computed)
//   2. do  = rnd(g Wproj)                       (gemm_mma.cuh, MMA_ROUND on
//      Wproj's transposed copy, with the tile K2's output projection takes)
//   3. core, one block per (window group, head), walking the group's
//      windows: recompute s and p, then o = pc v, dp = do v^T, ds = p (dp -
//      sum(dp p)), dq = scale ds k, dk = scale ds^T q, dv = pc^T do; ds
//      accumulates over the group's windows into the (group, head)'s dbias
//      partial, and the float32 column sums of dq, dk, dv into the group's
//      dbqkv partial. Writes o and dqkv (compute dtype).
//   4. dWproj = g^T o and dWqkv = dqkv^T x      (gemm_mma.cuh, MMA_WGRAD:
//      C = A^T B, split-K over the B*nW*T rows into float32 partials)
//   5. dx = rnd(dqkv Wqkv)                      (gemm_mma.cuh, MMA_ROUND on
//      Wqkv's transposed copy)
//   (steps 2, 4 and 5: window_attn_bwd_gemm.cu; float32 as 3xTF32)
//   6. dbproj = column sums of g; the partials of steps 3-4 are summed in a
//      fixed order, so a result repeats exactly from run to run (no atomics).
// Rounding points follow _bwd_kernel_body: do rounded to the compute dtype
// (:458-461); attn_f32 = 1: p = exp(min(s, 80) - 30) / (sum + 1e-37),
// normalised before P V, the clamp's derivative ignored (:479-492);
// attn_f32 = 0: s and p in the compute dtype with the row max (:472-478);
// ds, dq, dk, dv in float32 (:502-515); dbqkv from the float32 dqkv (:521);
// dWqkv and dx from dqkv rounded to the compute dtype (:522-528); dbproj
// from g in float32 (:457).
//
// Bound on the card: at swin-base@512 the five GEMMs (2 x 3C C + 2 x C C +
// 3C C multiply-adds per token) carry most of the flops; the core is 6
// T x T x 32 products per (window, head) on 74 KB of bf16 q, k, v, do, o and
// dqkv: bound by its bytes as long as the (B*nW, nh, T, T) scores,
// probabilities and ds never reach device memory. The qkv, do, o and dqkv
// tensors round-trip device memory between the launches.
//
// The bf16 core (attn_bwd_core_bf16_kernel): TP / 16 warps (T padded to
// TP = 16 ceil(T / 16)), each owning 16 rows of the (window, head); q, k,
// v and do arrive by cp.async in padded 80-byte bf16 rows (46 KB at
// T = 144), and every (T, T) matrix lives only in mma.sync.m16n8k16
// registers, one 16 x 16 tile at a time (ldmatrix fragments as in K2's
// core). The products are needed in both orientations, so each window
// takes two passes:
//   - pass Q, a warp's 16 query rows against every key: S = Q K^T and the
//     row statistics, then P with O = pc V, dS = P (dP - D) (dP = dO V^T)
//     and dQ += dS K. attn_f32: one statistics sweep gives den and D =
//     (sum_j e dp) / den, the float32 sum of p dp with the division by den
//     taken out of it; attn_f32 = 0 takes the max, den and D = sum_j p dp
//     (p rounded to bf16 first) in three. Writes o and dq, and leaves each
//     query row's max, den, 1 / den and D in shared memory;
//   - pass K, a warp's 16 keys against every query: S^T = K Q^T, P^T from
//     the stored statistics, dV += P^T dO, dP^T = V dO^T, dS^T and dK +=
//     dS^T Q. Writes dk and dv. Every p of both passes goes through one
//     function (probs_pair), and the tensor cores sum a score's products
//     the same way in both orientations, so both passes see the same p.
//     The thread that holds ds(i, j) is the one thread that ever touches
//     dbias(i, j) of its (group, head): it writes it at the group's first
//     window and adds to it at the others (the 81 KB partial stays in L2),
//     so no (T, T) tile occupies shared memory.
// S and dP are recomputed in each sweep rather than held (a 16 x 144
// float32 strip is 72 registers a thread): products are nearly free here,
// registers are not. The float32 bias (and in pass K the dbias partial)
// reaches each warp as 16 x 16 tiles staged by cp.async one tile ahead in
// a two-stage ring of its own, so the L2 latency of those reads overlaps
// the previous tile's work. p = e / den is one product by the row's
// correctly rounded 1 / den and one correction step (Markstein: the IEEE
// quotient, for a normal quotient). ds is float32, as the reference's dq
// and dk products are: it enters the bf16 tensor cores as three exact bf16
// terms (hi + mid + lo, 3 x 8 significant bits) summed in one float32
// accumulator. Each block takes 107 KB of shared memory at T = 144 and at
// most 96 registers a thread, so two blocks (18 warps) share an SM. The
// float32 core (attn_bwd_core_f32_kernel, window_attn_bwd_f32.cu) keeps
// this skeleton and takes every product float32-accurate on the tf32
// tensor cores (3xTF32); the helpers both share are in window_attn_bwd.cuh.
#include <type_traits>

#include "common.cuh"
#include "core_util.cuh"
#include "gemm_mma.cuh"
#include "window_attn_bwd.cuh"

namespace flair {

// ---- the bf16 core: S, P, dP and dS in mma.sync registers (see the note
// at the top) ----

constexpr int BC_LD = BWD_HD + 8;  // bf16 row stride in shared memory (80 bytes)

// shared bytes of the bf16 core at tp padded tokens: q, k, v, do rows; the
// warps' rings; per query row its max, denominator, reciprocal and D; per
// warp the dq, dk, dv column sums; per token its band byte
inline size_t bf16_bwd_smem_bytes(int tp) {
  return 4ull * tp * BC_LD * sizeof(bf16) + (size_t)(tp / 16) * RING_WARP * sizeof(float) +
         4ull * tp * sizeof(float) + (size_t)(tp / 16) * 3 * BWD_HD * sizeof(float) + tp;
}

// acc[n] = the 16 rows at a_rows times rows 8n .. 8n + 7 at b_rows, over
// the head dims (one 16 x 16 tile); the A fragments are loaded here, for
// each tile, rather than held across the loops (8 registers fewer)
__device__ __forceinline__ void tile16(float (&acc)[2][4], const bf16* a_rows,
                                       const bf16* b_rows, int lane) {
  uint32_t a[2][4];
  const bf16* pa = a_rows + (lane & 15) * BC_LD + (lane >> 4) * 8;
  ldsm_x4(a[0], pa);       // head dims 0-15
  ldsm_x4(a[1], pa + 16);  // head dims 16-31
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    uint32_t b[4];
    ldsm_x4(b, b_rows + (8 * n + (lane & 7)) * BC_LD + (lane >> 3) * 8);
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    mma_16816(acc[n], a[0], b[0], b[1]);
    mma_16816(acc[n], a[1], b[2], b[3]);
  }
}

// acc[n] += a (16 x 16 over the tokens of `rows`) times the head dims 8n ..
// 8n + 7 of those 16 rows (B by ldmatrix.trans)
__device__ __forceinline__ void mma_rows(float (&acc)[4][4], const uint32_t (&a)[4],
                                         const bf16* rows, int lane) {
  const bf16* p = rows + (lane & 15) * BC_LD + (lane >> 4) * 8;
  uint32_t b[4];
  ldsm_x4_trans(b, p);  // head dims 0-7, 8-15
  mma_16816(acc[0], a, b[0], b[1]);
  mma_16816(acc[1], a, b[2], b[3]);
  ldsm_x4_trans(b, p + 16);  // head dims 16-23, 24-31
  mma_16816(acc[2], a, b[0], b[1]);
  mma_16816(acc[3], a, b[2], b[3]);
}

// acc += ds (16 x 16, C fragments of two n-tiles) times the 16 rows of
// `rows`, ds split into three exact bf16 terms hi + mid + lo (three times 8
// significant bits hold float32's 24), one term at a time: each term's
// pairs are the A fragment, ds keeps the remainder
__device__ __forceinline__ void mma_split(float (&acc)[4][4], float (&ds)[2][4],
                                          const bf16* rows, int lane) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t a[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float& x0 = ds[n][2 * hf];
        float& x1 = ds[n][2 * hf + 1];
        a[2 * n + hf] = pack_bf16(x0, x1);
        if (k < 2) {
          x0 = __fsub_rn(x0, bf16_lo(a[2 * n + hf]));
          x1 = __fsub_rn(x1, bf16_hi(a[2 * n + hf]));
        }
      }
    mma_rows(acc, a, rows, lane);
  }
}

// attn_f32 = 0: the bf16 scores of an element pair, rnd(rnd(rnd(acc) *
// rnd(scale)) + rnd(bias)), then rnd(s - 100) where the bands differ; -inf
// past Tn (n_in: how many of the two lie before Tn)
__device__ __forceinline__ uint32_t s_bf16(float a0, float a1, float2 b, uint32_t diff,
                                           int n_in, uint32_t scale2) {
  uint32_t x = mul_bf16x2(pack_bf16(a0, a1), scale2);
  x = add_bf16x2(x, pack_bf16(b.x, b.y));
  if (diff)
    x = add_bf16x2(x, (diff & 0xffu ? BF16_MINUS_100 : 0u) |
                          (diff >> 8 ? BF16_MINUS_100 << 16 : 0u));
  if (n_in < 2) x = n_in ? (x & 0xffffu) | (BF16X2_NEG_INF & 0xffff0000u) : BF16X2_NEG_INF;
  return x;
}

// attn_f32 = 0: e = rnd(exp(rnd(s - m))) of a pair (m2: the pair's row maxima)
__device__ __forceinline__ uint32_t e_bf16(uint32_t s, uint32_t m2) {
  const uint32_t d = sub_bf16x2(s, m2);
  return pack_bf16(expf(bf16_lo(d)), expf(bf16_hi(d)));
}

// the probabilities p0, p1 of an element pair (acc0, acc1: its products;
// b: its bias; diff: band_diff's bits; in0, in1: whether each column lies
// before T, else p = 0) as the mode computes them, and pc, their bf16 pair: attn_f32 p = e /
// den in float32; else rnd(e / den) of the bf16 e = rnd(exp(rnd(s - m))).
// m, den, rden (1 / den): the statistics of each element's query row. Both
// passes take every p through this function, so a product that leaves the
// tensor cores the same in both orientations gives the same p.
template <bool F32>
__device__ __forceinline__ uint32_t probs_pair(float acc0, float acc1, float2 b, uint32_t diff,
                                               bool in0, bool in1, float scale, uint32_t scale2,
                                               float2 m, float2 den, float2 rden, float& p0,
                                               float& p1) {
  if constexpr (F32) {
    p0 = div_r(e_f32(acc0, b.x, diff & 0xffu, in0, scale), den.x, rden.x);
    p1 = div_r(e_f32(acc1, b.y, diff >> 8, in1, scale), den.y, rden.y);
    return pack_bf16(p0, p1);
  } else {
    const uint32_t e =
        e_bf16(s_bf16(acc0, acc1, b, diff, in0 + in1, scale2), pack_bf16(m.x, m.y));
    const uint32_t pc =
        pack_bf16(div_r(bf16_lo(e), den.x, rden.x), div_r(bf16_hi(e), den.y, rden.y));
    p0 = bf16_lo(pc);
    p1 = bf16_hi(pc);
    return pc;
  }
}

// a 16 x 32 float32 tile (rows r, r + 8 at dst_g, dst_g8) rounded to bf16
// pairs and stored; rows past Tn not
__device__ __forceinline__ void store_rows(bf16* dst_g, bf16* dst_g8, const float (&acc)[4][4],
                                           bool in0, bool in1, int tq) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (in0)
      *reinterpret_cast<uint32_t*>(dst_g + 8 * n + 2 * tq) = pack_bf16(acc[n][0], acc[n][1]);
    if (in1)
      *reinterpret_cast<uint32_t*>(dst_g8 + 8 * n + 2 * tq) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// FULL: T = TP, no padded row or column (T = 144, 64, 16), every bound
// check folded away at compile time
template <int NQ, bool F32, bool FULL>
__global__ void __launch_bounds__(32 * NQ, 2)
    attn_bwd_core_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                              const float* __restrict__ bias, bf16* __restrict__ o,
                              bf16* __restrict__ dqkv, float* __restrict__ dbias_part,
                              float* __restrict__ dbqkv_part, int bnw, int t, int C, int nh,
                              int ws, int ss, int nwh, int nww, float scale) {
  constexpr int TP = 16 * NQ, LD = BC_LD, HD = BWD_HD;
  const int Tn = FULL ? TP : t;
  auto in_t = [&](int x) { return FULL || x < Tn; };  // token x lies before T
  auto n_in = [&](int c) { return FULL ? 2 : min(2, max(0, Tn - c)); };  // of c, c + 1
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TP * LD;
  bf16* Vs = Ks + TP * LD;
  bf16* Gs = Vs + TP * LD;                                   // do
  float* rings = reinterpret_cast<float*>(Gs + TP * LD);    // per warp: RING_WARP floats
  float* st_m = rings + NQ * RING_WARP;  // per query row: max (attn_f32 = 0)
  float* st_den = st_m + TP;             // denominator
  float* st_r = st_den + TP;             // its reciprocal
  float* st_D = st_r + TP;               // D = sum_j p dp
  float* csum = st_D + TP;               // per warp: [dq | dk | dv] x 32
  uint8_t* bands = reinterpret_cast<uint8_t*>(csum + NQ * 3 * HD);

  const int grp = blockIdx.x, h = blockIdx.y, n_groups = gridDim.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int C3 = 3 * C;
  const int wpb = (bnw + n_groups - 1) / n_groups;
  const int w_lo = grp * wpb, w_hi = min(bnw, w_lo + wpb);
  const float* bhead = bias + (long long)h * Tn * Tn;
  float* dbh = dbias_part + ((long long)grp * nh + h) * Tn * Tn;
  const bool vec = FULL || (Tn & 3) == 0;  // bias rows in 16-byte chunks
  const uint32_t scale2 = pack_bf16(scale, scale);  // the reference's bf16 scalar
  float* cs = csum + wid * 3 * HD;
  float* ring = rings + wid * RING_WARP;

  for (int e = threadIdx.x; e < NQ * 3 * HD; e += blockDim.x) csum[e] = 0.f;
  const int lim = ws - ss;  // band 1 below it, band 2 from it
  for (int t = threadIdx.x; t < TP; t += blockDim.x)
    bands[t] = (uint8_t)((t >= lim * ws) | (t % ws >= lim) << 1);
  if (w_lo >= w_hi)
    for (int e = threadIdx.x; e < Tn * Tn; e += blockDim.x) dbh[e] = 0.f;

  // this warp's 16 rows: query rows in pass Q, key rows in pass K
  const int r0 = wid * 16;
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool in_a = in_t(ra), in_b = in_t(rb);
  const int nr = FULL ? 16 : Tn - r0;  // this warp's rows before T

  // sweep(stage, body): body(j, tiles) for j = 0 .. NQ - 1, tiles the
  // float32 tiles that stage(j, tiles) put in flight one step ahead (two
  // stages of this warp's ring)
  auto sweep = [&](auto stage, auto body) {
    stage(0, ring);
    cp_async_commit();
#pragma unroll 1
    for (int j = 0; j < NQ; ++j) {
      if (j + 1 < NQ) stage(j + 1, ring + ((j + 1) & 1) * 2 * RING_TILE);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      body(j, ring + (j & 1) * 2 * RING_TILE);
      __syncwarp();  // every lane is done with the stage before it is refilled
    }
  };
  // pass Q's tile j: bias rows r0 .. r0 + 15, keys 16 j .. 16 j + 15
  auto stage_q = [&](int j, float* t) {
    stage_tile(t, RQ_LD, bhead + r0 * Tn + 16 * j, Tn, nr, FULL ? 16 : Tn - 16 * j, vec, lane);
  };

  for (int w = w_lo; w < w_hi; ++w) {
    const long long row0 = (long long)w * Tn;
    __syncthreads();  // the previous window is done with the rows and statistics
    // q, k, v and do rows of this (window, head): four 16-byte chunks each,
    // rows past Tn zero
    for (int e = threadIdx.x; e < 16 * TP; e += blockDim.x) {
      const int part = e / (4 * TP), t = (e >> 2) % TP, ch = e & 3;
      bf16* dst = Qs + part * TP * LD + t * LD + ch * 8;
      if (in_t(t))
        cp_async16(dst, part < 3 ? qkv + (row0 + t) * C3 + part * C + h * HD + ch * 8
                                 : dout + (row0 + t) * C + h * HD + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int widx = w % (nwh * nww);
    const bool li = ss > 0 && widx / nww == nwh - 1;
    const bool lj = ss > 0 && widx % nww == nww - 1;
    const uint32_t sel = (li ? 0x0101u : 0u) | (lj ? 0x0202u : 0u);
    const uint32_t rowb[2] = {bands[ra] * 0x0101u, bands[rb] * 0x0101u};

    // ---- pass Q: the warp's 16 query rows against every key ----
    {
      const bf16* qa = Qs + r0 * LD;  // this warp's q and do rows
      const bf16* ga = Gs + r0 * LD;
      // pair (n, hf) of tile j (keys 16 j + 8 n + 2 tq, + 1 of row g + 8 hf):
      // its bias pair and its band bits, read where they are used
      auto bias_q = [&](const float* bt, int n, int hf) {
        return *reinterpret_cast<const float2*>(bt + (g + 8 * hf) * RQ_LD + 8 * n + 2 * tq);
      };
      auto diff_q = [&](int j, int n, int hf) {
        return band_diff(bands, 16 * j + 8 * n + 2 * tq, rowb[hf], sel);
      };
      // the row statistics m (attn_f32 = 0), den, 1 / den and D
      float m[2] = {0.f, 0.f}, den[2], rden[2], D[2] = {0.f, 0.f}, sum[2] = {0.f, 0.f};
      auto set_den = [&]() {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float s = quad_sum(sum[hf]);
          den[hf] = F32 ? s + 1e-37f : rnd<bf16>(rnd<bf16>(s) + 1e-37f);
          rden[hf] = __frcp_rn(den[hf]);
        }
      };
      if constexpr (F32) {
        // one sweep: den = sum e + 1e-37 and D = (sum e dp) / den, the
        // float32 sum of p dp with the division by den taken out
        sweep(stage_q, [&](int j, const float* bt) {
          float acc[2][4], dp[2][4];
          tile16(acc, qa, Ks + 16 * j * LD, lane);
          tile16(dp, ga, Vs + 16 * j * LD, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int c = 16 * j + 8 * n + 2 * tq;
              const float2 b = bias_q(bt, n, hf);
              const uint32_t d = diff_q(j, n, hf);
              const float e0 = e_f32(acc[n][2 * hf], b.x, d & 0xffu, in_t(c), scale);
              const float e1 = e_f32(acc[n][2 * hf + 1], b.y, d >> 8, in_t(c + 1), scale);
              sum[hf] += e0 + e1;
              D[hf] += e0 * dp[n][2 * hf] + e1 * dp[n][2 * hf + 1];
            }
        });
        set_den();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) D[hf] = div_r(quad_sum(D[hf]), den[hf], rden[hf]);
      } else {
        // the row max, then den = rnd(rnd(sum e) + 1e-37), then D = sum p dp
        uint32_t mx2[2] = {BF16X2_NEG_INF, BF16X2_NEG_INF};
        sweep(stage_q, [&](int j, const float* bt) {
          float acc[2][4];
          tile16(acc, qa, Ks + 16 * j * LD, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              mx2[hf] = max_bf16x2(
                  mx2[hf], s_bf16(acc[n][2 * hf], acc[n][2 * hf + 1], bias_q(bt, n, hf),
                                  diff_q(j, n, hf), n_in(16 * j + 8 * n + 2 * tq), scale2));
        });
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = fmaxf(bf16_lo(mx2[hf]), bf16_hi(mx2[hf]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          m[hf] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        }
        sweep(stage_q, [&](int j, const float* bt) {
          float acc[2][4];
          tile16(acc, qa, Ks + 16 * j * LD, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const uint32_t e =
                  e_bf16(s_bf16(acc[n][2 * hf], acc[n][2 * hf + 1], bias_q(bt, n, hf),
                                diff_q(j, n, hf), n_in(16 * j + 8 * n + 2 * tq), scale2),
                         pack_bf16(m[hf], m[hf]));
              sum[hf] += bf16_lo(e);
              sum[hf] += bf16_hi(e);
            }
        });
        set_den();
        sweep(stage_q, [&](int j, const float* bt) {
          float acc[2][4], dp[2][4], p[2];
          tile16(acc, qa, Ks + 16 * j * LD, lane);
          tile16(dp, ga, Vs + 16 * j * LD, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              probs_pair<F32>(acc[n][2 * hf], acc[n][2 * hf + 1], bias_q(bt, n, hf),
                              diff_q(j, n, hf), in_t(16 * j + 8 * n + 2 * tq),
                              in_t(16 * j + 8 * n + 2 * tq + 1), scale, scale2,
                              make_float2(m[hf], m[hf]), make_float2(den[hf], den[hf]),
                              make_float2(rden[hf], rden[hf]), p[0], p[1]);
              D[hf] += p[0] * dp[n][2 * hf] + p[1] * dp[n][2 * hf + 1];
            }
        });
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) D[hf] = quad_sum(D[hf]);
      }
      if (tq == 0) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = hf ? rb : ra;
          const bool in = hf ? in_b : in_a;
          st_m[r] = in ? m[hf] : 0.f;
          st_den[r] = in ? den[hf] : 1.f;
          st_r[r] = in ? rden[hf] : 1.f;
          st_D[r] = in ? D[hf] : 0.f;
        }
      }
      __syncwarp();  // the final sweep reads the rows' statistics back (fewer registers)

      // o = rnd(pc V); dq = scale (ds K), ds = p (dp - D)
      float oacc[4][4] = {}, dq[4][4] = {};
      sweep(stage_q, [&](int j, const float* bt) {
        float p[2][4], ds[2][4];
        {
          float acc[2][4];
          uint32_t pa[4];
          tile16(acc, qa, Ks + 16 * j * LD, lane);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = hf ? rb : ra;
            const float mr = st_m[r], dr = st_den[r], rr = st_r[r];
#pragma unroll
            for (int n = 0; n < 2; ++n)
              pa[2 * n + hf] = probs_pair<F32>(
                  acc[n][2 * hf], acc[n][2 * hf + 1], bias_q(bt, n, hf), diff_q(j, n, hf),
                  in_t(16 * j + 8 * n + 2 * tq), in_t(16 * j + 8 * n + 2 * tq + 1), scale, scale2,
                  make_float2(mr, mr), make_float2(dr, dr), make_float2(rr, rr),
                  p[n][2 * hf], p[n][2 * hf + 1]);
          }
          mma_rows(oacc, pa, Vs + 16 * j * LD, lane);
        }
        tile16(ds, ga, Vs + 16 * j * LD, lane);
        const float Dr[2] = {st_D[ra], st_D[rb]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - Dr[e >> 1]);
        mma_split(dq, ds, Ks + 16 * j * LD, lane);
      });
      store_rows(o + (row0 + ra) * C + h * HD, o + (row0 + rb) * C + h * HD, oacc, in_a, in_b,
                 tq);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = __fmul_rn(dq[n][e], scale);
      store_rows(dqkv + (row0 + ra) * C3 + h * HD, dqkv + (row0 + rb) * C3 + h * HD, dq, in_a,
                 in_b, tq);
      add_colsums(cs, dq, in_a, in_b, lane);
    }
    __syncthreads();  // the statistics of every query row

    // ---- pass K: the warp's 16 keys against every query ----
    {
      const bool first = w == w_lo;
      const bf16* ka = Ks + r0 * LD;  // this warp's k and v rows
      const bf16* va = Vs + r0 * LD;
      // tile j: queries 16 j .. 16 j + 15 by this warp's keys, of the bias
      // and (after the group's first window) of the dbias partial so far
      auto stage_k = [&](int j, float* t) {
        const int nq = FULL ? 16 : Tn - 16 * j;
        stage_tile(t, RK_LD, bhead + 16 * j * Tn + r0, Tn, nq, nr, vec, lane);
        if (!first) stage_tile(t + RING_TILE, RK_LD, dbh + 16 * j * Tn + r0, Tn, nq, nr, vec, lane);
      };
      float dk[4][4] = {}, dv[4][4] = {};
      sweep(stage_k, [&](int j, const float* bt) {
        float p[2][4], ds[2][4];
        {
          float acc[2][4];
          uint32_t pa[4];
          tile16(acc, ka, Qs + 16 * j * LD, lane);  // S^T: rows keys, cols queries
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = 16 * j + 8 * n + 2 * tq;  // queries c, c + 1
            const float* bc = bt + (8 * n + 2 * tq) * RK_LD + g;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              pa[2 * n + hf] = probs_pair<F32>(
                  acc[n][2 * hf], acc[n][2 * hf + 1],
                  make_float2(bc[8 * hf], bc[RK_LD + 8 * hf]), band_diff(bands, c, rowb[hf], sel),
                  in_t(c), in_t(c + 1), scale, scale2, *reinterpret_cast<const float2*>(st_m + c),
                  *reinterpret_cast<const float2*>(st_den + c),
                  *reinterpret_cast<const float2*>(st_r + c), p[n][2 * hf], p[n][2 * hf + 1]);
          }
          mma_rows(dv, pa, Gs + 16 * j * LD, lane);
        }
        tile16(ds, va, Gs + 16 * j * LD, lane);  // dP^T = V do^T
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int c = 16 * j + 8 * n + 2 * tq;
          const float2 Dc = *reinterpret_cast<const float2*>(st_D + c);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int key = hf ? rb : ra;
            const bool kin = hf ? in_b : in_a;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float x = p[n][2 * hf + u] * (ds[n][2 * hf + u] - (u ? Dc.y : Dc.x));
              ds[n][2 * hf + u] = x;
              // dbias: this thread alone owns element (query c + u, key)
              // of the group's partial; the group's windows add in order
              if (kin && in_t(c + u))
                dbh[(c + u) * Tn + key] =
                    first ? x : bt[RING_TILE + (8 * n + 2 * tq + u) * RK_LD + g + 8 * hf] + x;
            }
          }
        }
        mma_split(dk, ds, Qs + 16 * j * LD, lane);
      });
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = __fmul_rn(dk[n][e], scale);
      store_rows(dqkv + (row0 + ra) * C3 + C + h * HD, dqkv + (row0 + rb) * C3 + C + h * HD, dk,
                 in_a, in_b, tq);
      store_rows(dqkv + (row0 + ra) * C3 + 2 * C + h * HD,
                 dqkv + (row0 + rb) * C3 + 2 * C + h * HD, dv, in_a, in_b, tq);
      add_colsums(cs + HD, dk, in_a, in_b, lane);
      add_colsums(cs + 2 * HD, dv, in_a, in_b, lane);
    }
  }

  // the group's dq, dk, dv column sums, the warps' partials in order
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * HD; e += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < NQ; ++k) acc += csum[k * 3 * HD + e];
    dbqkv_part[(long long)grp * C3 + (e / HD) * C + h * HD + e % HD] = acc;
  }
}

// part[z, n] = sum of rows [z * rows, (z + 1) * rows) of column n of X (R, N)
template <typename T>
__global__ void colsum_partial_kernel(const T* __restrict__ X, float* __restrict__ part, int R,
                                      int N, int rows) {
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r_lo = blockIdx.x * rows, r_hi = min(R, r_lo + rows);
  float s = 0.f;
  for (int r = r_lo; r < r_hi; ++r) s += to_f<T>(X[(long long)r * N + n]);
  part[(long long)blockIdx.x * N + n] = s;
}

template <int NQ, bool F32, bool FULL>
int launch_bf16_core(const bf16* qkv, const bf16* dout, const float* bias, bf16* o,
                         bf16* dqkv, float* dbias_part, float* dbqkv_part, int bnw, int t, int c,
                         int nh, int ws, int ss, int nwh, int nww, int n_groups,
                         cudaStream_t stream, int* info) {
  const auto kernel = attn_bwd_core_bf16_kernel<NQ, F32, FULL>;
  const size_t smem = bf16_bwd_smem_bytes(16 * NQ);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (info) {
    const int rc = kernel_info(kernel, 32 * NQ, smem, info);
    info[4] = info[3] * NQ;
    return rc;
  }
  const float scale = 1.f / sqrtf((float)BWD_HD);
  kernel<<<dim3(n_groups, nh), 32 * NQ, smem, stream>>>(qkv, dout, bias, o, dqkv, dbias_part,
                                                        dbqkv_part, bnw, t, c, nh, ws, ss, nwh,
                                                        nww, scale);
  return 0;
}

// the FULL kernel where T = 16 NQ is a square (T = 16, 64, 144), else the
// one that checks its bounds
template <int NQ, bool F32>
int launch_bwd_core_bf16(const bf16* qkv, const bf16* dout, const float* bias, bf16* o,
                         bf16* dqkv, float* dbias_part, float* dbqkv_part, int bnw, int t, int c,
                         int nh, int ws, int ss, int nwh, int nww, int n_groups,
                         cudaStream_t stream, int* info) {
  if constexpr (NQ == 1 || NQ == 4 || NQ == 9) {
    if (t == 16 * NQ)
      return launch_bf16_core<NQ, F32, true>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part,
                                             bnw, t, c, nh, ws, ss, nwh, nww, n_groups, stream,
                                             info);
  }
  return launch_bf16_core<NQ, F32, false>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part,
                                          bnw, t, c, nh, ws, ss, nwh, nww, n_groups, stream, info);
}

template <bool F32>
int bwd_core_bf16(const bf16* qkv, const bf16* dout, const float* bias, bf16* o, bf16* dqkv,
                  float* dbias_part, float* dbqkv_part, int bnw, int t, int c, int nh, int ws,
                  int ss, int nwh, int nww, int n_groups, cudaStream_t s, int* info) {
#define FLAIR_BWD_NQ(NQ)                                                                    \
  case NQ:                                                                                  \
    return launch_bwd_core_bf16<NQ, F32>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, \
                                         bnw, t, c, nh, ws, ss, nwh, nww, n_groups, s, info);
  switch ((t + 15) / 16) {
    FLAIR_BWD_NQ(1)
    FLAIR_BWD_NQ(2)
    FLAIR_BWD_NQ(3)
    FLAIR_BWD_NQ(4)
    FLAIR_BWD_NQ(5)
    FLAIR_BWD_NQ(6)
    FLAIR_BWD_NQ(7)
    FLAIR_BWD_NQ(8)
    FLAIR_BWD_NQ(9)
  }
#undef FLAIR_BWD_NQ
  return (int)cudaErrorInvalidValue;  // T > 144
}

// the core on qkv (bnw * t, 3c) and do (bnw * t, c) -> o, dqkv and the
// per-group dbias and dbqkv partials; with `info`, nothing launches and
// info[0..4] receive the core kernel's resources at t tokens
template <typename T>
int bwd_core(const T* qkv, const T* dout, const float* bias, T* o, T* dqkv, float* dbias_part,
             float* dbqkv_part, int bnw, int t, int c, int nh, int ws, int ss, int nwh, int nww,
             int attn_f32, int n_groups, cudaStream_t s, int* info = nullptr) {
  if constexpr (std::is_same<T, bf16>::value) {
    return attn_f32 ? bwd_core_bf16<true>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw,
                                          t, c, nh, ws, ss, nwh, nww, n_groups, s, info)
                    : bwd_core_bf16<false>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw,
                                           t, c, nh, ws, ss, nwh, nww, n_groups, s, info);
  } else {
    return bwd_core_f32(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw, t, c, nh, ws, ss,
                        nwh, nww, attn_f32, n_groups, s, info);
  }
}

template <typename T>
int window_attn_bwd_impl(const void* x, const void* g, const void* wqkv, const void* bqkv,
                         const void* wqkv_t, const void* wproj_t, const void* bias, void* qkv,
                         void* dout, void* o, void* dqkv, void* dbias_part, void* dbqkv_part,
                         void* wpart, void* dx, void* dwqkv, void* dbqkv, void* dwproj,
                         void* dbproj, void* dbias, int bnw, int t, int c, int nh, int ws, int ss,
                         int nwh, int nww, int attn_f32, int n_groups, int tile_qkv,
                         int tile_proj, int tile_w, int k_chunk_proj, int k_chunk_qkv,
                         cudaStream_t s) {
  const int m = bnw * t;
  const int n_split = (m + k_chunk_proj - 1) / k_chunk_proj;
  float* part = (float*)wpart;
  int rc = gemm_bias<T>(tile_qkv, (const T*)x, (const T*)wqkv, (const T*)bqkv, (T*)qkv, m, 3 * c,
                        c, s);
  if (!rc)
    rc = bwd_gemm_round<T>(tile_proj, (const T*)g, (const T*)wproj_t, (T*)dout, m, c, c, s);
  if (!rc)
    rc = bwd_core<T>((const T*)qkv, (const T*)dout, (const float*)bias, (T*)o, (T*)dqkv,
                     (float*)dbias_part, (float*)dbqkv_part, bnw, t, c, nh, ws, ss, nwh, nww,
                     attn_f32, n_groups, s);
  // weight gradients in the nn.Linear layout: dWproj = g^T o, dWqkv = dqkv^T x
  if (!rc)
    rc = bwd_gemm_wgrad<T>(tile_w, (const T*)g, (const T*)o, part, (float*)dwproj, c, c, m,
                           k_chunk_proj, s);
  if (!rc)
    rc = bwd_gemm_wgrad<T>(tile_w, (const T*)dqkv, (const T*)x, part, (float*)dwqkv, 3 * c, c, m,
                           k_chunk_qkv, s);
  if (!rc)
    rc = bwd_gemm_round<T>(tile_proj, (const T*)dqkv, (const T*)wqkv_t, (T*)dx, m, c, 3 * c, s);
  if (rc) return rc;
  colsum_partial_kernel<T><<<dim3(n_split, (c + 255) / 256), 256, 0, s>>>((const T*)g, part, m,
                                                                           c, k_chunk_proj);
  launch_sum_partials(part, (float*)dbproj, c, n_split, s);
  launch_sum_partials((const float*)dbqkv_part, (float*)dbqkv, 3ll * c, n_groups, s);
  launch_sum_partials((const float*)dbias_part, (float*)dbias, (long long)nh * t * t, n_groups,
                      s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

// wqkv_t (C, 3C) and wproj_t (C, C): the weights' transposed copies (do
// and dx); tile_qkv: K2's qkv tile (the recompute), tile_proj: K2's proj
// tile (do, dx), tile_w and k_chunk_*: the weight gradients' plan
extern "C" int window_attn_bwd(const void* x, const void* g, const void* wqkv, const void* bqkv,
                               const void* wqkv_t, const void* wproj_t, const void* bias,
                               void* qkv, void* dout, void* o, void* dqkv, void* dbias_part,
                               void* dbqkv_part, void* wpart, void* dx, void* dwqkv, void* dbqkv,
                               void* dwproj, void* dbproj, void* dbias, int bnw, int t, int c,
                               int nh, int ws, int ss, int nwh, int nww, int attn_f32,
                               int n_groups, int tile_qkv, int tile_proj, int tile_w,
                               int k_chunk_proj, int k_chunk_qkv, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return window_attn_bwd_impl<float>(x, g, wqkv, bqkv, wqkv_t, wproj_t, bias, qkv, dout, o,
                                       dqkv, dbias_part, dbqkv_part, wpart, dx, dwqkv, dbqkv,
                                       dwproj, dbproj, dbias, bnw, t, c, nh, ws, ss, nwh, nww,
                                       attn_f32, n_groups, tile_qkv, tile_proj, tile_w,
                                       k_chunk_proj, k_chunk_qkv, s);
  return window_attn_bwd_impl<bf16>(x, g, wqkv, bqkv, wqkv_t, wproj_t, bias, qkv, dout, o, dqkv,
                                    dbias_part, dbqkv_part, wpart, dx, dwqkv, dbqkv, dwproj,
                                    dbproj, dbias, bnw, t, c, nh, ws, ss, nwh, nww, attn_f32,
                                    n_groups, tile_qkv, tile_proj, tile_w, k_chunk_proj,
                                    k_chunk_qkv, s);
}

// the core alone: qkv (bnw * t, 3c), do (bnw * t, c) -> o, dqkv, and dbias
// (nh, t, t), dbqkv (3c) summed in a fixed order from the per-group partials
extern "C" int window_attn_bwd_core(const void* qkv, const void* dout, const void* bias, void* o,
                                    void* dqkv, void* dbias_part, void* dbqkv_part, void* dbias,
                                    void* dbqkv, int bnw, int t, int c, int nh, int ws, int ss,
                                    int nwh, int nww, int attn_f32, int n_groups, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      dtype == 0
          ? bwd_core<float>((const float*)qkv, (const float*)dout, (const float*)bias, (float*)o,
                            (float*)dqkv, (float*)dbias_part, (float*)dbqkv_part, bnw, t, c, nh,
                            ws, ss, nwh, nww, attn_f32, n_groups, s)
          : bwd_core<bf16>((const bf16*)qkv, (const bf16*)dout, (const float*)bias, (bf16*)o,
                           (bf16*)dqkv, (float*)dbias_part, (float*)dbqkv_part, bnw, t, c, nh, ws,
                           ss, nwh, nww, attn_f32, n_groups, s);
  if (rc) return rc;
  launch_sum_partials((const float*)dbqkv_part, (float*)dbqkv, 3ll * c, n_groups, s);
  launch_sum_partials((const float*)dbias_part, (float*)dbias, (long long)nh * t * t, n_groups,
                      s);
  return (int)cudaGetLastError();
}

// the core kernel's registers, local (spill) bytes a thread, shared bytes a
// block, resident blocks and resident warps per SM at t tokens
extern "C" int window_attn_bwd_core_info(int t, int attn_f32, int dtype, int* out) {
  return dtype == 0 ? bwd_core<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      0, t, 0, 0, 0, 0, 0, 0, attn_f32, 0, 0, out)
                    : bwd_core<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     0, t, 0, 0, 0, 0, 0, 0, attn_f32, 0, 0, out);
}
