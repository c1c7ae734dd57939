// K6's float32 attention-backward core (attn_bwd_core_f32_kernel): the
// middle launch of K6 (window_attn_bwd.cu, whose note covers K6 as a whole)
// on float32 tensors, in both attn_f32 modes, for every T from 4 to 144.
//
// Replaces the float32 case of flair_for_aigle_tpu/ops/pallas/
// window_attn.py _bwd_kernel_body (:466-515; plain version
// ops/window_attn.py window_attention_core_backward_reference): s = q k^T *
// scale + bias (+ the -100 shift mask); attn_f32 p = exp(min(s, 80) - 30) /
// (sum + 1e-37), else e = exp(s - max); o = p v, dv = p^T do, dp = do v^T,
// ds = p (dp - sum dp p), dq = scale ds k, dk = scale ds^T q, all float32;
// dbias sums ds over the windows, dbqkv the columns of dqkv.
//
// Bound on the card: per (window, head) at T = 144 the core reads 74 KB of
// float32 q, k, v and do, writes 74 KB of o, dq, dk and dv (32 C bytes a
// token) and does six T x T x 32 products, 8 MFLOP: 54 operations a byte,
// above float32's 20 (67 TFLOP/s, no tensor cores) and about at 3xTF32's 49
// (a third of the tf32 tensor cores' 495 TFLOP/s), so bound by its
// operations as long as the (T, T) tiles never reach device memory.
//
// Design: the bf16 core's skeleton (window_attn_bwd.cu) with every product
// float32-accurate on the tensor cores as 3xTF32: each operand split into
// tf32 halves a = hi + lo, and lo*hi + hi*lo + hi*hi, small terms first, on
// mma.sync.m16n8k8 into one float32 accumulator (2^-21 of each product's
// magnitude; TF32 alone keeps 2^-11, not the reference's float32).
//   - One block per (window group, head), one warp per 16 rows (T padded
//     to TP = 16 ceil(T / 16)); two passes per window, every (T, T) tile
//     recomputed in registers and never stored: pass Q (the warp's query
//     rows against every key) takes the row statistics, then o, D and dq;
//     pass K (the warp's keys against every query) takes dk, dv and dbias.
//     The bias (and in pass K the dbias partial) reaches each warp as
//     16 x 16 float32 tiles staged by cp.async one tile ahead in a
//     two-stage ring of its own; the thread that holds ds(i, j) in pass K
//     alone adds it to dbias(i, j) of its (group, head) in device memory,
//     in window order, so two calls give the same bits (no atomics).
//   - q, k, v and do stay float32 in shared memory, rows padded to 36
//     floats (83 KB at T = 144): lane (g, t) of an A or B fragment then
//     reads bank (4 g + t) mod 32, and of a B fragment over the row pair
//     (2 t, 2 t + 1) bank (8 t + g) or (8 t + g + 4) mod 32, no conflicts.
//     Operands are split as they are loaded into fragments: split copies
//     would double the 83 KB. The warp's own 16 rows (q and do in pass Q,
//     k and v in pass K) are split once a pass and held as A fragments.
//   - P and dS leave the score accumulators as A fragments of the next
//     products without a shuffle: a product sums over k, so a thread's
//     accumulator columns 2t, 2t + 1 stand in for k = t, t + 4, and the B
//     fragment reads rows 2t, 2t + 1 of v, k, do or q to match.
//   - Pass K's scores K Q^T take the three terms in mirrored order (hi*lo
//     before lo*hi), so each score is the same sum of the same products as
//     pass Q's Q K^T, and both passes take every p through one function
//     (prob_f32) from the row statistics pass Q left in shared memory.
//   - attn_f32 = 0 in float32 has no clamp or static shift: pass Q takes
//     the row max in a sweep of its own, then den and D in one more.
// 144 KB of shared memory a block at T = 144 (rows and rings): one block of
// 9 warps per SM, with the registers that frees (up to 224 a thread)
// holding the split strips. The launch sizes its window groups by that
// residency (ops/window_attn.py _core_groups).
#include <cmath>

#include "common.cuh"
#include "core_util.cuh"
#include "window_attn_bwd.cuh"

namespace flair {

// shared bytes of the float32 core at tp padded tokens: q, k, v, do rows;
// the warps' rings; per query row its max, denominator, reciprocal and D;
// per warp the dq, dk, dv column sums; per token its band byte
inline size_t f32_bwd_smem_bytes(int tp) {
  return 4ull * tp * F_LD * sizeof(float) + (size_t)(tp / 16) * RING_WARP * sizeof(float) +
         4ull * tp * sizeof(float) + (size_t)(tp / 16) * 3 * BWD_HD * sizeof(float) + tp;
}

namespace {

// acc[n] = the strip a times rows 8 n .. 8 n + 7 of b_rows over the head
// dims (one 16 x 16 tile); MIRROR: the transposed product's term order
template <bool MIRROR>
__device__ __forceinline__ void tile16_f32(float (&acc)[2][4], const TF32A (&a)[4],
                                           const float* b_rows, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      TF32B b;
      ld_b_tf32(b, b_rows + 8 * n * F_LD + 8 * kk, F_LD, lane);
      mma_3xtf32<MIRROR>(acc[n], a[kk], b);
    }
  }
}

// acc[m] += x times the 16 rows of `rows` (head dims 8 m .. 8 m + 7): x, a
// 16 x 16 tile held as two accumulator tiles, enters as A fragments in the
// k order it lies in (acc_a_tf32)
__device__ __forceinline__ void mma_rows_f32(float (&acc)[4][4], const float (&x)[2][4],
                                             const float* rows, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    TF32A a;
    acc_a_tf32(a, x[n]);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      TF32B b;
      ld_b_pairs_tf32(b, rows + 8 * n * F_LD + 8 * m, F_LD, lane);
      mma_3xtf32<false>(acc[m], a, b);
    }
  }
}

// p = e / den of one element (m, den, rden = 1 / den: its query row's
// statistics). Both passes take every p through this function, so a score
// that leaves the tensor cores the same in both gives the same p.
template <bool F32>
__device__ __forceinline__ float prob_f32(float acc, float b, bool differ, bool in, float scale,
                                          float m, float den, float rden) {
  return div_r(e_of<F32>(acc, b, differ, in, scale, m), den, rden);
}

// a 16 x 32 float32 tile (rows r, r + 8 at dst_g, dst_g8) stored; rows past
// Tn not
__device__ __forceinline__ void store_rows_f32(float* dst_g, float* dst_g8,
                                               const float (&acc)[4][4], bool in0, bool in1,
                                               int tq) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (in0)
      *reinterpret_cast<float2*>(dst_g + 8 * n + 2 * tq) = make_float2(acc[n][0], acc[n][1]);
    if (in1)
      *reinterpret_cast<float2*>(dst_g8 + 8 * n + 2 * tq) = make_float2(acc[n][2], acc[n][3]);
  }
}

}  // namespace

// FULL: T = TP, no padded row or column (T = 144, 64, 16), every bound
// check folded away at compile time
template <int NQ, bool F32, bool FULL>
__global__ void __launch_bounds__(32 * NQ, 1)
    attn_bwd_core_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                             const float* __restrict__ bias, float* __restrict__ o,
                             float* __restrict__ dqkv, float* __restrict__ dbias_part,
                             float* __restrict__ dbqkv_part, int bnw, int t, int C, int nh,
                             int ws, int ss, int nwh, int nww, float scale) {
  constexpr int TP = 16 * NQ, LD = F_LD, HD = BWD_HD;
  const int Tn = FULL ? TP : t;
  auto in_t = [&](int x) { return FULL || x < Tn; };  // token x lies before T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + TP * LD;
  float* Vs = Ks + TP * LD;
  float* Gs = Vs + TP * LD;              // do
  float* rings = Gs + TP * LD;           // per warp: RING_WARP floats
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
  float* cs = csum + wid * 3 * HD;
  float* ring = rings + wid * RING_WARP;

  for (int e = threadIdx.x; e < NQ * 3 * HD; e += blockDim.x) csum[e] = 0.f;
  const int lim = ws - ss;  // band 1 below it, band 2 from it
  for (int x = threadIdx.x; x < TP; x += blockDim.x)
    bands[x] = (uint8_t)((x >= lim * ws) | (x % ws >= lim) << 1);
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
  auto stage_q = [&](int j, float* tl) {
    stage_tile(tl, RQ_LD, bhead + r0 * Tn + 16 * j, Tn, nr, FULL ? 16 : Tn - 16 * j, vec, lane);
  };

  for (int w = w_lo; w < w_hi; ++w) {
    const long long row0 = (long long)w * Tn;
    __syncthreads();  // the previous window is done with the rows and statistics
    // q, k, v and do rows of this (window, head): eight 16-byte chunks
    // each, rows past Tn zero
    for (int e = threadIdx.x; e < 32 * TP; e += blockDim.x) {
      const int part = e / (8 * TP), x = (e >> 3) % TP, ch = e & 7;
      float* dst = Qs + part * TP * LD + x * LD + ch * 4;
      if (in_t(x))
        cp_async16(dst, part < 3 ? qkv + (row0 + x) * C3 + part * C + h * HD + ch * 4
                                 : dout + (row0 + x) * C + h * HD + ch * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
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
      TF32A fq[4], fg[4];  // this warp's q and do rows, split
      load_strip(fq, Qs + r0 * LD, lane);
      load_strip(fg, Gs + r0 * LD, lane);
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
      if constexpr (!F32) {
        float mx[2] = {-INFINITY, -INFINITY};
        sweep(stage_q, [&](int j, const float* bt) {
          float acc[2][4];
          tile16_f32<false>(acc, fq, Ks + 16 * j * LD, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int c = 16 * j + 8 * n + 2 * tq;
              const float2 b = bias_q(bt, n, hf);
              const uint32_t d = diff_q(j, n, hf);
              if (in_t(c)) mx[hf] = fmaxf(mx[hf], s_f32(acc[n][2 * hf], b.x, d & 0xffu, scale));
              if (in_t(c + 1))
                mx[hf] = fmaxf(mx[hf], s_f32(acc[n][2 * hf + 1], b.y, d >> 8, scale));
            }
        });
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float x = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
          m[hf] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        }
      }
      // one sweep: den = sum e + 1e-37 and D = (sum e dp) / den, the
      // float32 sum of p dp with the division by den taken out
      sweep(stage_q, [&](int j, const float* bt) {
        float acc[2][4], dp[2][4];
        tile16_f32<false>(acc, fq, Ks + 16 * j * LD, lane);
        tile16_f32<false>(dp, fg, Vs + 16 * j * LD, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c = 16 * j + 8 * n + 2 * tq;
            const float2 b = bias_q(bt, n, hf);
            const uint32_t d = diff_q(j, n, hf);
            const float e0 = e_of<F32>(acc[n][2 * hf], b.x, d & 0xffu, in_t(c), scale, m[hf]);
            const float e1 =
                e_of<F32>(acc[n][2 * hf + 1], b.y, d >> 8, in_t(c + 1), scale, m[hf]);
            sum[hf] += e0 + e1;
            D[hf] += e0 * dp[n][2 * hf] + e1 * dp[n][2 * hf + 1];
          }
      });
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        den[hf] = quad_sum(sum[hf]) + 1e-37f;
        rden[hf] = __frcp_rn(den[hf]);
        D[hf] = div_r(quad_sum(D[hf]), den[hf], rden[hf]);
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

      // o = P V; dq = scale (dS K), dS = P (dP - D)
      float oacc[4][4] = {}, dq[4][4] = {};
      sweep(stage_q, [&](int j, const float* bt) {
        float p[2][4], ds[2][4];
        {
          float acc[2][4];
          tile16_f32<false>(acc, fq, Ks + 16 * j * LD, lane);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = hf ? rb : ra;
            const float mr = st_m[r], dr = st_den[r], rr = st_r[r];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int c = 16 * j + 8 * n + 2 * tq;
              const float2 b = bias_q(bt, n, hf);
              const uint32_t d = diff_q(j, n, hf);
              p[n][2 * hf] =
                  prob_f32<F32>(acc[n][2 * hf], b.x, d & 0xffu, in_t(c), scale, mr, dr, rr);
              p[n][2 * hf + 1] =
                  prob_f32<F32>(acc[n][2 * hf + 1], b.y, d >> 8, in_t(c + 1), scale, mr, dr, rr);
            }
          }
        }
        mma_rows_f32(oacc, p, Vs + 16 * j * LD, lane);
        tile16_f32<false>(ds, fg, Vs + 16 * j * LD, lane);  // dP = dO V^T
        const float Dr[2] = {st_D[ra], st_D[rb]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - Dr[e >> 1]);
        mma_rows_f32(dq, ds, Ks + 16 * j * LD, lane);
      });
      store_rows_f32(o + (row0 + ra) * C + h * HD, o + (row0 + rb) * C + h * HD, oacc, in_a,
                     in_b, tq);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = __fmul_rn(dq[n][e], scale);
      store_rows_f32(dqkv + (row0 + ra) * C3 + h * HD, dqkv + (row0 + rb) * C3 + h * HD, dq,
                     in_a, in_b, tq);
      add_colsums(cs, dq, in_a, in_b, lane);
    }
    __syncthreads();  // the statistics of every query row

    // ---- pass K: the warp's 16 keys against every query ----
    {
      const bool first = w == w_lo;
      TF32A fk[4], fv[4];  // this warp's k and v rows, split
      load_strip(fk, Ks + r0 * LD, lane);
      load_strip(fv, Vs + r0 * LD, lane);
      // tile j: queries 16 j .. 16 j + 15 by this warp's keys, of the bias
      // and (after the group's first window) of the dbias partial so far
      auto stage_k = [&](int j, float* tl) {
        const int nq = FULL ? 16 : Tn - 16 * j;
        stage_tile(tl, RK_LD, bhead + 16 * j * Tn + r0, Tn, nq, nr, vec, lane);
        if (!first)
          stage_tile(tl + RING_TILE, RK_LD, dbh + 16 * j * Tn + r0, Tn, nq, nr, vec, lane);
      };
      float dk[4][4] = {}, dv[4][4] = {};
      sweep(stage_k, [&](int j, const float* bt) {
        float p[2][4], ds[2][4];
        {
          float acc[2][4];
          tile16_f32<true>(acc, fk, Qs + 16 * j * LD, lane);  // S^T: rows keys, cols queries
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = 16 * j + 8 * n + 2 * tq;  // queries c, c + 1
            const float* bc = bt + (8 * n + 2 * tq) * RK_LD + g;
            const float2 mc = *reinterpret_cast<const float2*>(st_m + c);
            const float2 dc = *reinterpret_cast<const float2*>(st_den + c);
            const float2 rc = *reinterpret_cast<const float2*>(st_r + c);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const uint32_t d = band_diff(bands, c, rowb[hf], sel);
              p[n][2 * hf] = prob_f32<F32>(acc[n][2 * hf], bc[8 * hf], d & 0xffu, in_t(c),
                                           scale, mc.x, dc.x, rc.x);
              p[n][2 * hf + 1] = prob_f32<F32>(acc[n][2 * hf + 1], bc[RK_LD + 8 * hf], d >> 8,
                                               in_t(c + 1), scale, mc.y, dc.y, rc.y);
            }
          }
        }
        mma_rows_f32(dv, p, Gs + 16 * j * LD, lane);
        tile16_f32<true>(ds, fv, Gs + 16 * j * LD, lane);  // dP^T = V dO^T
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
        mma_rows_f32(dk, ds, Qs + 16 * j * LD, lane);
      });
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = __fmul_rn(dk[n][e], scale);
      store_rows_f32(dqkv + (row0 + ra) * C3 + C + h * HD, dqkv + (row0 + rb) * C3 + C + h * HD,
                     dk, in_a, in_b, tq);
      store_rows_f32(dqkv + (row0 + ra) * C3 + 2 * C + h * HD,
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

template <int NQ, bool F32, bool FULL>
int launch_f32_core(const float* qkv, const float* dout, const float* bias, float* o, float* dqkv,
                    float* dbias_part, float* dbqkv_part, int bnw, int t, int c, int nh, int ws,
                    int ss, int nwh, int nww, int n_groups, cudaStream_t stream, int* info) {
  const auto kernel = attn_bwd_core_f32_kernel<NQ, F32, FULL>;
  const size_t smem = f32_bwd_smem_bytes(16 * NQ);
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
int launch_bwd_core_f32(const float* qkv, const float* dout, const float* bias, float* o,
                        float* dqkv, float* dbias_part, float* dbqkv_part, int bnw, int t, int c,
                        int nh, int ws, int ss, int nwh, int nww, int n_groups,
                        cudaStream_t stream, int* info) {
  if constexpr (NQ == 1 || NQ == 4 || NQ == 9) {
    if (t == 16 * NQ)
      return launch_f32_core<NQ, F32, true>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw,
                                            t, c, nh, ws, ss, nwh, nww, n_groups, stream, info);
  }
  return launch_f32_core<NQ, F32, false>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw,
                                         t, c, nh, ws, ss, nwh, nww, n_groups, stream, info);
}

template <bool F32>
int bwd_core_f32_mode(const float* qkv, const float* dout, const float* bias, float* o,
                      float* dqkv, float* dbias_part, float* dbqkv_part, int bnw, int t, int c,
                      int nh, int ws, int ss, int nwh, int nww, int n_groups, cudaStream_t s,
                      int* info) {
#define FLAIR_BWD_NQ(NQ)                                                                   \
  case NQ:                                                                                 \
    return launch_bwd_core_f32<NQ, F32>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, \
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

int bwd_core_f32(const float* qkv, const float* dout, const float* bias, float* o, float* dqkv,
                 float* dbias_part, float* dbqkv_part, int bnw, int t, int c, int nh, int ws,
                 int ss, int nwh, int nww, int attn_f32, int n_groups, cudaStream_t s, int* info) {
  return attn_f32 ? bwd_core_f32_mode<true>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw,
                                            t, c, nh, ws, ss, nwh, nww, n_groups, s, info)
                  : bwd_core_f32_mode<false>(qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part,
                                             bnw, t, c, nh, ws, ss, nwh, nww, n_groups, s, info);
}

}  // namespace flair
