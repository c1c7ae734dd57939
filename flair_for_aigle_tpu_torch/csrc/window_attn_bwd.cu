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
//   1. qkv = rnd(rnd(x Wqkv^T) + bqkv)          (gemm.cuh, A @ W^T)
//   2. do  = rnd(g Wproj)                       (gemm.cuh, A @ B)
//   3. core, one block per (window group, head): recompute s and p per
//      16-row strip, then o = pc v, dp = do v^T, ds = p (dp - sum(dp p)),
//      dq = scale ds k; dk = scale ds^T q and dv = pc^T do accumulate in
//      registers over the strips; ds accumulates into a (T, T) float32
//      dbias tile in shared memory over the group's windows, and the f32
//      column sums of dq, dk, dv into the group's dbqkv partial. Writes o
//      and dqkv (compute dtype), one dbias partial per (group, head) and
//      one dbqkv partial per group.
//   4. dWproj = g^T o and dWqkv = dqkv^T x      (gemm.cuh, A^T @ B, split-K
//      over the B*nW*T rows into float32 partials)
//   5. dx = rnd(dqkv Wqkv)                      (gemm.cuh, A @ B)
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
// T x T x 32 products per (window, head), kept on chip: the (B*nW, nh, T, T)
// scores, probabilities and ds never reach device memory. The core runs
// SIMT float32 FMAs (ds must stay float32 for dq and dk, as the reference's
// float32 products); q, k, v and do of the (window, head) sit in shared
// memory as float32, with the 16-row score and ds strips and the dbias tile:
// 180 KB at T = 144, one block per SM. The qkv, do, o and dqkv tensors
// round-trip device memory between the launches, and the weight-gradient
// GEMMs are SIMT in float32 (perf_opt work: ROADMAP).
#include "common.cuh"
#include "gemm.cuh"

namespace flair {

constexpr int BWD_HD = 32;       // head dim
constexpr int BWD_HDP = 33;      // padded row of q, k, v, do in shared memory
constexpr int BWD_THREADS = 256;
constexpr int BWD_MAXR = 18;     // (TP * 32) / 256 at TP = 144

__host__ __device__ inline size_t bwd_smem_bytes(int t) {
  const int tp = (t + 15) / 16 * 16;
  return (size_t)(4 * tp * BWD_HDP + 2 * 16 * tp + t * t + 3 * BWD_THREADS) * sizeof(float);
}

__device__ __forceinline__ int bwd_band(int x, int ws, int ss) { return x < ws - ss ? 1 : 2; }

template <typename T, bool F32>
__global__ void __launch_bounds__(BWD_THREADS)
attn_bwd_core_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const float* __restrict__ bias, T* __restrict__ o, T* __restrict__ dqkv,
                     float* __restrict__ dbias_part, float* __restrict__ dbqkv_part, int bnw,
                     int Tn, int C, int nh, int ws, int ss, int nwh, int nww, float scale) {
  constexpr int HD = BWD_HD, HDP = BWD_HDP;
  const int TP = (Tn + 15) / 16 * 16;
  const int grp = blockIdx.x, h = blockIdx.y, n_groups = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nr = TP / 8;  // register entries of dk / dv per thread

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + TP * HDP;
  float* Vs = Ks + TP * HDP;
  float* Ds = Vs + TP * HDP;      // do of this head
  float* Ps = Ds + TP * HDP;      // 16 x TP: scores, then p (float32)
  float* Gs = Ps + 16 * TP;       // 16 x TP: dp, then ds
  float* Bacc = Gs + 16 * TP;     // Tn x Tn: sum of ds over the group's windows
  float* Csum = Bacc + Tn * Tn;   // 3 x 256: per-thread column sums, reduced at the end

  for (int e = tid; e < Tn * Tn; e += BWD_THREADS) Bacc[e] = 0.f;
  float colq = 0.f, colk = 0.f, colv = 0.f;  // column `lane` of dq, dk, dv

  const int wpb = (bnw + n_groups - 1) / n_groups;
  const int w_lo = grp * wpb, w_hi = min(bnw, w_lo + wpb);
  const int C3 = 3 * C;
  const float scale_t = rnd<T>(scale);
  for (int w = w_lo; w < w_hi; ++w) {
    const long long row0 = (long long)w * Tn;
    __syncthreads();  // the previous window is done with Qs .. Ds
    for (int e = tid; e < TP * HD; e += BWD_THREADS) {
      const int t = e / HD, d = e % HD;
      float q = 0.f, k = 0.f, v = 0.f, g = 0.f;
      if (t < Tn) {
        const T* src = qkv + (row0 + t) * C3 + h * HD + d;
        q = to_f<T>(src[0]);
        k = to_f<T>(src[C]);
        v = to_f<T>(src[2 * C]);
        g = to_f<T>(dout[(row0 + t) * C + h * HD + d]);
      }
      Qs[t * HDP + d] = q;
      Ks[t * HDP + d] = k;
      Vs[t * HDP + d] = v;
      Ds[t * HDP + d] = g;
    }
    float acc_dk[BWD_MAXR], acc_dv[BWD_MAXR];
#pragma unroll
    for (int u = 0; u < BWD_MAXR; ++u) acc_dk[u] = acc_dv[u] = 0.f;
    const int widx = w % (nwh * nww);
    const bool li = ss > 0 && widx / nww == nwh - 1;
    const bool lj = ss > 0 && widx % nww == nww - 1;
    __syncthreads();

    for (int r0 = 0; r0 < TP; r0 += 16) {
      // (a) raw scores q k^T of the strip, and dp = do v^T
      for (int e = tid; e < 16 * TP; e += BWD_THREADS) {
        const int r = e / TP, j = e % TP;
        const float* qr = Qs + (r0 + r) * HDP;
        const float* dr = Ds + (r0 + r) * HDP;
        const float* kr = Ks + j * HDP;
        const float* vr = Vs + j * HDP;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(dr[d], vr[d], dp);
        }
        Ps[r * TP + j] = s;
        Gs[r * TP + j] = dp;
      }
      __syncthreads();
      // (b) softmax and ds per row, one warp per row
      for (int r = wid; r < 16; r += BWD_THREADS / 32) {
        const int i = r0 + r;
        float* prow = Ps + r * TP;
        float* grow = Gs + r * TP;
        if (i >= Tn) {
          for (int j = lane; j < TP; j += 32) prow[j] = grow[j] = 0.f;
          continue;
        }
        const int bri = bwd_band(i / ws, ws, ss), bci = bwd_band(i % ws, ws, ss);
        const float* brow = bias + ((long long)h * Tn + i) * Tn;
        constexpr int MAXQ = 5;  // ceil(144 / 32)
        float sv[MAXQ];
        float mx = -INFINITY;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int j = lane + 32 * q;
          sv[q] = -INFINITY;
          if (j < Tn) {
            float s = prow[j];
            const bool differ = (li && bri != bwd_band(j / ws, ws, ss)) ||
                                (lj && bci != bwd_band(j % ws, ws, ss));
            if constexpr (F32) {
              s = s * scale + brow[j];
              if (differ) s += -100.f;
            } else {
              s = rnd<T>(rnd<T>(s) * scale_t);
              s = rnd<T>(s + rnd<T>(brow[j]));
              if (differ) s = rnd<T>(s + -100.f);
            }
            sv[q] = s;
            mx = fmaxf(mx, s);
          }
        }
        if constexpr (!F32) mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int j = lane + 32 * q;
          if (j < Tn) {
            sv[q] = F32 ? expf(fminf(sv[q], 80.f) - 30.f) : rnd<T>(expf(rnd<T>(sv[q] - mx)));
            sum += sv[q];
          }
        }
        sum = warp_sum(sum);
        const float den = F32 ? sum + 1e-37f : rnd<T>(rnd<T>(sum) + 1e-37f);
        float pv[MAXQ];
        float pdp = 0.f;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int j = lane + 32 * q;
          pv[q] = 0.f;
          if (j < Tn) {
            pv[q] = F32 ? sv[q] / den : rnd<T>(sv[q] / den);
            pdp = fmaf(grow[j], pv[q], pdp);
          }
        }
        pdp = warp_sum(pdp);
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const int j = lane + 32 * q;
          if (j < Tn) {
            const float ds = pv[q] * (grow[j] - pdp);
            prow[j] = pv[q];
            grow[j] = ds;
            Bacc[i * Tn + j] += ds;
          } else if (j < TP) {
            prow[j] = grow[j] = 0.f;
          }
        }
      }
      __syncthreads();
      // (c) o = pc v and dq = scale ds k for the strip; thread column d = lane
      for (int e = tid; e < 16 * HD; e += BWD_THREADS) {
        const int r = e / HD, d = e % HD, i = r0 + r;
        if (i >= Tn) continue;
        const float* prow = Ps + r * TP;
        const float* grow = Gs + r * TP;
        float ov = 0.f, dq = 0.f;
        for (int j = 0; j < Tn; ++j) {
          ov = fmaf(rnd<T>(prow[j]), Vs[j * HDP + d], ov);
          dq = fmaf(grow[j], Ks[j * HDP + d], dq);
        }
        dq *= scale;
        o[(row0 + i) * C + h * HD + d] = from_f<T>(ov);
        dqkv[(row0 + i) * C3 + h * HD + d] = from_f<T>(dq);
        colq += dq;
      }
      // (d) dk += ds^T q and dv += pc^T do over the strip's rows
#pragma unroll
      for (int u = 0; u < BWD_MAXR; ++u) {
        if (u >= nr) break;
        const int j = (tid + BWD_THREADS * u) / HD;  // d = lane
        float sk = 0.f, sv2 = 0.f;
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
          sk = fmaf(Gs[r * TP + j], Qs[(r0 + r) * HDP + lane], sk);
          sv2 = fmaf(rnd<T>(Ps[r * TP + j]), Ds[(r0 + r) * HDP + lane], sv2);
        }
        acc_dk[u] += sk;
        acc_dv[u] += sv2;
      }
      __syncthreads();
    }
    // dk, dv of this window: rows j < Tn (rows past Tn are zero)
#pragma unroll
    for (int u = 0; u < BWD_MAXR; ++u) {
      if (u >= nr) break;
      const int j = (tid + BWD_THREADS * u) / HD;
      if (j >= Tn) continue;
      const float dk = acc_dk[u] * scale;
      const long long base = (row0 + j) * C3 + h * HD + lane;
      dqkv[base + C] = from_f<T>(dk);
      dqkv[base + 2 * C] = from_f<T>(acc_dv[u]);
      colk += dk;
      colv += acc_dv[u];
    }
  }

  // this (group, head)'s partials: the dbias tile and the dq/dk/dv column sums
  __syncthreads();
  float* dst = dbias_part + ((long long)grp * nh + h) * Tn * Tn;
  for (int e = tid; e < Tn * Tn; e += BWD_THREADS) dst[e] = Bacc[e];
  Csum[tid] = colq;
  Csum[BWD_THREADS + tid] = colk;
  Csum[2 * BWD_THREADS + tid] = colv;
  __syncthreads();
  if (tid < 3 * HD) {
    const int s = tid / HD, d = tid % HD;
    float acc = 0.f;
    for (int k = 0; k < BWD_THREADS / 32; ++k) acc += Csum[s * BWD_THREADS + k * 32 + d];
    dbqkv_part[(long long)grp * C3 + s * C + h * HD + d] = acc;
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

template <typename T, bool F32>
void launch_bwd_core(const T* qkv, const T* dout, const float* bias, T* o, T* dqkv,
                     float* dbias_part, float* dbqkv_part, int bnw, int t, int c, int nh, int ws,
                     int ss, int nwh, int nww, int n_groups, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(t);
  cudaFuncSetAttribute(attn_bwd_core_kernel<T, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const float scale = 1.f / sqrtf((float)BWD_HD);
  attn_bwd_core_kernel<T, F32><<<dim3(n_groups, nh), BWD_THREADS, smem, stream>>>(
      qkv, dout, bias, o, dqkv, dbias_part, dbqkv_part, bnw, t, c, nh, ws, ss, nwh, nww, scale);
}

template <typename T>
int window_attn_bwd_impl(const void* x, const void* g, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bias, void* qkv, void* dout, void* o,
                         void* dqkv, void* dbias_part, void* dbqkv_part, void* wpart, void* dx,
                         void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dbias,
                         int bnw, int t, int c, int nh, int ws, int ss, int nwh, int nww,
                         int attn_f32, int n_groups, int k_chunk, cudaStream_t s) {
  const int m = bnw * t;
  const int n_split = (m + k_chunk - 1) / k_chunk;
  float* part = (float*)wpart;
  launch_gemm<T, EPI_BIAS>((const T*)x, (const T*)wqkv, qkv, m, 3 * c, c, (const T*)bqkv,
                           nullptr, nullptr, s);
  launch_gemm<T, EPI_NONE, false, true>((const T*)g, (const T*)wproj, dout, m, c, c, nullptr,
                                        nullptr, nullptr, s);
  if (attn_f32) {
    launch_bwd_core<T, true>((const T*)qkv, (const T*)dout, (const float*)bias, (T*)o, (T*)dqkv,
                             (float*)dbias_part, (float*)dbqkv_part, bnw, t, c, nh, ws, ss, nwh,
                             nww, n_groups, s);
  } else {
    launch_bwd_core<T, false>((const T*)qkv, (const T*)dout, (const float*)bias, (T*)o, (T*)dqkv,
                              (float*)dbias_part, (float*)dbqkv_part, bnw, t, c, nh, ws, ss, nwh,
                              nww, n_groups, s);
  }
  // weight gradients in the nn.Linear layout: dWproj = g^T o, dWqkv = dqkv^T x
  launch_gemm<T, EPI_F32, true, true>((const T*)g, (const T*)o, part, c, c, m, nullptr, nullptr,
                                      nullptr, s, k_chunk);
  launch_sum_partials(part, (float*)dwproj, (long long)c * c, n_split, s);
  launch_gemm<T, EPI_F32, true, true>((const T*)dqkv, (const T*)x, part, 3 * c, c, m, nullptr,
                                      nullptr, nullptr, s, k_chunk);
  launch_sum_partials(part, (float*)dwqkv, 3ll * c * c, n_split, s);
  launch_gemm<T, EPI_NONE, false, true>((const T*)dqkv, (const T*)wqkv, dx, m, c, 3 * c, nullptr,
                                        nullptr, nullptr, s);
  colsum_partial_kernel<T><<<dim3(n_split, (c + 255) / 256), 256, 0, s>>>((const T*)g, part, m,
                                                                           c, k_chunk);
  launch_sum_partials(part, (float*)dbproj, c, n_split, s);
  launch_sum_partials((const float*)dbqkv_part, (float*)dbqkv, 3ll * c, n_groups, s);
  launch_sum_partials((const float*)dbias_part, (float*)dbias, (long long)nh * t * t, n_groups,
                      s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

extern "C" int window_attn_bwd(const void* x, const void* g, const void* wqkv, const void* bqkv,
                               const void* wproj, const void* bias, void* qkv, void* dout,
                               void* o, void* dqkv, void* dbias_part, void* dbqkv_part,
                               void* wpart, void* dx, void* dwqkv, void* dbqkv, void* dwproj,
                               void* dbproj, void* dbias, int bnw, int t, int c, int nh, int ws,
                               int ss, int nwh, int nww, int attn_f32, int n_groups, int k_chunk,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return window_attn_bwd_impl<float>(x, g, wqkv, bqkv, wproj, bias, qkv, dout, o, dqkv,
                                       dbias_part, dbqkv_part, wpart, dx, dwqkv, dbqkv, dwproj,
                                       dbproj, dbias, bnw, t, c, nh, ws, ss, nwh, nww, attn_f32,
                                       n_groups, k_chunk, s);
  return window_attn_bwd_impl<bf16>(x, g, wqkv, bqkv, wproj, bias, qkv, dout, o, dqkv,
                                    dbias_part, dbqkv_part, wpart, dx, dwqkv, dbqkv, dwproj,
                                    dbproj, dbias, bnw, t, c, nh, ws, ss, nwh, nww, attn_f32,
                                    n_groups, k_chunk, s);
}
