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
// Bound on the card: at swin-base@512 batch 16 the two projections are
// ~2/3 of the flops (tensor-core GEMMs, gemm.cuh) and the attention core is
// T=144, head dim 32: 2.7 MFLOP per (window, head) over 27 KB of q/k/v —
// compute-bound on the tensor cores if the scores stay on chip. Design: one
// block per (window, head), one warp per 16 query rows; the warp's 16 x T
// score strip, its probabilities and its 16 x 32 output live in shared
// memory, so the (T, T) scores never reach device memory. bf16 runs the two
// products on wmma (m16n16k16, float32 accumulate); float32 runs SIMT FMAs.
// The (B*nW, T, 3C) qkv tensor and the pre-projection output round-trip
// device memory between the three launches (kept in VMEM by the TPU kernel;
// re-fusing them is later work).
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "gemm.cuh"

namespace flair {

constexpr int ATTN_HD = 32;  // swin v1 head dim (embed_dim / heads) at every size

template <typename T>
__host__ __device__ constexpr int attn_hdp() { return sizeof(T) == 2 ? ATTN_HD : ATTN_HD + 1; }

template <typename T>
__host__ __device__ inline size_t attn_smem_bytes(int tp) {
  const size_t qkv = 3ull * tp * attn_hdp<T>() * sizeof(T);
  const size_t s = (size_t)tp * tp * sizeof(float);
  const size_t p = sizeof(T) == 2 ? (size_t)tp * tp * sizeof(T) : 0;   // f32: in place
  const size_t o = sizeof(T) == 2 ? (size_t)tp * ATTN_HD * sizeof(float) : 0;
  return qkv + s + p + o + (size_t)tp * sizeof(float);
}

__device__ __forceinline__ int band(int x, int ws, int ss) { return x < ws - ss ? 1 : 2; }

template <typename T, bool F32>
__global__ void attn_core_kernel(const T* __restrict__ qkv, const void* __restrict__ bias_v,
                                 T* __restrict__ o, int Tn, int C, int ws, int ss, int nwh,
                                 int nww, float scale) {
  using BiasT = typename std::conditional<F32, float, T>::type;
  constexpr int HD = ATTN_HD;
  constexpr int HDP = attn_hdp<T>();
  constexpr bool TC = sizeof(T) == 2;
  const BiasT* bias = reinterpret_cast<const BiasT*>(bias_v);
  const int TP = (Tn + 15) / 16 * 16;
  const int w = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int r0 = wid * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TP * HDP;
  T* Vs = Ks + TP * HDP;
  float* Ss = reinterpret_cast<float*>(Vs + TP * HDP);
  T* Ps = TC ? reinterpret_cast<T*>(Ss + TP * TP) : reinterpret_cast<T*>(Ss);
  float* Os = reinterpret_cast<float*>(Ps + TP * TP);  // bf16 only
  float* dn = TC ? Os + TP * HD : Ss + TP * TP;

  // q, k, v of this (window, head); rows past Tn are zero
  const long long row0 = (long long)w * Tn;
  const int C3 = 3 * C;
  for (int e = threadIdx.x; e < TP * HD; e += blockDim.x) {
    const int t = e / HD, d = e % HD;
    T q = from_f<T>(0.f), k = q, v = q;
    if (t < Tn) {
      const T* src = qkv + (row0 + t) * C3 + h * HD + d;
      q = src[0];
      k = src[C];
      v = src[2 * C];
    }
    Qs[t * HDP + d] = q;
    Ks[t * HDP + d] = k;
    Vs[t * HDP + d] = v;
  }
  __syncthreads();

  float* Sw = Ss + r0 * TP;  // this warp's 16 x TP score strip
  T* Pw = Ps + r0 * TP;
  if constexpr (TC) {
    using namespace nvcuda;
    for (int jt = 0; jt < TP / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + r0 * HDP + kk, HDP);
        wmma::load_matrix_sync(fb, Ks + jt * 16 * HDP + kk, HDP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + jt * 16, acc, TP, wmma::mem_row_major);
    }
  } else {
    for (int e = lane; e < 16 * TP; e += 32) {
      const int r = e / TP, j = e % TP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(to_f<T>(Qs[(r0 + r) * HDP + d]), to_f<T>(Ks[j * HDP + d]), s);
      Sw[r * TP + j] = s;
    }
  }
  __syncwarp();

  // softmax over each of the warp's rows (columns spread over the lanes)
  const int widx = w % (nwh * nww);
  const bool li = ss > 0 && widx / nww == nwh - 1;
  const bool lj = ss > 0 && widx % nww == nww - 1;
  const float scale_t = rnd<T>(scale);  // the reference multiplies by a compute-dtype scalar
  constexpr int MAXQ = 5;               // ceil(144 / 32)
  for (int r = 0; r < 16; ++r) {
    const int i = r0 + r;
    if (i >= Tn) {
      for (int j = lane; j < TP; j += 32) Pw[r * TP + j] = from_f<T>(0.f);
      if (lane == 0) dn[i] = 1.f;
      continue;
    }
    const int bri = band(i / ws, ws, ss), bci = band(i % ws, ws, ss);
    const BiasT* brow = bias + ((long long)h * Tn + i) * Tn;
    float sv[MAXQ];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < MAXQ; ++q) {
      const int j = lane + 32 * q;
      sv[q] = -INFINITY;
      if (j < Tn) {
        float s = Sw[r * TP + j];
        const bool differ = (li && bri != band(j / ws, ws, ss)) || (lj && bci != band(j % ws, ws, ss));
        if constexpr (F32) {
          s = s * scale + to_f<BiasT>(brow[j]);
          if (differ) s += -100.f;
        } else {
          s = rnd<T>(rnd<T>(s) * scale_t);
          s = rnd<T>(s + to_f<BiasT>(brow[j]));
          if (differ) s = rnd<T>(s + -100.f);
        }
        sv[q] = s;
        mx = fmaxf(mx, s);
      }
    }
    float sum = 0.f;
    if constexpr (!F32) mx = warp_max(mx);
#pragma unroll
    for (int q = 0; q < MAXQ; ++q) {
      const int j = lane + 32 * q;
      if (j < Tn) {
        float e;
        if constexpr (F32) {
          e = expf(fminf(sv[q], 80.f) - 30.f);
        } else {
          e = rnd<T>(expf(rnd<T>(sv[q] - mx)));
        }
        sum += e;
        Pw[r * TP + j] = from_f<T>(e);
      } else if (j < TP) {
        Pw[r * TP + j] = from_f<T>(0.f);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) dn[i] = F32 ? sum + 1e-37f : rnd<T>(rnd<T>(sum) + 1e-37f);
  }
  __syncwarp();

  // o = P V / denominator, written at this head's channel offset
  if constexpr (TC) {
    using namespace nvcuda;
    float* Ow = Os + r0 * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kt = 0; kt < TP / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kt * 16, TP);
        wmma::load_matrix_sync(fb, Vs + kt * 16 * HDP + nt * 16, HDP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ow + nt * 16, acc, HD, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD, d = e % HD, i = r0 + r;
      if (i < Tn) o[(row0 + i) * C + h * HD + d] = from_f<T>(Ow[r * HD + d] / dn[i]);
    }
  } else {
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD, d = e % HD, i = r0 + r;
      if (i >= Tn) continue;
      float acc = 0.f;
      for (int j = 0; j < Tn; ++j) acc = fmaf(to_f<T>(Pw[r * TP + j]), to_f<T>(Vs[j * HDP + d]), acc);
      o[(row0 + i) * C + h * HD + d] = from_f<T>(acc / dn[i]);
    }
  }
}

template <typename T, bool F32>
void launch_attn_core(const T* qkv, const void* bias, T* o, int bnw, int t, int c, int nh,
                      int ws, int ss, int nwh, int nww, cudaStream_t stream) {
  const int tp = (t + 15) / 16 * 16;
  const size_t smem = attn_smem_bytes<T>(tp);
  cudaFuncSetAttribute(attn_core_kernel<T, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const float scale = 1.f / sqrtf((float)ATTN_HD);
  attn_core_kernel<T, F32><<<dim3(bnw, nh), tp / 16 * 32, smem, stream>>>(
      qkv, bias, o, t, c, ws, ss, nwh, nww, scale);
}

template <typename T>
int window_attn_impl(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                     const void* bproj, const void* bias, void* qkv, void* o, void* out,
                     int bnw, int t, int c, int nh, int ws, int ss, int nwh, int nww,
                     int attn_f32, cudaStream_t s) {
  const int m = bnw * t;
  launch_gemm<T, EPI_BIAS>((const T*)x, (const T*)wqkv, (T*)qkv, m, 3 * c, c,
                           (const T*)bqkv, nullptr, nullptr, s);
  if (attn_f32) {
    launch_attn_core<T, true>((const T*)qkv, bias, (T*)o, bnw, t, c, nh, ws, ss, nwh, nww, s);
  } else {
    launch_attn_core<T, false>((const T*)qkv, bias, (T*)o, bnw, t, c, nh, ws, ss, nwh, nww, s);
  }
  launch_gemm<T, EPI_BIAS>((const T*)o, (const T*)wproj, (T*)out, m, c, c, (const T*)bproj,
                           nullptr, nullptr, s);
  return (int)cudaGetLastError();
}

}  // namespace flair

using namespace flair;

extern "C" int window_attn_fwd(const void* x, const void* wqkv, const void* bqkv,
                               const void* wproj, const void* bproj, const void* bias,
                               void* qkv, void* o, void* out, int bnw, int t, int c, int nh,
                               int ws, int ss, int nwh, int nww, int attn_f32, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return window_attn_impl<float>(x, wqkv, bqkv, wproj, bproj, bias, qkv, o, out, bnw, t, c,
                                   nh, ws, ss, nwh, nww, attn_f32, s);
  return window_attn_impl<bf16>(x, wqkv, bqkv, wproj, bproj, bias, qkv, o, out, bnw, t, c, nh,
                                ws, ss, nwh, nww, attn_f32, s);
}
