// Shared-memory tiled GEMM with a fused epilogue: C = A @ W^T.
//
// A is (M, K) row-major (activations), W is (N, K) row-major (nn.Linear
// weight layout), C is (M, N). Used by K2 (qkv and output projections) and
// K3 (fc1, fc2). bf16 inputs run on the tensor cores through nvcuda::wmma
// (m16n16k16, float32 accumulate); float32 inputs run a SIMT FMA loop so the
// float32 path keeps full float32 precision (no TF32).
//
// Block tile 128 x 64 x 32, 8 warps (4 x 2 warps of 32 x 32). One stage, no
// cp.async / TMA pipeline: a first, simple kernel (Wgmma + TMA is later work).
// Requires K % (16 / sizeof(T)) == 0 so every 16-byte load stays in a row.
//
// Epilogues, in the JAX reference's rounding order (models/layers.py
// TorchLinear, ops/pallas/ffn.py :132-146):
//   EPI_BIAS       out = rnd(rnd(acc) + b[n])
//   EPI_BIAS_GELU  h = rnd(rnd(acc) + b[n]); out = 0.5 h (1 + erf(h / sqrt 2))
//   EPI_RESID      out = (rnd(x + a) + b[n]) + acc      (float32, then rounded)
#pragma once

#include <mma.h>

#include "common.cuh"

namespace flair {

enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_RESID = 2 };

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_LDC = GEMM_BN + 4;

template <typename T> __host__ __device__ constexpr int gemm_lds() { return GEMM_BK + (sizeof(T) == 2 ? 8 : 4); }

template <typename T> __host__ __device__ constexpr size_t gemm_smem_bytes() {
  const size_t ab = (size_t)(GEMM_BM + GEMM_BN) * gemm_lds<T>() * sizeof(T);
  const size_t c = (size_t)GEMM_BM * GEMM_LDC * sizeof(float);
  return ab > c ? ab : c;
}

template <typename T, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ Wt, T* __restrict__ Cout,
            int M, int N, int K, const T* __restrict__ bias,
            const T* __restrict__ ra, const T* __restrict__ rb) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int LDS = gemm_lds<T>();
  constexpr int VEC = 16 / sizeof(T);
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + GEMM_BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;

  constexpr bool TC = sizeof(T) == 2;
  const int warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int tr = tid >> 4, tc = tid & 15;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_tc[2][2];
  float acc[8][4];
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc_tc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int v = tid; v < GEMM_BM * GEMM_BK / VEC; v += GEMM_THREADS) {
      const int row = v / (GEMM_BK / VEC), col = (v % (GEMM_BK / VEC)) * VEC;
      const int gm = m0 + row, gk = k0 + col;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) val = *reinterpret_cast<const uint4*>(A + (long long)gm * K + gk);
      *reinterpret_cast<uint4*>(As + row * LDS + col) = val;
    }
    for (int v = tid; v < GEMM_BN * GEMM_BK / VEC; v += GEMM_THREADS) {
      const int row = v / (GEMM_BK / VEC), col = (v % (GEMM_BK / VEC)) * VEC;
      const int gn = n0 + row, gk = k0 + col;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gn < N && gk < K) val = *reinterpret_cast<const uint4*>(Wt + (long long)gn * K + gk);
      *reinterpret_cast<uint4*>(Bs + row * LDS + col) = val;
    }
    __syncthreads();
    if constexpr (TC) {
#pragma unroll
      for (int kk = 0; kk < GEMM_BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, nvcuda::wmma::row_major> fa[2];
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nvcuda::wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            nvcuda::wmma::mma_sync(acc_tc[i][j], fa[i], fb[j], acc_tc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < GEMM_BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f<T>(As[(tr * 8 + i) * LDS + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_f<T>(Bs[(tc * 4 + j) * LDS + kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // stage the float32 tile in shared memory (reusing the A/B buffers)
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * GEMM_LDC + wn * 32 + j * 16,
                                        acc_tc[i][j], GEMM_LDC, nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr * 8 + i) * GEMM_LDC + tc * 4 + j] = acc[i][j];
  }
  __syncthreads();

  for (int e = tid; e < GEMM_BM * GEMM_BN; e += GEMM_THREADS) {
    const int r = e / GEMM_BN, c = e % GEMM_BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float v = Cs[r * GEMM_LDC + c];
    const long long idx = (long long)gm * N + gn;
    float o;
    if constexpr (EPI == EPI_RESID) {
      const float x2 = rnd<T>(to_f<T>(ra[idx]) + to_f<T>(rb[idx]));
      o = (x2 + to_f<T>(bias[gn])) + v;
    } else {
      const float h = rnd<T>(rnd<T>(v) + to_f<T>(bias[gn]));
      if constexpr (EPI == EPI_BIAS_GELU) {
        o = 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
      } else {
        o = h;
      }
    }
    Cout[idx] = from_f<T>(o);
  }
}

// Launch C = A @ W^T with the chosen epilogue on `stream`.
template <typename T, int EPI>
void launch_gemm(const T* A, const T* Wt, T* C, int M, int N, int K, const T* bias,
                 const T* ra, const T* rb, cudaStream_t stream) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_kernel<T, EPI><<<grid, GEMM_THREADS, gemm_smem_bytes<T>(), stream>>>(
      A, Wt, C, M, N, K, bias, ra, rb);
}

}  // namespace flair
