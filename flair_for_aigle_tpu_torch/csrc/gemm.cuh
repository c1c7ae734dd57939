// Shared-memory tiled GEMM with a fused epilogue, in three layouts:
//
//   A @ W^T   A (M, K) row-major, W (N, K) row-major (nn.Linear weight)
//   A @ B     A (M, K), B (K, N) row-major              (BKN = true)
//   A^T @ B   A (K, M), B (K, N) row-major    (AT = true, BKN = true)
//
// C is (M, N). Used by K7 alone (fc1 recomputed, dh = g W2, dln = dh0 W1
// and the weight gradients g^T h and dh0^T ln, whose reduction runs over
// all rows). Every other product of the port runs on gemm_mma.cuh, which
// takes K7's layouts too: A^T @ B as MMA_WGRAD, A @ B as A W^T on the
// weight's transposed copy (as K6's do and dx); K7's two epilogues below
// have no counterpart there yet. bf16 inputs run on the tensor cores through
// nvcuda::wmma (m16n16k16, float32 accumulate); float32 inputs run a SIMT
// FMA loop so the float32 path keeps full float32 precision (no TF32).
//
// Block tile 128 x 64 x 32, 8 warps (4 x 2 warps of 32 x 32). One stage, no
// cp.async / TMA pipeline: a first, simple kernel (Wgmma + TMA is later work).
// Every 16-byte load runs along a tile's contiguous dimension, so that
// dimension's extent must be a multiple of 16 / sizeof(T) (K for A and W,
// M for A^T, N for B); the other dimension is masked row by row.
//
// Split-K (EPI_F32 only): block z of the grid reduces rows
// [z * k_chunk, (z + 1) * k_chunk) of K and writes its own float32 partial
// C_z at Cout + z * M * N; sum_partials_kernel (common.cuh) adds them in a
// fixed order, so the result repeats exactly from run to run (no atomics).
//
// Epilogues, in the JAX reference's rounding order (models/layers.py
// TorchLinear, ops/pallas/ffn.py :132-146):
//   EPI_F32        out = acc, float32 (the split-K partials)
//   EPI_BIAS_GELU_AUX  h = rnd(rnd(acc) + b[n]); out = 0.5 h (1 + erf(h /
//                  sqrt 2)); and h (before GELU) to aux (T)
//   EPI_DGELU      d = acc * gelu'(z), z = ra[m, n]; out = rnd(d); and the
//                  block's float32 column sums of d to aux[blockIdx.y * N + n]
//                  (one partial per 128-row tile, summed later in a fixed order)
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace flair {

enum { EPI_F32 = 4, EPI_BIAS_GELU_AUX = 6, EPI_DGELU = 7 };

// the derivative of the exact GELU (common.cuh gelu_f), Phi(z) + z phi(z),
// in float32
__device__ __forceinline__ float gelu_grad_f(float z) {
  return 0.5f * (1.f + erff(z * 0.7071067811865476f)) +
         z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_LDC = GEMM_BN + 4;

template <typename T> __host__ __device__ constexpr int gemm_pad() { return sizeof(T) == 2 ? 8 : 4; }

template <typename T> __host__ __device__ constexpr size_t gemm_smem_bytes() {
  // A and B tiles in either orientation hold (rows + pad) x cols elements;
  // the float32 C tile reuses the same buffer after the main loop
  const size_t a = (size_t)(GEMM_BM + gemm_pad<T>()) * (GEMM_BK + gemm_pad<T>()) * sizeof(T);
  const size_t b = (size_t)(GEMM_BN + gemm_pad<T>()) * (GEMM_BK + gemm_pad<T>()) * sizeof(T);
  const size_t c = (size_t)GEMM_BM * GEMM_LDC * sizeof(float);
  return a + b > c ? a + b : c;
}

// Load a (ROWS x COLS) tile whose COLS run along the contiguous dimension of
// a row-major source with leading dimension ld, rows [r0, r_end) and columns
// [c0, c_end) valid; out-of-range elements are zero.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* __restrict__ src, long long ld,
                                          int r0, int r_end, int c0, int c_end) {
  constexpr int VEC = 16 / sizeof(T);
  for (int v = threadIdx.x; v < ROWS * COLS / VEC; v += GEMM_THREADS) {
    const int row = v / (COLS / VEC), col = (v % (COLS / VEC)) * VEC;
    const int gr = r0 + row, gc = c0 + col;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < r_end && gc < c_end) val = *reinterpret_cast<const uint4*>(src + (long long)gr * ld + gc);
    *reinterpret_cast<uint4*>(dst + row * ldd + col) = val;
  }
}

template <typename T, int EPI, bool AT, bool BKN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, void* __restrict__ Cout,
            int M, int N, int K, int k_chunk, const T* __restrict__ bias,
            const T* __restrict__ ra, void* __restrict__ aux) {
  static_assert(EPI == EPI_F32 || !AT, "A^T @ B is only used for float32 weight gradients");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int PAD = gemm_pad<T>();
  // A tile: (BM x BK) as [m][k], or [k][m] when A is stored (K, M)
  constexpr int LDA = AT ? GEMM_BM + PAD : GEMM_BK + PAD;
  // B tile: (BK x BN) as [n][k] for a (N, K) weight, or [k][n]
  constexpr int LDB = BKN ? GEMM_BN + PAD : GEMM_BK + PAD;
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + (AT ? GEMM_BK * LDA : GEMM_BM * LDA);
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  constexpr bool TC = sizeof(T) == 2;
  using LA = typename std::conditional<AT, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  using LB = typename std::conditional<BKN, nvcuda::wmma::row_major, nvcuda::wmma::col_major>::type;
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

  for (int k0 = k_begin; k0 < k_end; k0 += GEMM_BK) {
    if constexpr (AT) {
      load_tile<T, GEMM_BK, GEMM_BM>(As, LDA, A, M, k0, k_end, m0, M);
    } else {
      load_tile<T, GEMM_BM, GEMM_BK>(As, LDA, A, K, m0, M, k0, k_end);
    }
    if constexpr (BKN) {
      load_tile<T, GEMM_BK, GEMM_BN>(Bs, LDB, B, N, k0, k_end, n0, N);
    } else {
      load_tile<T, GEMM_BN, GEMM_BK>(Bs, LDB, B, K, n0, N, k0, k_end);
    }
    __syncthreads();
    if constexpr (TC) {
#pragma unroll
      for (int kk = 0; kk < GEMM_BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LA> fa[2];
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LB> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mm = wm * 32 + i * 16;
          nvcuda::wmma::load_matrix_sync(fa[i], AT ? As + kk * LDA + mm : As + mm * LDA + kk, LDA);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nn = wn * 32 + j * 16;
          nvcuda::wmma::load_matrix_sync(fb[j], BKN ? Bs + kk * LDB + nn : Bs + nn * LDB + kk, LDB);
        }
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
        for (int i = 0; i < 8; ++i) {
          const int mm = tr * 8 + i;
          a[i] = to_f<T>(AT ? As[kk * LDA + mm] : As[mm * LDA + kk]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = tc * 4 + j;
          b[j] = to_f<T>(BKN ? Bs[kk * LDB + nn] : Bs[nn * LDB + kk]);
        }
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
    if constexpr (EPI == EPI_F32) {
      reinterpret_cast<float*>(Cout)[(long long)blockIdx.z * M * N + idx] = v;
      continue;
    }
    float o;
    if constexpr (EPI == EPI_DGELU) {
      o = v * gelu_grad_f(to_f<T>(ra[idx]));
      Cs[r * GEMM_LDC + c] = o;  // kept for the column sums below
    } else {
      const float h = rnd<T>(rnd<T>(v) + to_f<T>(bias[gn]));
      reinterpret_cast<T*>(aux)[idx] = from_f<T>(h);
      o = gelu_f(h);
    }
    reinterpret_cast<T*>(Cout)[idx] = from_f<T>(o);
  }
  if constexpr (EPI == EPI_DGELU) {
    // this tile's column sums, rows in order: one float32 partial per tile
    __syncthreads();
    const int gn = n0 + tid;
    if (tid < GEMM_BN && gn < N) {
      float s = 0.f;
      for (int r = 0; r < min(GEMM_BM, M - m0); ++r) s += Cs[r * GEMM_LDC + tid];
      reinterpret_cast<float*>(aux)[(long long)blockIdx.y * N + gn] = s;
    }
  }
}

// Launch C = A op B with the chosen epilogue on `stream`. For EPI_F32 with
// k_chunk < K, C receives ceil(K / k_chunk) partials of M x N (see above).
// aux: the second output of EPI_BIAS_GELU_AUX (M x N, T) and EPI_DGELU
// (ceil(M / GEMM_BM) x N, float32).
template <typename T, int EPI, bool AT = false, bool BKN = false>
void launch_gemm(const T* A, const T* B, void* C, int M, int N, int K, const T* bias,
                 const T* ra, cudaStream_t stream, int k_chunk = 0,
                 void* aux = nullptr) {
  if (k_chunk <= 0) k_chunk = K;
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, (K + k_chunk - 1) / k_chunk);
  gemm_kernel<T, EPI, AT, BKN><<<grid, GEMM_THREADS, gemm_smem_bytes<T>(), stream>>>(
      A, B, C, M, N, K, k_chunk, bias, ra, aux);
}

}  // namespace flair
