// Tensor-core GEMM with a cp.async pipeline and an epilogue straight from
// the accumulator registers, for K3's two products (ffn.cu), K2's qkv and
// output projections (window_attn.cu) and K6's qkv recompute
// (window_attn_bwd.cu):
//
//   C = A W^T   A (M, K) row-major, W (N, K) row-major (the nn.Linear layout)
//
// bf16 runs mma.sync.m16n8k16 (float32 accumulate). float32 runs the same
// skeleton as 3xTF32 on mma.sync.m16n8k8 (core_util.cuh: each operand
// split into tf32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
// first, float32 accumulate), float32-accurate to about 2^-21 of each
// product; tf32 alone would not be.
//
// Skeleton (one block: BM x BN of C, 8 warps as 2 x 4, each a BM/2 x BN/4
// tile of m16 x n8 accumulators):
//   - A k step stages RAW bytes of every row of the block's A and W tiles
//     (bf16: 128, 64 values; float32: 64, 16 values) as 16-byte cp.async
//     copies spread over the threads, into a ring of 3 stages. Copies past
//     M, N or the end of the block's K range are zero-filled (src-size 0),
//     so ragged M, N and K need no other branch; every extent is a
//     multiple of 8 elements (the wrapper checks), so a 16-byte chunk lies
//     wholly inside or outside.
//   - bf16: rows padded by 16 bytes, so that ldmatrix (8 rows of 16 bytes a
//     phase) is free of bank conflicts; the fragments come straight from
//     the ring.
//   - float32: the ring holds raw rows, and two more buffers the split
//     operands (tf32 hi and lo bit patterns, padded rows). Each thread
//     splits exactly the chunks it copied, once, after its own
//     cp.async.wait_group: no warp splits a fragment again, and no barrier
//     sits between the copy and the split. ldmatrix reads the 32-bit
//     patterns as pairs of b16, which gives the m16n8k8 tf32 fragments
//     (lane (g, t): row g, word t) in one instruction per 8 x 4 words. The
//     three products of a half step go term by term over all of the
//     warp's tiles, so that no product waits on the one before it in its
//     accumulator.
//   - One __syncthreads per k step. All stages start in flight. A's
//     fragments of the next half step (32 bytes of each row: k16 bf16, k8
//     float32) load while a half step's products run, W's just before
//     them (double-buffering both would take more than the 128 registers
//     of two blocks an SM); before the last half step's products each
//     thread waits for its own copies of the next step (and splits them),
//     the barrier, the copies of step + 3 go into the slot this step was
//     read from, and the next step's first A fragments load.
//     The barrier orders every reuse: a bf16 slot (or a split buffer, two
//     steps apart) is rewritten only after every warp has passed the
//     barrier that follows its last read; a float32 raw slot is read only
//     by the thread that filled it.
//   - Epilogues read the accumulators where they lie: each quad of lanes
//     transposes its four n8 tiles of a row by shuffles, so that a lane
//     holds 8 neighbouring columns and every load and store is 16 bytes of
//     whole sectors. In the reference's rounding order (a float32 dot
//     rounded to the compute dtype, then the bias added there):
//       MMA_BIAS   out = rnd(rnd(acc) + b[n])       (K2's qkv and proj, K6's qkv)
//       MMA_GELU   h = rnd(rnd(acc) + b[n]); out = GELU(h)     (fc1)
//       MMA_RESID  out = (rnd(x + a) + b[n]) + acc            (fc2)
//       MMA_PART   out = acc, float32, at part + z M N: block z of the grid
//                  sums K range [z k_chunk, (z + 1) k_chunk); the split-K
//                  partials of fc2, which resid_sum_kernel adds in the order
//                  z = 0, 1, ... before it applies MMA_RESID's epilogue (no
//                  atomics: two calls give the same bits)
#pragma once

#include <type_traits>

#include "common.cuh"
#include "core_util.cuh"

namespace flair {

enum { MMA_GELU = 0, MMA_RESID = 1, MMA_PART = 2, MMA_BIAS = 3 };

constexpr int MMA_THREADS = 256;

template <typename T> __host__ __device__ constexpr bool mma_f32() {
  return std::is_same<T, float>::value;
}
// bytes of each staged row a k step brings in: bf16 128 (64 values),
// float32 64 (16 values, split into 128 bytes of tf32 halves)
template <typename T> __host__ __device__ constexpr int mma_raw() {
  return mma_f32<T>() ? 64 : 128;
}
// stages of the ring (float32: of raw rows)
constexpr int MMA_STAGES = 3;
// resident blocks per SM that __launch_bounds__ promises (128 registers a
// thread at most)
constexpr int MMA_MIN_BLOCKS = 2;

// bf16: S stages of rows padded by 16 bytes for ldmatrix; float32: S raw
// stages, then two buffers of split rows (hi and lo), padded
template <typename T, int BM, int BN> __host__ __device__ constexpr size_t mma_smem_bytes() {
  constexpr int raw = mma_raw<T>(), row = raw + 16, s = MMA_STAGES;
  return mma_f32<T>() ? (size_t)(BM + BN) * (s * raw + 4 * row) : (size_t)(BM + BN) * s * row;
}

namespace {

// 16 bytes from gmem to the shared address `smem` when `full`, else 16
// zero bytes (nothing read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t smem, const void* gmem, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(full ? 16 : 0));
}

// ldmatrix x4 at a shared address (core_util.cuh ldsm_x4 takes a pointer)
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// one half step's fragments of a warp: MT m16 tiles of A, NT n8 tiles of W
// (bf16: m16n8k16 registers; float32: m16n8k8, split into tf32 hi and lo)
template <bool F32, int MT, int NT> struct MmaFrags {
  uint32_t a[MT][4], b[NT][2];
};
template <int MT, int NT> struct MmaFrags<true, MT, NT> {
  TF32A a[MT];
  TF32B b[NT];
};

// eight neighbouring values (16 bytes of bf16, 32 of float32; the address
// 16-byte aligned) as float32, and back
template <typename T> __device__ __forceinline__ void ld8(const T* p, float (&v)[8]);
template <> __device__ __forceinline__ void ld8<float>(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <> __device__ __forceinline__ void ld8<bf16>(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[2 * c] = bf16_lo(w[c]);
    v[2 * c + 1] = bf16_hi(w[c]);
  }
}

template <typename T> __device__ __forceinline__ void st8(T* p, const float (&v)[8]);
template <> __device__ __forceinline__ void st8<float>(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
template <> __device__ __forceinline__ void st8<bf16>(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// MMA_RESID's epilogue of eight columns: o = (rnd(x + a) + b) + acc
template <typename T>
__device__ __forceinline__ void resid8(const T* x, const T* a, const float (&b)[8],
                                       const float (&acc)[8], float (&o)[8]) {
  float xv[8], av[8];
  ld8<T>(x, xv);
  ld8<T>(a, av);
#pragma unroll
  for (int c = 0; c < 8; ++c) o[c] = (rnd<T>(xv[c] + av[c]) + b[c]) + acc[c];
}

// 4 x 4 transpose of 32-bit values within each quad of lanes (t = lane %
// 4): lane t's v[u] becomes lane u's v[t]. Two butterfly rounds: swap the
// off-diagonal 2 x 2 blocks (lanes t, t ^ 2), then the off-diagonal values
// of each block (lanes t, t ^ 1)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  {
    const bool up = t & 2;
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, up ? v[0] : v[2], 2);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, up ? v[1] : v[3], 2);
    if (up) {
      v[0] = s0;
      v[1] = s1;
    } else {
      v[2] = s0;
      v[3] = s1;
    }
  }
  {
    const bool odd = t & 1;
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
    if (odd) {
      v[0] = s0;
      v[2] = s1;
    } else {
      v[1] = s0;
      v[3] = s1;
    }
  }
}

}  // namespace

template <typename T, int BM, int BN, int EPI>
__global__ void __launch_bounds__(MMA_THREADS, MMA_MIN_BLOCKS)
    gemm_mma_kernel(const T* __restrict__ A, const T* __restrict__ W, void* __restrict__ out,
                    int M, int N, int K, int k_chunk, const T* __restrict__ bias,
                    const T* __restrict__ rx, const T* __restrict__ ra) {
  constexpr bool F32 = mma_f32<T>();
  constexpr int S = MMA_STAGES;
  constexpr int RAW = mma_raw<T>();               // bytes of a row a k step
  constexpr int ROW = RAW + 16;                   // a padded row: ldmatrix conflict-free
  constexpr int ROWS = BM + BN;
  constexpr int EPR = RAW / (int)sizeof(T);       // K elements a step
  constexpr int CPT = RAW / 64;                   // 16-byte chunks a thread takes of a row
  constexpr int RPT = ROWS / 64;                  // rows a thread takes, 64 apart
  constexpr int SUBS = RAW / 32;                  // half steps of 32 bytes: k16 bf16, k8 float32
  constexpr int WM = BM / 2, WN = BN / 4, MT = WM / 16, NT = WN / 8;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && MT >= 1 && NT % 4 == 0, "tile");
  constexpr int STAGE = ROWS * (F32 ? RAW : ROW);
  constexpr int SPLIT = 2 * ROWS * ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* split = smem + S * STAGE;
  const uint32_t smem_at = smem_u32(smem), split_at = smem_at + S * STAGE;  // shared addresses

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  const int nk = (ke - kb + EPR - 1) / EPR;

  // this thread's chunks of a step: rows r0 + 64 i of the stage (A's BM
  // rows, then W's BN), 16-byte columns ch + 4 c of each; offsets within
  // an operand in 32 bits (rows * K < 2^31)
  const int r0 = tid >> 2, ch = tid & 3;
  const T* a_src = A + (long long)(m0 + r0) * K + ch * (16 / (int)sizeof(T));
  const T* w_src = W + (long long)(n0 + r0) * K + ch * (16 / (int)sizeof(T));
  const int a_left = M - m0 - r0, w_left = N - n0 - r0;  // rows from r0 on
  auto load = [&](int ks) {
    const int k = kb + ks * EPR;
    const uint32_t dst = smem_at + (ks % S) * STAGE + ch * 16 + r0 * (F32 ? RAW : ROW);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool is_a = 64 * i < BM;  // known at compile time
      const int rr = is_a ? 64 * i : 64 * i - BM;
      const bool row_in = rr < (is_a ? a_left : w_left);
      const T* src = (is_a ? a_src : w_src) + (rr * K + k);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kc = c * 64 / (int)sizeof(T);  // 4 chunks further along the row
        const bool full = row_in && k + kc + ch * (16 / (int)sizeof(T)) < ke;
        cp_async16_zfill(dst + 64 * i * (F32 ? RAW : ROW) + 64 * c, full ? src + kc : A, full);
      }
    }
  };
  // float32: split this thread's own chunks of step ks (raw slot ks % S)
  // into tf32 hi and lo, in split buffer ks & 1
  auto split_step = [&](int ks) {
    const unsigned char* raw = smem + (ks % S) * STAGE + ch * 16 + r0 * RAW;
    unsigned char* hi = split + (ks & 1) * SPLIT + ch * 16 + r0 * ROW;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(raw + 64 * i * RAW + 64 * c);
        uint4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + 64 * i * ROW + 64 * c) = h;
        *reinterpret_cast<uint4*>(hi + ROWS * ROW + 64 * i * ROW + 64 * c) = l;
      }
  };
  // the tile of step ks that the fragments come from
  auto tile_of = [&](int ks) -> uint32_t {
    return F32 ? split_at + (ks & 1) * SPLIT : smem_at + (ks % S) * STAGE;
  };

  // fragment addresses within a tile of ROW-byte rows: A's m16 tiles
  // (lanes 0-15 rows 0-15 at bytes 0-15, lanes 16-31 at 16-31), W's n8
  // pairs (lanes 8q..8q+7: rows 8 (q >> 1).., bytes 16 (q & 1)..); half
  // step `sub` is 32 sub bytes along the rows
  const int a_off = (wm * WM + (lane & 15)) * ROW + (lane >> 4) * 16;
  const int b_off =
      (BM + wn * WN + ((lane >> 4) << 3) + (lane & 7)) * ROW + ((lane >> 3) & 1) * 16;
  using Frags = MmaFrags<F32, MT, NT>;
  auto load_a = [&](Frags& f, uint32_t tile, int sub) {
    const uint32_t pa = tile + a_off + sub * 32;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (F32) {
        ldsm_x4_at(f.a[i].hi, pa + i * 16 * ROW);
        ldsm_x4_at(f.a[i].lo, pa + ROWS * ROW + i * 16 * ROW);
      } else {
        ldsm_x4_at(f.a[i], pa + i * 16 * ROW);
      }
    }
  };
  auto load_b = [&](Frags& f, uint32_t tile, int sub) {
    const uint32_t pb = tile + b_off + sub * 32;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t h[4];
      ldsm_x4_at(h, pb + j * 8 * ROW);
      if constexpr (F32) {
        uint32_t l[4];
        ldsm_x4_at(l, pb + ROWS * ROW + j * 8 * ROW);
        f.b[j] = TF32B{{h[0], h[1]}, {l[0], l[1]}};
        f.b[j + 1] = TF32B{{h[2], h[3]}, {l[2], l[3]}};
      } else {
        f.b[j][0] = h[0];
        f.b[j][1] = h[1];
        f.b[j + 1][0] = h[2];
        f.b[j + 1][1] = h[3];
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // float32: mma_3xtf32's three products, each term over every tile
  // before the next term, so that no product waits on the one before it
  // in its accumulator (each still sums a_lo b_hi, a_hi b_lo, a_hi b_hi
  // in that order)
  auto mma_frags = [&](const Frags& fa, const Frags& fb) {
#pragma unroll
    for (int term = 0; term < (F32 ? 3 : 1); ++term)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (F32) {
            const uint32_t(&a)[4] = term == 0 ? fa.a[i].lo : fa.a[i].hi;
            const uint32_t(&b)[2] = term == 1 ? fb.b[j].lo : fb.b[j].hi;
            mma_1688(acc[i][j], a, b[0], b[1]);
          } else {
            mma_16816(acc[i][j], fa.a[i], fb.b[j][0], fb.b[j][1]);
          }
        }
  };

  // all S slots in flight; in each half step A's fragments of the next one
  // load while its products run (W's just before them), the barrier
  // section sitting before the last half step's products
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  cp_async_wait<S - 1>();
  if constexpr (F32) split_step(0);
  __syncthreads();
  Frags fa[2], fb;
  load_a(fa[0], tile_of(0), 0);
  for (int ks = 0; ks < nk; ++ks) {
#pragma unroll
    for (int sub = 0; sub < SUBS; ++sub) {
      load_b(fb, tile_of(ks), sub);
      uint32_t next = tile_of(ks);  // the next half step's tile and offset
      int next_sub = sub + 1;
      bool more = true;
      if (sub + 1 == SUBS) {
        more = ks + 1 < nk;
        if (more) {
          cp_async_wait<S - 2>();  // this thread's copies of step ks + 1 have landed
          if constexpr (F32) split_step(ks + 1);
          __syncthreads();  // step ks + 1 visible; every read of slot ks % S done
          if (ks + S < nk) load(ks + S);
          cp_async_commit();
        }
        next = tile_of(ks + 1);
        next_sub = 0;
      }
      if (more) load_a(fa[(sub + 1) & 1], next, next_sub);
      mma_frags(fa[sub & 1], fb);
    }
  }
  cp_async_wait<0>();  // no copy may land after the block has left

  // each quad's four n8 tiles of a row transposed, so that lane t holds
  // eight neighbouring columns 8 t .. 8 t + 7 of the 32 the quad spans:
  // 16-byte loads and stores of whole sectors
  const int g = lane >> 2, t = lane & 3;
  // this lane's eight bias values of each quad span (every epilogue but
  // MMA_PART's)
  float bq[NT / 4][8];
#pragma unroll
  for (int q = 0; q < NT / 4; ++q) {
    const int n = n0 + wn * WN + 32 * q + 8 * t;
#pragma unroll
    for (int c = 0; c < 8; ++c) bq[q][c] = 0.f;
    if (EPI != MMA_PART && n < N) ld8<T>(bias + n, bq[q]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q = 0; q < NT / 4; ++q) {
        uint32_t vx[4], vy[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vx[u] = __float_as_uint(acc[i][4 * q + u][2 * hf]);
          vy[u] = __float_as_uint(acc[i][4 * q + u][2 * hf + 1]);
        }
        quad_transpose(vx, t);
        quad_transpose(vy, t);
        float v[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[2 * u] = __uint_as_float(vx[u]);
          v[2 * u + 1] = __uint_as_float(vy[u]);
        }
        const int m = m0 + wm * WM + 16 * i + g + 8 * hf;
        const int n = n0 + wn * WN + 32 * q + 8 * t;
        if (m >= M || n >= N) continue;
        const long long idx = (long long)m * N + n;
        if constexpr (EPI == MMA_PART) {
          st8<float>(reinterpret_cast<float*>(out) + (long long)blockIdx.z * M * N + idx, v);
        } else {
          float o[8];
          if constexpr (EPI == MMA_RESID) {
            resid8<T>(rx + idx, ra + idx, bq[q], v, o);
          } else if constexpr (EPI == MMA_BIAS) {
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = rnd<T>(rnd<T>(v[e]) + bq[q][e]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = gelu_f(rnd<T>(rnd<T>(v[e]) + bq[q][e]));
          }
          st8<T>(reinterpret_cast<T*>(out) + idx, o);
        }
      }
}

// fc2's split-K reduction and epilogue: out = (rnd(x + a) + b[n]) + sum_z
// part[z], the partials added in the order z = 0, 1, ..., nz - 1; one
// thread eight neighbouring columns
template <typename T>
__global__ void __launch_bounds__(256)
    resid_sum_kernel(const float* __restrict__ part, int nz, long long mn, int N,
                     const T* __restrict__ bias, const T* __restrict__ rx,
                     const T* __restrict__ ra, T* __restrict__ out) {
  const long long e = 8 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= mn) return;
  float s[8], p[8], b[8], o[8];
  ld8<float>(part + e, s);
  for (int z = 1; z < nz; ++z) {
    ld8<float>(part + z * mn + e, p);
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] += p[c];
  }
  ld8<T>(bias + (int)(e % N), b);
  resid8<T>(rx + e, ra + e, b, s, o);
  st8<T>(out + e, o);
}

// Launch one product with tile BM x BN: grid (N / BN, M / BM, nz), block z
// over K range [z k_chunk, (z + 1) k_chunk). With `info` set, launch
// nothing and write the kernel's resources there (core_util.cuh
// kernel_info).
template <typename T, int BM, int BN, int EPI>
int launch_gemm_mma(const T* A, const T* W, void* out, int M, int N, int K, int k_chunk, int nz,
                    const T* bias, const T* rx, const T* ra, cudaStream_t stream, int* info) {
  const auto kernel = gemm_mma_kernel<T, BM, BN, EPI>;
  const size_t smem = mma_smem_bytes<T, BM, BN>();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (info) return kernel_info(kernel, MMA_THREADS, smem, info);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nz);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(A, W, out, M, N, K, k_chunk, bias, rx, ra);
  return 0;
}

// The tile codes of ops/mma_plan.py MMA_TILES: one product with the tile
// that `tile` names (see launch_gemm_mma). Each .cu file that calls it
// instantiates the kernels it names.
template <typename T, int EPI>
int gemm_tile(int tile, const T* A, const T* W, void* out, int M, int N, int K, int k_chunk,
              int nz, const T* bias, const T* rx, const T* ra, cudaStream_t s, int* info) {
  switch (tile) {
    case 0:  // bf16 only: float32's would hold one block an SM
      if constexpr (!mma_f32<T>())
        return launch_gemm_mma<T, 128, 128, EPI>(A, W, out, M, N, K, k_chunk, nz, bias, rx, ra,
                                                 s, info);
      break;
    case 1:
      return launch_gemm_mma<T, 64, 128, EPI>(A, W, out, M, N, K, k_chunk, nz, bias, rx, ra, s,
                                              info);
  }
  return (int)cudaErrorInvalidValue;
}

// C = A W^T + b[n] (MMA_BIAS) over the full K with the tile `tile`; with
// `info`, nothing launches and info[0..3] receive the kernel's resources
template <typename T>
int gemm_bias(int tile, const T* A, const T* W, const T* bias, T* out, int M, int N, int K,
              cudaStream_t s, int* info = nullptr) {
  return gemm_tile<T, MMA_BIAS>(tile, A, W, out, M, N, K, K, 1, bias, nullptr, nullptr, s, info);
}

template <typename T>
void launch_resid_sum(const float* part, int nz, int M, int N, const T* bias, const T* rx,
                      const T* ra, T* out, cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const long long groups = mn / 8;
  resid_sum_kernel<T><<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(part, nz, mn, N, bias,
                                                                             rx, ra, out);
}

}  // namespace flair
