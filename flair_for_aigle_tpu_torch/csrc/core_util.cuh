// Helpers of the mma.sync attention cores (K2's forward cores in
// window_attn.cu and window_attn_f32.cu, K6's backward cores in
// window_attn_bwd.cu and window_attn_bwd_f32.cu): cp.async copies, ldmatrix
// and mma.sync.m16n8k16 fragments, bf16 pair arithmetic with explicit
// rounding, read-only loads, 3xTF32 products on mma.sync.m16n8k8 with
// their split fragments, the float32 cores' scores, a quad's 4 x 4
// transpose (16-byte epilogue stores), and a kernel's resources. Also used
// by gemm_mma.cuh and the A/B tool's attn_dots.cu.
#pragma once

#include "common.cuh"

namespace flair {

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b on one m16n8k16 tile: bf16 in, float32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to one bf16 pair, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 values of a pair as float32
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// loads through the read-only path, volatile so that the compiler keeps each
// where it is written: the score loop prefetches the bias a fixed number of
// tiles ahead instead of hoisting every tile's load into registers
__device__ __forceinline__ uint32_t ldg_b16(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg_b32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ldg_b64(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.b32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// the bits of bias[j], bias[j + 1] (0 past tn), one load where the pair is
// aligned: a float pair, or one bf16 pair with bias[j] in the low half
__device__ __forceinline__ uint2 bias_bits(const float* p, int j, int tn, bool even) {
  if (j >= tn) return make_uint2(0u, 0u);
  if (even) return ldg_b64(p + j);
  return make_uint2(ldg_b32(p + j), j + 1 < tn ? ldg_b32(p + j + 1) : 0u);
}

__device__ __forceinline__ uint32_t bias_bits(const bf16* p, int j, int tn, bool even) {
  if (j >= tn) return 0u;
  if (even) return ldg_b32(p + j);
  const uint32_t lo = ldg_b16(p + j);
  return j + 1 < tn ? lo | ldg_b16(p + j + 1) << 16 : lo;
}

constexpr uint32_t BF16X2_NEG_INF = 0xff80ff80u;  // -inf in both halves
constexpr uint32_t BF16_MINUS_100 = 0xc2c8u;      // -100, exact in bf16

// bf16 pair arithmetic with the rounding written out: an op without it may
// be fused with its neighbour (a mul and an add into one fma, one rounding)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// ---- 3xTF32: float32-accurate products on the tf32 tensor cores ----

// x rounded to tf32 (10 fraction bits) to nearest, ties away from zero, on
// the bits: what cvt.rna.tf32.f32 gives for a finite x, with the low 13
// bits cleared (a NaN whose payload lies only in those bits becomes an
// infinity)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact):
// the pair holds x to 2^-22 of its magnitude
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// split m16n8k8 fragments: A (16 x 8) four registers a lane, B (8 x 8) two
struct TF32A {
  uint32_t hi[4], lo[4];
};
struct TF32B {
  uint32_t hi[2], lo[2];
};

// d += a b on one m16n8k8 tile: tf32 in, float32 accumulate
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: a_lo b_hi, a_hi b_lo, then a_hi b_hi, small terms
// first, into one float32 accumulator (each product to about 2^-21 of its
// magnitude). MIRROR issues the two small terms the other way round (a_hi
// b_lo first): the transposed product b^T a^T then sums the same three
// terms of every element in the same order as a b.
template <bool MIRROR>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const TF32A& a, const TF32B& b) {
  if (MIRROR) {
    mma_1688(d, a.hi, b.lo[0], b.lo[1]);
    mma_1688(d, a.lo, b.hi[0], b.hi[1]);
  } else {
    mma_1688(d, a.lo, b.hi[0], b.hi[1]);
    mma_1688(d, a.hi, b.lo[0], b.lo[1]);
  }
  mma_1688(d, a.hi, b.hi[0], b.hi[1]);
}

// the A fragment of the 16 x 8 block a(r, k) = p[r * ld + k], split: lane
// (g, t) = (lane / 4, lane % 4) holds rows g, g + 8 at columns t, t + 4
__device__ __forceinline__ void ld_a_tf32(TF32A& f, const float* p, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(p[g * ld + t], f.hi[0], f.lo[0]);
  split_tf32(p[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split_tf32(p[g * ld + t + 4], f.hi[2], f.lo[2]);
  split_tf32(p[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
}

// the B fragment of the 8 x 8 block b(k, n) = p[n * ld + k] (column n of B
// is row n of p), split: lane (g, t) holds column g at rows t, t + 4
__device__ __forceinline__ void ld_b_tf32(TF32B& f, const float* p, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(p[g * ld + t], f.hi[0], f.lo[0]);
  split_tf32(p[g * ld + t + 4], f.hi[1], f.lo[1]);
}

// an A fragment straight from a 16 x 8 float32 accumulator tile c (lane
// (g, t): c[0], c[1] at row g, columns 2t, 2t + 1; c[2], c[3] at row
// g + 8), its k order taken as it lies: k = t is column 2t, k = t + 4 is
// column 2t + 1. A product sums over k, so only the B fragment has to
// follow that order (ld_b_pairs_tf32); no shuffle is needed.
__device__ __forceinline__ void acc_a_tf32(TF32A& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

// the B fragment b(k, n) = p[row(k) * ld + n] in acc_a_tf32's k order:
// lane (g, t) holds column g at rows 2t (k = t) and 2t + 1 (k = t + 4)
__device__ __forceinline__ void ld_b_pairs_tf32(TF32B& f, const float* p, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(p[2 * t * ld + g], f.hi[0], f.lo[0]);
  split_tf32(p[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
}

// ld_b_tf32's and ld_b_pairs_tf32's fragments from operands split ahead:
// the tf32 bit patterns split_tf32 made, hi at `hi`, lo at `lo`, rows of ld
__device__ __forceinline__ void ld_b_bits(TF32B& f, const uint32_t* hi, const uint32_t* lo,
                                          int ld, int lane) {
  const int i = (lane >> 2) * ld + (lane & 3);
  f.hi[0] = hi[i];
  f.lo[0] = lo[i];
  f.hi[1] = hi[i + 4];
  f.lo[1] = lo[i + 4];
}

__device__ __forceinline__ void ld_b_pairs_bits(TF32B& f, const uint32_t* hi, const uint32_t* lo,
                                                int ld, int lane) {
  const int i = 2 * (lane & 3) * ld + (lane >> 2);
  f.hi[0] = hi[i];
  f.lo[0] = lo[i];
  f.hi[1] = hi[i + ld];
  f.lo[1] = lo[i + ld];
}

// ---- the float32 cores' scores (K2's window_attn_f32.cu, K6's
// window_attn_bwd_f32.cu) ----

// float32 rows of a head (32 floats) in shared memory are padded to F_LD:
// lane (g, t) of an A or B fragment then reads bank (4 g + t) mod 32, and of
// a B fragment over the row pair (2 t, 2 t + 1) bank (8 t + g) or
// (8 t + g + 4) mod 32, no conflicts
constexpr int F_LD = 36;

// the warp's 16 rows at `rows` (16 x 32, rows of F_LD) as four split A
// fragments, head dims 8 kk .. 8 kk + 7
__device__ __forceinline__ void load_strip(TF32A (&a)[4], const float* rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ld_a_tf32(a[kk], rows + 8 * kk, F_LD, lane);
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

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// bits 0 and 8: whether cols c and c + 1 lie in another compared band than
// the row (rowb: the row's band byte in both bytes; sel: the bands compared
// in this window, bit 0 the grid's last row, bit 1 its last column)
__device__ __forceinline__ uint32_t band_diff(const uint8_t* bands, int c, uint32_t rowb,
                                              uint32_t sel) {
  return sel ? (*reinterpret_cast<const uint16_t*>(bands + c) ^ rowb) & sel : 0u;
}

// the float32 score s = acc * scale + bias (- 100 where the bands differ),
// the float32 ops one at a time, as the reference rounds them (no fused
// multiply-add)
__device__ __forceinline__ float s_f32(float acc, float b, bool differ, float scale) {
  float s = __fadd_rn(__fmul_rn(acc, scale), b);
  if (differ) s = __fadd_rn(s, -100.f);
  return s;
}

// attn_f32: e = exp(min(s, 80) - 30) of the float32 score, 0 past Tn
__device__ __forceinline__ float e_f32(float acc, float b, bool differ, bool in, float scale) {
  return in ? expf(fminf(s_f32(acc, b, differ, scale), 80.f) - 30.f) : 0.f;
}

// e of one element (acc: its product, b: its bias, differ: whether its
// bands differ, in: whether its column lies before T, else 0): attn_f32
// exp(min(s, 80) - 30); else exp(s - m), m its query row's max
template <bool F32>
__device__ __forceinline__ float e_of(float acc, float b, bool differ, bool in, float scale,
                                      float m) {
  if constexpr (F32)
    return e_f32(acc, b, differ, in, scale);
  else
    return in ? expf(__fsub_rn(s_f32(acc, b, differ, scale), m)) : 0.f;
}

}  // namespace

// the kernel's registers, local bytes a thread, shared bytes and resident
// blocks per SM at `threads` threads and `dyn` bytes of dynamic shared memory
template <typename K>
inline int kernel_info(K kernel, int threads, size_t dyn, int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + dyn);
  out[3] = blocks;
  return 0;
}

}  // namespace flair
