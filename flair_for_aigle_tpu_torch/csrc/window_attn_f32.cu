// K2's float32 attention core (attn_core_f32_kernel): the middle launch of
// K2 (window_attn.cu, whose note covers K2 as a whole) on float32 tensors,
// in both attn_f32 modes, for every T from 4 to 144.
//
// Replaces the float32 case of flair_for_aigle_tpu/ops/pallas/
// window_attn.py _kernel_body (:173; plain version ops/window_attn.py
// window_attention_core_reference): s = q k^T * scale + bias (+ the -100
// shift mask); attn_f32 e = exp(min(s, 80) - 30) (the static shift, :241-
// 256), else e = exp(s - rowmax); o = (e v) / (sum e + 1e-37), all float32.
//
// Bound on the card: per (window, head) at T = 144 the core reads 55 KB of
// float32 q, k and v, writes 18 KB of o and does two T x T x 32 products,
// 2.65 MFLOP: 36 operations a byte. That is above float32's 20 (67
// TFLOP/s, no tensor cores) and below 3xTF32's 49 (a third of the tf32
// tensor cores' 495 TFLOP/s): on the tensor cores the bytes bound it, as
// long as the (T, T) scores never leave the SM.
//
// Design: K2's bf16 core (window_attn.cu) with both products float32-
// accurate on the tensor cores as 3xTF32 (core_util.cuh: each operand split
// into tf32 halves a = hi + lo, lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8).
//   - One block per (window, head), one warp per 16 query rows (T padded
//     to TP = 16 ceil(T / 16)); FULL instantiations where T = TP (144, 64,
//     16) fold every bound check away.
//   - K and V are split once a block, not once a warp: the block stages
//     them into shared memory as tf32 hi and lo bit patterns (four arrays
//     of rows padded to F_LD = 36 words, 83 KB at T = 144; 32 splits a
//     thread, after all of its eight 16-byte loads are in flight), so
//     every B fragment is plain 32-bit shared loads. q arrives by cp.async
//     as float32 rows (21 KB), and each warp splits its own 16 rows once
//     into A fragments held in registers (32 of them). 104 KB a block: two
//     blocks of 9 warps fit in the SM's 227 KB.
//   - The scores stream: one 16 x 8 key tile at a time leaves the tensor
//     cores (12 mma), becomes e through K6's score functions (s_f32 / e_of:
//     no fused multiply-add, as the reference rounds), adds to the row sum
//     and enters O += E V at once as an A fragment (acc_a_tf32, V's B
//     fragments in ld_b_pairs' row order: no shuffle; 12 mma). A thread
//     holds the q fragments, O (16 floats), one S tile, the row sums and
//     the bias two tiles ahead, read from device memory (a head's (T, T)
//     tile stays in L2); the tile loop is unrolled. attn_f32 = 0 first
//     sweeps S alone for the row max. S is tile16_f32's product in K6
//     (window_attn_bwd_f32.cu) term for term, so the forward's e and row
//     sums are K6's pass Q's bit for bit.
//   - o = O / den with the IEEE quotient, staged through the warp's own q
//     rows and stored in 16-byte rows; rows past T are never stored, keys
//     past T give e = 0.
//   - __launch_bounds__(32 * NQ, 2): at T = 144 two blocks put five warps
//     on one scheduler, which leaves 96 registers a thread; 96 are used,
//     no spill (the T = 129-143 instantiation, which no window size
//     reaches, spills 36 bytes at attn_f32 = 0).
#include <cmath>

#include "common.cuh"
#include "core_util.cuh"

namespace flair {

namespace {

constexpr int HD = 32;  // head dim

// shared bytes at tp padded tokens: q rows (float32); k and v rows split
// (tf32 hi and lo bit patterns); per token its band byte
inline size_t f32_core_smem_bytes(int tp) { return 5ull * tp * F_LD * sizeof(float) + tp; }

}  // namespace

template <int NQ, bool F32, bool FULL>
__global__ void __launch_bounds__(32 * NQ, 2)
    attn_core_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                         float* __restrict__ o, int t, int C, int ws, int ss, int nwh, int nww,
                         float scale) {
  constexpr int TP = 16 * NQ, NT = 2 * NQ, LD = F_LD;
  const int Tn = FULL ? TP : t;
  auto in_t = [&](int x) { return FULL || x < Tn; };  // token x lies before T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Qs + TP * LD);  // k hi, k lo, v hi, v lo
  uint32_t* Kl = Kh + TP * LD;
  uint32_t* Vh = Kl + TP * LD;
  uint32_t* Vl = Vh + TP * LD;
  uint8_t* bands = reinterpret_cast<uint8_t*>(Vl + TP * LD);

  const int w = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)w * Tn;
  const int C3 = 3 * C;

  // q rows by cp.async (in flight while k and v are split), 16-byte
  // chunks; rows past Tn zero
  for (int e = threadIdx.x; e < TP * 8; e += blockDim.x) {
    const int x = e >> 3, ch = e & 7;
    float* dst = Qs + x * LD + ch * 4;
    if (in_t(x))
      cp_async16(dst, qkv + (row0 + x) * C3 + h * HD + ch * 4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  // k and v rows, split once for every warp of the block: 2 TP rows of
  // eight 16-byte chunks, eight a thread, all loads in flight before the
  // first split (chunk i: k for i < 4, else v; row x, chunk ch)
  {
    const int ch = threadIdx.x & 7;
    float4 kv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = (threadIdx.x >> 3) + 4 * NQ * (i & 3);
      kv[i] = in_t(x) ? __ldg(reinterpret_cast<const float4*>(
                            qkv + (row0 + x) * C3 + ((i >> 2) + 1) * C + h * HD + ch * 4))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = (threadIdx.x >> 3) + 4 * NQ * (i & 3);
      uint4 hi, lo;
      split_tf32(kv[i].x, hi.x, lo.x);
      split_tf32(kv[i].y, hi.y, lo.y);
      split_tf32(kv[i].z, hi.z, lo.z);
      split_tf32(kv[i].w, hi.w, lo.w);
      uint32_t* dst = Kh + (i >> 2) * 2 * TP * LD + x * LD + ch * 4;
      *reinterpret_cast<uint4*>(dst) = hi;
      *reinterpret_cast<uint4*>(dst + TP * LD) = lo;
    }
  }
  const int lim = ws - ss;  // band 1 below it, band 2 from it
  for (int x = threadIdx.x; x < TP; x += blockDim.x)
    bands[x] = (uint8_t)((x >= lim * ws) | (x % ws >= lim) << 1);
  cp_async_wait<0>();
  __syncthreads();

  TF32A fq[4];  // this warp's q rows, split
  load_strip(fq, Qs + r0 * LD, lane);
  const int widx = w % (nwh * nww);
  const bool li = ss > 0 && widx / nww == nwh - 1;
  const bool lj = ss > 0 && widx % nww == nww - 1;
  const uint32_t sel = (li ? 0x0101u : 0u) | (lj ? 0x0202u : 0u);
  const int ra = r0 + g, rb = ra + 8;
  const uint32_t rowb[2] = {bands[ra] * 0x0101u, bands[rb] * 0x0101u};
  const bool even = FULL || (Tn & 1) == 0;
  // bias rows of rows g, g + 8; rows past Tn read row 0 (finite, never stored)
  const float* bhead = bias + (long long)h * Tn * Tn;
  const float* brow[2] = {bhead + (in_t(ra) ? ra * Tn : 0), bhead + (in_t(rb) ? rb * Tn : 0)};

  // sweep(body): body(j, acc, b) for each 8-key tile j of the warp's 16 x
  // TP score strip, acc = its 16 x 8 tile of Q K^T (lane (g, tq): rows g,
  // g + 8 at keys c = 8 j + 2 tq, c + 1), b[hf] the bias of row g + 8 hf at
  // keys c, c + 1, loaded two tiles ahead
  auto sweep = [&](auto body) {
    uint2 b0[2], b1[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      b0[hf] = bias_bits(brow[hf], 2 * tq, Tn, even);
      b1[hf] = bias_bits(brow[hf], 8 + 2 * tq, Tn, even);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint2 b2[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        b2[hf] = j + 2 < NT ? bias_bits(brow[hf], 8 * (j + 2) + 2 * tq, Tn, even)
                            : make_uint2(0u, 0u);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        TF32B kb;
        ld_b_bits(kb, Kh + 8 * j * LD + 8 * kk, Kl + 8 * j * LD + 8 * kk, LD, lane);
        mma_3xtf32<false>(acc, fq[kk], kb);
      }
      body(j, acc, b0);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        b0[hf] = b1[hf];
        b1[hf] = b2[hf];
      }
    }
  };

  // the row max (attn_f32 = 0): a sweep of S alone
  float m[2] = {0.f, 0.f};
  if constexpr (!F32) {
    float mx[2] = {-INFINITY, -INFINITY};
    sweep([&](int j, const float(&acc)[4], const uint2(&b)[2]) {
      const int c = 8 * j + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t d = band_diff(bands, c, rowb[hf], sel);
        if (in_t(c))
          mx[hf] = fmaxf(mx[hf], s_f32(acc[2 * hf], __uint_as_float(b[hf].x), d & 0xffu, scale));
        if (in_t(c + 1))
          mx[hf] = fmaxf(mx[hf], s_f32(acc[2 * hf + 1], __uint_as_float(b[hf].y), d >> 8, scale));
      }
    });
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float x = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      m[hf] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    }
    // the next sweep loads K's fragments again: across a warp barrier the
    // compiler cannot keep this sweep's (TP / 8 x 16 registers), which spill
    __syncwarp();
  }

  // e, the row sums and O = E V in one sweep
  float oacc[4][4] = {}, sum[2] = {0.f, 0.f};
  sweep([&](int j, const float(&acc)[4], const uint2(&b)[2]) {
    const int c = 8 * j + 2 * tq;
    float e[4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t d = band_diff(bands, c, rowb[hf], sel);
      e[2 * hf] =
          e_of<F32>(acc[2 * hf], __uint_as_float(b[hf].x), d & 0xffu, in_t(c), scale, m[hf]);
      e[2 * hf + 1] = e_of<F32>(acc[2 * hf + 1], __uint_as_float(b[hf].y), d >> 8, in_t(c + 1),
                                scale, m[hf]);
      sum[hf] += e[2 * hf] + e[2 * hf + 1];
    }
    TF32A ea;
    acc_a_tf32(ea, e);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      TF32B vb;
      ld_b_pairs_bits(vb, Vh + 8 * j * LD + 8 * n, Vl + 8 * j * LD + 8 * n, LD, lane);
      mma_3xtf32<false>(oacc[n], ea, vb);
    }
  });

  // o = O / den: staged through the warp's own q rows (read only by this
  // warp, and done with), then 16-byte rows at the head's offset
  float den[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) den[hf] = quad_sum(sum[hf]) + 1e-37f;
  __syncwarp();
  float* stage = Qs + r0 * LD;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(stage + (g + 8 * hf) * LD + 8 * n + 2 * tq) =
          make_float2(__fdiv_rn(oacc[n][2 * hf], den[hf]),
                      __fdiv_rn(oacc[n][2 * hf + 1], den[hf]));
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * 8; e += 32) {
    const int r = e >> 3, ch = e & 7, i = r0 + r;
    if (in_t(i))
      *reinterpret_cast<float4*>(o + (row0 + i) * C + h * HD + ch * 4) =
          *reinterpret_cast<const float4*>(stage + r * LD + ch * 4);
  }
}

namespace {

template <int NQ, bool F32, bool FULL>
int launch_core(const float* qkv, const float* bias, float* o, int bnw, int t, int c, int nh,
                int ws, int ss, int nwh, int nww, cudaStream_t stream, int* info) {
  const auto kernel = attn_core_f32_kernel<NQ, F32, FULL>;
  const size_t smem = f32_core_smem_bytes(16 * NQ);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)  // the whole of the SM's memory as shared: two blocks
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (info) return kernel_info(kernel, 32 * NQ, smem, info);
  const float scale = 1.f / sqrtf((float)HD);
  kernel<<<dim3(bnw, nh), 32 * NQ, smem, stream>>>(qkv, bias, o, t, c, ws, ss, nwh, nww, scale);
  return 0;
}

// the FULL kernel where T = 16 NQ is a square (T = 16, 64, 144), else the
// one that checks its bounds
template <int NQ, bool F32>
int launch_nq(const float* qkv, const float* bias, float* o, int bnw, int t, int c, int nh,
              int ws, int ss, int nwh, int nww, cudaStream_t stream, int* info) {
  if constexpr (NQ == 1 || NQ == 4 || NQ == 9) {
    if (t == 16 * NQ)
      return launch_core<NQ, F32, true>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, stream,
                                        info);
  }
  return launch_core<NQ, F32, false>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, stream,
                                     info);
}

template <bool F32>
int core_mode(const float* qkv, const float* bias, float* o, int bnw, int t, int c, int nh,
              int ws, int ss, int nwh, int nww, cudaStream_t s, int* info) {
#define FLAIR_CORE_NQ(NQ) \
  case NQ:                \
    return launch_nq<NQ, F32>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, s, info);
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

}  // namespace

int attn_core_f32(const float* qkv, const float* bias, float* o, int bnw, int t, int c, int nh,
                  int ws, int ss, int nwh, int nww, int attn_f32, cudaStream_t s, int* info) {
  return attn_f32 ? core_mode<true>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, s, info)
                  : core_mode<false>(qkv, bias, o, bnw, t, c, nh, ws, ss, nwh, nww, s, info);
}

}  // namespace flair
