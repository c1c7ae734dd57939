// K9: a ConvNeXt block's 7x7 depthwise convolution, its bias and the
// LayerNorm that follows, on NHWC tensors:
//
//   out = LN(dwconv7x7(x) + b_dw) * w_ln + b_ln     (zero padding 3, eps the block's)
//
// The ConvNeXt family's blocks (models/convnext.py); the JAX package runs
// this on XLA's convolution, with no Pallas kernel. The 49 taps and the bias
// are summed in float32 (taps and bias rounded to T first, as the layers
// round their parameters at use), the statistics are taken in float32 from
// those sums, and each output is rounded once to T and written contiguous.
//
// Bound on the card: below the ridge. Per element it reads and writes T
// once and does 49 float32 FMAs on the CUDA cores; no tensor-core form fits
// a per-channel filter. Design (the plan is ops/dw_ln.py dw_ln_plan, a
// function of the shapes, the dtype and the SM count):
//   - A tile is th x tw output pixels of one image and all C channels, so
//     each pixel's LayerNorm finds every channel in the block and nothing
//     goes back to device memory between the conv and the norm. The blocks
//     are persistent: block i takes tiles i, i + grid, ...
//   - A block walks each tile's C in chunks of cc channels. A chunk's
//     (th + 6) x (tw + 6) input halo (zeros past the image) and its 49 taps
//     (ops/dw_ln.py dw_ln_taps: [C / 8][49][8] float32, rounded to T) land
//     in shared memory as 16-byte cp.async copies, channel-vector major
//     ([cv][pixel][8], a channel vector's stride odd in 16-byte units). Two
//     buffers: the next chunk's copies, the next tile's first among them,
//     are in flight while the block computes the current one and while it
//     normalises a finished tile.
//   - A thread computes 4 neighbouring channels (half a channel vector of
//     8) for a vertical strip of DW_ROWS output pixels: per tap column kx
//     it holds the 7 taps' weights in registers and walks the strip's
//     DW_ROWS + 6 halo rows once, each staged value feeding every output
//     row it reaches. The tap columns are unrolled too, so the next
//     column's loads start while this one's FMAs run (117 registers; 6 %
//     faster over ConvNeXt-B's 36 blocks on the H100 than a rolled loop).
//     Lane pairs of a warp take the two halves of one channel vector,
//     neighbouring pairs neighbouring columns: their halo reads are
//     consecutive bytes and their weight reads two addresses.
//   - The float32 results stay in shared memory across the chunks ([pixel]
//     [C + 4], the pad keeping neighbouring pixels' rows off one bank);
//     then a group of g lanes a pixel (g the power of two at or above C / 8,
//     at most 32) takes the mean and the variance over C (two passes, as
//     the plain version) and writes the normalised row once, 16 bytes a
//     lane.
#include "common.cuh"
#include "core_util.cuh"

namespace flair {

constexpr int DW_THREADS = 256;
// resident blocks per SM the launch bounds promise (at most 128 registers
// a thread); the plan's shared memory decides how many of them fit
constexpr int DW_MIN_BLOCKS = 2;
constexpr int DW_ROWS = 4;  // output rows of a thread's strip
constexpr int DW_TAPS = 49;

// shared bytes of one of a block's two buffers: the halo [cc / 8][hpix +
// 1][8] in T and the taps [cc / 8][49][8] in float32
template <typename T>
__host__ __device__ inline size_t dw_buffer_bytes(int th, int tw, int cc) {
  const size_t hp1 = (size_t)(th + 6) * (tw + 6) + 1;
  return (size_t)(cc / 8) * (hp1 * 8 * sizeof(T) + DW_TAPS * 8 * sizeof(float));
}

// dynamic shared bytes of a block: the two buffers, then the results [th *
// tw][c + 4] in float32
template <typename T> inline size_t dw_smem_bytes(int th, int tw, int cc, int c) {
  return 2 * dw_buffer_bytes<T>(th, tw, cc) + (size_t)th * tw * (c + 4) * sizeof(float);
}

namespace {

// 4 channels at p as float32
__device__ __forceinline__ void ld4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(u.x), v[1] = bf16_hi(u.x), v[2] = bf16_lo(u.y), v[3] = bf16_hi(u.y);
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// 8 float32 values of global memory through the read-only path
__device__ __forceinline__ void ldg8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// 8 values rounded to T at p
__device__ __forceinline__ void st8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the sum of v over this lane's group of g lanes (g a power of two)
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace

// x and out (B, H, W, C) contiguous, C a multiple of 8; taps (C / 8, 49, 8)
// float32 (ops/dw_ln.py dw_ln_taps), b_dw, ln_w, ln_b (C) float32. Tiles of
// tw = 1 << tw_log columns by th = DW_ROWS << ts_log rows, tiles_x by
// tiles_y an image, tile t of image t / (tiles_x tiles_y); a 1-D grid of
// persistent blocks.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS, DW_MIN_BLOCKS)
dw_ln_kernel(const T* __restrict__ x, const float* __restrict__ taps,
             const float* __restrict__ b_dw, const float* __restrict__ ln_w,
             const float* __restrict__ ln_b, T* __restrict__ out, int B, int H, int W, int C,
             int tw_log, int ts_log, int cc, int tiles_x, int tiles_y, float eps) {
  extern __shared__ float4 dw_smem[];
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte copy
  constexpr int PIECES = 8 / VEC;      // 16-byte copies of a channel vector
  const int tw = 1 << tw_log, th = DW_ROWS << ts_log;
  const int hw = tw + 6, hpix = (th + 6) * hw, hp1 = hpix + 1;
  const int strips_log = tw_log + ts_log;
  const size_t halo_elems = (size_t)(cc >> 3) * hp1 * 8;
  const size_t buf_floats = dw_buffer_bytes<T>(th, tw, cc) / sizeof(float);
  float* res = reinterpret_cast<float*>(dw_smem) + 2 * buf_floats;
  const int rstride = C + 4;
  const int tid = threadIdx.x;
  const int tiles_img = tiles_x * tiles_y, n_tiles = B * tiles_img;
  const int n_chunks = (C + cc - 1) / cc;
  // quotients of small integers (below 2^20) by float reciprocals, off the
  // true quotient by far less than the half-step margin
  const float inv_hw = 1.f / (float)hw;

  // the copies of chunk k of tile t into buffer bi, one committed group:
  // consecutive threads on consecutive 16 bytes of one pixel's channels,
  // then the chunk's taps (contiguous, ncv * 49 * 8 floats)
  auto stage = [&](int t, int k, int bi) {
    T* halo = reinterpret_cast<T*>(reinterpret_cast<float*>(dw_smem) + bi * buf_floats);
    float4* wsm = reinterpret_cast<float4*>(halo + halo_elems);
    const int img = t / tiles_img, rt = t - img * tiles_img;
    const int ty = rt / tiles_x, y0 = ty * th, x0 = (rt - ty * tiles_x) << tw_log;
    const int c0 = k * cc, ncv = min(cc, C - c0) >> 3;
    const int per_pix = ncv * PIECES;
    const float inv_pp = 1.f / (float)per_pix;
    const T* xb = x + (size_t)img * H * W * C + c0;
    for (int it = tid; it < hpix * per_pix; it += DW_THREADS) {
      const int p = (int)((it + 0.5f) * inv_pp), q = it - p * per_pix;
      const int hy = (int)((p + 0.5f) * inv_hw), hx = p - hy * hw;
      const int yy = y0 - 3 + hy, xx = x0 - 3 + hx;
      const int cv = q / PIECES;
      T* dst = halo + ((size_t)cv * hp1 + p) * 8 + (q - cv * PIECES) * VEC;
      if ((unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W)
        cp_async16(dst, xb + ((size_t)yy * W + xx) * C + q * VEC);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    const float4* wc = reinterpret_cast<const float4*>(taps + (size_t)c0 * DW_TAPS);
    for (int j = tid; j < ncv * 2 * DW_TAPS; j += DW_THREADS) cp_async16(wsm + j, wc + j);
    cp_async_commit();
  };

  int t = blockIdx.x;
  if (t >= n_tiles) return;
  stage(t, 0, 0);
  int bi = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const int img = t / tiles_img, rt = t - img * tiles_img;
    const int ty = rt / tiles_x, y0 = ty * th, x0 = (rt - ty * tiles_x) << tw_log;
    for (int k = 0; k < n_chunks; ++k, bi ^= 1) {
      // chunk k has landed, and every thread is done with the other buffer
      // (the previous chunk) and with the previous tile's results
      cp_async_wait<0>();
      __syncthreads();
      if (k + 1 < n_chunks)
        stage(t, k + 1, bi ^ 1);
      else if (t + (int)gridDim.x < n_tiles)
        stage(t + gridDim.x, 0, bi ^ 1);
      const T* halo = reinterpret_cast<const T*>(reinterpret_cast<const float*>(dw_smem) +
                                                 bi * buf_floats);
      const float* wsm = reinterpret_cast<const float*>(halo + halo_elems);
      const int c0 = k * cc, ncv = min(cc, C - c0) >> 3;
      // item i: half i & 1 of channel vector i >> (strips_log + 1), strip
      // (i >> 1) & (strips - 1) at row sr, column xl
      for (int i = tid; i < ncv << (strips_log + 1); i += DW_THREADS) {
        const int half = i & 1, cv = i >> (strips_log + 1);
        const int s = (i >> 1) & ((1 << strips_log) - 1);
        const int xl = s & (tw - 1), sr = s >> tw_log;
        const T* hs = halo + ((size_t)cv * hp1 + sr * DW_ROWS * hw + xl) * 8 + half * 4;
        const float* ws = wsm + (size_t)cv * DW_TAPS * 8 + half * 4;
        float acc[DW_ROWS][4];
#pragma unroll
        for (int o = 0; o < DW_ROWS; ++o)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          float wk[7][4];
#pragma unroll
          for (int ky = 0; ky < 7; ++ky) ld4(ws + (ky * 7 + kx) * 8, wk[ky]);
#pragma unroll
          for (int r = 0; r < DW_ROWS + 6; ++r) {
            float v[4];
            ld4(hs + ((size_t)r * hw + kx) * 8, v);
#pragma unroll
            for (int ky = 0; ky < 7; ++ky) {
              const int o = r - ky;
              if (o >= 0 && o < DW_ROWS) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[o][e] = __fmaf_rn(wk[ky][e], v[e], acc[o][e]);
              }
            }
          }
        }
        const int c = c0 + 8 * cv + 4 * half;
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(b_dw + c));
        const float bv[4] = {rnd<T>(b4.x), rnd<T>(b4.y), rnd<T>(b4.z), rnd<T>(b4.w)};
#pragma unroll
        for (int o = 0; o < DW_ROWS; ++o) {
          float* r = res + (size_t)(((sr * DW_ROWS + o) << tw_log) + xl) * rstride + c;
          *reinterpret_cast<float4*>(r) = make_float4(acc[o][0] + bv[0], acc[o][1] + bv[1],
                                                      acc[o][2] + bv[2], acc[o][3] + bv[3]);
        }
      }
    }
    __syncthreads();

    // the LayerNorm: a group of g lanes a pixel, lane l of the group the
    // channel vectors l, l + g, ...; the next tile's first chunk lands
    // meanwhile. Every lane takes part in the group sums; a group past the
    // tile or the image reads the tile's last row and writes nothing.
    const int nv = C >> 3;
    const int g = nv >= 32 ? 32 : 1 << (32 - __clz(nv - 1));
    const int g_log = 31 - __clz(g), per_warp = 32 >> g_log, gl = tid & (g - 1);
    const float inv_c = 1.f / (float)C;
    for (int base = (tid >> 5) * per_warp; base < th * tw;
         base += (DW_THREADS / 32) * per_warp) {
      const int px = base + ((tid & 31) >> g_log), pc = min(px, th * tw - 1);
      const int yy = y0 + (pc >> tw_log), xx = x0 + (pc & (tw - 1));
      const float* r = res + (size_t)pc * rstride;
      float s = 0.f;
      for (int cv = gl; cv < nv; cv += g) {
        float v[8];
        ld8(r + 8 * cv, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
      const float mean = group_sum(s, g) * inv_c;
      float q = 0.f;
      for (int cv = gl; cv < nv; cv += g) {
        float v[8];
        ld8(r + 8 * cv, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[e] - mean;
          q = __fmaf_rn(d, d, q);
        }
      }
      const float rstd = rsqrtf(group_sum(q, g) * inv_c + eps);
      if (px >= th * tw || yy >= H || xx >= W) continue;
      T* o = out + (((size_t)img * H + yy) * W + xx) * C;
      for (int cv = gl; cv < nv; cv += g) {
        float v[8], w[8], bb[8];
        ld8(r + 8 * cv, v);
        ldg8(ln_w + 8 * cv, w);
        ldg8(ln_b + 8 * cv, bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fmaf_rn(__fmul_rn(v[e] - mean, rstd), w[e], bb[e]);
        st8(o + 8 * cv, v);
      }
    }
  }
}

namespace {

template <typename T>
int dw_launch(const void* x, const void* taps, const void* b_dw, const void* ln_w,
              const void* ln_b, void* out, int b, int h, int w, int c, int tw_log, int ts_log,
              int cc, int blocks, float eps, cudaStream_t s, int* info) {
  const auto kernel = dw_ln_kernel<T>;
  const int tw = 1 << tw_log, th = DW_ROWS << ts_log;
  if (c <= 0 || c % 8 || cc <= 0 || cc % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = dw_smem_bytes<T>(th, tw, cc, c);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (info) return kernel_info(kernel, DW_THREADS, smem, info);
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  kernel<<<blocks, DW_THREADS, smem, s>>>((const T*)x, (const float*)taps, (const float*)b_dw,
                                          (const float*)ln_w, (const float*)ln_b, (T*)out, b, h,
                                          w, c, tw_log, ts_log, cc, tiles_x, tiles_y, eps);
  return (int)cudaGetLastError();
}

template <typename... A> int dw_dispatch(int dtype, A... a) {
  return dtype == 0 ? dw_launch<float>(a...) : dw_launch<bf16>(a...);
}

}  // namespace

}  // namespace flair

using namespace flair;

// tw_log, ts_log, cc, blocks: ops/dw_ln.py dw_ln_plan
extern "C" int dw_ln_fwd(const void* x, const void* taps, const void* b_dw, const void* ln_w,
                         const void* ln_b, void* out, int b, int h, int w, int c, int tw_log,
                         int ts_log, int cc, int blocks, float eps, int dtype, void* stream) {
  return dw_dispatch(dtype, x, taps, b_dw, ln_w, ln_b, out, b, h, w, c, tw_log, ts_log, cc,
                     blocks, eps, (cudaStream_t)stream, (int*)nullptr);
}

// the resources of the kernel of `dtype` under the plan's tile and chunk at
// C = c: out = int[4] registers, local bytes, shared bytes, blocks per SM
extern "C" int dw_ln_info(int dtype, int tw_log, int ts_log, int cc, int c, int* out) {
  return dw_dispatch(dtype, (const void*)nullptr, (const void*)nullptr, (const void*)nullptr,
                     (const void*)nullptr, (const void*)nullptr, (void*)nullptr, 0, 0, 0, c,
                     tw_log, ts_log, cc, 0, 0.f, (cudaStream_t)0, out);
}
