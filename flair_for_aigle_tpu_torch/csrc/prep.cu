// K1: fused swin-block prologue — LayerNorm (float32 statistics) + cyclic
// shift by -ss + zero pad to a window multiple + window partition.
//
// Replaces flair_for_aigle_tpu/ops/pallas/prep.py (_build_call :40,
// fused_ln_shift_partition :146). Input (B, H, W, C) NHWC, output
// (B*nW, ws*ws, C): padded row r of the shifted raster reads source row
// (r + ss) % H (columns alike); rows or columns past H / W are zeros.
//
// Bound on the card: bytes (one read of the activation, one write of the
// windows; ~8 flops per element). Design (the plan is ops/prep.py
// prep_plan, a function of C, the dtype, the SM count and the token count):
//   - 16-byte vectors throughout. A token goes to a group of G lanes
//     (G = min(32, the power of two at or above C / VEC), VEC = 8 bf16 or
//     4 float32 values a vector); lane l of a group owns the vectors l,
//     l + G, ... (V of them), so neighbouring lanes touch neighbouring 16
//     bytes (lanes.cuh, shared with K8's gather pass). bf16 C = 128: 16
//     lanes, two tokens a warp; C = 1024: 32 lanes
//     of 4 vectors; float32 C = 1024: 32 lanes of 8. The mean and the
//     two-pass variance reduce by __shfl_xor_sync within the group; the
//     values stay in registers between the statistics and the write, so x
//     is read once.
//   - The lane's float32 scale and bias slice loads once per thread, into
//     registers where a lane holds at most 16 values of a token; past
//     that (bf16 C > 512, float32 C > 256) the registers would cut the
//     SM to one block of 8 warps, so the block copies scale and bias into
//     shared memory once instead (8 KB at C = 1024).
//   - Persistent groups: the grid is at most one wave of the blocks the
//     launch bounds promise; group g walks the units g, g + groups, ... of
//     `run` consecutive positions of the padded raster, (b * hp + r) * wp +
//     c. Along a unit the window indices and the source column advance by
//     increments (the source column wraps at most once); divisions happen
//     once a unit and once a raster row. Each group issues the next
//     token's loads before it reduces the current one, where a lane holds
//     at most 16 values of a token; past that the registers of a second
//     token would cost a resident block, which the stage-4 sizes (few
//     tokens, latency-bound) need more, so the loads follow the write.
//   - Padded tokens take 16-byte zero stores and no loads.
//   - Registers hold a token's raw bits, F = V * VEC values a lane (twice
//     where the next token's loads go ahead), and the scale and bias slice
//     where F <= 16. The launch bounds promise 4 blocks of 256 threads an
//     SM for F <= 8 (64 registers), 3 past F = 16 (85), else 2 (128;
//     ops/prep.py prep_min_blocks). In flight an SM then holds, beside the
//     stores: bf16 C = 128, each of 4 x 16 groups' next token, 64 x 256
//     bytes = 16 KB; bf16 C = 512, 2 x 8 groups' next 1 KB token, 16 KB;
//     C = 1024, 3 x 8 groups' current 2 KB (bf16) or 4 KB (float32) token,
//     48 or 96 KB (prep_info reports the registers, spill and blocks per
//     SM the card gives each instantiation).
#include "common.cuh"
#include "core_util.cuh"
#include "lanes.cuh"

namespace flair {

constexpr int PREP_THREADS = 256;

// the values F = V * VEC that a lane holds of each token
template <typename T, int V> __host__ __device__ constexpr int prep_floats() {
  return V * (16 / (int)sizeof(T));
}
// whether scale and bias go to shared memory (else registers), and the
// next token's loads wait for the current token's write (else they go
// ahead of its reduction)
template <typename T, int V> __host__ __device__ constexpr bool prep_shared_params() {
  return prep_floats<T, V>() > 16;
}
// resident blocks per SM that the launch bounds promise
template <typename T, int V> __host__ __device__ constexpr int prep_min_blocks() {
  return prep_floats<T, V>() <= 8 ? 4 : prep_shared_params<T, V>() ? 3 : 2;
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(PREP_THREADS, (prep_min_blocks<T, V>()))
prep_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C, int ws,
            int ss, float eps, int hp, int wp, int nwh, int nww, int run, int n_pos) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int gl = threadIdx.x % G;
  const int group = (blockIdx.x * PREP_THREADS + threadIdx.x) / G;
  const int groups = gridDim.x * (PREP_THREADS / G);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int nv = C / VEC;

  // scale and bias, once: this lane's vectors gl + G k (those below nv)
  // in registers, or all of them in shared memory (scale, then bias)
  constexpr bool SHARED = prep_shared_params<T, V>();
  extern __shared__ float4 prm[];
  float sc[SHARED ? 1 : V][VEC], bi[SHARED ? 1 : V][VEC];
  if constexpr (SHARED) {
    for (int i = threadIdx.x; i < C / 4; i += PREP_THREADS) {
      prm[i] = reinterpret_cast<const float4*>(scale)[i];
      prm[C / 4 + i] = reinterpret_cast<const float4*>(bias)[i];
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = gl + G * k;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f), b = s;
        if (j < nv) {
          s = *reinterpret_cast<const float4*>(scale + j * VEC + e);
          b = *reinterpret_cast<const float4*>(bias + j * VEC + e);
        }
        sc[k][e] = s.x, sc[k][e + 1] = s.y, sc[k][e + 2] = s.z, sc[k][e + 3] = s.w;
        bi[k][e] = b.x, bi[k][e + 1] = b.y, bi[k][e + 2] = b.z, bi[k][e + 3] = b.w;
      }
    }
  }

  // the position in the padded raster: image b, row r (window row wr,
  // row tr within it), column c (wc, tc); source row sr and column scol;
  // positions left in the unit
  int u = group, p = u * run;
  if (p >= n_pos) return;
  int left, b, r, c, wr, tr, wc, tc, sr, scol;
  auto seek = [&](int q) {
    const int row = q / wp;
    c = q - row * wp;
    b = row / hp;
    r = row - b * hp;
    wr = r / ws, tr = r - wr * ws;
    wc = c / ws, tc = c - wc * ws;
    sr = (r + ss) % H;
    scol = (c + ss) % W;
  };
  // to the next position of the group's walk; false past its last unit
  auto advance = [&]() -> bool {
    if (--left == 0) {
      u += groups;
      p = u * run;
      if (p >= n_pos) return false;
      seek(p);
      left = min(run, n_pos - p);
      return true;
    }
    if (++c == wp) {
      seek((b * hp + r + 1) * wp);  // a new raster row: once every wp positions
      return true;
    }
    if (++tc == ws) tc = 0, ++wc;
    if (++scol == W) scol = 0;
    return true;
  };
  auto dst_of = [&]() -> long long {
    return ((((long long)b * nwh + wr) * nww + wc) * ws * ws + tr * ws + tc) * C;
  };
  auto load = [&](uint4 (&raw)[V]) {
    const T* src = x + ((long long)(b * H + sr) * W + scol) * C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = gl + G * k;
      if (j < nv) raw[k] = *reinterpret_cast<const uint4*>(src + j * VEC);
    }
  };

  seek(p);
  left = min(run, n_pos - p);
  uint4 cur[V], nxt[V];  // a lane's vectors past nv stay zero
#pragma unroll
  for (int k = 0; k < V; ++k) cur[k] = nxt[k] = make_uint4(0, 0, 0, 0);
  bool pad = r >= H || c >= W;
  long long dst = dst_of();
  if (!pad) load(cur);
  bool more, pad_n;
  long long dst_n;
  auto next = [&](uint4 (&into)[V]) {  // the walk's next token: its place and its loads
    more = advance();
    pad_n = more && (r >= H || c >= W);
    dst_n = more ? dst_of() : 0;
    if (more && !pad_n) load(into);
  };
  for (;;) {
    if constexpr (!SHARED) next(nxt);
    T* o = out + dst;
    if (pad) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = gl + G * k;
        if (j < nv) *reinterpret_cast<uint4*>(o + j * VEC) = make_uint4(0, 0, 0, 0);
      }
    } else {
      float v[V][VEC];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        unpack16<T>(cur[k], v[k]);
        if (gl + G * k < nv)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s += v[k][e];
      }
      const float mean = group_sum<G>(s, mask) / (float)C;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (gl + G * k < nv)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float d = v[k][e] - mean;
            q += d * d;
          }
      const float rstd = 1.f / sqrtf(group_sum<G>(q, mask) / (float)C + eps);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = gl + G * k;
        if (j < nv) {
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            float g[4], bb[4];
            if constexpr (SHARED) {
              const float4 g4 = prm[(j * VEC + e) / 4], b4 = prm[(C + j * VEC + e) / 4];
              g[0] = g4.x, g[1] = g4.y, g[2] = g4.z, g[3] = g4.w;
              bb[0] = b4.x, bb[1] = b4.y, bb[2] = b4.z, bb[3] = b4.w;
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t) g[t] = sc[k][e + t], bb[t] = bi[k][e + t];
            }
#pragma unroll
            for (int t = 0; t < 4; ++t)
              v[k][e + t] = (v[k][e + t] - mean) * rstd * g[t] + bb[t];
          }
          *reinterpret_cast<uint4*>(o + j * VEC) = pack16<T>(v[k]);
        }
      }
    }
    if constexpr (SHARED) next(cur);  // the current token is written: its registers are free
    if (!more) break;
    if constexpr (!SHARED)
#pragma unroll
      for (int k = 0; k < V; ++k) cur[k] = nxt[k];
    pad = pad_n;
    dst = dst_n;
  }
}

namespace {

template <typename T>
int prep_impl(const void* x, const void* scale, const void* bias, void* out, int b, int h, int w,
              int c, int ws, int ss, float eps, int g, int v, int run, int blocks,
              cudaStream_t s) {
  const int hp = h + (ws - h % ws) % ws;
  const int wp = w + (ws - w % ws) % ws;
  const long long n_pos = (long long)b * hp * wp;  // positions are 32-bit in the kernel
  if (n_pos > 0x7fffffffLL - (long long)run * blocks * PREP_THREADS) return (int)cudaErrorInvalidValue;
  const int e = prep_dispatch<T>(g, v, [&](auto G, auto V) {
    constexpr int g_ = decltype(G)::value, v_ = decltype(V)::value;
    const size_t smem = prep_shared_params<T, v_>() ? 8 * c : 0;
    prep_kernel<T, g_, v_><<<blocks, PREP_THREADS, smem, s>>>(
        (const T*)x, (const float*)scale, (const float*)bias, (T*)out, h, w, c, ws, ss, eps, hp,
        wp, hp / ws, wp / ws, run, (int)n_pos);
    return 0;
  });
  return e ? e : (int)cudaGetLastError();
}

template <typename T> int prep_info_impl(int g, int v, int* out) {
  return prep_dispatch<T>(g, v, [&](auto G, auto V) {
    constexpr int v_ = decltype(V)::value;
    return kernel_info(prep_kernel<T, decltype(G)::value, v_>, PREP_THREADS,
                       prep_shared_params<T, v_>() ? 8 * 1024 : 0, out);
  });
}

}  // namespace

}  // namespace flair

using namespace flair;

// g, v, run, blocks: ops/prep.py prep_plan
extern "C" int prep_fwd(const void* x, const void* scale, const void* bias, void* out, int b,
                        int h, int w, int c, int ws, int ss, float eps, int g, int v, int run,
                        int blocks, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return prep_impl<float>(x, scale, bias, out, b, h, w, c, ws, ss, eps, g, v, run,
                                          blocks, s);
  return prep_impl<bf16>(x, scale, bias, out, b, h, w, c, ws, ss, eps, g, v, run, blocks, s);
}

// the resources of the kernel with group width g and v vectors a lane in
// `dtype`: out = int[4] registers, local bytes, shared bytes, blocks per SM
extern "C" int prep_info(int dtype, int g, int v, int* out) {
  return dtype == 0 ? prep_info_impl<float>(g, v, out) : prep_info_impl<bf16>(g, v, out);
}
