// K8: fused swin-block finish — window reverse + crop + un-shift (+ss roll)
// + residual + LayerNorm + MLP + residual:
//
//   attn = roll(window_reverse(win)[:, :H, :W], +ss)
//   x2   = rnd(x + attn);  ln = LN(x2) (float32 statistics)
//   out  = (x2 + b2) + GELU(rnd(rnd(ln W1^T) + b1)) W2^T
//
// Replaces flair_for_aigle_tpu/ops/pallas/finish.py (_build_call :41, body
// :52-88, fused_reverse_ln_mlp_residual :166). Windows (B*nW, ws*ws, C) of
// the padded (nwh*ws, nww*ws) grid; shortcut and output (B, H, W, C).
//
// Bound on the card: the two products, 4 N C hidden operations, against
// 989 TFLOP/s in bf16; in float32 against 67 TFLOP/s (the SIMT peak), or a
// third of the tf32 tensor cores' 495 (3xTF32). Design: after a gather
// pass, K3's own path (ffn.cu), so that the fused and the unfused block
// run the same products:
//   - The gather pass resolves, for each output token (b, r, c), the
//     cropped source row q = (r - ss) mod H and column p = (c - ss) mod W
//     (the un-shift is taken modulo the CROPPED size, so no pad row or
//     column is ever read), then window (q / ws, p / ws) at in-window token
//     (q % ws) * ws + p % ws, and reads that window row directly: the
//     reversed, cropped and rolled raster never exists. A token goes to a
//     group of lanes, 16 bytes a lane (lanes.cuh, as K1 walks its raster:
//     this pass is the inverse of K1's partition). It writes the gathered
//     row a and the LayerNorm row of x2 = rnd(x + a); x2's values stay in
//     registers between the statistics and the write. The LayerNorm's
//     scale and bias sit in shared memory (8 KB at C = 1024), so a lane's
//     registers hold one token.
//   - fc1 and fc2 are gemm_mma.cuh gemm_mlp, as in K3: fc1's epilogue adds
//     b1 and applies GELU; fc2's (MMA_RESID) forms (rnd(x + a) + b2) +
//     acc, which is the reference's (x2 + b2) + acc bit for bit, or K is
//     cut into float32 partials that resid_sum_kernel adds in order (the
//     plan is ops/ffn.py mlp_plan, shared with K3).
// The LN rows, a and the (N, hidden) activations round-trip device memory
// in the compute dtype (the TPU kernel kept them in VMEM); the gather pass
// moves 4 N C elements (x and a row in, a and ln out).
#include "common.cuh"
#include "gemm_mma.cuh"
#include "lanes.cuh"

namespace flair {

constexpr int FIN_THREADS = 256;
// resident blocks per SM the gather pass's launch bounds promise, from the
// values F = V VEC a lane holds of a token (x2 in registers): 4 up to 8
// (64 registers), 3 up to 16 (85), else 2 (128)
template <typename T, int V> __host__ __device__ constexpr int fin_min_blocks() {
  return V * (16 / (int)sizeof(T)) <= 8 ? 4 : V * (16 / (int)sizeof(T)) <= 16 ? 3 : 2;
}

// One token a group of G lanes, V vectors a lane (lanes.cuh).
template <typename T, int G, int V>
__global__ void __launch_bounds__(FIN_THREADS, (fin_min_blocks<T, V>()))
finish_gather_kernel(const T* __restrict__ win, const T* __restrict__ x,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ ln, T* __restrict__ a_out, int H, int W, int C, int ws,
                     int ss, int nwh, int nww, float eps, int n) {
  constexpr int VEC = 16 / (int)sizeof(T);
  extern __shared__ float4 prm[];  // scale, then bias
  for (int i = threadIdx.x; i < C / 4; i += FIN_THREADS) {
    prm[i] = reinterpret_cast<const float4*>(scale)[i];
    prm[C / 4 + i] = reinterpret_cast<const float4*>(bias)[i];
  }
  __syncthreads();
  const int gl = threadIdx.x % G;
  // token indices in 32 bits (the wrapper keeps n below 2^31)
  const int row = blockIdx.x * (FIN_THREADS / G) + threadIdx.x / G;
  if (row >= n) return;  // a whole group at once: the shuffles stay within it
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int nv = C / VEC;
  const int hw = H * W;
  const int b = row / hw, rem = row - b * hw;
  const int r = rem / W, c = rem - r * W;
  int q = r - ss, p = c - ss;  // the cropped source row and column
  if (q < 0) q += H;
  if (p < 0) p += W;
  const int qw = q / ws, pw = p / ws;
  const int w_idx = (b * nwh + qw) * nww + pw;
  const T* ar = win + ((long long)w_idx * ws * ws + (q - qw * ws) * ws + (p - pw * ws)) * C;
  const T* xr = x + (long long)row * C;
  uint4 xa[V], aa[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = gl + G * k;
    xa[k] = aa[k] = make_uint4(0, 0, 0, 0);
    if (j < nv) {
      xa[k] = *reinterpret_cast<const uint4*>(xr + j * VEC);
      aa[k] = *reinterpret_cast<const uint4*>(ar + j * VEC);
    }
  }
  float v[V][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = gl + G * k;
    float xv[VEC];
    unpack16<T>(xa[k], xv);
    unpack16<T>(aa[k], v[k]);
    if (j < nv) {
      *reinterpret_cast<uint4*>(a_out + (long long)row * C + j * VEC) = aa[k];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[k][e] = rnd<T>(xv[e] + v[k][e]);
        s += v[k][e];
      }
    }
  }
  const float mean = group_sum<G>(s, mask) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (gl + G * k < nv)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[k][e] - mean;
        sq += d * d;
      }
  const float rstd = 1.f / sqrtf(group_sum<G>(sq, mask) / (float)C + eps);
  T* dst = ln + (long long)row * C;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = gl + G * k;
    if (j >= nv) continue;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 g4 = prm[(j * VEC + e) / 4], b4 = prm[(C + j * VEC + e) / 4];
      const float g[4] = {g4.x, g4.y, g4.z, g4.w}, bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) v[k][e + t] = (v[k][e + t] - mean) * rstd * g[t] + bb[t];
    }
    *reinterpret_cast<uint4*>(dst + j * VEC) = pack16<T>(v[k]);
  }
}

namespace {

template <typename T>
int finish_impl(const void* win, const void* x, const void* lns, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, void* ln, void* a, void* h,
                void* part, void* out, int b, int H, int W, int c, int hidden, int ws, int ss,
                int g, int v, int tile1, int tile2, int k_chunk2, int nz2, float eps,
                cudaStream_t s) {
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  const long long n = (long long)b * H * W;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // tokens are 32-bit in the kernel
  int e = prep_dispatch<T>(g, v, [&](auto G, auto V) {
    constexpr int g_ = decltype(G)::value;
    const long long blocks = (n + FIN_THREADS / g_ - 1) / (FIN_THREADS / g_);
    finish_gather_kernel<T, g_, decltype(V)::value><<<(unsigned)blocks, FIN_THREADS, 8 * c, s>>>(
        (const T*)win, (const T*)x, (const float*)lns, (const float*)lnb, (T*)ln, (T*)a, H, W, c,
        ws, ss, nwh, nww, eps, (int)n);
    return 0;
  });
  if (!e)
    e = gemm_mlp<T>((const T*)ln, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
                    (const T*)x, (const T*)a, (T*)h, (float*)part, (T*)out, (int)n, c, hidden,
                    tile1, tile2, k_chunk2, nz2, s);
  return e ? e : (int)cudaGetLastError();
}

template <typename T> int finish_info_impl(int g, int v, int* out) {
  return prep_dispatch<T>(g, v, [&](auto G, auto V) {
    return kernel_info(finish_gather_kernel<T, decltype(G)::value, decltype(V)::value>,
                       FIN_THREADS, 8 * 1024, out);
  });
}

}  // namespace

}  // namespace flair

using namespace flair;

// g, v: ops/prep.py prep_group; tile1, tile2, k_chunk2, nz2: ops/ffn.py
// mlp_plan; part: fc2's float32 partials (nz2 x n x c) when nz2 > 1
extern "C" int finish_fwd(const void* win, const void* x, const void* lns, const void* lnb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          void* ln, void* a, void* h, void* part, void* out, int b, int H, int W,
                          int c, int hidden, int ws, int ss, int g, int v, int tile1, int tile2,
                          int k_chunk2, int nz2, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return finish_impl<float>(win, x, lns, lnb, w1, b1, w2, b2, ln, a, h, part, out, b, H, W, c,
                              hidden, ws, ss, g, v, tile1, tile2, k_chunk2, nz2, eps, s);
  return finish_impl<bf16>(win, x, lns, lnb, w1, b1, w2, b2, ln, a, h, part, out, b, H, W, c,
                           hidden, ws, ss, g, v, tile1, tile2, k_chunk2, nz2, eps, s);
}

// the resources of the gather pass with group width g and v vectors a lane
// in `dtype` (at C = 1024's shared bytes): out = int[4] registers, local
// bytes, shared bytes, blocks per SM
extern "C" int finish_info(int dtype, int g, int v, int* out) {
  return dtype == 0 ? finish_info_impl<float>(g, v, out) : finish_info_impl<bf16>(g, v, out);
}
