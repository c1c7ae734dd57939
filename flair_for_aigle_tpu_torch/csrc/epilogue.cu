// K4: fused zonal epilogue — x4 align-corners bilinear upsample of the
// stride-4 logits, margin crop, and argmax (uint8, ties to the lowest class)
// or class_prob (round(softmax * 255) per class, uint8).
//
// Replaces flair_for_aigle_tpu/ops/pallas/epilogue.py (_build_argmax_call
// :119 / _body_argmax :51, _build_class_prob_calls :149 / bodies :79, :106,
// upsample_crop_convert :184).
//
// The TPU kernel expresses the upsample as R @ L_k @ C interpolation matmuls
// (an MXU device). Each output pixel only ever touches a 2 x 2 neighbourhood,
// so here the two-tap rows then two-tap columns interpolation runs directly
// in float32, with the same float32 weights (host tables built in float64
// and rounded, exactly as _interp_matrix does) and the same summation order
// as the matmuls (rows, then columns).
//
// Bound on the card: bytes (one read of the logits, one write of the
// labels: 12.95 MB at the zonal batch, 0.0039 ms at 3.35 TB/s), though the
// float32 column taps and the running argmax (about six operations a pixel
// and class) come close behind. Design (the plan is ops/epilogue.py
// epilogue_plan, a function of h4, the scale and the margin):
//   - One block a tile of tr output rows by gt groups of P adjacent output
//     pixels of one image, a thread a group (inner = 432, P = 4: 4 rows by
//     216 columns, 216 of the 256 threads).
//   - The block stages the source rows and columns its tile needs, all K
//     classes, into shared memory as 16-byte cp.async copies, all in
//     flight at once (8-element chunks from a column aligned to 8; past w4
//     zeros), and meanwhile loads its tile's row taps into shared memory
//     and each thread its pixels' column weights into registers.
//   - Separable, row taps first: each row tap ta = wra L[ra, c] + wrb L[rb,
//     c] is computed once per (output row, staged column, class), float32,
//     into shared memory; then each thread takes its P pixels' column taps
//     from those values. A group's P pixels reach at most three
//     neighbouring source columns (P = 4 needs a scale of at least 3, else
//     the plan takes P = 2), so each pixel is u = v0 w0 + v1 w1 + v2 w2
//     over the group's three row taps, with weights (wca, wcb, 0) or (0,
//     wca, wcb) from the host: fma(v2, w2, fma(v1, w1, v0 w0)) is exactly
//     fma(tb, wcb, ta wca) either way, the two-tap value.
//   - The thread keeps a running (max, argmax) per pixel in registers over
//     the class loop and writes its P labels as one P-byte store (byte
//     stores where inner is not a multiple of P, and past the last pixel).
//   - class_prob: the online softmax statistics pass and the write pass
//     both read the staged row taps (no per-pixel K-array); the write pass
//     stores P bytes a class plane.
#include "common.cuh"
#include "core_util.cuh"

namespace flair {

constexpr int EPI_THREADS = 256;
// resident blocks per SM the launch bounds promise (40 registers a thread;
// a zonal block's 31 KB of shared memory allows 7)
constexpr int EPI_MIN_BLOCKS = 6;

// dynamic shared bytes of a block: the staged logits [K][nr][nc] in T,
// then the row taps [tr][K][nc] in float32 (nc a multiple of 8: each
// staged row is a whole number of 16-byte chunks)
template <typename T> inline size_t epi_smem_bytes(int k, int tr, int nc, int nr) {
  return (size_t)k * nr * nc * sizeof(T) + (size_t)tr * k * nc * sizeof(float);
}

namespace {

// two neighbouring staged values (c even) as float32
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(bf16_lo(w), bf16_hi(w));
}

// one pixel from its group's three row taps
__device__ __forceinline__ float col_tap(float v0, float v1, float v2, const float (&w)[3]) {
  return __fmaf_rn(v2, w[2], __fmaf_rn(v1, w[1], __fmul_rn(v0, w[0])));
}

// P labels at `dst` (one P-byte store where `packed`, else bytes up to `n`)
template <int P>
__device__ __forceinline__ void store_labels(uint8_t* dst, const uint32_t (&q)[P], bool packed,
                                             int n) {
  if (packed) {
    if constexpr (P == 4)
      *reinterpret_cast<uint32_t*>(dst) = q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24;
    else
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(q[0] | q[1] << 8);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (p < n) dst[p] = (uint8_t)q[p];
  }
}

}  // namespace

// Tables (ops/epilogue.py epilogue_plan): row_loc[i] = (ra, rb) of output
// row i relative to its tile's first staged row, row_w[i] = (wra, wrb);
// row_tile[t] = (first source row, rows) staged by row tile t; col_start[t]
// the first staged column of column tile t (a multiple of 8); group_base[g]
// group g's first row tap relative to its tile's first staged column;
// col_w[3 (P g + p) + o] pixel P g + p's weight of that row tap + o.
template <typename T, int P, bool PROB>
__global__ void __launch_bounds__(EPI_THREADS, EPI_MIN_BLOCKS)
epilogue_kernel(const T* __restrict__ logits, const int2* __restrict__ row_loc,
                const float2* __restrict__ row_w, const int2* __restrict__ row_tile,
                const int* __restrict__ col_start, const int* __restrict__ group_base,
                const float* __restrict__ col_w, uint8_t* __restrict__ out, int K, int h4,
                int w4, int inner, int tr, int gt, int nc, int nr) {
  extern __shared__ float4 epi_smem[];
  __shared__ int2 s_loc[EPI_THREADS];  // the tile's rows' (ra, rb) and (wra, wrb)
  __shared__ float2 s_w[EPI_THREADS];
  T* S = reinterpret_cast<T*>(epi_smem);
  float* RT = reinterpret_cast<float*>(S + (size_t)K * nr * nc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int2 rows = row_tile[rt];  // first staged source row, rows staged
  const int cs = col_start[ct];
  const int i0 = rt * tr, n_rows = min(tr, inner - i0);
  const long long plane = (long long)h4 * w4;
  const T* src = logits + (long long)b * K * plane + (long long)rows.x * w4 + cs;

  // stage [K][rows.y][nc]: 8-element chunks as 16-byte cp.async copies,
  // all in flight at once, where w4 keeps every row 16-byte aligned and
  // the chunk lies inside the row; else element by element
  const int nv = nc / 8, items = K * rows.y * nv;
  const bool vec_ok = w4 % 8 == 0;
  // quotients of small integers (items < 2^20) by float reciprocals, off
  // the true quotient by far less than the half-step margin
  const float inv_nv = 1.f / nv, inv_rows = 1.f / rows.y;
  for (int it = tid; it < items; it += EPI_THREADS) {
    const int kr = (int)((it + 0.5f) * inv_nv), v = it - kr * nv;
    const int k = (int)((kr + 0.5f) * inv_rows), r = kr - k * rows.y;
    const T* from = src + k * plane + (long long)r * w4 + 8 * v;
    T* to = S + ((size_t)k * nr + r) * nc + 8 * v;
    const int col = cs + 8 * v;
    if (vec_ok && col + 8 <= w4) {
#pragma unroll
      for (int h = 0; h < (int)(8 * sizeof(T) / 16); ++h)
        cp_async16(reinterpret_cast<uint4*>(to) + h, reinterpret_cast<const uint4*>(from) + h);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) to[e] = col + e < w4 ? from[e] : from_f<T>(0.f);
    }
  }
  cp_async_commit();
  if (tid < n_rows) {
    s_loc[tid] = row_loc[i0 + tid];
    s_w[tid] = row_w[i0 + tid];
  }
  // this thread's pixels of the column-tap phase, while the copies land
  const int r = tid / gt, gl = tid - r * gt;
  const int g = ct * gt + gl, j0 = P * g;
  const bool mine = r < n_rows && j0 < inner;
  float w[P][3];
  int base = 0;
  if (mine) {
    base = group_base[g];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int o = 0; o < 3; ++o) w[p][o] = __ldg(col_w + 3 * (j0 + p) + o);
  }
  cp_async_wait<0>();
  __syncthreads();

  // row taps [tr][K][nc], a warp a (row, class), two columns a lane
  int rr = 0, k = warp;
  while (k >= K) k -= K, ++rr;
  for (; rr < n_rows;) {
    const int2 loc = s_loc[rr];
    const float2 wr = s_w[rr];
    const T* sa = S + ((size_t)k * nr + loc.x) * nc;
    const T* sb = S + ((size_t)k * nr + loc.y) * nc;
    float* d = RT + ((size_t)rr * K + k) * nc;
    for (int c = 2 * lane; c < nc; c += 64) {
      const float2 a = ld2(sa + c), bb = ld2(sb + c);
      *reinterpret_cast<float2*>(d + c) =
          make_float2(__fmaf_rn(wr.y, bb.x, __fmul_rn(wr.x, a.x)),
                      __fmaf_rn(wr.y, bb.y, __fmul_rn(wr.x, a.y)));
    }
    for (k += EPI_THREADS / 32; k >= K;) k -= K, ++rr;
  }
  __syncthreads();

  // column taps: thread (r, gl) owns pixels P g .. P g + P - 1 of row i0 + r
  if (!mine) return;
  const int i = i0 + r;
  const float* t = RT + (size_t)r * K * nc + base;
  const int left = inner - j0;
  const bool packed = inner % P == 0;
  auto taps = [&](int k, float (&u)[P]) {
    const float* tk = t + (size_t)k * nc;
    const float v0 = tk[0], v1 = tk[1], v2 = tk[2];
#pragma unroll
    for (int p = 0; p < P; ++p) u[p] = col_tap(v0, v1, v2, w[p]);
  };
  float m[P], u[P];
  uint32_t q[P];
  taps(0, m);
  if constexpr (!PROB) {
#pragma unroll
    for (int p = 0; p < P; ++p) q[p] = 0;
#pragma unroll 4
    for (int k = 1; k < K; ++k) {
      taps(k, u);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (u[p] > m[p]) q[p] = k;
        m[p] = fmaxf(m[p], u[p]);
      }
    }
    store_labels<P>(out + ((long long)b * inner + i) * inner + j0, q, packed, left);
  } else {
    // class_prob: s = sum_k exp(u_k - m), taken online as the reference's
    // stats pass does (s = s exp(m - mn) + exp(u - mn), mn = max(m, u)); one
    // of the two exponentials is exp(0) = 1, so one expf a class
    float s[P];
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = 1.f;
#pragma unroll 2
    for (int k = 1; k < K; ++k) {
      taps(k, u);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float mn = fmaxf(m[p], u[p]);
        const float e = expf(fminf(m[p], u[p]) - mn);
        s[p] = u[p] > m[p] ? s[p] * e + 1.f : s[p] + e;
        m[p] = mn;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = 255.f / s[p];
    uint8_t* o = out + (((long long)b * K) * inner + i) * inner + j0;
    const long long npix = (long long)inner * inner;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      taps(k, u);
#pragma unroll
      for (int p = 0; p < P; ++p) q[p] = (uint32_t)(int)rintf(expf(u[p] - m[p]) * s[p]) & 0xffu;
      store_labels<P>(o + k * npix, q, packed, left);
    }
  }
}

namespace {

template <typename T, int P, bool PROB>
int epi_launch(const void* logits, const void* row_loc, const void* row_w, const void* row_tile,
               const void* col_start, const void* group_base, const void* col_w, void* out,
               int b, int k, int h4, int w4, int inner, int tr, int gt, int nc, int nr,
               int col_tiles, int row_tiles, cudaStream_t s, int* info) {
  const auto kernel = epilogue_kernel<T, P, PROB>;
  const size_t smem = epi_smem_bytes<T>(k, tr, nc, nr);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (info) return kernel_info(kernel, EPI_THREADS, smem, info);
  const dim3 grid(col_tiles, row_tiles, b);
  kernel<<<grid, EPI_THREADS, smem, s>>>(
      (const T*)logits, (const int2*)row_loc, (const float2*)row_w, (const int2*)row_tile,
      (const int*)col_start, (const int*)group_base, (const float*)col_w, (uint8_t*)out, k, h4,
      w4, inner, tr, gt, nc, nr);
  return (int)cudaGetLastError();
}

// the instantiation of dtype (0 float32, 1 bf16), P (4 or 2) and output
template <typename... A> int epi_dispatch(int dtype, int p, int class_prob, A... a) {
  if (p != 4 && p != 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (p == 4) return class_prob ? epi_launch<float, 4, true>(a...) : epi_launch<float, 4, false>(a...);
    return class_prob ? epi_launch<float, 2, true>(a...) : epi_launch<float, 2, false>(a...);
  }
  if (p == 4) return class_prob ? epi_launch<bf16, 4, true>(a...) : epi_launch<bf16, 4, false>(a...);
  return class_prob ? epi_launch<bf16, 2, true>(a...) : epi_launch<bf16, 2, false>(a...);
}

}  // namespace

}  // namespace flair

using namespace flair;

// tables and tr, gt, nc, nr, col_tiles, row_tiles, p: ops/epilogue.py
// epilogue_plan
extern "C" int epilogue_fwd(const void* logits, const void* row_loc, const void* row_w,
                            const void* row_tile, const void* col_start, const void* group_base,
                            const void* col_w, void* out, int b, int k, int h4, int w4,
                            int inner, int tr, int gt, int nc, int nr, int col_tiles,
                            int row_tiles, int p, int class_prob, int dtype, void* stream) {
  return epi_dispatch(dtype, p, class_prob, logits, row_loc, row_w, row_tile, col_start,
                      group_base, col_w, out, b, k, h4, w4, inner, tr, gt, nc, nr, col_tiles,
                      row_tiles, (cudaStream_t)stream, (int*)nullptr);
}

// the resources of the kernel of `dtype`, P = p and the output type at K =
// k classes and the plan's tr, nc, nr: out = int[4] registers, local bytes,
// shared bytes, blocks per SM
extern "C" int epilogue_info(int dtype, int p, int class_prob, int k, int tr, int nc, int nr,
                             int* out) {
  return epi_dispatch(dtype, p, class_prob, (const void*)nullptr, (const void*)nullptr,
                      (const void*)nullptr, (const void*)nullptr, (const void*)nullptr,
                      (const void*)nullptr, (const void*)nullptr, (void*)nullptr, 0, k, 0, 0, 0,
                      tr, 0, nc, nr, 0, 0, (cudaStream_t)0, out);
}
