// 16-byte lane groups over the channels of a token, shared by K1 (prep.cu,
// which walks the padded raster) and K8's gather pass (finish.cu, which
// walks the output raster): a token goes to a group of G lanes (G = min(32,
// the power of two at or above C / VEC), VEC = 8 bf16 or 4 float32 values
// a 16-byte vector), lane l of a group owns the vectors l, l + G, ... (V of
// them), so neighbouring lanes touch neighbouring 16 bytes (ops/prep.py
// prep_group).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "core_util.cuh"

namespace flair {

// the VEC values of a 16-byte vector as float32, and back
template <typename T> __device__ __forceinline__ void unpack16(const uint4& r, float* v) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(w[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = bf16_lo(w[e]);
      v[2 * e + 1] = bf16_hi(w[e]);
    }
  }
}

template <typename T> __device__ __forceinline__ uint4 pack16(const float* v) {
  if constexpr (std::is_same<T, float>::value)
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  else
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
}

// the sum over a group of G lanes (G a power of two, groups aligned in the warp)
template <int G> __device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// f(G, V) on the kernel of the plan's group width and vectors a lane: V =
// 1 at any G, or G = 32 with up to 1024 / (32 VEC) vectors
template <typename T, typename F> int prep_dispatch(int g, int v, F&& f) {
  using std::integral_constant;
  if (v == 1) {
    switch (g) {
      case 1: return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
      case 2: return f(integral_constant<int, 2>{}, integral_constant<int, 1>{});
      case 4: return f(integral_constant<int, 4>{}, integral_constant<int, 1>{});
      case 8: return f(integral_constant<int, 8>{}, integral_constant<int, 1>{});
      case 16: return f(integral_constant<int, 16>{}, integral_constant<int, 1>{});
      case 32: return f(integral_constant<int, 32>{}, integral_constant<int, 1>{});
    }
    return (int)cudaErrorInvalidValue;
  }
  if (g != 32) return (int)cudaErrorInvalidValue;
  switch (v) {
    case 2: return f(integral_constant<int, 32>{}, integral_constant<int, 2>{});
    case 3: return f(integral_constant<int, 32>{}, integral_constant<int, 3>{});
    case 4: return f(integral_constant<int, 32>{}, integral_constant<int, 4>{});
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (v) {
      case 5: return f(integral_constant<int, 32>{}, integral_constant<int, 5>{});
      case 6: return f(integral_constant<int, 32>{}, integral_constant<int, 6>{});
      case 7: return f(integral_constant<int, 32>{}, integral_constant<int, 7>{});
      case 8: return f(integral_constant<int, 32>{}, integral_constant<int, 8>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flair
