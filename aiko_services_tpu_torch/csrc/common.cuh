// Shared device helpers of the port's kernels: dtype conversion and
// vectorised bf16 and int8 loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aiko {

constexpr float kNegInf = -1e30f;   // the JAX package's _NEG_INF sentinel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and widened back to float.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// N consecutive elements at src (aligned to N elements) -> float dst.
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ src,
                                         float* dst) {
  static_assert(N % 2 == 0, "bf16 loads come in pairs");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        dst[i * 8 + 2 * j] = f.x;
        dst[i * 8 + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  } else {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src));
    dst[0] = f.x;
    dst[1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float* dst) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[i];
}

// The four signed bytes of a 32-bit word, in address order.
__device__ __forceinline__ void bytes_to_float(uint32_t word, float* dst) {
  dst[0] = static_cast<float>(static_cast<int32_t>(word << 24) >> 24);
  dst[1] = static_cast<float>(static_cast<int32_t>(word << 16) >> 24);
  dst[2] = static_cast<float>(static_cast<int32_t>(word << 8) >> 24);
  dst[3] = static_cast<float>(static_cast<int32_t>(word) >> 24);
}

// N consecutive int8 codes at src (aligned to N bytes) -> float dst.
template <int N>
__device__ __forceinline__ void load_vec(const int8_t* __restrict__ src,
                                         float* dst) {
  static_assert(N == 2 || N % 4 == 0, "int8 loads of 2, 4, 8 or 16");
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      bytes_to_float(raw.x, dst + i * 16);
      bytes_to_float(raw.y, dst + i * 16 + 4);
      bytes_to_float(raw.z, dst + i * 16 + 8);
      bytes_to_float(raw.w, dst + i * 16 + 12);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      bytes_to_float(reinterpret_cast<const uint32_t*>(src)[i], dst + i * 4);
  } else {
    const char2 raw = *reinterpret_cast<const char2*>(src);
    dst[0] = static_cast<float>(raw.x);
    dst[1] = static_cast<float>(raw.y);
  }
}

}  // namespace aiko
