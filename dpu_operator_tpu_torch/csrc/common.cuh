// Helpers shared by the port's hand-written kernels (sm_90a, plain C ABI).
//
// Element types are float (dtype code 0) and __nv_bfloat16 (dtype code 1);
// every kernel computes in fp32 and rounds once on the way out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace port {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a bf16 cast in torch
}

// VEC contiguous elements moved as one aligned load/store (16 bytes when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace port
