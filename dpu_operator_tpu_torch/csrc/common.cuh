// Helpers shared by the port's hand-written kernels (sm_90a, plain C ABI).
//
// Element types are float (dtype code 0) and __nv_bfloat16 (dtype code 1);
// every kernel computes in fp32 and rounds once on the way out. The int8 KV
// cache (KV8) is read as int8_t, converted to fp32 exactly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace port {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

// The port's own error codes, past cudaError_t's range (port_error_string
// names them): a refused TMA tensor map, and a tensor-core kernel whose
// register count cannot fund its producer / consumer register split.
constexpr int kErrTensorMap = 10001;
constexpr int kErrRegisters = 10002;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
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

// Copy rows [0, nrows) x D of a strided (S, D) slice into shared memory as
// fp32 rows of D + 4 floats (the pad keeps float4 reads of neighbouring rows
// on different banks); rows past `valid` are zero-filled. The attention
// kernels stage every Q / K / V / dO tile with it.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long row_stride, int nrows,
                                           int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kPerRow = D / VEC;
  using P = Pack<T, VEC>;
  for (int idx = threadIdx.x; idx < nrows * kPerRow; idx += NT) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * VEC;
    float* d = dst + r * (D + 4) + c;
    if (r < valid) {
      const P p = *reinterpret_cast<const P*>(src + r * row_stride + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = to_f(p.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = 0.f;
    }
  }
}

// `DPL` consecutive fp32 values from shared memory (one lane's output
// columns of a staged row), as one vector load where the width allows.
template <int DPL>
__device__ __forceinline__ void load_cols(float (&dst)[DPL], const float* src) {
  if constexpr (DPL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (DPL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < DPL; ++c) dst[c] = src[c];
  }
}

// Partial dot products of kRows broadcast rows (a, stride S floats) against
// two per-lane rows (b0, b1) over D: acc[r][t] += a[r] . b_t. Every row is
// D + 4 floats apart, so float4 reads stay conflict-free.
template <int kRows, int D>
__device__ __forceinline__ void dot_rows2(float (&acc)[kRows][2], const float* a,
                                          const float* b0, const float* b1) {
  constexpr int S = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(b0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(b1 + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(a + r * S + d);
      acc[r][0] = fmaf(y.x, x0.x, acc[r][0]);
      acc[r][0] = fmaf(y.y, x0.y, acc[r][0]);
      acc[r][0] = fmaf(y.z, x0.z, acc[r][0]);
      acc[r][0] = fmaf(y.w, x0.w, acc[r][0]);
      acc[r][1] = fmaf(y.x, x1.x, acc[r][1]);
      acc[r][1] = fmaf(y.y, x1.y, acc[r][1]);
      acc[r][1] = fmaf(y.z, x1.z, acc[r][1]);
      acc[r][1] = fmaf(y.w, x1.w, acc[r][1]);
    }
  }
}

// Round to T's precision and back: where the reference rounds an fp32
// intermediate to the input type before a product.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

}  // namespace port
