// Fused RMSNorm forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernel dpu_operator_tpu/ops/rmsnorm.py::_kernel
// (launched by fused_rmsnorm). Same function: per row, the mean of squares
// in fp32, then x * rsqrt(var + eps) * scale in fp32, one cast to x's type.
//
// Bound on the card: bytes. Each row is read once from device memory and
// written once (2 * rows * D * elt + D * elt for the scale); the arithmetic
// is a handful of fp32 operations per element. Design: one block of 256
// threads per row, 16-byte vector loads, a warp-shuffle reduction and one
// shared-memory step across the 8 warps. The second pass re-reads the row,
// which the first pass has just brought into L1, so device memory still
// sees each byte once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  using P = port::Pack<T, VEC>;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const P* xr = reinterpret_cast<const P*>(x + base);
  const P* sr = reinterpret_cast<const P*>(scale);
  P* orow = reinterpret_cast<P*>(out + base);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xr[i];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const float f = port::to_f(p.v[c]);
      ss += f * f;
    }
  }
  __shared__ float part[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = port::warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? part[lane] : 0.f;
    v = port::warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xr[i];
    const P s = sr[i];
    P o;
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      o.v[c] = port::from_f<T>(port::to_f(p.v[c]) * r * port::to_f(s.v[c]));
    orow[i] = o;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, int vectorized, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vectorized) {
    rmsnorm_kernel<T, kVec><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(out), d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(out), d, eps);
  }
  return cudaGetLastError();
}

// Does nothing: its time under graph replay is the card's floor for one
// launch, against which the serving shapes' few-microsecond norms are read.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// x, out: (rows, d) contiguous; scale: (d,). dtype: 0 fp32, 1 bf16.
// vectorized: 1 when d * elt is a multiple of 16 bytes and all three
// pointers are 16-byte aligned (the wrapper checks). Returns the launch's
// cudaGetLastError() code.
int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                float eps, int dtype, int vectorized, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == port::kDtypeF32)
    return static_cast<int>(launch<float>(x, scale, out, rows, d, eps, vectorized, s));
  if (dtype == port::kDtypeBF16)
    return static_cast<int>(launch<__nv_bfloat16>(x, scale, out, rows, d, eps, vectorized, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of the empty kernel on *stream* (chip_smoke.py's launch floor).
int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* port_error_string(int code) {
  if (code == port::kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a (B, S, H, D) view";
  if (code == port::kErrRegisters)
    return "kernel compiled with too few registers for its setmaxnreg split";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
