// Fused RMSNorm forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernel dpu_operator_tpu/ops/rmsnorm.py::_kernel
// (launched by fused_rmsnorm). Same function: per row, the mean of squares
// in fp32, then x * rsqrt(var + eps) * scale in fp32, one cast to x's type.
//
// Bound on the card: bytes. Each row is read once from device memory and
// written once (2 * rows * D * elt + D * elt for the scale); the arithmetic
// is a handful of fp32 operations per element. Two routes, chosen by shape
// alone (the wrapper's _rms_pieces: D, the type and the alignment, never
// the row count), so a row's arithmetic depends on that row and D only: a
// row normalized in a batch of any size, on any grid, equals the same row
// normalized alone bit for bit (chunked prefill equals whole prefill, and
// decode_step the generate loop, through the norms too).
// * warp (rows of at most 32 * 8 16-byte pieces in bf16, D <= 2048, or
//   32 * 12 in fp32, D <= 1536): rmsnorm_warp_kernel<T, NP>, one warp a
//   row, each lane holding NP 16-byte pieces of it (pieces lane, lane + 32,
//   ...) in registers between the sum and the scaling, so x is read once.
//   The lane's pieces of `scale` are loaded once a warp and kept across its
//   rows. The grid of one-warp blocks is sized to the card (the SMs times
//   the blocks an SM holds) and each warp walks rows warp, warp + warps,
//   ...; the next row's loads are issued before the current row is reduced
//   and stored, so two rows a warp are in flight. No block-wide barrier,
//   no shared memory. Fewer rows than SMs (decode's 8) take
//   rmsnorm_rowblock_kernel<T, NP> instead, NP warps a row, whose
//   arithmetic is the same to the bit (piece_squares, scale_piece, the
//   same order of sums), so the row count picks the faster launch and
//   never the result. (The block-per-row design these replace, the first one: 256
//   threads a row, a quarter of them idle at D 1536 in bf16, one load in
//   flight a thread, two block barriers a row, x and scale read twice.)
// * block (longer rows, or rows not in aligned 16-byte pieces):
//   rmsnorm_block_kernel, one block of 256 threads a row, a warp-shuffle
//   reduction and one shared-memory step across the 8 warps; its second
//   pass re-reads the row, which the first has just brought into L1.
#include "common.cuh"

namespace {

constexpr int kBlockThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     T* __restrict__ out, int d, float eps) {
  using P = port::Pack<T, VEC>;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const P* xr = reinterpret_cast<const P*>(x + base);
  const P* sr = reinterpret_cast<const P*>(scale);
  P* orow = reinterpret_cast<P*>(out + base);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kBlockThreads) {
    const P p = xr[i];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const float f = port::to_f(p.v[c]);
      ss += f * f;
    }
  }
  __shared__ float part[kBlockThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = port::warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kBlockThreads / 32 ? part[lane] : 0.f;
    v = port::warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += kBlockThreads) {
    const P p = xr[i];
    const P s = sr[i];
    P o;
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      o.v[c] = port::from_f<T>(port::to_f(p.v[c]) * r * port::to_f(s.v[c]));
    orow[i] = o;
  }
}

// The warp layout's arithmetic, which both of its kernels take, so that a
// row's result does not depend on which one ran: piece i = lane + 32 p of
// a row (16 bytes) is summed square by square in element order, a lane's
// pieces' sums are added in piece order (0 for a piece past the row), the
// lanes' sums by a butterfly over the warp; then each element is scaled
// as x * r * scale in fp32 and rounded once.
template <typename T, int VEC>
__device__ __forceinline__ float piece_squares(const port::Pack<T, VEC>& x) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const float f = port::to_f(x.v[c]);
    s = fmaf(f, f, s);
  }
  return s;
}

template <typename T, int VEC>
__device__ __forceinline__ port::Pack<T, VEC> scale_piece(const port::Pack<T, VEC>& x,
                                                          const port::Pack<T, VEC>& s,
                                                          float r) {
  port::Pack<T, VEC> o;
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    o.v[c] = port::from_f<T>(port::to_f(x.v[c]) * r * port::to_f(s.v[c]));
  return o;
}

// One warp a row, NP 16-byte pieces a lane (piece lane + 32 p of the row;
// those at or past the row's d / VEC pieces are not touched). A block is
// one warp, so the rows spread over the SMs first. Each piece's squares
// are their own chain, so a lane's NP chains run side by side.
template <typename T, int NP>
__global__ void __launch_bounds__(32)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = port::Pack<T, VEC>;
  const int lane = threadIdx.x;
  const int nvec = d / VEC;

  auto load = [&](const P* src, P (&dst)[NP]) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (lane + 32 * p < nvec) dst[p] = src[lane + 32 * p];
  };
  int row = blockIdx.x;
  P cur[NP], s[NP];
  load(reinterpret_cast<const P*>(x + static_cast<size_t>(row) * d), cur);
  load(reinterpret_cast<const P*>(scale), s);  // once a warp
  for (; row < rows; row += gridDim.x) {
    P nxt[NP];
    const int next = row + gridDim.x;
    if (next < rows)  // in flight while this row is reduced and stored
      load(reinterpret_cast<const P*>(x + static_cast<size_t>(next) * d), nxt);
    float part[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) part[p] = lane + 32 * p < nvec ? piece_squares(cur[p]) : 0.f;
    float ss = part[0];
#pragma unroll
    for (int p = 1; p < NP; ++p) ss += part[p];
    ss = port::warp_sum(ss);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    P* orow = reinterpret_cast<P*>(out + static_cast<size_t>(row) * d);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (lane + 32 * p < nvec) orow[lane + 32 * p] = scale_piece(cur[p], s[p], r);
#pragma unroll
    for (int p = 0; p < NP; ++p) cur[p] = nxt[p];
  }
}

// The same arithmetic with NP warps a row, one piece a thread (warp p holds
// piece lane + 32 p), one block a row: for fewer rows than SMs, where the
// chain of one warp's NP pieces a lane, not the bytes, sets the time (8
// decode rows at D 1536 in bf16: 1.79 us on one warp a row against 1.69
// for the block-per-row design, NVIDIA H100 80GB HBM3). A shared-memory
// step hands the pieces' sums to warp 0, which adds them in piece order.
template <typename T, int NP>
__global__ void __launch_bounds__(NP * 32)
rmsnorm_rowblock_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = port::Pack<T, VEC>;
  __shared__ float parts[NP][32];
  __shared__ float rs;
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int i = lane + 32 * p;
  const bool live = i < d / VEC;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  P xp, sp;
  if (live) {
    xp = reinterpret_cast<const P*>(x + base)[i];
    sp = reinterpret_cast<const P*>(scale)[i];
  }
  parts[p][lane] = live ? piece_squares(xp) : 0.f;
  __syncthreads();
  if (p == 0) {
    float ss = parts[0][lane];
#pragma unroll
    for (int q = 1; q < NP; ++q) ss += parts[q][lane];
    ss = port::warp_sum(ss);
    if (lane == 0) rs = rsqrtf(ss / static_cast<float>(d) + eps);
  }
  __syncthreads();
  if (live) reinterpret_cast<P*>(out + base)[i] = scale_piece(xp, sp, rs);
}

// SMs of the current device, read once a device.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The warp layout: fewer rows than SMs take one block a row, more rows the
// persistent warps (the same arithmetic either way).
template <typename T, int NP>
cudaError_t launch_warp(const T* x, const T* scale, T* out, int rows, int d,
                        float eps, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (rows < sms) {
    rmsnorm_rowblock_kernel<T, NP><<<rows, NP * 32, 0, stream>>>(x, scale, out, d, eps);
    return cudaGetLastError();
  }
  static int per_sm = 0;  // one-warp blocks an SM holds, read once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_warp_kernel<T, NP>, 32, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  const int blocks = rows < sms * per_sm ? rows : sms * per_sm;
  rmsnorm_warp_kernel<T, NP><<<blocks, 32, 0, stream>>>(x, scale, out, rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const void* sv, void* ov, int rows, int d,
                   float eps, int vectorized, int pieces, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* scale = static_cast<const T*>(sv);
  T* out = static_cast<T*>(ov);
  if (pieces > 0) {  // the warp route: rows of whole aligned pieces
    if (!vectorized || d % kVec != 0 || d / kVec > 32 * pieces)
      return cudaErrorInvalidValue;
    switch (pieces) {
      case 1: return launch_warp<T, 1>(x, scale, out, rows, d, eps, stream);
      case 2: return launch_warp<T, 2>(x, scale, out, rows, d, eps, stream);
      case 4: return launch_warp<T, 4>(x, scale, out, rows, d, eps, stream);
      case 6: return launch_warp<T, 6>(x, scale, out, rows, d, eps, stream);
      case 8: return launch_warp<T, 8>(x, scale, out, rows, d, eps, stream);
      case 12:  // fp32 only: bf16 at 12 pieces spills (ptxas: 255 registers)
        if constexpr (sizeof(T) == 4)
          return launch_warp<T, 12>(x, scale, out, rows, d, eps, stream);
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  }
  if (vectorized)
    rmsnorm_block_kernel<T, kVec><<<rows, kBlockThreads, 0, stream>>>(x, scale, out, d, eps);
  else
    rmsnorm_block_kernel<T, 1><<<rows, kBlockThreads, 0, stream>>>(x, scale, out, d, eps);
  return cudaGetLastError();
}

// Does nothing: its time under graph replay is the card's floor for one
// launch, against which the serving shapes' few-microsecond norms are read.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// x, out: (rows, d) contiguous; scale: (d,). dtype: 0 fp32, 1 bf16.
// vectorized: 1 when d * elt is a multiple of 16 bytes and all three
// pointers are 16-byte aligned (the wrapper checks). pieces: the warp
// route's 16-byte pieces a lane (1, 2, 4, 6, 8, or 12 in fp32; vectorized
// rows of at most 32 * pieces pieces), or 0 for the block route. Returns the
// launch's cudaGetLastError() code.
int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                float eps, int dtype, int vectorized, int pieces, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == port::kDtypeF32)
    return static_cast<int>(launch<float>(x, scale, out, rows, d, eps, vectorized, pieces, s));
  if (dtype == port::kDtypeBF16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, scale, out, rows, d, eps, vectorized, pieces, s));
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
