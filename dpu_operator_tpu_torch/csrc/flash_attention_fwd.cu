// Attention forward with a per-row query offset, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the Pallas kernel dpu_operator_tpu/ops/flash_attention.py::_kernel
// (forward, no lse; launched by flash_attention) and takes the two-phase
// causal walk of hack/flash_lab2.py::_kernel_v2 (only key blocks that cross
// the diagonal are masked). One kernel computes both the causal attention of
// a whole prompt (q_pos0 = 0, Skv = Sq) and the slotted-cache attention of
// decode, verify and chunked prefill: row i of batch b sits at absolute
// position q_pos0[b] + i and admits key j iff j <= q_pos0[b] + i (causal).
//
// Numerics follow _kernel: scores scaled into the exp2 domain
// (sm_scale * log2 e), online softmax with fp32 max / sum / accumulator, P
// rounded to the input type before the PV product, out = acc / max(l, 1e-20).
//
// Layout: q, k, v, o keep the (B, S, H, D) layout of the JAX package, and
// k / v are read through their strides, so one slot's row of the
// (slots, max_seq, H, D) cache is attended with no transpose copy.
//
// Two launch shapes:
// * tiled (Sq > 1): one block per (query tile of 32 rows, head, batch).
//   K/V tiles of 64 keys are staged in shared memory as fp32; each warp owns
//   8 query rows and each lane two keys of a tile. Key blocks past the
//   tile's last admitted position are never visited; key positions are
//   anchored at absolute key 0 and a row's arithmetic does not depend on the
//   other rows of its tile (a block that is fully masked for a row adds exact
//   zeros), so chunked prefill reproduces whole-prompt prefill row for row.
// * decode (Sq == 1): one block per (row, head, batch); the 8 warps take
//   32-key tiles in turn, each lane one key, and combine their partial
//   (max, sum, acc) in shared memory at the end. No query rows are wasted.
//
// Bound on the card: at decode, bytes (each admitted K/V row read once); at
// prefill, operations (4 * admitted pairs * D). This first version computes
// on the fp32 CUDA cores, not the tensor cores (no wgmma / TMA yet).
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos0;  // (B,) int32, device
  int B, Sq, Skv, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale2;  // sm_scale * log2(e)
};

// ---------------------------------------------------------------- tiled --
constexpr int kBQ = 32;      // query rows per block
constexpr int kBK = 64;      // keys per shared-memory tile
constexpr int kWarps = 4;    // 128 threads
constexpr int kRPW = kBQ / kWarps;  // rows per warp

template <int D>
struct TiledSmem {
  static constexpr int kStride = D + 4;  // floats; keeps float4 reads conflict-free
  static constexpr size_t kQ = static_cast<size_t>(kBQ) * kStride;
  static constexpr size_t kK = static_cast<size_t>(kBK) * kStride;
  static constexpr size_t kV = static_cast<size_t>(kBK) * kStride;
  static constexpr size_t kP = static_cast<size_t>(kWarps) * kRPW * kBK;
  static constexpr size_t kBytes = (kQ + kK + kV + kP) * sizeof(float);
};

// Copy rows [row0, row0 + n) x D of a strided (S, D) slice into shared
// memory as fp32; rows past `valid` are zero-filled.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long row_stride, int nrows,
                                           int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kPerRow = D / VEC;
  using P = port::Pack<T, VEC>;
  for (int idx = threadIdx.x; idx < nrows * kPerRow; idx += NT) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * VEC;
    float* d = dst + r * (D + 4) + c;
    if (r < valid) {
      const P p = *reinterpret_cast<const P*>(src + r * row_stride + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = port::to_f(p.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_tiled_kernel(AttnArgs a) {
  constexpr int NT = kWarps * 32;
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int S = D + 4;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + TiledSmem<D>::kQ;
  float* Vs = Ks + TiledSmem<D>::kK;
  float* Ps = Vs + TiledSmem<D>::kV;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = tile * kBQ;
  const int nrows = min(kBQ, a.Sq - r0);
  const int pos0 = a.q_pos0[b];
  const int p_lo = pos0 + r0;              // first row's absolute position
  const int p_hi = pos0 + r0 + nrows - 1;  // last row's

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + r0 * a.q_ss;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  stage_rows<T, D, NT>(Qs, q, a.q_ss, kBQ, nrows);

  const int nkb_all = (a.Skv + kBK - 1) / kBK;
  int nkb = nkb_all, n_full = a.Skv / kBK;
  if (a.causal) {
    // blocks past the tile's last admitted key contribute nothing
    nkb = min(nkb_all, p_hi / kBK + 1);
    // blocks wholly at or below the tile's FIRST row need no mask
    n_full = min(n_full, (p_lo + 1) / kBK);
  }
  n_full = min(n_full, nkb);

  float m[kRPW], l[kRPW], acc[kRPW][DPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* qw = Qs + warp * kRPW * S;
  float* pw = Ps + warp * kRPW * kBK;

  for (int kb = 0; kb < nkb; ++kb) {
    const int j0 = kb * kBK;
    const int kvalid = min(kBK, a.Skv - j0);
    __syncthreads();  // previous tile fully consumed
    stage_rows<T, D, NT>(Ks, k + j0 * a.k_ss, a.k_ss, kBK, kvalid);
    stage_rows<T, D, NT>(Vs, v + j0 * a.v_ss, a.v_ss, kBK, kvalid);
    __syncthreads();

    // scores for this warp's rows against keys lane and lane + 32
    float s[kRPW][2];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = Ks + lane * S;
    const float* k1 = Ks + (lane + 32) * S;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k0 + d);
      const float4 kc = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * S + d);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kc.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kc.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kc.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kc.w, s[r][1]);
      }
    }
    const bool masked = kb >= n_full;  // only diagonal / ragged blocks
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int row_pos = pos0 + r0 + warp * kRPW + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = j0 + lane + 32 * t;
        float sc = s[r][t] * a.scale2;
        if (masked && (j >= a.Skv || (a.causal && j > row_pos))) sc = kNegInf;
        s[r][t] = sc;
      }
      const float bm = port::warp_max(fmaxf(s[r][0], s[r][1]));
      const float m_new = fmaxf(m[r], bm);
      const float p0 = exp2f(s[r][0] - m_new);
      const float p1 = exp2f(s[r][1] - m_new);
      const float corr = exp2f(m[r] - m_new);
      l[r] = l[r] * corr + port::warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      // P enters the PV product in the input type (bf16 P on bf16 inputs)
      pw[r * kBK + lane] = port::to_f(port::from_f<T>(p0));
      pw[r * kBK + lane + 32] = port::to_f(port::from_f<T>(p1));
    }
    __syncwarp();
    for (int j = 0; j < kvalid; ++j) {
      float vv[DPL];
      const float* vr = Vs + j * S + lane * DPL;
      if constexpr (DPL == 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(vr);
        vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
      } else if constexpr (DPL == 2) {
        const float2 t2 = *reinterpret_cast<const float2*>(vr);
        vv[0] = t2.x; vv[1] = t2.y;
      } else {
#pragma unroll
        for (int c = 0; c < DPL; ++c) vv[c] = vr[c];
      }
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float pj = pw[r * kBK + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int lr = warp * kRPW + r;
    if (lr >= nrows) continue;
    T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + (r0 + lr) * a.o_ss + lane * DPL;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[c] = port::from_f<T>(acc[r][c] / denom);
  }
}

// --------------------------------------------------------------- decode --
constexpr int kDecWarps = 8;

template <typename T, int D>
__global__ void __launch_bounds__(kDecWarps * 32)
attn_decode_kernel(AttnArgs a) {
  constexpr int DPL = D / 32;
  constexpr int VEC = 16 / sizeof(T);
  using P = port::Pack<T, VEC>;
  using PV = port::Pack<T, DPL>;  // one lane's output columns of a V row
  __shared__ float qs[D];
  __shared__ float wm[kDecWarps], wl[kDecWarps];
  __shared__ float wacc[kDecWarps][D];

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + i * a.q_ss + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  for (int d = threadIdx.x; d < D; d += kDecWarps * 32) qs[d] = port::to_f(q[d]);
  __syncthreads();

  const int n_keys = a.causal ? min(a.q_pos0[b] + i + 1, a.Skv) : a.Skv;
  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  for (int t0 = warp * 32; t0 < n_keys; t0 += kDecWarps * 32) {
    const int j = t0 + lane;
    float sc = kNegInf;
    if (j < n_keys) {
      const T* kr = k + j * a.k_ss;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += VEC) {
        const P p = *reinterpret_cast<const P*>(kr + d);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qs[d + e], port::to_f(p.v[e]), dot);
      }
      sc = dot * a.scale2;
    }
    const float m_new = fmaxf(m, port::warp_max(sc));
    const float p = exp2f(sc - m_new);
    const float corr = exp2f(m - m_new);
    l = l * corr + port::warp_sum(p);
    m = m_new;
    const float pb = port::to_f(port::from_f<T>(p));
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] *= corr;
    const int jn = min(32, n_keys - t0);
    for (int jj = 0; jj < jn; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, pb, jj);
      const PV vr = *reinterpret_cast<const PV*>(v + (t0 + jj) * a.v_ss + lane * DPL);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] = fmaf(pj, port::to_f(vr.v[c]), acc[c]);
    }
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < DPL; ++c) wacc[warp][lane * DPL + c] = acc[c];
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, wm[w]);
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) lsum += wl[w] * exp2f(wm[w] - mx);
  const float denom = fmaxf(lsum, 1e-20f);
  T* o = static_cast<T*>(a.o) + b * a.o_sb + i * a.o_ss + h * a.o_sh;
  for (int d = threadIdx.x; d < D; d += kDecWarps * 32) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) sum += wacc[w][d] * exp2f(wm[w] - mx);
    o[d] = port::from_f<T>(sum / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  if (a.Sq == 1) {
    attn_decode_kernel<T, D><<<dim3(a.Sq, a.H, a.B), kDecWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  constexpr size_t smem = TiledSmem<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_tiled_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attn_tiled_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const AttnArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k / v (B, Skv, H, D), o (B, Sq, H, D): element strides
// for the batch, sequence and head dimensions; the last dimension is
// contiguous. q_pos0: (B,) int32 on the device. D in {32, 64, 128}; every
// pointer 16-byte aligned and every stride a multiple of 16 bytes (the
// wrapper checks). dtype: 0 fp32, 1 bf16. Returns cudaGetLastError().
int attention_fwd(const void* q, const void* k, const void* v, void* o,
                  const void* q_pos0, int B, int Sq, int Skv, int H, int D,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long o_sb, long long o_ss, long long o_sh,
                  int causal, float scale2, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k, v, o, static_cast<const int*>(q_pos0), B, Sq, Skv, H,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, causal, scale2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == port::kDtypeF32) return static_cast<int>(launch_d<float>(a, D, s));
  if (dtype == port::kDtypeBF16) return static_cast<int>(launch_d<__nv_bfloat16>(a, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
