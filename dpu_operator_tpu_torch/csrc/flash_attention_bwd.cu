// Attention backward for Hopper (sm_90a): dQ and dK/dV, bound to Python
// with ctypes.
//
// Replaces the two Pallas kernels of the training path's custom VJP in
// dpu_operator_tpu/ops/flash_attention.py: _bwd_dq_kernel (launched in
// _vjp_bwd for dq) and _bwd_dkv_kernel (for dk and dv). As there, P is never
// stored: both kernels recompute it from the forward's per-row logsumexp
// (flash_attention_fwd.cu, attention_fwd_lse), and delta = rowsum(dO * O)
// comes in from the caller. Two kernels and no atomics: every output element
// is summed by one thread in a fixed order, so gradients are the same from
// run to run.
//
// Numerics follow the Pallas kernels: scores scaled into the exp2 domain,
// P = exp2(s * scale2 - lse * log2 e) (exactly 0 where masked),
// dS = P * (dO . V - delta) * sm_scale rounded to the input type before both
// the dQ and the dK products, P rounded to dO's type before the dV product;
// every accumulator fp32, rounded once to the input type on the way out.
//
// Layout: q, k, v, dO (B, S, H, D) read through their strides (q, k and v
// are views of one (B, S, 3 * H * D) projection in the model); lse and delta
// (B, H, S) fp32 contiguous; dq, dk, dv written through one set of output
// strides. Ragged S is masked in the kernels (no divisibility rule).
//
// * dq: one block per (query tile of 32 rows, head, batch), 4 warps of 8
//   rows; walks 64-key tiles up to the tile's last row (causal), each lane
//   two keys for the scores and D / 32 columns of dq.
// * dkv: one block per (key tile of 64 keys, head, batch), 8 warps of 8 keys
//   (the 64 x D fp32 dk and dv accumulators spread over 256 threads: 64
//   registers a thread at D = 128); walks 64-query tiles from the causal
//   diagonal, each lane two queries for the scores and D / 32 columns of dk
//   and dv.
//
// Bound on the card: operations (dq: 6, dkv: 8 multiply-adds x 2 per
// admitted (row, key) pair and head dimension). This first version computes
// on the fp32 CUDA cores, not the tensor cores (no wgmma / TMA yet); both
// kernels need more than 48 KB of shared memory (set per kernel at first
// launch).
#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, S)
  const float* delta;  // (B, H, S)
  void* dq;
  void* dk;
  void* dv;
  int B, S, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;  // dO
  long long g_sb, g_ss, g_sh;  // every gradient output
  int causal;
  float scale2;    // sm_scale * log2(e)
  float sm_scale;  // 1 / sqrt(D)
};

// ------------------------------------------------------------------- dq --
constexpr int kQBQ = 32;                // query rows per block
constexpr int kQBK = 64;                // keys per tile
constexpr int kQWarps = 4;              // 128 threads
constexpr int kQRPW = kQBQ / kQWarps;   // rows per warp

template <int D>
struct DqSmem {
  static constexpr size_t kRow = static_cast<size_t>(D + 4);
  static constexpr size_t kQ = kQBQ * kRow;       // Q, then dO
  static constexpr size_t kK = kQBK * kRow;       // K, then V
  static constexpr size_t kDs = static_cast<size_t>(kQWarps) * kQRPW * kQBK;
  static constexpr size_t kBytes = (2 * kQ + 2 * kK + kDs) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kQWarps * 32)
attn_bwd_dq_kernel(BwdArgs a) {
  constexpr int NT = kQWarps * 32;
  constexpr int DPL = D / 32;
  constexpr int S = D + 4;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* DOs = Qs + DqSmem<D>::kQ;
  float* Ks = DOs + DqSmem<D>::kQ;
  float* Vs = Ks + DqSmem<D>::kK;
  float* DSs = Vs + DqSmem<D>::kK;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = tile * kQBQ;
  const int nrows = min(kQBQ, a.S - r0);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + r0 * a.q_ss;
  const T* dout = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh + r0 * a.d_ss;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  port::stage_rows<T, D, NT>(Qs, q, a.q_ss, kQBQ, nrows);
  port::stage_rows<T, D, NT>(DOs, dout, a.d_ss, kQBQ, nrows);

  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.S;
  float lse2[kQRPW], dlt[kQRPW], dq[kQRPW][DPL];
#pragma unroll
  for (int r = 0; r < kQRPW; ++r) {
    const int row = r0 + warp * kQRPW + r;
    const bool ok = row < a.S;
    lse2[r] = ok ? a.lse[stat0 + row] * kLog2e : 0.f;
    dlt[r] = ok ? a.delta[stat0 + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) dq[r][c] = 0.f;
  }
  const float* qw = Qs + warp * kQRPW * S;
  const float* dow = DOs + warp * kQRPW * S;
  float* dsw = DSs + warp * kQRPW * kQBK;

  const int nkb_all = (a.S + kQBK - 1) / kQBK;
  // key tiles past the query tile's last row contribute nothing
  const int nkb = a.causal ? min(nkb_all, (r0 + nrows - 1) / kQBK + 1) : nkb_all;
  for (int kb = 0; kb < nkb; ++kb) {
    const int j0 = kb * kQBK;
    const int kvalid = min(kQBK, a.S - j0);
    __syncthreads();  // previous tile fully consumed
    port::stage_rows<T, D, NT>(Ks, k + j0 * a.k_ss, a.k_ss, kQBK, kvalid);
    port::stage_rows<T, D, NT>(Vs, v + j0 * a.v_ss, a.v_ss, kQBK, kvalid);
    __syncthreads();

    float s[kQRPW][2], dp[kQRPW][2];
#pragma unroll
    for (int r = 0; r < kQRPW; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    port::dot_rows2<kQRPW, D>(s, qw, Ks + lane * S, Ks + (lane + 32) * S);
    port::dot_rows2<kQRPW, D>(dp, dow, Vs + lane * S, Vs + (lane + 32) * S);
#pragma unroll
    for (int r = 0; r < kQRPW; ++r) {
      const int row = r0 + warp * kQRPW + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = j0 + lane + 32 * t;
        const bool ok = row < a.S && j < a.S && !(a.causal && j > row);
        const float p = ok ? exp2f(s[r][t] * a.scale2 - lse2[r]) : 0.f;
        // dS enters the dQ product in the input type
        dsw[r * kQBK + lane + 32 * t] =
            port::round_to<T>(p * (dp[r][t] - dlt[r]) * a.sm_scale);
      }
    }
    __syncwarp();
    for (int j = 0; j < kvalid; ++j) {
      float kv[DPL];
      port::load_cols<DPL>(kv, Ks + j * S + lane * DPL);
#pragma unroll
      for (int r = 0; r < kQRPW; ++r) {
        const float ds = dsw[r * kQBK + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) dq[r][c] = fmaf(ds, kv[c], dq[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQRPW; ++r) {
    const int lr = warp * kQRPW + r;
    if (lr >= nrows) continue;
    T* o = static_cast<T*>(a.dq) + b * a.g_sb + h * a.g_sh + (r0 + lr) * a.g_ss + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[c] = port::from_f<T>(dq[r][c]);
  }
}

// ------------------------------------------------------------------ dkv --
constexpr int kKBK = 64;                // keys per block
constexpr int kKBQ = 64;                // queries per tile
constexpr int kKWarps = 8;              // 256 threads
constexpr int kKKPW = kKBK / kKWarps;   // keys per warp

template <int D>
struct DkvSmem {
  static constexpr size_t kRow = static_cast<size_t>(D + 4);
  static constexpr size_t kKV = kKBK * kRow;      // K, then V
  static constexpr size_t kQ = kKBQ * kRow;       // Q, then dO
  static constexpr size_t kP = static_cast<size_t>(kKWarps) * kKKPW * kKBQ;  // P, then dS
  static constexpr size_t kStat = kKBQ;           // lse * log2 e, then delta
  static constexpr size_t kBytes =
      (2 * kKV + 2 * kQ + 2 * kP + 2 * kStat) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kKWarps * 32)
attn_bwd_dkv_kernel(BwdArgs a) {
  constexpr int NT = kKWarps * 32;
  constexpr int DPL = D / 32;
  constexpr int S = D + 4;
  extern __shared__ float4 smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + DkvSmem<D>::kKV;
  float* Qs = Vs + DkvSmem<D>::kKV;
  float* DOs = Qs + DkvSmem<D>::kQ;
  float* Ps = DOs + DkvSmem<D>::kQ;
  float* DSs = Ps + DkvSmem<D>::kP;
  float* L2s = DSs + DkvSmem<D>::kP;
  float* DLs = L2s + DkvSmem<D>::kStat;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = tile * kKBK;
  const int nkeys = min(kKBK, a.S - k0);
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + k0 * a.k_ss;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + k0 * a.v_ss;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  port::stage_rows<T, D, NT>(Ks, k, a.k_ss, kKBK, nkeys);
  port::stage_rows<T, D, NT>(Vs, v, a.v_ss, kKBK, nkeys);
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.S;

  float dk[kKKPW][DPL], dv[kKKPW][DPL];
#pragma unroll
  for (int r = 0; r < kKKPW; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk[r][c] = dv[r][c] = 0.f;
  const float* kw = Ks + warp * kKKPW * S;
  const float* vw = Vs + warp * kKKPW * S;
  float* pw = Ps + warp * kKKPW * kKBQ;
  float* dsw = DSs + warp * kKKPW * kKBQ;

  const int nqt = (a.S + kKBQ - 1) / kKBQ;
  // query tiles before the key tile's first key contribute nothing
  const int qt0 = a.causal ? k0 / kKBQ : 0;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int i0 = qt * kKBQ;
    const int qvalid = min(kKBQ, a.S - i0);
    __syncthreads();  // previous tile fully consumed
    port::stage_rows<T, D, NT>(Qs, q + i0 * a.q_ss, a.q_ss, kKBQ, qvalid);
    port::stage_rows<T, D, NT>(DOs, dout + i0 * a.d_ss, a.d_ss, kKBQ, qvalid);
    if (threadIdx.x < kKBQ) {
      const int i = threadIdx.x;
      L2s[i] = i < qvalid ? a.lse[stat0 + i0 + i] * kLog2e : 0.f;
      DLs[i] = i < qvalid ? a.delta[stat0 + i0 + i] : 0.f;
    }
    __syncthreads();

    // transposed scores: this warp's keys against queries lane and lane + 32
    float s[kKKPW][2], dp[kKKPW][2];
#pragma unroll
    for (int r = 0; r < kKKPW; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    port::dot_rows2<kKKPW, D>(s, kw, Qs + lane * S, Qs + (lane + 32) * S);
    port::dot_rows2<kKKPW, D>(dp, vw, DOs + lane * S, DOs + (lane + 32) * S);
#pragma unroll
    for (int r = 0; r < kKKPW; ++r) {
      const int key = k0 + warp * kKKPW + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int il = lane + 32 * t;
        const int i = i0 + il;
        const bool ok = key < a.S && i < a.S && !(a.causal && key > i);
        const float p = ok ? exp2f(s[r][t] * a.scale2 - L2s[il]) : 0.f;
        // P enters the dV product in dO's type, dS the dK product in q's
        pw[r * kKBQ + il] = port::round_to<T>(p);
        dsw[r * kKBQ + il] = port::round_to<T>(p * (dp[r][t] - DLs[il]) * a.sm_scale);
      }
    }
    __syncwarp();
    for (int i = 0; i < qvalid; ++i) {
      float dov[DPL], qv[DPL];
      port::load_cols<DPL>(dov, DOs + i * S + lane * DPL);
      port::load_cols<DPL>(qv, Qs + i * S + lane * DPL);
#pragma unroll
      for (int r = 0; r < kKKPW; ++r) {
        const float p = pw[r * kKBQ + i];
        const float ds = dsw[r * kKBQ + i];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          dv[r][c] = fmaf(p, dov[c], dv[r][c]);
          dk[r][c] = fmaf(ds, qv[c], dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKKPW; ++r) {
    const int lk = warp * kKKPW + r;
    if (lk >= nkeys) continue;
    const long long off = b * a.g_sb + h * a.g_sh + (k0 + lk) * a.g_ss + lane * DPL;
    T* gk = static_cast<T*>(a.dk) + off;
    T* gv = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      gk[c] = port::from_f<T>(dk[r][c]);
      gv[c] = port::from_f<T>(dv[r][c]);
    }
  }
}

// Dynamic shared memory above 48 KB has to be allowed once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) configured = true;
  return e;
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = DqSmem<D>::kBytes;
  static bool configured = false;
  const cudaError_t e = allow_smem(attn_bwd_dq_kernel<T, D>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kQBQ - 1) / kQBQ, a.H, a.B);
  attn_bwd_dq_kernel<T, D><<<grid, kQWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<D>::kBytes;
  static bool configured = false;
  const cudaError_t e = allow_smem(attn_bwd_dkv_kernel<T, D>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kKBK - 1) / kKBK, a.H, a.B);
  attn_bwd_dkv_kernel<T, D><<<grid, kKWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const BwdArgs& a, int d, bool dkv, cudaStream_t s) {
  switch (d) {
    case 32: return dkv ? launch_dkv<T, 32>(a, s) : launch_dq<T, 32>(a, s);
    case 64: return dkv ? launch_dkv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
    case 128: return dkv ? launch_dkv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const BwdArgs& a, int d, int dtype, bool dkv, void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == port::kDtypeF32) return static_cast<int>(launch_t<float>(a, d, dkv, s));
  if (dtype == port::kDtypeBF16)
    return static_cast<int>(launch_t<__nv_bfloat16>(a, d, dkv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v, dout (B, S, H, D) with element strides for the batch, sequence
// and head dimensions (last dimension contiguous); lse, delta (B, H, S) fp32
// contiguous; dq (and dk, dv) written with strides g_*. D in {32, 64, 128};
// every pointer 16-byte aligned and every stride a multiple of 16 bytes (the
// wrapper checks). dtype: 0 fp32, 1 bf16. Each returns cudaGetLastError().
int attention_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int S, int H, int D,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long d_sb, long long d_ss, long long d_sh,
                     long long g_sb, long long g_ss, long long g_sh,
                     int causal, float scale2, float sm_scale, int dtype,
                     void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), dq, nullptr, nullptr, B, S, H,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            d_sb, d_ss, d_sh, g_sb, g_ss, g_sh, causal, scale2, sm_scale};
  return run(a, D, dtype, false, stream);
}

int attention_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int S, int H, int D,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      long long d_sb, long long d_ss, long long d_sh,
                      long long g_sb, long long g_ss, long long g_sh,
                      int causal, float scale2, float sm_scale, int dtype,
                      void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr, dk, dv, B, S, H,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            d_sb, d_ss, d_sh, g_sb, g_ss, g_sh, causal, scale2, sm_scale};
  return run(a, D, dtype, true, stream);
}

}  // extern "C"
