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
// * dkv on the tensor cores (bf16 at D 64 / 128; the wrapper's route 2):
//   attn_bwd_dkv_tc_kernel, below; fp32 and D 32 keep the kernel above.
//
// Bound on the card: operations (dq: 6, dkv: 8 multiply-adds x 2 per
// admitted (row, key) pair and head dimension). dq and the CUDA-core dkv
// compute on the fp32 CUDA cores; all kernels need more than 48 KB of shared
// memory (set per kernel at first launch).
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

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

// ----------------------------------------------------- dkv, tensor cores --
// attn_bwd_dkv_tc_kernel: dK and dV in bf16 at D 64 / 128 on wgmma. One
// block per (key tile of 64 NWG keys, head, batch): NWG consumer warpgroups
// of 64 keys each and one producer warp. K and V are loaded once; the
// producer streams 64-row tiles of Q and dO by TMA, with their lse * log2 e
// and delta (loaded by the producer's lanes: a (B, H, S) fp32 row of ragged
// S breaks TMA's 16-byte stride rule), through a ring of kDkvStages,
// starting at the tile of the block's first key (causal). Per query tile a
// consumer warpgroup takes
//   S^T = K Q^T and dP^T = V dO^T by m64n64k16 over D (shared memory);
//   P^T = exp2(S^T scale2 - lse * log2 e), exactly 0 where masked, and
//   dS^T = P^T (dP^T - delta) sm_scale, in registers, both rounded to bf16
//   as the Pallas kernel and the plain version round them. The tensor
//   cores sum S and dP in another order than an fp32 matrix product on the
//   CUDA cores, so about 2e-5 of those roundings would fall the other way
//   (H100 measurement), and one such flip of a P near 0.3 moves a whole dV
//   row by one bf16 step of P times dO. So where a P or dS is large enough
//   for that to matter (>= kHeavy) and lies within the possible summation
//   error of a bf16 rounding midpoint, the kernel recomputes that
//   element's S and dP with the sequential fp32 dot product (seq_dot) and
//   rounds from those: its rounding decisions are the plain version's.
//   A first pass only flags such elements; the recompute runs for the
//   flagged ones alone (well under one element per warp and tile);
//   dV += P^T dO and dK += dS^T Q by m64nDk16, the register A operand and
//   B transposed from shared memory.
// No atomics: each dK / dV element is summed by one warpgroup, query tile by
// query tile in order. The accumulators take D fp32 registers a thread
// (128 at D 128) besides 64 for S^T and dP^T. With two consumer
// warpgroups the producer is a whole warpgroup (setmaxnreg moves registers
// between warpgroups: ptxas budgets 65536 / 384 = 168 a thread at entry),
// which lowers its limit to kProducerRegs so that the consumers can raise
// theirs to kConsumerRegs; only its first warp works. With one consumer
// warpgroup the block is 160 threads and needs no split.
constexpr int kDkvStages = 2;
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
//: P or |dS| from which a flipped bf16 rounding would show in dV / dK (one
//: bf16 step of 2^-6 is 6e-5; times |dO| or |Q| below 4, under 3e-3 of the
//: outputs' typical size 0.1)
constexpr float kHeavy = 1.f / 64;
//: bound on |S_tensor_cores - S_sequential| (and dP alike), above the
//: largest fp32 product error measured against fp64 (1.5e-5, 128-wide rows
//: of N(0, 1), H100): every flagged element costs a sequential dot product,
//: so the window is kept near the error it must cover
constexpr float kDotErr = 2e-5f;

// Replace the bf16 half (hi: the upper) of A-fragment register `slot`
// (flattened [k16 step][register]) with x rounded to bf16: a select per
// register, so the fragments stay in registers for a runtime slot.
__device__ __forceinline__ void patch_bf16(uint32_t (&v)[4][4], int slot, int hi,
                                           float x) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(x));
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const uint32_t r = v[t >> 2][t & 3];
    const uint32_t nr = hi ? ((r & 0xFFFFu) | (b << 16)) : ((r & 0xFFFF0000u) | b);
    v[t >> 2][t & 3] = t == slot ? nr : r;
  }
}

template <int NWG>
constexpr int dkv_threads() { return NWG * 128 + (NWG == 2 ? 128 : 32); }

template <int D, int NWG>
struct TcDkvSmem {
  static constexpr int kNH = D / 64;                      // 64-column blocks a row
  static constexpr uint32_t kKV = NWG * kNH * tc::kBlk;   // K of the block's keys (V alike)
  static constexpr uint32_t kStage = 2 * kNH * tc::kBlk;  // Q blocks, then dO
  static constexpr uint32_t kStats = 2 * 64 * 4;          // lse * log2 e, then delta
  static constexpr uint32_t kBars = (1 + 2 * kDkvStages) * 8;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t kBytes =
      2 * kKV + kDkvStages * (kStage + kStats) + kBars + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(dkv_threads<NWG>(), 1)
attn_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using L = TcDkvSmem<D, NWG>;
  constexpr int NH = L::kNH;
  constexpr int BK = 64 * NWG;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* ks = tc::align_1024(tc_smem);
  uint8_t* vs = ks + L::kKV;
  uint8_t* stg = vs + L::kKV;
  float* stats = reinterpret_cast<float*>(stg + kDkvStages * L::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + kDkvStages * 128);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kDkvStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int nkeys = min(BK, a.S - k0);
  const int nqt = (a.S + kKBQ - 1) / kKBQ;
  // query tiles before the block's first key contribute nothing
  const int qt0 = a.causal ? k0 / kKBQ : 0;
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.S;

  if (threadIdx.x == 0) {
    tc::mbar_init(full_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      tc::mbar_init(&full[s], 32);  // the producer's lanes (their stats)
      tc::mbar_init(&empty[s], NWG * 128);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // producer: its first warp loads, any other warps only give back
    // registers
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x >= NWG * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      const int nk = (nkeys + 63) / 64;  // warpgroups that hold keys
      tc::mbar_expect_tx(full_kv, 2 * nk * NH * tc::kBlk);
      for (int w = 0; w < nk; ++w)
        for (int c = 0; c < NH; ++c) {
          tc::tma_load_4d(ks + (w * NH + c) * tc::kBlk, &tk, full_kv, 64 * c, h,
                          k0 + 64 * w, b);
          tc::tma_load_4d(vs + (w * NH + c) * tc::kBlk, &tv, full_kv, 64 * c, h,
                          k0 + 64 * w, b);
        }
    }
    for (int qt = qt0; qt < nqt; ++qt) {
      const int i = qt - qt0, s = i % kDkvStages, u = i / kDkvStages;
      if (u > 0) tc::mbar_wait(&empty[s], (u - 1) & 1);
      float* st = stats + s * 128;
      for (int r = lane; r < kKBQ; r += 32) {
        const int q = qt * kKBQ + r;
        st[r] = q < a.S ? a.lse[stat0 + q] * kLog2e : 0.f;
        st[kKBQ + r] = q < a.S ? a.delta[stat0 + q] : 0.f;
      }
      if (lane == 0) {
        uint8_t* qsd = stg + s * L::kStage;
        tc::mbar_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < NH; ++c) {
          tc::tma_load_4d(qsd + c * tc::kBlk, &tq, &full[s], 64 * c, h, qt * kKBQ, b);
          tc::tma_load_4d(qsd + (NH + c) * tc::kBlk, &tdo, &full[s], 64 * c, h,
                          qt * kKBQ, b);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
    }
  } else {
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int w = threadIdx.x >> 7;           // consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;  // warp in the warpgroup
    const int lane = threadIdx.x & 31;
    const int kw = k0 + 64 * w;               // the warpgroup's first key
    const bool has_keys = kw < a.S;
    const int qt_w = a.causal ? kw / kKBQ : 0;
    // this thread's keys (rows of S^T) kw + lr and kw + lr + 8, and its
    // queries 8 j + c0 (+ 1) of the tile (the accumulator map)
    const int lr = 16 * warp + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    const int key[2] = {kw + lr, kw + lr + 8};
    const uint8_t* kws = ks + w * NH * tc::kBlk;
    const uint8_t* vws = vs + w * NH * tc::kBlk;
    // relative error of P from an error of kDotErr in S (exp2 domain)
    const float p_rel = 0.6931472f * a.scale2 * kDotErr;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (has_keys) tc::mbar_wait(full_kv, 0);

    for (int qt = qt0; qt < nqt; ++qt) {
      const int i = qt - qt0, s = i % kDkvStages;
      tc::mbar_wait(&full[s], (i / kDkvStages) & 1);
      if (has_keys && qt >= qt_w) {
        const uint8_t* qs = stg + s * L::kStage;
        const uint8_t* dos = qs + NH * tc::kBlk;
        const float* l2s = stats + s * 128;
        const float* dls = l2s + kKBQ;
        float st[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) st[e] = dp[e] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_m64n64k16_ss<0>(st, tc::desc_k(kws, kk), tc::desc_k(qs, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_m64n64k16_ss<0>(dp, tc::desc_k(vws, kk), tc::desc_k(dos, kk), kk > 0);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(st);
        tc::fence_regs(dp);

        // P^T and dS^T rounded to bf16 as the A operands of k16 step j / 2;
        // flag the heavy values that lie near a bf16 rounding midpoint
        uint32_t pa[4][4], da[4][4];
        uint32_t flags = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pr[4], dr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + c0 + (e & 1);  // query within the tile
            const int q = qt * kKBQ + qi;
            const int kr = key[e >> 1];
            const bool ok = kr < a.S && q < a.S && !(a.causal && kr > q);
            const float p = ok ? exp2f(st[4 * j + e] * a.scale2 - l2s[qi]) : 0.f;
            const float ds = p * (dp[4 * j + e] - dls[qi]) * a.sm_scale;
            pr[e] = p;
            dr[e] = ds;
            if ((p >= kHeavy && tc::near_bf16_midpoint(p, p * p_rel)) ||
                (fabsf(ds) >= kHeavy &&
                 tc::near_bf16_midpoint(ds, fabsf(ds) * p_rel +
                                                p * a.sm_scale * kDotErr)))
              flags |= 1u << (4 * j + e);
          }
          pa[j >> 1][2 * (j & 1)] = tc::pack_bf16(pr[0], pr[1]);
          pa[j >> 1][2 * (j & 1) + 1] = tc::pack_bf16(pr[2], pr[3]);
          da[j >> 1][2 * (j & 1)] = tc::pack_bf16(dr[0], dr[1]);
          da[j >> 1][2 * (j & 1) + 1] = tc::pack_bf16(dr[2], dr[3]);
        }
        // rare: those take P and dS from the sequential fp32 dot products,
        // as the plain version does, patched into their fragment slot
        // (step j / 2, register 2 (j % 2) + e / 2, half e % 2)
        while (flags != 0) {
          const int i = __ffs(flags) - 1;
          flags &= flags - 1;
          const int j = i >> 2, e = i & 3;
          const int qi = 8 * j + c0 + (e & 1);
          const int rk = lr + 8 * (e >> 1);
          const float p = exp2f(tc::seq_dot<D>(kws, rk, qs, qi) * a.scale2 - l2s[qi]);
          const float ds = p * (tc::seq_dot<D>(vws, rk, dos, qi) - dls[qi]) * a.sm_scale;
          const int slot = 4 * (j >> 1) + 2 * (j & 1) + (e >> 1);
          patch_bf16(pa, slot, e & 1, p);
          patch_bf16(da, slot, e & 1, ds);
        }
        tc::wg_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_rs<D, 1>(dv, pa[t], tc::desc_t(dos, t), 1);
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_rs<D, 1>(dk, da[t], tc::desc_t(qs, t), 1);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(dv);
        tc::fence_regs(dk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          tc::fence_regs(pa[t]);
          tc::fence_regs(da[t]);
        }
      }
      tc::mbar_arrive(&empty[s]);  // this thread is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!has_keys || key[r] >= a.S) continue;
      const long long off = b * a.g_sb + h * a.g_sh +
                            static_cast<long long>(key[r]) * a.g_ss + c0;
      __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(a.dk) + off;
      __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(a.dv) + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(gk + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(gv + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D != 32) {
    return cudaErrorInvalidValue;  // the tensor cores' work (route 2)
  } else {
    constexpr size_t smem = DkvSmem<D>::kBytes;
    static bool configured = false;
    const cudaError_t e = allow_smem(attn_bwd_dkv_kernel<T, D>, smem, configured);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.S + kKBK - 1) / kKBK, a.H, a.B);
    attn_bwd_dkv_kernel<T, D><<<grid, kKWarps * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int D, int NWG>
cudaError_t launch_dkv_tc(const BwdArgs& a, cudaStream_t stream) {
  using L = TcDkvSmem<D, NWG>;
  static bool configured = false;
  cudaError_t e = allow_smem(attn_bwd_dkv_tc_kernel<D, NWG>, L::kBytes, configured);
  if (e != cudaSuccess) return e;
  if constexpr (NWG == 2) {
    // setmaxnreg moves registers within the block's launch allocation: the
    // consumers' raise must fit what the producer gives back, or it waits
    // for ever. Refuse to launch instead.
    static int regs = -1;
    if (regs < 0) {
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, attn_bwd_dkv_tc_kernel<D, NWG>);
      if (e != cudaSuccess) return e;
      regs = fa.numRegs;
    }
    if (regs * dkv_threads<NWG>() < NWG * 128 * kConsumerRegs + 128 * kProducerRegs)
      return static_cast<cudaError_t>(port::kErrRegisters);
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!tc::encode_bshd(&tq, a.q, a.B, a.S, a.H, D, a.q_sb, a.q_ss, a.q_sh) ||
      !tc::encode_bshd(&tk, a.k, a.B, a.S, a.H, D, a.k_sb, a.k_ss, a.k_sh) ||
      !tc::encode_bshd(&tv, a.v, a.B, a.S, a.H, D, a.v_sb, a.v_ss, a.v_sh) ||
      !tc::encode_bshd(&tdo, a.dout, a.B, a.S, a.H, D, a.d_sb, a.d_ss, a.d_sh))
    return static_cast<cudaError_t>(port::kErrTensorMap);
  const dim3 grid((a.S + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
  attn_bwd_dkv_tc_kernel<D, NWG><<<grid, dkv_threads<NWG>(), L::kBytes, stream>>>(
      tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

cudaError_t launch_dkv_tc_d(const BwdArgs& a, int d, int tile_rows, cudaStream_t s) {
  if (tile_rows == 128 && d == 64) return launch_dkv_tc<64, 2>(a, s);
  if (tile_rows == 128 && d == 128) return launch_dkv_tc<128, 2>(a, s);
  if (tile_rows == 64 && d == 64) return launch_dkv_tc<64, 1>(a, s);
  if (tile_rows == 64 && d == 128) return launch_dkv_tc<128, 1>(a, s);
  return cudaErrorInvalidValue;
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

constexpr int kRouteSimt = 0, kRouteTc = 2;

int run(const BwdArgs& a, int d, int dtype, bool dkv, int route, int tile_rows,
        void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteTc) {
    if (!dkv || dtype != port::kDtypeBF16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_dkv_tc_d(a, d, tile_rows, s));
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
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
// attention_bwd_dkv's route: 0 the CUDA-core kernel, 2 the tensor cores
// (bf16, D 64 or 128) with tile_rows 64 or 128 keys a block.
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
  return run(a, D, dtype, false, kRouteSimt, 0, stream);
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
                      int route, int tile_rows, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr, dk, dv, B, S, H,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            d_sb, d_ss, d_sh, g_sb, g_ss, g_sh, causal, scale2, sm_scale};
  return run(a, D, dtype, true, route, tile_rows, stream);
}

}  // extern "C"
