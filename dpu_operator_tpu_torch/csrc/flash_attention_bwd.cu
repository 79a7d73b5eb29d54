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
// Routes (the wrapper pads the head dim up to the route's next compiled D
// and passes the true D's scales):
// * dq and dkv in fp32 on the tensor cores (route 3, D 32 / 64 / 128 / 256):
//   attn_bwd_dq_tf32_kernel and attn_bwd_dkv_tf32_kernel, 3xTF32 on
//   mma.sync, below.
// * dq and dkv in bf16 on the tensor cores (route 2, D 64 / 128 / 256):
//   attn_bwd_dq_tc_kernel and attn_bwd_dkv_tc_kernel, below. At D 256 a
//   block takes 64 query rows (dq: one warpgroup, 192 KB of shared memory)
//   or 64 keys (dkv: two warpgroups that split the columns).
//
// Bound on the card: operations (dq: 6, dkv: 8 multiply-adds x 2 per
// admitted (row, key) pair and head dimension). All kernels but the 3xTF32
// ones at small D need more than 48 KB of shared memory (set per kernel at
// first launch).
#include "common.cuh"
#include "tf32.cuh"
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

// ------------------------------------------------------ dq, fp32: 3xTF32 --
// attn_bwd_dq_tf32_kernel: dQ in fp32 on the tensor cores.
// Bound: operations, 6 * admitted pairs * D, in three TF32 products each
// (495 / 3 TFLOP/s on the H100's tensor cores).
//
// Design: attn_bwd_dkv_tf32_kernel's (below) with the roles of queries and
// keys swapped. One block per (query tile of 64 rows, head, batch),
// heaviest tiles first, of KH x 4 warps: warp w owns rows 16 (w % 4) .. + 15
// (one m16 row block of mma.sync m16n8k8) for the key tiles of parity w / 4
// (KH 2), so a row group's walk over the keys takes two warps, not one;
// each keeps its rows' dQ in fp32 registers (D / 2 a thread), and the odd
// half adds its sums to the even half's through shared memory at the end
// (one fixed order). Q and dO are staged once; key tiles of dq_tf32_keys
// keys (K, then V) are staged KH at a time (one for each half) by cp.async
// into two buffers, so tiles i + KH .. load while tiles i .. are multiplied.
// Every tile stays fp32 in shared memory (rows of D + 4 floats: every
// fragment load is free of bank conflicts) and each warp splits the
// fragments it loads into TF32 hi / lo parts (tf32.cuh). Per key tile a
// warp takes
//   S = Q K^T and dP = dO V^T: both operands D-contiguous as staged, each in
//   two accumulator chains (the small terms, the large one);
//   P = exp2(S scale2 - lse * log2 e), exactly 0 where masked, and
//   dS = P (dP - delta) sm_scale, in registers (fp32: no rounding);
//   dQ += dS K: dS from the accumulator as the A operand (acc_to_a), K read
//   with its rows as the permuted k index (load_b_krow), over D / 8 output
//   fragments.
// No atomics: each dQ element is summed by KH warps, key tile by key tile in
// order, and the sums added once in a fixed order, so gradients are the same
// from run to run. Shared memory at D 128: Q and dO 2 x 64 (D + 4) floats and
// two buffers of two 32-key K / V tiles, 203 KB. At D 256, where dQ takes
// 128 registers a thread, one warp a row group (KH 1) and 16-key tiles keep
// it to 195 KB.
constexpr int kDqWarps = 4;  // row groups of 16: 64 query rows a block

//: keys a staged tile of the 3xTF32 dQ kernel: 32, or 16 at D 256 (Q, dO
//: and two K / V buffers in 227 KB)
template <int D>
__host__ __device__ constexpr int dq_tf32_keys() { return D > 128 ? 16 : 32; }

//: warps a row group of the 3xTF32 dQ kernel, on the key tiles of one
//: parity each: 2, or 1 at D 256 (two tiles a buffer would not fit)
template <int D>
__host__ __device__ constexpr int dq_tf32_halves() { return D > 128 ? 1 : 2; }

template <int D>
struct Tf32DqSmem {
  static constexpr int kLd = D + 4;  // floats a staged row
  static constexpr size_t kRows = static_cast<size_t>(16 * kDqWarps) * kLd;  // Q (dO alike)
  static constexpr size_t kTile = 2 * static_cast<size_t>(dq_tf32_keys<D>()) * kLd;  // K, V
  static constexpr size_t kBuf = dq_tf32_halves<D>() * kTile;  // one tile a half
  static constexpr size_t kBytes = (2 * kRows + 2 * kBuf) * sizeof(float);
  // the odd half's dQ sums at the end, in the buffers' place
  static_assert(dq_tf32_halves<D>() == 1 || kDqWarps * 32 * (D / 2) <= 2 * kBuf,
                "reduction space");
};

template <int D>
__global__ void __launch_bounds__(dq_tf32_halves<D>() * kDqWarps * 32, 1)
attn_bwd_dq_tf32_kernel(BwdArgs a) {
  using L = Tf32DqSmem<D>;
  constexpr int KH = dq_tf32_halves<D>();
  constexpr int NT = KH * kDqWarps * 32, LD = L::kLd, BQ = 16 * kDqWarps, NN = D / 8;
  constexpr int BK = dq_tf32_keys<D>(), NJ = BK / 8;
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + L::kRows;
  float* kvs = dos + L::kRows;  // [2][KH][K, V][BK][LD]

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int nrows = min(BQ, a.S - r0);
  const int nkb_all = (a.S + BK - 1) / BK;
  // key tiles past the block's last row contribute nothing
  const int nkb = a.causal ? min(nkb_all, (r0 + nrows - 1) / BK + 1) : nkb_all;
  const int nsets = (nkb + KH - 1) / KH;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  // key tiles KH i .. KH i + KH - 1 into buffer i % 2
  auto stage = [&](int i) {
    for (int hh = 0; hh < KH; ++hh) {
      const int kb = KH * i + hh;
      if (kb >= nkb) break;
      float* dst = kvs + ((i & 1) * KH + hh) * L::kTile;
      const int j0 = kb * BK, valid = min(BK, a.S - j0);
      tf32::stage_rows<D, NT>(dst, k + j0 * a.k_ss, a.k_ss, BK, valid);
      tf32::stage_rows<D, NT>(dst + BK * LD, v + j0 * a.v_ss, a.v_ss, BK, valid);
    }
  };
  tf32::stage_rows<D, NT>(qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh +
                                  r0 * a.q_ss, a.q_ss, BQ, nrows);
  tf32::stage_rows<D, NT>(dos, static_cast<const float*>(a.dout) + b * a.d_sb + h * a.d_sh +
                                   r0 * a.d_ss, a.d_ss, BQ, nrows);
  stage(0);
  tf32::cp_commit();  // Q, dO and the first key tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % kDqWarps, half = warp / kDqWarps;
  const int g = lane >> 2, t = lane & 3;
  const int rw = r0 + 16 * rg;  // the warp's first row
  // this thread's rows rw + g and rw + g + 8, and its keys 8 j + 2 t (+ 1)
  // of the tile (the accumulator map)
  const int row[2] = {rw + g, rw + g + 8};
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.S;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < a.S;
    lse2[r] = ok ? a.lse[stat0 + row[r]] * kLog2e : 0.f;
    dlt[r] = ok ? a.delta[stat0 + row[r]] : 0.f;
  }
  // key tiles past the warp's last row contribute nothing
  const int nkb_w = rw >= a.S ? 0
                    : a.causal ? min(nkb_all, min(rw + 15, a.S - 1) / BK + 1) : nkb_all;
  const float* qw = qs + 16 * rg * LD;
  const float* dow = dos + 16 * rg * LD;

  float dq[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int i = 0; i < nsets; ++i) {
    if (i + 1 < nsets) stage(i + 1);
    tf32::cp_commit();
    tf32::cp_wait<1>();  // tiles KH i .. (and Q, dO) landed for this thread ...
    __syncthreads();     // ... and for every thread
    const int kb = KH * i + half;  // this warp's tile
    if (kb < nkb_w) {
      const float* ks = kvs + ((i & 1) * KH + half) * L::kTile;
      const float* vs = ks + BK * LD;
      // S and dP (rows x keys), 8 keys a fragment
      float s[NJ][4], dp[NJ][4];
      {
        float sb[NJ][4], ss[NJ][4], pb[NJ][4], pss[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[j][e] = ss[j][e] = pb[j][e] = pss[j][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
          const tf32::Frag<4> fq = tf32::load_a(qw + 8 * kk, LD, g, t);
          const tf32::Frag<4> fo = tf32::load_a(dow + 8 * kk, LD, g, t);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            tf32::mma3_split(sb[j], ss[j], fq,
                             tf32::load_b_nrow(ks + 8 * j * LD + 8 * kk, LD, g, t));
            tf32::mma3_split(pb[j], pss[j], fo,
                             tf32::load_b_nrow(vs + 8 * j * LD + 8 * kk, LD, g, t));
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = sb[j][e] + ss[j][e];
            dp[j][e] = pb[j][e] + pss[j][e];
          }
      }
      // P in place of S, dS in place of dP
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb * BK + 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = key < a.S && row[r] < a.S && !(a.causal && key > row[r]);
          const float p = ok ? exp2f(s[j][e] * a.scale2 - lse2[r]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dlt[r]) * a.sm_scale;
        }
      // dQ += dS K, keys 8 j .. 8 j + 7 a k-step
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const tf32::Frag<4> fs = tf32::acc_to_a(dp[j]);
#pragma unroll
        for (int n = 0; n < NN; ++n)
          tf32::mma3(dq[n], fs, tf32::load_b_krow(ks + 8 * j * LD + 8 * n, LD, g, t));
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  tf32::cp_wait<0>();

  if constexpr (KH > 1) {  // the odd half's sums into the buffers, then added
    float* red = kvs + rg * (D / 2) * 32;  // [D / 2][32 lanes]
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32 + lane] = dq[n][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] += red[(4 * n + e) * 32 + lane];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.S) continue;
    float* gq = static_cast<float*>(a.dq) + b * a.g_sb + h * a.g_sh +
                static_cast<long long>(row[r]) * a.g_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<float2*>(gq + 8 * n) = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ----------------------------------------------------- dkv, fp32: 3xTF32 --
// attn_bwd_dkv_tf32_kernel: dK and dV in fp32 on the tensor cores; replaces
// the CUDA-core dK/dV kernel (5.2x its bound at 1 x 1024 x 12 x 128, slower
// than SDPA's whole backward). Bound: operations, 8 * admitted pairs * D, in
// three TF32 products each (495 / 3 TFLOP/s on the H100's tensor cores).
//
// Design. One block per (key tile of 16 NW keys, head, batch) and 2 NW
// warps: warp w owns keys 16 (w % NW) .. + 15 (one m16 row block of mma.sync
// m16n8k8) for the query tiles of parity w / NW, so a key tile's walk over
// the queries (all of them for key tile 0) takes two warps, not one; each
// keeps its keys' dK and dV in fp32 registers (D / 2 a thread each), and the
// odd half adds its sums to the even half's through shared memory at the
// end (one fixed order). K and V are staged once; 16-row tiles of Q and dO,
// with their lse and delta, are staged two at a time (one for each half) by
// cp.async into two buffers from the tile of the block's first key
// (causal), so tiles i + 2, i + 3 load while tiles i, i + 1 are multiplied.
// Every tile stays fp32 in shared memory (rows of D + 4 floats) and each warp
// splits the fragments it loads into TF32 hi / lo parts once per tile
// (tf32.cuh). Per query tile a warp takes
//   S^T = K Q^T and dP^T = V dO^T: both operands D-contiguous as staged,
//   each in two accumulator chains (the small terms, the large one);
//   P^T = exp2(S^T scale2 - lse * log2 e), exactly 0 where masked, and
//   dS^T = P^T (dP^T - delta) sm_scale, in registers (fp32: no rounding);
//   dV += P^T dO and dK += dS^T Q: P^T and dS^T from the accumulators as the
//   A operand, dO and Q read with their rows as the permuted k index
//   (tf32.cuh), over D / 8 output fragments.
// No atomics: each dK / dV element is summed by two warps, query tile by
// query tile in order, and the two sums added once in a fixed order, so
// gradients are the same from run to run. The wrapper takes 32-key blocks
// (NW = 2) when 64-key blocks would not give every SM one.
// At D 256 a warp's dK and dV for 16 keys would take 256 fp32 registers a
// thread, so the two warps of a key group split the columns instead of the
// query tiles: warp w holds columns DC (w / NW) .. + DC - 1 (DC = D / 2) of
// its keys' dK and dV (128 registers, as at D 128), takes every query tile
// and computes S^T and dP^T over the whole D (both warps alike: the same
// products in the same order), and no sums are added at the end. Shared
// memory holds 32-key blocks only (NW = 2: 200 KB).
constexpr int kDBQ = 16;  // queries per staged tile

//: the parts of the dK/dV accumulators' columns that the warps of a key
//: group (3xTF32) or the warpgroups of a key tile (tensor cores) split
//: between them: 2 at D 256, where one holds half the registers' worth;
//: else 1 (the 3xTF32 kernel's warps split the query tiles, the tensor-core
//: kernel's warpgroups the keys)
template <int D>
__host__ __device__ constexpr int dkv_col_split() { return D > 128 ? 2 : 1; }

template <int D, int NW>
struct Tf32DkvSmem {
  static constexpr int kLd = D + 4;  // floats a staged row
  static constexpr size_t kKV = static_cast<size_t>(16 * NW) * kLd;   // K (V alike)
  // one query tile: Q rows, dO rows, then its lse and delta (kDBQ each)
  static constexpr size_t kTile = 2 * static_cast<size_t>(kDBQ) * kLd + 2 * kDBQ;
  // two buffers of two tiles (the even and the odd half's)
  static constexpr size_t kStages = 4 * kTile;
  static constexpr size_t kBytes = (2 * kKV + kStages) * sizeof(float);
  // the odd half's dK and dV sums at the end, in the stages' place
  static_assert(dkv_col_split<D>() > 1 || 2 * (D / 2) * 32 * NW <= kStages,
                "reduction space");
};

template <int D, int NW>
__global__ void __launch_bounds__(2 * NW * 32)
attn_bwd_dkv_tf32_kernel(BwdArgs a) {
  using L = Tf32DkvSmem<D, NW>;
  constexpr int CS = dkv_col_split<D>();
  constexpr int NT = 2 * NW * 32, LD = L::kLd, BK = 16 * NW, DC = D / CS, NN = DC / 8;
  extern __shared__ float4 smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + L::kKV;
  float* stg = vs + L::kKV;

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int nkeys = min(BK, a.S - k0);
  const int nqt = (a.S + kDBQ - 1) / kDBQ;
  // query tiles before the block's first key contribute nothing
  const int qt0 = a.causal ? k0 / kDBQ : 0;
  const int npairs = (nqt - qt0 + 1) / 2;
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* dout = static_cast<const float*>(a.dout) + b * a.d_sb + h * a.d_sh;

  // the query tiles of pair i (qt0 + 2 i and + 1) into buffer i % 2
  auto stage = [&](int i) {
    for (int half = 0; half < 2; ++half) {
      const int qt = qt0 + 2 * i + half;
      if (qt >= nqt) break;
      float* st = stg + ((i & 1) * 2 + half) * L::kTile;
      const int i0 = qt * kDBQ, valid = min(kDBQ, a.S - i0);
      tf32::stage_rows<D, NT>(st, q + i0 * a.q_ss, a.q_ss, kDBQ, valid);
      tf32::stage_rows<D, NT>(st + kDBQ * LD, dout + i0 * a.d_ss, a.d_ss, kDBQ, valid);
      if (threadIdx.x < 2 * kDBQ) {
        const int r = threadIdx.x & (kDBQ - 1);
        const float* src = (threadIdx.x < kDBQ ? a.lse : a.delta) + stat0 + i0;
        tf32::cp_async4(st + 2 * kDBQ * LD + threadIdx.x, src + (r < valid ? r : 0),
                        r < valid);
      }
    }
  };
  tf32::stage_rows<D, NT>(ks, static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh +
                                  k0 * a.k_ss, a.k_ss, BK, nkeys);
  tf32::stage_rows<D, NT>(vs, static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh +
                                  k0 * a.v_ss, a.v_ss, BK, nkeys);
  stage(0);
  tf32::cp_commit();  // K, V and the first pair

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // half: the warp's query-tile parity (CS 1) or column half (CS 2)
  const int kg = warp % NW, half = warp / NW;
  const int col0 = CS > 1 ? half * DC : 0;  // the warp's first dK / dV column
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + 16 * kg;  // the warp's first key
  // query tiles before the warp's first key contribute nothing
  const int qt_w = a.causal ? kw / kDBQ : 0;
  // this thread's keys kw + g and kw + g + 8, and its queries 8 j + 2 t (+ 1)
  // of the tile (the accumulator map)
  const int key[2] = {kw + g, kw + g + 8};
  const float* kws = ks + 16 * kg * LD;
  const float* vws = vs + 16 * kg * LD;

  float dk[NN][4], dv[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int i = 0; i < npairs; ++i) {
    if (i + 1 < npairs) stage(i + 1);
    tf32::cp_commit();
    tf32::cp_wait<1>();  // pair i (and K / V) landed for this thread ...
    __syncthreads();     // ... and for every thread
    // query tile `sub` of pair i (0: the even tile, 1: the odd one)
    auto tile = [&](int sub) {
      const int qt = qt0 + 2 * i + sub;
      if (kw < a.S && qt >= qt_w && qt < nqt) {
        const float* qs = stg + ((i & 1) * 2 + sub) * L::kTile;
        const float* dos = qs + kDBQ * LD;
        const float* l2s = qs + 2 * kDBQ * LD;
        const float* dls = l2s + kDBQ;
        // S^T (keys x queries) and dP^T, 8 queries a fragment
        float st[2][4], dp[2][4];
        {
          float sb[2][4], ss[2][4], pb[2][4], pss[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sb[j][e] = ss[j][e] = pb[j][e] = pss[j][e] = 0.f;
#pragma unroll 2
          for (int kk = 0; kk < D / 8; ++kk) {
            const tf32::Frag<4> fk = tf32::load_a(kws + 8 * kk, LD, g, t);
            const tf32::Frag<4> fv = tf32::load_a(vws + 8 * kk, LD, g, t);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              tf32::mma3_split(sb[j], ss[j], fk,
                               tf32::load_b_nrow(qs + 8 * j * LD + 8 * kk, LD, g, t));
              tf32::mma3_split(pb[j], pss[j], fv,
                               tf32::load_b_nrow(dos + 8 * j * LD + 8 * kk, LD, g, t));
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              st[j][e] = sb[j][e] + ss[j][e];
              dp[j][e] = pb[j][e] + pss[j][e];
            }
        }
        // P^T and dS^T in place of S^T and dP^T
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * t + (e & 1);  // query within the tile
            const int qa = qt * kDBQ + qi;
            const int kr = key[e >> 1];
            const bool ok = kr < a.S && qa < a.S && !(a.causal && kr > qa);
            const float p = ok ? exp2f(st[j][e] * a.scale2 - l2s[qi] * kLog2e) : 0.f;
            st[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dls[qi]) * a.sm_scale;
          }
        // dV += P^T dO and dK += dS^T Q, queries 8 j .. 8 j + 7 a k-step
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const tf32::Frag<4> fp = tf32::acc_to_a(st[j]);
          const tf32::Frag<4> fs = tf32::acc_to_a(dp[j]);
#pragma unroll
          for (int n = 0; n < NN; ++n) {
            tf32::mma3(dv[n], fp, tf32::load_b_krow(dos + 8 * j * LD + col0 + 8 * n, LD, g, t));
            tf32::mma3(dk[n], fs, tf32::load_b_krow(qs + 8 * j * LD + col0 + 8 * n, LD, g, t));
          }
        }
      }
    };
    if constexpr (CS > 1) {  // both tiles, in order
      tile(0);
      tile(1);
    } else {                 // the tile of the warp's parity
      tile(half);
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  tf32::cp_wait<0>();
  if constexpr (CS > 1) {  // each warp writes its own columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= a.S) continue;
      const long long off = b * a.g_sb + h * a.g_sh +
                            static_cast<long long>(key[r]) * a.g_ss + col0 + 2 * t;
      float* gk = static_cast<float*>(a.dk) + off;
      float* gv = static_cast<float*>(a.dv) + off;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        *reinterpret_cast<float2*>(gk + 8 * n) = make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<float2*>(gv + 8 * n) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
    return;
  }
  __syncthreads();  // the stages are free: the odd half's sums go there

  float* red = stg + kg * 2 * (D / 2) * 32;  // [dK, dV][D / 2][32 lanes]
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(4 * n + e) * 32 + lane] = dk[n][e];
        red[((D / 2) + 4 * n + e) * 32 + lane] = dv[n][e];
      }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.S) continue;
    const long long off = b * a.g_sb + h * a.g_sh +
                          static_cast<long long>(key[r]) * a.g_ss + 2 * t;
    float* gk = static_cast<float*>(a.dk) + off;
    float* gv = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int e0 = 4 * n + 2 * r;
      *reinterpret_cast<float2*>(gk + 8 * n) =
          make_float2(dk[n][2 * r] + red[e0 * 32 + lane], dk[n][2 * r + 1] + red[(e0 + 1) * 32 + lane]);
      *reinterpret_cast<float2*>(gv + 8 * n) =
          make_float2(dv[n][2 * r] + red[((D / 2) + e0) * 32 + lane],
                      dv[n][2 * r + 1] + red[((D / 2) + e0 + 1) * 32 + lane]);
    }
  }
}

// ---------------------------------- rounding re-decision, tensor cores --
// The tensor cores sum S and dP in another order than an fp32 matrix
// product on the CUDA cores, so a few P or dS roundings to bf16 fall on the
// other side of a midpoint than the plain version's. Both tensor-core
// backward kernels re-decide those that matter from the sequential dot
// product (seq_dot): the constants and the fragment patch below.
//: P or |dS| from which a flipped bf16 rounding would show in dQ, dK or dV
//: (one bf16 step of 2^-6 is 6e-5; times |K|, |dO| or |Q| below 4, under
//: 3e-3 of the outputs' typical size 0.1)
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

// ------------------------------------------------------ dq, tensor cores --
// attn_bwd_dq_tc_kernel: dQ in bf16 at D 64 / 128 / 256 on wgmma, the dK/dV
// kernel's structure with the roles of queries and keys swapped. One block
// per (query tile of 64 NWG rows, head, batch): NWG consumer warpgroups of 64
// rows each and one producer warp. The producer loads the block's Q and dO
// tiles once, then streams 64-key K / V tiles by TMA through a ring of
// kDqStages, from key 0 to the tile that holds the block's last admitted key
// (causal): tiles stay anchored at key 0. Each consumer thread loads its own
// two rows' lse * log2 e and delta once (a (B, H, S) fp32 row of ragged S
// breaks TMA's 16-byte stride rule). Per key tile a consumer warpgroup takes
//   S = Q K^T and dP = dO V^T by m64n64k16 over D (shared memory);
//   P = exp2(S scale2 - lse * log2 e), exactly 0 where masked (the mask only
//   on the tiles that cross the diagonal or the ragged edge: the forward's
//   n_full / nkb split), and dS = P (dP - delta) sm_scale, rounded to bf16
//   as the register A operand. P enters no product here, so dS is the only
//   rounding on this path; where |dS| >= kHeavy lies within the possible
//   summation error of a bf16 midpoint, the kernel recomputes that element's
//   S and dP with seq_dot and rounds from those, as the dK/dV kernel does
//   (without it, 1.8e-2 against the plain version at 8 x 1024 x 12 x 128,
//   over the 1.5e-2 limit; H100 measurement);
//   dQ += dS K by m64nDk16, K transposed from shared memory.
// No atomics: each dQ element is summed by one warpgroup, key tile by key
// tile in order, so dQ is the same from run to run. The accumulator takes
// D / 2 fp32 registers a thread besides 64 for S and dP, which fits the
// 288-thread block's share without a setmaxnreg split. At D 256 (128 of
// them) the block holds one warpgroup: its Q, dO and two K / V stages take
// 192 KB, two warpgroups' 256 KB.
constexpr int kDqStages = 2;
constexpr int kQBK = 64;  // keys a staged tile

template <int D, int NWG>
struct TcDqSmem {
  static constexpr int kNH = D / 64;                      // 64-column blocks a row
  static constexpr uint32_t kQ = NWG * kNH * tc::kBlk;    // the Q tile (dO alike)
  static constexpr uint32_t kStage = 2 * kNH * tc::kBlk;  // K blocks, then V
  static constexpr uint32_t kBars = (1 + 2 * kDqStages) * 8;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t kBytes = 2 * kQ + kDqStages * kStage + kBars + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using L = TcDqSmem<D, NWG>;
  constexpr int NH = L::kNH;
  constexpr int BM = 64 * NWG;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* qs = tc::align_1024(tc_smem);
  uint8_t* dos = qs + L::kQ;
  uint8_t* kvs = dos + L::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(kvs + kDqStages * L::kStage);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kDqStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * BM;
  const int nrows = min(BM, a.S - r0);
  const int nkb_all = (a.S + kQBK - 1) / kQBK;
  // key tiles the block's last row needs; a warpgroup may need fewer
  const int nkb = a.causal ? min(nkb_all, (r0 + nrows - 1) / kQBK + 1) : nkb_all;

  if (threadIdx.x == 0) {
    tc::mbar_init(full_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], NWG * 128);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // producer warp: one lane issues every copy
    if (threadIdx.x == NWG * 128) {
      const int nq = (nrows + 63) / 64;  // warpgroups that hold rows
      tc::mbar_expect_tx(full_q, 2 * nq * NH * tc::kBlk);
      for (int w = 0; w < nq; ++w)
        for (int c = 0; c < NH; ++c) {
          tc::tma_load_4d(qs + (w * NH + c) * tc::kBlk, &tq, full_q, 64 * c, h,
                          r0 + 64 * w, b);
          tc::tma_load_4d(dos + (w * NH + c) * tc::kBlk, &tdo, full_q, 64 * c, h,
                          r0 + 64 * w, b);
        }
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kDqStages, u = kb / kDqStages;
        if (u > 0) tc::mbar_wait(&empty[s], (u - 1) & 1);
        uint8_t* ks = kvs + s * L::kStage;
        tc::mbar_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < NH; ++c) {
          tc::tma_load_4d(ks + c * tc::kBlk, &tk, &full[s], 64 * c, h, kb * kQBK, b);
          tc::tma_load_4d(ks + (NH + c) * tc::kBlk, &tv, &full[s], 64 * c, h,
                          kb * kQBK, b);
        }
      }
    }
  } else {
    const int w = threadIdx.x >> 7;           // consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;  // warp in the warpgroup
    const int lane = threadIdx.x & 31;
    const int rw = r0 + 64 * w;               // the warpgroup's first row
    const int wrows = min(64, a.S - rw);      // <= 0: no rows
    int nkb_w = 0, n_full = 0;
    if (wrows > 0) {
      nkb_w = a.causal ? min(nkb_all, (rw + wrows - 1) / kQBK + 1) : nkb_all;
      // tiles wholly at or below the warpgroup's first row need no mask
      n_full = a.S / kQBK;
      if (a.causal) n_full = min(n_full, (rw + 1) / kQBK);
      n_full = min(n_full, nkb_w);
    }
    // this thread's rows lr and lr + 8 of the warpgroup's tile, and its
    // keys 8 j + c0 (+ 1) of every key tile (the accumulator map)
    const int lr = 16 * warp + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    const int row[2] = {rw + lr, rw + lr + 8};
    const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.S;
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row[r] < a.S;
      lse2[r] = ok ? a.lse[stat0 + row[r]] * kLog2e : 0.f;
      dlt[r] = ok ? a.delta[stat0 + row[r]] : 0.f;
    }
    const uint8_t* qw = qs + w * NH * tc::kBlk;
    const uint8_t* dow = dos + w * NH * tc::kBlk;
    // relative error of P from an error of kDotErr in S (exp2 domain)
    const float p_rel = 0.6931472f * a.scale2 * kDotErr;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    if (nkb_w > 0) tc::mbar_wait(full_q, 0);

    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % kDqStages;
      tc::mbar_wait(&full[s], (kb / kDqStages) & 1);
      if (kb < nkb_w) {
        const uint8_t* ks = kvs + s * L::kStage;
        const uint8_t* vs = ks + NH * tc::kBlk;
        float st[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) st[e] = dp[e] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_m64n64k16_ss<0>(st, tc::desc_k(qw, kk), tc::desc_k(ks, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_m64n64k16_ss<0>(dp, tc::desc_k(dow, kk), tc::desc_k(vs, kk), kk > 0);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(st);
        tc::fence_regs(dp);

        // dS rounded to bf16 as the A operand of k16 step j / 2 (row lr in
        // a[0] / a[2], row lr + 8 in a[1] / a[3]); flag the heavy values
        // that lie near a bf16 rounding midpoint
        const int j0 = kb * kQBK;
        const bool masked = kb >= n_full;  // only diagonal / ragged tiles
        uint32_t da[4][4];
        uint32_t flags = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float dr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + 8 * j + c0 + (e & 1);
            const int r = e >> 1;
            float p = exp2f(st[4 * j + e] * a.scale2 - lse2[r]);
            if (masked && (key >= a.S || (a.causal && key > row[r]))) p = 0.f;
            const float ds = p * (dp[4 * j + e] - dlt[r]) * a.sm_scale;
            dr[e] = ds;
            if (fabsf(ds) >= kHeavy &&
                tc::near_bf16_midpoint(ds, fabsf(ds) * p_rel + p * a.sm_scale * kDotErr))
              flags |= 1u << (4 * j + e);
          }
          da[j >> 1][2 * (j & 1)] = tc::pack_bf16(dr[0], dr[1]);
          da[j >> 1][2 * (j & 1) + 1] = tc::pack_bf16(dr[2], dr[3]);
        }
        // rare: those take dS from the sequential fp32 dot products, as
        // the plain version does, patched into their fragment slot (step
        // j / 2, register 2 (j % 2) + e / 2, half e % 2)
        while (flags != 0) {
          const int i = __ffs(flags) - 1;
          flags &= flags - 1;
          const int j = i >> 2, e = i & 3;
          const int kj = 8 * j + c0 + (e & 1);
          const int rq = lr + 8 * (e >> 1);
          const float p = exp2f(tc::seq_dot<D>(qw, rq, ks, kj) * a.scale2 - lse2[e >> 1]);
          const float ds = p * (tc::seq_dot<D>(dow, rq, vs, kj) - dlt[e >> 1]) * a.sm_scale;
          patch_bf16(da, 4 * (j >> 1) + 2 * (j & 1) + (e >> 1), e & 1, ds);
        }
        tc::wg_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_rs<D, 1>(dq, da[t], tc::desc_t(ks, t), 1);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(dq);
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::fence_regs(da[t]);
      }
      tc::mbar_arrive(&empty[s]);  // this thread is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (wrows <= 0 || lr + 8 * r >= wrows) continue;
      __nv_bfloat16* g = static_cast<__nv_bfloat16*>(a.dq) + b * a.g_sb + h * a.g_sh +
                         static_cast<long long>(row[r]) * a.g_ss + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(g + 8 * j) =
            __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// ----------------------------------------------------- dkv, tensor cores --
// attn_bwd_dkv_tc_kernel: dK and dV in bf16 at D 64 / 128 / 256 on wgmma. One
// block per (key tile of 64 NWG keys, head, batch): NWG consumer warpgroups
// of 64 keys each and one producer warp (at D 256: below). K and V are loaded once; the
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
// At D 256 the accumulators of 64 keys would take 256 fp32 registers a
// thread in one warpgroup, so the two consumer warpgroups share the block's
// 64 keys and split the columns (FlashAttention-3's head-dim-256 backward
// splits the same way): warpgroup w holds columns 128 w .. 128 w + 127 of
// dK and dV (128 registers, as at D 128), and both compute S^T and dP^T
// over the whole D, the same products in the same order (so the same P, dS
// and re-decided roundings). Shared memory: K and V of 64 keys and two
// stages of Q and dO, 192 KB.
constexpr int kKBQ = 64;  // queries per tile
constexpr int kDkvStages = 2;
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
template <int NWG>
__host__ __device__ constexpr int dkv_threads() { return NWG * 128 + (NWG == 2 ? 128 : 32); }
//: keys a block of attn_bwd_dkv_tc_kernel<D, NWG>
template <int D, int NWG>
__host__ __device__ constexpr int dkv_tc_keys() {
  return dkv_col_split<D>() > 1 ? 64 : 64 * NWG;
}

template <int D, int NWG>
struct TcDkvSmem {
  static_assert(dkv_col_split<D>() == 1 || NWG == 2, "D 256: two warpgroups");
  static constexpr int kNH = D / 64;                      // 64-column blocks a row
  // K of the block's keys (V alike)
  static constexpr uint32_t kKV = dkv_tc_keys<D, NWG>() / 64 * kNH * tc::kBlk;
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
  constexpr bool kColSplit = dkv_col_split<D>() > 1;
  constexpr int BK = dkv_tc_keys<D, NWG>();
  constexpr int DC = kColSplit ? D / NWG : D;  // dK / dV columns a warpgroup holds
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
    const int kw = kColSplit ? k0 : k0 + 64 * w;  // the warpgroup's first key
    const int col0 = kColSplit ? DC * w : 0;       // ... and its first column
    const bool has_keys = kw < a.S;
    const int qt_w = a.causal ? kw / kKBQ : 0;
    // this thread's keys (rows of S^T) kw + lr and kw + lr + 8, and its
    // queries 8 j + c0 (+ 1) of the tile (the accumulator map)
    const int lr = 16 * warp + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    const int key[2] = {kw + lr, kw + lr + 8};
    const uint8_t* kws = ks + (kColSplit ? 0 : w) * NH * tc::kBlk;
    const uint8_t* vws = vs + (kColSplit ? 0 : w) * NH * tc::kBlk;
    // relative error of P from an error of kDotErr in S (exp2 domain)
    const float p_rel = 0.6931472f * a.scale2 * kDotErr;

    float dk[DC / 2], dv[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
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
        // the warpgroup's columns of dO and Q (64-column blocks kBlk apart)
        const uint8_t* dob = dos + col0 / 64 * tc::kBlk;
        const uint8_t* qb = qs + col0 / 64 * tc::kBlk;
        tc::wg_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_rs<DC, 1>(dv, pa[t], tc::desc_t(dob, t), 1);
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_rs<DC, 1>(dk, da[t], tc::desc_t(qb, t), 1);
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
                            static_cast<long long>(key[r]) * a.g_ss + col0 + c0;
      __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(a.dk) + off;
      __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(a.dv) + off;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
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

// Tensor maps of q, k, v and dO, each through its own strides.
bool encode_maps(const BwdArgs& a, int d, CUtensorMap* tq, CUtensorMap* tk,
                 CUtensorMap* tv, CUtensorMap* tdo) {
  return tc::encode_bshd(tq, a.q, a.B, a.S, a.H, d, a.q_sb, a.q_ss, a.q_sh) &&
         tc::encode_bshd(tk, a.k, a.B, a.S, a.H, d, a.k_sb, a.k_ss, a.k_sh) &&
         tc::encode_bshd(tv, a.v, a.B, a.S, a.H, d, a.v_sb, a.v_ss, a.v_sh) &&
         tc::encode_bshd(tdo, a.dout, a.B, a.S, a.H, d, a.d_sb, a.d_ss, a.d_sh);
}

template <int D>
cudaError_t launch_dq_tf32(const BwdArgs& a, cudaStream_t stream) {
  using L = Tf32DqSmem<D>;
  static bool configured = false;
  const cudaError_t e = allow_smem(attn_bwd_dq_tf32_kernel<D>, L::kBytes, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + 16 * kDqWarps - 1) / (16 * kDqWarps), a.H, a.B);
  attn_bwd_dq_tf32_kernel<D>
      <<<grid, dq_tf32_halves<D>() * kDqWarps * 32, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int NW>
cudaError_t launch_dkv_tf32(const BwdArgs& a, cudaStream_t stream) {
  using L = Tf32DkvSmem<D, NW>;
  static bool configured = false;
  const cudaError_t e = allow_smem(attn_bwd_dkv_tf32_kernel<D, NW>, L::kBytes, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + 16 * NW - 1) / (16 * NW), a.H, a.B);
  attn_bwd_dkv_tf32_kernel<D, NW><<<grid, 2 * NW * 32, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tf32_keys(const BwdArgs& a, int tile_keys, cudaStream_t s) {
  if (tile_keys == 64) return launch_dkv_tf32<D, 4>(a, s);
  if (tile_keys == 32) return launch_dkv_tf32<D, 2>(a, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_dkv_tf32_d(const BwdArgs& a, int d, int tile_keys, cudaStream_t s) {
  switch (d) {
    case 32: return launch_dkv_tf32_keys<32>(a, tile_keys, s);
    case 64: return launch_dkv_tf32_keys<64>(a, tile_keys, s);
    case 128: return launch_dkv_tf32_keys<128>(a, tile_keys, s);
    // D 256: 32-key blocks only (64 would take 266 KB of shared memory)
    case 256: return tile_keys == 32 ? launch_dkv_tf32<256, 2>(a, s) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
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
  if (!encode_maps(a, D, &tq, &tk, &tv, &tdo))
    return static_cast<cudaError_t>(port::kErrTensorMap);
  constexpr int BK = dkv_tc_keys<D, NWG>();
  const dim3 grid((a.S + BK - 1) / BK, a.H, a.B);
  attn_bwd_dkv_tc_kernel<D, NWG><<<grid, dkv_threads<NWG>(), L::kBytes, stream>>>(
      tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_dq_tc(const BwdArgs& a, cudaStream_t stream) {
  using L = TcDqSmem<D, NWG>;
  static bool configured = false;
  const cudaError_t e = allow_smem(attn_bwd_dq_tc_kernel<D, NWG>, L::kBytes, configured);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_maps(a, D, &tq, &tk, &tv, &tdo))
    return static_cast<cudaError_t>(port::kErrTensorMap);
  const dim3 grid((a.S + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
  attn_bwd_dq_tc_kernel<D, NWG><<<grid, NWG * 128 + 32, L::kBytes, stream>>>(
      tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_tc(const BwdArgs& a, bool dkv, cudaStream_t s) {
  return dkv ? launch_dkv_tc<D, NWG>(a, s) : launch_dq_tc<D, NWG>(a, s);
}

cudaError_t launch_tc_d(const BwdArgs& a, int d, int tile_rows, bool dkv,
                        cudaStream_t s) {
  if (tile_rows == 128 && d == 64) return launch_tc<64, 2>(a, dkv, s);
  if (tile_rows == 128 && d == 128) return launch_tc<128, 2>(a, dkv, s);
  if (tile_rows == 64 && d == 64) return launch_tc<64, 1>(a, dkv, s);
  if (tile_rows == 64 && d == 128) return launch_tc<128, 1>(a, dkv, s);
  // D 256, 64 rows (dQ) or keys (dK/dV) a block: dQ on one warpgroup, dK/dV
  // on two that split the columns
  if (tile_rows == 64 && d == 256)
    return dkv ? launch_dkv_tc<256, 2>(a, s) : launch_dq_tc<256, 1>(a, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_dq_tf32_d(const BwdArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch_dq_tf32<32>(a, s);
    case 64: return launch_dq_tf32<64>(a, s);
    case 128: return launch_dq_tf32<128>(a, s);
    case 256: return launch_dq_tf32<256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kRouteTc = 2, kRouteTf32 = 3;

int run(const BwdArgs& a, int d, int dtype, bool dkv, int route, int tile_rows,
        void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteTc) {
    if (dtype != port::kDtypeBF16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_tc_d(a, d, tile_rows, dkv, s));
  }
  if (dtype != port::kDtypeF32 || route != kRouteTf32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkv ? launch_dkv_tf32_d(a, d, tile_rows, s)
                              : launch_dq_tf32_d(a, d, s));
}

}  // namespace

extern "C" {

// q, k, v, dout (B, S, H, D) with element strides for the batch, sequence
// and head dimensions (last dimension contiguous); lse, delta (B, H, S) fp32
// contiguous; dq (and dk, dv) written with strides g_*. D in {32, 64, 128,
// 256}; every pointer 16-byte aligned and every stride a multiple of 16 bytes
// (the wrapper checks). dtype: 0 fp32, 1 bf16. Each returns
// cudaGetLastError(). route: 2 the tensor cores (bf16, D 64, 128 or 256)
// with tile_rows 64 or 128 query rows (dq) or keys (dkv) a block (64 at D
// 256), 3 the 3xTF32 kernels (fp32): dq with 64 query rows a block
// (tile_rows is not read), dkv with tile_rows 32 or 64 keys a block (32 at
// D 256).
int attention_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int S, int H, int D,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long d_sb, long long d_ss, long long d_sh,
                     long long g_sb, long long g_ss, long long g_sh,
                     int causal, float scale2, float sm_scale, int dtype,
                     int route, int tile_rows, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), dq, nullptr, nullptr, B, S, H,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            d_sb, d_ss, d_sh, g_sb, g_ss, g_sh, causal, scale2, sm_scale};
  return run(a, D, dtype, false, route, tile_rows, stream);
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
