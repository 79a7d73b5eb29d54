// Attention forward with a per-row query offset, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the Pallas kernel dpu_operator_tpu/ops/flash_attention.py::_kernel
// in both its uses: the forward of flash_attention (no lse) and the training
// forward of _fwd_with_lse, which also stores each row's natural-log
// logsumexp, (m + log2(max(l, 1e-20))) / log2(e), for the backward
// (flash_attention_bwd.cu). It takes the two-phase
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
// Three routes; the wrapper picks one:
// * tensor cores (route 2: bf16 at D 64 or 128, Sq > 1 or with the lse):
//   attn_fwd_tc_kernel, below.
// * tiled on the CUDA cores (route 0: fp32, and bf16 at D 32): one block per
//   (query tile of 32 rows, head, batch).
//   K/V tiles of 64 keys are staged in shared memory as fp32; each warp owns
//   8 query rows and each lane two keys of a tile. Key blocks past the
//   tile's last admitted position are never visited; key positions are
//   anchored at absolute key 0 and a row's arithmetic does not depend on the
//   other rows of its tile (a block that is fully masked for a row adds exact
//   zeros), so chunked prefill reproduces whole-prompt prefill row for row.
// * decode (Sq == 1 without the lse; its own entry point, attention_decode):
//   attn_decode_split_kernel splits each row's keys into fixed chunks across
//   blocks, attn_decode_combine_kernel folds the chunks' partials; below.
//
// Bound on the card: at decode, bytes (each admitted K/V row read once); at
// prefill, operations (4 * admitted pairs * D). The tiled and decode kernels
// compute on the fp32 CUDA cores; bf16 at D 64 / 128 takes the tensor cores.
//
// The attention over the int8 KV cache (KV8) is attention_kv8.cu.
#include <type_traits>

#include "attention.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace attn;

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
  const int pos0 = a.q_pos0 ? a.q_pos0[b] : 0;
  const int p_lo = pos0 + r0;              // first row's absolute position
  const int p_hi = pos0 + r0 + nrows - 1;  // last row's

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + r0 * a.q_ss;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  port::stage_rows<T, D, NT>(Qs, q, a.q_ss, kBQ, nrows);

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
    port::stage_rows<T, D, NT>(Ks, k + j0 * a.k_ss, a.k_ss, kBK, kvalid);
    port::stage_rows<T, D, NT>(Vs, v + j0 * a.v_ss, a.v_ss, kBK, kvalid);
    __syncthreads();

    // scores for this warp's rows against keys lane and lane + 32
    float s[kRPW][2];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r][0] = s[r][1] = 0.f;
    port::dot_rows2<kRPW, D>(s, qw, Ks + lane * S, Ks + (lane + 32) * S);
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
      port::load_cols<DPL>(vv, Vs + j * S + lane * DPL);
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
    // m and l are warp-uniform after the all-reduces; one lane writes
    if (a.lse != nullptr && lane == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + r0 + lr] =
          (m[r] + log2f(denom)) / kLog2e;
  }
}

// --------------------------------------------------------------- decode --
// One query row without the lse (decode, verify at width 1), split over
// keys. A row's admitted keys, min(q_pos0[b] + 1, Skv) when causal, are cut
// into chunks of kDecChunk keys anchored at key 0. attn_decode_split_kernel
// runs one block per (head, chunk, batch) over the longest row's chunks; a
// block whose chunk lies past its row's keys exits at once, so short rows
// cost nothing and a long cache fills the card (8 slots at position 511: 384
// working blocks of 8 warps, against 96 blocks when one block took a whole
// row). The heads of a chunk are neighbouring blocks, so they read the same
// cache rows (all heads of a key lie together) at about the same time. Warp
// w takes keys [16 w, 16 w + 16) of the chunk. A key row of D elements is
// read by LPK neighbouring lanes, 16 bytes each (at D 128 in bf16, 16 lanes a
// 256-byte row: one warp-wide load serves two keys), and its score summed by
// shuffles inside the lane group; V is read the same way for the PV sum.
// (Of the shapes tried on the H100, 4 warps of 32 keys in a chunk-major grid,
// with or without every load held in registers, 16 warps of 8 keys, chunks
// of 32, 64 and 256 keys, and the combine folded into the last block of a
// row by a counter, none was faster at 8 slots near position 512.) The
// chunk's softmax is taken against the chunk's own max: P =
// exp2(s - m_chunk) rounded to the input type before the PV product, l and
// acc in fp32. Each chunk writes its partial (m, l, acc[D]) in fp32 to the
// wrapper's scratch, and attn_decode_combine_kernel folds a row's partials in
// chunk order into out = acc / max(l, 1e-20). A row's result depends only on
// its query, its keys and kDecChunk: not on B, H, the grid or which block
// finishes first.
constexpr int kDecKeysPerWarp = 16;
constexpr int kDecWarps = kDecChunk / kDecKeysPerWarp;  // 256 threads

template <typename T, int D>
__global__ void __launch_bounds__(kDecWarps * 32)
attn_decode_split_kernel(AttnArgs a, float* part) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte piece
  constexpr int LPK = D / VEC;         // lanes that read one key row
  constexpr int KPL = 32 / LPK;        // keys of one warp-wide load
  constexpr int NG = kDecKeysPerWarp / KPL;  // loads for the warp's keys
  using P = port::Pack<T, VEC>;
  __shared__ float wm[kDecWarps], wl[kDecWarps];
  __shared__ float wacc[kDecWarps][D];

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int n_keys = a.causal ? min(a.q_pos0[b] + 1, a.Skv) : a.Skv;
  const int k0 = c * kDecChunk;
  if (k0 >= n_keys) return;  // past the row's keys: no partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK;  // this lane's piece of a row
  const int kw = k0 + kDecKeysPerWarp * warp + lane / LPK;  // its key of load 0
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + sub * VEC;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + sub * VEC;
  const P qp = *reinterpret_cast<const P*>(q + sub * VEC);

  float s[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int key = kw + g * KPL;
    float dot = 0.f;
    if (key < n_keys) {
      const P kp = *reinterpret_cast<const P*>(k + key * a.k_ss);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(port::to_f(qp.v[e]), port::to_f(kp.v[e]), dot);
    }
    s[g] = dot;
  }
  float mx = kNegInf;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    s[g] = kw + g * KPL < n_keys ? s[g] * a.scale2 : kNegInf;
    mx = fmaxf(mx, s[g]);
  }
  mx = port::warp_max(mx);
  if (lane == 0) wm[warp] = mx;
  __syncthreads();
  float m = wm[0];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) m = fmaxf(m, wm[w]);  // finite: k0 < n_keys

  float l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int key = kw + g * KPL;
    if (key < n_keys) {
      const float p = exp2f(s[g] - m);
      l += p;
      // P enters the PV product in the input type (bf16 P on bf16 inputs)
      const float pb = port::round_to<T>(p);
      const P vp = *reinterpret_cast<const P*>(v + key * a.v_ss);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pb, port::to_f(vp.v[e]), acc[e]);
    }
  }
  // sum over the warp's lane groups (each group holds the same l)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane < LPK) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) wacc[warp][lane * VEC + e] = acc[e];
  }
  if (lane == 0) wl[warp] = l;
  __syncthreads();
  // the chunk's partial: warps summed in order
  float* out = part + ((static_cast<long long>(b) * a.H + h) * gridDim.y + c) * (D + 2);
  for (int d = threadIdx.x; d < D; d += kDecWarps * 32) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) sum += wacc[w][d];
    out[2 + d] = sum;
  }
  if (threadIdx.x == 0) {
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) ls += wl[w];
    out[0] = m;
    out[1] = ls;
  }
}

// One block per (head, batch), one thread per column: a row's chunk
// partials folded in chunk order. A row with no admitted key writes zeros.
template <typename T, int D>
__global__ void __launch_bounds__(D)
attn_decode_combine_kernel(AttnArgs a, const float* part, int nch_max) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n_keys = a.causal ? min(a.q_pos0[b] + 1, a.Skv) : a.Skv;
  const int nch = n_keys > 0 ? (n_keys + kDecChunk - 1) / kDecChunk : 0;
  const float* p = part + (static_cast<long long>(b) * a.H + h) * nch_max * (D + 2);
  float m = kNegInf;
  for (int c = 0; c < nch; ++c) m = fmaxf(m, p[c * (D + 2)]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    const float* pc = p + c * (D + 2);
    const float w = exp2f(pc[0] - m);
    l += pc[1] * w;
    acc += pc[2 + d] * w;
  }
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  o[d] = port::from_f<T>(acc / fmaxf(l, 1e-20f));
}

// -------------------------------------------------------- tensor cores --
// attn_fwd_tc_kernel: the bf16 forward at D 64 / 128 on wgmma. One block per
// (query tile of 64 NWG rows, head, batch): NWG consumer warpgroups of 64
// rows each and one producer warp. The producer loads the Q tile once and
// streams 64-key K / V tiles through a ring of kTcStages by TMA (bf16 in
// the 128-byte swizzle that wgmma reads; rows past S read as zeros). Per
// key tile a consumer warpgroup takes
//   S = Q K^T by m64n64k16 over D, both operands in shared memory;
//   in registers: S scaled into the exp2 domain, the mask on the tiles that
//   cross the diagonal or the ragged edge only (the n_full / nkb split of
//   the tiled kernel, per warpgroup), the online max and sum over the four
//   lanes of a quad (they share a row), P rounded to bf16;
//   O += P V by m64nDk16, P as the register A operand, V transposed from
//   shared memory.
// Key tiles stay anchored at key 0, and a row's arithmetic involves no other
// row (the tensor cores keep rows apart; every reduction stays in its quad),
// so a row's result does not depend on which tile holds it: chunked prefill
// equals whole prefill bit for bit.
//
// Bound: operations (4 * admitted pairs * D on the bf16 tensor cores) at
// prefill and training shapes. Shared memory: the Q tile and two K / V
// stages in bf16, 96 KB at D 128 with two warpgroups.
constexpr int kTcStages = 2;

template <int D, int NWG>
struct TcFwdSmem {
  static constexpr int kNH = D / 64;                      // 64-column blocks a row
  static constexpr uint32_t kQ = NWG * kNH * tc::kBlk;    // the Q tile
  static constexpr uint32_t kStage = 2 * kNH * tc::kBlk;  // K blocks, then V
  static constexpr uint32_t kBars = (1 + 2 * kTcStages) * 8;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t kBytes = kQ + kTcStages * kStage + kBars + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, AttnArgs a) {
  using L = TcFwdSmem<D, NWG>;
  constexpr int NH = L::kNH;
  constexpr int BM = 64 * NWG;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* qs = tc::align_1024(tc_smem);
  uint8_t* kvs = qs + L::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(kvs + kTcStages * L::kStage);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kTcStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * BM;
  const int pos0 = a.q_pos0 ? a.q_pos0[b] : 0;
  const int nrows = min(BM, a.Sq - r0);
  const int nkb_all = (a.Skv + kBK - 1) / kBK;
  // key tiles the block's last row needs; a warpgroup may need fewer
  const int nkb = a.causal ? min(nkb_all, (pos0 + r0 + nrows - 1) / kBK + 1) : nkb_all;

  if (threadIdx.x == 0) {
    tc::mbar_init(full_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
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
      tc::mbar_expect_tx(full_q, nq * NH * tc::kBlk);
      for (int w = 0; w < nq; ++w)
        for (int c = 0; c < NH; ++c)
          tc::tma_load_4d(qs + (w * NH + c) * tc::kBlk, &tq, full_q, 64 * c, h,
                          r0 + 64 * w, b);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kTcStages, u = kb / kTcStages;
        if (u > 0) tc::mbar_wait(&empty[s], (u - 1) & 1);
        uint8_t* ks = kvs + s * L::kStage;
        tc::mbar_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < NH; ++c) {
          tc::tma_load_4d(ks + c * tc::kBlk, &tk, &full[s], 64 * c, h, kb * kBK, b);
          tc::tma_load_4d(ks + (NH + c) * tc::kBlk, &tv, &full[s], 64 * c, h,
                          kb * kBK, b);
        }
      }
    }
  } else {
    const int w = threadIdx.x >> 7;           // consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;  // warp in the warpgroup
    const int lane = threadIdx.x & 31;
    const int rw = r0 + 64 * w;               // the warpgroup's first row
    const int wrows = min(64, a.Sq - rw);     // <= 0: no rows
    int nkb_w = 0, n_full = 0;
    if (wrows > 0) {
      const int p_lo = pos0 + rw, p_hi = pos0 + rw + wrows - 1;
      nkb_w = a.causal ? min(nkb_all, p_hi / kBK + 1) : nkb_all;
      // tiles wholly at or below the warpgroup's first row need no mask
      n_full = a.Skv / kBK;
      if (a.causal) n_full = min(n_full, (p_lo + 1) / kBK);
      n_full = min(n_full, nkb_w);
    }
    // this thread's rows lr and lr + 8 of the warpgroup's tile, and its
    // columns 8 j + c0 (+ 1) of every 8-column group (the accumulator map)
    const int lr = 16 * warp + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    const int prow[2] = {pos0 + rw + lr, pos0 + rw + lr + 8};
    const uint8_t* qw = qs + w * NH * tc::kBlk;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    if (nkb_w > 0) tc::mbar_wait(full_q, 0);

    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % kTcStages;
      tc::mbar_wait(&full[s], (kb / kTcStages) & 1);
      if (kb < nkb_w) {
        const uint8_t* ks = kvs + s * L::kStage;
        const uint8_t* vs = ks + NH * tc::kBlk;
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_m64n64k16_ss<0>(sc, tc::desc_k(qw, kk), tc::desc_k(ks, kk), kk > 0);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(sc);

        const int j0 = kb * kBK;
        const bool masked = kb >= n_full;  // only diagonal / ragged tiles
        float bm[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = j0 + 8 * j + c0 + (i & 1);
            float x = sc[4 * j + i] * a.scale2;
            if (masked && (col >= a.Skv || (a.causal && col > prow[i >> 1]))) x = kNegInf;
            sc[4 * j + i] = x;
            bm[i >> 1] = fmaxf(bm[i >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
          bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
          const float mn = fmaxf(m[r], bm[r]);
          corr[r] = exp2f(m[r] - mn);
          m[r] = mn;
        }
        // P in fp32 for the row sums; rounded to bf16 as the A operand of
        // k16 step j / 2 (row lr in a[0] / a[2], row lr + 8 in a[1] / a[3])
        float ps[2] = {0.f, 0.f};
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[i] = exp2f(sc[4 * j + i] - m[i >> 1]);
            ps[i >> 1] += p[i];
          }
          pa[j >> 1][2 * (j & 1)] = tc::pack_bf16(p[0], p[1]);
          pa[j >> 1][2 * (j & 1) + 1] = tc::pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
          ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
          l[r] = l[r] * corr[r] + ps[r];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        tc::wg_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_rs<D, 1>(o, pa[t], tc::desc_t(vs, t), 1);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(o);
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::fence_regs(pa[t]);
      }
      tc::mbar_arrive(&empty[s]);  // this thread is done with stage s
    }

    if (wrows > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lr + 8 * r;
        if (row >= wrows) continue;
        const float denom = fmaxf(l[r], 1e-20f);
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh +
                              static_cast<long long>(rw + row) * a.o_ss + c0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
              o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
        // m and l are equal on the four lanes of the quad; one writes
        if (a.lse != nullptr && (lane & 3) == 0)
          a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + rw + row] =
              (m[r] + log2f(denom)) / kLog2e;
      }
    }
  }
}

// ----------------------------------------------------------- launching --
constexpr int kRouteSimt = 0, kRouteTc = 2;

template <typename T, int D>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D != 32) {
    return cudaErrorInvalidValue;  // the tensor cores' work (route 2)
  } else {
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

template <typename T, int D>
cudaError_t launch_decode(const AttnArgs& a, float* part, cudaStream_t stream) {
  const int nch = (a.Skv + kDecChunk - 1) / kDecChunk;
  attn_decode_split_kernel<T, D><<<dim3(a.H, nch, a.B), kDecWarps * 32, 0, stream>>>(a, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_decode_combine_kernel<T, D><<<dim3(a.H, a.B), D, 0, stream>>>(a, part, nch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_d(const AttnArgs& a, int d, float* part, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_decode<T, 32>(a, part, stream);
    case 64: return launch_decode<T, 64>(a, part, stream);
    case 128: return launch_decode<T, 128>(a, part, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, int NWG>
cudaError_t launch_tc(const AttnArgs& a, cudaStream_t stream) {
  using L = TcFwdSmem<D, NWG>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_tc_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!tc::encode_bshd(&tq, a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, a.q_sh) ||
      !tc::encode_bshd(&tk, a.k, a.B, a.Skv, a.H, D, a.k_sb, a.k_ss, a.k_sh) ||
      !tc::encode_bshd(&tv, a.v, a.B, a.Skv, a.H, D, a.v_sb, a.v_ss, a.v_sh))
    return static_cast<cudaError_t>(port::kErrTensorMap);
  const dim3 grid((a.Sq + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
  attn_fwd_tc_kernel<D, NWG><<<grid, NWG * 128 + 32, L::kBytes, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

cudaError_t launch_tc_d(const AttnArgs& a, int d, int tile_rows, cudaStream_t s) {
  if (tile_rows == 128 && d == 64) return launch_tc<64, 2>(a, s);
  if (tile_rows == 128 && d == 128) return launch_tc<128, 2>(a, s);
  if (tile_rows == 64 && d == 64) return launch_tc<64, 1>(a, s);
  if (tile_rows == 64 && d == 128) return launch_tc<128, 1>(a, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const AttnArgs& a, int d, int dtype, int route, int tile_rows,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteTc)
    return dtype == port::kDtypeBF16 ? launch_tc_d(a, d, tile_rows, s)
                                     : cudaErrorInvalidValue;
  if (route != kRouteSimt) return cudaErrorInvalidValue;
  if (dtype == port::kDtypeF32) return launch_d<float>(a, d, s);
  if (dtype == port::kDtypeBF16) return launch_d<__nv_bfloat16>(a, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k / v (B, Skv, H, D), o (B, Sq, H, D): element strides
// for the batch, sequence and head dimensions; the last dimension is
// contiguous. q_pos0: (B,) int32 on the device. D in {32, 64, 128}; every
// pointer 16-byte aligned and every stride a multiple of 16 bytes (the
// wrapper checks). dtype: 0 fp32, 1 bf16. route: 0 the tiled CUDA-core
// kernel, 2 the tensor cores (bf16, D 64 or 128) with tile_rows 64 or 128
// query rows a block (one query row takes attention_decode). Returns
// cudaGetLastError(), or an error without launching when the route does not
// take the arguments.
int attention_fwd(const void* q, const void* k, const void* v, void* o,
                  const void* q_pos0, int B, int Sq, int Skv, int H, int D,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long o_sb, long long o_ss, long long o_sh,
                  int causal, float scale2, int dtype, int route, int tile_rows,
                  void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k, v, o, static_cast<const int*>(q_pos0), nullptr, B, Sq, Skv, H,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, causal, scale2};
  return static_cast<int>(dispatch(a, D, dtype, route, tile_rows, stream));
}

// The training forward: self-attention (Sq == Skv == S, offset 0) that also
// writes lse (B, H, S) fp32, contiguous, in natural log. Route 0 (tiled) or
// 2 (tensor cores), S == 1 included. Strides and checks as attention_fwd.
int attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int S, int H, int D,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      long long o_sb, long long o_ss, long long o_sh,
                      int causal, float scale2, int dtype, int route,
                      int tile_rows, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k, v, o, nullptr, static_cast<float*>(lse), B, S, S, H,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, causal, scale2};
  return static_cast<int>(dispatch(a, D, dtype, route, tile_rows, stream));
}

// One query row a batch entry, without the lse (decode), split over keys:
// q / o (B, 1, H, D), k / v (B, Skv, H, D), q_pos0 (B,) int32 on the device
// (read when causal), strides and checks as attention_fwd. part: fp32
// scratch of B * H * ceil(Skv / chunk) * (D + 2) floats, which the two
// kernels leave as they like; chunk must be the kernel's kDecChunk (the
// wrapper's DECODE_CHUNK). Launches the split kernel, then the combine
// kernel; returns cudaGetLastError().
int attention_decode(const void* q, const void* k, const void* v, void* o,
                     const void* q_pos0, void* part, int B, int Skv, int H, int D,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     int causal, float scale2, int dtype, int chunk, void* stream) {
  if (B <= 0 || Skv <= 0 || H <= 0 || B > 65535 || H > 65535 || part == nullptr ||
      chunk != kDecChunk || (causal && q_pos0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k, v, o, static_cast<const int*>(q_pos0), nullptr, B, 1, Skv, H,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, causal, scale2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(part);
  if (dtype == port::kDtypeF32) return static_cast<int>(launch_decode_d<float>(a, D, f, s));
  if (dtype == port::kDtypeBF16)
    return static_cast<int>(launch_decode_d<__nv_bfloat16>(a, D, f, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
