// The fp32 attention over the int8 KV cache (KV8) past kRowsMax query rows
// (prefill chunks, wide verify) on Hopper's tensor cores (sm_90a):
// attn_fwd_kv8_tf32_kernel, launched through attention_kv8.cu's C entry
// attention_kv8 (route 3).
//
// The function is attention_kv8.cu's (the "k_q" branch of dpu_operator_tpu/
// workloads/decode.py::prefill_chunk :428-448, XLA in the JAX package;
// ops/flash_attention.py::attention_kv8_plain is its plain version), in the
// two passes every KV8 route takes: scores (q . k_q) k_s scale2 in fp32;
// pass 1 each row's max m and sum l; pass 2 out = sum_j P'_j v_q_j with
// P' = exp2(s - m) / l * v_s in fp32 (fp32's rounding of P' v_s is none).
// Bound: operations (2 D a score in each pass, 2 D a P V term), at the
// TF32 rate in two products a term.
//
// Why two TF32 products. An int8 value is exact in TF32 (7 significant
// bits of its 11), so K and V need no split: only q and P' do. q = q_hi +
// q_lo and P' = P'_hi + P'_lo, each part a TF32 value (tf32::split), and
//   S = q_hi K + q_lo K,   P' V = P'_hi V + P'_lo V
// in fp32 accumulators: a TF32 x TF32 product is exact in fp32, so all
// that is lost is the dropped tail of q or P' (about 2^-22 of it), fp32
// noise (tests/test_torch_tc.py emulates this on the CPU, and shows one
// product of the rounded q and P' missing fp32's limit).
//
// Design: mma.sync m16n8k8 (tf32.cuh), not TF32 wgmma. wgmma reads a TF32
// B operand only K-major from swizzled shared memory, so K and V would have
// to be converted to fp32 there (four times the bytes of the int8 tile, V
// transposed) by a converter warpgroup, and a block would be a warpgroup of
// 64 rows: the 256-row chunk's 12 heads would make 48 blocks for 132 SMs.
// With mma.sync each lane reads its fragments' int8 bytes straight from the
// staged tile, four at a time, and converts them exactly in registers
// (int8x4_to_f32). One block of kKS = 4 warps per (16 query rows, head,
// batch), heaviest first; the warps split the rows' key tiles (warp w takes
// tiles w, w + 4, ...), since 16 rows a warp alone would leave most SMs
// one or two warps at the chunk shape, whose chains of dependent
// instructions would then set the time. Per block:
// * Q is split into TF32 hi / lo once and stored in shared memory as the
//   fragments it feeds (a lane's hi and lo uint4 a k step: two
//   conflict-free 16-byte loads a k step); the warps split the work.
// * The k index of S = Q K^T is permuted so that a lane's fragments of a
//   key row are four consecutive bytes: k steps 2p and 2p + 1 take columns
//   16 p + 4 t .. + 3 (t = lane % 4), one 32-bit load for two steps. The n
//   index of O = P' V likewise: n fragment 4 nn + i, column g (g = lane /
//   4) reads column 32 nn + 4 g + i, so one 32-bit load of a V row serves
//   four fragments, and a row's output columns come out as two float4
//   stores of eight consecutive columns. P' goes from the S accumulator to
//   the A operand with acc_to_a (keys 2t, 2t + 1 of each group of 8), so V
//   is read at those rows.
// * Each warp stages its key tiles of kTK keys (int8 K, then V in pass 2,
//   with their k_s / v_s) by cp.async one tile ahead into two buffers of
//   its own; K / V rows are D + 16 bytes, which puts every fragment load of
//   a warp on distinct banks at each head dim.
// * Pass 1: each warp's online (m, l) over its tiles; the four are folded
//   in warp order through shared memory. Pass 2: each warp's O over its
//   tiles with the rows' m and l, recomputing S by the same instructions
//   (the same scores bit for bit); only tiles that cross the diagonal or
//   the ragged edge are masked. The four O partials are added in warp order
//   (no atomics).
// Shared memory: Q 16 D x 16 bytes plus each warp's two stages of 2 kTK
// (D + 16) bytes and scales: 90.5 KB at D 128 (two blocks an SM), 170.5 KB
// at D 256. O is D / 2 fp32 registers a thread (128 at D 256).
//
// A row's result depends only on its query, its keys and the fixed key
// tiling (tiles of kTK anchored at key 0, tile kb on warp kb % 4): a key
// tile that a row does not reach adds exact zeros (a warp none of whose
// tiles a row reaches keeps m = -inf, l = 0), so a chunked prefill equals
// the whole prefill row for row. Two launches are equal.
#include "attention.cuh"
#include "tf32.cuh"

namespace {

using namespace attn;

constexpr int kKS = 4;   // warps a block, each a quarter of the key tiles
constexpr int kTK = 32;  // keys a tile (tiles anchored at key 0)

template <int D>
struct Kv8Tf32Smem {
  static constexpr int kRow = D + 16;  // bytes a staged int8 row
  // the block's Q fragments: a hi and a lo uint4 a lane a k step
  static constexpr size_t kQ = static_cast<size_t>(D / 8) * 2 * 32 * 16;
  static constexpr size_t kTile = static_cast<size_t>(kTK) * kRow;  // int8 K (V alike)
  static constexpr size_t kStage = 2 * kTile + 2 * kTK * sizeof(float);  // K, V, k_s, v_s
  static constexpr size_t kWarp = 2 * kStage;  // a warp's two buffers
  static constexpr size_t kStats = 2 * kKS * 16 * sizeof(float);  // each warp's m, l a row
  static constexpr size_t kBytes = kQ + kKS * kWarp + kStats;
  // each warp's O partial (16 rows of D fp32) in its buffers at the end
  static_assert(16 * D * sizeof(float) <= kWarp, "partial space");
};

// Rows [0, kTK) of an int8 (keys, D) slice into a tile of D + 16-byte rows
// by the warp's cp.async (16 bytes a copy); rows at or past `valid` are
// zero-filled.
template <int D>
__device__ __forceinline__ void stage_int8(uint8_t* dst, const int8_t* src,
                                           long long row_stride, int valid, int lane) {
  constexpr int kPer = D / 16;
  for (int idx = lane; idx < kTK * kPer; idx += 32) {
    const int r = idx / kPer, c = (idx - r * kPer) * 16;
    const bool ok = r < valid;
    tf32::cp_async16(dst + r * (D + 16) + c, src + (ok ? r * row_stride + c : 0), ok);
  }
}

// k step kk's A fragment of Q (hi and lo parts).
__device__ __forceinline__ tf32::Frag<4> q_frag(const uint4* qf, int kk, int lane) {
  const uint4 h = qf[kk * 64 + lane], l = qf[kk * 64 + 32 + lane];
  return {{h.x, h.y, h.z, h.w}, {l.x, l.y, l.z, l.w}};
}

// d += a b with b exact in TF32 (int8 values): a's lo part, then its hi part.
__device__ __forceinline__ void mma2(float (&d)[4], const tf32::Frag<4>& a,
                                     const uint32_t (&b)[2]) {
  tf32::mma(d, a.lo, b);
  tf32::mma(d, a.hi, b);
}

// S = Q K^T of the block's 16 rows against the kTK keys of tile kt, 8 keys
// an n fragment (sc[j]: keys 8 j + 2 t, + 1 of rows g, g + 8).
template <int D>
__device__ __forceinline__ void scores(float (&sc)[kTK / 8][4], const uint4* qf,
                                       const uint8_t* kt, int lane, int g, int t) {
  constexpr int kRow = D + 16;
#pragma unroll
  for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 2
  for (int p = 0; p < D / 16; ++p) {
    const tf32::Frag<4> q0 = q_frag(qf, 2 * p, lane), q1 = q_frag(qf, 2 * p + 1, lane);
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j) {
      float f[4];
      int8x4_to_f32(*reinterpret_cast<const uint32_t*>(kt + (8 * j + g) * kRow + 16 * p + 4 * t),
                    f);
      const uint32_t b0[2] = {__float_as_uint(f[0]), __float_as_uint(f[1])};
      const uint32_t b1[2] = {__float_as_uint(f[2]), __float_as_uint(f[3])};
      mma2(sc[j], q0, b0);
      mma2(sc[j], q1, b1);
    }
  }
}

// One block of kKS warps per (query tile of 16 rows, head, batch), heaviest
// tiles first. Warp w takes key tiles w, w + kKS, ... of the nkb the tile's
// last row needs: pass 1 over them, the warps' (m, l) folded in warp order,
// pass 2 over them, the warps' O partials added in warp order.
template <int D>
__global__ void __launch_bounds__(kKS * 32, 1)
attn_fwd_kv8_tf32_kernel(AttnArgs a, KvScales sc) {
  using L = Kv8Tf32Smem<D>;
  constexpr int NJ = kTK / 8, kRow = L::kRow;
  extern __shared__ float4 kv8t_smem[];
  uint4* qf = reinterpret_cast<uint4*>(kv8t_smem);
  uint8_t* stg = reinterpret_cast<uint8_t*>(kv8t_smem) + L::kQ;
  float* stats = reinterpret_cast<float*>(stg + kKS * L::kWarp);  // [m, l][kKS][16]

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 16;  // heaviest tiles first
  const int nrows = min(16, a.Sq - r0);
  const int pos0 = a.q_pos0 ? a.q_pos0[b] : 0;
  const int p_lo = pos0 + r0, p_hi = pos0 + r0 + nrows - 1;
  const int nkb_all = (a.Skv + kTK - 1) / kTK;
  // key tiles the tile's last row needs
  const int nkb = a.causal ? min(nkb_all, p_hi / kTK + 1) : nkb_all;
  // tiles wholly at or below the tile's first row need no mask
  int n_full = a.Skv / kTK;
  if (a.causal) n_full = min(n_full, (p_lo + 1) / kTK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's tiles a pass: kb = warp + kKS i, i < nw
  const int nw = nkb > warp ? (nkb - warp + kKS - 1) / kKS : 0;
  const int8_t* k = static_cast<const int8_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const int8_t* v = static_cast<const int8_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ksp = sc.ks + b * sc.ks_sb + h * sc.ks_sh;
  const float* vsp = sc.vs + b * sc.vs_sb + h * sc.vs_sh;
  uint8_t* wst = stg + warp * L::kWarp;
  // the warp's iteration it (pass 1: it < nw, pass 2: it - nw) into its
  // buffer it % 2: K, and V in pass 2, with their scales
  auto stage = [&](int it) {
    const bool pv = it >= nw;
    const int j0 = (warp + kKS * (pv ? it - nw : it)) * kTK, valid = min(kTK, a.Skv - j0);
    uint8_t* st = wst + (it & 1) * L::kStage;
    stage_int8<D>(st, k + j0 * a.k_ss, a.k_ss, valid, lane);
    if (pv) stage_int8<D>(st + L::kTile, v + j0 * a.v_ss, a.v_ss, valid, lane);
    float* scs = reinterpret_cast<float*>(st + 2 * L::kTile);
    const bool ok = lane < valid;
    tf32::cp_async4(scs + lane, ksp + (ok ? (j0 + lane) * sc.ks_ss : 0), ok);
    if (pv) tf32::cp_async4(scs + kTK + lane, vsp + (ok ? (j0 + lane) * sc.vs_ss : 0), ok);
  };
  if (nw > 0) stage(0);
  tf32::cp_commit();

  // Q split into TF32 hi / lo once, as the A fragments: k step 2 p + s of
  // rows g, g + 8 takes columns 16 p + 4 t + 2 s (slot t) and + 1 (slot
  // t + 4), so one float4 of each row serves two steps; the warps split
  // the k-step pairs
  {
    const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bool ok0 = g < nrows, ok1 = g + 8 < nrows;
    const float* q0 = q + static_cast<long long>(r0 + g) * a.q_ss + 4 * t;
    const float* q1 = q + static_cast<long long>(r0 + g + 8) * a.q_ss + 4 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = warp; p < D / 16; p += kKS) {
      const float4 x = ok0 ? *reinterpret_cast<const float4*>(q0 + 16 * p) : zero;
      const float4 y = ok1 ? *reinterpret_cast<const float4*>(q1 + 16 * p) : zero;
      uint4 hi, lo;
      tf32::split(x.x, hi.x, lo.x);
      tf32::split(y.x, hi.y, lo.y);
      tf32::split(x.y, hi.z, lo.z);
      tf32::split(y.y, hi.w, lo.w);
      qf[2 * p * 64 + lane] = hi;
      qf[2 * p * 64 + 32 + lane] = lo;
      tf32::split(x.z, hi.x, lo.x);
      tf32::split(y.z, hi.y, lo.y);
      tf32::split(x.w, hi.z, lo.z);
      tf32::split(y.w, hi.w, lo.w);
      qf[(2 * p + 1) * 64 + lane] = hi;
      qf[(2 * p + 1) * 64 + 32 + lane] = lo;
    }
  }
  __syncthreads();  // every warp's share of Q

  // this thread's rows g and g + 8, and its keys 8 j + 2 t (+ 1) of every
  // key tile (the accumulator map)
  const int prow[2] = {pos0 + r0 + g, pos0 + r0 + g + 8};
  // tile kb's scores, into the exp2 domain column by column, masked on the
  // tiles that cross the diagonal or the ragged edge: the same arithmetic
  // in both passes, so the same scores
  auto scaled_scores = [&](float (&x)[NJ][4], const uint8_t* kt, int kb) {
    const float* ksc = reinterpret_cast<const float*>(kt + 2 * L::kTile);
    scores<D>(x, qf, kt, lane, g, t);
    const int j0 = kb * kTK;
    const bool masked = kb >= n_full;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float y = __fmul_rn(__fmul_rn(x[j][e], ksc[col]), a.scale2);
        if (masked && (j0 + col >= a.Skv || (a.causal && j0 + col > prow[e >> 1])))
          y = kNegInf;
        x[j][e] = y;
      }
  };

  // pass 1: the rows' online max and sum over this warp's tiles (the quad's
  // four lanes share a row); a warp whose tiles a row does not reach keeps
  // m = -inf, l = 0 (the max subtracted is 0 while m is -inf)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int i = 0; i < nw; ++i) {
    stage(i + 1);  // pass 1's next tile, or pass 2's first after the last
    tf32::cp_commit();
    tf32::cp_wait<1>();  // tile i landed for this lane ...
    __syncwarp();        // ... and for every lane of the warp
    float x[NJ][4];
    scaled_scores(x, wst + (i & 1) * L::kStage, warp + kKS * i);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float bm = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) bm = fmaxf(bm, fmaxf(x[j][2 * r], x[j][2 * r + 1]));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
      const float mn = fmaxf(m[r], bm);
      const float ms = mn == kNegInf ? 0.f : mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ps += exp2f(x[j][2 * r] - ms) + exp2f(x[j][2 * r + 1] - ms);
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[r] = l[r] * exp2f(m[r] - ms) + ps;
      m[r] = mn;
    }
    __syncwarp();  // every lane is done with buffer i % 2 before it refills
  }
  // the warps' (m, l) folded in warp order: every warp holds the rows' m, l
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stats[warp * 16 + g + 8 * r] = m[r];
      stats[(kKS + warp) * 16 + g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  float il[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = kNegInf, lr = 0.f;
#pragma unroll
    for (int w = 0; w < kKS; ++w) mr = fmaxf(mr, stats[w * 16 + g + 8 * r]);
#pragma unroll
    for (int w = 0; w < kKS; ++w)
      lr += stats[(kKS + w) * 16 + g + 8 * r] * exp2f(stats[w * 16 + g + 8 * r] - mr);
    m[r] = mr;
    il[r] = 1.f / lr;
  }

  // pass 2: O += P' V, P' = exp2(s - m) / l * v_s from the accumulator as
  // the A operand (keys 8 j + 2 t, + 1 in the permuted k order), V rows
  // 8 j + 2 t, + 1 read four n fragments a word
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int i = 0; i < nw; ++i) {
    if (i + 1 < nw) stage(nw + i + 1);
    tf32::cp_commit();
    tf32::cp_wait<1>();
    __syncwarp();
    const uint8_t* kt = wst + ((nw + i) & 1) * L::kStage;
    const uint8_t* vt = kt + L::kTile;
    const float* vsc = reinterpret_cast<const float*>(kt + 2 * L::kTile) + kTK;
    float x[NJ][4];
    scaled_scores(x, kt, warp + kKS * i);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = exp2f(x[j][e] - m[e >> 1]) * il[e >> 1] * vsc[8 * j + 2 * t + (e & 1)];
      const tf32::Frag<4> fp = tf32::acc_to_a(p);
      const uint8_t* v0 = vt + (8 * j + 2 * t) * kRow + 4 * g;
#pragma unroll
      for (int nn = 0; nn < D / 32; ++nn) {
        float f0[4], f1[4];
        int8x4_to_f32(*reinterpret_cast<const uint32_t*>(v0 + 32 * nn), f0);
        int8x4_to_f32(*reinterpret_cast<const uint32_t*>(v0 + kRow + 32 * nn), f1);
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const uint32_t bv[2] = {__float_as_uint(f0[i4]), __float_as_uint(f1[i4])};
          mma2(o[4 * nn + i4], fp, bv);
        }
      }
    }
    __syncwarp();
  }
  tf32::cp_wait<0>();
  __syncwarp();

  // the warp's partial into its buffers, row-major: row g (+ 8), n fragment
  // 4 nn + i holds columns 32 nn + 8 t + i (c0 / c2) and 32 nn + 8 t + 4 + i
  // (c1 / c3)
  float* part = reinterpret_cast<float*>(wst);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* prow_o = part + (g + 8 * r) * D + 8 * t;
#pragma unroll
    for (int nn = 0; nn < D / 32; ++nn) {
      *reinterpret_cast<float4*>(prow_o + 32 * nn) =
          make_float4(o[4 * nn][2 * r], o[4 * nn + 1][2 * r], o[4 * nn + 2][2 * r],
                      o[4 * nn + 3][2 * r]);
      *reinterpret_cast<float4*>(prow_o + 32 * nn + 4) =
          make_float4(o[4 * nn][2 * r + 1], o[4 * nn + 1][2 * r + 1], o[4 * nn + 2][2 * r + 1],
                      o[4 * nn + 3][2 * r + 1]);
    }
  }
  __syncthreads();
  // the partials added in warp order, four columns a thread
  for (int idx = threadIdx.x; idx < 16 * D / 4; idx += kKS * 32) {
    const int row = idx / (D / 4), c = (idx - row * (D / 4)) * 4;
    if (row >= nrows) break;
    float4 sum = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(stg) +
                                                  row * D + c);
#pragma unroll
    for (int w = 1; w < kKS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(stg + w * L::kWarp) + row * D + c);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    *reinterpret_cast<float4*>(static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh +
                               static_cast<long long>(r0 + row) * a.o_ss + c) = sum;
  }
}

template <int D>
cudaError_t launch(const AttnArgs& a, const KvScales& sc, cudaStream_t stream) {
  using L = Kv8Tf32Smem<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kv8_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.Sq + 15) / 16, a.H, a.B);
  attn_fwd_kv8_tf32_kernel<D><<<grid, kKS * 32, L::kBytes, stream>>>(a, sc);
  return cudaGetLastError();
}

}  // namespace

namespace attn {

cudaError_t launch_kv8_tf32(const AttnArgs& a, const KvScales& sc, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32>(a, sc, stream);
    case 64: return launch<64>(a, sc, stream);
    case 128: return launch<128>(a, sc, stream);
    case 256: return launch<256>(a, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
