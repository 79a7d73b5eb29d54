// Attention over the int8 KV cache (KV8) for Hopper (sm_90a), bound to
// Python with ctypes (C entry attention_kv8).
//
// The function is that of the "k_q" branches of dpu_operator_tpu/workloads/
// decode.py (_verify_one :238-256, prefill_chunk :428-448), XLA in the JAX
// package; ops/flash_attention.py::attention_kv8_plain is its plain version.
// q / o (B, Sq, H, D) in q's type (fp32 or bf16); k_q / v_q (B, Skv, H, D)
// int8 with one fp32 scale per (key, head), k_s / v_s (B, Skv, H, 1), the
// cache of init_kv_cache(kv_int8=True), read through its strides. Row i of
// batch b sits at q_pos0[b] + i and, when causal, admits key j iff j <=
// q_pos0[b] + i. Scores (q . k_q) * k_s / sqrt(D) in fp32, the softmax P in
// fp32, then out = sum_j round(P_j * v_s_j) * v_q_j: each product rounded
// to q's type, the sum in fp32, rounded once.
//
// P there is the row's normalized softmax, so round(P * v_s) needs the
// row's max m and sum l before the first product with V: rounding
// exp2(s - m_tile) * v_s against a running max (as the bf16 kernels round
// P) lands each product a bf16 step from the reference's, which went past
// the 1.5e-2 limit in bf16 at the verify shape. So every route takes the
// keys twice, first for m and l, then for round(exp2(s - m) / l * v_s) *
// v_q with the scores recomputed by the same arithmetic. The routes differ
// in where the statistics live between the two passes (the wrapper's
// _kv8_route picks one):
//
// * rows (1 <= Sq <= kRowsMax: decode, speculative verify):
//   attn_kv8_rows_kernel, one launch, compiled for each row count. One
//   thread-block cluster per (head, batch); its C CTAs (C = min(chunks, 8),
//   8 the portable cluster size) take the row's chunks of kDecChunk keys
//   anchored at key 0, chunk c on CTA c % C (a longer cache: each CTA walks
//   its chunks in order). A CTA reads its chunk's int8 K straight into
//   registers (16-byte loads) and stages V by cp.async, computes the rows'
//   scores on the tensor cores (mma.sync, K converted to fp16 exactly, fp32
//   sums) and each row's chunk (max, sum), and pushes those into every CTA
//   of the cluster (distributed shared memory); after a cluster barrier
//   each CTA folds them in chunk order, so all hold the same row m and l.
//   It then sums round(exp2(s - m) / l * v_s) * v_q over its keys on the
//   CUDA cores and pushes the partial to the CTAs that own its elements;
//   after a second barrier each CTA adds its elements' partials in rank
//   order (chunk order when C covers the row) and writes them. K and V
//   leave device memory once; nothing goes through global scratch. Bound:
//   bytes. (Measured on the H100: one thread a key on the CUDA cores, or a
//   kernel too large for the instruction cache, left the decode shape at
//   21-30 us; the per-CTA chain of dependent steps, not the memory, set
//   the time.)
// * tc (Sq > kRowsMax in bf16, D 64 / 128 / 256: prefill chunks, wide verify):
//   attn_fwd_kv8_tc_kernel, attn_fwd_tc_kernel's structure (consumer
//   warpgroups of 64 query rows, diagonal-only masking) with a converter
//   warpgroup in the producer's place: it reads the int8 tiles one tile
//   ahead and converts them to bf16 (exact: |x| <= 127) into a ring of
//   stages in the swizzled layout the wgmma descriptors read, with each
//   tile's scales. Pass 1 runs S = Q K^T on the tensor cores for m and l;
//   pass 2 recomputes S and feeds round(exp2(s - m) / l * v_s) as the
//   register A operand of the PV product against the converted v_q.
//   Bound: operations.
//   A bf16 head dim of 32 or less is padded to 64 by the wrapper.
// * tf32 (Sq > kRowsMax in fp32): attn_fwd_kv8_tf32_kernel
//   (attention_kv8_tf32.cu), the same two passes on the tensor cores by
//   mma.sync: int8 K and V exact in TF32, q and P' split into TF32 hi / lo,
//   two products a term. Bound: operations.
//
// A row's result depends only on its query, its keys and the route's fixed
// tiling (rows: kDecChunk and C; tc: key tiles of kBK; tf32: of 32), not on the
// other rows of the launch: row i of a rows launch at position p equals a
// one-row launch of the same query at p + i bit for bit.
#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "attention.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace attn;
namespace cg = cooperative_groups;

constexpr int kRouteKv8Rows = 1, kRouteKv8Tc = 2, kRouteKv8Tf32 = 3;
//: the most query rows the rows route takes (the wrapper's KV8_ROWS_MAX)
constexpr int kRowsMax = 8;
//: one thread a key of the chunk
constexpr int kRowsThreads = kDecChunk;
constexpr int kRowsWarps = kRowsThreads / 32;
//: the portable cluster size
constexpr int kClusterMax = 8;
//: the shared memory a block may use on the card (227 KB)
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(tc::smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------------- rows --
//: CTAs of the rows kernel an SM must hold for the decode grid (8 slots x
//: 12 heads x 8 CTAs) to run in one wave; it caps the registers at 72. At
//: D 256 a lane's quarter of four int8 K rows alone takes 64 registers: 4
//: CTAs an SM (128 registers) still hold the grid of the flagship's widths
//: at head dim 256 (8 slots x 6 heads x 8 CTAs) in one wave
template <int D>
__host__ __device__ constexpr int rows_ctas_per_sm() { return D > 128 ? 4 : 7; }

// barrier.cluster in two halves: arrive (release, or relaxed when it only
// marks this CTA as running) and wait (acquire). Every thread of every CTA
// of the cluster takes part.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d += a b on the tensor cores: m16n8k16, fp16 operands, fp32 sum. Lane
// (g, t) = (lane / 4, lane % 4) holds a as rows g, g + 8 x columns 2t,
// 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); b as rows 2t, 2t + 1
// (b[0]) and 2t + 8, 2t + 9 (b[1]) of column g; d as (row g, columns 2t,
// 2t + 1) in d[0], d[1] and row g + 8 in d[2], d[3].
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Four int8 (one 32-bit word, lowest byte first) as two fp16 pairs,
// exactly: a byte biased to x + 128 is the low mantissa byte of 1024 + x +
// 128 in fp16, and 1152 is subtracted.
__device__ __forceinline__ void int8x4_to_f16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  uint32_t x = __byte_perm(u, 0x64646464u, 0x4140), y = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 l = __hsub2(*reinterpret_cast<const __half2*>(&x), bias);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&y), bias);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  hi = *reinterpret_cast<const uint32_t*>(&h);
}

// Shared memory of attn_kv8_rows_kernel, in 4-byte words after the int8 V
// chunk (kDecChunk x D bytes), for R rows, nchl local chunks of nch, a
// cluster of C CTAs, head dim D and NP fp16 pieces of q; the kernel carves
// it in this order.
struct RowsSmem {
  int R, D, NP, nchl, nch, C, per;
  __host__ __device__ RowsSmem(int r, int d, int np, int n_local, int n, int c)
      : R(r), D(d), NP(np), nchl(n_local), nch(n), C(c), per((r * d + c - 1) / c) {}
  // the q rows as NP fp16 pieces (8 rows, zero past R; rows of D + 4
  // halves), then the partials pushed to this CTA (once q is no longer
  // read); each local chunk's scores, then round(P v_s) in place; this
  // CTA's partial output; each local chunk's (max, sum) a row and its keys'
  // v_s; every chunk's (max, sum) pushed to this CTA; each row's m and l;
  // the warps' maxima and sums; each q row's power-of-two scale
  __host__ __device__ int q_words() const {
    const int qh = NP * 8 * (D + 4) / 2;
    return qh > C * per ? qh : C * per;
  }
  __host__ __device__ int words() const {
    return q_words() + nchl * R * kDecChunk + R * D + 2 * nchl * R + nchl * kDecChunk +
           2 * nch * R + 2 * R + 2 * kRowsWarps * R + 8;
  }
  size_t bytes() const {
    return static_cast<size_t>(kDecChunk) * D + 4 * static_cast<size_t>(words());
  }
};

// Grid (C, H, B) in clusters of (C, 1, 1), kRowsThreads threads a CTA; nch
// = ceil(Skv / kDecChunk) chunks, nchl = ceil(nch / C) of them a CTA; R
// query rows. Scores on the tensor cores: each warp takes 32 keys as two
// 16-key tiles of m16n8k16 products, A the int8 K rows converted to fp16
// (exact) straight from device memory, B the R query rows (columns past R
// zero) in fp16 after a power-of-two scale per row: one piece for bf16 q
// (fp16 keeps bf16's 8 significant bits), three for fp32 q (q = hi + mid +
// lo). The product's k index is permuted so that lane (g, t) reads one
// contiguous quarter of each key row: physical column t D / 4 + 4 kk + i
// at k step kk. V is staged by cp.async while the scores are computed; in
// the PV pass (CUDA cores) a lane sums four columns over every KP-th key of
// the chunk and the warp's key phases are summed by shuffles. The
// statistics and the partial outputs are pushed into the CTAs that read
// them (remote stores before a cluster barrier), so after the last
// barrier no CTA touches another's shared memory. Every branch around a
// barrier is uniform over the CTA, and every CTA reaches each cluster
// barrier: a chunk past every row's keys contributes m = -inf, l = 0 and a
// zero partial, with no early return.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kRowsThreads, rows_ctas_per_sm<D>())
attn_kv8_rows_kernel(AttnArgs a, KvScales sc, int nch, int nchl) {
  constexpr int P16 = D / 16;                       // 16-byte pieces of a key row
  constexpr int NP = std::is_same<T, float>::value ? 3 : 1;  // fp16 pieces of q
  constexpr int QS = D + 4;                         // halves a staged q row
  constexpr int SEG = D / 4;                        // bytes of a lane's quarter row
  constexpr int QPW = D / 16;                       // PV: column quads a warp
  constexpr int KP = 32 / QPW;                      // PV: key phases a warp
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const RowsSmem L(R, D, NP, nchl, nch, C);
  extern __shared__ float4 rows_smem[];
  int8_t* vt = reinterpret_cast<int8_t*>(rows_smem);
  float* recv = reinterpret_cast<float*>(vt + kDecChunk * D);
  __half* qh = reinterpret_cast<__half*>(recv);
  float* sp = recv + L.q_words();
  float* part = sp + nchl * R * kDecChunk;
  float* stl = part + R * D;
  float* vsl = stl + 2 * nchl * R;
  float* m_all = vsl + nchl * kDecChunk;
  float* l_all = m_all + nch * R;
  float* ml = l_all + nch * R;
  float* red = ml + 2 * R;
  float* qexp = red + 2 * kRowsWarps * R;

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int lg = lane >> 2, lt = lane & 3;  // the lane's (g, t) in the mma maps
  const int pos0 = a.q_pos0 ? a.q_pos0[b] : 0;
  // the keys row r admits; the last row admits the most
  auto n_keys = [&](int r) { return a.causal ? min(pos0 + r + 1, a.Skv) : a.Skv; };
  const int n_max = n_keys(R - 1);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const int8_t* k = static_cast<const int8_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const int8_t* v = static_cast<const int8_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ksp = sc.ks + b * sc.ks_sb + h * sc.ks_sh;
  const float* vsp = sc.vs + b * sc.vs_sb + h * sc.vs_sh;

  cluster_arrive_relaxed();  // this CTA runs; waited for before the first remote store

  // rows [k0, k0 + nk) of V, 16 bytes a copy, as one cp.async group
  auto stage_v = [&](int k0, int nk) {
    for (int idx = t; idx < nk * P16; idx += kRowsThreads) {
      const int j = idx / P16, p = idx - j * P16;
      cp_async16(vt + j * D + 16 * p, v + (k0 + j) * a.v_ss + 16 * p);
    }
    cp_async_commit();
  };
  const int nk0 = min(kDecChunk, n_max - rank * kDecChunk);
  if (nk0 > 0 && nchl == 1) stage_v(rank * kDecChunk, nk0);  // in flight through pass 1
  for (int i = t; i < R * D; i += kRowsThreads) part[i] = 0.f;

  // pass 1: each local chunk's scores (kept) and each row's chunk (max, sum)
  for (int i = 0; i < nchl; ++i) {
    const int k0 = (rank + i * C) * kDecChunk;
    const int nk = min(kDecChunk, n_max - k0);  // the chunk's keys some row admits
    float* si = sp + i * R * kDecChunk;
    float* sti = stl + i * 2 * R;
    if (nk <= 0) {  // past every row's keys (and so are the later chunks)
      if (t < R) {
        sti[t] = kNegInf;
        sti[R + t] = 0.f;
      }
      continue;
    }
    // this lane's quarter of key rows 32 w + lg + 8 n (n = 0..3) and their k_s
    uint32_t kw[4][SEG / 4];
    float ksn[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = 32 * warp + lg + 8 * n;
      const int8_t* src = k + (k0 + key) * a.k_ss + lt * SEG;
#pragma unroll
      for (int c = 0; c < SEG / 16; ++c) {
        const int4 x = key < nk ? *reinterpret_cast<const int4*>(src + 16 * c) : make_int4(0, 0, 0, 0);
        kw[n][4 * c] = x.x;
        kw[n][4 * c + 1] = x.y;
        kw[n][4 * c + 2] = x.z;
        kw[n][4 * c + 3] = x.w;
      }
      if constexpr (SEG == 8) {
        const int2 x = key < nk ? *reinterpret_cast<const int2*>(src) : make_int2(0, 0);
        kw[n][0] = x.x;
        kw[n][1] = x.y;
      }
      ksn[n] = key < nk ? ksp[(k0 + key) * sc.ks_ss] : 0.f;
    }
    const float vsj = t < nk ? vsp[(k0 + t) * sc.vs_ss] : 0.f;
    if (i == 0) {
      // q as NP fp16 pieces, rows past R zero (its loads overlap K's):
      // warp w takes rows w and w + 4, each scaled by a power of two to a
      // largest |q| in [0.5, 1) (exact; undone on the scores), so fp16's
      // range holds any q
#pragma unroll
      for (int r = warp; r < 8; r += kRowsWarps) {
        float x[D / 32];
        float mx = 0.f;
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          x[c] = r < R ? port::to_f(q[r * a.q_ss + lane + 32 * c]) : 0.f;
          mx = fmaxf(mx, fabsf(x[c]));
        }
        // mx in [2^(E - 127), 2^(E - 126)): scale by 2^(126 - E), undo
        // by 2^(E - 126); a zero row (E = 0) keeps scale 1
        const int E = static_cast<int>(__float_as_uint(port::warp_max(mx)) >> 23);
        const bool scaled = E >= 1 && E <= 252;
        if (lane == 0) qexp[r] = scaled ? __uint_as_float(static_cast<uint32_t>(E + 1) << 23) : 1.f;
        const float qscale = scaled ? __uint_as_float(static_cast<uint32_t>(253 - E) << 23) : 1.f;
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          float y = __fmul_rn(x[c], qscale);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const __half hp = __float2half_rn(y);
            qh[(p * 8 + r) * QS + lane + 32 * c] = hp;
            y = y - __half2float(hp);
          }
        }
      }
    }
    vsl[i * kDecChunk + t] = vsj;
    __syncthreads();  // q staged; the previous chunk's warp maxima and sums read
    // S^T = K Q^T for the warp's two 16-key tiles
    float acc[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        int8x4_to_f16x2(kw[2 * mt][kk], af[mt][0], af[mt][2]);
        int8x4_to_f16x2(kw[2 * mt + 1][kk], af[mt][1], af[mt][3]);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint2 bf = *reinterpret_cast<const uint2*>(qh + (p * 8 + lg) * QS + lt * SEG + 4 * kk);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_16816(acc[mt], af[mt], bf);
      }
    }
    // lane (lg, lt) holds keys 32 w + 16 mt + lg (+ 8) x rows 2 lt, 2 lt + 1
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * lt + (e & 1), key = 32 * warp + 16 * mt + lg + 8 * (e >> 1);
        if (r < R)
          si[r * kDecChunk + key] =
              k0 + key < n_keys(r)
                  ? __fmul_rn(__fmul_rn(__fmul_rn(acc[mt][e], qexp[r]), ksn[2 * mt + (e >> 1)]),
                              a.scale2)
                  : kNegInf;
      }
    __syncthreads();
    // thread t takes key t: the chunk's max and sum of exp2(s - max) a row
    const int j = k0 + t;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m = port::warp_max(si[r * kDecChunk + t]);
      if (lane == 0) red[warp * R + r] = m;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mc = red[r];
#pragma unroll
      for (int w = 1; w < kRowsWarps; ++w) mc = fmaxf(mc, red[w * R + r]);
      const float p = j < n_keys(r) ? exp2f(si[r * kDecChunk + t] - mc) : 0.f;
      const float ls = port::warp_sum(p);
      if (lane == 0) red[(kRowsWarps + warp) * R + r] = ls;
      if (t == r) sti[r] = mc;
    }
    __syncthreads();
    if (t < R) {
      float ls = red[kRowsWarps * R + t];
#pragma unroll
      for (int w = 1; w < kRowsWarps; ++w) ls = __fadd_rn(ls, red[(kRowsWarps + w) * R + t]);
      sti[R + t] = ls;
    }
  }
  __syncthreads();  // the local statistics written
  cluster_wait();   // every CTA of the cluster runs
  // every local chunk's statistics into every CTA, chunk c at [c][r]
  for (int idx = t; idx < nchl * R * C; idx += kRowsThreads) {
    const int dst = idx % C, ir = idx / C, i = ir / R, r = ir - i * R;
    const int c = rank + i * C;
    if (c < nch) {
      cluster.map_shared_rank(m_all, dst)[c * R + r] = stl[i * 2 * R + r];
      cluster.map_shared_rank(l_all, dst)[c * R + r] = stl[i * 2 * R + R + r];
    }
  }
  cluster_arrive();
  cluster_wait();  // every chunk's statistics here

  // each row's m and l: the chunks' (max, sum) folded in chunk order
  if (t < R) {
    float m = kNegInf;
    for (int c = 0; c < nch; ++c) m = fmaxf(m, m_all[c * R + t]);
    float l = 0.f;
    for (int c = 0; c < nch; ++c) l = fmaf(l_all[c * R + t], exp2f(m_all[c * R + t] - m), l);
    ml[t] = m;
    ml[R + t] = l;
  }

  // pass 2: this CTA's partial sum of round(exp2(s - m) / l * v_s) * v_q.
  // Lane kp * QPW + qd of warp w sums columns 4 (QPW w + qd) .. + 3 over
  // keys kp, kp + KP, ... in order; the KP key phases are then summed by
  // shuffles.
  const int cq = QPW * warp + lane % QPW, kp = lane / QPW;
  for (int i = 0; i < nchl; ++i) {
    const int k0 = (rank + i * C) * kDecChunk;
    const int nk = min(kDecChunk, n_max - k0);
    if (nk <= 0) continue;
    float* si = sp + i * R * kDecChunk;
    __syncthreads();  // m and l written; the previous chunk's V read
    if (nchl > 1) stage_v(k0, nk);
    cp_async_wait_all();
    const int j = k0 + t;
    const float vsj = vsl[i * kDecChunk + t];
#pragma unroll
    for (int r = 0; r < R; ++r)
      si[r * kDecChunk + t] =
          j < n_keys(r)
              ? port::round_to<T>(__fmul_rn(
                    __fdiv_rn(exp2f(si[r * kDecChunk + t] - ml[r]), ml[R + r]), vsj))
              : 0.f;
    __syncthreads();
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int key = kp; key < nk; key += KP) {
      float vv[4];
      int8x4_to_f32(*reinterpret_cast<const uint32_t*>(vt + key * D + 4 * cq), vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = si[r * kDecChunk + key];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int o = QPW; o < 32; o <<= 1)
          acc[r][c] = __fadd_rn(acc[r][c], __shfl_xor_sync(0xffffffffu, acc[r][c], o));
        if (kp == 0) part[r * D + 4 * cq + c] = __fadd_rn(part[r * D + 4 * cq + c], acc[r][c]);
      }
  }
  __syncthreads();  // every partial element written
  // this CTA's partial into the CTAs that own its elements; recv reuses
  // q's words, which no CTA reads after the statistics barrier
  for (int idx = t; idx < R * D; idx += kRowsThreads) {
    const int owner = idx / L.per;
    cluster.map_shared_rank(recv, owner)[rank * L.per + idx - owner * L.per] = part[idx];
  }
  cluster_arrive();
  cluster_wait();  // every CTA's partial here; no remote access follows

  // the CTAs' partials added in rank order (chunk order when C covers the
  // row); this CTA writes elements [rank per, (rank + 1) per)
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int e = t; e < L.per; e += kRowsThreads) {
    const int idx = rank * L.per + e;
    if (idx >= R * D) break;
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum = __fadd_rn(sum, recv[c * L.per + e]);
    const int r = idx / D;
    o[r * a.o_ss + (idx - r * D)] = port::from_f<T>(sum);
  }
}

// ------------------------------------------------------------------- tc --
//: threads of the converter warpgroup
constexpr int kConvThreads = 128;

// Shared memory of attn_fwd_kv8_tc_kernel: the bf16 Q tile; a ring of
// kStages stages, each a converted bf16 K tile and V tile in the 128-byte
// swizzle; each stage's k_s and v_s of its kBK keys; the barriers. Three
// stages, two at D 256, where a stage takes 64 KB (three would leave 1 KB of
// the 227 KB; the O accumulator's 128 registers a thread allow one consumer
// warpgroup there).
template <int D, int NWG>
struct TcKv8Smem {
  static constexpr int kStages = D > 128 ? 2 : 3;
  static constexpr int kNH = D / 64;                     // 64-column blocks a row
  static constexpr uint32_t kQ = NWG * kNH * tc::kBlk;
  static constexpr uint32_t kTile = kNH * tc::kBlk;      // one converted tile
  static constexpr uint32_t kStage = 2 * kTile;          // K, then V
  static constexpr uint32_t kScales = 2 * kBK * 4;       // k_s, then v_s
  static constexpr uint32_t kBars = (1 + 2 * kStages) * 8;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t kBytes =
      kQ + kStages * (kStage + kScales) + kBars + 1024;
};

// Four int8 (one 32-bit word) as two bf16x2, exactly (|x| <= 127 fits
// bf16's 8-bit significand).
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  float f[4];
  int8x4_to_f32(w, f);
  return make_uint2(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]));
}

// One 16-byte piece (16 int8 columns 16 c16 ..) of row r of a tile,
// converted to bf16 into the 128-byte-swizzled block layout (tc::kBlk bytes
// a 64-column block, row r at 128 r, 16-byte chunk c at c ^ (r % 8)).
__device__ __forceinline__ void store_bf16_piece(uint8_t* tile, int r, int c16, int4 raw) {
  const uint2 a = int8x4_to_bf16(static_cast<uint32_t>(raw.x));
  const uint2 b = int8x4_to_bf16(static_cast<uint32_t>(raw.y));
  const uint2 c = int8x4_to_bf16(static_cast<uint32_t>(raw.z));
  const uint2 d = int8x4_to_bf16(static_cast<uint32_t>(raw.w));
  uint8_t* blk = tile + (c16 >> 2) * tc::kBlk + r * 128;
  const int c0 = (2 * c16) & 7;
  *reinterpret_cast<uint4*>(blk + ((c0 ^ (r & 7)) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<uint4*>(blk + (((c0 + 1) ^ (r & 7)) << 4)) = make_uint4(c.x, c.y, d.x, d.y);
}

// One block per (query tile of 64 NWG rows, head, batch): NWG consumer
// warpgroups and a converter warpgroup. The converter walks 2 nkb key
// tiles, K tiles 0 .. nkb - 1 for pass 1, then K and V tiles 0 .. nkb - 1
// for pass 2: it reads each int8 tile from device memory with 16-byte
// loads one tile ahead, converts it to bf16 (exact: |x| <= 127) into a
// stage of the ring with the tile's k_s and v_s, and releases the stage
// (one lane also loads the Q tile by TMA at the start). Per tile each
// consumer warpgroup runs
//   S = Q K^T by m64n64k16 over D, each column scaled by its k_s and
//   scale2, masked on the tiles that cross the diagonal or the ragged edge;
//   pass 1: the online max and sum over the four lanes of a quad;
//   pass 2: round(exp2(s - m) / l * v_s) to bf16 as the register A
//   operand, O += P v_q by m64nDk16 against the converted V tile.
// out = O rounded to bf16 (P is normalized: no division at the end).
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + kConvThreads, 1)
attn_fwd_kv8_tc_kernel(const __grid_constant__ CUtensorMap tq, AttnArgs a, KvScales sc) {
  using L = TcKv8Smem<D, NWG>;
  constexpr int NH = L::kNH;
  constexpr int BM = 64 * NWG;
  constexpr int kKv8TcStages = L::kStages;
  constexpr int NT = NWG * 128;                  // consumer threads
  constexpr int PPT = kBK * D / 16 / kConvThreads;  // 16-byte pieces a converter thread a tile
  extern __shared__ uint8_t kv8_smem[];
  uint8_t* qs = tc::align_1024(kv8_smem);
  uint8_t* stages = qs + L::kQ;
  float* scales = reinterpret_cast<float*>(stages + kKv8TcStages * L::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(scales + kKv8TcStages * 2 * kBK);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kKv8TcStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * BM;
  const int pos0 = a.q_pos0 ? a.q_pos0[b] : 0;
  const int nrows = min(BM, a.Sq - r0);
  const int nkb_all = (a.Skv + kBK - 1) / kBK;
  // key tiles the block's last row needs; a warpgroup may need fewer
  const int nkb = a.causal ? min(nkb_all, (pos0 + r0 + nrows - 1) / kBK + 1) : nkb_all;

  if (threadIdx.x == 0) {
    tc::mbar_init(full_q, 1);
    for (int s = 0; s < kKv8TcStages; ++s) {
      tc::mbar_init(&full[s], kConvThreads);
      tc::mbar_init(&empty[s], NT);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NT) {
    // the converter warpgroup
    const int ct = threadIdx.x - NT;
    if (ct == 0) {
      const int nq = (nrows + 63) / 64;  // warpgroups that hold rows
      tc::mbar_expect_tx(full_q, nq * NH * tc::kBlk);
      for (int w = 0; w < nq; ++w)
        for (int c = 0; c < NH; ++c)
          tc::tma_load_4d(qs + (w * NH + c) * tc::kBlk, &tq, full_q, 64 * c, h,
                          r0 + 64 * w, b);
    }
    const int8_t* k = static_cast<const int8_t*>(a.k) + b * a.k_sb + h * a.k_sh;
    const int8_t* v = static_cast<const int8_t*>(a.v) + b * a.v_sb + h * a.v_sh;
    // threads 0-63 take k_s of the tile's keys, 64-127 v_s
    const float* scp = ct < kBK ? sc.ks + b * sc.ks_sb + h * sc.ks_sh
                                : sc.vs + b * sc.vs_sb + h * sc.vs_sh;
    const long long sc_ss = ct < kBK ? sc.ks_ss : sc.vs_ss;
    // tile `it`'s int8 pieces and scale into registers (zeros past Skv)
    auto load = [&](int it, int4 (&kr)[PPT], int4 (&vr)[PPT], float& scr) {
      const bool pv = it >= nkb;
      const int j0 = (pv ? it - nkb : it) * kBK;
#pragma unroll
      for (int n = 0; n < PPT; ++n) {
        const int idx = ct + n * kConvThreads;
        const int key = j0 + idx / (D / 16), c16 = idx % (D / 16);
        const bool ok = key < a.Skv;
        kr[n] = ok ? *reinterpret_cast<const int4*>(k + key * a.k_ss + 16 * c16)
                   : make_int4(0, 0, 0, 0);
        vr[n] = ok && pv ? *reinterpret_cast<const int4*>(v + key * a.v_ss + 16 * c16)
                         : make_int4(0, 0, 0, 0);
      }
      const int key = j0 + (ct & (kBK - 1));
      scr = key < a.Skv && (pv || ct < kBK) ? scp[key * sc_ss] : 0.f;
    };
    int4 kr[PPT], vr[PPT];
    float scr;
    load(0, kr, vr, scr);
    for (int it = 0; it < 2 * nkb; ++it) {
      const int s = it % kKv8TcStages, u = it / kKv8TcStages;
      int4 kn[PPT], vn[PPT];
      float scn = 0.f;
      if (it + 1 < 2 * nkb) load(it + 1, kn, vn, scn);  // one tile ahead
      if (u > 0) tc::mbar_wait(&empty[s], (u - 1) & 1);
      uint8_t* st = stages + s * L::kStage;
#pragma unroll
      for (int n = 0; n < PPT; ++n) {
        const int idx = ct + n * kConvThreads;
        store_bf16_piece(st, idx / (D / 16), idx % (D / 16), kr[n]);
        if (it >= nkb) store_bf16_piece(st + L::kTile, idx / (D / 16), idx % (D / 16), vr[n]);
      }
      scales[s * 2 * kBK + ct] = scr;
      tc::fence_proxy_async();  // the tiles are read by wgmma
      tc::mbar_arrive(&full[s]);
#pragma unroll
      for (int n = 0; n < PPT; ++n) {
        kr[n] = kn[n];
        vr[n] = vn[n];
      }
      scr = scn;
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

    for (int it = 0; it < 2 * nkb; ++it) {
      const bool pv = it >= nkb;
      const int kb = pv ? it - nkb : it;
      const int s = it % kKv8TcStages;
      tc::mbar_wait(&full[s], (it / kKv8TcStages) & 1);
      if (kb < nkb_w) {
        const uint8_t* kb16 = stages + s * L::kStage;
        const uint8_t* vb16 = kb16 + L::kTile;
        const float* ksc = scales + s * 2 * kBK;
        const float* vsc = ksc + kBK;
        // S = Q K^T, scaled into the exp2 domain column by column, masked:
        // the same arithmetic in both passes, so the same scores
        float x[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_m64n64k16_ss<0>(x, tc::desc_k(qw, kk), tc::desc_k(kb16, kk), kk > 0);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_regs(x);
        const int j0 = kb * kBK;
        const bool masked = kb >= n_full;  // only diagonal / ragged tiles
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + c0 + e;
            const float kscale = ksc[col];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float y = __fmul_rn(__fmul_rn(x[4 * j + 2 * r + e], kscale), a.scale2);
              if (masked && (j0 + col >= a.Skv || (a.causal && j0 + col > prow[r])))
                y = kNegInf;
              x[4 * j + 2 * r + e] = y;
            }
          }

        if (!pv) {
          // pass 1: the rows' online max and sum (row lr in x[4 j + 0 / 1],
          // row lr + 8 in x[4 j + 2 / 3]; the quad's four lanes share a row)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float bm = kNegInf;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              bm = fmaxf(bm, fmaxf(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]));
            bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
            bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
            const float mn = fmaxf(m[r], bm);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              ps += exp2f(x[4 * j + 2 * r] - mn) + exp2f(x[4 * j + 2 * r + 1] - mn);
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            l[r] = l[r] * exp2f(m[r] - mn) + ps;
            m[r] = mn;
          }
        } else {
          // pass 2: round(exp2(s - m) / l * v_s) to bf16 as the A operand of
          // k16 step j / 2 (row lr in a[0] / a[2], row lr + 8 in a[1] / a[3])
          const float il[2] = {1.f / l[0], 1.f / l[1]};
          uint32_t pa[4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              p[i] = exp2f(x[4 * j + i] - m[i >> 1]) * il[i >> 1] * vsc[8 * j + c0 + (i & 1)];
            pa[j >> 1][2 * (j & 1)] = tc::pack_bf16(p[0], p[1]);
            pa[j >> 1][2 * (j & 1) + 1] = tc::pack_bf16(p[2], p[3]);
          }
          tc::wg_fence();
#pragma unroll
          for (int t = 0; t < 4; ++t) tc::mma_rs<D, 1>(o, pa[t], tc::desc_t(vb16, t), 1);
          tc::wg_commit();
          tc::wg_wait<0>();
          tc::fence_regs(o);
#pragma unroll
          for (int t = 0; t < 4; ++t) tc::fence_regs(pa[t]);
        }
      }
      tc::mbar_arrive(&empty[s]);  // this thread is done with stage s
    }

    if (wrows > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lr + 8 * r;
        if (row >= wrows) continue;
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh +
                              static_cast<long long>(rw + row) * a.o_ss + c0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ----------------------------------------------------------- launching --
template <typename T, int D, int R>
cudaError_t launch_rows(const AttnArgs& a, const KvScales& sc, cudaStream_t stream) {
  const int nch = (a.Skv + kDecChunk - 1) / kDecChunk;
  const int C = nch < kClusterMax ? nch : kClusterMax;
  const int nchl = (nch + C - 1) / C;
  const size_t smem =
      RowsSmem(R, D, std::is_same<T, float>::value ? 3 : 1, nchl, nch, C).bytes();
  if (smem > kSmemMax) return cudaErrorInvalidValue;  // a cache row too long
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kv8_rows_kernel<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.H, a.B);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_kv8_rows_kernel<T, D, R>, a, sc, nch, nchl);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The rows kernel is compiled for each row count 1 .. kRowsMax.
template <typename T, int D>
cudaError_t launch_rows_r(const AttnArgs& a, const KvScales& sc, cudaStream_t stream) {
  static_assert(kRowsMax == 8, "one case a row count");
  switch (a.Sq) {
    case 1: return launch_rows<T, D, 1>(a, sc, stream);
    case 2: return launch_rows<T, D, 2>(a, sc, stream);
    case 3: return launch_rows<T, D, 3>(a, sc, stream);
    case 4: return launch_rows<T, D, 4>(a, sc, stream);
    case 5: return launch_rows<T, D, 5>(a, sc, stream);
    case 6: return launch_rows<T, D, 6>(a, sc, stream);
    case 7: return launch_rows<T, D, 7>(a, sc, stream);
    case 8: return launch_rows<T, D, 8>(a, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, int NWG>
cudaError_t launch_tc(const AttnArgs& a, const KvScales& sc, cudaStream_t stream) {
  using L = TcKv8Smem<D, NWG>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kv8_tc_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tq;
  if (!tc::encode_bshd(&tq, a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, a.q_sh))
    return static_cast<cudaError_t>(port::kErrTensorMap);
  const dim3 grid((a.Sq + 64 * NWG - 1) / (64 * NWG), a.H, a.B);
  attn_fwd_kv8_tc_kernel<D, NWG><<<grid, NWG * 128 + kConvThreads, L::kBytes, stream>>>(tq, a, sc);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_route(const AttnArgs& a, const KvScales& sc, int route, int tile_rows,
                         cudaStream_t stream) {
  if (route == kRouteKv8Rows) return launch_rows_r<T, D>(a, sc, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D != 32) {
    if constexpr (D != 256)
      if (tile_rows == 128) return launch_tc<D, 2>(a, sc, stream);
    if (tile_rows == 64) return launch_tc<D, 1>(a, sc, stream);
  }
  // tc: bf16 at D 64 / 128 (64 or 128 rows a block) or 256 (64 rows)
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(const AttnArgs& a, const KvScales& sc, int d, int route, int tile_rows,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch_route<T, 32>(a, sc, route, tile_rows, stream);
    case 64: return launch_route<T, 64>(a, sc, route, tile_rows, stream);
    case 128: return launch_route<T, 128>(a, sc, route, tile_rows, stream);
    case 256: return launch_route<T, 256>(a, sc, route, tile_rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Attention over the int8 KV cache (KV8): q / o (B, Sq, H, D) in dtype (0
// fp32, 1 bf16), k_q / v_q (B, Skv, H, D) int8, k_s / v_s (B, Skv, H, 1)
// fp32; element strides for the batch, key (or row) and head dimensions of
// q, k_q, k_s, v_q, v_s and o, in that order; q_pos0 (B,) int32 on the
// device (read when causal). D in {32, 64, 128, 256}. q, k_q, v_q and o
// 16-byte aligned with strides of 16 bytes (the wrapper checks). route 1
// (rows): 1 <= Sq <= kRowsMax, chunk the kernel's kDecChunk, one cluster
// launch; route 2 (tc): bf16 at D 64 or 128 with tile_rows 64 or 128 query
// rows a block, at D 256 with 64; route 3 (tf32): fp32, any Sq, 16 query
// rows a block (attention_kv8_tf32.cu; tile_rows is not read). Returns
// cudaGetLastError() (or the cluster launch's error), or an error without
// launching when the arguments do not fit the route.
int attention_kv8(const void* q, const void* k_q, const void* k_s, const void* v_q,
                  const void* v_s, void* o, const void* q_pos0, int B, int Sq, int Skv,
                  int H, int D,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long kq_sb, long long kq_ss, long long kq_sh,
                  long long ks_sb, long long ks_ss, long long ks_sh,
                  long long vq_sb, long long vq_ss, long long vq_sh,
                  long long vs_sb, long long vs_ss, long long vs_sh,
                  long long o_sb, long long o_ss, long long o_sh,
                  int causal, float scale2, int dtype, int route, int chunk,
                  int tile_rows, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      k_s == nullptr || v_s == nullptr || (causal && q_pos0 == nullptr) ||
      (route != kRouteKv8Rows && route != kRouteKv8Tc && route != kRouteKv8Tf32) ||
      (route == kRouteKv8Rows && (Sq > kRowsMax || chunk != kDecChunk)))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k_q, v_q, o, static_cast<const int*>(q_pos0), nullptr, B, Sq, Skv, H,
             q_sb, q_ss, q_sh, kq_sb, kq_ss, kq_sh, vq_sb, vq_ss, vq_sh,
             o_sb, o_ss, o_sh, causal, scale2};
  const KvScales sc{static_cast<const float*>(k_s), static_cast<const float*>(v_s),
                    ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteKv8Tf32)
    return static_cast<int>(dtype == port::kDtypeF32 ? launch_kv8_tf32(a, sc, D, s)
                                                     : cudaErrorInvalidValue);
  if (dtype == port::kDtypeF32)
    return static_cast<int>(launch_d<float>(a, sc, D, route, tile_rows, s));
  if (dtype == port::kDtypeBF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(a, sc, D, route, tile_rows, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
