// 3xTF32 building blocks for the fp32 attention kernels on Hopper's tensor
// cores (flash_attention_fwd.cu: attn_fwd_tf32_kernel, on TF32 wgmma;
// flash_attention_bwd.cu: attn_bwd_dkv_tf32_kernel, on mma.sync): the
// operand split, the m16n8k8 TF32 product of mma.sync, fragment loads from
// fp32 tiles in shared memory, and cp.async staging of strided fp32 rows.
//
// Why three products. A TF32 value keeps 10 explicit mantissa bits, so one
// TF32 product of fp32 operands is good to about 3 decimal digits, and an
// attention output would miss fp32's limit (1e-4 scaled) by far. Each fp32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (both rounded to
// nearest, ties away, as cvt.rna rounds), and A B is taken as
//   A_lo B_hi + A_hi B_lo + A_hi B_hi
// in fp32 accumulators; the dropped A_lo B_lo and the rounding of lo stay
// near 2^-22 of |A| |B|, fp32 noise (tests/test_torch_tc.py emulates the
// split on the CPU and measures both designs). The operands are finite:
// attention's inputs, P in [0, 1] and dS.
//
// mma.sync fragments (the dK/dV kernel). wgmma takes TF32 operands only
// K-major from shared memory, so the dV and dK products would need Q and dO
// transposed as well as staged as they are. mma.sync m16n8k8 loads its
// fragments from registers, and those come from padded shared memory in
// either layout, so every product reads the tiles as they were staged (rows
// of D + 4 floats: every fragment load below is free of bank conflicts). The
// B operand of a product over rows of a tile (dO in P^T dO) is read with the
// k index permuted: k-step column t holds row 2t and column t + 4 holds row
// 2t + 1, which is exactly how the accumulator of the previous product holds
// P (c0 / c1: columns 2t, 2t + 1), so P and dS go from accumulator to A
// operand in registers, with no shuffle. The forward's wgmma takes the same
// permutation into the transposed V it stages.
//
// Fragment maps (PTX mma.m16n8k8 .tf32, g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32 {

// x rounded to TF32: to nearest on the top 10 mantissa bits, ties away
// from zero, as cvt.rna.tf32.f32 rounds a finite x. Adding half of the
// dropped 13 bits' range to the bit pattern carries into the kept bits
// exactly when the dropped part is at least half a step, whatever the sign.
// Two integer instructions; cvt.rna lowers to a compare, a predicated add
// and a mask on sm_90a, and the split runs for every operand element the
// kernels load, so it sets their instruction count.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 2^-22 of |x|, each a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 step in TF32 with an fp32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A split operand fragment: hi and lo parts.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

// d += A B in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The two small terms into `small`, the large one into `big`: two
// independent accumulator chains (the caller adds them once at the end).
__device__ __forceinline__ void mma3_split(float (&big)[4], float (&small)[4],
                                           const Frag<4>& a, const Frag<2>& b) {
  mma(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma(big, a.hi, b.hi);
}

// A fragment of a row-major fp32 tile: `s` at (row 0, column 0) of the 16 x 8
// block, `ld` floats a row.
__device__ __forceinline__ Frag<4> load_a(const float* s, int ld, int g, int t) {
  Frag<4> f;
  split(s[g * ld + t], f.hi[0], f.lo[0]);
  split(s[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(s[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(s[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// A fragment from an m16n8 accumulator (P or dS) for the next product over
// the accumulator's 8 columns, in the permuted k order (column t <- 2t,
// column t + 4 <- 2t + 1).
__device__ __forceinline__ Frag<4> acc_to_a(const float (&c)[4]) {
  Frag<4> f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B fragment whose n index runs over the rows of a staged tile (K in Q K^T,
// Q in K Q^T): `s` at (row n0, column k0), k along the row.
__device__ __forceinline__ Frag<2> load_b_nrow(const float* s, int ld, int g, int t) {
  Frag<2> f;
  split(s[g * ld + t], f.hi[0], f.lo[0]);
  split(s[g * ld + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// B fragment whose k index runs over the rows of a staged tile (V in P V,
// dO in P^T dO), k permuted as acc_to_a: `s` at (row k0, column n0).
__device__ __forceinline__ Frag<2> load_b_krow(const float* s, int ld, int g, int t) {
  Frag<2> f;
  split(s[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(s[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// ------------------------------------------------------------ cp.async --
// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (no byte
// is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared (a row's statistic); zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, nrows) of a strided (S, D) fp32 slice into shared memory rows of
// LD floats by cp.async (16 bytes a copy); rows at or past `valid` are
// zero-filled. The caller commits and waits.
template <int D, int NT, int LD = D + 4>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long row_stride, int nrows,
                                           int valid) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < nrows * kPerRow; idx += NT) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r * row_stride + c : 0), ok);
  }
}

}  // namespace tf32
