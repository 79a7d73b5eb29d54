// Arguments and tile constants shared by the attention forward kernels
// (flash_attention_fwd.cu) and the attention over the int8 KV cache
// (attention_kv8.cu, attention_kv8_tf32.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos0;  // (B,) int32, device; null: every offset is 0
  float* lse;         // (B, H, Sq) fp32, or null: not written
  int B, Sq, Skv, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale2;  // sm_scale * log2(e)
};

// The KV8 scales: one fp32 per (key, head) of K and of V, with element
// strides for the batch, key and head dimensions.
struct KvScales {
  const float* ks;
  const float* vs;
  long long ks_sb, ks_ss, ks_sh;
  long long vs_sb, vs_ss, vs_sh;
};

// Keys per shared-memory tile of the bf16 tensor-core forward and of the
// bf16 KV8 kernel of many rows: tiles are anchored at key 0.
constexpr int kBK = 64;

// Keys per chunk of the kernels that split a row's keys across blocks (the
// wrapper's DECODE_CHUNK): chunks are anchored at key 0.
constexpr int kDecChunk = 128;

// int8 to fp32 without the quarter-rate integer conversion: a byte biased
// to x + 128 becomes the low mantissa bits of 2^23 + x + 128, and the bias
// is subtracted in fp32 (exact for every int8).
constexpr float kInt8Bias = 8388736.f;  // 2^23 + 128

// The four int8 of a 32-bit word, lowest byte first, as fp32.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - kInt8Bias;
}

// The fp32 KV8 kernel of many query rows (attention_kv8_tf32.cu), launched
// by attention_kv8.cu's C entry: D in {32, 64, 128, 256}, 16 query rows a
// block.
cudaError_t launch_kv8_tf32(const AttnArgs& a, const KvScales& sc, int d, cudaStream_t stream);

}  // namespace attn
