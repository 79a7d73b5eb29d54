// Arguments and tile constants shared by the attention forward kernels
// (flash_attention_fwd.cu) and the attention over the int8 KV cache
// (attention_kv8.cu).
#pragma once

#include <cstddef>

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

// The tiled CUDA-core KV8 kernel (attention_kv8.cu): one block per (query
// tile of kBQ rows, head, batch), key tiles of kBK staged in shared memory as
// fp32.
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

// Keys per chunk of the kernels that split a row's keys across blocks (the
// wrapper's DECODE_CHUNK): chunks are anchored at key 0.
constexpr int kDecChunk = 128;

}  // namespace attn
