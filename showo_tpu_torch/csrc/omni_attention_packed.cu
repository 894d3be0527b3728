// Omni-masked attention on the packed [B, S, H*D] projection layout, for
// Hopper (sm_90a), bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::omni_attention_packed (Pallas
// kernel _attn_kernel_packed).  The kernel, its mask predicate, what bounds
// it on an H100 and its design are in omni_attention.cuh, which the
// head-major entry (omni_attention.cu) shares: here the head stride is D
// and the row stride H*D.  GQA: kv head = h / (H / Hkv).  Head dim 64
// (Show-o v1, the Show-o2 DiT head: 32 q / 8 kv heads) or 128 (Qwen2.5:
// 12 q / 2 kv heads), one instantiation of the tile core each.

#include "omni_attention.cuh"

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements; the last dim of q/k/v/out is contiguous; the head
// dim is 64 or 128.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int omni_attention_packed_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q,
    int B, int Q, int S, int H, int Hkv, int head_dim,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    float sm_scale, void* stream) {
  const long long d = head_dim;
  const tile::Strides qs{q_sb, d, q_sr}, ks{k_sb, d, k_sr},
      vs{v_sb, d, v_sr}, os{o_sb, d, o_sr};
  if (head_dim == 64)
    return omni::launch<64>(q, k, v, out, seg, pad, last_pad, prefix, pos_q,
                            seg_q, B, Q, S, H, Hkv, qs, ks, vs, os, sm_scale,
                            stream);
  if (head_dim == 128)
    return omni::launch<128>(q, k, v, out, seg, pad, last_pad, prefix, pos_q,
                             seg_q, B, Q, S, H, Hkv, qs, ks, vs, os, sm_scale,
                             stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
