// Omni-masked attention on the head-major [B, H, S, D] layout, for Hopper
// (sm_90a), bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::omni_attention (Pallas kernel
// _attn_kernel).  The Pallas kernel transposes q/k/v to [D, S] only so that
// the TPU's lane axis is a multiple of 128; the function it computes is
// that of omni_attention_packed, so both entries launch the one kernel of
// omni_attention.cuh (mask predicate, bounds on an H100 and design are
// described there) with their own strides.  Any strided view whose last
// dim is contiguous is taken as it is, e.g. [B, Q, H, D].transpose(1, 2)
// from phi's projections, so the host copies nothing.  No GQA (the Pallas
// kernel has none): k and v have H heads.

#include "omni_attention.cuh"

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements (batch, head, row); the last dim of q/k/v/out is
// contiguous; the head dim is 64.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int omni_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q,
    int B, int H, int Q, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long o_sb, long long o_sh, long long o_sr,
    float sm_scale, void* stream) {
  if (head_dim != tile::D) return static_cast<int>(cudaErrorInvalidValue);
  return omni::launch<tile::D>(q, k, v, out, seg, pad, last_pad, prefix,
                               pos_q, seg_q, B, Q, S, H, H,
                               {q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
                               {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr},
                               sm_scale, stream);
}
