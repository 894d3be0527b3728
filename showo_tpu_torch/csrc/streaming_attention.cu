// K-blocked omni-masked attention with an online softmax on head-major
// [B, H, Q, D] / [B, Hkv, S, D] views, for Hopper (sm_90a): bf16 in and
// out, fp32 scores, softmax and accumulation, GQA (kv head = h / group),
// q rows at any kv positions (the prefix-cached Q != K step).
//
// Replaces showo_tpu/ops/streaming_attention.py::omni_attention_streaming
// (Pallas kernel _stream_kernel).  On the TPU it differs from the fused
// omni kernel by streaming K/V in 512-row blocks instead of holding a
// head's whole K/V in VMEM, and by emitting 0 for a row that sees no key.
// On Hopper every attention kernel of the port already streams K/V in
// 64-row tiles, so this is the forward of attention_grad.cuh without the
// logsumexp: the same masked -inf logits and online softmax (the tile
// core's softmax_update, whose -inf guard keeps a row that sees no key at
// l = 0, so it emits 0), and tiles no row of the block sees are skipped
// before they are loaded, decided from the O(S) metadata.  The inference
// kernels of omni_attention.cuh differ in that one point: they average v
// over such a row.
//
// What bounds it on an H100 at the v1 512^2 cached step (B=4, Q=1026,
// K=1155, H=32, D=64): 4.7e6 visible (row, key) pairs per head, 4*D FLOP
// each, 3.5e10 FLOP over 36 MB: operations bound (0.035 ms at the bf16
// peak); the mma.sync tile loop and the launch shape (2176 blocks of one
// (b, h, 64-row q tile)) decide.

#include "attention_grad.cuh"

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements (batch, head, row); the last dim of q/k/v/out is
// contiguous; the head dim is 64.  pos_q / seg_q: the q rows' kv positions
// and segment ids, int32 [B, Q].  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int streaming_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q,
    int B, int H, int Hkv, int Q, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long o_sb, long long o_sh, long long o_sr,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad::launch_fwd<false>(
      q, k, v, out, nullptr, {seg, pad, last_pad, prefix}, {pos_q, seg_q}, B,
      Q, S, H, Hkv, {q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
      {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr}, sm_scale, 0.f, stream);
}
