// Attention under an explicit additive bias (kernel 3), for Hopper
// (sm_90a): bf16 q/k/v and output, fp32 bias, fp32 scores, softmax and
// accumulation.
//
// Replaces showo_tpu/ops/decode_attention.py::decode_attention (Pallas
// kernels _kernel, grid (B, H), and _kernel_headloop, grid (B,) with a head
// loop; they compute the same function and both map to this one kernel):
//
//   out[b,i,h] = softmax_fp32(q[b,i,h].k[b,:,h]^T * sm_scale + bias[b,0,i,:])
//                . v[b,:,h]
//
// Every v1 mask quirk comes in through the bias (0 or -1e9), so the score
// is formed exactly as the dense path forms it: the fp32 product, scaled,
// plus the bias, in that order; a row whose every key is masked then
// averages v, as in the dense path.  The ragged K edge takes no weight
// (-inf): unlike the Pallas wrapper the host pads nothing.
//
// What bounds it on an H100: at the v1 512^2 cached step (B=4, Q=1026,
// K=1155, H=32, D=64) the work of omni attention (3.5e10 FLOP over the
// visible pairs, 0.035 ms at the bf16 peak) plus the 19 MB of the bias,
// which the first kernel read entry by entry once per head (~607 MB a
// launch).  The design: the wgmma forward core of attention_fwd_sm90.cuh
// with the bias as its third mask (MASK_BIAS), on a tile map of the bias
// made once per forward and read by every layer (models/phi.py):
// a (q tile, K tile) pair whose bias is all 0 loads no bias, one whose
// bias is all <= -1e9 is skipped, and only the rest copy their 16 KB of
// bias into the ring beside K and V (on the cached t2i step ~15% of the
// pairs).  The caller passes the view attention_bias[:, :, P:, :P+S],
// whose row stride is the full sequence length, so no contiguous copy of
// the bias is ever made; its rows start at any 4-byte boundary, so the
// bias is copied 4 bytes a thread.

#include "attention_fwd_sm90.cuh"

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// the bias is fp32 [B, 1, Q, K] with batch and row strides in elements and
// a contiguous last dim.  Each returns the cudaError_t of its launch (0 =
// launched) on ``stream``.

// The tile map (agrad90::bias_tile_map_kernel): uint8
// [B, ceil(Q / 64), ceil(K / 64) + 1].
extern "C" int decode_attention_tiles(const float* bias, long long bias_sb,
                                      long long bias_sr, unsigned char* tiles,
                                      int B, int Q, int K, void* stream) {
  if (B <= 0 || Q <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_bias_tile_map(bias, bias_sb, bias_sr, B, Q, K, tiles,
                                       stream);
}

// Strides are in elements (batch, row, head for q/k/v/out); the last dim
// of every operand is contiguous; head dim 64; ``tiles``: the map above of
// the same bias.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, void* out, const float* bias,
    const unsigned char* tiles, int B, int Q, int K, int H, int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    long long bias_sb, long long bias_sr, float sm_scale, void* stream) {
  if (head_dim != 64 || tiles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_fwd<64, agrad90::MASK_BIAS>(
      q, k, v, out, nullptr, {}, {}, {bias, bias_sb, bias_sr, sm_scale}, tiles,
      true, B, Q, K, H, H, {q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
      {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr}, sm_scale, 0.f, stream);
}
