// GQA-stacked omni-masked attention on the packed [B, S, H*D] layout
// (kernel 6), for Hopper (sm_90a), bf16 in and out, fp32 scores, softmax
// and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::_omni_attention_gqa_stacked
// (its pallas_call at :399).  It computes the function of kernel 1
// (omni_attention_packed.cu):
//
//   visible(b,i,j) = [ j <= pos_q[b,i]
//                    | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
//                    | j < prefix[b] ]
//                  & ( pad[b,j] == 0 | pos_q[b,i] <= last_pad[b] )
//   out = softmax_fp32(q.k^T * sm_scale, masked) . v
//
// A masked score is -1e30 (not -inf), so a row with no visible column
// averages v over all S columns, as the plain version does; columns past S
// are -inf and take no weight.  What the TPU version buys is one K/V load
// shared by the G q heads of a kv head: it stacks those heads' rows (row
// g*Qp + pos) into one tall q block, through HBM transposes into a
// [B, Hkv, D, G*Qp] layout (:362-366, :410-412) that only Mosaic's lane
// tiling needed.  Here the heads share the K/V tiles in shared memory
// instead, and every tensor is read through the packed layout's strides.
//
// What bounds it on an H100: 4*D FLOP per visible (row, key) pair and head
// (0.028 ms at Show-o2's B=8, S=768 for Qwen's 12 q / 2 kv heads of 128,
// 0.037 ms for the DiT's 32 / 8 of 64, at the bf16 peak), with the K/V
// tile traffic from L2 into shared memory cut by the heads a block holds:
// kernel 1's G blocks of one kv head each load every K/V tile.
//
// Design: the wgmma forward core of attention_fwd_sm90.cuh at <HD,
// MASK_MEAN, false, W>: one block per (64-row q tile, kv head, slice of
// W of the group's q heads, batch), W warpgroups, one q head each, all
// reading one cp.async ring of (K, V) tiles over kernel 1's tile map (the
// mask does not depend on the head), each doing what kernel 1's
// warpgroup does for its head, so the outputs carry kernel 1's bits.  W
// = 2 (the wrapper's stack_width; 1 for a group of one): the register
// file holds 2 warpgroups an SM at head dim 128 (167 registers a thread)
// and 4 at 64, where 2 blocks of 2 ran as fast as kernel 1's 4 blocks of
// one on an H100 and one block of 4 (the most the register file allows)
// ~15% slower; the last slice of an odd group has an idle warpgroup.
// Any group is taken.

#include "attention_fwd_sm90.cuh"

namespace {

template <int HD, int W>
int launch(const void* q, const void* k, const void* v, void* out,
           agrad::Meta mt, agrad::Rows rows, const unsigned char* tiles,
           int B, int Q, int S, int H, int Hkv, tile::Strides qs,
           tile::Strides ks, tile::Strides vs, tile::Strides os,
           float sm_scale, void* stream) {
  return agrad90::launch_fwd<HD, agrad90::MASK_MEAN, false, W>(
      q, k, v, out, nullptr, mt, rows, {}, tiles, true, B, Q, S, H, Hkv, qs,
      ks, vs, os, sm_scale, 0.f, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// strides are in elements; the last dim of q/k/v/out is contiguous; the
// metadata is int32: seg / pad [B, S], last_pad / prefix [B], pos_q /
// seg_q [B, Q].  Each returns the cudaError_t of its launch (0 =
// launched) on ``stream``.

// The tile map of kernel 1 (agrad90::rows_tile_map_kernel): uint8
// [B, ceil(Q / 64), ceil(S / 64) + 1]; ``pos_k`` null (key j at j).
extern "C" int omni_attention_gqa_stacked_tiles(
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_k, const int* pos_q, const int* seg_q,
    unsigned char* tiles, int B, int Q, int S, void* stream) {
  if (B <= 0 || Q <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_rows_tile_map({seg, pad, last_pad, prefix, pos_k},
                                       {pos_q, seg_q}, B, Q, S, tiles,
                                       stream);
}

// Head dim 64 or 128, ``width`` 1 or 2 q heads a block; ``tiles``: the
// map above (or kernel 1's) of the same metadata.
extern "C" int omni_attention_gqa_stacked_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q, const unsigned char* tiles,
    int B, int Q, int S, int H, int Hkv, int head_dim, int width,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    float sm_scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || tiles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long d = head_dim;
  const tile::Strides qs{q_sb, d, q_sr}, ks{k_sb, d, k_sr},
      vs{v_sb, d, v_sr}, os{o_sb, d, o_sr};
  const agrad::Meta mt{seg, pad, last_pad, prefix};
  const agrad::Rows rows{pos_q, seg_q};
#define GQA_LAUNCH(HD_, W_)                                                 \
  if (head_dim == HD_ && width == W_)                                       \
    return launch<HD_, W_>(q, k, v, out, mt, rows, tiles, B, Q, S, H, Hkv,  \
                           qs, ks, vs, os, sm_scale, stream);
  GQA_LAUNCH(64, 1)
  GQA_LAUNCH(64, 2)
  GQA_LAUNCH(128, 1)
  GQA_LAUNCH(128, 2)
#undef GQA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
