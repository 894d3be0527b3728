// Omni-masked attention on the head-major [B, H, S, D] layout (kernel 4),
// for Hopper (sm_90a), bf16 in and out, fp32 scores, softmax and
// accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::omni_attention (Pallas kernel
// _attn_kernel).  The Pallas kernel transposes q/k/v to [D, S] only so that
// the TPU's lane axis is a multiple of 128; the function it computes is
// kernel 1's (omni_attention_packed.cu): a masked score is -1e30, so a row
// with no visible key averages v over the S keys.  So this is kernel 5's
// launch with kernel 1's mask: the wgmma forward core of
// attention_fwd_sm90.cuh at <64 | 128, MASK_MEAN> (the head dim; the
// Pallas kernel takes any) on (batch, head, row) strides,
// q rows by (pos_q, seg_q), no lse, on kernel 1's kind of tile map (flag
// read: the blocks of q tiles that hold a row with no visible key visit
// every K tile), made once per forward (models/phi.py attn_step) under
// this source's own entry.  Kernel 4 and kernel 1 compute the same
// function through the same core: on the same memory ([B, S, H, D] is
// [B, S, H*D]) their outputs carry the same bits.
//
// What bounds it on an H100 at the v1 512^2 cached step (B=4, Q=1026,
// K=1155, H=32, D=64): 4.7e6 visible (row, key) pairs per head, 4*D FLOP
// each, 3.5e10 FLOP over 36 MB: operations bound (0.035 ms at the bf16
// peak).  Any strided view whose last dim is contiguous is taken as it
// is, e.g. [B, Q, H, D].transpose(1, 2) from phi's projections: a head
// row of that view lies at a 128-byte offset of its H*D*2-byte row, so
// the core's 16-byte cp.async and 128-byte swizzle stay aligned; the
// wrapper raises on a view that is not 16-byte aligned and copies
// nothing.  No GQA (the Pallas kernel has none): k and v have H heads.

#include "attention_fwd_sm90.cuh"

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// the metadata is int32: seg / pad [B, S], last_pad / prefix [B], pos_q /
// seg_q (the q rows' kv positions and segment ids) [B, Q].  Each returns
// the cudaError_t of its launch (0 = launched) on ``stream``.

// The tile map (agrad90::rows_tile_map_kernel): uint8
// [B, ceil(Q / 64), ceil(S / 64) + 1]; ``pos_k`` [S], the keys' positions,
// null here (key j at position j).
extern "C" int omni_attention_tiles(
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_k, const int* pos_q, const int* seg_q,
    unsigned char* tiles, int B, int Q, int S, void* stream) {
  if (B <= 0 || Q <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_rows_tile_map({seg, pad, last_pad, prefix, pos_k},
                                       {pos_q, seg_q}, B, Q, S, tiles,
                                       stream);
}

// Strides are in elements (batch, head, row); the last dim of q/k/v/out is
// contiguous; head dim 64 or 128; ``tiles``: the map above of the same
// metadata.
extern "C" int omni_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q, const unsigned char* tiles,
    int B, int H, int Q, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long o_sb, long long o_sh, long long o_sr,
    float sm_scale, void* stream) {
  if (tiles == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64)
    return agrad90::launch_fwd<64, agrad90::MASK_MEAN>(
        q, k, v, out, nullptr, {seg, pad, last_pad, prefix}, {pos_q, seg_q},
        {}, tiles, true, B, Q, S, H, H, {q_sb, q_sh, q_sr},
        {k_sb, k_sh, k_sr}, {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr},
        sm_scale, 0.f, stream);
  if (head_dim == 128)
    return agrad90::launch_fwd<128, agrad90::MASK_MEAN>(
        q, k, v, out, nullptr, {seg, pad, last_pad, prefix}, {pos_q, seg_q},
        {}, tiles, true, B, Q, S, H, H, {q_sb, q_sh, q_sr},
        {k_sb, k_sh, k_sr}, {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr},
        sm_scale, 0.f, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
