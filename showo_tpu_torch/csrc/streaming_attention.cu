// K-blocked omni-masked attention (kernel 5) on head-major [B, H, Q, D] /
// [B, Hkv, S, D] views, for Hopper (sm_90a): bf16 in and out, fp32
// scores, softmax and accumulation, GQA (kv head = h / group), q rows at
// any kv positions (the prefix-cached Q != K step), head dim 64 or 128.
//
// Replaces showo_tpu/ops/streaming_attention.py::omni_attention_streaming
// (Pallas kernel _stream_kernel).  On the TPU it differs from the fused
// omni kernel by streaming K/V in 512-row blocks instead of holding a
// head's whole K/V in VMEM, and by emitting 0 for a row that sees no key.
// On Hopper every attention kernel of the port streams K/V in 64-row
// tiles, so this is the wgmma forward core of attention_fwd_sm90.cuh
// with the -inf mask (MASK_INF, no logsumexp): a row that sees no key
// keeps l = 0 and emits 0, and a tile the map marks empty is skipped
// exactly, so the map's flag of such rows is not read.  The map is
// rows_tile_map_kernel's (kernel 1's) of the same metadata, made once per
// forward (models/phi.py attn_step) under this source's own entry.  Where
// every row sees a key, kernel 5 and kernel 1 compute the same function
// on the same memory: [B, S, H, D] is [B, S, H*D].
//
// What bounds it on an H100 at the v1 512^2 cached step (B=4, Q=1026,
// K=1155, H=32, D=64): 4.7e6 visible (row, key) pairs per head, 4*D FLOP
// each, 3.5e10 FLOP over 36 MB: operations bound (0.035 ms at the bf16
// peak).  A head row of phi's transposed [B, S, H, D] views lies at a
// 128-byte offset of its H*D*2-byte row, so the core's 16-byte cp.async
// and 128-byte swizzle stay aligned; the wrapper raises on a view that is
// not 16-byte aligned.

#include "attention_fwd_sm90.cuh"

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// the metadata is int32: seg / pad [B, S], last_pad / prefix [B], pos_q /
// seg_q (the q rows' kv positions and segment ids) [B, Q].  Each returns
// the cudaError_t of its launch (0 = launched) on ``stream``.

// The tile map (agrad90::rows_tile_map_kernel): uint8
// [B, ceil(Q / 64), ceil(S / 64) + 1]; ``pos_k`` [S], the keys' positions,
// null here (key j at position j).
extern "C" int streaming_attention_tiles(
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
extern "C" int streaming_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q, const unsigned char* tiles,
    int B, int H, int Hkv, int Q, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long o_sb, long long o_sh, long long o_sr,
    float sm_scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || tiles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const agrad::Meta mt{seg, pad, last_pad, prefix};
  const tile::Strides qs{q_sb, q_sh, q_sr}, ks{k_sb, k_sh, k_sr},
      vs{v_sb, v_sh, v_sr}, os{o_sb, o_sh, o_sr};
  if (head_dim == 64)
    return agrad90::launch_fwd<64, agrad90::MASK_INF>(
        q, k, v, out, nullptr, mt, {pos_q, seg_q}, {}, tiles, true, B, Q, S,
        H, Hkv, qs, ks, vs, os, sm_scale, 0.f, stream);
  if (head_dim == 128)
    return agrad90::launch_fwd<128, agrad90::MASK_INF>(
        q, k, v, out, nullptr, mt, {pos_q, seg_q}, {}, tiles, true, B, Q, S,
        H, Hkv, qs, ks, vs, os, sm_scale, 0.f, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
