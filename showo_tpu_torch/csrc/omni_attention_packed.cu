// Omni-masked attention on the packed [B, S, H*D] projection layout, for
// Hopper (sm_90a), bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::omni_attention_packed (Pallas
// kernel _attn_kernel_packed).  Here the head stride is D and the row
// stride H*D; GQA: kv head = h / (H / Hkv).  Both head dims run the wgmma
// forward core (attention_fwd_sm90.cuh, MASK_MEAN: q rows by position,
// masked scores -1e30), after a tile map of the q rows' metadata
// (omni_attention_packed_tiles) that says which K tiles each block visits
// and masks:
//   64 (Show-o v1, the Show-o2 DiT head: 32 q / 8 kv heads): one 128-byte
//      panel a head row; a head row of the packed layout lies at a 128-byte
//      offset of its H*D*2-byte row, so the 16-byte cp.async and the
//      128-byte swizzle stay aligned;
//   128 (Qwen2.5: 12 q / 2 kv heads): two panels a head row.
// Kernel 4 (omni_attention.cu) runs the same core on head-major views.

#include "attention_fwd_sm90.cuh"

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// strides are in elements; the last dim of q/k/v/out is contiguous; the
// metadata is int32: seg / pad [B, S], last_pad / prefix [B], pos_q /
// seg_q [B, Q].  Each returns the cudaError_t of its launch (0 =
// launched) on ``stream``.

// The tile map (agrad90::rows_tile_map_kernel): uint8
// [B, ceil(Q / 64), ceil(S / 64) + 1]; ``pos_k`` [S], the keys' positions,
// null here (key j at position j).
extern "C" int omni_attention_packed_tiles(
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_k, const int* pos_q, const int* seg_q,
    unsigned char* tiles, int B, int Q, int S, void* stream) {
  if (B <= 0 || Q <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_rows_tile_map({seg, pad, last_pad, prefix, pos_k},
                                       {pos_q, seg_q}, B, Q, S, tiles,
                                       stream);
}

// Head dim 64 or 128; ``tiles``: the map above of the same metadata.
extern "C" int omni_attention_packed_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q, const unsigned char* tiles,
    int B, int Q, int S, int H, int Hkv, int head_dim,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    float sm_scale, void* stream) {
  const long long d = head_dim;
  const tile::Strides qs{q_sb, d, q_sr}, ks{k_sb, d, k_sr},
      vs{v_sb, d, v_sr}, os{o_sb, d, o_sr};
  if (Hkv <= 0 || H % Hkv != 0 || tiles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const agrad::Meta mt{seg, pad, last_pad, prefix};
  if (head_dim == 64)
    return agrad90::launch_fwd<64, agrad90::MASK_MEAN>(
        q, k, v, out, nullptr, mt, {pos_q, seg_q}, {}, tiles, true, B, Q, S,
        H, Hkv, qs, ks, vs, os, sm_scale, 0.f, stream);
  if (head_dim == 128)
    return agrad90::launch_fwd<128, agrad90::MASK_MEAN>(
        q, k, v, out, nullptr, mt, {pos_q, seg_q}, {}, tiles, true, B, Q, S,
        H, Hkv, qs, ks, vs, os, sm_scale, 0.f, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
