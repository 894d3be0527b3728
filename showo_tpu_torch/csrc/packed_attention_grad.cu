// Trainable omni-masked self-attention on the packed [B, S, H*D] layout, for
// Hopper (sm_90a): a forward that also writes the per-(head, row)
// logsumexp, and the two backward kernels (dq; dk and dv).  bf16 operands,
// fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/packed_attention_grad.py: the Pallas kernels
// _fwd_kernel (call in _fwd), _dq_kernel and _dkv_kernel (calls in _bwd),
// which the JAX dispatcher takes within its VMEM budget (the v1 stage-1
// rows, S=387).  The function is kernel 8's (streaming_attention_grad.cu)
// and so are the cores, on wgmma: a tile map from the O(S) metadata
// (agrad90::tile_map_kernel, attention_grad_sm90.cuh), made once per
// forward and read by all three kernels; the forward on the forward core
// (attention_fwd_sm90.cuh); dq and dk/dv on the backward's
// (attention_grad_sm90.cuh); the GQA group summed in registers.  Here they
// read the packed layout's strides: head stride D, row stride H*D (Hkv*D
// for k, v, dk and dv).  A head row is then a 128-byte panel at a 128-byte
// offset of a 4096-byte row (H = 32), so the tile loader's 16-byte cp.async
// and the 128-byte swizzle stay aligned, as on head-major views.  What
// bounds the kernels on an H100 at the stage-1 step (B=29, S=387, H=32,
// D=64, 0.58 of the pairs visible): the forward moves 185 MB for 2.1e10
// FLOP, dq 233 MB for 3.1e10 and dk/dv 279 MB for 4.1e10, so the memory
// rate (0.055 / 0.070 / 0.083 ms); the ragged S (6 x 64 + 3) leaves a last
// tile of 3 rows, zero-filled by the copies and masked by the map.
//
// A row with no visible key gets out = 0 and lse = 1e9 (the JAX kernel's
// -NEG_INF sentinel, NEG_INF = -1e9 in its packed module), and P = 0 in
// the backward: the per-element map masks every entry of its row.

#include "attention_fwd_sm90.cuh"

namespace {

constexpr float SENTINEL = 1e9f;  // lse of a row with no visible key

tile::Strides packed(int S, int heads) {
  return {(long long)S * heads * tile::D, tile::D, (long long)heads * tile::D};
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// q, out, dout, dq are contiguous [B, S, H*64], k, v, dk, dv contiguous
// [B, S, Hkv*64], lse and delta contiguous fp32 [B, H, S]; metadata int32
// seg / pad [B, S], last_pad / prefix [B]; the tile map uint8 [B, nt, nt],
// nt = ceil(S / 64).  Each returns the cudaError_t of its launch (0 =
// launched) on ``stream``.

// The tile map of the three kernels (agrad90::tile_map_kernel).
extern "C" int packed_attention_grad_tiles(
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    unsigned char* tiles, int B, int S, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_tile_map({seg, pad, last_pad, prefix}, B, S, tiles,
                                  stream);
}

extern "C" int packed_attention_grad_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const unsigned char* tiles, int B, int S, int H, int Hkv, int head_dim,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Strides qs = packed(S, H), ks = packed(S, Hkv);
  return agrad90::launch_fwd<64, agrad90::MASK_INF>(
      q, k, v, out, lse, {seg, pad, last_pad, prefix}, {nullptr, nullptr}, {},
      tiles, false, B, S, S, H, Hkv, qs, ks, ks, qs, sm_scale, SENTINEL,
      stream);
}

extern "C" int packed_attention_grad_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* seg,
    const int* pad, const int* last_pad, const int* prefix,
    const unsigned char* tiles, int B, int S, int H, int Hkv, int head_dim,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Strides qs = packed(S, H), ks = packed(S, Hkv);
  return agrad90::launch_dq<64>(q, k, v, dout, lse, delta, dq,
                                {seg, pad, last_pad, prefix}, tiles, B, S, H,
                                Hkv, qs, ks, ks, qs, qs, sm_scale, stream);
}

extern "C" int packed_attention_grad_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const unsigned char* tiles, int B, int S, int H, int Hkv, int head_dim,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Strides qs = packed(S, H), ks = packed(S, Hkv);
  return agrad90::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv,
                                 {seg, pad, last_pad, prefix}, tiles, B, S, H,
                                 Hkv, qs, ks, ks, qs, ks, ks, sm_scale,
                                 stream);
}

