// Trainable omni-masked self-attention on the packed [B, S, H*D] layout, for
// Hopper (sm_90a): a forward that also writes the per-(head, row)
// logsumexp, and the two backward kernels (dq; dk and dv).  bf16 operands,
// fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/packed_attention_grad.py: the Pallas kernels
// _fwd_kernel (call in _fwd), _dq_kernel and _dkv_kernel (calls in _bwd).
// The function, what bounds it on an H100 and the design are those of
// attention_grad.cuh, whose three kernels run here with the packed
// layout's strides (head stride D, row stride H*D).  At the v1 stage-1
// step (B=29, S=387, H=32, D=64) the forward moves 184 MB for at most
// 3.6e10 FLOP, dq 230 MB for 5.3e10 and dk/dv 276 MB for 7.1e10: all
// three near the 295 FLOP/byte ridge.
//
// A row with no visible key gets out = 0 and lse = 1e9 (the JAX kernel's
// -NEG_INF sentinel, NEG_INF = -1e9 in its packed module), and P = 0 in
// the backward.

#include "attention_grad.cuh"

namespace {

constexpr float SENTINEL = 1e9f;  // lse of a row with no visible key

tile::Strides packed(int S, int heads) {
  return {(long long)S * heads * tile::D, tile::D, (long long)heads * tile::D};
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// q, out, dout, dq are contiguous [B, S, H*64], k, v, dk, dv contiguous
// [B, S, Hkv*64], lse and delta contiguous fp32 [B, H, S]; metadata int32
// seg / pad [B, S], last_pad / prefix [B].  Each returns the cudaError_t of
// its launch (0 = launched) on ``stream``.

extern "C" int packed_attention_grad_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    int B, int S, int H, int Hkv, int head_dim, float sm_scale,
    void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Strides qs = packed(S, H), ks = packed(S, Hkv);
  return agrad::launch_fwd<true>(q, k, v, out, lse,
                                 {seg, pad, last_pad, prefix}, {nullptr,
                                                                nullptr},
                                 B, S, S, H, Hkv, qs, ks, ks, qs, sm_scale,
                                 SENTINEL, stream);
}

extern "C" int packed_attention_grad_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* seg,
    const int* pad, const int* last_pad, const int* prefix, int B, int S,
    int H, int Hkv, int head_dim, float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Strides qs = packed(S, H), ks = packed(S, Hkv);
  return agrad::launch_dq(q, k, v, dout, lse, delta, dq,
                          {seg, pad, last_pad, prefix}, B, S, H, Hkv, qs, ks,
                          ks, qs, qs, sm_scale, stream);
}

extern "C" int packed_attention_grad_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    int B, int S, int H, int Hkv, int head_dim, float sm_scale,
    void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Strides qs = packed(S, H), ks = packed(S, Hkv);
  return agrad::launch_dkv(q, k, v, dout, lse, delta, dk, dv,
                           {seg, pad, last_pad, prefix}, B, S, H, Hkv, qs, ks,
                           ks, qs, ks, ks, sm_scale, stream);
}
