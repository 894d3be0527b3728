// Trainable omni-masked self-attention on head-major [B, H, S, D] views,
// for Hopper (sm_90a): a forward that also writes the per-(head, row)
// logsumexp, and the two backward kernels (dq; dk and dv).  bf16 operands,
// fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/streaming_attention_grad.py: the Pallas kernels
// _fwd_kernel (call in _fwd), _dq_kernel and _dkv_kernel (calls in _bwd),
// which the JAX dispatcher takes for every shape past the packed kernel's
// VMEM budget (the v1 512x512 training rows, S=1408).  On the TPU they
// differ from kernel 7 in their tiling: 256 x 512 blocks over a transposed
// [D, S] layout, K/V streamed per block instead of held whole in VMEM, GQA
// dk/dv summed outside the kernel.  On Hopper the function is kernel 7's,
// on wgmma: a tile map from the metadata (attention_grad_sm90.cuh), made
// once per forward and read by all three kernels; the forward on the
// forward core (attention_fwd_sm90.cuh); dq and dk/dv on the backward's
// (attention_grad_sm90.cuh); a cp.async ring and no transposed copies in
// each, all with the strides of the caller's head-major views (any
// [B, H, S, D] view whose last dim is contiguous, e.g. phi's
// [B, S, H, D].transpose(1, 2), without a copy), 64 x 64 tiles, and the
// GQA group summed in registers.  Kernel 7 runs the same cores on its
// packed layout (packed_attention_grad.cu).
//
// What bounds it on an H100 at the v1 512x512 step (B=12, S=1408, H=32,
// D=64, ~60% of the pairs visible): per layer the forward does ~1.5e11
// FLOP over 0.3 GB and the backward ~3.5e11 over 0.6 GB, ~500 FLOP per
// byte, so the tensor-core rate bounds it; the kernels skip the tiles the
// mask hides (from the O(S) metadata) and keep every score on chip.
//
// A row with no visible key gets out = 0, lse = 1e30 (the JAX kernel's
// -NEG_INF sentinel, NEG_INF = -1e30 in its streaming modules) and P = 0
// in the backward, as the JAX kernel's _finish intends.  (The Pallas
// forward adds exp(NEG_INF - NEG_INF) = 1 for such a row when it shares a
// tile with a row that sees a key, so there it averages v over that tile:
// a result of its 512-wide tiling that 64-wide tiles cannot reproduce.)

#include <type_traits>

#include "attention_fwd_sm90.cuh"

namespace {

constexpr float SENTINEL = 1e30f;  // lse of a row with no visible key

// f(integral_constant<int, 64 or 128>) by the head dim (bad_shape has
// refused any other)
template <typename F>
int by_head_dim(int head_dim, F f) {
  return head_dim == 64 ? f(std::integral_constant<int, 64>())
                        : f(std::integral_constant<int, 128>());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// each tensor comes with its (batch, head, row) strides in elements and a
// contiguous last dim of D (64 or 128): q, out, dout, dq [B, H, S, D], k,
// v, dk, dv [B, Hkv, S, D] (Hkv divides H); lse and delta contiguous fp32
// [B, H, S]; metadata int32 seg / pad [B, S], last_pad / prefix [B]; the
// tile map uint8 [B, nt, nt], nt = ceil(S / 64).  Each returns the
// cudaError_t of its launch (0 = launched) on ``stream``.

// The tile map of the three kernels (agrad90::tile_map_kernel).
extern "C" int streaming_attention_grad_tiles(
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    unsigned char* tiles, int B, int S, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_tile_map({seg, pad, last_pad, prefix}, B, S, tiles,
                                  stream);
}

extern "C" int streaming_attention_grad_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const unsigned char* tiles, int B, int H, int Hkv, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long o_sb, long long o_sh, long long o_sr,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return agrad90::launch_fwd<HD, agrad90::MASK_INF>(
        q, k, v, out, lse, {seg, pad, last_pad, prefix}, {nullptr, nullptr},
        {}, tiles, false, B, S, S, H, Hkv, {q_sb, q_sh, q_sr},
        {k_sb, k_sh, k_sr}, {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr}, sm_scale,
        SENTINEL, stream);
  });
}

extern "C" int streaming_attention_grad_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* seg,
    const int* pad, const int* last_pad, const int* prefix,
    const unsigned char* tiles, int B, int H, int Hkv, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long d_sb, long long d_sh, long long d_sr,
    long long dq_sb, long long dq_sh, long long dq_sr,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return agrad90::launch_dq<HD>(
        q, k, v, dout, lse, delta, dq, {seg, pad, last_pad, prefix}, tiles, B,
        S, H, Hkv, {q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
        {v_sb, v_sh, v_sr}, {d_sb, d_sh, d_sr}, {dq_sb, dq_sh, dq_sr},
        sm_scale, stream);
  });
}

extern "C" int streaming_attention_grad_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const unsigned char* tiles, int B, int H, int Hkv, int S, int head_dim,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr,
    long long v_sb, long long v_sh, long long v_sr,
    long long d_sb, long long d_sh, long long d_sr,
    long long dk_sb, long long dk_sh, long long dk_sr,
    long long dv_sb, long long dv_sh, long long dv_sr,
    float sm_scale, void* stream) {
  if (agrad::bad_shape(head_dim, H, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return agrad90::launch_dkv<HD>(
        q, k, v, dout, lse, delta, dk, dv, {seg, pad, last_pad, prefix},
        tiles, B, S, H, Hkv, {q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
        {v_sb, v_sh, v_sr}, {d_sb, d_sh, d_sr}, {dk_sb, dk_sh, dk_sr},
        {dv_sb, dv_sh, dv_sr}, sm_scale, stream);
  });
}
