// Tile pieces shared by the attention kernels of showo_tpu_torch, for
// Hopper (sm_90a): bf16 operands, fp32 scores, softmax and accumulation.
// The wgmma cores (attention_fwd_sm90.cuh, attention_grad_sm90.cuh) use
// its strides, accumulator row map, online softmax and stores; no kernel
// lives here.
//
// A 64 x 64 score tile is held by one warpgroup as the accumulators of
// wgmma m64n64 (the layout of mma.sync m16n8 fragments, 8 of them across
// the 64 columns): thread t of the warpgroup holds rows (t / 32) * 16 +
// (t % 32) / 4 (index 0) and that + 8 (index 1), tile columns
// n*8 + (t % 4)*2 + e in s[n][e] (row 0) and s[n][2 + e] (row 1).  The
// head dim HD of an output accumulator o[HD / 8][4] is a template
// parameter: Show-o v1 (Phi-1.5) and the Show-o2 DiT head run 64,
// Qwen2.5 runs 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_K = 64;
constexpr int NK = BLOCK_K / 8;  // n-tiles of the score tile
constexpr float MASKED = -1e30f;  // a masked logit: finite, see the kernels
constexpr float LOG2E = 1.4426950408889634f;

// head dim 64: the trainable kernels' only one
constexpr int D = 64;

// Strides of a [B, heads, rows, D] view in elements (the last dim is
// contiguous): the packed [B, S, H*D] layout is head stride D and row
// stride H*D, the head-major one head stride S*D and row stride D.
struct Strides {
  long long b, h, r;
};

// The exponential of the online softmax: the bare ex2.approx.ftz, without
// exp2f's handling of subnormal results (a weight below 2^-126 becomes 0),
// which ran the wgmma forward core ~10% faster on an H100 than exp2f.
struct Exp2Ftz {
  __device__ __forceinline__ float operator()(float x) const {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
};

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The first row of thread ``t`` of a warpgroup in its 64-row tile (the
// second is + 8)
__device__ __forceinline__ int tile_row(int t) {
  return (t >> 5) * 16 + ((t & 31) >> 2);
}
__device__ __forceinline__ int tile_row() { return tile_row(threadIdx.x); }

// Online softmax over the log2-domain logits s of one tile: updates the
// running max m and sum l of both rows, rescales o, and leaves the
// unnormalised probabilities in s.  Masked logits may be -inf (the
// trainable forward): a row whose logits so far are all -inf keeps
// m = -inf and l = 0 and adds nothing to o.  The inference kernels mask
// with the finite MASKED, so their running max is finite from the first
// tile on and the guard never fires for them.  ``Ex``: the exponential.
// ROUND_P: each probability is rounded to bf16 before the row sum, so the
// sum is that of the weights P.V multiplies (the bf16-softmax variant).
template <int HD, typename Ex, bool ROUND_P = false>
__device__ __forceinline__ void softmax_update(float s[NK][4], float m[2],
                                               float l[2],
                                               float o[HD / 8][4]) {
  const Ex ex2{};
  float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    tmax0 = fmaxf(tmax0, fmaxf(s[n][0], s[n][1]));
    tmax1 = fmaxf(tmax1, fmaxf(s[n][2], s[n][3]));
  }
  // the 4 threads of a quad share rows
  tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 1));
  tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 2));
  tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 1));
  tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 2));
  const float mn0 = fmaxf(m[0], tmax0), mn1 = fmaxf(m[1], tmax1);
  // the max subtracted: 0 while a row has seen only -inf (exp2 gives 0)
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
  const float alpha0 = ex2(m[0] - ms0), alpha1 = ex2(m[1] - ms1);
  m[0] = mn0;
  m[1] = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    s[n][0] = ex2(s[n][0] - ms0);
    s[n][1] = ex2(s[n][1] - ms0);
    s[n][2] = ex2(s[n][2] - ms1);
    s[n][3] = ex2(s[n][3] - ms1);
    if constexpr (ROUND_P) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[n][c] = __bfloat162float(__float2bfloat16_rn(s[n][c]));
    }
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
  l[0] = l[0] * alpha0 + sum0;
  l[1] = l[1] * alpha1 + sum1;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[n][0] *= alpha0;
    o[n][1] *= alpha0;
    o[n][2] *= alpha1;
    o[n][3] *= alpha1;
  }
}

// Sum each row's l over the 4 threads of its quad.
__device__ __forceinline__ void quad_sum(float l[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// Write this thread's accumulator rows row0 and row0 + 8 (those < Q) of
// one head, row r times scale[r], as bf16 (oh: the head's base, row
// stride o_sr).
template <int HD>
__device__ __forceinline__ void store_rows(bf16* oh, long long o_sr,
                                           int row0, int Q,
                                           const float o[HD / 8][4],
                                           const float scale[2]) {
  const int c0 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row0 < Q)
      *reinterpret_cast<__nv_bfloat162*>(oh + (long long)row0 * o_sr + n * 8 +
                                         c0) =
          __floats2bfloat162_rn(o[n][0] * scale[0], o[n][1] * scale[0]);
    if (row0 + 8 < Q)
      *reinterpret_cast<__nv_bfloat162*>(oh + (long long)(row0 + 8) * o_sr +
                                         n * 8 + c0) =
          __floats2bfloat162_rn(o[n][2] * scale[1], o[n][3] * scale[1]);
  }
}

// Write this thread's accumulator rows q0 + tile_row() (+ 8) < Q of one
// head, row r times scale[r], as bf16 (store_rows).
template <int HD>
__device__ __forceinline__ void store_scaled(bf16* oh, long long o_sr, int q0,
                                             int Q, const float o[HD / 8][4],
                                             const float scale[2]) {
  store_rows<HD>(oh, o_sr, q0 + tile_row(), Q, o, scale);
}

// Normalise by the row sums and write the rows row0 and row0 + 8 (those
// < Q), as store_rows.
template <int HD>
__device__ __forceinline__ void store(bf16* oh, long long o_sr, int row0,
                                      int Q, const float o[HD / 8][4],
                                      float l[2]) {
  quad_sum(l);
  // l >= 1: the row's max contributes exp2(0)
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows<HD>(oh, o_sr, row0, Q, o, inv);
}

}  // namespace tile
