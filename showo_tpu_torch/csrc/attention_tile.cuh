// Tile machinery shared by the attention kernels of showo_tpu_torch, for
// Hopper (sm_90a): bf16 operands, fp32 scores, softmax and accumulation.
//
// One block owns 64 query rows of one (batch, head) and walks the keys in
// 64-row K/V tiles with an online softmax, so no score row and no [Q, K]
// matrix ever reaches device memory.  4 warps x 16 query rows; both
// products are mma.sync m16n8k16 (bf16 in, fp32 accumulate); Q fragments
// stay in registers for the whole K loop; V is stored transposed in shared
// memory so that each B fragment of P.V is one 32-bit load.
//
// Per K tile a kernel calls scores() for the raw products q.k, turns them
// into log2-domain logits with its own mask or bias (written inline: a
// generic callback here cost ~20 registers and spills, measured on an
// H100), then softmax_update() and pv().  Thread layout of the mma
// accumulators: this thread holds rows warp*16 + lane/4 (index 0) and
// that + 8 (index 1), tile columns n*8 + (lane%4)*2 + e in s[n][e] (row 0)
// and s[n][2 + e] (row 1).
//
// The head dim is a template parameter (Geom<HD>) of every function that
// depends on it, 64 by default: Show-o v1 (Phi-1.5) and the Show-o2 DiT
// head run 64, Qwen2.5 runs 128 (the packed omni kernel only).  At 64 the
// kernels ask for 4 resident blocks of 128 threads per SM
// (__launch_bounds__(128, 4), so at most 128 registers): on an H100 the
// omni kernel ran faster so, with a few bytes of spills, than at the 130
// registers and 3 blocks it takes unbounded.  At 128 the accumulator
// (o[16][4]) and the Q fragments (qf[8][4]) alone take 96 registers, so
// those kernels ask for 2 blocks (up to 255 registers) and their 53 KB of
// tiles go above the 48 KB default of dynamic shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KP = BLOCK_K + 8;  // padded smem row of V^T (bf16)
constexpr int NK = BLOCK_K / 8;  // n-tiles of the score tile
constexpr float MASKED = -1e30f;  // a masked logit: finite, see the kernels
constexpr float LOG2E = 1.4426950408889634f;

// The shapes that follow from head dim HD.  Q tile [BLOCK_Q][DP], K tile
// [BLOCK_K][DP], V^T tile [HD][KP], in that order from the start of
// dynamic smem (offsets in bf16): 27648 bytes at HD = 64, 53248 at 128; a
// kernel appends its own arrays
template <int HD>
struct Geom {
  static_assert(HD % 16 == 0, "head dim: a multiple of 16");
  static constexpr int D = HD;
  static constexpr int DP = HD + 8;   // padded smem row of Q / K (bf16)
  static constexpr int CH = HD / 8;   // 16-byte chunks in one head row
  static constexpr int KD = HD / 16;  // k-steps of Q.K^T
  static constexpr int ND = HD / 8;   // n-tiles of the output
  static constexpr int K_OFF = BLOCK_Q * DP;
  static constexpr int V_OFF = K_OFF + BLOCK_K * DP;
  static constexpr int TILE_SMEM = (V_OFF + HD * KP) * 2;
};

// head dim 64: the default of every function below and the shapes the
// kernels other than the packed omni kernel are written against
constexpr int D = 64;
constexpr int DP = Geom<D>::DP;
constexpr int CH = Geom<D>::CH;
constexpr int KD = Geom<D>::KD;
constexpr int ND = Geom<D>::ND;
constexpr int K_OFF = Geom<D>::K_OFF;
constexpr int V_OFF = Geom<D>::V_OFF;
constexpr int TILE_SMEM = Geom<D>::TILE_SMEM;

// Strides of a [B, heads, rows, D] view in elements (the last dim is
// contiguous): the packed [B, S, H*D] layout is head stride D and row
// stride H*D, the head-major one head stride S*D and row stride D.
struct Strides {
  long long b, h, r;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// one 16-byte chunk (8 dims from cc on) of K row r and V row r of the tile
template <int HD = D>
__device__ __forceinline__ void put_kv(bf16* Ks, bf16* Vt, int r, int cc,
                                       uint4 kv, uint4 vv) {
  *reinterpret_cast<uint4*>(Ks + r * Geom<HD>::DP + cc) = kv;
  const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
  for (int e = 0; e < 8; ++e) Vt[(cc + e) * KP + r] = ve[e];
}

// Q rows [q0, q0 + BLOCK_Q) of one head (row stride q_sr) -> Qs, zeros
// past Q
template <int HD = D>
__device__ __forceinline__ void load_q(bf16* Qs, const bf16* qh,
                                       long long q_sr, int q0, int Q) {
  constexpr int CHD = Geom<HD>::CH;
  for (int c = threadIdx.x; c < BLOCK_Q * CHD; c += THREADS) {
    const int r = c / CHD, cc = (c % CHD) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Q) val = ld16(qh + (long long)(q0 + r) * q_sr + cc);
    *reinterpret_cast<uint4*>(Qs + r * Geom<HD>::DP + cc) = val;
  }
}

// K/V rows [k0, k0 + BLOCK_K) of one head -> Ks, Vt, zeros past S; the
// block's ``nthreads`` threads share the copy
template <int HD = D>
__device__ __forceinline__ void load_kv(bf16* Ks, bf16* Vt, const bf16* kh,
                                        long long k_sr, const bf16* vh,
                                        long long v_sr, int k0, int S,
                                        int nthreads = THREADS) {
  constexpr int CHD = Geom<HD>::CH;
  for (int c = threadIdx.x; c < BLOCK_K * CHD; c += nthreads) {
    const int r = c / CHD, cc = (c % CHD) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < S) {
      kv = ld16(kh + (long long)(k0 + r) * k_sr + cc);
      vv = ld16(vh + (long long)(k0 + r) * v_sr + cc);
    }
    put_kv<HD>(Ks, Vt, r, cc, kv, vv);
  }
}

// This thread's first row in the block's Q tile (the second is + 8)
__device__ __forceinline__ int tile_row() {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}

// A fragments of the warp's 16 Q rows (after load_q and a __syncthreads)
template <int HD = D>
__device__ __forceinline__ void q_fragments(const bf16* Qs,
                                            uint32_t qf[Geom<HD>::KD][4]) {
  constexpr int DPD = Geom<HD>::DP;
  const int rl = tile_row(), c0 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < Geom<HD>::KD; ++kk) {
    const int c = kk * 16 + c0;
    qf[kk][0] = lds32(Qs + rl * DPD + c);
    qf[kk][1] = lds32(Qs + (rl + 8) * DPD + c);
    qf[kk][2] = lds32(Qs + rl * DPD + c + 8);
    qf[kk][3] = lds32(Qs + (rl + 8) * DPD + c + 8);
  }
}

// s = Q.K^T: the warp's 16 rows x the tile's 64 keys
template <int HD = D>
__device__ __forceinline__ void scores(const uint32_t qf[Geom<HD>::KD][4],
                                       const bf16* Ks, float s[NK][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const bf16* krow = Ks + (n * 8 + (lane >> 2)) * Geom<HD>::DP +
                       (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < Geom<HD>::KD; ++kk)
      mma_16816(s[n], qf[kk], lds32(krow + kk * 16),
                lds32(krow + kk * 16 + 8));
  }
}

// Online softmax over the log2-domain logits s of one tile: updates the
// running max m and sum l of both rows, rescales o, and leaves the
// unnormalised probabilities in s.  Masked logits may be -inf (the
// trainable forward): a row whose logits so far are all -inf keeps
// m = -inf and l = 0 and adds nothing to o.  The inference kernels mask
// with the finite MASKED, so their running max is finite from the first
// tile on and the guard never fires for them.
template <int HD = D>
__device__ __forceinline__ void softmax_update(float s[NK][4], float m[2],
                                               float l[2],
                                               float o[Geom<HD>::ND][4]) {
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
  const float alpha0 = exp2f(m[0] - ms0), alpha1 = exp2f(m[1] - ms1);
  m[0] = mn0;
  m[1] = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    s[n][0] = exp2f(s[n][0] - ms0);
    s[n][1] = exp2f(s[n][1] - ms0);
    s[n][2] = exp2f(s[n][2] - ms1);
    s[n][3] = exp2f(s[n][3] - ms1);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
  l[0] = l[0] * alpha0 + sum0;
  l[1] = l[1] * alpha1 + sum1;
#pragma unroll
  for (int n = 0; n < Geom<HD>::ND; ++n) {
    o[n][0] *= alpha0;
    o[n][1] *= alpha0;
    o[n][2] *= alpha1;
    o[n][3] *= alpha1;
  }
}

// o += P . V   (P from the score registers, V^T from smem)
template <int HD = D>
__device__ __forceinline__ void pv(const float s[NK][4], const bf16* Vt,
                                   float o[Geom<HD>::ND][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < Geom<HD>::ND; ++n) {
      const bf16* vrow = Vt + (n * 8 + (lane >> 2)) * KP + kk * 16 +
                         (lane & 3) * 2;
      mma_16816(o[n], a, lds32(vrow), lds32(vrow + 8));
    }
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
template <int HD = D>
__device__ __forceinline__ void store_rows(bf16* oh, long long o_sr,
                                           int row0, int Q,
                                           const float o[Geom<HD>::ND][4],
                                           const float scale[2]) {
  const int c0 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < Geom<HD>::ND; ++n) {
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
template <int HD = D>
__device__ __forceinline__ void store_scaled(bf16* oh, long long o_sr, int q0,
                                             int Q,
                                             const float o[Geom<HD>::ND][4],
                                             const float scale[2]) {
  store_rows<HD>(oh, o_sr, q0 + tile_row(), Q, o, scale);
}

// Normalise by the row sums and write, as store_scaled.
template <int HD = D>
__device__ __forceinline__ void store(bf16* oh, long long o_sr, int q0, int Q,
                                      const float o[Geom<HD>::ND][4],
                                      float l[2]) {
  quad_sum(l);
  // l >= 1: the row's max contributes exp2(0)
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_scaled<HD>(oh, o_sr, q0, Q, o, inv);
}

}  // namespace tile
