// Omni-masked attention with a trainable forward (out and the per-row
// logsumexp) and its two backward kernels (dq; dk and dv), for Hopper
// (sm_90a): bf16 operands, fp32 scores, softmax and accumulation: the first
// kernels of the trainable attention, and the helpers (mask, metadata) the
// wgmma cores share.  Launched by:
//   streaming_attention.cu       the forward without lse, Q != S through
//                                q_positions        (Pallas kernel 5)
//   packed_attention_grad.cu     all three on q/k/v [B, S, H*D], under the
//                                packed_attention_grad_first_* entries: the
//                                baseline of kernel 7's wgmma cores, on no
//                                model path
// Every tensor is read and written through its (batch, head, row) strides
// with a contiguous last dim, so the packed layout and any head-major view
// of it (phi's [B, S, H, D].transpose(1, 2)) go in without a copy.
//
//   visible(b,i,j) = [ j <= pos[i] | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
//                    | j < prefix[b] ]
//                  & ( pad[b,j] == 0 | pos[i] <= last_pad[b] ) & i < Q, j < S
//   forward:  out = softmax(q.k^T * sm_scale, masked) . v
//             lse = logsumexp of the visible scores
//   backward: P = exp(q.k^T * sm_scale - lse) on visible entries, else 0
//             dP = dO . v^T,  delta = rowsum(dO * O)  (per head, computed by
//             the caller),  dS = P * (dP - delta) * sm_scale
//             dq = dS . k,  dk = dS^T . q,  dv = P^T . dO
// pos[i] = i and seg_q = seg for self-attention (the trainable kernels); the
// forward also takes q rows at other kv positions (Rows).
//
// A row with no visible key gets out = 0 and lse = the caller's sentinel,
// and P = 0 in the backward.  Masked scores are -inf, so such rows never
// average v (the inference kernels of omni_attention.cuh do average it).
//
// What bounds it on an H100: with D = 64 each visible (row, key) pair costs
// 4*D FLOP in the forward, 6*D in dq and 8*D in dk/dv, over O(S*D) bytes
// per (batch, head), so at S of a few hundred and more the kernels sit at
// or above the 295 FLOP/byte ridge: the tensor-core rate and the mask's
// sparsity decide, not device memory.  The design:
//   * every score stays on chip; one block per (batch, head, 64-row tile),
//     thousands of blocks at the training shapes against 132 SMs, so no
//     persistent scheduler is needed;
//   * the mask is computed once per tile into a 32-bit map per thread (two
//     rows x 16 columns) from the O(S) metadata, and a tile with no visible
//     entry is skipped by the whole block (__syncthreads_or) before its
//     operands are loaded, in all three kernels; the next tile's metadata
//     is staged into a second buffer while this tile's operands load, so
//     a tile costs two barriers and one round of global loads, as in the
//     inference kernels;
//   * dq walks the K/V tiles of one (b, h, q tile) and recomputes P from q,
//     k and the forward's lse; dk/dv walks the q tiles of one (b, kv head,
//     k tile) and sums the GQA group's heads in registers, in fp32, so no
//     atomics and no second pass;
//   * dk/dv computes S^T = K.Q^T with the block's K rows as the A operand,
//     so P^T and dS^T come out of the tensor cores already in the layout
//     of the A operand of P^T.dO and dS^T.Q.
// mma.sync m16n8k16 (attention_tile.cuh), head dim 64: what kernel 5 (the
// forward) runs.  Kernels 7 and 8 run on wgmma with cp.async tile rings:
// their forward on attention_fwd_sm90.cuh, their backward on
// attention_grad_sm90.cuh.

#pragma once

#include "attention_tile.cuh"

namespace agrad {

using namespace tile;

constexpr float LN2 = 0.6931471805599453f;
constexpr int TILE = BLOCK_Q * DP;  // one 64 x 64 tile, padded rows (bf16)
static_assert(BLOCK_Q == BLOCK_K && DP == KP, "square tiles");

struct Meta {  // int32: seg / pad [B, S], last_pad / prefix [B]
  const int* seg;
  const int* pad;
  const int* last_pad;
  const int* prefix;
};

// The q rows of the forward: kv position and segment of each, int32
// [B, Q]; both null for self-attention (row i at position i, seg[b, i]).
struct Rows {
  const int* pos;
  const int* seg;
};

// The thread's rows of the mma accumulators: tile_row() and tile_row() + 8.
// Column of accumulator entry (n, e): n * 8 + (lane % 4) * 2 + e.
__device__ __forceinline__ int acc_col(int n, int e) {
  return n * 8 + (threadIdx.x & 3) * 2 + e;
}
__device__ __forceinline__ int bit(int r, int n, int e) {
  return r * 16 + n * 2 + e;
}

// Stage seg / pad of rows [r0, r0 + 64) of batch row b into shared memory
// (zeros past S).
__device__ __forceinline__ void stage_meta(int* seg_s, int* pad_s,
                                           const Meta& mt, int b, int r0,
                                           int S) {
  if (threadIdx.x < BLOCK_K) {
    const int j = r0 + threadIdx.x;
    seg_s[threadIdx.x] = j < S ? mt.seg[(long long)b * S + j] : 0;
    if (pad_s) pad_s[threadIdx.x] = j < S ? mt.pad[(long long)b * S + j] : 0;
  }
}

// Stage the metadata of the tile after the one at r0 into ``buf`` (seg,
// then pad when ``with_pad``), if there is one.
__device__ __forceinline__ void stage_next(int* buf, bool with_pad,
                                           const Meta& mt, int b, int r0,
                                           int S) {
  if (r0 + BLOCK_K < S)
    stage_meta(buf, with_pad ? buf + BLOCK_K : nullptr, mt, b, r0 + BLOCK_K,
               S);
}

// Visibility map of a tile whose accumulator rows are query rows
// (forward, dq): rows at kv positions pos[r] (-1: past Q) with segment
// sq[r], columns k0 + c with their seg / pad staged in smem.
__device__ __forceinline__ uint32_t query_rows_map(
    const int pos[2], const int sq[2], const bool padok[2], int k0, int S,
    int pf, const int* seg_s, const int* pad_s) {
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = acc_col(n, e), j = k0 + c;
      if (j >= S) continue;
      const int sj = seg_s[c];
      const bool pj = pad_s[c] != 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool v = pos[r] >= 0 &&
                       ((j <= pos[r]) || (sq[r] > 0 && sq[r] == sj) ||
                        (j < pf)) &&
                       (!pj || padok[r]);
        bits |= (uint32_t)v << bit(r, n, e);
      }
    }
  }
  return bits;
}

// ---------------------------------------------------------------------------
// forward: out, and with LSE the logsumexp [B, H, Q]
// ---------------------------------------------------------------------------

// tiles, then seg / pad of the K tile, twice (this tile's and the next's)
constexpr int FWD_SMEM = TILE_SMEM + 4 * BLOCK_K * 4;

template <bool LSE>
__global__ void __launch_bounds__(THREADS, 4)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out,
           float* __restrict__ lse, Meta mt, Rows rows, int Q, int S,
           int group, Strides qs, Strides ks, Strides vs, Strides os,
           float scale_log2, float sentinel) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + K_OFF;
  bf16* Vt = Qs + V_OFF;
  int* meta_s = reinterpret_cast<int*>(smem + TILE_SMEM);

  const int q0 = blockIdx.x * BLOCK_Q, h = blockIdx.y, b = blockIdx.z;
  const bf16* kh = k + b * ks.b + (h / group) * ks.h;
  const bf16* vh = v + b * vs.b + (h / group) * vs.h;

  load_q(Qs, q + b * qs.b + h * qs.h, qs.r, q0, Q);
  stage_meta(meta_s, meta_s + BLOCK_K, mt, b, 0, S);
  __syncthreads();
  uint32_t qf[KD][4];
  q_fragments(Qs, qf);

  int pos[2], sq[2];
  bool padok[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + tile_row() + 8 * r;
    const long long bi = (long long)b * Q + i;
    pos[r] = -1;  // past Q
    sq[r] = 0;
    if (i < Q) {
      pos[r] = rows.pos ? rows.pos[bi] : i;
      sq[r] = rows.seg ? rows.seg[bi] : mt.seg[(long long)b * S + i];
    }
    padok[r] = pos[r] <= lp;
  }

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0, buf = 0; k0 < S; k0 += BLOCK_K, buf ^= 1) {
    const int* seg_s = meta_s + buf * 2 * BLOCK_K;
    const uint32_t vis =
        query_rows_map(pos, sq, padok, k0, S, pf, seg_s, seg_s + BLOCK_K);
    // the barrier also says that the previous tile is consumed
    const bool any = __syncthreads_or(vis != 0u);
    stage_next(meta_s + (buf ^ 1) * 2 * BLOCK_K, true, mt, b, k0, S);
    if (any) load_kv(Ks, Vt, kh, ks.r, vh, vs.r, k0, S);
    __syncthreads();
    if (!any) continue;
    float s[NK][4];
    scores(qf, Ks, s);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[n][c] = (vis >> bit(c >> 1, n, c & 1)) & 1u ? s[n][c] * scale_log2
                                                       : -INFINITY;
    softmax_update(s, m, l, o);
    pv(s, Vt, o);
  }

  quad_sum(l);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int i = q0 + tile_row() + 8 * r;
    if (LSE && (threadIdx.x & 3) == 0 && i < Q)
      lse[((long long)b * gridDim.y + h) * Q + i] =
          l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : sentinel;
  }
  store_scaled(out + b * os.b + h * os.h, os.r, q0, Q, o, inv);
}

// ---------------------------------------------------------------------------
// dq (self-attention: Q == S; lse, delta [B, H, S])
// ---------------------------------------------------------------------------

// Q / dO staging tile, K tile, K^T tile, V tile; then seg / pad of the K
// tile, twice (this tile's and the next's)
constexpr int DQ_SMEM = 4 * TILE * 2 + 4 * BLOCK_K * 4;

__global__ void __launch_bounds__(THREADS, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Meta mt, int S, int group, Strides qs,
          Strides ks, Strides vs, Strides ds, Strides dqs, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* QD = reinterpret_cast<bf16*>(smem);
  bf16* Ks = QD + TILE;
  bf16* Kt = Ks + TILE;
  bf16* Vs = Kt + TILE;
  int* meta_s = reinterpret_cast<int*>(smem + 4 * TILE * 2);

  const int q0 = blockIdx.x * BLOCK_Q, h = blockIdx.y, b = blockIdx.z;
  const bf16* kh = k + b * ks.b + (h / group) * ks.h;
  const bf16* vh = v + b * vs.b + (h / group) * vs.h;
  const float scale_log2 = sm_scale * LOG2E;

  uint32_t qf[KD][4], df[KD][4];
  load_q(QD, q + b * qs.b + h * qs.h, qs.r, q0, S);
  stage_meta(meta_s, meta_s + BLOCK_K, mt, b, 0, S);
  __syncthreads();
  q_fragments(QD, qf);
  __syncthreads();
  load_q(QD, dout + b * ds.b + h * ds.h, ds.r, q0, S);
  __syncthreads();
  q_fragments(QD, df);

  int qi[2], sq[2];
  bool padok[2];
  float lse2[2], dl[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + tile_row() + 8 * r;
    const bool in = i < S;
    const long long hr = ((long long)b * gridDim.y + h) * S + i;
    qi[r] = in ? i : -1;
    sq[r] = in ? mt.seg[(long long)b * S + i] : 0;
    padok[r] = i <= lp;
    lse2[r] = in ? lse[hr] * LOG2E : 0.f;
    dl[r] = in ? delta[hr] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0, buf = 0; k0 < S; k0 += BLOCK_K, buf ^= 1) {
    const int* seg_s = meta_s + buf * 2 * BLOCK_K;
    const uint32_t vis =
        query_rows_map(qi, sq, padok, k0, S, pf, seg_s, seg_s + BLOCK_K);
    // the barrier also says that the previous tile is consumed
    const bool any = __syncthreads_or(vis != 0u);
    stage_next(meta_s + (buf ^ 1) * 2 * BLOCK_K, true, mt, b, k0, S);
    if (any) {
      load_kv(Ks, Kt, kh, ks.r, kh, ks.r, k0, S);
      load_q(Vs, vh, vs.r, k0, S);
    }
    __syncthreads();
    if (!any) continue;
    float s[NK][4], dp[NK][4];
    scores(qf, Ks, s);
    scores(df, Vs, dp);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = (vis >> bit(r, n, c & 1)) & 1u
                            ? exp2f(s[n][c] * scale_log2 - lse2[r])
                            : 0.f;
        s[n][c] = p * (dp[n][c] - dl[r]) * sm_scale;  // dS
      }
    pv(s, Kt, acc);  // dq += dS . K
  }
  const float one[2] = {1.f, 1.f};
  store_scaled(dq + b * dqs.b + h * dqs.h, dqs.r, q0, S, acc, one);
}

// ---------------------------------------------------------------------------
// dk, dv (self-attention; per kv head, the GQA group summed)
// ---------------------------------------------------------------------------

// Q, Q^T, dO, dO^T tiles; then lse, delta of the q tile's rows and their
// seg, twice (this tile's and the next's)
constexpr int DKV_SMEM = 4 * TILE * 2 + 4 * BLOCK_Q * 4;

__global__ void __launch_bounds__(THREADS, 2)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, Meta mt, int S,
           int group, Strides qs, Strides ks, Strides vs, Strides ds,
           Strides dks, Strides dvs, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Qt = Qs + TILE;
  bf16* Ds = Qt + TILE;
  bf16* Dt = Ds + TILE;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * TILE * 2);
  float* dl_s = lse_s + BLOCK_Q;
  int* meta_s = reinterpret_cast<int*>(dl_s + BLOCK_Q);

  const int k0 = blockIdx.x * BLOCK_K, kvh = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * group;
  const float scale_log2 = sm_scale * LOG2E;

  // the block's K and V rows as A fragments, for the whole q loop
  uint32_t kf[KD][4], vf[KD][4];
  load_q(Qs, k + b * ks.b + kvh * ks.h, ks.r, k0, S);
  load_q(Ds, v + b * vs.b + kvh * vs.h, vs.r, k0, S);
  stage_meta(meta_s, nullptr, mt, b, 0, S);
  __syncthreads();
  q_fragments(Qs, kf);
  q_fragments(Ds, vf);

  // this thread's key rows and their metadata
  int kj[2], sk[2];
  bool pk[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = k0 + tile_row() + 8 * r;
    const bool in = kj[r] < S;
    sk[r] = in ? mt.seg[(long long)b * S + kj[r]] : 0;
    pk[r] = in && mt.pad[(long long)b * S + kj[r]] != 0;
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int i0 = 0, buf = 0; i0 < S; i0 += BLOCK_Q, buf ^= 1) {
    const int* segq_s = meta_s + buf * BLOCK_Q;
    // rows: keys kj[r]; columns: query rows i0 + c
    uint32_t vis = 0;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = acc_col(n, e), i = i0 + c;
        if (i >= S) continue;
        const int si = segq_s[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool vv = kj[r] < S &&
                          ((kj[r] <= i) || (si > 0 && si == sk[r]) ||
                           (kj[r] < pf)) &&
                          (!pk[r] || i <= lp);
          vis |= (uint32_t)vv << bit(r, n, e);
        }
      }
    // the barrier also says that the previous tile is consumed
    const bool any = __syncthreads_or(vis != 0u);
    stage_next(meta_s + (buf ^ 1) * BLOCK_Q, false, mt, b, i0, S);
    if (!any) {
      __syncthreads();  // the next tile's seg is staged
      continue;
    }

    for (int g = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const bf16* qh = q + b * qs.b + h * qs.h;
      const bf16* dh = dout + b * ds.b + h * ds.h;
      if (g) __syncthreads();  // the previous head's tiles are consumed
      load_kv(Qs, Qt, qh, qs.r, qh, qs.r, i0, S);
      load_kv(Ds, Dt, dh, ds.r, dh, ds.r, i0, S);
      if (threadIdx.x < BLOCK_Q) {
        const int i = i0 + threadIdx.x;
        const long long hr = ((long long)b * H + h) * S + i;
        lse_s[threadIdx.x] = i < S ? lse[hr] * LOG2E : 0.f;
        dl_s[threadIdx.x] = i < S ? delta[hr] : 0.f;
      }
      __syncthreads();
      float p[NK][4], dsr[NK][4];
      scores(kf, Qs, p);    // S^T: keys x query rows
      scores(vf, Ds, dsr);  // dP^T = V . dO^T
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = acc_col(n, c & 1);
          p[n][c] = (vis >> bit(c >> 1, n, c & 1)) & 1u
                        ? exp2f(p[n][c] * scale_log2 - lse_s[col])
                        : 0.f;
          dsr[n][c] = p[n][c] * (dsr[n][c] - dl_s[col]) * sm_scale;
        }
      pv(p, Dt, dva);    // dv += P^T . dO
      pv(dsr, Qt, dka);  // dk += dS^T . Q
    }
  }
  const float one[2] = {1.f, 1.f};
  store_scaled(dk + b * dks.b + kvh * dks.h, dks.r, k0, S, dka, one);
  store_scaled(dv + b * dvs.b + kvh * dvs.h, dvs.r, k0, S, dva, one);
}

// ---------------------------------------------------------------------------
// launches on ``stream``; each returns the cudaError_t of its launch
// ---------------------------------------------------------------------------

inline dim3 grid_of(int rows, int heads, int B) {
  return dim3((rows + BLOCK_Q - 1) / BLOCK_Q, heads, B);
}

inline bool bad_shape(int head_dim, int H, int Hkv) {
  return head_dim != D || Hkv <= 0 || H % Hkv != 0;
}

// forward: q rows Q (Rows null: Q == S); lse null without LSE
template <bool LSE>
inline int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, Meta mt, Rows rows, int B, int Q, int S,
                      int H, int Hkv, Strides qs, Strides ks, Strides vs,
                      Strides os, float sm_scale, float sentinel,
                      void* stream) {
  fwd_kernel<LSE><<<grid_of(Q, H, B), THREADS, FWD_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, mt, rows, Q,
      S, H / Hkv, qs, ks, vs, os, sm_scale * LOG2E, sentinel);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, Meta mt, int B, int S, int H, int Hkv,
                     Strides qs, Strides ks, Strides vs, Strides ds,
                     Strides dqs, float sm_scale, void* stream) {
  dq_kernel<<<grid_of(S, H, B), THREADS, DQ_SMEM,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), mt, S, H / Hkv, qs, ks, vs, ds, dqs, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, Meta mt, int B, int S, int H,
                      int Hkv, Strides qs, Strides ks, Strides vs, Strides ds,
                      Strides dks, Strides dvs, float sm_scale,
                      void* stream) {
  dkv_kernel<<<grid_of(S, Hkv, B), THREADS, DKV_SMEM,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), mt, S, H / Hkv, qs, ks,
      vs, ds, dks, dvs, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace agrad
