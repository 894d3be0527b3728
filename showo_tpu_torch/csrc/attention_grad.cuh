// The omni mask of the attention kernels on the wgmma cores
// (attention_fwd_sm90.cuh, attention_grad_sm90.cuh), computed per tile
// from O(S) metadata: the metadata structs, the accumulator geometry of a
// 64 x 64 score tile, and the per-thread visibility map.
//
//   visible(b,i,j) = [ kpos[j] <= pos[i]
//                    | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
//                    | kpos[j] < prefix[b] ]
//                  & ( pad[b,j] == 0 | pos[i] <= last_pad[b] ) & i < Q, j < S
//
// pos[i] = i and seg_q = seg for self-attention (the trainable kernels 7
// and 8); the forwards of kernels 1, 2, 4 and 5 take q rows at other kv
// positions (Rows).  kpos[j] = j except for kernel 2, whose keys are a
// cached prefix followed by the fresh rows at their own positions
// (Meta::kpos).

#pragma once

#include "attention_tile.cuh"

namespace agrad {

using namespace tile;

constexpr float LN2 = 0.6931471805599453f;

// int32: seg / pad [B, S], last_pad / prefix [B]; kpos [S], the keys'
// positions (shared by the batch), null where key j sits at position j
struct Meta {
  const int* seg;
  const int* pad;
  const int* last_pad;
  const int* prefix;
  const int* kpos;
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

// Stage seg / pad (and, where kpos_s is given, the key positions) of rows
// [r0, r0 + 64) of batch row b into shared memory (zeros past S).
__device__ __forceinline__ void stage_meta(int* seg_s, int* pad_s,
                                           const Meta& mt, int b, int r0,
                                           int S, int* kpos_s = nullptr) {
  if (threadIdx.x < BLOCK_K) {
    const int j = r0 + threadIdx.x;
    seg_s[threadIdx.x] = j < S ? mt.seg[(long long)b * S + j] : 0;
    if (pad_s) pad_s[threadIdx.x] = j < S ? mt.pad[(long long)b * S + j] : 0;
    if (kpos_s) kpos_s[threadIdx.x] = j < S ? mt.kpos[j] : 0;
  }
}

// Visibility map of a tile whose accumulator rows are query rows
// (forward, dq): rows at kv positions pos[r] (-1: past Q) with segment
// sq[r], columns k0 + c with their seg / pad (and, where kpos_s is given,
// their positions; else column j is at position j) staged in smem.
__device__ __forceinline__ uint32_t query_rows_map(
    const int pos[2], const int sq[2], const bool padok[2], int k0, int S,
    int pf, const int* seg_s, const int* pad_s,
    const int* kpos_s = nullptr) {
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = acc_col(n, e), j = k0 + c;
      if (j >= S) continue;
      const int sj = seg_s[c], pk = kpos_s ? kpos_s[c] : j;
      const bool pj = pad_s[c] != 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool v = pos[r] >= 0 &&
                       ((pk <= pos[r]) || (sq[r] > 0 && sq[r] == sj) ||
                        (pk < pf)) &&
                       (!pj || padok[r]);
        bits |= (uint32_t)v << bit(r, n, e);
      }
    }
  }
  return bits;
}

// head dim 64 (the trainable kernels), kv heads dividing the q heads
inline bool bad_shape(int head_dim, int H, int Hkv) {
  return head_dim != D || Hkv <= 0 || H % Hkv != 0;
}

}  // namespace agrad
