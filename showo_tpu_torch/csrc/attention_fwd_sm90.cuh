// One forward attention core for Hopper (sm_90a) on wgmma, beside the
// backward of attention_grad_sm90.cuh and on its pieces: masked attention
// out = softmax(q.k^T * sm_scale, masked) . v with bf16 operands and fp32
// scores, online softmax and accumulation, every tensor read and written
// through its (batch, head, row) strides.  Eight callers, three masks
// (template argument MASK):
//   MASK_INF, the omni mask from metadata, masked scores -inf, so a row
//     with no visible key gets out = 0 (and lse = the caller's sentinel
//     where lse is written):
//     the forwards of kernels 8 and 7 (streaming_attention_grad.cu on
//       head-major views, packed_attention_grad.cu on the packed layout),
//       self-attention, head dim 64, lse written; the map of
//       tile_map_kernel.  Replace the Pallas _fwd_kernel of
//       showo_tpu/ops/streaming_attention_grad.py::_fwd and
//       packed_attention_grad.py::_fwd;
//     kernel 5 (streaming_attention.cu) at head dims 64 and 128: head-major
//       views, q rows by (pos_q, seg_q), Q != S, no lse; the map of
//       rows_tile_map_kernel, whose flag it does not need (skipping a tile
//       is exact under -inf).  Replaces the Pallas _stream_kernel of
//       showo_tpu/ops/streaming_attention.py::omni_attention_streaming.
//   MASK_MEAN, masked scores -1e30, so a row with no visible key averages
//     v over all S columns, and columns past S take no weight; q rows by
//     (pos_q, seg_q), Q != S, no lse, the map of rows_tile_map_kernel with
//     its flag:
//     kernel 1 (omni_attention_packed.cu) at head dims 64 and 128 on the
//       packed [B, S, H*D] layout.  Replaces the Pallas
//       _attn_kernel_packed of
//       showo_tpu/ops/flash_attention.py::omni_attention_packed;
//     kernel 6 (omni_attention_gqa_stacked.cu) at head dims 64 and 128 on
//       the packed layout, with W > 1 warpgroups a block, one q head of a
//       kv head's group each, sharing the ring of K / V tiles.  Replaces
//       the pallas_call of
//       showo_tpu/ops/flash_attention.py::_omni_attention_gqa_stacked
//       (its _attn_kernel on the heads stacked along rows);
//     kernel 4 (omni_attention.cu) at head dim 64 on head-major views.
//       Replaces the Pallas _attn_kernel of
//       showo_tpu/ops/flash_attention.py::omni_attention;
//     kernel 2 (fused_decode.cu) at head dim 64 with SPLIT: K and V rows
//       j < P from the cache views, rows j >= P from the fresh rows'
//       buffers (row j - P), and the keys at the positions Meta::kpos.
//       Replaces, after the LN + RoPE pass of that source, the Pallas
//       _kernel of showo_tpu/ops/fused_decode.py::fused_decode_attention;
//       with BF16S its softmax_dtype=bfloat16 variant: each score
//       q.k * sm_scale (masked) rounded to bf16 before the softmax, each
//       probability rounded to bf16 before the row sum.
//   MASK_BIAS, kernel 3 (decode_attention.cu) at head dim 64: the mask
//     arrives as an additive fp32 bias [B, 1, Q, K] read through its
//     strides; score = (q.k * sm_scale + bias) in the log2 domain, the
//     ragged K edge -inf; the map of bias_tile_map_kernel.  Replaces the
//     Pallas _kernel and _kernel_headloop of
//     showo_tpu/ops/decode_attention.py::decode_attention.
//
// What bounds it on an H100: 4 * D FLOP per visible (row, key) pair and
// head over O(S * D) bytes a head, so the tensor-core rate at the visible
// share: at kernel 8's 512x512 step (B=12, S=1408, H=32, D=64, 0.60 of
// the pairs visible) 0.126 ms at 989 TFLOP/s, at the v1 512x512 cached
// step (B=4, Q=1026, S=1155, D=64) 0.035 ms (kernel 3 adds the 19 MB of
// its bias, 0.006 ms at 3.35 TB/s), at Show-o2's rows (B=8, S=768) 0.028
// ms for Qwen's 12 q / 2 kv heads of 128 and 0.037 ms for the DiT's 32 /
// 8 of 64.  What held the first forwards (mma.sync tile cores, now
// removed) back, and what this design does about it:
//   1. Each K / V tile loaded synchronously, two barriers a tile, no copy
//      in flight during the products: here a ring of STAGES (K, V) tiles
//      in dynamic shared memory, filled by cp.async, the next visible
//      tiles' copies in flight while this tile's products run.
//   2. V transposed into shared memory by scalar stores: here every tile
//      is stored once as it lies in memory (64-element head-row panels of
//      128 bytes, the 128-byte swizzle), and P.V reads V through the
//      MN-major descriptor; P goes from the score accumulators, rounded
//      to bf16, straight into wgmma's register A operand.
//   3. mma.sync with every B fragment read per warp: here wgmma
//      m64n64k16, one warpgroup per 64 q rows, Q resident in shared
//      memory; S = Q.K^T with both operands from shared memory (HD / 16
//      k16 steps over HD / 64 panels), O += P.V as one n64 product per
//      panel of the head dim (64 fp32 accumulator registers a thread at
//      HD = 128).
//   4. Every K tile visited and masked element by element (kernel 3: every
//      bias entry read by its thread from device memory, once per head):
//      here the block walks the visible K tiles of its row of a tile map
//      made once per forward (agrad90::tile_map_kernel for kernels 7 and
//      8, rows_tile_map_kernel for kernels 1, 2, 4 and 5 from the O(S)
//      metadata, bias_tile_map_kernel for kernel 3 from the bias), and
//      masks only the tiles the map marks partial; kernel 3 copies a
//      partial tile's bias into the ring beside K and V and reads no bias
//      for a tile whose every entry is 0.  Under -1e30 (kernels 1, 2, 4) or a
//      -1e9 bias (kernel 3) a tile may be skipped only where every row of
//      the block sees some key (a masked score then weighs exactly 0); the
//      map flags the q tiles that hold a row with no visible key, and
//      their blocks visit and mask every tile.
// The ring depth and the resident blocks per SM (FwdCfg) were set by
// timing on an H100.  No atomics: two launches give the same bits.

#pragma once

#include "attention_grad_sm90.cuh"

namespace agrad90 {

// The mask of wgmma_fwd_kernel (see the top of this file)
enum : int { MASK_INF = 0, MASK_MEAN = 1, MASK_BIAS = 2 };

// MASK_BIAS: the additive fp32 bias [B, 1, Q, K], batch and row strides
// in elements, its last dim contiguous, and sm_scale itself (the score is
// (q.k * scale + bias) * log2 e, as the dense path forms it)
struct Bias {
  const float* p;
  long long sb, sr;
  float scale;
};

// Dynamic shared memory of wgmma_fwd_kernel: the W warpgroups' Q tiles
// (HD / 64 panels each); the ring of STAGES stages, each a K and a V tile
// and with MASK_BIAS the 64 x 64 fp32 bias tile (16 KB), else the K
// tile's seg and pad (and with SPLIT the keys' positions); the visible
// tile count and list.  One warpgroup (W = 1): HD = 64: 2 stages, 41 KB
// (SPLIT 42 KB), 4 blocks an SM (at most 128 registers); with the bias
// 72 KB, 3 blocks; HD = 128: 2 stages, 81 KB, 2 blocks an SM.  On an H100
// 4 blocks of 2 stages ran kernel 8's forward ~6% faster than 3 blocks of
// 3; at HD = 128 one block an SM ran as fast as 2, and a third stage (one
// block) slower.  W warpgroups (kernel 6, W q heads of one kv head): the
// register file holds as many warpgroups an SM as with W = 1, so 4 / W
// blocks at HD = 64 and one at HD = 128; 3 stages, since the W
// warpgroups wait for each other at every tile.  On an H100 at Show-o2's
// rows W = 2 ran at kernel 1's time at both head dims, and W = 4 (one
// block an SM) at HD = 64 ~15% slower.
template <int HD, int MASK, bool SPLIT = false, int W = 1>
struct FwdCfg {
  static constexpr bool BIAS = MASK == MASK_BIAS;
  static constexpr int TILE = BLK * HD * 2;
  static constexpr int BIAS_TILE = BLK * BLK * 4;
  static constexpr int STAGES = W == 1 ? 2 : 3;
  static constexpr int BLOCKS =
      W == 1 ? (BIAS ? 3 : HD == 64 ? 4 : 2)
             : (HD == 64 && W <= 2 ? 4 / W : 1);
  static constexpr int RING = W * TILE;
  static constexpr int STAGE = 2 * TILE + (BIAS ? BIAS_TILE : 0);
  static constexpr int META = RING + STAGES * STAGE;
  static constexpr int META_INTS = (SPLIT ? 3 : 2) * BLK;  // a stage's
  static constexpr int LIST = META + (BIAS ? 0 : STAGES * META_INTS * 4);
  static int smem(int nk) { return LIST + 4 * (nk + 1); }
};

// Byte offset of bias entry (r, c) in a 64 x 64 fp32 bias tile: the pair
// of columns c / 2 of row r at (c / 2) ^ ((r & 3) << 2), so that the 8-byte
// reads of a half warp (4 rows, the same 4 pairs of each) fall on 32
// distinct banks.
__device__ __forceinline__ uint32_t bias_off(int r, int c) {
  return (r * BLK + (((c >> 1) ^ ((r & 3) << 2)) << 1) + (c & 1)) * 4;
}

// Rows [q0, q0 + 64) x keys [k0, k0 + 64) of one batch row's bias (row
// stride ld) -> a bias tile at dst, zeros past Q and K.  4-byte copies: a
// row of the cached step's view starts at any 4-byte boundary (its stride
// is the whole sequence, 1155 or 387 entries); neighbouring threads copy
// neighbouring keys of one row.
__device__ __forceinline__ void load_bias(uint32_t dst, const float* src,
                                          long long ld, int q0, int Q,
                                          int k0, int K) {
  const int c = threadIdx.x & (BLK - 1);
  const bool cin = k0 + c < K;
#pragma unroll
  for (int i = 0; i < BLK * BLK / THREADS; ++i) {
    const int r = (threadIdx.x / BLK) + (THREADS / BLK) * i;
    const bool in = cin && q0 + r < Q;
    cp_async4(dst + bias_off(r, c),
              in ? src + (long long)(q0 + r) * ld + k0 + c : src,
              in ? 4 : 0);
  }
}

// Kernel 2's second K / V source (SPLIT): key rows j >= p of a head come
// from k and v here, at row j - p, through their (batch, head, row)
// strides; rows j < p from the kernel's own k and v (the cache views).
struct Split {
  const bf16* k;
  const bf16* v;
  Strides ks, vs;
  int p;
};

// Rows [r0, r0 + 64) of one head -> a 64 x HD tile at dst as load_tile,
// row j < p from a (row stride lda), row j >= p from b at row j - p (row
// stride ldb), zeros past S: the choice is made per row, so the tile that
// holds row p takes its first rows from a and the rest from b.
template <int HD>
__device__ __forceinline__ void load_tile_split(uint32_t dst, const bf16* a,
                                                long long lda, const bf16* b,
                                                long long ldb, int r0, int p,
                                                int S) {
  constexpr int CH = HD / 8;
#pragma unroll
  for (int i = 0; i < BLK * CH / THREADS; ++i) {
    const int q = threadIdx.x + i * THREADS, row = q / CH, c = q % CH;
    const int j = r0 + row;
    const bf16* src = j < p ? a + (long long)j * lda
                            : b + (long long)(j - p) * ldb;
    cp_async16(dst + (c / 8) * PANEL + row * 128 + (((c % 8) ^ (row & 7)) * 16),
               j < S ? src + 8 * c : a, j < S ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// the tile map of kernels 1, 2, 4 and 5: q rows at (pos_q, seg_q), Q != S
// ---------------------------------------------------------------------------

// [B, nq, nk + 1] bytes: entry kt < nk of (b, q tile) is 0 where no entry
// of the 64 x 64 pair is visible, 1 where some are, 3 where all are (rows
// past Q and keys past S count as not visible); entry nk is 1 where some
// row of the q tile (< Q) sees no key at all, else 0.  Keys at the
// positions mt.kpos where it is not null (kernel 2).  One block per (q
// tile, b) walks the K tiles.
__global__ void __launch_bounds__(THREADS)
rows_tile_map_kernel(Meta mt, agrad::Rows rows, int Q, int S,
                     uint8_t* __restrict__ tiles) {
  __shared__ int meta_s[3 * BLK];
  int* kpos_s = mt.kpos ? meta_s + 2 * BLK : nullptr;
  const int qt = blockIdx.x, b = blockIdx.y;
  const int nk = (S + BLK - 1) / BLK;
  uint8_t* row = tiles + ((long long)b * gridDim.x + qt) * (nk + 1);
  int pos[2], sq[2];
  bool padok[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qt * BLK + tile::tile_row() + 8 * r;
    const long long bi = (long long)b * Q + i;
    pos[r] = i < Q ? rows.pos[bi] : -1;
    sq[r] = i < Q ? rows.seg[bi] : 0;
    padok[r] = pos[r] <= lp;
  }
  uint32_t seen = 0;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's metadata is consumed
    agrad::stage_meta(meta_s, meta_s + BLK, mt, b, kt * BLK, S, kpos_s);
    __syncthreads();
    const uint32_t bits = agrad::query_rows_map(
        pos, sq, padok, kt * BLK, S, pf, meta_s, meta_s + BLK, kpos_s);
    seen |= bits;
    const bool any = __syncthreads_or(bits != 0u);
    const bool all = __syncthreads_and(bits == 0xffffffffu);
    if (threadIdx.x == 0) row[kt] = any ? (all ? 3 : 1) : 0;
  }
  // a row's 64 columns lie with the 4 threads of its quad
  seen |= __shfl_xor_sync(0xffffffffu, seen, 1);
  seen |= __shfl_xor_sync(0xffffffffu, seen, 2);
  bool empty = false;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    empty |= pos[r] >= 0 && !(seen & (0xffffu << (16 * r)));
  const bool flag = __syncthreads_or(empty);
  if (threadIdx.x == 0) row[nk] = flag ? 1 : 0;
}

// ---------------------------------------------------------------------------
// the tile map of kernel 3: an additive bias [B, 1, Q, K]
// ---------------------------------------------------------------------------

constexpr float BIAS_MASKED = -1e9f;  // the masks' masked value (ops/masks.py)
constexpr float BIAS_SEES = -1e8f;    // a row with an entry above sees a key

// [B, nq, nk + 1] bytes from the bias (batch / row strides sb / sr): entry
// kt < nk of (b, q tile) is 3 where the K tile lies inside K and every
// entry of its rows < Q is exactly 0 (no bias is read), 0 where every
// entry (rows < Q, keys < K) is <= -1e9 (the tile is skipped), 1
// otherwise (the bias is read and added); entry nk is 1 where some row of
// the q tile (< Q) has no entry above -1e8 (it averages v over the K keys,
// so its block visits every tile), else 0.  Skipping is exact: a row with
// an entry above -1e8 weighs an entry at or below -1e9 by exp(< -9e8),
// which is 0 in fp32.  One block per (q tile, b) walks the K tiles;
// neighbouring threads read neighbouring keys of one row.
__global__ void __launch_bounds__(THREADS)
bias_tile_map_kernel(const float* __restrict__ bias, long long sb,
                     long long sr, int Q, int K,
                     uint8_t* __restrict__ tiles) {
  __shared__ uint32_t seen_s[THREADS / 32];
  const int qt = blockIdx.x, b = blockIdx.y, q0 = qt * BLK;
  const int nk = (K + BLK - 1) / BLK;
  uint8_t* row = tiles + ((long long)b * gridDim.x + qt) * (nk + 1);
  const int c = threadIdx.x & (BLK - 1), r0 = threadIdx.x / BLK;
  constexpr int ROWS = BLK * BLK / THREADS;  // rows r0 + 2 i of a thread
  const float* src = bias + b * sb;
  uint32_t seen = 0;  // bit i: row r0 + 2 i has an entry above -1e8
  for (int kt = 0; kt < nk; ++kt) {
    const int j = kt * BLK + c;
    bool zero = kt * BLK + BLK <= K, low = true;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = q0 + r0 + (THREADS / BLK) * i;
      if (r < Q && j < K) {
        const float x = __ldg(src + (long long)r * sr + j);
        zero &= x == 0.f;
        low &= x <= BIAS_MASKED;
        seen |= (uint32_t)(x > BIAS_SEES) << i;
      }
    }
    const bool all_zero = __syncthreads_and(zero);
    const bool all_low = __syncthreads_and(low);
    if (threadIdx.x == 0) row[kt] = all_zero ? 3 : all_low ? 0 : 1;
  }
  seen = __reduce_or_sync(0xffffffffu, seen);
  if ((threadIdx.x & 31) == 0) seen_s[threadIdx.x / 32] = seen;
  __syncthreads();
  if (threadIdx.x == 0) {
    // warps 2h and 2h + 1 hold rows h + 2 i
    bool flag = false;
    for (int h = 0; h < THREADS / BLK; ++h) {
      const uint32_t s = seen_s[2 * h] | seen_s[2 * h + 1];
      for (int i = 0; i < ROWS; ++i)
        flag |= q0 + h + (THREADS / BLK) * i < Q && !((s >> i) & 1u);
    }
    row[nk] = flag ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

// Grid (ceil(Q / 64), H, B), one warpgroup a block.  tiles: the block's
// map row is tiles + (b * nq + q tile) * ld (nk entries; MASK_MEAN and
// MASK_BIAS read the flag at nk).  rows.pos null: self-attention (row i at
// position i, seg[b, i]).  MASK_BIAS reads no metadata; S is then K.
// SPLIT (kernel 2): key rows j >= split.p from split.k / split.v, keys at
// the positions mt.kpos.
// BF16S (kernel 2's bf16 softmax): ``scale`` is sm_scale itself, and a
// visible logit is bf16(q.k * sm_scale) * log2 e, as the JAX kernel rounds
// its scores to bf16 before the softmax; the probabilities are rounded to
// bf16 before the row sum (tile::softmax_update's ROUND_P).  Otherwise
// ``scale`` is sm_scale * log2 e.  The online softmax rescales the tiles
// seen so far where JAX takes one max over the row, so the two round at
// different points: the variant is held to its plain version at the
// card's attention limit, not bit for bit.
// W > 1 (kernel 6, MASK_MEAN): grid (ceil(Q / 64), Hkv * ceil(G / W), B)
// for a group of G = ``group`` q heads a kv head, W warpgroups a block:
// warpgroup w runs q head slice * W + w of the group (the last slice's
// warpgroups past G repeat head G - 1 and store nothing), each on its own
// Q tile, all W reading one ring of the kv head's K / V tiles.  The mask
// does not depend on the head, so every warpgroup walks the same tile
// list and does what the one warpgroup of W = 1 does for its head: the
// same bits.  A stage is refilled only after the block barrier at the top
// of an iteration, which all W warpgroups reach after their last product
// on it.
template <int HD, int MASK, bool SPLIT = false, int W = 1,
          bool BF16S = false>
__global__ void __launch_bounds__(W * THREADS,
                                  FwdCfg<HD, MASK, SPLIT, W>::BLOCKS)
wgmma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, Meta mt, agrad::Rows rows,
                 Bias bias, const uint8_t* __restrict__ tiles, int ld, int Q,
                 int S, int group, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, float sentinel, Split split) {
  static_assert(W == 1 || (MASK == MASK_MEAN && !SPLIT),
                "several warpgroups: kernel 6's mask only");
  static_assert(!BF16S || (MASK == MASK_MEAN && SPLIT),
                "bf16 scores: kernel 2 only");
  using C = FwdCfg<HD, MASK, SPLIT, W>;
  constexpr bool BIAS = C::BIAS;
  constexpr int P = HD / 64;  // panels of a head row
  // P.V is waited for at the end of its iteration, so the stage read last
  // is free when the next copies are issued.  (Left in flight across the
  // loop's back edge, it made ptxas serialize every wgmma of the kernel:
  // warning C7515.)
  constexpr int LOOKAHEAD = C::STAGES - 1;
  // a visible score in the log2 domain
  auto logit = [scale](float x) {
    if constexpr (BF16S)
      return __bfloat162float(__float2bfloat16_rn(x * scale)) * tile::LOG2E;
    else
      return x * scale;
  };
  extern __shared__ __align__(1024) uint8_t ring_smem[];
  const uint32_t sb = smem_u32(ring_smem);
  int* list = reinterpret_cast<int*>(ring_smem + C::LIST) + 1;

  const int qt = blockIdx.x, b = blockIdx.z;
  const int q0 = qt * BLK, nk = (S + BLK - 1) / BLK;
  // this thread: thread t of warpgroup wg, which runs q head h of kv head
  // hk (stores where ``mine``)
  const int wg = W == 1 ? 0 : threadIdx.x / THREADS;
  const int t = W == 1 ? threadIdx.x : threadIdx.x % THREADS;
  int h = blockIdx.y, hk = h / group;
  bool mine = true;
  if constexpr (W > 1) {
    const int slices = (group + W - 1) / W;
    const int g = blockIdx.y % slices * W + wg;
    hk = blockIdx.y / slices;
    mine = g < group;
    h = hk * group + min(g, group - 1);
  }
  const bf16* kh = k + b * ks.b + hk * ks.h;
  const bf16* vh = v + b * vs.b + hk * vs.h;
  const float* bh = BIAS ? bias.p + b * bias.sb : nullptr;

  const uint8_t* trow = tiles + ((long long)b * gridDim.x + qt) * ld;
  const int n = visible_tiles(trow, 1, nk, list, list - 1,
                              MASK != MASK_INF && trow[nk] != 0);
  // this warpgroup's Q tile
  const uint32_t qb = sb + wg * C::TILE;
  load_tile<HD, THREADS>(qb, q + b * qs.b + h * qs.h, qs.r, q0, Q, t);
  // tile i of the list -> stage i % STAGES: K, V, and the bias tile (a
  // partial tile of MASK_BIAS) or the keys' seg / pad; with W warpgroups
  // the K and V copies are shared by all, the seg / pad ones by the first
  auto load_stage = [&](int i) {
    const int st = i % C::STAGES, k0 = (list[i] >> 1) * BLK;
    const uint32_t kb = sb + C::RING + st * C::STAGE;
    if constexpr (SPLIT) {
      load_tile_split<HD>(kb, kh, ks.r,
                          split.k + b * split.ks.b + hk * split.ks.h,
                          split.ks.r, k0, split.p, S);
      load_tile_split<HD>(kb + C::TILE, vh, vs.r,
                          split.v + b * split.vs.b + hk * split.vs.h,
                          split.vs.r, k0, split.p, S);
    } else {
      load_tile<HD, W * THREADS>(kb, kh, ks.r, k0, S, threadIdx.x);
      load_tile<HD, W * THREADS>(kb + C::TILE, vh, vs.r, k0, S, threadIdx.x);
    }
    if constexpr (BIAS) {
      if (!(list[i] & FULL))
        load_bias(kb + 2 * C::TILE, bh, bias.sr, q0, Q, k0, S);
    } else if (W == 1 || threadIdx.x < THREADS) {
      const int j = k0 + (threadIdx.x & (BLK - 1));
      const int* src = threadIdx.x < BLK ? mt.seg : mt.pad;
      const uint32_t meta = sb + C::META + st * C::META_INTS * 4;
      cp_async4(meta + threadIdx.x * 4,
                src + (long long)b * S + (j < S ? j : 0), j < S ? 4 : 0);
      if constexpr (SPLIT) {
        if (threadIdx.x < BLK)
          cp_async4(meta + (2 * BLK + threadIdx.x) * 4,
                    mt.kpos + (j < S ? j : 0), j < S ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < LOOKAHEAD; ++i) {
    if (i < n) load_stage(i);
    cp_async_commit();
  }

  // this thread's rows q0 + tile_row() (+ 8): the rows of the wgmma
  // accumulator fragments, as of mma.sync's
  int pos[2] = {-1, -1}, sq[2] = {0, 0};
  bool padok[2] = {false, false};
  int pf = 0;
  if constexpr (!BIAS) {
    const int lp = mt.last_pad[b];
    pf = mt.prefix[b];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + tile::tile_row(t) + 8 * r;
      const long long bi = (long long)b * Q + i;
      if (i < Q) {  // else past Q: pos -1
        pos[r] = rows.pos ? rows.pos[bi] : i;
        sq[r] = rows.seg ? rows.seg[bi] : mt.seg[(long long)b * S + i];
      }
      padok[r] = pos[r] <= lp;
    }
  }

  float o[8 * P][4], s[8][4], m[2] = {-INFINITY, -INFINITY},
                              l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 8 * P; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<LOOKAHEAD - 1>();
    fence_proxy_async();
    // tile i has landed for every thread, and no product reads the stage
    // refilled below
    __syncthreads();
    if (i + LOOKAHEAD < n) load_stage(i + LOOKAHEAD);
    cp_async_commit();
    const int st = i % C::STAGES, entry = list[i];
    const uint32_t kb = sb + C::RING + st * C::STAGE, vb = kb + C::TILE;
    // S = Q.K^T, K-major from shared memory, HD / 16 steps over the panels
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * PANEL + 32 * (kk % 4);
      wgmma_ss64(&s[0][0], gmma_desc_sw128(qb + off),
                 gmma_desc_sw128(kb + off), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    // log2-domain logits; the mask only on tiles not all visible
    if constexpr (BIAS) {
      // (q.k * scale + bias) * log2 e, the product rounded on its own, so
      // a FULL tile (bias 0, not read) gives the bits of a read 0
      if (entry & FULL) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[j][c] = __fmul_rn(s[j][c], bias.scale) * tile::LOG2E;
      } else {
        const int k0 = (entry >> 1) * BLK;
        const uint8_t* bt = ring_smem + (kb - sb) + 2 * C::TILE;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int col = agrad::acc_col(j, 0);
            const float2 x = *reinterpret_cast<const float2*>(
                bt + bias_off(tile::tile_row() + 8 * r, col));
            s[j][2 * r] = k0 + col < S ? (__fmul_rn(s[j][2 * r], bias.scale)
                                          + x.x) * tile::LOG2E
                                       : -INFINITY;
            s[j][2 * r + 1] =
                k0 + col + 1 < S
                    ? (__fmul_rn(s[j][2 * r + 1], bias.scale) + x.y) *
                          tile::LOG2E
                    : -INFINITY;
          }
      }
    } else if (entry & FULL) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = logit(s[j][c]);
    } else {
      const int k0 = (entry >> 1) * BLK;
      const int* seg_s =
          reinterpret_cast<const int*>(ring_smem + C::META) +
          st * C::META_INTS;
      const uint32_t vis = agrad::query_rows_map(
          pos, sq, padok, k0, S, pf, seg_s, seg_s + BLK,
          SPLIT ? seg_s + 2 * BLK : nullptr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float masked =
              MASK == MASK_MEAN && k0 + agrad::acc_col(j, c & 1) < S
                  ? tile::MASKED
                  : -INFINITY;
          s[j][c] = (vis >> agrad::bit(c >> 1, j, c & 1)) & 1u
                        ? logit(s[j][c])
                        : masked;
        }
    }
    tile::softmax_update<HD, tile::Exp2Ftz, BF16S>(s, m, l, o);
    uint32_t a[4][4];
    to_a(s, a);
    // O += P.V: V read as the MN-major B operand, 16 keys a step, one n64
    // product per panel of the head dim
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs64_tb(&o[8 * p][0], a[kk],
                      gmma_desc_sw128_mn(vb + p * PANEL + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_acc(o + 8 * p);
  }
  cp_async_wait<0>();

  bf16* oh = out + b * os.b + h * os.h;
  if constexpr (MASK == MASK_MEAN) {
    if (mine) tile::store<HD>(oh, os.r, q0 + tile::tile_row(t), Q, o, l);
    return;
  }
  tile::quad_sum(l);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int i = q0 + tile::tile_row() + 8 * r;
    if (lse && (threadIdx.x & 3) == 0 && i < Q)
      lse[((long long)b * gridDim.y + h) * Q + i] =
          l[r] > 0.f ? m[r] * agrad::LN2 + logf(l[r]) : sentinel;
  }
  tile::store_scaled<HD>(oh, os.r, q0, Q, o, inv);
}

// ---------------------------------------------------------------------------
// launches on ``stream``; each returns the cudaError_t of its launch
// ---------------------------------------------------------------------------

// the tile map of kernels 1, 2, 4 and 5, [B, ceil(Q / 64), ceil(S / 64)
// + 1] bytes
inline int launch_rows_tile_map(Meta mt, agrad::Rows rows, int B, int Q,
                                int S, uint8_t* tiles, void* stream) {
  rows_tile_map_kernel<<<dim3(tiles_of(Q), B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(mt, rows, Q, S,
                                                              tiles);
  return static_cast<int>(cudaGetLastError());
}

// kernel 3's tile map, [B, ceil(Q / 64), ceil(K / 64) + 1] bytes
inline int launch_bias_tile_map(const float* bias, long long sb,
                                long long sr, int B, int Q, int K,
                                uint8_t* tiles, void* stream) {
  bias_tile_map_kernel<<<dim3(tiles_of(Q), B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(bias, sb, sr, Q,
                                                              K, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ``tiles``: the map of tile_map_kernel (self-attention, [B, nk, nk]), or
// with ``flagged`` one of rows_tile_map_kernel or bias_tile_map_kernel
// ([B, nq, nk + 1]).  MASK_INF: q rows by ``rows`` (null: Q == S, self-
// attention), lse written where not null.  MASK_MEAN: q rows by ``rows``,
// lse null; with SPLIT the keys' second source ``split`` and their
// positions mt.kpos.  MASK_BIAS: ``bias``, no metadata, lse null; S is K.
// W > 1 (MASK_MEAN): W q heads of a kv head a block (kernel 6).  BF16S:
// kernel 2's bf16 scores (see wgmma_fwd_kernel).
template <int HD, int MASK, bool SPLIT = false, int W = 1,
          bool BF16S = false>
inline int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, Meta mt, agrad::Rows rows, Bias bias,
                      const uint8_t* tiles, bool flagged, int B, int Q, int S,
                      int H, int Hkv, Strides qs, Strides ks, Strides vs,
                      Strides os, float sm_scale, float sentinel,
                      void* stream, Split split = {}) {
  const int nk = tiles_of(S), smem = FwdCfg<HD, MASK, SPLIT, W>::smem(nk);
  const int group = H / Hkv;
  auto kernel = wgmma_fwd_kernel<HD, MASK, SPLIT, W, BF16S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int heads = W == 1 ? H : Hkv * ((group + W - 1) / W);
  kernel<<<dim3(tiles_of(Q), heads, B), W * THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, mt, rows,
      bias, tiles, flagged ? nk + 1 : nk, Q, S, group, qs, ks, vs, os,
      BF16S ? sm_scale : sm_scale * tile::LOG2E, sentinel, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace agrad90
