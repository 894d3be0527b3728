// One forward attention core for Hopper (sm_90a) on wgmma, beside the
// backward of attention_grad_sm90.cuh and on its pieces: omni-masked
// attention out = softmax(q.k^T * sm_scale, masked) . v with bf16
// operands and fp32 scores, online softmax and accumulation, every tensor
// read and written through its (batch, head, row) strides.  Three callers,
// two masks (template flag OMNI):
//   the forwards of kernels 8 and 7 (streaming_attention_grad.cu on
//     head-major views, packed_attention_grad.cu on the packed layout;
//     OMNI = false): self-attention, head dim 64; masked scores are -inf,
//     so a row with no visible key gets out = 0 and lse = the caller's
//     sentinel (1e30, 1e9); writes lse.  Replaces the Pallas _fwd_kernel
//     of showo_tpu/ops/streaming_attention_grad.py::_fwd and
//     packed_attention_grad.py::_fwd.
//   kernel 1 (omni_attention_packed.cu, OMNI = true) at head dims 64 and
//     128: the packed [B, S, H*D] layout, q rows by (pos_q, seg_q), Q != S;
//     masked scores are -1e30, so a row with no visible key averages v
//     over all S columns, and columns past S take no weight (as in
//     omni_attention.cuh).  Replaces the Pallas _attn_kernel_packed of
//     showo_tpu/ops/flash_attention.py::omni_attention_packed.
//
// What bounds it on an H100: 4 * D FLOP per visible (row, key) pair and
// head over O(S * D) bytes a head, so the tensor-core rate at the visible
// share: at kernel 8's 512x512 step (B=12, S=1408, H=32, D=64, 0.60 of
// the pairs visible) 0.126 ms at 989 TFLOP/s, at the v1 512x512 cached
// step (B=4, Q=1026, S=1155, D=64) 0.035 ms, at Show-o2's rows (B=8,
// S=768) 0.028 ms for Qwen's 12 q / 2 kv heads of 128 and 0.037 ms for
// the DiT's 32 / 8 of 64.  What held the first forward
// (attention_tile.cuh) back, and what this design does about it:
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
//   4. Every K tile visited and masked element by element: here the
//      block walks the visible K tiles of its row of a tile map made from
//      the O(S) metadata (agrad90::tile_map_kernel for kernels 7 and 8,
//      rows_tile_map_kernel for kernel 1's q rows), and masks only the
//      tiles the map marks partial.  Kernel 1 may skip a tile only where
//      every row of the block sees some key (a masked -1e30 score then
//      weighs exactly 0); the map flags the q tiles that hold a row with
//      no visible key, and their blocks visit and mask every tile.
// The ring depth and the resident blocks per SM (FwdCfg) were set by
// timing on an H100.  No atomics: two launches give the same bits.

#pragma once

#include "attention_grad_sm90.cuh"

namespace agrad90 {

// Dynamic shared memory of wgmma_fwd_kernel: Q (HD / 64 panels); the ring
// of STAGES (K, V) tiles; per stage the K tile's seg and pad; the visible
// tile count and list.  HD = 64: 2 stages, 41 KB, 4 blocks an SM (at most
// 128 registers); HD = 128: 2 stages, 81 KB, 2 blocks an SM.  On an H100
// 4 blocks of 2 stages ran kernel 8's forward ~6% faster than 3 blocks of
// 3; at HD = 128 one block an SM ran as fast as 2, and a third stage (one
// block) slower.
template <int HD>
struct FwdCfg {
  static constexpr int TILE = BLK * HD * 2;
  static constexpr int STAGES = 2;
  static constexpr int BLOCKS = HD == 64 ? 4 : 2;
  static constexpr int RING = TILE;
  static constexpr int META = RING + STAGES * 2 * TILE;
  static constexpr int LIST = META + STAGES * 2 * BLK * 4;
  static int smem(int nk) { return LIST + 4 * (nk + 1); }
};

// ---------------------------------------------------------------------------
// kernel 1's tile map: q rows at (pos_q, seg_q), Q != S
// ---------------------------------------------------------------------------

// [B, nq, nk + 1] bytes: entry kt < nk of (b, q tile) is 0 where no entry
// of the 64 x 64 pair is visible, 1 where some are, 3 where all are (rows
// past Q and keys past S count as not visible); entry nk is 1 where some
// row of the q tile (< Q) sees no key at all, else 0.  One block per (q
// tile, b) walks the K tiles.
__global__ void __launch_bounds__(THREADS)
rows_tile_map_kernel(Meta mt, agrad::Rows rows, int Q, int S,
                     uint8_t* __restrict__ tiles) {
  __shared__ int meta_s[2 * BLK];
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
    agrad::stage_meta(meta_s, meta_s + BLK, mt, b, kt * BLK, S);
    __syncthreads();
    const uint32_t bits = agrad::query_rows_map(pos, sq, padok, kt * BLK, S,
                                                pf, meta_s, meta_s + BLK);
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
// the forward
// ---------------------------------------------------------------------------

// Grid (ceil(Q / 64), H, B), one warpgroup a block.  tiles: the block's
// map row is tiles + (b * nq + q tile) * ld (nk entries; OMNI: the flag
// at nk).  rows.pos null: self-attention (row i at position i, seg[b, i]).
template <int HD, bool OMNI>
__global__ void __launch_bounds__(THREADS, FwdCfg<HD>::BLOCKS)
wgmma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, Meta mt, agrad::Rows rows,
                 const uint8_t* __restrict__ tiles, int ld, int Q, int S,
                 int group, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale_log2, float sentinel) {
  using C = FwdCfg<HD>;
  constexpr int P = HD / 64;  // panels of a head row
  // P.V is waited for at the end of its iteration, so the stage read last
  // is free when the next copies are issued.  (Left in flight across the
  // loop's back edge, it made ptxas serialize every wgmma of the kernel:
  // warning C7515.)
  constexpr int LOOKAHEAD = C::STAGES - 1;
  extern __shared__ __align__(1024) uint8_t ring_smem[];
  const uint32_t sb = smem_u32(ring_smem);
  int* list = reinterpret_cast<int*>(ring_smem + C::LIST) + 1;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BLK, nk = (S + BLK - 1) / BLK;
  const bf16* kh = k + b * ks.b + (h / group) * ks.h;
  const bf16* vh = v + b * vs.b + (h / group) * vs.h;

  const uint8_t* trow = tiles + ((long long)b * gridDim.x + qt) * ld;
  const int n = visible_tiles(trow, 1, nk, list, list - 1,
                              OMNI && trow[nk] != 0);
  load_tile<HD>(sb, q + b * qs.b + h * qs.h, qs.r, q0, Q);
  // tile i of the list -> stage i % STAGES: K, V, and the keys' seg / pad
  auto load_stage = [&](int i) {
    const int st = i % C::STAGES, k0 = (list[i] >> 1) * BLK;
    const uint32_t kb = sb + C::RING + st * 2 * C::TILE;
    load_tile<HD>(kb, kh, ks.r, k0, S);
    load_tile<HD>(kb + C::TILE, vh, vs.r, k0, S);
    const int j = k0 + (threadIdx.x & (BLK - 1));
    const int* src = threadIdx.x < BLK ? mt.seg : mt.pad;
    cp_async4(sb + C::META + (st * 2 * BLK + threadIdx.x) * 4,
              src + (long long)b * S + (j < S ? j : 0), j < S ? 4 : 0);
  };
#pragma unroll
  for (int i = 0; i < LOOKAHEAD; ++i) {
    if (i < n) load_stage(i);
    cp_async_commit();
  }

  // this thread's rows q0 + tile_row() (+ 8): the rows of the wgmma
  // accumulator fragments, as of mma.sync's
  int pos[2], sq[2];
  bool padok[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + tile::tile_row() + 8 * r;
    const long long bi = (long long)b * Q + i;
    pos[r] = -1;  // past Q
    sq[r] = 0;
    if (i < Q) {
      pos[r] = rows.pos ? rows.pos[bi] : i;
      sq[r] = rows.seg ? rows.seg[bi] : mt.seg[(long long)b * S + i];
    }
    padok[r] = pos[r] <= lp;
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
    const uint32_t kb = sb + C::RING + st * 2 * C::TILE, vb = kb + C::TILE;
    // S = Q.K^T, K-major from shared memory, HD / 16 steps over the panels
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * PANEL + 32 * (kk % 4);
      wgmma_ss64(&s[0][0], gmma_desc_sw128(sb + off),
                 gmma_desc_sw128(kb + off), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    // log2-domain logits; the mask only on tiles not all visible
    if (entry & FULL) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] *= scale_log2;
    } else {
      const int k0 = (entry >> 1) * BLK;
      const int* seg_s =
          reinterpret_cast<const int*>(ring_smem + C::META) + st * 2 * BLK;
      const uint32_t vis = agrad::query_rows_map(pos, sq, padok, k0, S, pf,
                                                 seg_s, seg_s + BLK);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float masked =
              OMNI && k0 + agrad::acc_col(j, c & 1) < S ? tile::MASKED
                                                        : -INFINITY;
          s[j][c] = (vis >> agrad::bit(c >> 1, j, c & 1)) & 1u
                        ? s[j][c] * scale_log2
                        : masked;
        }
    }
    tile::softmax_update<HD, tile::Exp2Ftz>(s, m, l, o);
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
  if (OMNI) {
    // l >= 1: the row's max contributes exp2(0)
    tile::store<HD>(oh, os.r, q0, Q, o, l);
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

// kernel 1's tile map, [B, ceil(Q / 64), ceil(S / 64) + 1] bytes
inline int launch_rows_tile_map(Meta mt, agrad::Rows rows, int B, int Q,
                                int S, uint8_t* tiles, void* stream) {
  rows_tile_map_kernel<<<dim3(tiles_of(Q), B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(mt, rows, Q, S,
                                                              tiles);
  return static_cast<int>(cudaGetLastError());
}

// OMNI = false: self-attention (Q == S, rows null), the tile map of
// tile_map_kernel, lse written.  OMNI = true: q rows by ``rows``, the map
// of rows_tile_map_kernel, lse null.
template <int HD, bool OMNI>
inline int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, Meta mt, agrad::Rows rows,
                      const uint8_t* tiles, int B, int Q, int S, int H,
                      int Hkv, Strides qs, Strides ks, Strides vs, Strides os,
                      float sm_scale, float sentinel, void* stream) {
  const int nk = tiles_of(S), smem = FwdCfg<HD>::smem(nk);
  auto kernel = wgmma_fwd_kernel<HD, OMNI>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles_of(Q), H, B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, mt, rows,
      tiles, OMNI ? nk + 1 : nk, Q, S, H / Hkv, qs, ks, vs, os,
      sm_scale * tile::LOG2E, sentinel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace agrad90
