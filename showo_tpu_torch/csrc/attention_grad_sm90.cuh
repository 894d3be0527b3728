// The backward of kernels 7 and 8 for Hopper (sm_90a) on wgmma: dq, and dk
// with dv, of omni-masked self-attention on any (batch, head, row) strides
// (kernel 8's head-major [B, H, S, D] views, kernel 7's packed [B, S, H*D]
// layout), and the tile map both read.  bf16 operands, fp32 scores,
// softmax and accumulation: P = exp(q.k^T * sm_scale - lse) on visible
// entries, dS = P * (dP - delta) * sm_scale, P and dS rounded to bf16 for
// the products dq = dS.K, dk = dS^T.Q, dv = P^T.dO, the GQA group summed
// in fp32.
//
// Replaces showo_tpu/ops/streaming_attention_grad.py::_bwd and
// packed_attention_grad.py::_bwd (the Pallas _dq_kernel and _dkv_kernel of
// each).  What bounds it on an H100 at the v1 512x512 step (B=12,
// S=1408, H=32, D=64, 0.60 of the pairs visible): 6*D and 8*D FLOP per
// visible pair and head over ~0.2 GB, the tensor-core rate (0.19 / 0.25
// ms at 989 TFLOP/s).
// What held the first kernels back, and what this design does about it:
//   1. No overlap of loads and products: here a ring of STAGES tiles in
//      dynamic shared memory, filled by cp.async, the next visible tile's
//      copies in flight while this one's products run.
//   2. Transposed copies (K^T, Q^T, dO^T, written by scalar stores): here
//      none.  Every operand tile is stored once, as it lies in memory
//      (head rows of 128 bytes, the 128-byte swizzle), and the products
//      that need it transposed read it through an MN-major descriptor
//      (dq = dS.K, dk = dS^T.Q, dv = P^T.dO); P and dS go from the
//      accumulators straight into wgmma's register A operand.
//   3. mma.sync with every B fragment re-read per warp: here wgmma
//      m64n64k16, one warpgroup per block, B (and A of the score
//      products) read by the tensor cores from shared memory.
// The mask costs ALU work per pair, so the tile map (tile_map_kernel, one
// byte per (q tile, k tile) pair, from the O(S) metadata, once for all
// heads and both kernels) says which tiles have no visible entry (never
// fetched), which are all visible (no mask), and which need the
// per-element map of attention_grad.cuh (query_rows_map).
//
//   dq_kernel:  one block per (b, h, 64-row q tile): Q and dO resident,
//               the visible K / V tiles streamed;
//   dkv_kernel: one block per (b, kv head, 64-key tile): K and V
//               resident, Q, dO, lse, delta of each visible q tile and
//               each head of the GQA group streamed, dk / dv summed in
//               fp32 registers.
// Two kernels, no atomics: the result does not depend on scheduling.
// Head dim: the kernels take it as the template parameter HD, built for
// 64 (a head row is one 128-byte swizzle row).  The tile loader stores a
// wider head row as 128-byte panels; the forward core on these pieces,
// attention_fwd_sm90.cuh, runs head dims 64 and 128.

#pragma once

#include "attention_grad.cuh"
#include "sm90_async.cuh"

namespace agrad90 {

using namespace sm90;
using agrad::Meta;
using tile::bf16;
using tile::Strides;

constexpr int BLK = 64;        // rows of a q or k tile: wgmma's M
constexpr int THREADS = 128;   // one warpgroup
constexpr int FULL = 1;        // list entry bit: every entry visible

// D (64 x 64 fp32) = A (64 x 16) * B (16 x 64) (+ D where `accumulate`),
// both operands from shared memory through descriptors, K-major
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64 fp32) += A (64 x 16, a warp's m16k16 fragment in registers)
// * B (16 x 64) from shared memory through a descriptor, MN-major
// (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs64_tb(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from moving reads or writes of a 64 x 64 accumulator
// across a wgmma issue or wait
__device__ __forceinline__ void fence_acc(float a[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_reg(a[n][c]);
}

// The accumulators of a 64 x 64 product (this warp's 16 rows) as the A
// fragments of the four k16 steps of a product over its 64 columns.
__device__ __forceinline__ void to_a(const float s[8][4], uint32_t a[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = tile::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = tile::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = tile::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = tile::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// Rows [r0, r0 + 64) of one head (row stride ld, elements) -> a 64 x HD
// tile at dst in the 128-byte swizzle, zeros past S: HD / 64 panels of
// 64 rows x 128 bytes, PANEL bytes apart (head dims [64p, 64p + 64) in
// panel p), 16-byte chunk c of a panel row r at c ^ (r & 7); HD / 8
// neighbouring threads copy one head row.  The copy is shared by NT
// threads, this one being thread ``tid`` of them.
constexpr int PANEL = BLK * 128;

template <int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int S,
                                          int tid) {
  static_assert(HD % 64 == 0, "head dim: whole 128-byte swizzle panels");
  constexpr int CH = HD / 8, CHUNKS = BLK * CH;
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int q = tid + i * NT, row = q / CH, c = q % CH;
    if (CHUNKS % NT != 0 && q >= CHUNKS) break;
    const bool in = r0 + row < S;
    cp_async16(dst + (c / 8) * PANEL + row * 128 + (((c % 8) ^ (row & 7)) * 16),
               in ? src + (long long)(r0 + row) * ld + 8 * c : src,
               in ? 16 : 0);
  }
}

// the copy shared by the block's one warpgroup
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int S) {
  load_tile<HD, THREADS>(dst, src, ld, r0, S, threadIdx.x);
}

// The visible tiles of one row (or column) of the tile map, count entries
// `stride` bytes apart, in order: list[i] = (tile << 1) | FULL where every
// entry is visible.  With `every` the tiles without a visible entry are
// listed too (to be masked).  Warp 0 compacts them; returns their number.
__device__ __forceinline__ int visible_tiles(const uint8_t* cls,
                                             long long stride, int count,
                                             int* list, int* n_s,
                                             bool every = false) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < count; base += 32) {
      const int t = base + lane;
      const int c = t < count ? cls[t * stride] | (every ? 1 : 0) : 0;
      const uint32_t m = __ballot_sync(0xffffffffu, c != 0);
      if (c) list[n + __popc(m & ((1u << lane) - 1u))] = (t << 1) | (c >> 1);
      n += __popc(m);
    }
    if (lane == 0) *n_s = n;
  }
  __syncthreads();
  return *n_s;
}

// ---------------------------------------------------------------------------
// the tile map: [B, nt, nt] bytes, (q tile, k tile) -> 0 no visible entry,
// 1 some, 3 all 64 x 64 (rows and keys past S count as not visible)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
tile_map_kernel(Meta mt, int S, uint8_t* __restrict__ tiles) {
  __shared__ int meta_s[2 * BLK];
  const int qt = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;
  const int nt = gridDim.x;
  agrad::stage_meta(meta_s, meta_s + BLK, mt, b, kt * BLK, S);
  __syncthreads();
  int pos[2], sq[2];
  bool padok[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qt * BLK + tile::tile_row() + 8 * r;
    pos[r] = i < S ? i : -1;
    sq[r] = i < S ? mt.seg[(long long)b * S + i] : 0;
    padok[r] = i <= lp;
  }
  const uint32_t bits = agrad::query_rows_map(pos, sq, padok, kt * BLK, S,
                                              pf, meta_s, meta_s + BLK);
  const bool any = __syncthreads_or(bits != 0u);
  const bool all = __syncthreads_and(bits == 0xffffffffu);
  if (threadIdx.x == 0)
    tiles[((long long)b * nt + qt) * nt + kt] = any ? (all ? 3 : 1) : 0;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// Dynamic shared memory of dq_kernel: Q, dO; the ring of STAGES (K, V)
// tiles; per stage the K tile's seg and pad; the visible-tile count and
// list.  66 KB at 3 stages, so 3 blocks an SM (up to 168 registers a
// thread): more resident blocks hid more of each tile's latency on an
// H100 than a deeper ring with fewer blocks.
template <int HD>
struct DqCfg {
  static constexpr int TILE = BLK * HD * 2;
  static constexpr int STAGES = 3, BLOCKS = 3;
  static constexpr int RING = 2 * TILE;
  static constexpr int META = RING + STAGES * 2 * TILE;
  static constexpr int LIST = META + STAGES * 2 * BLK * 4;
  static int smem(int nt) { return LIST + 4 * (nt + 1); }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, DqCfg<HD>::BLOCKS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Meta mt, const uint8_t* __restrict__ tiles,
          int S, int group, Strides qs, Strides ks, Strides vs, Strides ds,
          Strides dqs, float sm_scale) {
  static_assert(HD == 64, "head dim 64: one 128-byte swizzle row a head row");
  using C = DqCfg<HD>;
  // dq's product is waited for at the end of its iteration, so the stage
  // read last is free when the next copies are issued: the ring runs
  // STAGES - 1 tiles ahead.  (Left in flight across the loop's back edge,
  // it made ptxas serialize every wgmma of the kernel: warning C7515.)
  constexpr int LOOKAHEAD = C::STAGES - 1;
  extern __shared__ __align__(1024) uint8_t ring_smem[];
  const uint32_t sb = smem_u32(ring_smem);
  int* list = reinterpret_cast<int*>(ring_smem + C::LIST) + 1;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BLK, nt = gridDim.x;
  const bf16* kh = k + b * ks.b + (h / group) * ks.h;
  const bf16* vh = v + b * vs.b + (h / group) * vs.h;
  const float scale_log2 = sm_scale * tile::LOG2E;

  const int n = visible_tiles(tiles + ((long long)b * nt + qt) * nt, 1, nt,
                              list, list - 1);
  load_tile<HD>(sb, q + b * qs.b + h * qs.h, qs.r, q0, S);
  load_tile<HD>(sb + C::TILE, dout + b * ds.b + h * ds.h, ds.r, q0, S);
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

  // this thread's rows q0 + tile_row() (+ 8)
  int qi[2], sq[2];
  bool padok[2];
  float lse2[2], dl[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + tile::tile_row() + 8 * r;
    const bool in = i < S;
    const long long hr = ((long long)b * gridDim.y + h) * S + i;
    qi[r] = in ? i : -1;
    sq[r] = in ? mt.seg[(long long)b * S + i] : 0;
    padok[r] = i <= lp;
    lse2[r] = in ? lse[hr] * tile::LOG2E : 0.f;
    dl[r] = in ? delta[hr] : 0.f;
  }

  float acc[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = s[j][c] = dp[j][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<LOOKAHEAD - 1>();
    fence_proxy_async();
    // tile i has landed for every thread, and tile i - 1's stage, which
    // is refilled below, is read by no product in flight
    __syncthreads();
    if (i + LOOKAHEAD < n) load_stage(i + LOOKAHEAD);
    cp_async_commit();
    const int st = i % C::STAGES, entry = list[i];
    const uint32_t kb = sb + C::RING + st * 2 * C::TILE, vb = kb + C::TILE;
    // S = Q.K^T, dP = dO.V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64(&s[0][0], gmma_desc_sw128(sb + 32 * kk),
                 gmma_desc_sw128(kb + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64(&dp[0][0], gmma_desc_sw128(sb + C::TILE + 32 * kk),
                 gmma_desc_sw128(vb + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    uint32_t vis = 0xffffffffu;
    if (!(entry & FULL)) {
      const int* seg_s = reinterpret_cast<const int*>(ring_smem + C::META) +
                         st * 2 * BLK;
      vis = agrad::query_rows_map(qi, sq, padok, (entry >> 1) * BLK, S, pf,
                                  seg_s, seg_s + BLK);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = (vis >> agrad::bit(r, j, c & 1)) & 1u
                            ? exp2f(s[j][c] * scale_log2 - lse2[r])
                            : 0.f;
        s[j][c] = p * (dp[j][c] - dl[r]) * sm_scale;  // dS
      }
    uint32_t a[4][4];
    to_a(s, a);
    // dq += dS.K: K read as the MN-major B operand, 16 keys a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64_tb(&acc[0][0], a[kk], gmma_desc_sw128_mn(kb + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  tile::store_scaled<HD>(dq + b * dqs.b + h * dqs.h, dqs.r, q0, S, acc, one);
}

// ---------------------------------------------------------------------------
// dk, dv (per kv head, the GQA group summed)
// ---------------------------------------------------------------------------

// Dynamic shared memory of dkv_kernel: K, V; the ring of STAGES (Q, dO)
// tiles; per stage the q tile's lse, delta and seg (64 words each); the
// visible-tile count and list.  3 blocks an SM, as dq_kernel (its four
// 64 x 64 accumulators fit in 168 registers).
template <int HD>
struct DkvCfg {
  static constexpr int TILE = BLK * HD * 2;
  static constexpr int STAGES = 3, BLOCKS = 3;
  static constexpr int RING = 2 * TILE;
  static constexpr int ROWS = RING + STAGES * 2 * TILE;
  static constexpr int LIST = ROWS + STAGES * 3 * BLK * 4;
  static int smem(int nt) { return LIST + 4 * (nt + 1); }
};

// Visibility map of a dk/dv tile: accumulator rows are keys kj[r] (seg
// sk[r], pad pk[r]), columns the query rows i0 + c (their seg staged in
// segq_s); bit(r, n, e) as in attention_grad.cuh.
__device__ __forceinline__ uint32_t key_rows_map(const int kj[2],
                                                 const int sk[2],
                                                 const bool pk[2], int i0,
                                                 int S, int pf, int lp,
                                                 const int* segq_s) {
  uint32_t vis = 0;
#pragma unroll
  for (int n = 0; n < tile::NK; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = agrad::acc_col(n, e), i = i0 + c;
      if (i >= S) continue;
      const int si = segq_s[c];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool vv = kj[r] < S &&
                        ((kj[r] <= i) || (si > 0 && si == sk[r]) ||
                         (kj[r] < pf)) &&
                        (!pk[r] || i <= lp);
        vis |= (uint32_t)vv << agrad::bit(r, n, e);
      }
    }
  return vis;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, DkvCfg<HD>::BLOCKS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, Meta mt,
           const uint8_t* __restrict__ tiles, int S, int group, Strides qs,
           Strides ks, Strides vs, Strides ds, Strides dks, Strides dvs,
           float sm_scale) {
  static_assert(HD == 64, "head dim 64: one 128-byte swizzle row a head row");
  using C = DkvCfg<HD>;
  // dk's and dv's products are waited for at the end of their step, as
  // dq_kernel's
  constexpr int LOOKAHEAD = C::STAGES - 1;
  extern __shared__ __align__(1024) uint8_t ring_smem[];
  const uint32_t sb = smem_u32(ring_smem);
  int* list = reinterpret_cast<int*>(ring_smem + C::LIST) + 1;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BLK, nt = gridDim.x;
  const int H = gridDim.y * group;
  const float scale_log2 = sm_scale * tile::LOG2E;

  // the visible q tiles of this key tile: a column of the tile map
  const int n = visible_tiles(tiles + (long long)b * nt * nt + kt, nt, nt,
                              list, list - 1);
  const int steps = n * group;
  load_tile<HD>(sb, k + b * ks.b + kvh * ks.h, ks.r, k0, S);
  load_tile<HD>(sb + C::TILE, v + b * vs.b + kvh * vs.h, vs.r, k0, S);
  // step s (q tile list[s / group], head kvh * group + s % group) ->
  // stage s % STAGES: Q, dO, and the rows' lse, delta and seg
  auto load_stage = [&](int s) {
    const int st = s % C::STAGES, i0 = (list[s / group] >> 1) * BLK;
    const int h = kvh * group + s % group;
    const uint32_t qb = sb + C::RING + st * 2 * C::TILE;
    load_tile<HD>(qb, q + b * qs.b + h * qs.h, qs.r, i0, S);
    load_tile<HD>(qb + C::TILE, dout + b * ds.b + h * ds.h, ds.r, i0, S);
    const uint32_t rb = sb + C::ROWS + st * 3 * BLK * 4;
    const int t = threadIdx.x & (BLK - 1), i = i0 + t;
    const int bytes = i < S ? 4 : 0;
    const long long hr = ((long long)b * H + h) * S + (i < S ? i : 0);
    cp_async4(rb + threadIdx.x * 4,
              threadIdx.x < BLK ? lse + hr : delta + hr, bytes);
    if (threadIdx.x < BLK)
      cp_async4(rb + (2 * BLK + t) * 4,
                mt.seg + (long long)b * S + (i < S ? i : 0), bytes);
  };
#pragma unroll
  for (int s = 0; s < LOOKAHEAD; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }

  // this thread's key rows and their metadata
  int kj[2], sk[2];
  bool pk[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = k0 + tile::tile_row() + 8 * r;
    const bool in = kj[r] < S;
    sk[r] = in ? mt.seg[(long long)b * S + kj[r]] : 0;
    pk[r] = in && mt.pad[(long long)b * S + kj[r]] != 0;
  }

  float dka[8][4], dva[8][4], p[8][4], dsr[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dka[j][c] = dva[j][c] = p[j][c] = dsr[j][c] = 0.f;

  uint32_t vis = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<LOOKAHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (s + LOOKAHEAD < steps) load_stage(s + LOOKAHEAD);
    cp_async_commit();
    const int st = s % C::STAGES, entry = list[s / group];
    const uint32_t qb = sb + C::RING + st * 2 * C::TILE, db = qb + C::TILE;
    const float* rows =
        reinterpret_cast<const float*>(ring_smem + C::ROWS) + st * 3 * BLK;
    // S^T = K.Q^T (keys x query rows), dP^T = V.dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64(&p[0][0], gmma_desc_sw128(sb + 32 * kk),
                 gmma_desc_sw128(qb + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64(&dsr[0][0], gmma_desc_sw128(sb + C::TILE + 32 * kk),
                 gmma_desc_sw128(db + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(p);
    fence_acc(dsr);
    // the q tile's map, once for the heads of the group
    if (s % group == 0)
      vis = entry & FULL
                ? 0xffffffffu
                : key_rows_map(kj, sk, pk, (entry >> 1) * BLK, S, pf, lp,
                               reinterpret_cast<const int*>(rows + 2 * BLK));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = agrad::acc_col(j, c & 1);
        p[j][c] = (vis >> agrad::bit(c >> 1, j, c & 1)) & 1u
                      ? exp2f(p[j][c] * scale_log2 - rows[col] * tile::LOG2E)
                      : 0.f;
        dsr[j][c] = p[j][c] * (dsr[j][c] - rows[BLK + col]) * sm_scale;
      }
    uint32_t ap[4][4], ads[4][4];
    to_a(p, ap);
    to_a(dsr, ads);
    // dv += P^T.dO, dk += dS^T.Q: dO and Q read as MN-major B operands,
    // 16 query rows a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64_tb(&dva[0][0], ap[kk], gmma_desc_sw128_mn(db + 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64_tb(&dka[0][0], ads[kk], gmma_desc_sw128_mn(qb + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dka);
    fence_acc(dva);
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  tile::store_scaled<HD>(dk + b * dks.b + kvh * dks.h, dks.r, k0, S, dka,
                         one);
  tile::store_scaled<HD>(dv + b * dvs.b + kvh * dvs.h, dvs.r, k0, S, dva,
                         one);
}

// ---------------------------------------------------------------------------
// launches on ``stream``; each returns the cudaError_t of its launch
// ---------------------------------------------------------------------------

inline int tiles_of(int S) { return (S + BLK - 1) / BLK; }

inline int launch_tile_map(Meta mt, int B, int S, uint8_t* tiles,
                           void* stream) {
  const int nt = tiles_of(S);
  tile_map_kernel<<<dim3(nt, nt, B), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(mt, S, tiles);
  return static_cast<int>(cudaGetLastError());
}

// the dynamic shared memory above 48 KB and all of L1 as shared memory
template <typename F>
inline cudaError_t allow_smem(F kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int HD>
inline int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, Meta mt, const uint8_t* tiles, int B, int S,
                     int H, int Hkv, Strides qs, Strides ks, Strides vs,
                     Strides ds, Strides dqs, float sm_scale, void* stream) {
  const int nt = tiles_of(S), smem = DqCfg<HD>::smem(nt);
  auto kernel = dq_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nt, H, B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), mt, tiles, S, H / Hkv, qs, ks, vs, ds, dqs,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
inline int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, Meta mt, const uint8_t* tiles, int B,
                      int S, int H, int Hkv, Strides qs, Strides ks,
                      Strides vs, Strides ds, Strides dks, Strides dvs,
                      float sm_scale, void* stream) {
  const int nt = tiles_of(S), smem = DkvCfg<HD>::smem(nt);
  auto kernel = dkv_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nt, Hkv, B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), mt, tiles, S, H / Hkv,
      qs, ks, vs, ds, dks, dvs, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace agrad90
