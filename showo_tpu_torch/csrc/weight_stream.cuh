// Weight-streaming matmuls for Hopper (sm_90a): bf16 activations times
// int8 or packed int4 weights, dequantized in registers, fp32 accumulation,
// one fp32 scale per output column applied after the sum.
//
//   out[m, n] = bf16(bf16(sum_k x[m, k] * w[k, n] * scale[n]) + bias[n])
//
// (the bias, where one is given, is added to the bf16 product in fp32 and
// rounded again: what `y + bias` does on two bf16 tensors).  Two weight
// formats share the code, as rows of bytes [rows, N] with row stride ldw:
//
//   * int8 (NIB = false): rows = K, byte (k, n) is w[k, n];
//   * int4 split-halves (NIB = true): rows = K/2, byte (r, n) holds w[r, n]
//     in its low nibble and w[K/2 + r, n] in its high nibble, both
//     sign-extended; x column r pairs with the low nibble, K/2 + r with the
//     high one.
//
// Every weight is exact in bf16 (|w| <= 127), so bf16 products of x and w
// summed in fp32 are the TPU kernels' arithmetic; only the order of the
// sum differs.
//
// What bounds them on an H100: at decode (M = 1..4) every weight byte is
// read once for 2M operations, far below the ~295 operations per byte
// where the tensor cores become the limit, so the time is the weight bytes
// over 3.35 TB/s (win [2048 x 14336] 0.0088 ms, wout [10240 x 2048]
// 0.0063 ms, lm_head [2048 x 58498] 0.0358 ms).  Two kernels:
//
//   * gemv_kernel (M <= GEMV_MAX_M, decode): one launch per product.
//     Replaces a first pair of launches (split-K partial sums written to
//     device memory by one kernel and added by a second; ~900 short
//     blocks of one 32 KB pass each, x read from device memory for every
//     weight row, the bytes widened by int -> float conversions, about
//     half of the bytes bound on an H100).  Here a block owns a column
//     tile of 16 * cw bytes (cw 8, 16 or 32 chunks, ops/int8_matmul.py::
//     gemv_plan: ~2 blocks an SM) over one contiguous range of K rows, and
//     streams it through a ring of GV_STAGES stages of 16 KB in shared
//     memory filled by 16-byte cp.async (the ragged N edge zero-filled
//     through the source-size operand), GV_STAGES - 1 stages in flight;
//     its rows of x are staged in shared memory once, as fp32.  Each
//     thread takes one 16-byte chunk of 4 rows a stage and widens the
//     bytes exactly with integer ops (the byte in the low mantissa bits
//     of 2^23, then one subtraction).  The block adds its row groups in a
//     fixed order; where K is split, each block writes fp32 partial sums
//     and the last block of a column tile to arrive (a ticket per tile,
//     which that block resets) adds the splits in split order and applies
//     the epilogue.  No atomics touch a sum, so two launches give the same
//     bits.  Rows that are not 16-byte aligned are copied into the same
//     ring by plain loads.
//   * mma_kernel (M > GEMV_MAX_M, rows the prefill kernel of
//     weight_stream_prefill.cuh does not take): 64 x 128 output tiles,
//     8 warps of 32 x 32, mma.sync m16n8k16 over 32-row K tiles; the int8
//     tile is widened to bf16 while it is stored, transposed, in shared
//     memory, so each B fragment is one 32-bit load.  No cp.async or TMA
//     pipelining: load, barrier, multiply, barrier.
//
// Ragged M, K and N are masked in the kernels (N = 58498 for the Show-o
// vocabulary); 16-byte (x) and 8- or 16-byte (w) vector loads are taken
// only where the wrapper found the pointers and strides aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace wsmm {

using bf16 = __nv_bfloat16;

constexpr int GEMV_MAX_M = 4;
constexpr int GV_THREADS = 256;
constexpr int GV_STAGE = 16384;   // weight bytes of a ring stage
constexpr int GV_STAGES = 4;
constexpr int GV_CHUNKS = GV_STAGE / 16 / GV_THREADS;  // a thread's, a stage
constexpr int GV_MAX_ROWS = 1024;  // weight rows of one split (x in smem)
constexpr int GV_FINISH_LOADS = 16;  // partial sums in flight a column
static_assert(16 * 32 <= 2 * GV_THREADS, "a column tile: 2 columns a thread");
constexpr int GV_SMEM_MAX = GV_STAGES * GV_STAGE + GV_MAX_ROWS * 4 * 4 * 2;
constexpr int FINISH_THREADS = 256;

constexpr int MM_BM = 64, MM_BN = 128, MM_BK = 32;
constexpr int MM_THREADS = 256;
constexpr int MM_LD = MM_BK + 8;  // padded smem row (bf16): 80 bytes

// sign-extended nibbles of a sign-extended byte
__device__ __forceinline__ int nib_lo(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// fp32 sum -> bf16(sum * scale), then + bias in fp32, rounded again
__device__ __forceinline__ bf16 epilogue(float acc, const bf16* scale,
                                         const bf16* bias, int n) {
  bf16 y = __float2bfloat16(acc * bf2f(scale[n]));
  if (bias != nullptr) y = __float2bfloat16(bf2f(y) + bf2f(bias[n]));
  return y;
}

// 16 bytes of one weight row from column n0 on, zero past N: one 16-byte
// load where the row is aligned and whole, else byte loads packed into the
// same registers
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_row16(const int8_t* row, int n0,
                                            int N) {
  if (ALIGNED && n0 + 16 <= N)
    return __ldg(reinterpret_cast<const uint4*>(row + n0));
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n0 + j < N)
      word[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[n0 + j]))
                     << (8 * (j % 4));
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// The 4 bytes of ``u`` (each an unsigned value below 256 that is ``bias``
// above the weight) -> 4 floats, exact: 0x4B0000uu is the float 2^23 + u.
// Byte e of the word is column e.
__device__ __forceinline__ void widen4(uint32_t u, float bias, float f[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) -
           (8388608.f + bias);
}

// x [MT] of one row from shared memory (one 4-, 8- or 16-byte load)
template <int MT>
__device__ __forceinline__ void load_x(const float* p, float x[MT]) {
  if constexpr (MT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (MT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// One decode product, M <= MT rows: grid (column tiles of 16 * cw bytes,
// K splits of rows_per_split weight rows), GV_THREADS threads, dynamic
// shared memory GV_STAGES * GV_STAGE + rows_per_split * MT * 4 (twice the
// x part for NIB).  part [splits, M, N] fp32 and tickets [column tiles]
// (zero before the launch, zero after it) where K is split.
template <bool NIB, bool ALIGNED, int MT>
__global__ void __launch_bounds__(GV_THREADS, 2)
gemv_kernel(const bf16* __restrict__ x, long long ldx,
            const int8_t* __restrict__ w, long long ldw,
            const bf16* __restrict__ scale, const bf16* __restrict__ bias,
            bf16* __restrict__ out, long long ldo, float* __restrict__ part,
            int* __restrict__ tickets, int M, int rows, int N, int k_half,
            int cw, int rows_per_split) {
  using namespace sm90;
  extern __shared__ __align__(16) uint8_t gv_smem[];
  __shared__ int last_s;
  const int tid = threadIdx.x;
  // the column tile's ct bytes a row; stages of rs rows; this thread's
  // 16-byte chunk c of rows rg + ng * j of every stage
  const int ct = 16 * cw, rs = GV_STAGE / ct, ng = GV_THREADS / cw;
  const int c = tid % cw, rg = tid / cw;
  const int n0 = blockIdx.x * ct, r0 = blockIdx.y * rows_per_split;
  const int nrows = min(rows - r0, rows_per_split);
  const int nst = (nrows + rs - 1) / rs;
  float* xs = reinterpret_cast<float*>(gv_smem + GV_STAGES * GV_STAGE);
  const uint32_t ring = smem_u32(gv_smem);

  // stage s (rows [s * rs, s * rs + rs) of the range) -> slot s % GV_STAGES,
  // row r's chunk c at r * ct + 16 c
  auto load_stage = [&](int s) {
    const int slot = (s % GV_STAGES) * GV_STAGE;
#pragma unroll
    for (int i = 0; i < GV_CHUNKS; ++i) {
      const int q = tid + i * GV_THREADS, r = s * rs + q / cw;
      const int n = n0 + 16 * (q % cw);
      const bool in = r < nrows && n < N;
      const int8_t* src = w + (long long)(r0 + r) * ldw;
      if constexpr (ALIGNED) {
        cp_async16(ring + slot + q * 16, in ? src + n : w,
                   in ? min(16, N - n) : 0);
      } else {
        *reinterpret_cast<uint4*>(gv_smem + slot + q * 16) =
            in ? load_row16<false>(src, n, N) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < GV_STAGES - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  // the range's x as fp32 [row][MT] (NIB: the high half's columns after),
  // rows m >= M zero
  for (int i = tid; i < nrows * MT; i += GV_THREADS) {
    const int r = i / MT, m = i % MT;
    const bf16* xm = x + m * ldx + r0 + r;
    xs[i] = m < M ? bf2f(xm[0]) : 0.f;
    if (NIB) xs[rows_per_split * MT + i] = m < M ? bf2f(xm[k_half]) : 0.f;
  }

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<GV_STAGES - 2>();
    // stage s has landed for every thread (and x is staged), and no thread
    // still reads the slot refilled below
    __syncthreads();
    if (s + GV_STAGES - 1 < nst) load_stage(s + GV_STAGES - 1);
    cp_async_commit();
    const uint8_t* st = gv_smem + (s % GV_STAGES) * GV_STAGE;
#pragma unroll
    for (int j = 0; j < GV_CHUNKS; ++j) {
      const int row = rg + ng * j, r = s * rs + row;
      if (r >= nrows) continue;
      const uint4 wv = *reinterpret_cast<const uint4*>(st + row * ct + 16 * c);
      const uint32_t wd[4] = {wv.x, wv.y, wv.z, wv.w};
      float xa[MT], xb[MT];
      load_x<MT>(xs + r * MT, xa);
      if (NIB) load_x<MT>(xs + (rows_per_split + r) * MT, xb);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[4];
        if (NIB) {
          // low nibbles (+ 8) against x's first half, high ones its second
          widen4((wd[q] & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * q + e] = fmaf(xa[m], f[e], acc[m][4 * q + e]);
          widen4(((wd[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * q + e] = fmaf(xb[m], f[e], acc[m][4 * q + e]);
        } else {
          widen4(wd[q] ^ 0x80808080u, 128.f, f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * q + e] = fmaf(xa[m], f[e], acc[m][4 * q + e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the sums below

  // the row groups' sums, one row m at a time, in the ring's memory:
  // red[rg][20 c + j] holds this thread's column 16 c + j (4 floats of
  // padding a chunk keep a quarter warp's 16-byte stores on distinct
  // banks), added in row-group order
  float* red = reinterpret_cast<float*>(gv_smem);
  const int ld = 20 * cw;
  const bool split = gridDim.y > 1;
  float* dst = part + (long long)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(red + rg * ld + 20 * c + 4 * q) =
          make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2],
                      acc[m][4 * q + 3]);
    __syncthreads();
    for (int i = tid; i < ct; i += GV_THREADS) {
      const int col = n0 + i;
      float sum = 0.f;
      for (int g = 0; g < ng; ++g) sum += red[g * ld + 20 * (i >> 4) + (i & 15)];
      if (col < N) {
        if (split) dst[(long long)m * N + col] = sum;
        else out[m * ldo + col] = epilogue(sum, scale, bias, col);
      }
    }
    __syncthreads();
  }
  if (!split) return;

  // the last block of the column tile adds the splits in order, each
  // thread its columns tid and tid + GV_THREADS (a tile has at most 512),
  // up to GV_FINISH_LOADS splits of both loaded before any is added: one
  // round trip to L2 where a dependent chain of loads took one a split
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int splits = gridDim.y;
  const long long step = (long long)M * N;
  for (int m = 0; m < M; ++m) {
    float sum[2] = {0.f, 0.f};
    for (int sp0 = 0; sp0 < splits; sp0 += GV_FINISH_LOADS) {
      float v[2][GV_FINISH_LOADS];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < GV_FINISH_LOADS; ++j) {
          const int i = tid + h * GV_THREADS, sp = sp0 + j;
          v[h][j] = i < ct && n0 + i < N && sp < splits
                        ? __ldcg(part + sp * step + (long long)m * N + n0 + i)
                        : 0.f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < GV_FINISH_LOADS; ++j)
          if (sp0 + j < splits) sum[h] += v[h][j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = tid + h * GV_THREADS;
      if (i < ct && n0 + i < N)
        out[m * ldo + n0 + i] = epilogue(sum[h], scale, bias, n0 + i);
    }
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

// The prefill kernel's split-K partial sums [splits, M, N], added in split
// order, through the epilogue
__global__ void __launch_bounds__(FINISH_THREADS)
finish_splits(const float* __restrict__ part, int splits, int M, int N,
              const bf16* __restrict__ scale, const bf16* __restrict__ bias,
              bf16* __restrict__ out, long long ldo) {
  const long long i =
      static_cast<long long>(blockIdx.x) * FINISH_THREADS + threadIdx.x;
  if (i >= static_cast<long long>(M) * N) return;
  const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s += part[(static_cast<long long>(sp) * M + m) * N + n];
  out[m * ldo + n] = epilogue(s, scale, bias, n);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two small integers -> one register of two bf16 (exact), lo in the low half
__device__ __forceinline__ uint32_t pack_int_bf16(int lo, int hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 bytes of one weight row from column n0 on, zero past N or past the rows
__device__ __forceinline__ void load_row8(const int8_t* w, long long ldw,
                                          int r, int rows, int n0, int N,
                                          bool aligned, int out[8]) {
  if (r < rows && aligned && n0 + 8 <= N) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(w + r * ldw + n0));
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = b[j];
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = (r < rows && n0 + j < N) ? w[r * ldw + n0 + j] : 0;
  }
}

// One 64 x 128 output tile (blockIdx.x: M tile, so the M tiles of one N
// tile run together and share its weights in L2; blockIdx.y: N tile).
template <bool NIB>
__global__ void __launch_bounds__(MM_THREADS)
mma_kernel(const bf16* __restrict__ x, long long ldx,
           const int8_t* __restrict__ w, long long ldw,
           const bf16* __restrict__ scale, const bf16* __restrict__ bias,
           bf16* __restrict__ out, long long ldo, int M, int rows, int N,
           int k_half, int x_aligned, int w_aligned) {
  constexpr int NSUB = NIB ? 2 : 1;  // K sub-tiles per tile of weight rows
  __shared__ __align__(16) bf16 Xs[NSUB][MM_BM][MM_LD];
  __shared__ __align__(16) bf16 Wt[NSUB][MM_BN][MM_LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int m_tile = blockIdx.x * MM_BM, n_tile = blockIdx.y * MM_BN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // this thread's share of the tile loads
  const int xr = tid >> 2, xc = (tid & 3) * 8;        // x: row, 8 columns
  const int wp = tid >> 4, wc = (tid & 15) * 8;       // w: row pair, 8 cols
  const bool x_row = m_tile + xr < M;
  const bf16* x_src = x + static_cast<long long>(m_tile + xr) * ldx;

  for (int r0 = 0; r0 < rows; r0 += MM_BK) {
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
      // x columns of this sub-tile: r0.. (int8, low nibbles), k_half + r0..
      // (high nibbles); storage rows past `rows` have no x column
      const int col = (s == 0 ? 0 : k_half) + r0 + xc;
      bf16* xs = &Xs[s][xr][xc];
      if (x_row && x_aligned && r0 + xc + 8 <= rows) {
        *reinterpret_cast<uint4*>(xs) =
            __ldg(reinterpret_cast<const uint4*>(x_src + col));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xs[e] = (x_row && r0 + xc + e < rows) ? x_src[col + e]
                                                : __float2bfloat16(0.f);
      }
    }
    int b0[8], b1[8];
    load_row8(w, ldw, r0 + 2 * wp, rows, n_tile + wc, N, w_aligned, b0);
    load_row8(w, ldw, r0 + 2 * wp + 1, rows, n_tile + wc, N, w_aligned, b1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (NIB) {
        *reinterpret_cast<uint32_t*>(&Wt[0][wc + e][2 * wp]) =
            pack_int_bf16(nib_lo(b0[e]), nib_lo(b1[e]));
        *reinterpret_cast<uint32_t*>(&Wt[NSUB - 1][wc + e][2 * wp]) =
            pack_int_bf16(nib_hi(b0[e]), nib_hi(b1[e]));
      } else {
        *reinterpret_cast<uint32_t*>(&Wt[0][wc + e][2 * wp]) =
            pack_int_bf16(b0[e], b1[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
#pragma unroll
      for (int kk = 0; kk < MM_BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bf16* xa = &Xs[s][wm + i * 16 + g][kk + 2 * t];
          a[i][0] = lds32(xa);
          a[i][1] = lds32(xa + 8 * MM_LD);
          a[i][2] = lds32(xa + 8);
          a[i][3] = lds32(xa + 8 * MM_LD + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* wb = &Wt[s][wn + j * 8 + g][kk + 2 * t];
          const uint32_t f0 = lds32(wb), f1 = lds32(wb + 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_16816(acc[i][j], a[i], f0, f1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m_tile + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n_tile + wn + j * 8 + 2 * t + e;
          if (col < N)
            out[row * ldo + col] = epilogue(acc[i][j][2 * h + e], scale, bias,
                                            col);
        }
      }
    }
  }
}

// gemv_kernel's dynamic shared memory limit, set once per device for each
// instantiation (the attribute is the function's, on the current device),
// with all of L1 as shared memory so that two blocks fit on an SM
template <bool NIB, bool ALIGNED, int MT>
inline cudaError_t gemv_allow_smem() {
  static unsigned done = 0u;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && ((done >> dev) & 1u))) return err;
  auto kernel = gemv_kernel<NIB, ALIGNED, MT>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GV_SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// Launches gemv_kernel on `stream` (M <= GEMV_MAX_M) on the plan of
// ops/int8_matmul.py::gemv_plan: column tiles of 16 * cw bytes, K in
// `splits` ranges of rows_per_split rows, each non-empty; part [splits, M,
// N] fp32 and tickets [column tiles] int32 (zeros) where splits > 1.
// Returns the cudaError_t.
template <bool NIB>
int launch_gemv(const bf16* x, long long ldx, const int8_t* w, long long ldw,
                const bf16* scale, const bf16* bias, bf16* out, long long ldo,
                float* part, int* tickets, int M, int rows, int N,
                int k_half, int cw, int splits, int rows_per_split,
                bool w_aligned16, cudaStream_t stream) {
  if (M <= 0 || M > GEMV_MAX_M || N <= 0 || rows <= 0 ||
      (cw != 8 && cw != 16 && cw != 32) || rows_per_split <= 0 ||
      rows_per_split > GV_MAX_ROWS || splits <= 0 ||
      static_cast<long long>(splits) * rows_per_split < rows ||
      static_cast<long long>(splits - 1) * rows_per_split >= rows ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M == 1 ? 1 : M == 2 ? 2 : 4;
  const int smem =
      GV_STAGES * GV_STAGE + rows_per_split * mt * 4 * (NIB ? 2 : 1);
  const dim3 grid((N + 16 * cw - 1) / (16 * cw), splits);
  cudaError_t err = cudaSuccess;
#define WSMM_GEMV(MT_, AL_)                                                 \
  if (mt == MT_ && w_aligned16 == AL_) {                                    \
    err = gemv_allow_smem<NIB, AL_, MT_>();                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    gemv_kernel<NIB, AL_, MT_><<<grid, GV_THREADS, smem, stream>>>(         \
        x, ldx, w, ldw, scale, bias, out, ldo, part, tickets, M, rows, N,   \
        k_half, cw, rows_per_split);                                        \
  }
  WSMM_GEMV(1, true) WSMM_GEMV(1, false)
  WSMM_GEMV(2, true) WSMM_GEMV(2, false)
  WSMM_GEMV(4, true) WSMM_GEMV(4, false)
#undef WSMM_GEMV
  return static_cast<int>(cudaGetLastError());
}

// Launches mma_kernel on `stream` (M > GEMV_MAX_M).  Returns the
// cudaError_t.
template <bool NIB>
int launch_mma(const bf16* x, long long ldx, const int8_t* w, long long ldw,
               const bf16* scale, const bf16* bias, bf16* out, long long ldo,
               int M, int rows, int N, int k_half, int x_aligned,
               int w_aligned8, cudaStream_t stream) {
  if (M <= GEMV_MAX_M || N <= 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + MM_BM - 1) / MM_BM, (N + MM_BN - 1) / MM_BN);
  mma_kernel<NIB><<<grid, MM_THREADS, 0, stream>>>(
      x, ldx, w, ldw, scale, bias, out, ldo, M, rows, N, k_half, x_aligned,
      w_aligned8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wsmm
