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
// over 3.35 TB/s.  Two kernels:
//
//   * gemv_partial + gemv_finish (M <= GEMV_MAX_M): CUDA-core dot products.
//     A warp reads 512 consecutive columns of one row (16 bytes a lane,
//     GV_UNROLL rows in flight), the 8 warps of a block take interleaved
//     rows of one K slice, and the grid splits K so that ~8 blocks per SM
//     are there to stream even where N has few 512-column tiles (wout: 4;
//     the warp and unroll counts and the split are the fastest of a sweep
//     on an H100, win / wout / lm_head at M = 1).  Each
//     block sums its warps in shared memory and writes fp32 partial sums
//     [split, M, N]; gemv_finish adds the splits in a fixed order (the
//     result does not depend on scheduling) and applies scale and bias.
//   * mma_kernel (M > GEMV_MAX_M, the prefill): 64 x 128 output tiles,
//     8 warps of 32 x 32, mma.sync m16n8k16 over 32-row K tiles; the int8
//     tile is widened to bf16 while it is stored, transposed, in shared
//     memory, so each B fragment is one 32-bit load.  No cp.async or TMA
//     pipelining yet: load, barrier, multiply, barrier.
//
// Ragged M, K and N are masked in the kernels (N = 58498 for the Show-o
// vocabulary); 16-byte (x) and 8- or 16-byte (w) vector loads are taken
// only where the wrapper found the pointers and strides aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wsmm {

using bf16 = __nv_bfloat16;

constexpr int GEMV_MAX_M = 4;
constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_COLS = 32 * 16;  // columns of one block
constexpr int GV_UNROLL = 8;      // rows in flight per thread
constexpr int GV_FINISH_THREADS = 256;

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

// Partial sums over one K slice (blockIdx.y) of 512 columns (blockIdx.x)
// for M <= MT rows: part[(split * M + m) * N + n].  The weight rows stay in
// registers as they were loaded (uint4) and are widened byte by byte.
template <bool NIB, bool ALIGNED, int MT>
__global__ void __launch_bounds__(GV_THREADS)
gemv_partial(const bf16* __restrict__ x, long long ldx,
             const int8_t* __restrict__ w, long long ldw,
             float* __restrict__ part, int M, int rows, int N, int k_half,
             int rows_per_split) {
  __shared__ float red[GV_WARPS][GV_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * GV_COLS;
  const int n0 = c0 + lane * 16;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
    for (int r = r_begin + warp; r < r_end; r += GV_WARPS * GV_UNROLL) {
      uint4 v[GV_UNROLL];
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        const int rr = r + u * GV_WARPS;
        v[u] = rr < r_end ? load_row16<ALIGNED>(w + rr * ldw, n0, N)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        const int rr = r + u * GV_WARPS;
        if (rr >= r_end) continue;
        const int8_t* b = reinterpret_cast<const int8_t*>(&v[u]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= M) continue;
          const float xa = bf2f(x[m * ldx + rr]);
          if (NIB) {
            const float xb = bf2f(x[m * ldx + k_half + rr]);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int bj = b[j];
              acc[m][j] = fmaf(xa, static_cast<float>(nib_lo(bj)), acc[m][j]);
              acc[m][j] = fmaf(xb, static_cast<float>(nib_hi(bj)), acc[m][j]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j)
              acc[m][j] = fmaf(xa, static_cast<float>(b[j]), acc[m][j]);
          }
        }
      }
    }
  }

  // sum the warps, one row m at a time: red[warp][j * 32 + lane] holds
  // column lane * 16 + j (conflict-free stores and loads)
  float* dst = part + static_cast<long long>(blockIdx.y) * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 16; ++j) red[warp][j * 32 + lane] = acc[m][j];
    __syncthreads();
    for (int i = threadIdx.x; i < GV_COLS; i += GV_THREADS) {
      const int col = c0 + (i & 31) * 16 + (i >> 5);
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < GV_WARPS; ++v) s += red[v][i];
      if (col < N) dst[static_cast<long long>(m) * N + col] = s;
    }
    __syncthreads();
  }
}

// the splits' partial sums, added in order, through the epilogue
__global__ void __launch_bounds__(GV_FINISH_THREADS)
gemv_finish(const float* __restrict__ part, int splits, int M, int N,
            const bf16* __restrict__ scale, const bf16* __restrict__ bias,
            bf16* __restrict__ out, long long ldo) {
  const long long i =
      static_cast<long long>(blockIdx.x) * GV_FINISH_THREADS + threadIdx.x;
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

// Launches one weight-streaming product on `stream`: the gemv pair for
// M <= GEMV_MAX_M (part: [splits, M, N] fp32 workspace, splits from
// gemv_splits), else the mma kernel.  Returns the cudaError_t.
template <bool NIB>
int launch(const bf16* x, long long ldx, const int8_t* w, long long ldw,
           const bf16* scale, const bf16* bias, bf16* out, long long ldo,
           float* part, int splits, int M, int rows, int N, int k_half,
           int x_aligned, int w_aligned16, int w_aligned8,
           cudaStream_t stream) {
  if (M <= 0 || N <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= GEMV_MAX_M) {
    if (part == nullptr || splits <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows_per_split = (rows + splits - 1) / splits;
    dim3 grid((N + GV_COLS - 1) / GV_COLS, splits);
#define WSMM_GEMV(MT_, AL_)                                                 \
  gemv_partial<NIB, AL_, MT_><<<grid, GV_THREADS, 0, stream>>>(             \
      x, ldx, w, ldw, part, M, rows, N, k_half, rows_per_split)
    if (M == 1) {
      if (w_aligned16) WSMM_GEMV(1, true); else WSMM_GEMV(1, false);
    } else if (M == 2) {
      if (w_aligned16) WSMM_GEMV(2, true); else WSMM_GEMV(2, false);
    } else {
      if (w_aligned16) WSMM_GEMV(4, true); else WSMM_GEMV(4, false);
    }
#undef WSMM_GEMV
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(M) * N;
    gemv_finish<<<static_cast<unsigned>((total + GV_FINISH_THREADS - 1) /
                                        GV_FINISH_THREADS),
                  GV_FINISH_THREADS, 0, stream>>>(part, splits, M, N, scale,
                                                  bias, out, ldo);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((M + MM_BM - 1) / MM_BM, (N + MM_BN - 1) / MM_BN);
  mma_kernel<NIB><<<grid, MM_THREADS, 0, stream>>>(
      x, ldx, w, ldw, scale, bias, out, ldo, M, rows, N, k_half, x_aligned,
      w_aligned8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wsmm
