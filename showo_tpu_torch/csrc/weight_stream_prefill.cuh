// The int8 and int4 weight-streaming matmuls above the decode rows
// (M > GEMV_MAX_M) for Hopper (sm_90a): the prefill of a quantized Phi
// (win / wout / lm_head at M = 267 or 609 rows) and the probes' [8, 2048]
// x [2048, 8192].
//
//   out[m, n] = bf16(bf16(sum_k x[m, k] * w[k, n] * scale[n]) + bias[n])
//
// with the arithmetic of weight_stream.cuh (int8 or int4 widened exactly
// to bf16, bf16 products summed in fp32, `epilogue`); only the order of
// the sum differs.  Two weight formats, as in weight_stream.cuh: int8
// rows (NIB = false), and the int4 split-halves layout (NIB = true), where
// byte (r, n) of the [K/2, N] packed rows holds w[r, n] in its low nibble
// and w[K/2 + r, n] in its high one.  Replaces the Pallas kernels
// tools/probe_int8_decode.py::_i8_kernel, tools/probe_pallas_wsmm.py::
// _i8_kernel (int8) and tools/probe_int4_decode.py::_nib_kernel,
// tools/probe_pallas_wsmm.py::_nib_kernel (int4) above the decode rows,
// as weight_stream.cuh's mma_kernel did before it (which stays for rows
// that are not 16-byte aligned).
//
// What bounds it on an H100: at M = 267 a weight byte feeds 534
// operations, above the ~295 per byte where the tensor cores, not the
// memory, are the limit: win / wout 15.7 / 11.2 GFLOP, bound 0.0159 /
// 0.0113 ms at 989 TFLOP/s (lm_head 0.0647 ms).  The probe's M = 8 is
// bound by its 16.8 MB of weights (0.0051 ms at 3.35 TB/s; int4: 8.4 MB,
// 0.0026 ms).
//
// Design, against the five faults of mma_kernel:
//   1. Loads overlap the multiply: a ring of STAGES K tiles of 64 rows in
//      dynamic shared memory, filled by 16-byte cp.async.cg copies (the
//      ragged M, K and N edges zero-filled through the source-size
//      operand), STAGES - 2 tiles in flight while one is multiplied.
//   2. Split-K where M tiles x N tiles fill less than a wave: blockIdx.z
//      takes a range of K tiles and writes fp32 partial sums [splits, M,
//      N]; finish_splits adds them in a fixed order and applies the
//      epilogue, so the result does not depend on scheduling.  The split
//      is chosen by ops/int8_matmul.py::prefill_plan.
//   3. No bank conflicts, whole cache lines: 8 neighbouring threads copy
//      one 128-byte row (of x: 64 bf16; of w: 128 int8) into 8 different
//      bank groups, the 16-byte chunk c of row r at c ^ (r & 7).  For x
//      that is wgmma's 128-byte swizzle; for w it puts the 8 rows of one
//      16-byte column band, what one ldmatrix phase reads, in 8 bank
//      groups.  (Unswizzled 8 x 16-byte core matrices of x, 8 rows per
//      8 threads, read half a cache line per row and held the kernel
//      back.)  int4: a stage holds one packed tile, laid out as the int8
//      one, and two x tiles: columns k0 + [0, 64) and K/2 + k0 + [0, 64).
//   4. Row tiles that fit M: the tile width NT (x rows) is one of PF_NT,
//      8 to 256 (prefill_plan: M = 267 -> 2 x 144, 609 -> 3 x 208, 8 -> 8).
//   5. The multiply is wgmma.mma_async m64nNTk16 with the problem turned
//      over, out^T = w^T x^T: the weights are the A operand, widened in
//      registers straight into the m64k16 fragments (ldmatrix.trans of
//      the raw bytes, two bytes per 16-bit lane, then an exact bf16
//      subtraction), and x is B, read by the tensor cores from shared
//      memory through a descriptor.  No widened copy of the weights is
//      written to shared memory (a first version that widened them into
//      a bf16 tile for mma.sync spent its time on shared-memory traffic).
//      Two warpgroups, 64 weight columns each; one tile's products stay
//      in flight while the next tile's copies are issued and its
//      fragments loaded.  int4: each ldmatrix.trans of the packed bytes
//      gives the A fragments of two k16 steps, the low nibbles against
//      the first x tile and the high nibbles against the second, so each
//      packed byte is read once and feeds two products.

#pragma once

#include "sm90_async.cuh"
#include "weight_stream.cuh"
#include "wgmma_rs.cuh"

namespace wsmm {

using namespace sm90;

constexpr int PF_BK = 64;        // K rows of a tile (128 bytes of x rows)
constexpr int PF_BN = 128;       // weight columns of a tile: 2 warpgroups
constexpr int PF_THREADS = 256;
constexpr int PF_W_STAGE = PF_BK * PF_BN;  // raw int8 tile: 8 KB

// two bytes, each in the low byte of a 16-bit half of `pair` -> two bf16,
// exact: bf16(128 + (b & 127)) - bf16(128, or 256 where b < 0) = b
__device__ __forceinline__ uint32_t widen_pair(uint32_t pair) {
  const uint32_t mag = (pair & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (pair & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
              *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// two nibbles, each in the low 4 bits of a 16-bit half of `pair` (the
// other bits of the half are ignored) -> two bf16, exact, sign-extended:
// bf16(128 + (n ^ 8)) - bf16(136) = (n ^ 8) - 8
__device__ __forceinline__ uint32_t widen_nib_pair(uint32_t pair) {
  const uint32_t mag = ((pair & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  const uint32_t sub = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
              *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// x rows [m_tile, m_tile + ROWS) x columns [k0, k0 + 64) -> ROWS rows of
// 128 bytes at xs in the 128-byte swizzle (16-byte chunk c of row r at
// c ^ (r & 7)): 8 neighbouring threads copy one row, 128 contiguous bytes
// of x, into 8 different bank groups
template <int ROWS>
__device__ __forceinline__ void load_x_tile(uint32_t xs, const bf16* x,
                                            long long ldx, int m_tile, int M,
                                            int K, int k0, int tid) {
#pragma unroll
  for (int r = 0; r < (ROWS * 8 + PF_THREADS - 1) / PF_THREADS; ++r) {
    const int q = tid + r * PF_THREADS, row = q >> 3, c = q & 7;
    if (ROWS * 8 % PF_THREADS != 0 && q >= ROWS * 8) break;
    const int m = m_tile + row, col = k0 + 8 * c;
    const bf16* src = x;
    int bytes = 0;
    if (m < M && col < K) {
      src = x + m * ldx + col;
      bytes = min(16, 2 * (K - col));
    }
    cp_async16(xs + row * 128 + ((c ^ (row & 7)) * 16), src, bytes);
  }
}

// w rows [k0, k0 + 64) x columns [n_tile, n_tile + 128) -> 64 rows of 128
// bytes at ws, 16-byte chunk c of row k at c ^ (k & 7): 8 neighbouring
// threads copy one row
__device__ __forceinline__ void load_w_tile(uint32_t ws, const int8_t* w,
                                            long long ldw, int n_tile, int N,
                                            int K, int k0, int tid) {
#pragma unroll
  for (int r = 0; r < PF_W_STAGE / 16 / PF_THREADS; ++r) {
    const int q = tid + r * PF_THREADS, row = q >> 3, c = q & 7;
    const int k = k0 + row, n = n_tile + 16 * c;
    const int8_t* src = w;
    int bytes = 0;
    if (k < K && n < N) {
      src = w + k * ldw + n;
      bytes = min(16, N - n);
    }
    cp_async16(ws + row * PF_BN + ((c ^ (row & 7)) * 16), src, bytes);
  }
}

// The tile width NT (x rows of a block, wgmma's N) and the stages of its
// ring: up to 144 rows (int4: 96, whose stages hold two x tiles) a
// thread's accumulators fit in 128 registers, two blocks an SM; wider
// tiles take one block and a deeper ring.
template <int NT, bool NIB>
struct PfCfg {
  static constexpr int X_TILES = NIB ? 2 : 1;  // x column ranges of a stage
  static constexpr int X_STAGE = NT * PF_BK * 2;
  static constexpr int STAGE = X_TILES * X_STAGE + PF_W_STAGE;
  static constexpr int BLOCKS = NT <= (NIB ? 96 : 144) ? 2 : 1;
  static constexpr int FIT = (BLOCKS == 2 ? 112 : 220) * 1024 / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(NT % 8 == 0 && NT <= 256 && STAGES >= 3, "tile width");
};

// One tile of NT x rows by 128 weight columns (blockIdx.x: M tile, so the
// M tiles of one N tile run together and share its weights in L2;
// blockIdx.y: N tile) over the K tiles [z * kt_per_split, ...) of split
// z = blockIdx.z.  part == nullptr: out gets the epilogue; else part[z]
// gets the fp32 sums.  K counts the rows of w: for int4 (NIB) the packed
// rows, K/2 of x's columns, x column r pairing with the low nibbles of
// row r and K + r with the high ones.  x rows (ldx) and w rows (ldw)
// must be 16-byte aligned, and for int4 x + K too.
//
// Warp `warp` (warpgroup warp / 4) owns the 16 weight columns n_tile + 16
// warp + [0, 16), one 16-byte chunk of a raw row; of its m16k16 A
// fragment, row g (lane / 4) is column 2 g and row g + 8 column 2 g + 1,
// the order in which ldmatrix.trans hands a thread two columns' bytes.
template <int NT, bool NIB>
__global__ void __launch_bounds__(PF_THREADS, PfCfg<NT, NIB>::BLOCKS)
prefill_kernel(const bf16* __restrict__ x, long long ldx,
               const int8_t* __restrict__ w, long long ldw,
               const bf16* __restrict__ scale, const bf16* __restrict__ bias,
               bf16* __restrict__ out, long long ldo,
               float* __restrict__ part, int M, int K, int N,
               int kt_per_split) {
  using C = PfCfg<NT, NIB>;
  // one tile's products stay in flight, so its stage is refilled one
  // iteration later
  constexpr int LOOKAHEAD = C::STAGES - 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_tile = blockIdx.x * NT, n_tile = blockIdx.y * PF_BN;
  const int k_tiles = (K + PF_BK - 1) / PF_BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(k_tiles, kt0 + kt_per_split) - kt0;

  auto load_tile = [&](int kt, int stage) {
    const uint32_t xs = sbase + stage * C::STAGE;
    load_x_tile<NT>(xs, x, ldx, m_tile, M, K, kt * PF_BK, tid);
    if constexpr (NIB)
      load_x_tile<NT>(xs + C::X_STAGE, x + K, ldx, m_tile, M, K, kt * PF_BK,
                      tid);
    load_w_tile(xs + C::X_TILES * C::X_STAGE, w, ldw, n_tile, N, K,
                kt * PF_BK, tid);
  };

  float acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0.f;

#pragma unroll
  for (int s = 0; s < LOOKAHEAD; ++s) {
    if (s < nkt) load_tile(kt0 + s, s);
    cp_async_commit();
  }
  // this lane's row of an ldmatrix of the raw tile: k = 32 p + lane
  const uint32_t a_row = lane * PF_BN + ((warp ^ (lane & 7)) * 16);
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<LOOKAHEAD - 1>();
    fence_proxy_async();
    // tile i has landed for every thread, and every warpgroup is done
    // with the stage refilled below (tile i - 2's)
    __syncthreads();
    if (i + LOOKAHEAD < nkt)
      load_tile(kt0 + i + LOOKAHEAD, (i + LOOKAHEAD) % C::STAGES);
    cp_async_commit();
    const uint32_t xs = sbase + (i % C::STAGES) * C::STAGE;
    const uint32_t raw = xs + C::X_TILES * C::X_STAGE;
    // r[p][q]: k rows 32 p + 8 q + [0, 8) of this warp's 16 columns; a
    // thread gets the bytes (k 2t, col 2g), (2t, 2g+1), (2t+1, 2g),
    // (2t+1, 2g+1) of each 8 x 8 block
    uint32_t r[2][4];
    ldsm_x4_t(r[0], raw + a_row);
    ldsm_x4_t(r[1], raw + 32 * PF_BN + a_row);
    // tile i - 1's products are done: the A registers may be written
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) fence_reg(acc[j]);
    // a[s]: k16 step s of the tile (int4: a[4 + s], the high nibbles')
    uint32_t a[4 * C::X_TILES][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t lo = r[s >> 1][2 * (s & 1)];
      const uint32_t hi = r[s >> 1][2 * (s & 1) + 1];
      const uint32_t pairs[4] = {
          __byte_perm(lo, 0u, 0x4240), __byte_perm(lo, 0u, 0x4341),
          __byte_perm(hi, 0u, 0x4240), __byte_perm(hi, 0u, 0x4341)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (NIB) {
          a[s][q] = widen_nib_pair(pairs[q]);
          a[4 + s][q] = widen_nib_pair(pairs[q] >> 4);
        } else {
          a[s][q] = widen_pair(pairs[q]);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4 * C::X_TILES; ++s)
      wgmma_rs<NT>(acc, a[s],
                   gmma_desc_sw128(xs + (s >> 2) * C::X_STAGE + 32 * (s & 3)));
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) fence_reg(acc[j]);

  // acc[4 j + 2 h + e]: column n0 + h, row m_tile + 8 j + 2 t + e
  const int g = lane >> 2, t = lane & 3;
  const int n0 = n_tile + 16 * warp + 2 * g;
  if (n0 >= N) return;
  const bool pair = n0 + 1 < N;
  if (part != nullptr) {
    float* dst = part + static_cast<long long>(blockIdx.z) * M * N + n0;
    const bool vec = pair && N % 2 == 0;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m_tile + 8 * j + 2 * t + e;
        if (m >= M) continue;
        float* p = dst + static_cast<long long>(m) * N;
        if (vec) {
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
        } else {
          p[0] = acc[4 * j + e];
          if (pair) p[1] = acc[4 * j + 2 + e];
        }
      }
    }
    return;
  }
  // the epilogue's scale and bias of the two columns, read once
  const float s0 = bf2f(scale[n0]), s1 = pair ? bf2f(scale[n0 + 1]) : 0.f;
  const float b0 = bias == nullptr ? 0.f : bf2f(bias[n0]);
  const float b1 = bias == nullptr || !pair ? 0.f : bf2f(bias[n0 + 1]);
  const bool vec = pair && ldo % 2 == 0;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m_tile + 8 * j + 2 * t + e;
      if (m >= M) continue;
      bf16 y0 = __float2bfloat16(acc[4 * j + e] * s0);
      bf16 y1 = __float2bfloat16(acc[4 * j + 2 + e] * s1);
      if (bias != nullptr) {
        y0 = __float2bfloat16(bf2f(y0) + b0);
        y1 = __float2bfloat16(bf2f(y1) + b1);
      }
      bf16* o = out + m * ldo + n0;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);
      } else {
        o[0] = y0;
        if (pair) o[1] = y1;
      }
    }
  }
}

// Launches the prefill kernel on a grid of M tiles x N tiles x splits,
// then finish_splits when K is split (part: [splits, M, N] fp32).  Returns
// the cudaError_t.
template <int NT, bool NIB>
int launch_prefill_t(const bf16* x, long long ldx, const int8_t* w,
                     long long ldw, const bf16* scale, const bf16* bias,
                     bf16* out, long long ldo, float* part, int splits,
                     int M, int K, int N, cudaStream_t stream) {
  using C = PfCfg<NT, NIB>;
  auto kernel = prefill_kernel<NT, NIB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  // all of L1 as shared memory, so that two blocks fit on an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_tiles = (K + PF_BK - 1) / PF_BK;
  const int per = (k_tiles + splits - 1) / splits;
  dim3 grid((M + NT - 1) / NT, (N + PF_BN - 1) / PF_BN, splits);
  kernel<<<grid, PF_THREADS, C::SMEM, stream>>>(
      x, ldx, w, ldw, scale, bias, out, ldo, splits > 1 ? part : nullptr, M,
      K, N, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  finish_splits<<<static_cast<unsigned>((total + FINISH_THREADS - 1) /
                                        FINISH_THREADS),
                  FINISH_THREADS, 0, stream>>>(part, splits, M, N, scale,
                                               bias, out, ldo);
  return static_cast<int>(cudaGetLastError());
}

// Checks what the prefill kernel takes: M > GEMV_MAX_M, every split a
// non-empty range of K tiles (K: w's rows), 16-byte aligned x and w rows,
// and for int4 (nib) x's second half 16-byte aligned too.
inline bool prefill_args_ok(const void* x, long long ldx, const void* w,
                            long long ldw, const void* part, int splits,
                            int M, int K, int N, bool nib) {
  if (M <= GEMV_MAX_M || K <= 0 || N <= 0 || splits <= 0) return false;
  if (splits > 1 && part == nullptr) return false;
  const int k_tiles = (K + PF_BK - 1) / PF_BK;
  const int per = (k_tiles + splits - 1) / splits;
  if ((splits - 1) * per >= k_tiles) return false;
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0 &&
         (!nib || K % 8 == 0) && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         ldw % 16 == 0;
}

// The prefill product at tile width nt (one of PF_NT: 8, 16, 32, 48, 64,
// 96, 128, 144, 176, 208, 256) after prefill_args_ok; K counts w's rows.
// Returns the cudaError_t of the launches.
template <bool NIB>
int launch_prefill(const void* x, long long ldx, const void* w,
                   long long ldw, const void* scale, const void* bias,
                   void* out, long long ldo, void* part, int splits, int M,
                   int K, int N, int nt, void* stream) {
  if (!prefill_args_ok(x, ldx, w, ldw, part, splits, M, K, N, NIB))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const int8_t*>(w);
  const auto* sb = static_cast<const bf16*>(scale);
  const auto* bb = static_cast<const bf16*>(bias);
  auto* ob = static_cast<bf16*>(out);
  auto* pf = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  switch (nt) {
#define WSMM_PREFILL(NT_)                                                 \
  case NT_:                                                               \
    return launch_prefill_t<NT_, NIB>(xb, ldx, wb, ldw, sb, bb, ob, ldo,  \
                                      pf, splits, M, K, N, st);
    WSMM_PREFILL(8) WSMM_PREFILL(16) WSMM_PREFILL(32) WSMM_PREFILL(48)
    WSMM_PREFILL(64) WSMM_PREFILL(96) WSMM_PREFILL(128) WSMM_PREFILL(144)
    WSMM_PREFILL(176) WSMM_PREFILL(208) WSMM_PREFILL(256)
#undef WSMM_PREFILL
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wsmm
