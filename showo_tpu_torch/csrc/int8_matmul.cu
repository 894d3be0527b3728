// Weight-only int8 matmul for Hopper (sm_90a):
//
//   out[M, N] = bf16(fp32(x[M, K] @ bf16(w_i8[K, N])) * scale[N]) (+ bias[N])
//
// Replaces the Pallas kernels tools/probe_int8_decode.py::pallas_i8_matmul
// (_i8_kernel, grid over K blocks) and tools/probe_pallas_wsmm.py::
// pallas_i8_matmul (the same function on an (N, K) grid): both stream
// int8 weight tiles, widen them to bf16 next to the matrix unit and scale
// the fp32 sum per output column, so no bf16 copy of the weights is ever
// written.  On the card that is every matmul of a quantized Phi (win,
// wout, lm_head after fuse_parallel_mlp): at decode the weight bytes over
// the memory rate are the whole bound, half those of bf16 weights.  The
// tile code is weight_stream.cuh's (int8 rows: NIB = false); above the
// decode rows, where x and w rows are 16-byte aligned, the prefill kernel
// of weight_stream_prefill.cuh.

#include "weight_stream_prefill.cuh"

// Plain C entry points (bound with ctypes).  x [M, K] bf16 with row
// stride ldx; w [K, N] int8 with row stride ldw; scale [N] bf16 and bias
// [N] bf16 (bias may be null) contiguous; out [M, N] bf16 with row stride
// ldo.  Each returns the cudaError_t of its launches.

// The decode kernel (M <= 4) on the plan of ops/int8_matmul.py::gemv_plan:
// column tiles of 16 * cw bytes, K in `splits` ranges of rows_per_split
// rows; part the fp32 workspace [splits, M, N] and tickets the int32
// [column tiles] zeros where splits > 1.  w_aligned16: w and its row
// stride are 16-byte aligned (the rows are streamed by cp.async).
extern "C" int int8_matmul_gemv_bf16(
    const void* x, long long ldx, const void* w, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo,
    void* part, void* tickets, int M, int K, int N, int cw, int splits,
    int rows_per_split, int w_aligned16, void* stream) {
  using wsmm::bf16;
  return wsmm::launch_gemv<false>(
      static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w), ldw,
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), ldo, static_cast<float*>(part),
      static_cast<int*>(tickets), M, K, N, 0, cw, splits, rows_per_split,
      w_aligned16 != 0, static_cast<cudaStream_t>(stream));
}

// The first mma kernel (M > 4, rows the prefill kernel does not take).
// The aligned flags say that 16-byte loads of x and 8-byte loads of w
// rows are legal.
extern "C" int int8_matmul_mma_bf16(
    const void* x, long long ldx, const void* w, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo, int M,
    int K, int N, int x_aligned, int w_aligned8, void* stream) {
  using wsmm::bf16;
  return wsmm::launch_mma<false>(
      static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w), ldw,
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), ldo, M, K, N, 0, x_aligned, w_aligned8,
      static_cast<cudaStream_t>(stream));
}

// The prefill kernel (M > 4, x and w rows 16-byte aligned): tiles of nt x
// rows (one of 8, 16, 32, 48, 64, 96, 128, 144, 176, 208, 256) by 128
// weight columns over `splits` K ranges, part the fp32 workspace [splits,
// M, N] when splits > 1 (ops/int8_matmul.py::prefill_plan chooses them).
// Returns the cudaError_t of the launches.
extern "C" int int8_matmul_prefill_bf16(
    const void* x, long long ldx, const void* w, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo,
    void* part, int splits, int M, int K, int N, int nt, void* stream) {
  return wsmm::launch_prefill<false>(x, ldx, w, ldw, scale, bias, out, ldo,
                                     part, splits, M, K, N, nt, stream);
}
