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
// tile code is weight_stream.cuh's (int8 rows: NIB = false).

#include "weight_stream.cuh"

// Plain C entry point (bound with ctypes).  x [M, K] bf16 with row stride
// ldx; w [K, N] int8 with row stride ldw; scale [N] bf16 and bias [N] bf16
// (bias may be null) contiguous; out [M, N] bf16 with row stride ldo; part
// the fp32 workspace of the decode kernel ([splits, M, N], unused for
// M > 4).  The aligned flags say that 16-byte loads of x and 16- / 8-byte
// loads of w rows are legal.  Returns the cudaError_t of the launches.
extern "C" int int8_matmul_bf16(
    const void* x, long long ldx, const void* w, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo,
    void* part, int splits, int M, int K, int N, int x_aligned,
    int w_aligned16, int w_aligned8, void* stream) {
  using wsmm::bf16;
  return wsmm::launch<false>(
      static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w), ldw,
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), ldo, static_cast<float*>(part), splits, M, K,
      N, 0, x_aligned, w_aligned16, w_aligned8,
      static_cast<cudaStream_t>(stream));
}
