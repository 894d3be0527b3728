// Weight-only int4 matmul for Hopper (sm_90a), split-halves nibble layout:
//
//   out[M, N] = bf16(fp32(x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale[N])
//               (+ bias[N])
//
// where byte w_pk[r, n] (w_pk: [K/2, N] int8) holds row r of the weights
// in its low nibble (lo) and row K/2 + r in its high nibble (hi), both
// sign-extended.  Replaces the Pallas kernels tools/probe_int4_decode.py::
// pallas_nib_matmul (_nib_kernel, 8-bit shifts) and tools/
// probe_pallas_wsmm.py::pallas_nib_matmul (the same function on an (N, K)
// grid, 32-bit shifts): both unpack the nibbles next to the matrix unit.
// The bound at decode is the packed bytes over the memory rate, a quarter
// of bf16 weights.  The tile code is weight_stream.cuh's (NIB = true):
// one pass over a byte row feeds both halves of K, so each byte is read
// once; the host re-lays nothing out (the Pallas wrappers concatenate x's
// halves per block).

#include "weight_stream.cuh"

// Plain C entry point (bound with ctypes), as int8_matmul_bf16 with w_pk
// [K/2, N] packed bytes with row stride ldw, and K even.
extern "C" int int4_matmul_bf16(
    const void* x, long long ldx, const void* w_pk, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo,
    void* part, int splits, int M, int K, int N, int x_aligned,
    int w_aligned16, int w_aligned8, void* stream) {
  using wsmm::bf16;
  if (K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wsmm::launch<true>(
      static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w_pk), ldw,
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), ldo, static_cast<float*>(part), splits, M,
      K / 2, N, K / 2, x_aligned, w_aligned16, w_aligned8,
      static_cast<cudaStream_t>(stream));
}
