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
// halves per block).  Above the decode rows, where x and w rows are
// 16-byte aligned and K/2 is a multiple of 8, the prefill kernel of
// weight_stream_prefill.cuh with the nibble layout.

#include "weight_stream_prefill.cuh"

// Plain C entry points (bound with ctypes), as int8_matmul.cu's with w_pk
// [K/2, N] packed bytes with row stride ldw, and K even.

// The decode kernel (M <= 4); the plan (gemv_plan) over the K/2 packed
// rows.
extern "C" int int4_matmul_gemv_bf16(
    const void* x, long long ldx, const void* w_pk, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo,
    void* part, void* tickets, int M, int K, int N, int cw, int splits,
    int rows_per_split, int w_aligned16, void* stream) {
  using wsmm::bf16;
  if (K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wsmm::launch_gemv<true>(
      static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w_pk),
      ldw, static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), ldo, static_cast<float*>(part),
      static_cast<int*>(tickets), M, K / 2, N, K / 2, cw, splits,
      rows_per_split, w_aligned16 != 0, static_cast<cudaStream_t>(stream));
}

// The first mma kernel (M > 4, rows the prefill kernel does not take).
extern "C" int int4_matmul_mma_bf16(
    const void* x, long long ldx, const void* w_pk, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo, int M,
    int K, int N, int x_aligned, int w_aligned8, void* stream) {
  using wsmm::bf16;
  if (K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wsmm::launch_mma<true>(
      static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w_pk),
      ldw, static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), ldo, M, K / 2, N, K / 2, x_aligned,
      w_aligned8, static_cast<cudaStream_t>(stream));
}

// The prefill kernel with the nibble layout (M > 4, x and w_pk rows
// 16-byte aligned, K/2 a multiple of 8): tiles of nt x rows (one of 8, 16,
// 32, 48, 64, 96, 128, 144, 176, 208, 256) by 128 weight columns over
// `splits` ranges of the K/2 packed rows, part the fp32 workspace
// [splits, M, N] when splits > 1 (ops/int8_matmul.py::prefill_plan on the
// packed rows chooses them).  Returns the cudaError_t of the launches.
extern "C" int int4_matmul_prefill_bf16(
    const void* x, long long ldx, const void* w_pk, long long ldw,
    const void* scale, const void* bias, void* out, long long ldo,
    void* part, int splits, int M, int K, int N, int nt, void* stream) {
  if (K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wsmm::launch_prefill<true>(x, ldx, w_pk, ldw, scale, bias, out,
                                    ldo, part, splits, M, K / 2, N, nt,
                                    stream);
}
