// Hopper (sm_90a) building blocks shared by the kernels that stream tiles
// through shared memory into wgmma: cp.async copies, ldmatrix, wgmma
// shared-memory descriptors of the 128-byte swizzle, and the wgmma fence,
// commit and wait.  Used by weight_stream_prefill.cuh (the int8 / int4
// prefill matmul) and attention_grad_sm90.cuh (kernel 8's backward).

#pragma once

#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the last 16 - bytes of them zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, zero where bytes = 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a K-major operand in the
// 128-byte swizzle: rows of 128 bytes (64 bf16 of K), 16-byte chunk c of
// row r at c ^ (r & 7), 8-row groups 1024 bytes apart (SBO) from a
// 1024-byte aligned base; `addr` is the base plus the byte offset of the
// k16 step
__device__ __forceinline__ uint64_t gmma_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The same for an MN-major operand (wgmma's imm-trans-b = 1): rows of 128
// bytes hold 64 bf16 of M or N, one row per k, 16-byte chunk c of row k
// at c ^ (k & 7), 8-k groups 1024 bytes apart (SBO); `addr` is the base
// plus the byte offset of the k16 step (16 rows, 2048 bytes).  With 64
// elements of M or N (one swizzle atom) the stride to the next 64 (LBO)
// is never used; it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t gmma_desc_sw128_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy shared-memory writes (cp.async) before the async proxy
// (wgmma) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// register across a wgmma issue or wait
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

}  // namespace sm90
