// Omni-masked attention with the mask recomputed from O(S) span metadata,
// shared by three entry points that differ only in layout and in how a
// block's rows are chosen:
//   omni_attention_packed.cu       q/k/v [B, S, H*D]  (Pallas
//                                  omni_attention_packed), head dim 64 or
//                                  128
//   omni_attention.cu              q/k/v [B, H, S, D]  (Pallas
//                                  omni_attention), head dim 64
//   omni_attention_gqa_stacked.cu  the packed layout, one block per kv head
//                                  (Pallas _omni_attention_gqa_stacked)
// On the TPU the first two are separate kernels because lane tiling forced
// the head-major one into a transposed [D, S] layout
// (showo_tpu/ops/flash_attention.py:46-49).  On Hopper a head stride beside
// the batch and row strides covers both: the packed layout has head stride
// D and row stride H*D, the head-major one head stride S*D and row stride D
// (or any strided view whose last dim is contiguous).
//
//   visible(b,i,j) = [ j <= pos_q[b,i]
//                    | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
//                    | j < prefix[b] ]
//                  & ( pad[b,j] == 0 | pos_q[b,i] <= last_pad[b] )
//   out = softmax_fp32(q.k^T * sm_scale, masked) . v
//
// A masked score is -1e30 (not -inf), so a row with no visible column
// averages v over all S columns, as the plain version does; columns past S
// are -inf and take no weight.
//
// What bounds it on an H100: at the v1 512^2 cached step (B=4, Q=1026,
// S=1155, H=32, D=64) each (b, h) pair does 2*Q*S*D*2 = 0.3 GFLOP over
// 0.4 MB of q/k/v, so with D=64 a q tile performs ~64 FLOP per byte of K/V
// it reads from shared memory: small-D attention is bound by moving K/V
// through shared memory and by the launch shape, not by the tensor cores.
// At D=128 (Qwen2.5, Show-o2) a tile does twice the products per K/V byte.
// The design (attention_tile.cuh) keeps every score on chip, gives every
// (b, h, 64-row q tile) its own block (2176 blocks at the main shape,
// against 132 SMs) so the card is filled without a persistent scheduler,
// and masks the ragged Q and K edges itself, so the host pads nothing.
// TMA, wgmma and a pipelined K/V ring are later work.
//
// Grid (ceil(Q/64), H, B); block 128 threads.  GQA: kv head = h / group.

#pragma once

#include "attention_tile.cuh"

namespace omni {

using tile::bf16;
using tile::Strides;

// tiles, then seg / pad of the K tile
template <int HD>
constexpr int smem_bytes() {
  return tile::Geom<HD>::TILE_SMEM + 2 * tile::BLOCK_K * 4;
}
static_assert(smem_bytes<64>() <= 48 * 1024, "dynamic smem above the default");

// The metadata of one q row: its kv position, segment id, and whether it
// may see pad columns.
struct Row {
  int pos, seg;
  bool padok;
};

__device__ __forceinline__ Row load_row(const int* pos_q, const int* seg_q,
                                        int b, int i, int Q, int last_pad) {
  Row r{0, 0, false};
  if (i < Q) {
    r.pos = pos_q[(long long)b * Q + i];
    r.seg = seg_q[(long long)b * Q + i];
  }
  r.padok = r.pos <= last_pad;
  return r;
}

// seg / pad of K tile [k0, k0 + BLOCK_K) into shared memory (threads
// 0..BLOCK_K-1; the block has at least BLOCK_K threads)
__device__ __forceinline__ void load_tile_meta(int* seg_s, int* pad_s,
                                               const int* seg, const int* pad,
                                               int b, int k0, int S) {
  if (threadIdx.x < tile::BLOCK_K) {
    const int j = k0 + threadIdx.x;
    seg_s[threadIdx.x] = j < S ? seg[(long long)b * S + j] : 0;
    pad_s[threadIdx.x] = j < S ? pad[(long long)b * S + j] : 0;
  }
}

// Mask the raw products s of K tile k0 for this thread's rows r0, r1 and
// scale them into the log2 domain.
__device__ __forceinline__ void mask_logits(float s[tile::NK][4], int k0,
                                            int S, const int* seg_s,
                                            const int* pad_s, Row r0, Row r1,
                                            int prefix, float scale_log2) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < tile::NK; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jl = n * 8 + t4 * 2 + e, j = k0 + jl;
      float x0 = -INFINITY, x1 = -INFINITY;
      if (j < S) {
        const int sj = seg_s[jl];
        const bool pj = pad_s[jl] != 0;
        const bool v0 = ((j <= r0.pos) || (r0.seg > 0 && r0.seg == sj) ||
                         (j < prefix)) && (!pj || r0.padok);
        const bool v1 = ((j <= r1.pos) || (r1.seg > 0 && r1.seg == sj) ||
                         (j < prefix)) && (!pj || r1.padok);
        x0 = v0 ? s[n][e] * scale_log2 : tile::MASKED;
        x1 = v1 ? s[n][2 + e] * scale_log2 : tile::MASKED;
      }
      s[n][e] = x0;
      s[n][2 + e] = x1;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(tile::THREADS, HD == 64 ? 4 : 2)
omni_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      const int* __restrict__ seg, const int* __restrict__ pad,
                      const int* __restrict__ last_pad,
                      const int* __restrict__ prefix,
                      const int* __restrict__ pos_q,
                      const int* __restrict__ seg_q, int Q, int S, int group,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale_log2) {
  using namespace tile;
  using G = Geom<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + G::K_OFF;
  bf16* Vt = Qs + G::V_OFF;
  int* seg_s = reinterpret_cast<int*>(smem + G::TILE_SMEM);
  int* pad_s = seg_s + BLOCK_K;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* kh = k + b * ks.b + kvh * ks.h;
  const bf16* vh = v + b * vs.b + kvh * vs.h;

  load_q<HD>(Qs, q + b * qs.b + h * qs.h, qs.r, q0, Q);
  __syncthreads();
  uint32_t qf[G::KD][4];
  q_fragments<HD>(Qs, qf);

  const int row0 = q0 + tile_row();
  const int lp = last_pad[b], pf = prefix[b];
  const Row r0 = load_row(pos_q, seg_q, b, row0, Q, lp);
  const Row r1 = load_row(pos_q, seg_q, b, row0 + 8, Q, lp);

  float o[G::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < G::ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    load_kv<HD>(Ks, Vt, kh, ks.r, vh, vs.r, k0, S);
    load_tile_meta(seg_s, pad_s, seg, pad, b, k0, S);
    __syncthreads();
    float s[NK][4];
    scores<HD>(qf, Ks, s);
    mask_logits(s, k0, S, seg_s, pad_s, r0, r1, pf, scale_log2);
    softmax_update<HD>(s, m, l, o);
    pv<HD>(s, Vt, o);
  }
  store<HD>(out + b * os.b + h * os.h, os.r, q0, Q, o, l);
}

// Allow ``kernel`` ``bytes`` of dynamic shared memory on the current device
// where that is above the default 48 KB (the attribute is the device's, so
// it is set at every launch).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Launch on ``stream``; returns the cudaError_t of the launch (0 = launched).
template <int HD>
inline int launch(const void* q, const void* k, const void* v, void* out,
                  const int* seg, const int* pad, const int* last_pad,
                  const int* prefix, const int* pos_q, const int* seg_q,
                  int B, int Q, int S, int H, int Hkv, Strides qs, Strides ks,
                  Strides vs, Strides os, float sm_scale, void* stream) {
  constexpr int bytes = smem_bytes<HD>();
  const cudaError_t set = allow_smem(omni_attention_kernel<HD>, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  dim3 grid((Q + tile::BLOCK_Q - 1) / tile::BLOCK_Q, H, B);
  omni_attention_kernel<HD><<<grid, tile::THREADS, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seg, pad,
      last_pad, prefix, pos_q, seg_q, Q, S, H / Hkv, qs, ks, vs, os,
      sm_scale * tile::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omni
