// Omni-masked attention with the mask recomputed from O(S) span metadata,
// shared by two entry points that differ only in layout:
//   omni_attention_packed.cu  q/k/v [B, S, H*D]  (Pallas omni_attention_packed)
//   omni_attention.cu         q/k/v [B, H, S, D]  (Pallas omni_attention)
// On the TPU the two are separate kernels because lane tiling forced the
// head-major one into a transposed [D, S] layout
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
constexpr int SMEM_BYTES = tile::TILE_SMEM + 2 * tile::BLOCK_K * 4;
static_assert(SMEM_BYTES <= 48 * 1024, "dynamic smem above the default");

__global__ void __launch_bounds__(tile::THREADS, 4)
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
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + K_OFF;
  bf16* Vt = Qs + V_OFF;
  int* seg_s = reinterpret_cast<int*>(smem + TILE_SMEM);
  int* pad_s = seg_s + BLOCK_K;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* kh = k + b * ks.b + kvh * ks.h;
  const bf16* vh = v + b * vs.b + kvh * vs.h;

  load_q(Qs, q + b * qs.b + h * qs.h, qs.r, q0, Q);
  __syncthreads();
  uint32_t qf[KD][4];
  q_fragments(Qs, qf);

  const int row0 = q0 + tile_row(), row1 = row0 + 8;
  int pos0 = 0, pos1 = 0, sq0 = 0, sq1 = 0;
  if (row0 < Q) {
    pos0 = pos_q[(long long)b * Q + row0];
    sq0 = seg_q[(long long)b * Q + row0];
  }
  if (row1 < Q) {
    pos1 = pos_q[(long long)b * Q + row1];
    sq1 = seg_q[(long long)b * Q + row1];
  }
  const int lp = last_pad[b], pf = prefix[b];
  const bool padok0 = pos0 <= lp, padok1 = pos1 <= lp;
  const int t4 = threadIdx.x & 3;

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    load_kv(Ks, Vt, kh, ks.r, vh, vs.r, k0, S);
    if (threadIdx.x < BLOCK_K) {
      const int j = k0 + threadIdx.x;
      seg_s[threadIdx.x] = j < S ? seg[(long long)b * S + j] : 0;
      pad_s[threadIdx.x] = j < S ? pad[(long long)b * S + j] : 0;
    }
    __syncthreads();
    float s[NK][4];
    scores(qf, Ks, s);
    // mask and scale into the log2 domain
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = n * 8 + t4 * 2 + e, j = k0 + jl;
        float x0 = -INFINITY, x1 = -INFINITY;
        if (j < S) {
          const int sj = seg_s[jl];
          const bool pj = pad_s[jl] != 0;
          const bool v0 = ((j <= pos0) || (sq0 > 0 && sq0 == sj) ||
                           (j < pf)) && (!pj || padok0);
          const bool v1 = ((j <= pos1) || (sq1 > 0 && sq1 == sj) ||
                           (j < pf)) && (!pj || padok1);
          x0 = v0 ? s[n][e] * scale_log2 : MASKED;
          x1 = v1 ? s[n][2 + e] * scale_log2 : MASKED;
        }
        s[n][e] = x0;
        s[n][2 + e] = x1;
      }
    }
    softmax_update(s, m, l, o);
    pv(s, Vt, o);
  }
  store(out + b * os.b + h * os.h, os.r, q0, Q, o, l);
}

// Launch on ``stream``; returns the cudaError_t of the launch (0 = launched).
inline int launch(const void* q, const void* k, const void* v, void* out,
                  const int* seg, const int* pad, const int* last_pad,
                  const int* prefix, const int* pos_q, const int* seg_q,
                  int B, int Q, int S, int H, int Hkv, Strides qs, Strides ks,
                  Strides vs, Strides os, float sm_scale, void* stream) {
  dim3 grid((Q + tile::BLOCK_Q - 1) / tile::BLOCK_Q, H, B);
  omni_attention_kernel<<<grid, tile::THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seg, pad,
      last_pad, prefix, pos_q, seg_q, Q, S, H / Hkv, qs, ks, vs, os,
      sm_scale * tile::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omni
