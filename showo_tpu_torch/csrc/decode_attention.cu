// Attention under an explicit additive bias, for Hopper (sm_90a): bf16
// q/k/v and output, fp32 bias, fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/decode_attention.py::decode_attention (Pallas
// kernels _kernel, grid (B, H), and _kernel_headloop, grid (B,) with a head
// loop; they compute the same function and both map to this one kernel):
//
//   out[b,i,h] = softmax_fp32(q[b,i,h].k[b,:,h]^T * sm_scale + bias[b,0,i,:])
//                . v[b,:,h]
//
// Every v1 mask quirk comes in through the bias (0 or -1e9), so the score
// is formed exactly as the dense path forms it: the fp32 product, scaled,
// plus the bias, in that order; a row whose every key is masked then
// averages v, as in the dense path.  The ragged K edge takes no weight
// (-inf): unlike the Pallas wrapper the host pads nothing.
//
// What bounds it on an H100: at the v1 512^2 cached step (B=4, Q=1026,
// K=1155, H=32, D=64) the work is that of omni attention (0.3 GFLOP and
// 0.4 MB of q/k/v per (b, h)), plus the bias: 4.7 MB per batch row, read
// once per head.  The design is the omni kernel's (attention_tile.cuh: one
// block per (b, h, 64-row q tile), 64-row K/V tiles, online softmax,
// mma.sync), with each thread reading its own bias entries straight from
// device memory through the bias's strides.  The caller passes the view
// attention_bias[:, :, P:, :P+S], whose row stride is the full sequence
// length, so no contiguous copy of the bias is ever made; the 19 MB of one
// layer's bias stay in the 50 MB L2 across the 32 heads.
//
// Grid (ceil(Q/64), H, B); block 128 threads; head dim 64.

#include "attention_tile.cuh"

namespace {

using tile::bf16;

struct Strides {  // in elements: batch, row, head
  long long b, r, h;
};

__global__ void __launch_bounds__(tile::THREADS, 4)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        const float* __restrict__ bias, int Q, int K,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        long long bias_sb, long long bias_sr, float sm_scale) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + K_OFF;
  bf16* Vt = Qs + V_OFF;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;

  load_q(Qs, q + b * qs.b + h * qs.h, qs.r, q0, Q);
  __syncthreads();
  uint32_t qf[KD][4];
  q_fragments(Qs, qf);

  // this thread's bias rows (a row past Q reads row 0 and is not stored)
  const int row0 = q0 + tile_row(), row1 = row0 + 8;
  const float* bias0 =
      bias + b * bias_sb + (long long)(row0 < Q ? row0 : 0) * bias_sr;
  const float* bias1 =
      bias + b * bias_sb + (long long)(row1 < Q ? row1 : 0) * bias_sr;
  const int t4 = threadIdx.x & 3;

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    load_kv(Ks, Vt, kh, ks.r, vh, vs.r, k0, K);
    __syncthreads();
    float s[NK][4];
    scores(qf, Ks, s);
    // scale, add the bias, into the log2 domain
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + t4 * 2 + e;
        float x0 = -INFINITY, x1 = -INFINITY;
        if (j < K) {
          x0 = (s[n][e] * sm_scale + __ldg(bias0 + j)) * LOG2E;
          x1 = (s[n][2 + e] * sm_scale + __ldg(bias1 + j)) * LOG2E;
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

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements (batch, row, head for q/k/v/out; batch, row for
// the bias); the last dim of every operand is contiguous; the head dim is
// 64.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, void* out, const float* bias,
    int B, int Q, int K, int H, int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    long long bias_sb, long long bias_sr, float sm_scale, void* stream) {
  if (head_dim != tile::D) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Q + tile::BLOCK_Q - 1) / tile::BLOCK_Q, H, B);
  decode_attention_kernel<<<grid, tile::THREADS, tile::TILE_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), bias, Q, K,
      {q_sb, q_sr, q_sh}, {k_sb, k_sr, k_sh}, {v_sb, v_sr, v_sh},
      {o_sb, o_sr, o_sh}, bias_sb, bias_sr, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
