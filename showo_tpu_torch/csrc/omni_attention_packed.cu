// Omni-masked attention on the packed [B, S, H*D] projection layout, for
// Hopper (sm_90a), bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::omni_attention_packed (Pallas
// kernel _attn_kernel_packed).  The mask is recomputed in the kernel from
// O(S) span metadata instead of reading a [B, 1, Q, S] bias:
//
//   visible(b,i,j) = [ j <= pos_q[b,i]
//                    | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
//                    | j < prefix[b] ]
//                  & ( pad[b,j] == 0 | pos_q[b,i] <= last_pad[b] )
//   out = softmax_fp32(q.k^T / sqrt(D), masked) . v
//
// A masked score is -1e30 (not -inf), so a row with no visible column
// averages v over all S columns, as the plain version does; columns past
// S are -inf and take no weight.
//
// What bounds it on an H100: at the v1 512^2 cached step (B=4, Q=1026,
// S=1155, H=32, D=64) each (b, h) pair does 2*Q*S*D*2 = 0.3 GFLOP over
// 0.4 MB of q/k/v, so with D=64 a q tile performs ~64 FLOP per byte of
// K/V it reads from shared memory: small-D attention is bound by moving
// K/V through shared memory and by the launch shape, not by the tensor
// cores.  The design therefore (a) visits K/V in 64-row tiles with an
// online softmax, so no S-long score row and no [Q, S] bias ever touches
// device memory; (b) gives every (b, h, 64-row q tile) its own block
// (2176 blocks at the main shape, against 132 SMs) so the card is filled
// without a persistent scheduler; (c) keeps Q in registers for the
// whole K loop and computes both products with mma.sync m16n8k16 (bf16,
// fp32 accumulate); (d) masks the ragged Q and K edges in the kernel, so
// the host pads nothing.  TMA, wgmma and a pipelined K/V ring are later
// work.
//
// Grid (ceil(Q/64), H, B); block 128 threads = 4 warps x 16 q rows.
// GQA: kv head = h / (H / Hkv).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;  // head dim (Show-o v1, Phi-1.5)
constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Q tile, K tile, V^T tile (bf16, padded rows), seg / pad of the K tile:
// 28160 bytes, under the 48 KB a launch may take without an attribute
constexpr int SMEM_BYTES =
    (BLOCK_Q * (D + 8) + BLOCK_K * (D + 8) + D * (BLOCK_K + 8)) * 2 +
    2 * BLOCK_K * 4;
static_assert(SMEM_BYTES <= 48 * 1024, "dynamic smem above the default");

__global__ void __launch_bounds__(THREADS)
omni_attention_packed_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ seg, const int* __restrict__ pad,
    const int* __restrict__ last_pad, const int* __restrict__ prefix,
    const int* __restrict__ pos_q, const int* __restrict__ seg_q,
    int Q, int S, int group,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    float scale_log2) {
  constexpr int DP = D + 8;        // padded smem row of Q / K (bf16)
  constexpr int KP = BLOCK_K + 8;  // padded smem row of V^T (bf16)
  constexpr int CH = D / 8;        // 16-byte chunks in one head row
  constexpr int KD = D / 16;       // k-steps of Q.K^T
  constexpr int NK = BLOCK_K / 8;  // n-tiles of the score tile
  constexpr int ND = D / 8;        // n-tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BLOCK_Q * DP;
  __nv_bfloat16* Vt = Ks + BLOCK_K * DP;
  int* seg_s = reinterpret_cast<int*>(Vt + D * KP);
  int* pad_s = seg_s + BLOCK_K;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qb = q + b * q_sb + (long long)h * D;
  const __nv_bfloat16* kb = k + b * k_sb + (long long)kvh * D;
  const __nv_bfloat16* vb = v + b * v_sb + (long long)kvh * D;

  // ---- Q tile -> smem -> registers (A fragments, kept for the K loop)
  for (int c = tid; c < BLOCK_Q * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Q)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_sr + cc);
    *reinterpret_cast<uint4*>(Qs + r * DP + cc) = val;
  }
  __syncthreads();

  const int rl = warp * 16 + g;  // this thread's rows: rl and rl + 8
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = lds32(Qs + rl * DP + c);
    qf[kk][1] = lds32(Qs + (rl + 8) * DP + c);
    qf[kk][2] = lds32(Qs + rl * DP + c + 8);
    qf[kk][3] = lds32(Qs + (rl + 8) * DP + c + 8);
  }

  const int rowA = q0 + rl, rowB = rowA + 8;
  int posA = 0, posB = 0, sqA = 0, sqB = 0;
  if (rowA < Q) { posA = pos_q[(long long)b * Q + rowA]; sqA = seg_q[(long long)b * Q + rowA]; }
  if (rowB < Q) { posB = pos_q[(long long)b * Q + rowB]; sqB = seg_q[(long long)b * Q + rowB]; }
  const int lp = last_pad[b], pf = prefix[b];
  const bool padokA = posA <= lp, padokB = posB <= lp;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    // ---- K tile -> Ks [key][d]; V tile -> Vt [d][key]; metadata
    for (int c = tid; c < BLOCK_K * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_sr + cc);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_sr + cc);
      }
      *reinterpret_cast<uint4*>(Ks + r * DP + cc) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(cc + e) * KP + r] = ve[e];
    }
    if (tid < BLOCK_K) {
      const int j = k0 + tid;
      seg_s[tid] = j < S ? seg[(long long)b * S + j] : 0;
      pad_s[tid] = j < S ? pad[(long long)b * S + j] : 0;
    }
    __syncthreads();

    // ---- scores: 16 rows x 64 keys per warp
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (n * 8 + g) * DP + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_16816(s[n], qf[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
    }

    // ---- mask, scale (log2 domain), running max
    float tmaxA = -INFINITY, tmaxB = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = n * 8 + t4 * 2 + e;
        const int j = k0 + jl;
        float xA = -INFINITY, xB = -INFINITY;
        if (j < S) {
          const int sj = seg_s[jl];
          const bool pj = pad_s[jl] != 0;
          const bool vA = ((j <= posA) || (sqA > 0 && sqA == sj) || (j < pf)) &&
                          (!pj || padokA);
          const bool vB = ((j <= posB) || (sqB > 0 && sqB == sj) || (j < pf)) &&
                          (!pj || padokB);
          xA = vA ? s[n][e] * scale_log2 : MASKED;
          xB = vB ? s[n][2 + e] * scale_log2 : MASKED;
        }
        s[n][e] = xA;
        s[n][2 + e] = xB;
        tmaxA = fmaxf(tmaxA, xA);
        tmaxB = fmaxf(tmaxB, xB);
      }
    }
    // the 4 threads of a quad share rows
    tmaxA = fmaxf(tmaxA, __shfl_xor_sync(0xffffffffu, tmaxA, 1));
    tmaxA = fmaxf(tmaxA, __shfl_xor_sync(0xffffffffu, tmaxA, 2));
    tmaxB = fmaxf(tmaxB, __shfl_xor_sync(0xffffffffu, tmaxB, 1));
    tmaxB = fmaxf(tmaxB, __shfl_xor_sync(0xffffffffu, tmaxB, 2));
    // column k0 < S lies in every tile, so the new max is finite
    const float mnA = fmaxf(mA, tmaxA), mnB = fmaxf(mB, tmaxB);
    const float alphaA = exp2f(mA - mnA), alphaB = exp2f(mB - mnB);
    mA = mnA;
    mB = mnB;

    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = exp2f(s[n][0] - mnA);
      s[n][1] = exp2f(s[n][1] - mnA);
      s[n][2] = exp2f(s[n][2] - mnB);
      s[n][3] = exp2f(s[n][3] - mnB);
      sumA += s[n][0] + s[n][1];
      sumB += s[n][2] + s[n][3];
    }
    lA = lA * alphaA + sumA;
    lB = lB * alphaB + sumB;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alphaA;
      o[n][1] *= alphaA;
      o[n][2] *= alphaB;
      o[n][3] *= alphaB;
    }

    // ---- out += P . V   (P from the score registers, V^T from smem)
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vrow = Vt + (n * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_16816(o[n], a, lds32(vrow), lds32(vrow + 8));
      }
    }
  }

  // ---- normalise and store
  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  const float invA = 1.f / lA, invB = 1.f / lB;  // l >= 1: the max scores 1
  __nv_bfloat16* ob = out + b * o_sb + (long long)h * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (rowA < Q)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rowA * o_sr + c) =
          __floats2bfloat162_rn(o[n][0] * invA, o[n][1] * invA);
    if (rowB < Q)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rowB * o_sr + c) =
          __floats2bfloat162_rn(o[n][2] * invB, o[n][3] * invB);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements; the last dim of q/k/v/out is contiguous; the head
// dim is 64.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int omni_attention_packed_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q,
    int B, int Q, int S, int H, int Hkv, int head_dim,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    float sm_scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Q + BLOCK_Q - 1) / BLOCK_Q, H, B);
  omni_attention_packed_kernel<<<grid, THREADS, SMEM_BYTES,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      seg, pad, last_pad, prefix, pos_q, seg_q, Q, S, H / Hkv,
      q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
