// The cached MaskGIT step's attention in one kernel, for Hopper (sm_90a):
// per-head q/k LayerNorm, partial NeoX RoPE, the [prefix | fresh] K/V
// concat and omni-masked attention, read straight off the fused ``win``
// projection output.  bf16 in and out, fp32 LayerNorm, scores, softmax and
// accumulation.
//
// Replaces showo_tpu/ops/fused_decode.py::fused_decode_attention (Pallas
// kernel _kernel).  For batch b, head h, fresh row i (of S) and key j (of
// K = P + S):
//
//   q_i   = rope(ln_q(y[b, i, h*D : h*D+D]))
//   k_j   = ck[b, j]                                 j <  P (already normed
//         = rope(ln_k(y[b, j-P, hidden + h*D : ...]))  j >= P   and roped)
//   v_j   = cv[b, j]  or  y[b, j-P, 2*hidden + h*D : ...]
//   visible(i, j) = [ pos_k[j] <= pos_q[b,i]
//                   | (seg_q[b,i] == seg_k[b,j] & seg_q[b,i] > 0)
//                   | pos_k[j] < prefix[b] ]
//                 & ( pad_k[b,j] == 0 | pos_q[b,i] <= last_pad[b] )
//   out[b, i, h*D : h*D+D] = softmax_fp32(q_i.k^T * sm_scale, masked) . v
//
// Numerics follow the JAX kernel: LayerNorm in fp32, two-pass (mean, then
// centred variance), rsqrt(var + eps), the affine in fp32, then a cast to
// bf16; RoPE in bf16, each product and the sum rounded to bf16, as the
// storage-dtype JAX code computes it (the plain PyTorch version's bf16
// tensor ops round the same way).  A masked score is -1e30, so a row with
// nothing visible averages v over the K keys; columns past K take no weight.
//
// What bounds it on an H100: the attention itself is that of the omni
// kernel (at the 512^2 step, B=4, S=1026, K=1155, H=32, D=64: 0.3 GFLOP
// and 0.4 MB per (b, h)); what this kernel removes is the glue around it,
// each of which is a pass over device memory in the unfused route: the
// fp32 upcast, per-head LayerNorm and downcast of q and k, the rope halves
// and their concat, and the [prefix | fresh] concat of K and V (~10 kernel
// launches and ~100 MB of traffic per layer at that shape).  q, k and v are
// read through the row stride of ``y`` (3*2048 + 8192 = 14336 columns), and
// ck / cv through the batch stride of the cache views, so the host copies
// nothing.  The design is the omni kernel's (attention_tile.cuh: one block
// per (b, h, 64-row q tile), 64-row K/V tiles, online softmax, mma.sync);
// the Q tile is normed and roped once as it is loaded, and each fresh K row
// as its tile is loaded.  Every q-tile block of a head thus recomputes the
// LayerNorm and RoPE of that head's fresh K rows (17 times at 512^2): ~64
// FLOP per element against the 128 of Q.K^T and P.V, simpler than staging
// normalised K in device memory, which later work may do.
//
// Grid (ceil(S/64), H, B); block 128 threads; head dim 64, rotary dim 32.

#include "attention_tile.cuh"

namespace {

using tile::bf16;
using tile::D;
using tile::THREADS;

constexpr int ROT = 32;  // rotary dims (Phi-1.5: partial_rotary_factor 0.5)
static_assert(ROT == 32, "the rope lane exchange below assumes ROT == 32");

// tiles, then pos_k / seg_k / pad_k of the K tile, then the two
// LayerNorms' affine (q scale, q shift, k scale, k shift) in fp32
constexpr int SMEM_BYTES = tile::TILE_SMEM + 3 * tile::BLOCK_K * 4 + 4 * D * 4;
static_assert(SMEM_BYTES <= 48 * 1024, "dynamic smem above the default");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack(uint4 u, float x[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
}

// LayerNorm + RoPE of one head row held by 8 consecutive lanes, 8 dims
// each (dims 8*chunk .. 8*chunk+7, chunk = lane & 7).  Every lane of the
// warp must call it: the row reductions and the rope exchange are
// shuffles.  w / sh: the LayerNorm's scale and shift [D]; cs / sn: the
// row's rope tables [ROT].
__device__ __forceinline__ uint4 ln_rope(const float x[8], int chunk,
                                         const float* w, const float* sh,
                                         float eps, const float* cs,
                                         const float* sn) {
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) sum += x[e];
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  const float mean = sum * (1.f / D);
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += (x[e] - mean) * (x[e] - mean);
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  ss += __shfl_xor_sync(0xffffffffu, ss, 4);
  const float rs = rsqrtf(ss * (1.f / D) + eps);

  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = chunk * 8 + e;
    y[e] = round_bf16((x[e] - mean) * rs * w[d] + sh[d]);
  }
  // NeoX half rotation over the first ROT dims: dim d < ROT/2 pairs with
  // d + ROT/2, two chunks (lanes) away
  float p[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = __shfl_xor_sync(0xffffffffu, y[e], 2);
  if (chunk < ROT / 8) {
    const bool lower = chunk < ROT / 16;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = chunk * 8 + e;
      const float rot = lower ? -p[e] : p[e];
      y[e] = round_bf16(round_bf16(y[e] * round_bf16(cs[d])) +
                        round_bf16(rot * round_bf16(sn[d])));
    }
  }
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o2[e] = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
  return out;
}

struct Args {
  const bf16* y;     // [B, S, >= 3*hidden]
  const bf16* ck;    // [B, P, hidden] view
  const bf16* cv;
  bf16* out;         // [B, S, hidden]
  const bf16* ln[4];  // q scale, q shift, k scale, k shift: [D] each
  const float* cos;  // [S, ROT]
  const float* sin;
  const int* last_pad;  // [B]
  const int* prefix;    // [B]
  const int* pos_q;     // [B, S]
  const int* seg_q;     // [B, S]
  const int* pos_k;     // [K]
  const int* seg_k;     // [B, K]
  const int* pad_k;     // [B, K]
  int S, P;
  long long hidden, y_sb, y_sr, ck_sb, ck_sr, cv_sb, cv_sr, o_sb, o_sr;
  float eps, scale_log2;
};

__global__ void __launch_bounds__(THREADS, 4)
fused_decode_kernel(const Args a) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + K_OFF;
  bf16* Vt = Qs + V_OFF;
  int* posk_s = reinterpret_cast<int*>(smem + TILE_SMEM);
  int* segk_s = posk_s + BLOCK_K;
  int* padk_s = segk_s + BLOCK_K;
  float* ln_s = reinterpret_cast<float*>(padk_s + BLOCK_K);

  const int S = a.S, P = a.P, K = P + S;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const int chunk = threadIdx.x & 7;
  const bf16* yb = a.y + b * a.y_sb + (long long)h * D;

  for (int i = threadIdx.x; i < 4 * D; i += THREADS)
    ln_s[i] = __bfloat162float(a.ln[i / D][i % D]);
  __syncthreads();

  // ---- Q tile: LayerNorm + RoPE of the fresh rows as they are loaded
  for (int c = threadIdx.x; c < BLOCK_Q * CH; c += THREADS) {
    const int r = c / CH, row = q0 + r;
    const bool ok = row < S;
    float x[8];
    unpack(ok ? ld16(yb + (long long)row * a.y_sr + chunk * 8)
              : make_uint4(0u, 0u, 0u, 0u), x);
    const long long rr = ok ? row : 0;
    const uint4 qv = ln_rope(x, chunk, ln_s, ln_s + D, a.eps,
                             a.cos + rr * ROT, a.sin + rr * ROT);
    *reinterpret_cast<uint4*>(Qs + r * DP + chunk * 8) =
        ok ? qv : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t qf[KD][4];
  q_fragments(Qs, qf);

  const int row0 = q0 + tile_row(), row1 = row0 + 8;
  int pos0 = 0, pos1 = 0, sq0 = 0, sq1 = 0;
  if (row0 < S) {
    pos0 = a.pos_q[(long long)b * S + row0];
    sq0 = a.seg_q[(long long)b * S + row0];
  }
  if (row1 < S) {
    pos1 = a.pos_q[(long long)b * S + row1];
    sq1 = a.seg_q[(long long)b * S + row1];
  }
  const int lp = a.last_pad[b], pf = a.prefix[b];
  const bool padok0 = pos0 <= lp, padok1 = pos1 <= lp;
  const int t4 = threadIdx.x & 3;
  const bf16* ckh = a.ck + b * a.ck_sb + (long long)h * D;
  const bf16* cvh = a.cv + b * a.cv_sb + (long long)h * D;

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    // ---- K/V tile: cached prefix rows as they are, fresh rows normed and
    // roped (K) or taken as they are (V) from y
    for (int c = threadIdx.x; c < BLOCK_K * CH; c += THREADS) {
      const int r = c / CH, j = k0 + r, f = j - P;
      const bool fresh = j >= P && j < K;
      float x[8];
      unpack(fresh ? ld16(yb + (long long)f * a.y_sr + a.hidden + chunk * 8)
                   : make_uint4(0u, 0u, 0u, 0u), x);
      const long long ff = fresh ? f : 0;
      const uint4 kn = ln_rope(x, chunk, ln_s + 2 * D, ln_s + 3 * D, a.eps,
                               a.cos + ff * ROT, a.sin + ff * ROT);
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (fresh) {
        kv = kn;
        vv = ld16(yb + (long long)f * a.y_sr + 2 * a.hidden + chunk * 8);
      } else if (j < P) {
        kv = ld16(ckh + (long long)j * a.ck_sr + chunk * 8);
        vv = ld16(cvh + (long long)j * a.cv_sr + chunk * 8);
      }
      put_kv(Ks, Vt, r, chunk * 8, kv, vv);
    }
    if (threadIdx.x < BLOCK_K) {
      const int j = k0 + threadIdx.x;
      const bool ok = j < K;
      posk_s[threadIdx.x] = ok ? a.pos_k[j] : 0;
      segk_s[threadIdx.x] = ok ? a.seg_k[(long long)b * K + j] : 0;
      padk_s[threadIdx.x] = ok ? a.pad_k[(long long)b * K + j] : 0;
    }
    __syncthreads();
    float s[NK][4];
    scores(qf, Ks, s);
    // mask and scale into the log2 domain
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = n * 8 + t4 * 2 + e;
        float x0 = -INFINITY, x1 = -INFINITY;
        if (k0 + jl < K) {
          const int pk = posk_s[jl], sk = segk_s[jl];
          const bool pj = padk_s[jl] != 0;
          const bool v0 = ((pk <= pos0) || (sq0 > 0 && sq0 == sk) ||
                           (pk < pf)) && (!pj || padok0);
          const bool v1 = ((pk <= pos1) || (sq1 > 0 && sq1 == sk) ||
                           (pk < pf)) && (!pj || padok1);
          x0 = v0 ? s[n][e] * a.scale_log2 : MASKED;
          x1 = v1 ? s[n][2 + e] * a.scale_log2 : MASKED;
        }
        s[n][e] = x0;
        s[n][2 + e] = x1;
      }
    }
    softmax_update(s, m, l, o);
    pv(s, Vt, o);
  }
  store(a.out + b * a.o_sb + (long long)h * D, a.o_sr, q0, S, o, l);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements; the last dim of every operand is contiguous; the
// LayerNorm affine (q_w, q_b, k_w, k_b) is bf16 [64] each; head dim 64,
// rotary dim 32.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_decode_attention_bf16(
    const void* y, const void* ck, const void* cv, void* out,
    const void* q_w, const void* q_b, const void* k_w, const void* k_b,
    const float* cos, const float* sin, const int* last_pad,
    const int* prefix, const int* pos_q, const int* seg_q, const int* pos_k,
    const int* seg_k, const int* pad_k, int B, int S, int P, int H,
    int head_dim, int rotary_dim, long long y_sb, long long y_sr,
    long long ck_sb, long long ck_sr, long long cv_sb, long long cv_sr,
    long long o_sb, long long o_sr, float eps, float sm_scale, void* stream) {
  if (head_dim != D || rotary_dim != ROT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.y = static_cast<const bf16*>(y);
  a.ck = static_cast<const bf16*>(ck);
  a.cv = static_cast<const bf16*>(cv);
  a.out = static_cast<bf16*>(out);
  a.ln[0] = static_cast<const bf16*>(q_w);
  a.ln[1] = static_cast<const bf16*>(q_b);
  a.ln[2] = static_cast<const bf16*>(k_w);
  a.ln[3] = static_cast<const bf16*>(k_b);
  a.cos = cos;
  a.sin = sin;
  a.last_pad = last_pad;
  a.prefix = prefix;
  a.pos_q = pos_q;
  a.seg_q = seg_q;
  a.pos_k = pos_k;
  a.seg_k = seg_k;
  a.pad_k = pad_k;
  a.S = S;
  a.P = P;
  a.hidden = (long long)H * D;
  a.y_sb = y_sb;
  a.y_sr = y_sr;
  a.ck_sb = ck_sb;
  a.ck_sr = ck_sr;
  a.cv_sb = cv_sb;
  a.cv_sr = cv_sr;
  a.o_sb = o_sb;
  a.o_sr = o_sr;
  a.eps = eps;
  a.scale_log2 = sm_scale * tile::LOG2E;
  dim3 grid((S + tile::BLOCK_Q - 1) / tile::BLOCK_Q, H, B);
  fused_decode_kernel<<<grid, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
