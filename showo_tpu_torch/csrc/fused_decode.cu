// The cached MaskGIT step's attention, for Hopper (sm_90a): per-head q/k
// LayerNorm, partial NeoX RoPE, the [prefix | fresh] K/V concat and
// omni-masked attention, read straight off the fused ``win`` projection
// output (kernel 2).  bf16 in and out, fp32 LayerNorm, scores, softmax and
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
// Two launches, which together compute what the Pallas _kernel computes:
//   1. norm_rope_kernel, one pass over the fresh rows: the q and k column
//      blocks of y (read through its row stride, 3*2048 + 8192 = 14336
//      columns at full width) normed and roped into qn, kn [B, S, hidden]
//      bf16, contiguous.  At the 512^2 step (B=4, S=1026, hidden 2048)
//      33.6 MB read and 33.6 MB written, ~0.020 ms at 3.35 TB/s.
//   2. the wgmma forward core of attention_fwd_sm90.cuh at <64, MASK_MEAN>
//      with SPLIT: Q from qn; K rows j < P from the cache view ck and rows
//      j >= P from kn, V rows j < P from cv and rows j >= P from y's v
//      block, chosen per row in the 16-byte copies (P = 129 is not a
//      multiple of 64: the tile 128..191 takes row 128 from the cache);
//      the keys at pos_k, staged per K tile beside their seg / pad; on a
//      tile map of the K = P + S keys (fused_decode_tiles, made once per
//      forward by models/phi.py attn_step), whose flag sends the blocks of
//      q tiles holding a row with no visible key over every tile.  Bound:
//      the attention's products, 0.035 ms at the bf16 peak (as kernel 1).
// The first kernel 2 (one mma.sync block per (b, h, 64-row q tile)) normed
// and roped every fresh K tile again in each of a head's q-tile blocks (17
// times at 512^2), on synchronously loaded tiles, visiting every K tile:
// the pass here does each row once, and the core streams the visible tiles
// through a cp.async ring.  ck / cv are read through the batch stride of
// the cache views and y's v block through y's row stride, so the host
// copies nothing; the wrapper raises where those are not 16-byte aligned.
//
// Head dim 64, rotary dim 32.

#include "attention_fwd_sm90.cuh"

namespace fused {

using tile::bf16;

constexpr int D = 64;
constexpr int ROT = 32;  // rotary dims (Phi-1.5: partial_rotary_factor 0.5)
static_assert(ROT == 32, "the rope lane exchange below assumes ROT == 32");
constexpr int THREADS = 128;
constexpr int ROWS = THREADS / 8;  // head rows a block normalises at once

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

struct NormArgs {
  const bf16* y;      // [B, S, >= 2*hidden]: the q and k column blocks
  const bf16* ln[4];  // q scale, q shift, k scale, k shift: [D] each
  const float* cos;   // [S, ROT]
  const float* sin;
  bf16* qn;           // [B, S, hidden], contiguous
  bf16* kn;
  int S, H;
  long long y_sb, y_sr;
  float eps;
};

// Grid (B * S): one block per fresh row, its 2H head rows (the q heads,
// then the k heads) ROWS at a time, 8 lanes a head row.
__global__ void __launch_bounds__(THREADS)
norm_rope_kernel(const NormArgs a) {
  __shared__ float ln_s[4 * D];
  for (int i = threadIdx.x; i < 4 * D; i += THREADS)
    ln_s[i] = __bfloat162float(a.ln[i / D][i % D]);
  __syncthreads();
  const int row = blockIdx.x, b = row / a.S, i = row - b * a.S;
  const int chunk = threadIdx.x & 7;
  const long long hidden = (long long)a.H * D;
  const bf16* yr = a.y + b * a.y_sb + i * a.y_sr;
  const float* cs = a.cos + (long long)i * ROT;
  const float* sn = a.sin + (long long)i * ROT;
  // every lane runs every pass: ln_rope's shuffles take the whole warp
  for (int base = 0; base < 2 * a.H; base += ROWS) {
    const int hr = base + threadIdx.x / 8;
    const bool ok = hr < 2 * a.H;
    const int kq = hr >= a.H ? 1 : 0;  // 0: a q head, 1: a k head
    const long long col = (long long)(hr - kq * a.H) * D + chunk * 8;
    float x[8];
    unpack(ok ? tile::ld16(yr + kq * hidden + col)
              : make_uint4(0u, 0u, 0u, 0u), x);
    const uint4 o = ln_rope(x, chunk, ln_s + 2 * kq * D,
                            ln_s + (2 * kq + 1) * D, a.eps, cs, sn);
    if (ok)
      *reinterpret_cast<uint4*>((kq ? a.kn : a.qn) + row * hidden + col) = o;
  }
}

}  // namespace fused

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// strides are in elements; the last dim of every operand is contiguous;
// head dim 64.  Each returns the cudaError_t of its launch (0 = launched)
// on ``stream``.

// The tile map (agrad90::rows_tile_map_kernel) of the K = P + S keys at
// positions pos_k [K], with seg_k / pad_k [B, K] and the q rows' pos_q /
// seg_q [B, S] (int32): uint8 [B, ceil(S / 64), ceil(K / 64) + 1].
extern "C" int fused_decode_tiles(
    const int* seg_k, const int* pad_k, const int* last_pad,
    const int* prefix, const int* pos_k, const int* pos_q, const int* seg_q,
    unsigned char* tiles, int B, int Q, int K, void* stream) {
  if (B <= 0 || Q <= 0 || K <= 0 || pos_k == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return agrad90::launch_rows_tile_map({seg_k, pad_k, last_pad, prefix,
                                        pos_k}, {pos_q, seg_q}, B, Q, K,
                                       tiles, stream);
}

// The LayerNorm + RoPE pass: y [B, S, >= 2*hidden] (batch / row strides
// y_sb / y_sr) -> qn, kn [B, S, hidden] contiguous; the LayerNorm affine
// (q_w, q_b, k_w, k_b) bf16 [64] each; cos / sin fp32 [S, 32].
extern "C" int fused_decode_norm_rope_bf16(
    const void* y, const void* q_w, const void* q_b, const void* k_w,
    const void* k_b, const float* cos, const float* sin, void* qn, void* kn,
    int B, int S, int H, int head_dim, int rotary_dim, long long y_sb,
    long long y_sr, float eps, void* stream) {
  if (head_dim != fused::D || rotary_dim != fused::ROT || B <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fused::NormArgs a;
  a.y = static_cast<const tile::bf16*>(y);
  a.ln[0] = static_cast<const tile::bf16*>(q_w);
  a.ln[1] = static_cast<const tile::bf16*>(q_b);
  a.ln[2] = static_cast<const tile::bf16*>(k_w);
  a.ln[3] = static_cast<const tile::bf16*>(k_b);
  a.cos = cos;
  a.sin = sin;
  a.qn = static_cast<tile::bf16*>(qn);
  a.kn = static_cast<tile::bf16*>(kn);
  a.S = S;
  a.H = H;
  a.y_sb = y_sb;
  a.y_sr = y_sr;
  a.eps = eps;
  fused::norm_rope_kernel<<<B * S, fused::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The attention on the forward core: qn, kn from the pass above; y's v
// block (columns 2*hidden on, strides y_sb / y_sr) for the fresh V rows;
// ck / cv [B, P, hidden] cache views (strides ck_sb / ck_sr, cv_sb /
// cv_sr); out [B, S, hidden] (strides o_sb / o_sr); the metadata int32 as
// for fused_decode_tiles; ``tiles``: that map.
extern "C" int fused_decode_attention_bf16(
    const void* qn, const void* kn, const void* y, const void* ck,
    const void* cv, void* out, const int* seg_k, const int* pad_k,
    const int* last_pad, const int* prefix, const int* pos_k,
    const int* pos_q, const int* seg_q, const unsigned char* tiles, int B,
    int S, int P, int H, int head_dim, long long y_sb, long long y_sr,
    long long ck_sb, long long ck_sr, long long cv_sb, long long cv_sr,
    long long o_sb, long long o_sr, float sm_scale, void* stream) {
  if (head_dim != fused::D || tiles == nullptr || pos_k == nullptr || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long d = fused::D, hidden = H * d;
  const tile::Strides fresh{S * hidden, d, hidden};
  const agrad90::Split split{
      static_cast<const tile::bf16*>(kn),
      static_cast<const tile::bf16*>(y) + 2 * hidden, fresh,
      {y_sb, d, y_sr}, P};
  return agrad90::launch_fwd<64, agrad90::MASK_MEAN, true>(
      qn, ck, cv, out, nullptr, {seg_k, pad_k, last_pad, prefix, pos_k},
      {pos_q, seg_q}, {}, tiles, true, B, S, P + S, H, H, fresh,
      {ck_sb, d, ck_sr}, {cv_sb, d, cv_sr}, {o_sb, d, o_sr}, sm_scale, 0.f,
      stream, split);
}
