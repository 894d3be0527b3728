// GQA-stacked omni-masked attention on the packed [B, S, H*D] layout, for
// Hopper (sm_90a), bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::_omni_attention_gqa_stacked
// (its pallas_call at :399).  It computes the function of the packed omni
// kernel (omni_attention.cuh: the mask predicate, -1e30 for a masked score,
// -inf past S).  What the TPU version buys is one K/V load shared by the G
// q heads of a kv head: it stacks those heads' rows (row g*Qp + pos) into
// one tall q block.  It does so with HBM transposes into a [B, Hkv, D,
// G*Qp] layout (:362-366, :410-412) that only Mosaic's lane tiling needed;
// here the block reads the packed layout through its strides.
//
// What bounds it on an H100: as the packed kernel (moving K/V through
// shared memory at D=64, a little more compute-heavy at D=128), with the
// K/V tile traffic from L2 into shared memory cut by G: the packed kernel's
// G blocks of one kv head each load every K/V tile, here one block loads it
// for all G heads.
//
// Design: one block per (64/G-row-rounded q block, kv head, batch).  The
// block holds QB q positions of all G heads of its kv head, stacked as rows
// g*QB + p of one shared-memory Q tile, QB = 16 * max(1, 8 / G) (a warp's 16
// rows never straddle two heads); G*QB/16 warps (6 at G=6, 8 at G=4), each
// running the tile core of attention_tile.cuh on its 16 rows against every
// 64-key K/V tile, which is loaded once into shared memory for the whole
// block.  Groups above 8 are not taken (the wrapper raises).
//
// Grid (ceil(Q/QB), Hkv, B); block G*QB/16 warps.

#include "omni_attention.cuh"

namespace gqa {

using tile::bf16;
using tile::Strides;

constexpr int MAX_WARPS = 8;

// q positions per block for group G: the stacked rows fill up to 8 warps
inline int positions(int group) {
  return 16 * (group >= MAX_WARPS ? 1 : MAX_WARPS / group);
}

// stacked Q tile [rows][DP], K tile, V^T tile, seg / pad of the K tile
template <int HD>
constexpr int smem_bytes(int rows) {
  using G = tile::Geom<HD>;
  return (rows * G::DP + tile::BLOCK_K * G::DP + HD * tile::KP) * 2 +
         2 * tile::BLOCK_K * 4;
}

template <int HD>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gqa_stacked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   const int* __restrict__ seg, const int* __restrict__ pad,
                   const int* __restrict__ last_pad,
                   const int* __restrict__ prefix,
                   const int* __restrict__ pos_q,
                   const int* __restrict__ seg_q, int Q, int S, int group,
                   int qb, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale_log2) {
  using namespace tile;
  using G = Geom<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = group * qb;
  const int nthreads = blockDim.x;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + rows * G::DP;
  bf16* Vt = Ks + BLOCK_K * G::DP;
  int* seg_s = reinterpret_cast<int*>(Vt + HD * KP);
  int* pad_s = seg_s + BLOCK_K;

  const int q0 = blockIdx.x * qb;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const bf16* kh = k + b * ks.b + kvh * ks.h;
  const bf16* vh = v + b * vs.b + kvh * vs.h;
  const bf16* qb_base = q + b * qs.b + (long long)kvh * group * qs.h;

  // stacked row r = g*qb + p <- q[b, q0 + p, head kvh*group + g]; zeros
  // past Q
  for (int c = threadIdx.x; c < rows * G::CH; c += nthreads) {
    const int r = c / G::CH, cc = (c % G::CH) * 8;
    const int g = r / qb, p = r - g * qb;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + p < Q)
      val = ld16(qb_base + g * qs.h + (long long)(q0 + p) * qs.r + cc);
    *reinterpret_cast<uint4*>(Qs + r * G::DP + cc) = val;
  }
  __syncthreads();
  uint32_t qf[G::KD][4];
  q_fragments<HD>(Qs, qf);

  // this thread's rows: stacked rows tile_row() and + 8, one head g (qb is
  // a multiple of 16), positions q0 + p and + 8
  const int g = tile_row() / qb;
  const int row0 = q0 + tile_row() - g * qb;
  const int lp = last_pad[b], pf = prefix[b];
  const omni::Row r0 = omni::load_row(pos_q, seg_q, b, row0, Q, lp);
  const omni::Row r1 = omni::load_row(pos_q, seg_q, b, row0 + 8, Q, lp);

  float o[G::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < G::ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    load_kv<HD>(Ks, Vt, kh, ks.r, vh, vs.r, k0, S, nthreads);
    omni::load_tile_meta(seg_s, pad_s, seg, pad, b, k0, S);
    __syncthreads();
    float s[NK][4];
    scores<HD>(qf, Ks, s);
    omni::mask_logits(s, k0, S, seg_s, pad_s, r0, r1, pf, scale_log2);
    softmax_update<HD>(s, m, l, o);
    pv<HD>(s, Vt, o);
  }
  quad_sum(l);
  // l >= 1: the row's max contributes exp2(0)
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows<HD>(out + b * os.b + (long long)(kvh * group + g) * os.h, os.r,
                 row0, Q, o, inv);
}

template <int HD>
inline int launch(const void* q, const void* k, const void* v, void* out,
                  const int* seg, const int* pad, const int* last_pad,
                  const int* prefix, const int* pos_q, const int* seg_q,
                  int B, int Q, int S, int Hkv, int group, Strides qs,
                  Strides ks, Strides vs, Strides os, float sm_scale,
                  void* stream) {
  const int qb = positions(group);
  const int warps = group * qb / 16;
  if (group < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes<HD>(group * qb);
  const cudaError_t set = omni::allow_smem(gqa_stacked_kernel<HD>, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  dim3 grid((Q + qb - 1) / qb, Hkv, B);
  gqa_stacked_kernel<HD><<<grid, warps * 32, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seg, pad,
      last_pad, prefix, pos_q, seg_q, Q, S, group, qb, qs, ks, vs, os,
      sm_scale * tile::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gqa

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// strides are in elements (batch, row; the head stride is the head dim);
// the last dim of q/k/v/out is contiguous; the head dim is 64 or 128; the
// group H / Hkv is 1..8.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int omni_attention_gqa_stacked_bf16(
    const void* q, const void* k, const void* v, void* out,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    const int* pos_q, const int* seg_q,
    int B, int Q, int S, int H, int Hkv, int head_dim,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    float sm_scale, void* stream) {
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const long long d = head_dim;
  const tile::Strides qs{q_sb, d, q_sr}, ks{k_sb, d, k_sr},
      vs{v_sb, d, v_sr}, os{o_sb, d, o_sr};
  if (head_dim == 64)
    return gqa::launch<64>(q, k, v, out, seg, pad, last_pad, prefix, pos_q,
                           seg_q, B, Q, S, Hkv, H / Hkv, qs, ks, vs, os,
                           sm_scale, stream);
  if (head_dim == 128)
    return gqa::launch<128>(q, k, v, out, seg, pad, last_pad, prefix, pos_q,
                            seg_q, B, Q, S, Hkv, H / Hkv, qs, ks, vs, os,
                            sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
