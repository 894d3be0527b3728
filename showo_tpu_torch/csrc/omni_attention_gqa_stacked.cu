// GQA-stacked omni-masked attention on the packed [B, S, H*D] layout
// (kernel 6), for Hopper (sm_90a), bf16 in and out, fp32 scores, softmax
// and accumulation.
//
// Replaces showo_tpu/ops/flash_attention.py::_omni_attention_gqa_stacked
// (its pallas_call at :399).  It computes the function of kernel 1
// (omni_attention_packed.cu):
//
//   visible(b,i,j) = [ j <= pos_q[b,i]
//                    | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
//                    | j < prefix[b] ]
//                  & ( pad[b,j] == 0 | pos_q[b,i] <= last_pad[b] )
//   out = softmax_fp32(q.k^T * sm_scale, masked) . v
//
// A masked score is -1e30 (not -inf), so a row with no visible column
// averages v over all S columns, as the plain version does; columns past S
// are -inf and take no weight.  What the TPU version buys is one K/V load
// shared by the G q heads of a kv head: it stacks those heads' rows (row
// g*Qp + pos) into one tall q block.  It does so with HBM transposes into
// a [B, Hkv, D, G*Qp] layout (:362-366, :410-412) that only Mosaic's lane
// tiling needed; here the block reads the packed layout through its
// strides.
//
// What bounds it on an H100: 4*D FLOP per visible (row, key) pair and head
// (0.028 ms at Show-o2's B=8, S=768 for Qwen's 12 q / 2 kv heads of 128,
// 0.037 ms for the DiT's 32 / 8 of 64, at the bf16 peak), with the K/V
// tile traffic from L2 into shared memory cut by G: kernel 1's G blocks of
// one kv head each load every K/V tile, here one block loads it for all G
// heads.
//
// Design: the first tile core of attention_tile.cuh (mma.sync on
// synchronously loaded K/V tiles, every tile visited and masked); the
// other attention kernels run the wgmma forward core of
// attention_fwd_sm90.cuh.  One block per (64/G-row-rounded q block, kv
// head, batch).  The block holds QB q positions of all G heads of its kv
// head, stacked as rows g*QB + p of one shared-memory Q tile, QB = 16 *
// max(1, 8 / G) (a warp's 16 rows never straddle two heads); G*QB/16 warps
// (6 at G=6, 8 at G=4), each running the tile core on its 16 rows against
// every 64-key K/V tile, which is loaded once into shared memory for the
// whole block.  Groups above 8 are not taken (the wrapper raises).
//
// Grid (ceil(Q/QB), Hkv, B); block G*QB/16 warps.

#include "attention_tile.cuh"

namespace gqa {

using tile::bf16;
using tile::Strides;

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

// Allow ``kernel`` ``bytes`` of dynamic shared memory on the current device
// where that is above the default 48 KB (the attribute is the device's, so
// it is set at every launch): head dim 128.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

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
  const Row r0 = load_row(pos_q, seg_q, b, row0, Q, lp);
  const Row r1 = load_row(pos_q, seg_q, b, row0 + 8, Q, lp);

  float o[G::ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < G::ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    load_kv<HD>(Ks, Vt, kh, ks.r, vh, vs.r, k0, S, nthreads);
    load_tile_meta(seg_s, pad_s, seg, pad, b, k0, S);
    __syncthreads();
    float s[NK][4];
    scores<HD>(qf, Ks, s);
    mask_logits(s, k0, S, seg_s, pad_s, r0, r1, pf, scale_log2);
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
  const cudaError_t set = allow_smem(gqa_stacked_kernel<HD>, bytes);
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
