// Trainable omni-masked self-attention on the packed [B, S, H*D] layout, for
// Hopper (sm_90a): a forward that also writes the per-(head, row)
// logsumexp, and the two backward kernels (dq; dk and dv).  bf16 operands,
// fp32 scores, softmax and accumulation.
//
// Replaces showo_tpu/ops/packed_attention_grad.py: the Pallas kernels
// _fwd_kernel (call in _fwd), _dq_kernel and _dkv_kernel (calls in _bwd).
//
//   visible(b,i,j) = [ j <= i | (seg[b,i] == seg[b,j] & seg[b,i] > 0)
//                    | j < prefix[b] ]
//                  & ( pad[b,j] == 0 | i <= last_pad[b] ) & i, j < S
//   forward:  out = softmax(q.k^T * sm_scale, masked) . v
//             lse = logsumexp of the visible scores
//   backward: P = exp(q.k^T * sm_scale - lse) on visible entries, else 0
//             dP = dO . v^T,  delta = rowsum(dO * O)  (per head, computed by
//             the caller),  dS = P * (dP - delta) * sm_scale
//             dq = dS . k,  dk = dS^T . q,  dv = P^T . dO
//
// A row with no visible key gets out = 0 and lse = 1e9 (the JAX kernel's
// -NEG_INF sentinel), and P = 0 in the backward, as in the Pallas kernels.
// Masked scores are -inf here, so such rows never average v (the inference
// kernels of omni_attention.cuh do average it).
//
// What bounds it on an H100 at the v1 stage-1 step (B=29, S=387, H=32,
// D=64): per layer the forward reads q, k, v and writes out (184 MB) for at
// most 3.6e10 FLOP, the dq kernel moves 230 MB for at most 5.3e10 FLOP and
// the dk/dv kernel 276 MB for at most 7.1e10 FLOP; all three sit near the
// 295 FLOP/byte ridge, so both the bytes and the tensor-core rate matter.
// The design:
//   * every score stays on chip; one block per (batch, head, 64-row tile),
//     6496 blocks at the stage-1 shape against 132 SMs, so no persistent
//     scheduler is needed;
//   * the mask is computed once per tile into a 32-bit map per thread (two
//     rows x 16 columns) from the O(S) metadata, and a tile with no visible
//     entry is skipped by the whole block (__syncthreads_or) before its
//     operands are loaded, in all three kernels;
//   * dq walks the K/V tiles of one (b, h, q tile) and recomputes P from q,
//     k and the forward's lse; dk/dv walks the q tiles of one (b, kv head,
//     k tile) and sums the GQA group's heads in registers, in fp32, so no
//     atomics and no second pass;
//   * dk/dv computes S^T = K.Q^T with the block's K rows as the A operand,
//     so P^T and dS^T come out of the tensor cores already in the layout
//     of the A operand of P^T.dO and dS^T.Q.
// mma.sync m16n8k16 (attention_tile.cuh); wgmma, TMA and pipelined tile
// rings are later work.  Head dim 64.

#include "attention_tile.cuh"

namespace pag {

using namespace tile;

constexpr float SENTINEL = 1e9f;  // lse of a row with no visible key
constexpr float LN2 = 0.6931471805599453f;
constexpr int TILE = BLOCK_Q * DP;  // one 64 x 64 tile, padded rows (bf16)
static_assert(BLOCK_Q == BLOCK_K && DP == KP, "square tiles");

struct Meta {
  const int* seg;
  const int* pad;
  const int* last_pad;
  const int* prefix;
};

// The thread's rows of the mma accumulators: tile_row() and tile_row() + 8.
// Column of accumulator entry (n, e): n * 8 + (lane % 4) * 2 + e.
__device__ __forceinline__ int acc_col(int n, int e) {
  return n * 8 + (threadIdx.x & 3) * 2 + e;
}
__device__ __forceinline__ int bit(int r, int n, int e) {
  return r * 16 + n * 2 + e;
}

// Stage seg / pad of rows [r0, r0 + 64) of batch row b into shared memory
// (zeros past S).
__device__ __forceinline__ void stage_meta(int* seg_s, int* pad_s,
                                           const Meta& mt, int b, int r0,
                                           int S) {
  if (threadIdx.x < BLOCK_K) {
    const int j = r0 + threadIdx.x;
    seg_s[threadIdx.x] = j < S ? mt.seg[(long long)b * S + j] : 0;
    if (pad_s) pad_s[threadIdx.x] = j < S ? mt.pad[(long long)b * S + j] : 0;
  }
}

// Visibility map of a tile whose accumulator rows are query rows
// (forward, dq): rows qi[r] with segment sq[r], columns k0 + c with their
// seg / pad staged in smem.
__device__ __forceinline__ uint32_t query_rows_map(
    const int qi[2], const int sq[2], const bool padok[2], int k0, int S,
    int pf, const int* seg_s, const int* pad_s) {
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = acc_col(n, e), j = k0 + c;
      if (j >= S) continue;
      const int sj = seg_s[c];
      const bool pj = pad_s[c] != 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool v = qi[r] < S &&
                       ((j <= qi[r]) || (sq[r] > 0 && sq[r] == sj) ||
                        (j < pf)) &&
                       (!pj || padok[r]);
        bits |= (uint32_t)v << bit(r, n, e);
      }
    }
  }
  return bits;
}

// ---------------------------------------------------------------------------
// forward: out, lse
// ---------------------------------------------------------------------------

constexpr int FWD_SMEM = TILE_SMEM + 2 * BLOCK_K * 4;

__global__ void __launch_bounds__(THREADS, 4)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out,
           float* __restrict__ lse, Meta mt, int S, int H, int group,
           float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + K_OFF;
  bf16* Vt = Qs + V_OFF;
  int* seg_s = reinterpret_cast<int*>(smem + TILE_SMEM);
  int* pad_s = seg_s + BLOCK_K;

  const int q0 = blockIdx.x * BLOCK_Q, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D, KVD = (H / group) * D;
  const long long qrow = HD, krow = KVD;
  const bf16* qh = q + (long long)b * S * HD + h * D;
  const bf16* kh = k + (long long)b * S * KVD + (h / group) * D;
  const bf16* vh = v + (long long)b * S * KVD + (h / group) * D;

  load_q(Qs, qh, qrow, q0, S);
  __syncthreads();
  uint32_t qf[KD][4];
  q_fragments(Qs, qf);

  int qi[2], sq[2];
  bool padok[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + tile_row() + 8 * r;
    sq[r] = qi[r] < S ? mt.seg[(long long)b * S + qi[r]] : 0;
    padok[r] = qi[r] <= lp;
  }

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    stage_meta(seg_s, pad_s, mt, b, k0, S);
    __syncthreads();
    const uint32_t vis =
        query_rows_map(qi, sq, padok, k0, S, pf, seg_s, pad_s);
    if (!__syncthreads_or(vis != 0u)) continue;
    load_kv(Ks, Vt, kh, krow, vh, krow, k0, S);
    __syncthreads();
    float s[NK][4];
    scores(qf, Ks, s);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[n][c] = (vis >> bit(c >> 1, n, c & 1)) & 1u ? s[n][c] * scale_log2
                                                       : -INFINITY;
    softmax_update(s, m, l, o);
    pv(s, Vt, o);
  }

  quad_sum(l);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if ((threadIdx.x & 3) == 0 && qi[r] < S)
      lse[((long long)b * H + h) * S + qi[r]] =
          l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : SENTINEL;
  }
  store_scaled(out + (long long)b * S * HD + h * D, qrow, q0, S, o, inv);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// Q / dO staging tile, K tile, K^T tile, V tile; then seg / pad of the K tile
constexpr int DQ_SMEM = 4 * TILE * 2 + 2 * BLOCK_K * 4;

__global__ void __launch_bounds__(THREADS, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Meta mt, int S, int H, int group,
          float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* QD = reinterpret_cast<bf16*>(smem);
  bf16* Ks = QD + TILE;
  bf16* Kt = Ks + TILE;
  bf16* Vs = Kt + TILE;
  int* seg_s = reinterpret_cast<int*>(smem + 4 * TILE * 2);
  int* pad_s = seg_s + BLOCK_K;

  const int q0 = blockIdx.x * BLOCK_Q, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D, KVD = (H / group) * D;
  const long long qrow = HD, krow = KVD;
  const long long qoff = (long long)b * S * HD + h * D;
  const bf16* kh = k + (long long)b * S * KVD + (h / group) * D;
  const bf16* vh = v + (long long)b * S * KVD + (h / group) * D;
  const float scale_log2 = sm_scale * LOG2E;

  uint32_t qf[KD][4], df[KD][4];
  load_q(QD, q + qoff, qrow, q0, S);
  __syncthreads();
  q_fragments(QD, qf);
  __syncthreads();
  load_q(QD, dout + qoff, qrow, q0, S);
  __syncthreads();
  q_fragments(QD, df);

  int qi[2], sq[2];
  bool padok[2];
  float lse2[2], dl[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + tile_row() + 8 * r;
    const bool in = qi[r] < S;
    const long long hr = ((long long)b * H + h) * S + qi[r];
    sq[r] = in ? mt.seg[(long long)b * S + qi[r]] : 0;
    padok[r] = qi[r] <= lp;
    lse2[r] = in ? lse[hr] * LOG2E : 0.f;
    dl[r] = in ? delta[hr] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is consumed
    stage_meta(seg_s, pad_s, mt, b, k0, S);
    __syncthreads();
    const uint32_t vis =
        query_rows_map(qi, sq, padok, k0, S, pf, seg_s, pad_s);
    if (!__syncthreads_or(vis != 0u)) continue;
    load_kv(Ks, Kt, kh, krow, kh, krow, k0, S);
    load_q(Vs, vh, krow, k0, S);
    __syncthreads();
    float s[NK][4], dp[NK][4];
    scores(qf, Ks, s);
    scores(df, Vs, dp);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = (vis >> bit(r, n, c & 1)) & 1u
                            ? exp2f(s[n][c] * scale_log2 - lse2[r])
                            : 0.f;
        s[n][c] = p * (dp[n][c] - dl[r]) * sm_scale;  // dS
      }
    pv(s, Kt, acc);  // dq += dS . K
  }
  const float one[2] = {1.f, 1.f};
  store_scaled(dq + qoff, qrow, q0, S, acc, one);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

// Q, Q^T, dO, dO^T tiles; then seg, lse, delta of the q tile's rows
constexpr int DKV_SMEM = 4 * TILE * 2 + 3 * BLOCK_Q * 4;

__global__ void __launch_bounds__(THREADS, 2)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, Meta mt, int S,
           int H, int group, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Qt = Qs + TILE;
  bf16* Ds = Qt + TILE;
  bf16* Dt = Ds + TILE;
  int* segq_s = reinterpret_cast<int*>(smem + 4 * TILE * 2);
  float* lse_s = reinterpret_cast<float*>(segq_s + BLOCK_Q);
  float* dl_s = lse_s + BLOCK_Q;

  const int k0 = blockIdx.x * BLOCK_K, kvh = blockIdx.y, b = blockIdx.z;
  const int HD = H * D, KVD = (H / group) * D;
  const long long qrow = HD, krow = KVD;
  const long long koff = (long long)b * S * KVD + kvh * D;
  const float scale_log2 = sm_scale * LOG2E;

  // the block's K and V rows as A fragments, for the whole q loop
  uint32_t kf[KD][4], vf[KD][4];
  load_q(Qs, k + koff, krow, k0, S);
  load_q(Ds, v + koff, krow, k0, S);
  __syncthreads();
  q_fragments(Qs, kf);
  q_fragments(Ds, vf);

  // this thread's key rows and their metadata
  int kj[2], sk[2];
  bool pk[2];
  const int lp = mt.last_pad[b], pf = mt.prefix[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = k0 + tile_row() + 8 * r;
    const bool in = kj[r] < S;
    sk[r] = in ? mt.seg[(long long)b * S + kj[r]] : 0;
    pk[r] = in && mt.pad[(long long)b * S + kj[r]] != 0;
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int i0 = 0; i0 < S; i0 += BLOCK_Q) {
    __syncthreads();  // the previous tile is consumed
    stage_meta(segq_s, nullptr, mt, b, i0, S);
    __syncthreads();
    // rows: keys kj[r]; columns: query rows i0 + c
    uint32_t vis = 0;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = acc_col(n, e), i = i0 + c;
        if (i >= S) continue;
        const int si = segq_s[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool vv = kj[r] < S &&
                          ((kj[r] <= i) || (si > 0 && si == sk[r]) ||
                           (kj[r] < pf)) &&
                          (!pk[r] || i <= lp);
          vis |= (uint32_t)vv << bit(r, n, e);
        }
      }
    if (!__syncthreads_or(vis != 0u)) continue;

    for (int g = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const long long qoff = (long long)b * S * HD + h * D;
      __syncthreads();  // the previous head's tiles are consumed
      load_kv(Qs, Qt, q + qoff, qrow, q + qoff, qrow, i0, S);
      load_kv(Ds, Dt, dout + qoff, qrow, dout + qoff, qrow, i0, S);
      if (threadIdx.x < BLOCK_Q) {
        const int i = i0 + threadIdx.x;
        const long long hr = ((long long)b * H + h) * S + i;
        lse_s[threadIdx.x] = i < S ? lse[hr] * LOG2E : 0.f;
        dl_s[threadIdx.x] = i < S ? delta[hr] : 0.f;
      }
      __syncthreads();
      float p[NK][4], ds[NK][4];
      scores(kf, Qs, p);   // S^T: keys x query rows
      scores(vf, Ds, ds);  // dP^T = V . dO^T
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = acc_col(n, c & 1);
          p[n][c] = (vis >> bit(c >> 1, n, c & 1)) & 1u
                        ? exp2f(p[n][c] * scale_log2 - lse_s[col])
                        : 0.f;
          ds[n][c] = p[n][c] * (ds[n][c] - dl_s[col]) * sm_scale;
        }
      pv(p, Dt, dva);   // dv += P^T . dO
      pv(ds, Qt, dka);  // dk += dS^T . Q
    }
  }
  const float one[2] = {1.f, 1.f};
  store_scaled(dk + koff, krow, k0, S, dka, one);
  store_scaled(dv + koff, krow, k0, S, dva, one);
}

inline dim3 grid_of(int S, int heads, int B) {
  return dim3((S + BLOCK_Q - 1) / BLOCK_Q, heads, B);
}

}  // namespace pag

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// q, out, dout, dq are contiguous [B, S, H*64], k, v, dk, dv contiguous
// [B, S, Hkv*64], lse and delta contiguous fp32 [B, H, S]; metadata int32
// seg / pad [B, S], last_pad / prefix [B].  Each returns the cudaError_t of
// its launch (0 = launched) on ``stream``.

extern "C" int packed_attention_grad_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    int B, int S, int H, int Hkv, int head_dim, float sm_scale,
    void* stream) {
  if (head_dim != tile::D || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  pag::fwd_kernel<<<pag::grid_of(S, H, B), tile::THREADS, pag::FWD_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tile::bf16*>(q), static_cast<const tile::bf16*>(k),
      static_cast<const tile::bf16*>(v), static_cast<tile::bf16*>(out), lse,
      {seg, pad, last_pad, prefix}, S, H, H / Hkv, sm_scale * tile::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_attention_grad_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* seg,
    const int* pad, const int* last_pad, const int* prefix, int B, int S,
    int H, int Hkv, int head_dim, float sm_scale, void* stream) {
  if (head_dim != tile::D || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  pag::dq_kernel<<<pag::grid_of(S, H, B), tile::THREADS, pag::DQ_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tile::bf16*>(q), static_cast<const tile::bf16*>(k),
      static_cast<const tile::bf16*>(v),
      static_cast<const tile::bf16*>(dout), lse, delta,
      static_cast<tile::bf16*>(dq), {seg, pad, last_pad, prefix}, S, H,
      H / Hkv, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_attention_grad_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* seg, const int* pad, const int* last_pad, const int* prefix,
    int B, int S, int H, int Hkv, int head_dim, float sm_scale,
    void* stream) {
  if (head_dim != tile::D || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  pag::dkv_kernel<<<pag::grid_of(S, Hkv, B), tile::THREADS, pag::DKV_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tile::bf16*>(q), static_cast<const tile::bf16*>(k),
      static_cast<const tile::bf16*>(v),
      static_cast<const tile::bf16*>(dout), lse, delta,
      static_cast<tile::bf16*>(dk), static_cast<tile::bf16*>(dv),
      {seg, pad, last_pad, prefix}, S, H, H / Hkv, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
