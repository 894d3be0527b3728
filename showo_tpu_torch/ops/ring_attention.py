"""Ring attention: K / V split over a process group on the sequence axis.

Counterpart of ``showo_tpu/ops/ring_attention.py``.  Each rank of the
group holds S/P rows of Q, K and V; the K / V chunks (with their segment
ids and pad flags) go round the ring by ``batch_isend_irecv`` while
every rank accumulates its Q block's attention with fp32 online-softmax
statistics (Liu et al. 2023, "Ring Attention with Blockwise
Transformers").  The mask is the O(S) span predicate of the omni kernels,
on absolute positions carried through the rotation:

  visible(b, i, j) = [ j <= i
                       | (seg[b,i] == seg[b,j] & seg[b,i] > 0)
                       | j < prefix[b] ]
                     & ( !pad[b,j] | i <= last_pad[b] )

The chunk is plain PyTorch, as JAX's is ``jnp`` (no Pallas kernel): two
einsums and an exponential in fp32 on the rank's device.

* :func:`ring_omni_attention`: the per-rank body, over this rank's rows;
* :func:`ring_omni_attention_sharded`: whole [B, H, S, D] inputs on every
  rank -> each rank takes its S/P rows, runs the ring, and the output is
  gathered whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _chunk_attn(q, k, v, pos_q, pos_k, seg_q, seg_k, pad_k, last_pad,
                prefix, sm_scale):
    """One (local Q) x (one K / V chunk) partial attention.

    q: [B, H, Qc, D] fp32; k, v: [B, Hkv, Kc, D]; returns (row max
    [B, H, Qc], row sum [B, H, Qc], weighted values [B, H, Qc, D]), fp32."""
    H, Hkv = q.shape[1], k.shape[1]
    group = H // Hkv
    kq = k.repeat_interleave(group, dim=1) if group > 1 else k
    vq = v.repeat_interleave(group, dim=1) if group > 1 else v

    s = torch.einsum("bhqd,bhkd->bhqk", q, kq.float()) * sm_scale
    rows = pos_q[:, None]                                   # [Qc, 1]
    cols = pos_k[None, :]                                   # [1, Kc]
    visible = (cols <= rows)[None]                          # causal
    visible = visible | ((seg_q[:, :, None] == seg_k[:, None, :])
                         & (seg_q[:, :, None] > 0))         # [B, Qc, Kc]
    visible = visible | (cols < prefix[:, None, None])
    keep = (pad_k[:, None, :] == 0) | (rows[None] <= last_pad[:, None, None])
    mask = (visible & keep)[:, None]                        # [B, 1, Qc, Kc]
    s = torch.where(mask, s, NEG_INF)

    m = s.amax(dim=-1)
    # fully masked rows: keep m finite so exp() underflows to 0 cleanly
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    return m_safe, p.sum(dim=-1), torch.einsum("bhqk,bhkd->bhqd", p,
                                               vq.float())


def _rotate(tensors, group, rank: int, world: int):
    """Send each tensor to the next rank of the ring, receive the previous
    rank's; returns the received tensors."""
    g = group if group is not None else dist.group.WORLD
    nxt = dist.get_global_rank(g, (rank + 1) % world)
    prv = dist.get_global_rank(g, (rank - 1) % world)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_omni_attention(q, k, v, seg, pad=None, last_pad=None, prefix=None,
                        sm_scale: Optional[float] = None, group=None):
    """This rank's rows of ring attention over ``group`` (default: the
    whole process group; no group and no process group: one rank).

    q: [B, H, Qloc, D]; k, v: [B, Hkv, Kloc, D]; seg / pad: [B, Kloc] int,
    this rank's rows (rank r holds rows [r*Qloc, (r+1)*Qloc)); last_pad /
    prefix: [B], the same on every rank.  Returns [B, H, Qloc, D] in q's
    dtype, the unsharded omni attention's rows."""
    B, H, Qloc, D = q.shape
    Kloc = k.shape[2]
    dev = q.device
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if pad is None:
        pad = torch.zeros((B, Kloc), dtype=torch.int32, device=dev)
    if last_pad is None:
        last_pad = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if prefix is None:
        prefix = torch.zeros((B,), dtype=torch.int32, device=dev)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size(group)
        me = dist.get_rank(group)
    else:
        world, me = 1, 0

    pos_q = me * Qloc + torch.arange(Qloc, device=dev)
    qf = q.float()
    m = torch.full((B, H, Qloc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Qloc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Qloc, D), dtype=torch.float32, device=dev)
    kc, vc, segc, padc, src = k, v, seg, pad, me
    for step in range(world):
        pos_k = src * Kloc + torch.arange(Kloc, device=dev)
        mc, lc, oc = _chunk_attn(qf, kc, vc, pos_q, pos_k, seg, segc, padc,
                                 last_pad, prefix, sm_scale)
        m_new = torch.maximum(m, mc)
        a_old, a_new = torch.exp(m - m_new), torch.exp(mc - m_new)
        l = l * a_old + lc * a_new
        acc = acc * a_old[..., None] + oc * a_new[..., None]
        m = m_new
        if step + 1 < world:
            # receive the left neighbour's chunk (P-1 useful hops)
            kc, vc, segc, padc = _rotate((kc, vc, segc, padc), group, me,
                                         world)
            src = (src - 1) % world
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_omni_attention_sharded(mesh, q, k, v, seg, pad=None, last_pad=None,
                                prefix=None, sm_scale: Optional[float] = None,
                                axis_name: str = "sp"):
    """Whole inputs on every rank of ``mesh``'s ``axis_name`` group (a
    DeviceMesh; None: the whole process group): q [B, H, S, D], k / v
    [B, Hkv, S, D], seg / pad [B, S], last_pad / prefix [B].  Each rank
    takes its S/P rows, runs :func:`ring_omni_attention`, and the output
    [B, H, S, D] is gathered whole on every rank."""
    group = None if mesh is None else mesh.get_group(axis_name)
    B, H, S, D = q.shape
    world = (dist.get_world_size(group)
             if dist.is_available() and dist.is_initialized() else 1)
    if S % world:
        raise ValueError(f"S={S} does not divide over {world} ranks")
    me = dist.get_rank(group) if world > 1 else 0
    n = S // world
    rows = slice(me * n, (me + 1) * n)
    pad = None if pad is None else pad[:, rows]
    out = ring_omni_attention(q[:, :, rows], k[:, :, rows], v[:, :, rows],
                              seg[:, rows], pad, last_pad, prefix, sm_scale,
                              group)
    if world == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=2)
