"""Omni attention: the CUDA kernel's two wrappers, their plain versions, and
the span metadata they read.

Counterpart of ``showo_tpu/ops/flash_attention.py``.  Three entry points,
as in the JAX package, compute the same function on two layouts:

* ``omni_attention_packed``: q/k/v [B, S, H*D], GQA, head dim 64 or 128
  (replaces the Pallas ``omni_attention_packed``, kernel
  ``_attn_kernel_packed``);
* ``omni_attention_gqa_stacked``: the same layout and function, one block
  per kv head running the rows of its G q heads against each K/V tile
  loaded once (replaces the Pallas ``_omni_attention_gqa_stacked``);
  ``omni_attention_packed(gqa_stack=True)`` routes to it under the JAX
  package's condition;
* ``omni_attention``: head-major q/k/v [B, H, S, D] (replaces the Pallas
  ``omni_attention``, kernel ``_attn_kernel``), taking strided views as
  they are.

They launch the hand-written Hopper kernels of ``csrc/omni_attention.cuh``
(entries ``csrc/omni_attention_packed.cu``, ``csrc/omni_attention.cu`` and
``csrc/omni_attention_gqa_stacked.cu``), which read the layouts through
their strides.  The mask is recomputed from O(S) metadata instead of a
[B, 1, Q, S] bias:

    visible(b, i, j) = [ j <= pos_q[b,i]
                         | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
                         | j < prefix[b] ]
                       & ( pad[b,j] == 0 | pos_q[b,i] <= last_pad[b] )

with ``seg_q`` gathered from ``seg`` at the q rows' kv positions.

What bounds the kernel on an H100 at the v1 512^2 cached step (Q=1026,
S=1155, D=64): small-D attention moves many bytes per FLOP, so moving K/V
through shared memory and the launch shape limit it, not the tensor
cores.  The kernel keeps every score on chip (64-row K/V tiles, online
softmax, no [Q, S] bias or score matrix in device memory), launches one
block per (batch, head, 64-row q tile) to fill the card, and masks ragged
edges itself.  See the sources for the design.

The wrappers run the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise.  ``cuda_build.launches`` counts kernel
launches by source name.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from showo_tpu_torch.ops import cuda_build

# Masked score in the plain version and the kernel.  Finite, so a row with
# no visible column averages v instead of producing NaN.
NEG_INF = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_PACKED_ARGS = [_P] * 10 + [_I] * 6 + [_L] * 8 + [_F]
_OMNI_ARGS = [_P] * 10 + [_I] * 5 + [_L] * 12 + [_F]


# ---------------------------------------------------------------------------
# Token sequences -> O(S) kernel metadata
# ---------------------------------------------------------------------------

def seg_from_modality_positions(modality_positions: torch.Tensor,
                                L: int) -> torch.Tensor:
    """[B, M, 2] (offset, length) spans -> segment ids [B, L] int32 (v2
    omni): a position inside span m has id m + 1 (the last span that
    claims it, as in JAX), others 0."""
    B, M, _ = modality_positions.shape
    mp = torch.as_tensor(modality_positions)
    pos = torch.arange(L, device=mp.device)[None, :, None]
    off = mp[:, None, :, 0]
    length = mp[:, None, :, 1]
    in_span = (pos >= off) & (pos < off + length)            # [B, L, M]
    ids = torch.arange(M, device=mp.device)[None, None, :] + 1
    sid = torch.argmax(torch.where(in_span, ids, 0), dim=-1)
    return torch.where(in_span.any(-1), sid + 1, 0).to(torch.int32)


def seg_from_soi_eoi(sequence: torch.Tensor, soi_id: int,
                     eoi_id: int) -> torch.Tensor:
    """Image-span ids (1-based per row, 0 for text) from soi/eoi markers."""
    is_soi = sequence == soi_id
    is_eoi = sequence == eoi_id
    c_soi = torch.cumsum(is_soi.int(), dim=1)
    c_eoi = torch.cumsum(is_eoi.int(), dim=1)
    inside = (c_soi > c_eoi) | is_soi | is_eoi
    return torch.where(inside, c_soi, 0).to(torch.int32)


def metadata_predict_next(sequence: torch.Tensor, pad_id: int, soi_id: int,
                          eoi_id: int):
    """Metadata reproducing ``omni_mask_predict_next(rm_pad_in_image=True)``
    for the t2i layout (left-padded text + one image span).

    Returns int32 ``seg [B, L]``, ``pad [B, L]``, ``last_pad [B]``,
    ``prefix [B]``."""
    seg = seg_from_soi_eoi(sequence, soi_id, eoi_id)
    pad = (sequence == pad_id).to(torch.int32)
    L = sequence.shape[1]
    idx = torch.arange(L, device=sequence.device)[None, :]
    last_pad = torch.where(pad > 0, idx, -1).amax(dim=1).to(torch.int32)
    prefix = torch.zeros((sequence.shape[0],), dtype=torch.int32,
                         device=sequence.device)
    return seg, pad, last_pad, prefix


def metadata_mmu(sequence: torch.Tensor, eoi_id: int):
    """Metadata reproducing ``omni_mask_mmu``: causal, plus every column up
    to the batch-first eoi visible (the first row that has an eoi sets the
    column for the whole batch; L when no row has one).  No segments, no
    pads.  Returns int32 ``seg``, ``pad`` [B, L], ``last_pad``,
    ``prefix`` [B]."""
    B, L = sequence.shape
    dev = sequence.device
    is_eoi = sequence == eoi_id
    idx = torch.arange(L, device=dev)[None, :]
    row_first = torch.where(is_eoi, idx, L).amin(dim=1)
    first_row = torch.argmax(is_eoi.any(dim=1).int())
    eoi_col = row_first[first_row]
    zeros = torch.zeros((B, L), dtype=torch.int32, device=dev)
    return (zeros, zeros.clone(),
            torch.full((B,), -1, dtype=torch.int32, device=dev),
            (eoi_col + 1).expand(B).to(torch.int32).contiguous())


def gather_at(m: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Entries of a [B, L] metadata map at ``positions`` ([B, N]) as int32;
    a position past the map's end has entry 0."""
    L = m.shape[1]
    got = torch.gather(m, 1, positions.clamp(0, L - 1).long())
    return torch.where(positions >= L, 0, got).to(torch.int32)


def q_rows(seg: torch.Tensor, q_positions, batch: int, rows: int):
    """(pos_q, seg_q): the q rows' kv positions ([Q] or [B, Q] in
    ``q_positions``) and segment ids, both int32 [B, Q] and contiguous, as
    the kernel reads them.  They do not change between layers, so a
    forward computes them once (``models/phi.py``) and every layer's
    kernel call takes them as they are."""
    pos = torch.as_tensor(q_positions, device=seg.device).to(torch.int32)
    pos = torch.atleast_2d(pos).expand(batch, rows).contiguous()
    return pos, gather_at(seg, pos)


def visible_mask(seg, pad, last_pad, prefix, q_positions) -> torch.Tensor:
    """The omni predicate as a [B, Q, S] bool tensor."""
    S = seg.shape[1]
    pos = q_positions[:, :, None]
    seg_q = gather_at(seg, q_positions)[:, :, None]
    j = torch.arange(S, device=seg.device)[None, None, :]
    vis = (j <= pos) | ((seg_q == seg[:, None, :]) & (seg_q > 0))
    vis = vis | (j < prefix[:, None, None])
    return vis & ((pad[:, None, :] == 0) | (pos <= last_pad[:, None, None]))


def span_meta(seg, pad, last_pad, prefix, B: int, S: int, dev) -> list:
    """[seg, pad, last_pad, prefix] with their defaults (no pads, no
    prefix), checked, int32 and contiguous on ``dev``, as the kernels read
    them.  Tensors that already are so pass through without a copy."""
    if pad is None:
        pad = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if last_pad is None:
        last_pad = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if prefix is None:
        prefix = torch.zeros((B,), dtype=torch.int32, device=dev)
    if tuple(seg.shape) != (B, S) or tuple(pad.shape) != (B, S):
        raise ValueError(f"seg/pad must be [B, S] = {(B, S)}, got "
                         f"{tuple(seg.shape)} / {tuple(pad.shape)}")
    return [torch.as_tensor(m, device=dev).to(torch.int32).contiguous()
            for m in (seg, pad, last_pad, prefix)]


def _kernel_meta(seg, pad, last_pad, prefix, q_positions, seg_q, B: int,
                 Q: int, S: int, dev):
    """Defaults, int32 and checks of the metadata both wrappers take:
    (seg, pad, last_pad, prefix, pos_q, seg_q) as the kernel reads them."""
    meta = span_meta(seg, pad, last_pad, prefix, B, S, dev)
    if seg_q is None:
        if q_positions is None:
            if Q != S:
                raise ValueError("q_positions is required when Q != S")
            q_positions = torch.arange(S, device=dev)
        q_positions, seg_q = q_rows(meta[0], q_positions, B, Q)
    for name, t in (("q_positions", q_positions), ("seg_q", seg_q)):
        if (tuple(t.shape) != (B, Q) or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be int32 [B, Q] = {(B, Q)}, "
                             f"contiguous, on {dev} (see q_rows)")
    return (*meta, q_positions, seg_q)


def _masked_attention(qh, kh, vh, vis, sm_scale):
    """The plain computation on head-major [B, H, *, D]: fp32 products and
    softmax under the [B, Q, S] mask, probabilities cast to v's dtype for
    the second product, as the Pallas kernels do."""
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * sm_scale
    scores = scores.masked_fill(~vis[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vh.dtype)
    return torch.matmul(probs, vh)


def _check_operands(kernel: str, tensors: dict, dims: int) -> None:
    """What the kernels take: bf16 on one device, ``dims`` dims, the last
    contiguous, strides and base 16-byte aligned (vector loads)."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bf16; {name} is "
                            f"{t.dtype}")
        if t.dim() != dims or t.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name} must have {dims} dims with "
                             f"a contiguous last dim")
        if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name}: strides and base must be "
                             f"16-byte aligned for the kernel's vector loads")


def _check_head_dim(kernel: str, D: int, dims=(64,)) -> None:
    if D not in dims:
        raise ValueError(f"{kernel} kernel: head dim {D}, the kernel is "
                         f"built for {' or '.join(map(str, dims))}")


# The JAX package stacks the q heads of a group only while a [Sp, block_q *
# group] fp32 score block fits this budget of TPU VMEM
# (showo_tpu/ops/flash_attention.py:287, block_q 256 from 256 q rows, else
# 128; Sp = S rounded up to block_q).  The port keeps the condition so that
# the same calls dispatch the same way; on an H100 the cut-over has no
# reason yet and is to be set from card timings.
GQA_STACK_MAX_BYTES = 8 * 1024 * 1024
GQA_STACK_MAX_GROUP = 8     # the kernel's block holds at most 8 warps


def gqa_stack_fits(Q: int, S: int, group: int) -> bool:
    """Whether ``omni_attention_packed(gqa_stack=True)`` takes the stacked
    kernel for these shapes (the JAX package's condition)."""
    block_q = 256 if Q >= 256 else 128
    Sp = -(-S // block_q) * block_q
    return group > 1 and Sp * block_q * group * 4 <= GQA_STACK_MAX_BYTES


# ---------------------------------------------------------------------------
# Packed omni attention
# ---------------------------------------------------------------------------

def omni_attention_packed_plain(q, k, v, seg, pad, last_pad, prefix,
                                q_positions, *, num_heads: int,
                                num_kv_heads: int, sm_scale: float):
    """Plain PyTorch version: matmul, mask, fp32 softmax, matmul.

    q [B, Q, H*D]; k, v [B, S, Hkv*D]; metadata int32 as in
    :func:`omni_attention_packed` with ``q_positions`` [B, Q].
    Scores and softmax are fp32; the probabilities are cast to v's dtype
    for the second product, as the Pallas kernel does.
    """
    B, Q, HD = q.shape
    S = k.shape[1]
    D = HD // num_heads
    group = num_heads // num_kv_heads
    qh = q.view(B, Q, num_heads, D).transpose(1, 2)
    kh = k.view(B, S, num_kv_heads, D).transpose(1, 2)
    vh = v.view(B, S, num_kv_heads, D).transpose(1, 2)
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    vis = visible_mask(seg, pad, last_pad, prefix, q_positions)
    out = _masked_attention(qh, kh, vh, vis, sm_scale)   # [B, H, Q, D]
    return out.transpose(1, 2).reshape(B, Q, HD).to(q.dtype)


def omni_attention_packed(q, k, v, seg, pad=None, last_pad=None, prefix=None,
                          num_heads: int = 32,
                          num_kv_heads: Optional[int] = None,
                          sm_scale: Optional[float] = None,
                          q_positions=None, seg_q=None,
                          gqa_stack: bool = False):
    """q: [B, Q, H*D]; k, v: [B, S, Hkv*D] (GQA: Hkv divides H).

    seg, pad: [B, S] int; last_pad, prefix: [B] int.  ``q_positions`` are
    the q rows' kv positions, [Q] (shared) or [B, Q]; required when
    Q != S.  ``seg_q``, when given, says that ``q_positions`` and ``seg_q``
    already are the int32 [B, Q] pair of :func:`q_rows`.  Returns
    [B, Q, H*D] in q's dtype.  ``gqa_stack``: take
    :func:`omni_attention_gqa_stacked` where :func:`gqa_stack_fits`, as the
    JAX package does.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel (bf16, head dim 64 or 128), which raises on what it does not
    take.
    """
    B, Q, HD = q.shape
    S = k.shape[1]
    if num_kv_heads is None:
        num_kv_heads = num_heads
    if HD % num_heads or num_heads % num_kv_heads:
        raise ValueError(f"H*D={HD} with H={num_heads}, Hkv={num_kv_heads}")
    if gqa_stack and gqa_stack_fits(Q, S, num_heads // num_kv_heads):
        return omni_attention_gqa_stacked(
            q, k, v, seg, pad, last_pad, prefix, num_heads=num_heads,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale,
            q_positions=q_positions, seg_q=seg_q)
    return _packed_call("omni_attention_packed", omni_attention_packed_plain,
                        q, k, v, seg, pad, last_pad, prefix, num_heads,
                        num_kv_heads, sm_scale, q_positions, seg_q)


def _packed_call(kernel: str, plain, q, k, v, seg, pad, last_pad, prefix,
                 num_heads: int, num_kv_heads: int, sm_scale, q_positions,
                 seg_q):
    """The packed-layout kernels' common wrapper: checks, metadata, the
    plain version for CPU tensors, the kernel of ``csrc/<kernel>.cu`` for
    CUDA tensors."""
    B, Q, HD = q.shape
    S = k.shape[1]
    D = HD // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    meta = _kernel_meta(seg, pad, last_pad, prefix, q_positions, seg_q, B, Q,
                        S, dev)
    if dev.type == "cpu":
        return plain(q, k, v, *meta[:5], num_heads=num_heads,
                     num_kv_heads=num_kv_heads, sm_scale=sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    _check_operands(kernel, {"q": q, "k": k, "v": v}, 3)
    _check_head_dim(kernel, D, (64, 128))
    if tuple(k.shape) != (B, S, num_kv_heads * D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, S, Hkv*D] = "
                         f"{(B, S, num_kv_heads * D)}, got {tuple(k.shape)}"
                         f" / {tuple(v.shape)}")
    out = torch.empty((B, Q, HD), dtype=q.dtype, device=dev)
    cuda_build.launch(
        kernel, f"{kernel}_bf16", _PACKED_ARGS,
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(m.data_ptr() for m in meta), B, Q, S, num_heads, num_kv_heads, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), out.stride(0), out.stride(1), float(sm_scale))
    return out


# ---------------------------------------------------------------------------
# GQA-stacked packed omni attention
# ---------------------------------------------------------------------------

def omni_attention_gqa_stacked_plain(q, k, v, seg, pad, last_pad, prefix,
                                     q_positions, *, num_heads: int,
                                     num_kv_heads: int, sm_scale: float):
    """Plain PyTorch version of the JAX package's stacked arithmetic: the G
    q heads of each kv head stacked along rows (row g*Q + pos), one masked
    fp32 product and softmax per kv head, probabilities cast to v's dtype,
    unstacked.  Arguments as :func:`omni_attention_packed_plain`."""
    B, Q, HD = q.shape
    S = k.shape[1]
    D = HD // num_heads
    Hkv = num_kv_heads
    G = num_heads // Hkv
    qs = q.view(B, Q, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * Q, D)
    kh = k.view(B, S, Hkv, D).transpose(1, 2)
    vh = v.view(B, S, Hkv, D).transpose(1, 2)
    vis = visible_mask(seg, pad, last_pad, prefix, q_positions).repeat(1, G, 1)
    out = _masked_attention(qs, kh, vh, vis, sm_scale)   # [B, Hkv, G*Q, D]
    return out.view(B, Hkv, G, Q, D).permute(0, 3, 1, 2, 4).reshape(
        B, Q, HD).to(q.dtype)


def omni_attention_gqa_stacked(q, k, v, seg, pad=None, last_pad=None,
                               prefix=None, num_heads: int = 32,
                               num_kv_heads: Optional[int] = None,
                               sm_scale: Optional[float] = None,
                               q_positions=None, seg_q=None):
    """The function of :func:`omni_attention_packed` (same arguments), one
    kernel block per (q block, kv head, batch) holding the rows of the
    group's q heads (groups 1..8).  CPU tensors go through the plain
    version; CUDA tensors through the kernel (bf16, head dim 64 or 128)."""
    if num_kv_heads is None:
        num_kv_heads = num_heads
    if q.shape[-1] % num_heads or num_heads % num_kv_heads:
        raise ValueError(f"H*D={q.shape[-1]} with H={num_heads}, "
                         f"Hkv={num_kv_heads}")
    group = num_heads // num_kv_heads
    if q.device.type == "cuda" and group > GQA_STACK_MAX_GROUP:
        raise ValueError(f"omni_attention_gqa_stacked kernel: group {group}"
                         f" above {GQA_STACK_MAX_GROUP}")
    return _packed_call("omni_attention_gqa_stacked",
                        omni_attention_gqa_stacked_plain, q, k, v, seg, pad,
                        last_pad, prefix, num_heads, num_kv_heads, sm_scale,
                        q_positions, seg_q)


# ---------------------------------------------------------------------------
# Head-major omni attention
# ---------------------------------------------------------------------------

def omni_attention_plain(q, k, v, seg, pad, last_pad, prefix, q_positions,
                         *, sm_scale: float):
    """Plain PyTorch version of :func:`omni_attention`: q [B, H, Q, D],
    k/v [B, H, S, D], metadata int32 with ``q_positions`` [B, Q]; fp32
    scores and softmax, probabilities cast to v's dtype.  Returns
    [B, H, Q, D] in q's dtype."""
    vis = visible_mask(seg, pad, last_pad, prefix, q_positions)
    return _masked_attention(q, k, v, vis, sm_scale).to(q.dtype)


def omni_attention(q, k, v, seg, pad=None, last_pad=None, prefix=None,
                   sm_scale: Optional[float] = None, q_positions=None,
                   seg_q=None):
    """q: [B, H, Q, D]; k, v: [B, H, S, D]; seg, pad: [B, S] int;
    last_pad, prefix: [B] int.  Returns [B, H, Q, D] in q's dtype.

    Q == S by default (self-attention); with a prefix cache pass
    ``q_positions``, the q rows' kv positions, [Q] or [B, Q].  ``seg_q``,
    when given, says that ``q_positions`` and ``seg_q`` already are the
    int32 [B, Q] pair of :func:`q_rows`.  Any strided view whose last dim
    is contiguous is taken as it is (``x.transpose(1, 2)`` of [B, S, H, D]
    projections costs no copy); the kernel's output is a [B, H, Q, D] view
    of a [B, Q, H, D] tensor, so transposing it back is free as well.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel (bf16, head dim 64), which raises on what it does not take.
    """
    B, H, Q, D = q.shape
    S = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    meta = _kernel_meta(seg, pad, last_pad, prefix, q_positions, seg_q, B, Q,
                        S, dev)
    if dev.type == "cpu":
        return omni_attention_plain(q, k, v, *meta[:5], sm_scale=sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"omni_attention: unsupported device {dev}")
    _check_operands("omni_attention", {"q": q, "k": k, "v": v}, 4)
    _check_head_dim("omni_attention", D)
    if tuple(k.shape) != (B, H, S, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, H, S, D] = {(B, H, S, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    cuda_build.launch(
        "omni_attention", "omni_attention_bf16", _OMNI_ARGS, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(m.data_ptr() for m in meta), B, H, Q, S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(sm_scale))
    return out
