"""Packed omni attention: the CUDA kernel's wrapper, its plain version, and
the span metadata it reads.

Counterpart of ``showo_tpu/ops/flash_attention.py``.  ``omni_attention_packed``
replaces the Pallas ``omni_attention_packed`` (kernel
``_attn_kernel_packed``) with the hand-written Hopper kernel in
``csrc/omni_attention_packed.cu``.  The mask is recomputed from O(S)
metadata instead of a [B, 1, Q, S] bias:

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
edges itself.  See the source for the design.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from showo_tpu_torch.ops.cuda_build import load_library

# Masked score in the plain version and the kernel.  Finite, so a row with
# no visible column averages v instead of producing NaN.
NEG_INF = -1e30

# Number of times the CUDA kernel was launched (incremented only there).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p])


# ---------------------------------------------------------------------------
# Token sequences -> O(S) kernel metadata
# ---------------------------------------------------------------------------

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


def gather_seg_q(seg: torch.Tensor, q_positions: torch.Tensor) -> torch.Tensor:
    """Segment ids of the q rows, gathered from the kv segment map at their
    positions ([B, Q]); a position past the keys has segment 0."""
    S = seg.shape[1]
    got = torch.gather(seg, 1, q_positions.clamp(0, S - 1).long())
    return torch.where(q_positions >= S, 0, got).to(torch.int32)


def q_rows(seg: torch.Tensor, q_positions, batch: int, rows: int):
    """(pos_q, seg_q): the q rows' kv positions ([Q] or [B, Q] in
    ``q_positions``) and segment ids, both int32 [B, Q] and contiguous, as
    the kernel reads them.  They do not change between layers, so a
    forward computes them once (``models/phi.py``) and every layer's
    :func:`omni_attention_packed` call takes them as they are."""
    pos = torch.as_tensor(q_positions, device=seg.device).to(torch.int32)
    pos = torch.atleast_2d(pos).expand(batch, rows).contiguous()
    return pos, gather_seg_q(seg, pos)


def visible_mask(seg, pad, last_pad, prefix, q_positions) -> torch.Tensor:
    """The omni predicate as a [B, Q, S] bool tensor."""
    S = seg.shape[1]
    pos = q_positions[:, :, None]
    seg_q = gather_seg_q(seg, q_positions)[:, :, None]
    j = torch.arange(S, device=seg.device)[None, None, :]
    vis = (j <= pos) | ((seg_q == seg[:, None, :]) & (seg_q > 0))
    vis = vis | (j < prefix[:, None, None])
    return vis & ((pad[:, None, :] == 0) | (pos <= last_pad[:, None, None]))


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
    qh = q.view(B, Q, num_heads, D).transpose(1, 2).float()
    kh = k.view(B, S, num_kv_heads, D).transpose(1, 2).float()
    vh = v.view(B, S, num_kv_heads, D).transpose(1, 2)
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    vis = visible_mask(seg, pad, last_pad, prefix, q_positions)
    scores = scores.masked_fill(~vis[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, vh)                      # [B, H, Q, D]
    return out.transpose(1, 2).reshape(B, Q, HD).to(q.dtype)


def omni_attention_packed(q, k, v, seg, pad=None, last_pad=None, prefix=None,
                          num_heads: int = 32,
                          num_kv_heads: Optional[int] = None,
                          sm_scale: Optional[float] = None,
                          q_positions=None, seg_q=None):
    """q: [B, Q, H*D]; k, v: [B, S, Hkv*D] (GQA: Hkv divides H).

    seg, pad: [B, S] int; last_pad, prefix: [B] int.  ``q_positions`` are
    the q rows' kv positions, [Q] (shared) or [B, Q]; required when
    Q != S.  ``seg_q``, when given, says that ``q_positions`` and ``seg_q``
    already are the int32 [B, Q] pair of :func:`q_rows`.  Returns
    [B, Q, H*D] in q's dtype.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel (bf16, head dim 64), which raises on what it does not take.
    """
    B, Q, HD = q.shape
    S = k.shape[1]
    if num_kv_heads is None:
        num_kv_heads = num_heads
    if HD % num_heads or num_heads % num_kv_heads:
        raise ValueError(f"H*D={HD} with H={num_heads}, Hkv={num_kv_heads}")
    D = HD // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    if pad is None:
        pad = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if last_pad is None:
        last_pad = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if prefix is None:
        prefix = torch.zeros((B,), dtype=torch.int32, device=dev)
    if tuple(seg.shape) != (B, S) or tuple(pad.shape) != (B, S):
        raise ValueError(f"seg/pad must be [B, S] = {(B, S)}, got "
                         f"{tuple(seg.shape)} / {tuple(pad.shape)}")
    meta = [torch.as_tensor(m, device=dev).to(torch.int32).contiguous()
            for m in (seg, pad, last_pad, prefix)]
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

    if dev.type == "cpu":
        return omni_attention_packed_plain(
            q, k, v, *meta, q_positions, num_heads=num_heads,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"omni_attention_packed: unsupported device {dev}")
    return _launch(q, k, v, *meta, q_positions, seg_q, num_heads=num_heads,
                   num_kv_heads=num_kv_heads, sm_scale=sm_scale)


def _kernel():
    lib = load_library("omni_attention_packed")
    fn = lib.omni_attention_packed_bf16
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, seg, pad, last_pad, prefix, pos_q, seg_q, *,
            num_heads, num_kv_heads, sm_scale):
    global launches
    B, Q, HD = q.shape
    S = k.shape[1]
    D = HD // num_heads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"omni_attention_packed kernel takes bf16; "
                            f"{name} is {t.dtype}")
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, rows, heads*D] with a "
                             f"contiguous last dim")
        if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides and base must be 16-byte "
                             f"aligned for the kernel's vector loads")
    if D != 64:
        raise ValueError(f"omni_attention_packed kernel: head dim {D}, "
                         f"the kernel is built for 64")
    if tuple(k.shape) != (B, S, num_kv_heads * D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, S, Hkv*D] = "
                         f"{(B, S, num_kv_heads * D)}, got {tuple(k.shape)}"
                         f" / {tuple(v.shape)}")
    out = torch.empty((B, Q, HD), dtype=q.dtype, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 seg.data_ptr(), pad.data_ptr(), last_pad.data_ptr(),
                 prefix.data_ptr(), pos_q.data_ptr(), seg_q.data_ptr(),
                 B, Q, S, num_heads, num_kv_heads, D,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"omni_attention_packed kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
