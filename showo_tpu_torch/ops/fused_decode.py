"""The cached MaskGIT step's attention in one kernel: per-head q/k
LayerNorm, partial RoPE, the [prefix | fresh] K/V concat and omni-masked
attention, read straight off the fused ``win`` projection output.  The
CUDA kernel's wrapper, its plain version, and the metadata it reads.

Counterpart of ``showo_tpu/ops/fused_decode.py``.
``fused_decode_attention`` replaces the Pallas ``fused_decode_attention``
(kernel ``_kernel``) with the hand-written Hopper kernel in
``csrc/fused_decode.cu``.  For fresh row i and key j of
``K = P + S``:

    q_i = rope(ln_q(y[:, i, h])),   k_j = ck[:, j]               j <  P
                                        = rope(ln_k(y[:, j-P, hidden + h]))
    v_j = cv[:, j]  or  y[:, j-P, 2*hidden + h]
    visible(i, j) = [ pos_k[j] <= pos_q[i] | same nonzero segment
                      | pos_k[j] < prefix ]
                    & ( !pad_k[j] | pos_q[i] <= last_pad )

with ``pos_k = [0..P-1, q_positions]`` and the segment / pad maps
gathered at ``pos_k`` from the logical [B, L] maps (:func:`fused_rows`).

Numerics are the JAX kernel's: LayerNorm in fp32 (two-pass mean and
centred variance, ``rsqrt(var + eps)``, affine in fp32) cast to the
storage dtype; RoPE in the storage dtype, each product rounded; scores
and softmax in ``softmax_dtype``; probabilities cast to v's dtype.  The
kernel takes the fp32 softmax only (``attn_fp32=True``, the default);
for a bf16 softmax on a CUDA tensor the wrapper raises.

What bounds the kernel on an H100 at the v1 512^2 cached step (B=4,
S=1026, P=129, H=32, D=64): the attention is the omni kernel's; what it
removes is the glue of the unfused route (fp32 casts and per-head
LayerNorm, rope halves and concats, the K/V prefix concat), each a pass
over device memory.  It reads q/k/v through the row stride of ``y`` and
the prefix through the batch stride of the cache views, so the host
copies nothing.  See the source for the design.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  ``cuda_build.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import (NEG_INF, _check_head_dim,
                                                 _check_operands, gather_at,
                                                 q_rows)

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_ARGS = [_P] * 17 + [_I] * 6 + [_L] * 8 + [_F] * 2


def fused_rows(seg, pad, q_positions, prefix_len: int, batch: int):
    """(pos_q, seg_q, pos_k, seg_k, pad_k), int32 and contiguous, as the
    kernel reads them: the q rows' positions and segments [B, S]; the keys'
    positions ``[0..P-1, q_positions]`` [K] (``q_positions`` shared by the
    batch); their segments and pads [B, K], gathered from the logical
    [B, L] maps (0 past L).  They do not change between layers, so a
    forward computes them once (``models/phi.py``)."""
    q_positions = torch.as_tensor(q_positions, device=seg.device)
    if q_positions.dim() != 1:
        raise ValueError("fused_rows: q_positions must be [S], shared by "
                         "the batch")
    pos_q, seg_q = q_rows(seg, q_positions, batch, q_positions.shape[0])
    pos_k = torch.cat([torch.arange(prefix_len, dtype=torch.int32,
                                    device=seg.device), pos_q[0]])
    at = pos_k[None, :].expand(batch, -1)
    return (pos_q, seg_q, pos_k, gather_at(seg, at).contiguous(),
            gather_at(pad, at).contiguous())


def _layer_norm(x, scale, shift, eps):
    """fp32 two-pass LayerNorm over the last dim, cast to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + shift.float()).to(x.dtype)


def _rope(x, cos, sin, rotary_dim):
    """GPT-NeoX partial rotary in x's dtype; x [B, S, H, D], cos/sin
    [S, rotary_dim]."""
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot.chunk(2, dim=-1)
    return torch.cat([rot * c + torch.cat([-x2, x1], dim=-1) * s, rest], -1)


def fused_decode_attention_plain(y, ck, cv, q_ln, k_ln, cos, sin, last_pad,
                                 prefix, rows, *, hidden: int,
                                 num_heads: int, rotary_dim: int, eps: float,
                                 sm_scale: float, softmax_dtype):
    """Plain PyTorch version; arguments as in :func:`fused_decode_attention`
    with ``rows`` the tuple of :func:`fused_rows`.  Returns [B, S, hidden]
    in y's dtype."""
    pos_q, seg_q, pos_k, seg_k, pad_k = rows
    B, S, _ = y.shape
    D = hidden // num_heads

    def heads(block):
        return y[..., block * hidden:(block + 1) * hidden].unflatten(
            -1, (num_heads, D))

    q = _rope(_layer_norm(heads(0), *q_ln, eps), cos, sin, rotary_dim)
    kf = _rope(_layer_norm(heads(1), *k_ln, eps), cos, sin, rotary_dim)
    k = torch.cat([ck.unflatten(-1, (num_heads, D)), kf.to(ck.dtype)], 1)
    v = torch.cat([cv.unflatten(-1, (num_heads, D)),
                   heads(2).to(cv.dtype)], 1)

    pq = pos_q[:, :, None]
    sq = seg_q[:, :, None]
    pk = pos_k[None, None, :]
    vis = (pk <= pq) | ((sq == seg_k[:, None, :]) & (sq > 0))
    vis = vis | (pk < prefix[:, None, None])
    vis = vis & ((pad_k[:, None, :] == 0) | (pq <= last_pad[:, None, None]))

    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    scores = scores.masked_fill(~vis[:, None], NEG_INF).to(softmax_dtype)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(B, S, hidden).to(y.dtype)


def fused_decode_attention(y, ck, cv, q_ln, k_ln, cos, sin, seg, pad,
                           last_pad, prefix, q_positions, *, hidden: int,
                           num_heads: int, rotary_dim: int, eps: float = 1e-5,
                           sm_scale: Optional[float] = None,
                           softmax_dtype=torch.float32, rows=None):
    """y: [B, S, YW], YW >= 3 * hidden, with q/k/v the first three
    hidden-wide column blocks (the ``win`` output of
    ``models/phi.py::fuse_parallel_mlp``); any view with a contiguous last
    dim.  ck, cv: [B, P, hidden] cached prefix, already normed and roped
    (views of the cache are taken as they are).  q_ln, k_ln: the per-head
    LayerNorms' (scale, shift), [D] each.  cos, sin: [S, rotary_dim] fp32
    rope tables of the fresh rows.  seg, pad: [B, L] span metadata over
    the logical sequence (L >= P + S); last_pad, prefix: [B];
    q_positions: [S] positions of the fresh rows.  ``rows``, when given,
    is :func:`fused_rows` of those, computed once per forward.  Returns
    [B, S, hidden] in y's dtype.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel (bf16, head dim 64, rotary dim 32, fp32 softmax), which raises
    on what it does not take.
    """
    B, S, YW = y.shape
    P = ck.shape[1]
    D = hidden // num_heads
    if hidden % num_heads or YW < 3 * hidden:
        raise ValueError(f"y [B, S, {YW}] must hold q/k/v of hidden "
                         f"{hidden} = {num_heads} heads x D")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = y.device
    last_pad, prefix = (torch.as_tensor(m, device=dev).to(torch.int32)
                        .contiguous() for m in (last_pad, prefix))
    if last_pad.shape != (B,) or prefix.shape != (B,):
        raise ValueError(f"last_pad/prefix must be [B] = [{B}]")
    if rows is None:
        rows = fused_rows(seg, pad, q_positions, P, B)
    if dev.type == "cpu":
        return fused_decode_attention_plain(
            y, ck, cv, q_ln, k_ln, cos, sin, last_pad, prefix, rows,
            hidden=hidden, num_heads=num_heads, rotary_dim=rotary_dim,
            eps=eps, sm_scale=sm_scale, softmax_dtype=softmax_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_attention: unsupported device {dev}")
    _check_operands("fused_decode_attention", {"y": y, "ck": ck, "cv": cv}, 3)
    _check_head_dim("fused_decode_attention", D)
    if rotary_dim != 32:
        raise ValueError(f"fused_decode_attention kernel: rotary dim "
                         f"{rotary_dim}, the kernel is built for 32")
    if softmax_dtype != torch.float32:
        raise ValueError(f"fused_decode_attention kernel takes the fp32 "
                         f"softmax only, not {softmax_dtype} (the plain "
                         f"version has both)")
    if tuple(ck.shape) != (B, P, hidden) or cv.shape != ck.shape:
        raise ValueError(f"ck/cv must be [B, P, hidden] = {(B, P, hidden)}, "
                         f"got {tuple(ck.shape)} / {tuple(cv.shape)}")
    ln = (*q_ln, *k_ln)
    if any(t.shape != (D,) or t.dtype != torch.bfloat16 or t.device != dev
           or not t.is_contiguous() for t in ln):
        raise TypeError(f"fused_decode_attention kernel: q/k LayerNorm "
                        f"scale and shift must be contiguous bf16 [{D}] on "
                        f"{dev}")
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (S, rotary_dim)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"fused_decode_attention kernel: {name} must be "
                             f"contiguous fp32 [S, rotary_dim] on {dev}")
    K = P + S
    for name, t, shape in zip(("pos_q", "seg_q", "pos_k", "seg_k", "pad_k"),
                              rows, ((B, S), (B, S), (K,), (B, K), (B, K))):
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"fused_decode_attention: {name} must be int32 "
                             f"{shape}, contiguous, on {dev} (see "
                             f"fused_rows)")
    out = torch.empty((B, S, hidden), dtype=y.dtype, device=dev)
    cuda_build.launch(
        "fused_decode", "fused_decode_attention_bf16", _ARGS, dev,
        y.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in ln), cos.data_ptr(), sin.data_ptr(),
        last_pad.data_ptr(), prefix.data_ptr(),
        *(t.data_ptr() for t in rows), B, S, P,
        num_heads, D, rotary_dim, y.stride(0), y.stride(1), ck.stride(0),
        ck.stride(1), cv.stride(0), cv.stride(1), out.stride(0),
        out.stride(1), float(eps), float(sm_scale))
    return out
