"""The cached MaskGIT step's attention (kernel 2): per-head q/k
LayerNorm, partial RoPE, the [prefix | fresh] K/V concat and omni-masked
attention, read straight off the fused ``win`` projection output.  The
CUDA kernels' wrappers, their plain versions, and the metadata they read.

Counterpart of ``showo_tpu/ops/fused_decode.py``.
``fused_decode_attention`` replaces the Pallas ``fused_decode_attention``
(kernel ``_kernel``) with the hand-written Hopper kernels of
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
core takes both softmax dtypes: fp32 (``attn_fp32=True``, the default)
and bf16 (``attn_fp32=False``), where the fp32 score q.k * sm_scale,
masked, is rounded to bf16 before the softmax and each probability to
bf16 before the row sum (the core's ``BF16S`` instance, counted under
``BF16_KERNEL`` too).  The online softmax rounds at other points than
JAX's one max over the row, so the bf16 variant is held to its plain
version at the attention limit, not bit for bit.

Two launches compute it (see the source for the design and its bound
on an H100): :func:`norm_rope`, one pass of LayerNorm + RoPE over the
fresh rows' q and k column blocks of ``y`` into contiguous ``qn`` /
``kn`` [B, S, hidden]; then :func:`fused_attend`, the wgmma forward core
of ``csrc/attention_fwd_sm90.cuh`` (kernel 1's -1e30 mask) over K rows
``[ck | kn]`` and V rows ``[cv | y's v block]``, chosen per row at P,
keys at ``pos_k``, on the tile map of those keys (:func:`fused_tile_map`,
made once per forward by ``models/phi.py::attn_step``).  What the route
saves is the glue of the unfused route (fp32 casts and per-head
LayerNorm, rope halves and concats, the K/V prefix concat).  ``y`` is
read through its row stride and the prefix through the batch stride of
the cache views, so the host copies nothing.

The wrappers run the plain versions for CPU tensors only; for CUDA
tensors they launch the kernels or raise.  ``cuda_build.launches``
counts the core's launches under ``SOURCE``, the pass's under
``NORM_KERNEL`` and the maps under ``TILES_KERNEL``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import (NEG_INF, _check_head_dim,
                                                 _check_operands,
                                                 _check_tiles,
                                                 _masked_attention, gather_at,
                                                 q_rows, rows_tile_map,
                                                 visible_mask)

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_NORM_ARGS = [_P] * 9 + [_I] * 5 + [_L] * 2 + [_F]
_ATTEND_ARGS = [_P] * 14 + [_I] * 5 + [_L] * 8 + [_F, _I]
SOURCE = "fused_decode"
# the LayerNorm + RoPE pass, and the tile map of the K = P + S keys
NORM_KERNEL = f"{SOURCE}_norm_rope"
TILES_KERNEL = f"{SOURCE}_tiles"
# the core's bf16-softmax launches (also counted under SOURCE)
BF16_KERNEL = f"{SOURCE}_bf16"
SOFTMAX_DTYPES = (torch.float32, torch.bfloat16)
ROTARY_DIM = 32     # the kernels' rotary dims (Phi-1.5)


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


def norm_rope_plain(y, q_ln, k_ln, cos, sin, *, hidden: int,
                    num_heads: int, rotary_dim: int, eps: float):
    """Plain version of :func:`norm_rope`: (qn, kn), each [B, S, hidden]
    in y's dtype, LayerNorm then RoPE of the q and k column blocks."""
    B, S, _ = y.shape
    D = hidden // num_heads
    qn, kn = (_rope(_layer_norm(
        y[..., i * hidden:(i + 1) * hidden].unflatten(-1, (num_heads, D)),
        *ln, eps), cos, sin, rotary_dim).reshape(B, S, hidden)
        for i, ln in enumerate((q_ln, k_ln)))
    return qn, kn


def norm_rope(y, q_ln, k_ln, cos, sin, *, hidden: int, num_heads: int,
              rotary_dim: int = ROTARY_DIM, eps: float = 1e-5):
    """The LayerNorm + RoPE pass of kernel 2: y [B, S, >= 2 * hidden] (any
    view with a contiguous last dim, 16-byte aligned), its q and k column
    blocks normed by ``q_ln`` / ``k_ln`` ((scale, shift), [D] each) and
    roped by cos / sin ([S, rotary_dim] fp32) -> (qn, kn), [B, S, hidden]
    contiguous in y's dtype.  CPU tensors go through the plain version;
    CUDA tensors through the kernel (bf16, head dim 64, rotary dim 32),
    counted under ``NORM_KERNEL``."""
    if y.device.type == "cpu":
        return norm_rope_plain(y, q_ln, k_ln, cos, sin, hidden=hidden,
                               num_heads=num_heads, rotary_dim=rotary_dim,
                               eps=eps)
    B, S, YW = y.shape
    D = hidden // num_heads
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"norm_rope: unsupported device {dev}")
    _check_operands("fused_decode_attention", {"y": y}, 3)
    _check_head_dim("fused_decode_attention", D)
    if hidden % num_heads or YW < 2 * hidden:
        raise ValueError(f"y [B, S, {YW}] must hold q/k of hidden {hidden}")
    if rotary_dim != ROTARY_DIM:
        raise ValueError(f"fused_decode_attention kernel: rotary dim "
                         f"{rotary_dim}, the kernel is built for "
                         f"{ROTARY_DIM}")
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
    qn, kn = (torch.empty((B, S, hidden), dtype=y.dtype, device=dev)
              for _ in range(2))
    cuda_build.launch(
        SOURCE, "fused_decode_norm_rope_bf16", _NORM_ARGS, dev,
        y.data_ptr(), *(t.data_ptr() for t in ln), cos.data_ptr(),
        sin.data_ptr(), qn.data_ptr(), kn.data_ptr(), B, S, num_heads, D,
        rotary_dim, y.stride(0), y.stride(1), float(eps), kernel=NORM_KERNEL)
    return qn, kn


def fused_tile_map(rows, last_pad, prefix):
    """The tile map of kernel 2's core: ``rows_tile_map`` of the S fresh
    q rows over the K = P + S keys at their positions ``pos_k``
    (:func:`fused_rows`' tuple; last_pad / prefix int32 [B]), uint8
    [B, ceil(S / 64), ceil(K / 64) + 1]; on CUDA the kernel of
    ``csrc/attention_fwd_sm90.cuh`` under this source's entry, counted
    under ``TILES_KERNEL``.  A forward makes it once for all layers."""
    pos_q, seg_q, pos_k, seg_k, pad_k = rows
    return rows_tile_map(seg_k, pad_k, last_pad, prefix, pos_q, seg_q,
                         source=SOURCE, pos_k=pos_k)


def fused_attend_plain(qn, kn, y, ck, cv, last_pad, prefix, rows, *,
                       hidden: int, num_heads: int, sm_scale: float,
                       softmax_dtype=torch.float32):
    """Plain version of :func:`fused_attend`: the packed omni attention
    of qn over K = [ck | kn] and V = [cv | y's v block], keys at
    ``pos_k``, fp32 scores, softmax in ``softmax_dtype`` (bf16: the
    masked fp32 scores rounded to bf16 first, as in JAX), probabilities
    cast to v's dtype.  Returns [B, S, hidden] in qn's dtype."""
    pos_q, seg_q, pos_k, seg_k, pad_k = rows
    B, S, _ = qn.shape
    D = hidden // num_heads

    def heads(t):
        return t.unflatten(-1, (num_heads, D)).transpose(1, 2)

    k = torch.cat([ck, kn.to(ck.dtype)], 1)
    v = torch.cat([cv, y[..., 2 * hidden:3 * hidden].to(cv.dtype)], 1)
    vis = visible_mask(seg_k, pad_k, last_pad, prefix, pos_q, pos_k=pos_k,
                       seg_q=seg_q)
    if softmax_dtype == torch.float32:
        out = _masked_attention(heads(qn), heads(k), heads(v), vis,
                                sm_scale)
    else:
        scores = torch.einsum("bhqd,bhkd->bhqk", heads(qn).float(),
                              heads(k).float()) * sm_scale
        scores = scores.masked_fill(~vis[:, None], NEG_INF)
        probs = torch.softmax(scores.to(softmax_dtype), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), heads(v))
    return out.transpose(1, 2).reshape(B, S, hidden).to(qn.dtype)


def fused_attend(qn, kn, y, ck, cv, last_pad, prefix, rows, tiles=None, *,
                 hidden: int, num_heads: int,
                 sm_scale: Optional[float] = None,
                 softmax_dtype=torch.float32):
    """The attention of kernel 2 after :func:`norm_rope`: qn, kn [B, S,
    hidden] contiguous; y [B, S, >= 3 * hidden] (its v block read); ck, cv
    [B, P, hidden] cache views; last_pad, prefix int32 [B]; ``rows`` the
    tuple of :func:`fused_rows`; ``tiles``: :func:`fused_tile_map` of
    those (made here when None).  ``softmax_dtype``: fp32, or bf16 (the
    core's bf16-score variant).  Returns [B, S, hidden].  CPU tensors go
    through the plain version; CUDA tensors through the forward core
    (bf16, head dim 64), counted under ``SOURCE`` (and the bf16 variant
    under ``BF16_KERNEL``); it raises on a view whose strides or base are
    not 16-byte aligned, and copies nothing."""
    B, S, _ = qn.shape
    P = ck.shape[1]
    D = hidden // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if softmax_dtype not in SOFTMAX_DTYPES:
        raise ValueError(f"fused_decode_attention: softmax dtype "
                         f"{softmax_dtype}, the kernel takes "
                         f"{SOFTMAX_DTYPES}")
    dev = qn.device
    if dev.type == "cpu":
        return fused_attend_plain(qn, kn, y, ck, cv, last_pad, prefix, rows,
                                  hidden=hidden, num_heads=num_heads,
                                  sm_scale=sm_scale,
                                  softmax_dtype=softmax_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_attend: unsupported device {dev}")
    _check_operands("fused_decode_attention",
                    {"qn": qn, "kn": kn, "y": y, "ck": ck, "cv": cv}, 3)
    _check_head_dim("fused_decode_attention", D)
    if (tuple(qn.shape) != (B, S, hidden) or kn.shape != qn.shape
            or not (qn.is_contiguous() and kn.is_contiguous())):
        raise ValueError(f"qn/kn must be contiguous [B, S, hidden] = "
                         f"{(B, S, hidden)} (see norm_rope)")
    if y.shape[:2] != (B, S) or y.shape[2] < 3 * hidden:
        raise ValueError(f"y must be [B, S, >= 3 * hidden] = [{B}, {S}, "
                         f">= {3 * hidden}], got {tuple(y.shape)}")
    if tuple(ck.shape) != (B, P, hidden) or cv.shape != ck.shape:
        raise ValueError(f"ck/cv must be [B, P, hidden] = {(B, P, hidden)}, "
                         f"got {tuple(ck.shape)} / {tuple(cv.shape)}")
    K = P + S
    for name, t, shape in zip(("pos_q", "seg_q", "pos_k", "seg_k", "pad_k"),
                              rows, ((B, S), (B, S), (K,), (B, K), (B, K))):
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"fused_decode_attention: {name} must be int32 "
                             f"{shape}, contiguous, on {dev} (see "
                             f"fused_rows)")
    if tiles is None:
        tiles = fused_tile_map(rows, last_pad, prefix)
    _check_tiles(tiles, B, S, K, dev)
    out = torch.empty((B, S, hidden), dtype=qn.dtype, device=dev)
    pos_q, seg_q, pos_k, seg_k, pad_k = rows
    bf16 = softmax_dtype == torch.bfloat16
    cuda_build.launch(
        SOURCE, "fused_decode_attention_bf16", _ATTEND_ARGS, dev,
        *(t.data_ptr() for t in (qn, kn, y, ck, cv, out, seg_k, pad_k,
                                 last_pad, prefix, pos_k, pos_q, seg_q,
                                 tiles)),
        B, S, P, num_heads, D, y.stride(0), y.stride(1), ck.stride(0),
        ck.stride(1), cv.stride(0), cv.stride(1), out.stride(0),
        out.stride(1), float(sm_scale), int(bf16),
        kernel=(SOURCE, BF16_KERNEL) if bf16 else SOURCE)
    return out


def fused_decode_attention(y, ck, cv, q_ln, k_ln, cos, sin, seg, pad,
                           last_pad, prefix, q_positions, *, hidden: int,
                           num_heads: int, rotary_dim: int, eps: float = 1e-5,
                           sm_scale: Optional[float] = None,
                           softmax_dtype=torch.float32, rows=None,
                           tiles=None):
    """y: [B, S, YW], YW >= 3 * hidden, with q/k/v the first three
    hidden-wide column blocks (the ``win`` output of
    ``models/phi.py::fuse_parallel_mlp``); any view with a contiguous last
    dim.  ck, cv: [B, P, hidden] cached prefix, already normed and roped
    (views of the cache are taken as they are).  q_ln, k_ln: the per-head
    LayerNorms' (scale, shift), [D] each.  cos, sin: [S, rotary_dim] fp32
    rope tables of the fresh rows.  seg, pad: [B, L] span metadata over
    the logical sequence (L >= P + S); last_pad, prefix: [B];
    q_positions: [S] positions of the fresh rows (any, as in JAX).
    ``rows``, when given, is :func:`fused_rows` of those, and ``tiles``
    :func:`fused_tile_map` of ``rows``, each computed once per forward
    (made here when None).  Returns [B, S, hidden] in y's dtype.

    CPU tensors go through the plain version; CUDA tensors through the
    kernels, :func:`norm_rope` then :func:`fused_attend` (bf16, head dim
    64, rotary dim 32, an fp32 or bf16 softmax), which raise on what they
    do not take.
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
    if softmax_dtype not in SOFTMAX_DTYPES:
        raise ValueError(f"fused_decode_attention: softmax dtype "
                         f"{softmax_dtype}, the kernel takes "
                         f"{SOFTMAX_DTYPES}")
    qn, kn = norm_rope(y, q_ln, k_ln, cos, sin, hidden=hidden,
                       num_heads=num_heads, rotary_dim=rotary_dim, eps=eps)
    return fused_attend(qn, kn, y, ck, cv, last_pad, prefix, rows, tiles,
                        hidden=hidden, num_heads=num_heads,
                        sm_scale=sm_scale, softmax_dtype=softmax_dtype)
