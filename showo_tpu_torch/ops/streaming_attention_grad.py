"""Trainable K-blocked omni attention (kernel 8): the forward, dq and dk/dv
kernels under one ``torch.autograd.Function``, and their plain versions.

Counterpart of ``showo_tpu/ops/streaming_attention_grad.py`` (Pallas
kernels ``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel`` under a custom
VJP), which the JAX dispatcher takes for every shape past the packed
trainable budget (``packed_attention_grad.packed_trainable_fits``): the v1
512x512 training rows (S=1408) among them.  The hand-written Hopper kernels
are in ``csrc/streaming_attention_grad.cu``, all on wgmma with a cp.async
ring and no transposed copies: a tile map from the O(S) metadata
(:func:`tile_map`: per (q tile, k tile) pair of 64 rows, no visible
entry / some / all), made once per forward and kept for the backward;
the forward of ``csrc/attention_fwd_sm90.cuh``; dq and dk/dv of
``csrc/attention_grad_sm90.cuh``.  Each fetches only the visible tiles and
masks only those not all visible.  (Kernel 7 runs the same cores on its
packed layout.)

Self-attention (Q == S) on head-major views: q [B, H, S, D], k and v
[B, Hkv, S, D] (GQA: Hkv divides H), with the mask of
``streaming_attention.py``.  The forward also returns the per-(head, row)
logsumexp ``lse`` [B, H, S] (fp32); the backward recomputes the
probabilities from it, ``P = exp(q.k^T * sm_scale - lse)`` on visible
entries, and forms ``dS = P * (dP - delta)`` with ``dP = dO.v^T`` and
``delta = rowsum(dO*O)`` per head (a PyTorch op, as the JAX package
computes it outside its kernels).  dk and dv are summed over each GQA
group inside the dk/dv kernel (JAX sums them after its kernel).

A row with no visible key gets a zero output, ``lse = 1e30`` (JAX's
``-NEG_INF``) and ``P = 0``: what the Pallas kernel's ``_finish`` intends.
The Pallas forward itself gives such a row the mean of v over one of its
tiles when the tile holds a row that sees a key (it lacks kernel 5's
p-guard), a value of its tile width; the port does not reproduce it.

Every tensor is read through its strides (last dim contiguous), so the
dispatcher's head-major views of the packed projections, and the gradient
autograd hands back through them, go in without a copy; the outputs take
the layout of the inputs they belong to.  The wrappers run the plain
versions for CPU tensors only; for CUDA tensors they launch the kernels
(bf16, head dim 64 or 128) or raise.  ``cuda_build.launches`` counts the launches
under ``streaming_attention_grad_fwd``, ``_dq``, ``_dkv`` (those at head
dim 128 also under the name with ``_d128``) and ``_tiles`` (once per
forward of :class:`StreamingTrainableAttention`, shared by its
forward, dq and dk/dv).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import (_check_head_dim,
                                                 _check_operands, span_meta,
                                                 visible_mask)
from showo_tpu_torch.ops.streaming_attention import NEG_INF, streaming_softmax

SOURCE = "streaming_attention_grad"
KERNELS = tuple(f"{SOURCE}_{part}" for part in ("fwd", "dq", "dkv"))
TILES_KERNEL = f"{SOURCE}_tiles"
TILE = 64       # rows of a q or k tile of the backward kernels
# lse of a row with no visible key (the JAX kernel's -NEG_INF)
LSE_EMPTY = -NEG_INF

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_FWD_ARGS = [_P] * 10 + [_I] * 5 + [_L] * 12 + [_F]
_DQ_ARGS = [_P] * 12 + [_I] * 5 + [_L] * 15 + [_F]
_DKV_ARGS = [_P] * 13 + [_I] * 5 + [_L] * 18 + [_F]
_TILES_ARGS = [_P] * 5 + [_I] * 2


# ---------------------------------------------------------------------------
# Plain versions (also kernel 7's, on head views of its packed layout)
# ---------------------------------------------------------------------------

def self_visible(seg, pad, last_pad, prefix) -> torch.Tensor:
    """The omni predicate of self-attention as a [B, S, S] bool tensor."""
    B, S = seg.shape
    return visible_mask(seg, pad, last_pad, prefix,
                        torch.arange(S, device=seg.device).expand(B, S))


def trainable_fwd_plain(q, k, v, seg, pad, last_pad, prefix, *,
                        sm_scale: float, lse_empty: float = LSE_EMPTY):
    """(out [B, H, S, D] in q's dtype, lse [B, H, S] fp32) from dense fp32
    scores (:func:`streaming_softmax`); ``lse_empty`` for a row with no
    visible key."""
    vis = self_visible(seg, pad, last_pad, prefix)
    out, m, l = streaming_softmax(q, k, v, vis, sm_scale)
    lse = torch.where(l == 0, lse_empty, m + torch.log(l.clamp(min=1e-37)))
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, dout, lse, delta, seg, pad, last_pad, prefix,
                  sm_scale):
    """(P, dS) [B, H, S, S] fp32 and the fp32 views of q, k (per q head)
    and dO."""
    group = q.shape[1] // k.shape[1]
    qh, doh = q.float(), dout.float()
    kh = k.float().repeat_interleave(group, dim=1)
    vh = v.float().repeat_interleave(group, dim=1)
    vis = self_visible(seg, pad, last_pad, prefix)[:, None]
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds, qh, kh, doh


def trainable_dq_plain(q, k, v, dout, lse, delta, seg, pad, last_pad,
                       prefix, *, sm_scale: float):
    """dq = dS . k [B, H, S, D], with dS cast to k's dtype for the
    product."""
    _, ds, _, kh, _ = _probs_and_ds(q, k, v, dout, lse, delta, seg, pad,
                                    last_pad, prefix, sm_scale)
    return torch.matmul(ds.to(k.dtype).float(), kh).to(q.dtype)


def trainable_dkv_plain(q, k, v, dout, lse, delta, seg, pad, last_pad,
                        prefix, *, sm_scale: float):
    """(dk, dv) = (dS^T . q, P^T . dO) [B, Hkv, S, D], summed over each
    GQA group, with dS and P cast to the operands' dtype for the
    products."""
    B, Hkv, S, D = k.shape
    p, ds, qh, _, doh = _probs_and_ds(q, k, v, dout, lse, delta, seg, pad,
                                      last_pad, prefix, sm_scale)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), doh)
    return (dk.view(B, Hkv, -1, S, D).sum(dim=2).to(k.dtype),
            dv.view(B, Hkv, -1, S, D).sum(dim=2).to(v.dtype))


def tile_map_plain(seg, pad, last_pad, prefix) -> torch.Tensor:
    """uint8 [B, nt, nt] (nt = ceil(S / 64)): for each (q tile, k tile)
    pair of 64 rows, 0 where no entry is visible, 1 where some are, 3
    where all 64 x 64 are (rows and keys past S count as not visible)."""
    B, S = seg.shape
    nt = -(-S // TILE)
    vis = torch.zeros((B, nt * TILE, nt * TILE), dtype=torch.bool,
                      device=seg.device)
    vis[:, :S, :S] = self_visible(seg, pad, last_pad, prefix)
    blocks = vis.view(B, nt, TILE, nt, TILE)
    some = blocks.any(dim=4).any(dim=2)
    every = blocks.all(dim=4).all(dim=2)
    return (some.to(torch.uint8) + 2 * every.to(torch.uint8))


def attention_delta(out, dout) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: fp32 [B, H, S], contiguous."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers (CPU tensors: plain versions)
# ---------------------------------------------------------------------------

def counters(name: str, head_dim: int):
    """The launch counters of kernel ``name`` at ``head_dim``: its own, and
    at head dim 128 also ``<name>_d128``."""
    return (name, f"{name}_d128") if head_dim == 128 else name


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{SOURCE}: unsupported device {q.device}")
    return q.device.type


def _check(q, k, v, rows=()) -> tuple:
    """(B, H, Hkv, S, D) after the kernels' checks: bf16 head-major views
    (last dim contiguous, 16-byte aligned strides) of q-like [B, H, S, D]
    and k-like [B, Hkv, S, D] shapes, D 64 or 128, and fp32 contiguous [B, H, S] row
    tensors (lse, delta), all on q's device."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    _check_operands(SOURCE, {"q": q, "k": k, "v": v}, 4)
    _check_head_dim(SOURCE, D, (64, 128))
    if Hkv <= 0 or H % Hkv or tuple(k.shape) != (B, Hkv, S, D) \
            or v.shape != k.shape:
        raise ValueError(f"{SOURCE}: k/v must be [B, Hkv, S, D] with Hkv "
                         f"dividing H={H}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    for t in rows:
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{SOURCE}: lse / delta must be fp32 "
                             f"contiguous {(B, H, S)} on {q.device}")
    return B, H, Hkv, S, D


def _strides(*tensors) -> list:
    return [s for t in tensors for s in t.stride()[:3]]


def _kernel_view(x):
    """``x`` as the kernels read it: itself when its last dim is
    contiguous and its strides and base are 16-byte aligned, else a
    contiguous copy (a layout change, not a fallback)."""
    if x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def streaming_trainable_fwd(q, k, v, seg, pad, last_pad, prefix, *,
                            sm_scale: float, tiles=None):
    """(out [B, H, S, D] in q's layout, lse [B, H, S] fp32); metadata int32
    as :func:`span_meta` returns it; ``tiles``: :func:`tile_map` of the
    metadata, made here when not given."""
    if _device(q) == "cpu":
        return trainable_fwd_plain(q, k, v, seg, pad, last_pad, prefix,
                                   sm_scale=sm_scale)
    B, H, Hkv, S, D = _check(q, k, v)
    if tiles is None:
        tiles = tile_map(seg, pad, last_pad, prefix)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    cuda_build.launch(
        SOURCE, "streaming_attention_grad_fwd_bf16", _FWD_ARGS, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        tiles.data_ptr(), B, H, Hkv, S, D, *_strides(q, k, v, out),
        float(sm_scale), kernel=counters(KERNELS[0], D))
    return out, lse


def check_meta(kernel: str, seg, pad, last_pad, prefix) -> None:
    """What a tile map kernel reads: int32 contiguous seg / pad [B, S]
    and last_pad / prefix [B] on seg's device."""
    B, S = seg.shape
    for name, m, shape in (("seg", seg, (B, S)), ("pad", pad, (B, S)),
                           ("last_pad", last_pad, (B,)),
                           ("prefix", prefix, (B,))):
        if (m.dtype != torch.int32 or tuple(m.shape) != shape
                or not m.is_contiguous() or m.device != seg.device):
            raise ValueError(f"{kernel}: {name} must be int32 contiguous "
                             f"{shape} on {seg.device}")


def tile_map(seg, pad, last_pad, prefix) -> torch.Tensor:
    """The kernels' tile map (:func:`tile_map_plain`): for CUDA
    metadata (int32, as :func:`span_meta` returns it) the kernel of
    ``csrc/attention_grad_sm90.cuh``, counted under ``TILES_KERNEL``."""
    if _device(seg) == "cpu":
        return tile_map_plain(seg, pad, last_pad, prefix)
    check_meta(SOURCE, seg, pad, last_pad, prefix)
    B, S = seg.shape
    nt = -(-S // TILE)
    tiles = torch.empty((B, nt, nt), dtype=torch.uint8, device=seg.device)
    cuda_build.launch(
        SOURCE, "streaming_attention_grad_tiles", _TILES_ARGS, seg.device,
        *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        tiles.data_ptr(), B, S, kernel=TILES_KERNEL)
    return tiles


def streaming_trainable_dq(q, k, v, dout, lse, delta, seg, pad, last_pad,
                           prefix, *, sm_scale: float, tiles=None):
    """dq [B, H, S, D] in q's layout; ``tiles``: :func:`tile_map` of the
    metadata, made here when not given."""
    if _device(q) == "cpu":
        return trainable_dq_plain(q, k, v, dout, lse, delta, seg, pad,
                                  last_pad, prefix, sm_scale=sm_scale)
    B, H, Hkv, S, D = _check(q, k, v, (lse, delta))
    _check_operands(SOURCE, {"q": q, "dout": dout}, 4)
    if tiles is None:
        tiles = tile_map(seg, pad, last_pad, prefix)
    dq = torch.empty_like(q)
    cuda_build.launch(
        SOURCE, "streaming_attention_grad_dq_bf16", _DQ_ARGS, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        tiles.data_ptr(), B, H, Hkv, S, D, *_strides(q, k, v, dout, dq),
        float(sm_scale), kernel=counters(KERNELS[1], D))
    return dq


def streaming_trainable_dkv(q, k, v, dout, lse, delta, seg, pad, last_pad,
                            prefix, *, sm_scale: float, tiles=None):
    """(dk, dv) [B, Hkv, S, D] in k's and v's layouts, each GQA group
    summed; ``tiles`` as for :func:`streaming_trainable_dq`."""
    if _device(q) == "cpu":
        return trainable_dkv_plain(q, k, v, dout, lse, delta, seg, pad,
                                   last_pad, prefix, sm_scale=sm_scale)
    B, H, Hkv, S, D = _check(q, k, v, (lse, delta))
    _check_operands(SOURCE, {"q": q, "dout": dout}, 4)
    if tiles is None:
        tiles = tile_map(seg, pad, last_pad, prefix)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    cuda_build.launch(
        SOURCE, "streaming_attention_grad_dkv_bf16", _DKV_ARGS, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        tiles.data_ptr(), B, H, Hkv, S, D, *_strides(q, k, v, dout, dk, dv),
        float(sm_scale), kernel=counters(KERNELS[2], D))
    return dk, dv


class StreamingTrainableAttention(torch.autograd.Function):
    """out = attention(q, k, v) with the forward and backward of this
    module: the kernels for CUDA tensors, the plain versions for CPU
    tensors.  Metadata as :func:`span_meta` returns it.  On CUDA the
    forward makes the tile map once and the backward reads it again."""

    @staticmethod
    def forward(ctx, q, k, v, seg, pad, last_pad, prefix, sm_scale):
        kw = dict(sm_scale=sm_scale)
        cuda_build.check_plain("streaming_attention_grad", q, k, v)
        if q.is_cuda:
            kw["tiles"] = tile_map(seg, pad, last_pad, prefix)
        out, lse = streaming_trainable_fwd(q, k, v, seg, pad, last_pad,
                                           prefix, **kw)
        ctx.save_for_backward(q, k, v, out, lse, seg, pad, last_pad, prefix)
        ctx.sm_scale = sm_scale
        ctx.tiles = kw.get("tiles")
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, *meta = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if dout.is_cuda:
            dout = _kernel_view(dout)
        delta = attention_delta(out, dout)
        kw = dict(sm_scale=ctx.sm_scale)
        if dout.is_cuda:
            kw["tiles"] = ctx.tiles
        dq = streaming_trainable_dq(q, k, v, dout, lse, delta, *meta, **kw)
        dk, dv = streaming_trainable_dkv(q, k, v, dout, lse, delta, *meta,
                                         **kw)
        return dq, dk, dv, None, None, None, None, None


def omni_attention_trainable(q, k, v, seg, pad=None, last_pad=None,
                             prefix=None, *,
                             sm_scale: Optional[float] = None):
    """Differentiable K-blocked omni attention (self-attention, Q == S).

    q [B, H, S, D]; k, v [B, Hkv, S, D] (any strided views with a
    contiguous last dim); seg, pad [B, S] int; last_pad, prefix [B] int
    (pad / last_pad / prefix default to none).  Returns [B, H, S, D] in
    q's dtype; gradients flow to q, k and v."""
    B, H, Q, D = q.shape
    S = k.shape[2]
    if Q != S:
        raise ValueError(f"the trainable kernels are self-attention: q has "
                         f"{Q} rows, k/v {S}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    meta = span_meta(seg, pad, last_pad, prefix, B, S, q.device)
    return StreamingTrainableAttention.apply(q, k, v, *meta, float(sm_scale))
