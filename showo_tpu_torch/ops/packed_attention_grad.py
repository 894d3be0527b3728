"""Trainable packed omni attention: the forward, dq and dk/dv kernels under
one ``torch.autograd.Function``, their plain versions, and the budget that
decides where this plan applies.

Counterpart of ``showo_tpu/ops/packed_attention_grad.py`` (Pallas kernels
``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel`` under a custom VJP).  The
hand-written Hopper kernels are kernel 8's wgmma cores run on the packed
layout by ``csrc/packed_attention_grad.cu``: a tile map from the O(S)
metadata (:func:`tile_map`: per (q tile, k tile) pair of 64 rows, no
visible entry / some / all), made once per forward and kept for the
backward; the forward of ``csrc/attention_fwd_sm90.cuh``; dq and dk/dv of
``csrc/attention_grad_sm90.cuh``.  The plain versions are kernel 8's
(``streaming_attention_grad.py``) on head views.  Shapes past the budget
below go to kernel 8, as in JAX.
Self-attention (Q == S) on the packed layout: q [B, S, H*D], k and v
[B, S, Hkv*D] (GQA: Hkv divides H), with the omni mask recomputed from
O(S) metadata:

    visible(b, i, j) = [ j <= i | (seg[b,i] == seg[b,j] & seg[b,i] > 0)
                         | j < prefix[b] ]
                       & ( pad[b,j] == 0 | i <= last_pad[b] )

The forward also returns the per-(head, row) logsumexp ``lse`` [B, H, S]
(fp32); the backward recomputes the probabilities from it,
``P = exp(q.k^T * sm_scale - lse)`` on visible entries, and forms
``dS = P * (dP - delta)`` with ``dP = dO.v^T`` and ``delta = rowsum(dO*O)``
per head (PyTorch ops, as the JAX package computes it outside its
kernels).  A row with no visible key gets a zero output, ``lse = 1e9`` and
``P = 0``: unlike the inference kernels, which average v over such a row.

What bounds the kernels on an H100 and their design are in the source.
The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernels (bf16, head dim 64 or 128, contiguous operands) or
raise.  At head dim 128 (Qwen2.5's 12 q / 2 kv heads) each backward
kernel computes the output in two 64-wide halves, one block each.
``cuda_build.launches`` counts the launches of the three kernels under
``packed_attention_grad_fwd``, ``_dq`` and ``_dkv`` (those at head dim 128
also under the name with ``_d128``), and of the tile map under
``_tiles``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import span_meta
from showo_tpu_torch.ops.masks import NEG_INF
from showo_tpu_torch.ops.streaming_attention_grad import (
    TILE, attention_delta as streaming_delta, check_meta, counters,
    omni_attention_trainable, self_visible, tile_map_plain,
    trainable_dkv_plain, trainable_dq_plain, trainable_fwd_plain)

SOURCE = "packed_attention_grad"
KERNELS = tuple(f"{SOURCE}_{part}" for part in ("fwd", "dq", "dkv"))
TILES_KERNEL = f"{SOURCE}_tiles"
# lse of a row with no visible key (the JAX kernel's -NEG_INF)
LSE_EMPTY = -NEG_INF

HEAD_DIMS = (64, 128)   # the kernels' builds (the v1 / DiT heads, Qwen2.5's)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# tensor pointers of each entry, before the metadata and the tile map
_ARGS = {"fwd": 9, "dq": 11, "dkv": 12}
_TILES_ARGS = [_P] * 5 + [_I] * 2

# Budget of the packed plan: the Pallas kernels hold the full K/V (and the
# q/do rows of the dk/dv kernel) in TPU VMEM, ~Sp * (2*HD + 2*KVD) * 2 bytes;
# past it the JAX dispatcher takes the streaming trainable kernels.  The
# port keeps the same cut so the two packages route the same shapes.
PACKED_TRAINABLE_MAX_BYTES = 10 * 1024 * 1024


def packed_trainable_fits(S, num_heads, num_kv_heads, head_dim,
                          block_q: int = 256) -> bool:
    Sp = ((S + block_q - 1) // block_q) * block_q
    HD, KVD = num_heads * head_dim, num_kv_heads * head_dim
    return Sp * (2 * HD + 2 * KVD) * 2 <= PACKED_TRAINABLE_MAX_BYTES


# ---------------------------------------------------------------------------
# Plain versions: kernel 8's, on head views of the packed layout
# ---------------------------------------------------------------------------

def _heads(x, n):
    """[B, S, n*D] -> the [B, n, S, D] view."""
    B, S, nD = x.shape
    return x.view(B, S, n, nD // n).transpose(1, 2)


def _packed(x):
    """[B, n, S, D] -> [B, S, n*D]."""
    B, n, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, n * D)


def packed_trainable_fwd_plain(q, k, v, seg, pad, last_pad, prefix, *,
                               num_heads: int, num_kv_heads: int,
                               sm_scale: float):
    """(out [B, S, H*D] in q's dtype, lse [B, H, S] fp32) from dense fp32
    scores; the unnormalised probabilities are cast to v's dtype for the
    second product, as the Pallas kernel does."""
    out, lse = trainable_fwd_plain(
        _heads(q, num_heads), _heads(k, num_kv_heads),
        _heads(v, num_kv_heads), seg, pad, last_pad, prefix,
        sm_scale=sm_scale, lse_empty=LSE_EMPTY)
    return _packed(out), lse


def packed_trainable_dq_plain(q, k, v, dout, lse, delta, seg, pad, last_pad,
                              prefix, *, num_heads: int, num_kv_heads: int,
                              sm_scale: float):
    """dq = dS . k, with dS cast to k's dtype for the product."""
    H, Hkv = num_heads, num_kv_heads
    return _packed(trainable_dq_plain(
        _heads(q, H), _heads(k, Hkv), _heads(v, Hkv), _heads(dout, H), lse,
        delta, seg, pad, last_pad, prefix, sm_scale=sm_scale))


def packed_trainable_dkv_plain(q, k, v, dout, lse, delta, seg, pad,
                               last_pad, prefix, *, num_heads: int,
                               num_kv_heads: int, sm_scale: float):
    """(dk, dv) = (dS^T . q, P^T . dO), summed over each GQA group, with dS
    and P cast to the operands' dtype for the products."""
    H, Hkv = num_heads, num_kv_heads
    dk, dv = trainable_dkv_plain(
        _heads(q, H), _heads(k, Hkv), _heads(v, Hkv), _heads(dout, H), lse,
        delta, seg, pad, last_pad, prefix, sm_scale=sm_scale)
    return _packed(dk), _packed(dv)


def attention_delta(out, dout, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: fp32 [B, H, S], contiguous."""
    return streaming_delta(_heads(out, num_heads), _heads(dout, num_heads))


# ---------------------------------------------------------------------------
# Kernel wrappers (CPU tensors: plain versions)
# ---------------------------------------------------------------------------

def _check(tensors: dict, shapes: dict) -> None:
    """What the kernels take: bf16 (fp32 for lse / delta) contiguous
    tensors of the given shapes on one CUDA device, head dim 64 or 128."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.device != dev:
            raise ValueError(f"{SOURCE}: {name} is on {t.device}, not {dev}")
        if t.dtype != want:
            raise TypeError(f"{SOURCE} kernels take {want} {name}; got "
                            f"{t.dtype}")
        if tuple(t.shape) != shapes[name] or not t.is_contiguous():
            raise ValueError(f"{SOURCE}: {name} must be contiguous "
                             f"{shapes[name]}, got {tuple(t.shape)}")


def _shapes(q, num_heads, num_kv_heads):
    B, S, HD = q.shape
    D = HD // num_heads
    if D not in HEAD_DIMS:
        raise ValueError(f"{SOURCE} kernels: head dim {D}, the kernels are "
                         f"built for 64 or 128")
    kv, rows = (B, S, num_kv_heads * D), (B, num_heads, S)
    return {"q": (B, S, HD), "out": (B, S, HD), "dout": (B, S, HD),
            "k": kv, "v": kv, "lse": rows, "delta": rows}


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{SOURCE}: unsupported device {q.device}")
    return q.device.type


def tile_map(seg, pad, last_pad, prefix) -> torch.Tensor:
    """The kernels' tile map (``tile_map_plain`` of kernel 8, the same
    function): for CUDA metadata (int32 and contiguous, as
    :func:`span_meta` returns it) the kernel of
    ``csrc/attention_grad_sm90.cuh``, counted under ``TILES_KERNEL``."""
    if _device(seg) == "cpu":
        return tile_map_plain(seg, pad, last_pad, prefix)
    check_meta(SOURCE, seg, pad, last_pad, prefix)
    B, S = seg.shape
    nt = -(-S // TILE)
    tiles = torch.empty((B, nt, nt), dtype=torch.uint8, device=seg.device)
    cuda_build.launch(
        SOURCE, TILES_KERNEL, _TILES_ARGS, seg.device,
        *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        tiles.data_ptr(), B, S, kernel=TILES_KERNEL)
    return tiles


def _launch(part: str, q, pointers, meta, tiles, num_heads, num_kv_heads,
            sm_scale) -> None:
    """Launch kernel ``part`` ("fwd", "dq", "dkv") on ``tiles`` (made here
    when None)."""
    B, S, HD = q.shape
    name = f"{SOURCE}_{part}"
    if tiles is None:
        tiles = tile_map(*meta)
    nt = -(-S // TILE)
    if (tiles.dtype != torch.uint8 or tuple(tiles.shape) != (B, nt, nt)
            or not tiles.is_contiguous() or tiles.device != q.device):
        raise ValueError(f"{SOURCE}: tiles must be the uint8 contiguous "
                         f"{(B, nt, nt)} map of tile_map on {q.device}")
    cuda_build.launch(
        SOURCE, f"{name}_bf16", [_P] * (_ARGS[part] + 1) + [_I] * 5 + [_F],
        q.device, *(t.data_ptr() for t in pointers),
        *(m.data_ptr() for m in meta), tiles.data_ptr(),
        B, S, num_heads, num_kv_heads, HD // num_heads, float(sm_scale),
        kernel=counters(name, HD // num_heads))


def packed_trainable_fwd(q, k, v, seg, pad, last_pad, prefix, *,
                         num_heads: int, num_kv_heads: int,
                         sm_scale: float, tiles=None):
    """(out, lse); metadata int32 as :func:`span_meta` returns it;
    ``tiles``: :func:`tile_map` of the metadata, made here when not
    given."""
    if _device(q) == "cpu":
        return packed_trainable_fwd_plain(
            q, k, v, seg, pad, last_pad, prefix, num_heads=num_heads,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale)
    B, S, HD = q.shape
    _check({"q": q, "k": k, "v": v}, _shapes(q, num_heads, num_kv_heads))
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    _launch("fwd", q, (q, k, v, out, lse), (seg, pad, last_pad, prefix),
            tiles, num_heads, num_kv_heads, sm_scale)
    return out, lse


def packed_trainable_dq(q, k, v, dout, lse, delta, seg, pad, last_pad,
                        prefix, *, num_heads: int, num_kv_heads: int,
                        sm_scale: float, tiles=None):
    """dq [B, S, H*D]; ``tiles`` as for :func:`packed_trainable_fwd`."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              sm_scale=sm_scale)
    if _device(q) == "cpu":
        return packed_trainable_dq_plain(q, k, v, dout, lse, delta, seg, pad,
                                         last_pad, prefix, **kw)
    _check({"q": q, "k": k, "v": v, "dout": dout, "lse": lse,
            "delta": delta}, _shapes(q, num_heads, num_kv_heads))
    dq = torch.empty_like(q)
    _launch("dq", q, (q, k, v, dout, lse, delta, dq),
            (seg, pad, last_pad, prefix), tiles, **kw)
    return dq


def packed_trainable_dkv(q, k, v, dout, lse, delta, seg, pad, last_pad,
                         prefix, *, num_heads: int, num_kv_heads: int,
                         sm_scale: float, tiles=None):
    """(dk, dv) [B, S, Hkv*D], each GQA group summed; ``tiles`` as for
    :func:`packed_trainable_fwd`."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              sm_scale=sm_scale)
    if _device(q) == "cpu":
        return packed_trainable_dkv_plain(q, k, v, dout, lse, delta, seg,
                                          pad, last_pad, prefix, **kw)
    _check({"q": q, "k": k, "v": v, "dout": dout, "lse": lse,
            "delta": delta}, _shapes(q, num_heads, num_kv_heads))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", q, (q, k, v, dout, lse, delta, dk, dv),
            (seg, pad, last_pad, prefix), tiles, **kw)
    return dk, dv


class PackedTrainableAttention(torch.autograd.Function):
    """out = attention(q, k, v) with the forward and backward of this
    module: the kernels for CUDA tensors, the plain versions for CPU
    tensors.  Metadata as :func:`span_meta` returns it.  On CUDA the
    forward makes the tile map once and the backward reads it again (a
    forward recomputed under remat makes its own)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, pad, last_pad, prefix, num_heads,
                num_kv_heads, sm_scale):
        kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
                  sm_scale=sm_scale)
        cuda_build.check_plain("packed_attention_grad", q, k, v)
        if q.is_cuda:
            kw["tiles"] = tile_map(seg, pad, last_pad, prefix)
        out, lse = packed_trainable_fwd(q, k, v, seg, pad, last_pad, prefix,
                                        **kw)
        ctx.save_for_backward(q, k, v, out, lse, seg, pad, last_pad, prefix)
        ctx.kw = kw
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, *meta = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = attention_delta(out, dout, ctx.kw["num_heads"])
        dq = packed_trainable_dq(q, k, v, dout, lse, delta, *meta, **ctx.kw)
        dk, dv = packed_trainable_dkv(q, k, v, dout, lse, delta, *meta,
                                      **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def omni_attention_packed_trainable(
        q, k, v, seg, pad=None, last_pad=None, prefix=None, *,
        num_heads: int, num_kv_heads: Optional[int] = None,
        sm_scale: Optional[float] = None):
    """Differentiable packed omni attention (self-attention, Q == S).

    q [B, S, H*D]; k, v [B, S, Hkv*D]; seg, pad [B, S] int; last_pad,
    prefix [B] int (pad / last_pad / prefix default to none).  Returns
    [B, S, H*D] in q's dtype.  Shapes within :func:`packed_trainable_fits`
    (at the JAX dispatcher's row block, 256 rows or S rounded up to 128)
    take this module's kernels; past it the packed tensors are viewed
    head-major and go through the trainable K-blocked kernels
    (``streaming_attention_grad.omni_attention_trainable``, kernel 8), as
    the JAX dispatcher sends them."""
    B, S, HD = q.shape
    if num_kv_heads is None:
        num_kv_heads = num_heads
    if HD % num_heads or num_heads % num_kv_heads:
        raise ValueError(f"H*D={HD} with H={num_heads}, Hkv={num_kv_heads}")
    if tuple(k.shape) != (B, S, HD // num_heads * num_kv_heads) \
            or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, S, Hkv*D] for self-attention, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    D = HD // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bq = min(256, ((S + 127) // 128) * 128)
    if not packed_trainable_fits(S, num_heads, num_kv_heads, D, bq):
        out = omni_attention_trainable(
            _heads(q, num_heads), _heads(k, num_kv_heads),
            _heads(v, num_kv_heads), seg, pad, last_pad, prefix,
            sm_scale=sm_scale)
        return _packed(out)
    meta = span_meta(seg, pad, last_pad, prefix, B, S, q.device)
    return PackedTrainableAttention.apply(q, k, v, *meta, num_heads,
                                          num_kv_heads, float(sm_scale))
