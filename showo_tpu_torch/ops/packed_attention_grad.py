"""Trainable packed omni attention: the forward, dq and dk/dv kernels under
one ``torch.autograd.Function``, their plain versions, and the budget that
decides where this plan applies.

Counterpart of ``showo_tpu/ops/packed_attention_grad.py`` (Pallas kernels
``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel`` under a custom VJP).  The
hand-written Hopper kernels are in ``csrc/packed_attention_grad.cu``.
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
they launch the kernels (bf16, head dim 64, contiguous operands) or raise.
``cuda_build.launches`` counts the launches of each of the three kernels
under ``packed_attention_grad_fwd``, ``_dq`` and ``_dkv``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import span_meta, visible_mask
from showo_tpu_torch.ops.masks import NEG_INF

SOURCE = "packed_attention_grad"
KERNELS = tuple(f"{SOURCE}_{part}" for part in ("fwd", "dq", "dkv"))
# lse of a row with no visible key (the JAX kernel's -NEG_INF)
LSE_EMPTY = -NEG_INF

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 9 + [_I] * 5 + [_F]
_DQ_ARGS = [_P] * 11 + [_I] * 5 + [_F]
_DKV_ARGS = [_P] * 12 + [_I] * 5 + [_F]

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
# Plain versions
# ---------------------------------------------------------------------------

def _heads(x, B, S, n, D):
    """[B, S, n*D] -> fp32 [B, n, S, D] (exact for bf16 values)."""
    return x.view(B, S, n, D).transpose(1, 2).float()


def _visible(seg, pad, last_pad, prefix):
    B, S = seg.shape
    return visible_mask(seg, pad, last_pad, prefix,
                        torch.arange(S, device=seg.device).expand(B, S))


def packed_trainable_fwd_plain(q, k, v, seg, pad, last_pad, prefix, *,
                               num_heads: int, num_kv_heads: int,
                               sm_scale: float):
    """(out [B, S, H*D] in q's dtype, lse [B, H, S] fp32) from dense fp32
    scores; the unnormalised probabilities are cast to v's dtype for the
    second product, as the Pallas kernel does."""
    B, S, HD = q.shape
    H, Hkv = num_heads, num_kv_heads
    D = HD // H
    qh = _heads(q, B, S, H, D)
    kh = _heads(k, B, S, Hkv, D).repeat_interleave(H // Hkv, dim=1)
    vh = _heads(v, B, S, Hkv, D).repeat_interleave(H // Hkv, dim=1)
    vis = _visible(seg, pad, last_pad, prefix)[:, None]
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), vh)
    out = out / torch.where(l == 0, 1.0, l)[..., None]
    lse = torch.where(l == 0, LSE_EMPTY, m + torch.log(l.clamp(min=1e-37)))
    return out.transpose(1, 2).reshape(B, S, HD).to(q.dtype), lse


def _probs_and_ds(q, k, v, dout, lse, delta, seg, pad, last_pad, prefix, H,
                  Hkv, sm_scale):
    """(P, dS) [B, H, S, S] fp32 and the fp32 head views of q, k, dO."""
    B, S, HD = q.shape
    D = HD // H
    qh = _heads(q, B, S, H, D)
    kh = _heads(k, B, S, Hkv, D).repeat_interleave(H // Hkv, dim=1)
    vh = _heads(v, B, S, Hkv, D).repeat_interleave(H // Hkv, dim=1)
    doh = _heads(dout, B, S, H, D)
    vis = _visible(seg, pad, last_pad, prefix)[:, None]
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    lse = torch.where(lse >= LSE_EMPTY, 0.0, lse)
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds, qh, kh, doh


def _merge(x, B, S, Hkv):
    """[B, H, S, D] per-q-head grads -> [B, S, Hkv*D], the GQA group summed."""
    H, D = x.shape[1], x.shape[3]
    x = x.view(B, Hkv, H // Hkv, S, D).sum(dim=2)
    return x.transpose(1, 2).reshape(B, S, Hkv * D)


def packed_trainable_dq_plain(q, k, v, dout, lse, delta, seg, pad, last_pad,
                              prefix, *, num_heads: int, num_kv_heads: int,
                              sm_scale: float):
    """dq = dS . k, with dS cast to k's dtype for the product."""
    B, S, HD = q.shape
    _, ds, _, kh, _ = _probs_and_ds(q, k, v, dout, lse, delta, seg, pad,
                                    last_pad, prefix, num_heads,
                                    num_kv_heads, sm_scale)
    dq = torch.matmul(ds.to(k.dtype).float(), kh)
    return dq.transpose(1, 2).reshape(B, S, HD).to(q.dtype)


def packed_trainable_dkv_plain(q, k, v, dout, lse, delta, seg, pad,
                               last_pad, prefix, *, num_heads: int,
                               num_kv_heads: int, sm_scale: float):
    """(dk, dv) = (dS^T . q, P^T . dO), summed over each GQA group, with dS
    and P cast to the operands' dtype for the products."""
    B, S, _ = q.shape
    p, ds, qh, _, doh = _probs_and_ds(q, k, v, dout, lse, delta, seg, pad,
                                      last_pad, prefix, num_heads,
                                      num_kv_heads, sm_scale)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), doh)
    return (_merge(dk, B, S, num_kv_heads).to(k.dtype),
            _merge(dv, B, S, num_kv_heads).to(v.dtype))


def attention_delta(out, dout, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: fp32 [B, H, S], contiguous."""
    B, S, HD = out.shape
    prod = dout.float() * out.float()
    return prod.view(B, S, num_heads, HD // num_heads).sum(-1) \
        .transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers (CPU tensors: plain versions)
# ---------------------------------------------------------------------------

def _check(tensors: dict, shapes: dict) -> None:
    """What the kernels take: bf16 (fp32 for lse / delta) contiguous
    tensors of the given shapes on one CUDA device, head dim 64."""
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
    if D != 64:
        raise ValueError(f"{SOURCE} kernels: head dim {D}, the kernels are "
                         f"built for 64")
    kv, rows = (B, S, num_kv_heads * D), (B, num_heads, S)
    return {"q": (B, S, HD), "out": (B, S, HD), "dout": (B, S, HD),
            "k": kv, "v": kv, "lse": rows, "delta": rows}


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{SOURCE}: unsupported device {q.device}")
    return q.device.type


def packed_trainable_fwd(q, k, v, seg, pad, last_pad, prefix, *,
                         num_heads: int, num_kv_heads: int,
                         sm_scale: float):
    """(out, lse); metadata int32 as :func:`span_meta` returns it."""
    if _device(q) == "cpu":
        return packed_trainable_fwd_plain(
            q, k, v, seg, pad, last_pad, prefix, num_heads=num_heads,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale)
    B, S, HD = q.shape
    _check({"q": q, "k": k, "v": v}, _shapes(q, num_heads, num_kv_heads))
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    cuda_build.launch(
        SOURCE, "packed_attention_grad_fwd_bf16", _FWD_ARGS, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        B, S, num_heads, num_kv_heads, HD // num_heads, float(sm_scale),
        kernel=KERNELS[0])
    return out, lse


def packed_trainable_dq(q, k, v, dout, lse, delta, seg, pad, last_pad,
                        prefix, *, num_heads: int, num_kv_heads: int,
                        sm_scale: float):
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              sm_scale=sm_scale)
    if _device(q) == "cpu":
        return packed_trainable_dq_plain(q, k, v, dout, lse, delta, seg, pad,
                                         last_pad, prefix, **kw)
    B, S, HD = q.shape
    _check({"q": q, "k": k, "v": v, "dout": dout, "lse": lse,
            "delta": delta}, _shapes(q, num_heads, num_kv_heads))
    dq = torch.empty_like(q)
    cuda_build.launch(
        SOURCE, "packed_attention_grad_dq_bf16", _DQ_ARGS, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        B, S, num_heads, num_kv_heads, HD // num_heads, float(sm_scale),
        kernel=KERNELS[1])
    return dq


def packed_trainable_dkv(q, k, v, dout, lse, delta, seg, pad, last_pad,
                         prefix, *, num_heads: int, num_kv_heads: int,
                         sm_scale: float):
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              sm_scale=sm_scale)
    if _device(q) == "cpu":
        return packed_trainable_dkv_plain(q, k, v, dout, lse, delta, seg,
                                          pad, last_pad, prefix, **kw)
    B, S, HD = q.shape
    _check({"q": q, "k": k, "v": v, "dout": dout, "lse": lse,
            "delta": delta}, _shapes(q, num_heads, num_kv_heads))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    cuda_build.launch(
        SOURCE, "packed_attention_grad_dkv_bf16", _DKV_ARGS, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(m.data_ptr() for m in (seg, pad, last_pad, prefix)),
        B, S, num_heads, num_kv_heads, HD // num_heads, float(sm_scale),
        kernel=KERNELS[2])
    return dk, dv


class PackedTrainableAttention(torch.autograd.Function):
    """out = attention(q, k, v) with the forward and backward of this
    module: the kernels for CUDA tensors, the plain versions for CPU
    tensors.  Metadata as :func:`span_meta` returns it."""

    @staticmethod
    def forward(ctx, q, k, v, seg, pad, last_pad, prefix, num_heads,
                num_kv_heads, sm_scale):
        kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
                  sm_scale=sm_scale)
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
    [B, S, H*D] in q's dtype.  Shapes past :func:`packed_trainable_fits`
    (at the JAX dispatcher's row block, 256 rows or S rounded up to 128)
    raise NotImplementedError: the JAX package sends them to the streaming
    trainable kernels (``showo_tpu/ops/streaming_attention_grad.py``),
    which are not ported yet."""
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
        raise NotImplementedError(
            f"S={S}, H={num_heads}, Hkv={num_kv_heads}, D={D} is past the "
            f"packed trainable budget ({PACKED_TRAINABLE_MAX_BYTES} bytes); "
            f"the streaming trainable kernels "
            f"(showo_tpu/ops/streaming_attention_grad.py) that take such "
            f"shapes are not ported yet")
    meta = span_meta(seg, pad, last_pad, prefix, B, S, q.device)
    return PackedTrainableAttention.apply(q, k, v, *meta, num_heads,
                                          num_kv_heads, float(sm_scale))
