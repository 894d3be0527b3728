"""K-blocked omni attention (kernel 5): the CUDA kernel's wrapper, its
plain version, and the softmax that it shares with the trainable
kernels of ``streaming_attention_grad.py``.

Counterpart of ``showo_tpu/ops/streaming_attention.py``
(``omni_attention_streaming``, Pallas kernel ``_stream_kernel``), the
``streaming`` attention route of phi.  q is head-major [B, H, Q, D]; k and
v are [B, Hkv, S, D] with GQA (kv head ``h // (H // Hkv)``); the mask is
recomputed from O(S) metadata:

    visible(b, i, j) = [ j <= pos_q[b,i]
                         | (seg_q[b,i] == seg[b,j] & seg_q[b,i] > 0)
                         | j < prefix[b] ]
                       & ( pad[b,j] == 0 | pos_q[b,i] <= last_pad[b] )
                       & j < S

A row that sees no key emits 0 (the Pallas kernel's p-guard and its
``l == 0`` guard); the packed and omni kernels average v over such a row
instead.  ``q_positions`` are the q rows' kv positions (the prefix-cached
Q != K step).  The Pallas kernel pads Q and S to its block sizes; that is
tiling, not semantics, and the port pads nothing.

The hand-written Hopper kernel is ``csrc/streaming_attention.cu`` (the
forward of ``csrc/attention_grad.cuh`` without the logsumexp): 64-row K/V
tiles with an online softmax, tiles the mask hides skipped from the
metadata, q/k/v read through their strides, so phi's transposed
[B, S, H, D] views go in without a copy.  The wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel or
raises.  ``cuda_build.launches["streaming_attention"]`` counts launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import (_check_head_dim,
                                                 _check_operands,
                                                 _kernel_meta, visible_mask)

SOURCE = "streaming_attention"
# The JAX streaming modules' masked logit; its negation is the lse of a row
# that sees no key in the trainable kernels (kernel 8)
NEG_INF = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_ARGS = [_P] * 10 + [_I] * 6 + [_L] * 12 + [_F]


def streaming_softmax(q, k, v, vis, sm_scale: float):
    """The plain computation of kernels 5 and 8.  q [B, H, Q, D], k and v
    [B, Hkv, S, D], vis [B, Q, S] bool.  Scores are fp32 with masked
    entries at -inf; the unnormalised probabilities ``exp(s - m)`` are cast
    to v's dtype for the product with v and the sum is divided by their
    row sum ``l`` after it, as the Pallas kernels do.  Returns (out fp32
    [B, H, Q, D], m, l [B, H, Q]): a row with no visible key has l = 0,
    m = 0 and out 0."""
    group = q.shape[1] // k.shape[1]
    kh = k.float().repeat_interleave(group, dim=1)
    vh = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kh.transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~vis[:, None], float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), vh)
    return out / torch.where(l == 0, 1.0, l)[..., None], m, l


def omni_attention_streaming_plain(q, k, v, seg, pad, last_pad, prefix,
                                   q_positions, *, sm_scale: float):
    """Plain PyTorch version of :func:`omni_attention_streaming`: metadata
    int32 with ``q_positions`` [B, Q]; returns [B, H, Q, D] in q's
    dtype."""
    vis = visible_mask(seg, pad, last_pad, prefix, q_positions)
    return streaming_softmax(q, k, v, vis, sm_scale)[0].to(q.dtype)


def omni_attention_streaming(q, k, v, seg, pad=None, last_pad=None,
                             prefix=None, *, sm_scale: Optional[float] = None,
                             q_positions=None, seg_q=None):
    """q [B, H, Q, D]; k, v [B, Hkv, S, D] (Hkv divides H); seg, pad
    [B, S] int; last_pad, prefix [B] int.  Returns [B, H, Q, D] in q's
    dtype.

    Q == S by default (self-attention); with a prefix cache pass
    ``q_positions``, the q rows' kv positions, [Q] or [B, Q].  ``seg_q``,
    when given, says that ``q_positions`` and ``seg_q`` already are the
    int32 [B, Q] pair of ``flash_attention.q_rows``.  Any strided view
    whose last dim is contiguous is taken as it is; on CUDA the output is
    a [B, H, Q, D] view of a [B, Q, H, D] tensor, so transposing it back is
    free.

    CPU tensors go through the plain version; CUDA tensors through the
    kernel (bf16, head dim 64), which raises on what it does not take.
    """
    B, H, Q, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    if tuple(k.shape) != (B, Hkv, S, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, Hkv, S, D] = {(B, Hkv, S, D)}, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    meta = _kernel_meta(seg, pad, last_pad, prefix, q_positions, seg_q, B, Q,
                        S, dev)
    if dev.type == "cpu":
        return omni_attention_streaming_plain(q, k, v, *meta[:5],
                                              sm_scale=sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"omni_attention_streaming: unsupported device "
                         f"{dev}")
    _check_operands(SOURCE, {"q": q, "k": k, "v": v}, 4)
    _check_head_dim(SOURCE, D)
    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    cuda_build.launch(
        SOURCE, "streaming_attention_bf16", _ARGS, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(m.data_ptr() for m in meta), B, H, Hkv, Q, S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(sm_scale))
    return out
