"""Attention under an explicit additive bias: the CUDA kernel's wrapper and
its plain version.

Counterpart of ``showo_tpu/ops/decode_attention.py``.  ``decode_attention``
replaces the Pallas ``decode_attention`` (kernels ``_kernel`` and
``_kernel_headloop``, its two grid variants, which compute the same
function) with the hand-written Hopper kernel in
``csrc/decode_attention.cu``:

    out = softmax_fp32(q.k^T / sqrt(D) + bias) . v

Every v1 mask quirk comes in through the bias, so the route is exact
against the dense path by construction.  Scores and softmax are fp32
whatever the model's ``attn_fp32`` says, as in the Pallas kernel.

What bounds the kernel on an H100 at the v1 512^2 cached step (B=4,
Q=1026, K=1155, H=32, D=64): the attention of the omni kernel plus the
fp32 bias (4.7 MB per batch row, read once per head).  The kernel reads
the bias through its strides: the cached step passes the view
``attention_bias[:, :, P:, :P+S]``, whose row stride is the sequence
length, and no contiguous copy is made (one would cost 384 copies of
19 MB per generate).  The ragged K edge takes no weight in the kernel
itself; unlike the Pallas wrapper nothing is padded with -1e30 (the
mask's own masked value is -1e9, ``ops/masks.py``).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  ``cuda_build.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import (_check_head_dim,
                                                 _check_operands)

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_ARGS = [_P] * 5 + [_I] * 5 + [_L] * 14 + [_F]


def decode_attention_plain(q, k, v, bias):
    """Plain PyTorch version: fp32 scores ``q.k / sqrt(D) + bias``, fp32
    softmax, probabilities cast to v's dtype, product with v.  Shapes as in
    :func:`decode_attention`; returns [B, Q, H, D] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores + bias.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def decode_attention(q, k, v, bias):
    """q [B, Q, H, D]; k, v [B, K, H, D]; bias [B, 1, Q, K] additive
    (any strided view with a contiguous last dim).  Scores are scaled by
    1 / sqrt(D), as in the Pallas kernel.  Returns [B, Q, H, D].

    CPU tensors go through the plain version; CUDA tensors through the
    kernel (bf16 q/k/v, fp32 bias, head dim 64), which raises on what it
    does not take.
    """
    B, Q, H, D = q.shape
    K = k.shape[1]
    if tuple(bias.shape) != (B, 1, Q, K):
        raise ValueError(f"bias must be [B, 1, Q, K] = {(B, 1, Q, K)}, got "
                         f"{tuple(bias.shape)}")
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, bias)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    _check_operands("decode_attention", {"q": q, "k": k, "v": v}, 4)
    _check_head_dim("decode_attention", D)
    if tuple(k.shape) != (B, K, H, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, K, H, D] = {(B, K, H, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if bias.dtype != torch.float32 or bias.device != dev:
        raise TypeError(f"decode_attention kernel takes an fp32 bias on "
                        f"{dev}; got {bias.dtype} on {bias.device}")
    if bias.stride(-1) != 1:
        raise ValueError("decode_attention: the bias's last dim must be "
                         "contiguous")
    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=dev)
    cuda_build.launch(
        "decode_attention", "decode_attention_bf16", _ARGS, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bias.data_ptr(), B, Q, K, H, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], bias.stride(0), bias.stride(2),
        1.0 / math.sqrt(D))
    return out
