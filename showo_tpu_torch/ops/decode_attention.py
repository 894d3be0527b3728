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
fp32 bias, 19 MB a layer.  The kernel is the wgmma forward core of
``csrc/attention_fwd_sm90.cuh`` with the bias as its mask, on a tile map
of the bias (:func:`bias_tile_map`, one byte per pair of 64-row q and K
tiles) that a model forward makes once for all its layers
(``models/phi.py``): a pair whose bias is all exactly 0 reads no bias, one
whose bias is all <= -1e9 (the masks' masked value) is skipped, the rest
copy their bias tile beside K and V; a q tile with a row that has no
entry above -1e8 visits every tile, so such a row still averages v over
all K keys.  Skipping is exact: next to an entry above -1e8 an entry at
or below -1e9 weighs exp(< -9e8), 0 in fp32.  The kernel reads the bias
through its strides: the cached step passes the view
``attention_bias[:, :, P:, :P+S]``, whose row stride is the sequence
length, and no contiguous copy is made (one would cost 384 copies of
19 MB per generate).  The ragged K edge takes no weight in the kernel
itself; unlike the Pallas wrapper nothing is padded with -1e30 (the
mask's own masked value is -1e9, ``ops/masks.py``).

The wrappers run the plain versions for CPU tensors only; for CUDA
tensors they launch the kernel or raise.  ``cuda_build.launches`` counts
kernel launches: ``decode_attention`` the attention, ``TILES_KERNEL`` the
maps.
"""

from __future__ import annotations

import ctypes
import math

import torch

from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.flash_attention import (TILE, _check_head_dim,
                                                 _check_operands,
                                                 _check_tiles)

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_ARGS = [_P] * 6 + [_I] * 5 + [_L] * 14 + [_F]
_TILES_ARGS = [_P] + [_L] * 2 + [_P] + [_I] * 3
SOURCE = "decode_attention"
TILES_KERNEL = f"{SOURCE}_tiles"
MASKED = -1e9       # the masks' masked value (ops/masks.py NEG_INF)
SEES_KEY = -1e8     # a row with an entry above this sees some key


def decode_attention_plain(q, k, v, bias):
    """Plain PyTorch version: fp32 scores ``q.k / sqrt(D) + bias``, fp32
    softmax, probabilities cast to v's dtype, product with v.  Shapes as in
    :func:`decode_attention`; returns [B, Q, H, D] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores + bias.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def bias_tile_map_plain(bias) -> torch.Tensor:
    """uint8 [B, nq, nk + 1] (nq = ceil(Q / 64), nk = ceil(K / 64)) of a
    bias [B, 1, Q, K]: entry kt < nk of (b, q tile) is 3 where the K tile
    lies inside K and every entry of its rows < Q is exactly 0, 0 where
    every entry (rows < Q, keys < K) is <= -1e9, 1 otherwise; entry nk is
    1 where some row (< Q) of the q tile has no entry above -1e8."""
    B, _, Q, K = bias.shape
    nq, nk = -(-Q // TILE), -(-K // TILE)
    x = bias[:, 0].float()
    dev = bias.device
    zero = torch.ones((B, nq * TILE, nk * TILE), dtype=torch.bool,
                      device=dev)
    low = zero.clone()
    zero[:, :Q, :K] = x == 0
    zero[:, :, K:] = False
    low[:, :Q, :K] = x <= MASKED
    full = zero.view(B, nq, TILE, nk, TILE).all(dim=4).all(dim=2)
    empty = low.view(B, nq, TILE, nk, TILE).all(dim=4).all(dim=2)
    cls = torch.where(full, 3, torch.where(empty, 0, 1)).to(torch.uint8)
    blind = torch.zeros((B, nq * TILE), dtype=torch.bool, device=dev)
    blind[:, :Q] = ~(x > SEES_KEY).any(dim=2)
    flag = blind.view(B, nq, TILE).any(dim=2).to(torch.uint8)
    return torch.cat([cls, flag[..., None]], dim=2)


def bias_tile_map(bias) -> torch.Tensor:
    """Kernel 3's tile map of ``bias`` (:func:`bias_tile_map_plain` of the
    same values): for a CUDA bias (fp32, last dim contiguous, any batch
    and row strides) the kernel of ``csrc/attention_fwd_sm90.cuh``, one
    pass over the bias, counted under ``TILES_KERNEL``."""
    if bias.device.type == "cpu":
        return bias_tile_map_plain(bias)
    _check_bias(bias, bias.device)
    B, _, Q, K = bias.shape
    tiles = torch.empty((B, -(-Q // TILE), -(-K // TILE) + 1),
                        dtype=torch.uint8, device=bias.device)
    cuda_build.launch(SOURCE, TILES_KERNEL, _TILES_ARGS, bias.device,
                      bias.data_ptr(), bias.stride(0), bias.stride(2),
                      tiles.data_ptr(), B, Q, K, kernel=TILES_KERNEL)
    return tiles


def _check_bias(bias, dev) -> None:
    if bias.dtype != torch.float32 or bias.device != dev:
        raise TypeError(f"decode_attention kernel takes an fp32 bias on "
                        f"{dev}; got {bias.dtype} on {bias.device}")
    if bias.stride(-1) != 1 or bias.data_ptr() % 4:
        raise ValueError("decode_attention: the bias's last dim must be "
                         "contiguous and its base 4-byte aligned")


def decode_attention(q, k, v, bias, tiles=None):
    """q [B, Q, H, D]; k, v [B, K, H, D]; bias [B, 1, Q, K] additive
    (any strided view with a contiguous last dim).  Scores are scaled by
    1 / sqrt(D), as in the Pallas kernel.  ``tiles``: the bias's tile map
    (:func:`bias_tile_map`), made here when None.  Returns [B, Q, H, D].

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
    cuda_build.check_plain("decode_attention", q, k, v)
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, bias)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    _check_operands(SOURCE, {"q": q, "k": k, "v": v}, 4)
    _check_head_dim(SOURCE, D)
    if tuple(k.shape) != (B, K, H, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, K, H, D] = {(B, K, H, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    _check_bias(bias, dev)
    if tiles is None:
        tiles = bias_tile_map(bias)
    _check_tiles(tiles, B, Q, K, dev)
    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=dev)
    cuda_build.launch(
        SOURCE, "decode_attention_bf16", _ARGS, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bias.data_ptr(), tiles.data_ptr(), B, Q, K, H, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], bias.stride(0),
        bias.stride(2), 1.0 / math.sqrt(D))
    return out
