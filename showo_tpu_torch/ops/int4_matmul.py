"""Weight-only int4 matmul, split-halves nibble layout: the CUDA kernel's
wrapper, its plain version and the packing helpers.

Counterpart of the Pallas ``pallas_nib_matmul`` of
``tools/probe_int4_decode.py`` (``_nib_kernel``, ``_unpack_nib``) and of
``tools/probe_pallas_wsmm.py`` (``_unpack_nib32``, tiled over (N, K)):

    out = bf16(fp32(x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale)

where byte ``w_pk[r, n]`` (w_pk [K/2, N] int8) holds weight row r in its
low nibble (``lo``) and row K/2 + r in its high nibble (``hi``), both
sign-extended.  ``csrc/int4_matmul.cu`` shares ``csrc/weight_stream.cuh``
with the int8 kernel; only the unpack differs.  No model path of the JAX
package quantizes to int4: the kernel is ported as the int8 kernel's
sibling, checked on the card at the probes' shape.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  ``cuda_build.launches["int4_matmul"]``
counts kernel launches.
"""

from __future__ import annotations

import torch

from showo_tpu_torch.ops.int8_matmul import _epilogue, weight_stream


def pack_nibbles(w4: torch.Tensor) -> torch.Tensor:
    """[K, N] integers in [-8, 7] -> [K/2, N] int8 bytes, split halves:
    row r in the low nibble, row K/2 + r in the high one."""
    K = w4.shape[0]
    if K % 2:
        raise ValueError(f"pack_nibbles needs an even K, got {K}")
    w = w4.to(torch.int16)
    if int(w.min()) < -8 or int(w.max()) > 7:
        raise ValueError("pack_nibbles takes values in [-8, 7]")
    byte = ((w[K // 2:] & 0xF) << 4) | (w[:K // 2] & 0xF)
    return byte.to(torch.uint8).view(torch.int8)


def unpack_nibbles(w_pk: torch.Tensor):
    """[K/2, N] packed bytes -> (lo, hi), each [K/2, N] int8 in [-8, 7]:
    rows 0..K/2-1 and K/2..K-1 of the weights."""
    b = w_pk.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = b >> 4
    return lo.to(torch.int8), hi.to(torch.int8)


def nib_matmul_plain(x, w_pk, scale, bias=None):
    """Plain PyTorch version, the Pallas kernel's order: the two half-K
    products in fp32, summed, times the fp32 scale, cast to x's dtype,
    then + bias.  x [M, K], w_pk [K/2, N], scale [1, N] or [N]."""
    lo, hi = unpack_nibbles(w_pk)
    kh = w_pk.shape[0]
    acc = x[:, :kh].float() @ lo.float()
    acc = acc + x[:, kh:].float() @ hi.float()
    return _epilogue(acc, scale, bias, x.dtype)


def pallas_nib_matmul(x, w_pk, scale, bias=None):
    """x [M, K] bf16 @ unpack(w_pk [K/2, N], split halves) * scale [1, N]
    -> [M, N] bf16 (+ bias [N]).  The JAX probes' signature (kernels 10
    and 11b compute this one function).  CPU tensors go through the plain
    version; CUDA tensors through the kernel."""
    if x.shape[-1] != 2 * w_pk.shape[0]:
        raise ValueError(f"x [M, K] {tuple(x.shape)} and w_pk [K/2, N] "
                         f"{tuple(w_pk.shape)} do not match")
    if x.device.type == "cpu":
        return nib_matmul_plain(x, w_pk, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"pallas_nib_matmul: unsupported device {x.device}")
    return weight_stream("int4_matmul", x, w_pk, scale, bias, x.shape[1])
