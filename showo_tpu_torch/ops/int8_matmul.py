"""Weight-only int8 matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of the Pallas ``pallas_i8_matmul`` of
``tools/probe_int8_decode.py`` (``_i8_kernel``) and of
``tools/probe_pallas_wsmm.py`` (the same function tiled over (N, K)), and
of what ``showo_tpu/models/phi.py::_wk`` asks XLA to fuse into every
matmul of a quantized Phi:

    out = bf16(fp32(x @ bf16(w_i8)) * scale)        x [M, K] bf16,
                                                    w_i8 [K, N] int8,
                                                    scale [1, N] bf16

``csrc/int8_matmul.cu`` (over ``csrc/weight_stream.cuh``) reads the int8
weights once and widens them in registers; eager PyTorch would write a
bf16 copy of each weight per call and read it back (5 bytes moved per
weight against the kernel's 1).  The scale is applied to the fp32 sum, as
in ``_i8_kernel``; ``_wk`` instead rounds ``w_i8 * scale`` to bf16 before
the product, which is the one difference from the JAX model (tests state
its tolerance).

:func:`linear_i8` is the call a quantized Phi makes (any leading dims,
optional bias added to the bf16 product).  The wrappers run the plain
version for CPU tensors only; for CUDA tensors they launch the kernel or
raise.  ``cuda_build.launches["int8_matmul"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from showo_tpu_torch.ops import cuda_build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, ldx, w, ldw, scale, bias, out, ldo, part, splits, M, K, N, 3 flags
_ARGS = [_P, _L, _P, _L, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I]

GEMV_MAX_M = 4          # csrc/weight_stream.cuh: decode kernel up to M = 4
_GEMV_COLS = 512        # columns of one decode block
_BLOCKS_PER_SM = 8      # decode blocks per SM the split aims at
_MIN_ROWS_PER_SPLIT = 64


def _epilogue(acc: torch.Tensor, scale: torch.Tensor, bias, dtype):
    """fp32 sum -> (sum * scale) in ``dtype``, then + bias in ``dtype``."""
    y = (acc * scale.reshape(-1).float()).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def i8_matmul_plain(x, w_i8, scale, bias=None):
    """Plain PyTorch version: bf16-exact int8 weights, fp32 products and
    sum, the fp32 sum times the fp32 scale, cast to x's dtype (bf16 for
    the kernel's inputs), then + bias.  x [M, K], w_i8 [K, N], scale
    [1, N] or [N]."""
    acc = x.float() @ w_i8.float()
    return _epilogue(acc, scale, bias, x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_splits(rows: int, N: int, sms: int) -> int:
    """K slices of the decode kernel: enough blocks for ~8 per SM, at
    least 64 weight rows per slice."""
    tiles = -(-N // _GEMV_COLS)
    want = -(-(_BLOCKS_PER_SM * sms) // tiles)
    return max(1, min(want, rows // _MIN_ROWS_PER_SPLIT))


def _check(name: str, t: torch.Tensor, dtype, dev, dims: int):
    if t.device != dev or t.dtype != dtype or t.dim() != dims:
        raise TypeError(f"{name}: the kernel takes a {dims}-D {dtype} tensor "
                        f"on {dev}; got {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")


class WeightStream:
    """The weight side of a launch of ``csrc/<source>.cu`` (int8_matmul or
    int4_matmul), checked and laid out once: w [rows, N] int8 (rows = K,
    or K/2 packed) with a contiguous last dim, scale / bias [N] bf16, all on
    one CUDA device.  Calling it with x [M, K] bf16 launches the kernel and
    returns [M, N] bf16.  A quantized Phi keeps one per matmul, so a decode
    step's ~50 launches check and measure only x (the wrapper's host time
    is part of every token)."""

    def __init__(self, source: str, w, scale, bias, K: int):
        dev = w.device
        _check(f"{source} w", w, torch.int8, dev, 2)
        rows, N = w.shape
        scale = scale.reshape(-1)
        for name, t in (("scale", scale), ("bias", bias)):
            if t is None:
                continue
            _check(f"{source} {name}", t, torch.bfloat16, dev, 1)
            if t.numel() != N:
                raise ValueError(f"{source}: {name} has {t.numel()} "
                                 f"entries, N = {N}")
        self.source, self.dev, self.K, self.N = source, dev, K, N
        self.k_half = K // 2 if source == "int4_matmul" else 0
        self.weights = (w, scale, bias)      # what the pointers point into
        self.args = (w.data_ptr(), w.stride(0), scale.data_ptr(),
                     None if bias is None else bias.data_ptr())
        self.flags = (int(w.data_ptr() % 16 == 0 and w.stride(0) % 16 == 0),
                      int(w.data_ptr() % 8 == 0 and w.stride(0) % 8 == 0))
        self.splits = gemv_splits(rows, N, _sm_count(dev.index or 0))

    def __call__(self, x):
        if (x.device != self.dev or x.dtype != torch.bfloat16
                or x.dim() != 2 or x.stride(-1) != 1):
            _check(f"{self.source} x", x, torch.bfloat16, self.dev, 2)
        if x.shape[1] != self.K:
            raise ValueError(f"{self.source}: x has {x.shape[1]} columns, "
                             f"K = {self.K}")
        M, N = x.shape[0], self.N
        out = torch.empty((M, N), dtype=torch.bfloat16, device=self.dev)
        if M == 0 or N == 0:
            return out
        splits, part = 0, None
        if M <= GEMV_MAX_M:
            splits = self.splits
            part = torch.empty((splits, M, N), dtype=torch.float32,
                               device=self.dev)
        x_aligned = (x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
                     and self.k_half % 8 == 0)
        w_ptr, ldw, scale_ptr, bias_ptr = self.args
        cuda_build.launch(
            self.source, f"{self.source}_bf16", _ARGS, self.dev, x.data_ptr(),
            x.stride(0), w_ptr, ldw, scale_ptr, bias_ptr, out.data_ptr(),
            out.stride(0), None if part is None else part.data_ptr(), splits,
            M, self.K, N, int(x_aligned), *self.flags)
        return out


def weight_stream(source: str, x, w, scale, bias, K: int):
    """One launch of ``csrc/<source>.cu`` on CUDA tensors (see
    :class:`WeightStream`)."""
    return WeightStream(source, w, scale, bias, K)(x)


def pallas_i8_matmul(x, w_i8, scale, bias=None):
    """x [M, K] bf16 @ dequant(w_i8 [K, N] int8, scale [1, N] bf16) ->
    [M, N] bf16 (+ bias [N]).  The JAX probes' signature (kernels 9 and
    11a compute this one function).  CPU tensors go through the plain
    version; CUDA tensors through the kernel."""
    if x.shape[-1] != w_i8.shape[0]:
        raise ValueError(f"x [M, K] {tuple(x.shape)} and w_i8 [K, N] "
                         f"{tuple(w_i8.shape)} differ in K")
    if x.device.type == "cpu":
        return i8_matmul_plain(x, w_i8, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"pallas_i8_matmul: unsupported device {x.device}")
    return weight_stream("int8_matmul", x, w_i8, scale, bias, x.shape[1])


def linear_i8(x, w_i8, scale, bias=None):
    """``x [..., K]`` through int8 weights ``w_i8 [K, N]`` (any row stride,
    a contiguous last dim), per-column ``scale``, optional ``bias``:
    [..., N].  The call a quantized Phi makes."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.device.type == "cuda" and x2.stride(-1) != 1:
        x2 = x2.contiguous()
    return pallas_i8_matmul(x2, w_i8, scale, bias).reshape(
        *lead, w_i8.shape[1])
