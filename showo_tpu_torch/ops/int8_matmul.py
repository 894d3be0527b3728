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
weights once and widens them next to the multiply; eager PyTorch would
write a bf16 copy of each weight per call and read it back (5 bytes moved
per weight against the kernel's 1).  Three cores, each with its counter
beside the source's (``launches["int8_matmul_<core>"]``; the int4 source
of ``ops/int4_matmul.py`` has the same three, ``int4_matmul_<core>``):

* ``gemv`` (M <= 4, decode): CUDA-core dot products, one launch a
  product: blocks of a column tile and a K range stream the weights
  through a cp.async ring, the last block of a tile adds the K ranges in
  order (:func:`gemv_plan`; a workspace and tickets kept per device);
* ``prefill`` (M > 4, x and w rows 16-byte aligned, as ``Int8Linear``
  pads them; int4 also K/2 a multiple of 8):
  ``csrc/weight_stream_prefill.cuh``, wgmma with the weights widened in
  registers as the A operand and x from shared memory, on a cp.async ring
  of 64-row K tiles, with split-K; the tile width and the split from
  :func:`prefill_plan` (over the packed rows for int4);
* ``mma`` (M > 4, rows that are not so aligned): the first ``mma.sync``
  kernel of ``weight_stream.cuh``.

:func:`select_core` picks the core from M, K and the alignment before the
launch.
The scale is applied to the fp32 sum, as in ``_i8_kernel``; ``_wk``
instead rounds ``w_i8 * scale`` to bf16 before the product, which is the
one difference from the JAX model (tests state its tolerance).

:func:`linear_i8` is the call a quantized Phi makes (any leading dims,
optional bias added to the bf16 product).  The wrappers run the plain
version for CPU tensors only; for CUDA tensors they launch the kernel or
raise.  ``cuda_build.launches["int8_matmul"]`` counts products (one per
call, whatever the core; the prefill kernel's split-K adds a second
launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from showo_tpu_torch.ops import cuda_build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the gemv entry: x, ldx, w, ldw, scale, bias, out, ldo, part, tickets, M,
# K, N, cw, splits, rows_per_split, w_aligned16
_GEMV_ARGS = [_P, _L, _P, _L, _P, _P, _P, _L, _P, _P] + [_I] * 7
# the mma entry: x, ldx, w, ldw, scale, bias, out, ldo, M, K, N, x_aligned,
# w_aligned8
_MMA_ARGS = [_P, _L, _P, _L, _P, _P, _P, _L] + [_I] * 5
# the prefill entry: x, ldx, w, ldw, scale, bias, out, ldo, part, splits,
# M, K, N, bm
_PF_ARGS = [_P, _L, _P, _L, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I]

GEMV_MAX_M = 4          # csrc/weight_stream.cuh: decode kernel up to M = 4
# csrc/weight_stream.cuh's gemv_kernel: weight bytes of a ring stage, rows
# of one K range at most (its x is staged in shared memory), and the
# column tiles' widths in 16-byte chunks, widest first
GEMV_STAGE, GEMV_MAX_ROWS, GEMV_CW = 16384, 1024, (32, 16, 8)
_GEMV_BLOCKS_PER_SM = 2     # blocks the plan aims at (2 fit an SM)
GEMV_MAX_SPLITS = 16        # K ranges a column tile's last block adds
PF_BN, PF_BK = 128, 64  # csrc/weight_stream_prefill.cuh: N and K tiles
# its tile widths (x rows of a block, wgmma's N)
PF_NT = (8, 16, 32, 48, 64, 96, 128, 144, 176, 208, 256)


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


class GemvPlan(NamedTuple):
    """Column tiles and K ranges of one launch of the decode kernel."""
    cw: int                 # 16-byte chunks a row of a column tile
    tiles: int              # column tiles (blockIdx.x)
    splits: int             # K ranges (blockIdx.y); > 1: fp32 partials
    rows_per_split: int     # weight rows of each range (the last: the rest)


def gemv_plan(rows: int, N: int, sms: int) -> GemvPlan:
    """The decode kernel's tiles for w [rows, N] on a card of ``sms`` SMs:
    the widest column tile (512, 256 or 128 bytes) whose tiles, each cut
    into up to GEMV_MAX_SPLITS K ranges of at least one ring stage, give a
    block to every SM, aiming at 2 blocks an SM (one wave); K ranges of at
    most GEMV_MAX_ROWS rows, split evenly.  A pure function of its
    arguments, so every call of a product runs the same sums in the same
    order."""
    target = _GEMV_BLOCKS_PER_SM * sms
    for cw in GEMV_CW:
        tiles = -(-N // (16 * cw))
        stage_rows = GEMV_STAGE // (16 * cw)
        splits = max(-(-rows // GEMV_MAX_ROWS),
                     min(target // tiles, GEMV_MAX_SPLITS,
                         -(-rows // stage_rows)))
        if tiles * splits >= sms:
            break
    per = -(-rows // splits)
    return GemvPlan(cw, tiles, -(-rows // per), per)


class PrefillPlan(NamedTuple):
    """Tiles and K split of one launch of the prefill kernel."""
    bm: int                 # x rows of an output tile (one of PF_NT)
    splits: int             # K ranges (blockIdx.z); > 1: fp32 partials
    k_tiles_per_split: int  # 64-row K tiles of each range (the last: the rest)
    m_tiles: int
    n_tiles: int
    k_tiles: int


def prefill_plan(M: int, K: int, N: int, sms: int) -> PrefillPlan:
    """The prefill kernel's tiles and split-K for x [M, K] @ w [K, N] on a
    card of ``sms`` SMs.  As few row tiles as the widest (256 rows) needs,
    each the narrowest width of PF_NT that covers M with them (M = 267: 2
    x 144; 609: 3 x 208; 8: 1 x 8).  K is split only where the M x N
    tiles give fewer blocks than SMs: among ceil(sms / tiles) to twice as
    many splits, the one whose last wave of blocks is fullest (fewest
    splits on a tie), then as many as keep every split's K range
    non-empty."""
    m_tiles = -(-M // PF_NT[-1])
    bm = next(nt for nt in PF_NT if nt * m_tiles >= M)
    m_tiles, n_tiles = -(-M // bm), -(-N // PF_BN)
    k_tiles = -(-K // PF_BK)
    tiles = m_tiles * n_tiles
    splits = 1
    if tiles < sms:
        low = -(-sms // tiles)

        def fill(s):
            return tiles * s / (-(-(tiles * s) // sms) * sms)
        splits = min(max(range(low, 2 * low + 1),
                         key=lambda s: (fill(s), -s)), k_tiles)
    per = -(-k_tiles // splits)
    return PrefillPlan(bm, -(-k_tiles // per), per, m_tiles, n_tiles, k_tiles)


def select_core(source: str, M: int, K: int, x_ptr: int, ldx: int,
                w_aligned16: bool) -> str:
    """The kernel of ``csrc/<source>.cu`` that x [M, K] (data pointer
    ``x_ptr``, row stride ``ldx`` in elements) goes to: ``gemv`` for
    M <= 4, else ``prefill`` where x rows and the w rows
    (``w_aligned16``) are 16-byte aligned, and for int4 x's second half
    (column K/2) too, else ``mma``."""
    if M <= GEMV_MAX_M:
        return "gemv"
    aligned = x_ptr % 16 == 0 and ldx % 8 == 0 and w_aligned16
    if source == "int4_matmul":
        aligned = aligned and (K // 2) % 8 == 0
    return "prefill" if aligned else "mma"


def _check(name: str, t: torch.Tensor, dtype, dev, dims: int):
    if t.device != dev or t.dtype != dtype or t.dim() != dims:
        raise TypeError(f"{name}: the kernel takes a {dims}-D {dtype} tensor "
                        f"on {dev}; got {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")


# device -> (fp32 partial sums, int32 tickets) of the decode kernel, grown
# as needed and reused by every product on the device: its launches run in
# stream order, and each leaves the tickets at zero
_gemv_space: dict = {}


def _gemv_workspace(dev, floats: int, tiles: int):
    """(part, tickets) of at least ``floats`` / ``tiles`` entries on
    ``dev``."""
    part, tickets = _gemv_space.get(dev, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    _gemv_space[dev] = (part, tickets)
    return part, tickets


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
        self.rows = rows
        self.k_half = K // 2 if source == "int4_matmul" else 0
        self.weights = (w, scale, bias)      # what the pointers point into
        self.args = (w.data_ptr(), w.stride(0), scale.data_ptr(),
                     None if bias is None else bias.data_ptr())
        self.flags = (int(w.data_ptr() % 16 == 0 and w.stride(0) % 16 == 0),
                      int(w.data_ptr() % 8 == 0 and w.stride(0) % 8 == 0))
        self.sms = _sm_count(dev.index or 0)
        self.plan = gemv_plan(rows, N, self.sms)

    def core(self, x) -> str:
        """The kernel that x [M, K] goes to (:func:`select_core`)."""
        return select_core(self.source, x.shape[0], self.K, x.data_ptr(),
                           x.stride(0), bool(self.flags[0]))

    def __call__(self, x):
        """x [M, K] bf16 -> [M, N] bf16 through :meth:`core`'s kernel."""
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
        core = self.core(x)
        counters = (self.source, f"{self.source}_{core}")
        w_ptr, ldw, scale_ptr, bias_ptr = self.args
        if core == "prefill":
            plan = prefill_plan(M, self.rows, N, self.sms)
            part = None
            if plan.splits > 1:
                part = torch.empty((plan.splits, M, N), dtype=torch.float32,
                                   device=self.dev)
            cuda_build.launch(
                self.source, f"{self.source}_prefill_bf16", _PF_ARGS,
                self.dev, x.data_ptr(), x.stride(0), w_ptr, ldw, scale_ptr,
                bias_ptr, out.data_ptr(), out.stride(0),
                None if part is None else part.data_ptr(), plan.splits, M,
                self.K, N, plan.bm, kernel=counters)
            return out
        if core == "gemv":
            plan = self.plan
            part = tickets = None
            if plan.splits > 1:
                part, tickets = _gemv_workspace(self.dev, plan.splits * M * N,
                                                plan.tiles)
            cuda_build.launch(
                self.source, f"{self.source}_gemv_bf16", _GEMV_ARGS,
                self.dev, x.data_ptr(), x.stride(0), w_ptr, ldw, scale_ptr,
                bias_ptr, out.data_ptr(), out.stride(0),
                None if part is None else part.data_ptr(),
                None if tickets is None else tickets.data_ptr(), M, self.K,
                N, plan.cw, plan.splits, plan.rows_per_split, self.flags[0],
                kernel=counters)
            return out
        x_aligned = (x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
                     and self.k_half % 8 == 0)
        cuda_build.launch(
            self.source, f"{self.source}_mma_bf16", _MMA_ARGS, self.dev,
            x.data_ptr(), x.stride(0), w_ptr, ldw, scale_ptr, bias_ptr,
            out.data_ptr(), out.stride(0), M, self.K, N, int(x_aligned),
            self.flags[1], kernel=counters)
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
    cuda_build.check_plain("int8_matmul", x, w_i8)
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
