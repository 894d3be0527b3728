"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity) and the
operation and byte counts the per-layer metrics divide by.

A kernel's least time is the larger of its operations over the bf16 peak
and its bytes over the memory rate, counting each input byte read once and
each output byte written once, and only the score pairs that the mask
leaves visible.  Model FLOPs count 2 per multiply-add of every matrix
product and convolution the configuration needs, and the visible score
pairs of attention; nothing is counted for recomputation.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a kernel: its operations and bytes."""

    flops: float
    bytes: float

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_BYTES_S)


def attention_launch(batch: int, q_rows: int, k_rows: int, heads: int,
                     kv_heads: int, head_dim: int, visible_pairs: int,
                     elem_bytes: int = 2) -> Launch:
    """An attention forward over ``visible_pairs`` (q row, key) pairs
    summed over the batch, per head: QK^T and PV, 2 x 2 x head_dim
    operations a pair a head; q, k, v read once and the output written
    once."""
    flops = 4.0 * head_dim * heads * visible_pairs
    q = batch * q_rows * heads * head_dim
    kv = 2 * batch * k_rows * kv_heads * head_dim
    return Launch(flops, elem_bytes * (2 * q + kv))


def conv_flops(batch: int, h_out: int, w_out: int, c_in: int, c_out: int,
               k: int) -> float:
    return 2.0 * batch * h_out * w_out * c_in * c_out * k * k
