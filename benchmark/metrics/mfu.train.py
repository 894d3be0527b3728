"""Model FLOPs of the traced training steps (6 per trained parameter a
token, the attention's visible pairs three times, the frozen towers'
forward; nothing for recomputation: ``benchmark/drivers/train_v2.py``) over
the traced time at the H100's published bf16 peak, in percent."""

from __future__ import annotations

from benchmark.roofline import PEAK_BF16_FLOPS

LAYER = "trainer"
UNIT = "%"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * ctx.driver.window_flops(ctx.records) / (
        ctx.trace.window_s * PEAK_BF16_FLOPS)
