"""Model FLOPs of the traced generates (counted from the configuration's
shapes by the cell's driver: ``benchmark/roofline.py``) over the traced
time at the H100's published bf16 peak, in percent."""

from __future__ import annotations

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
MOVES = "images_per_min"

from benchmark.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * ctx.driver.window_flops(ctx.records) / (ctx.trace.window_s
                                                * PEAK_BF16_FLOPS)
