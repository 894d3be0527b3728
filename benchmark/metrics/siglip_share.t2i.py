"""Device time of the kernels launched inside SigLIP's forward (a range
hooks on the tower open around its forward) over the device's busy time,
in percent."""

from __future__ import annotations

LAYER = "SigLIP tower"
UNIT = "%"
BETTER = "lower"
MOVES = "images_per_min"


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    s = ctx.trace.seconds_in("siglip")
    return 100.0 * s / ctx.trace.busy_s if s > 0 else None
