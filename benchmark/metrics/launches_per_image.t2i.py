"""Device kernel launches in the traced window over the images it
completed (memory copies and sets left out)."""

from __future__ import annotations

LAYER = "t2i pipeline and sampler"
UNIT = "launches"
BETTER = "lower"
MOVES = "images_per_min"


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return ctx.trace.launches() / ctx.units
