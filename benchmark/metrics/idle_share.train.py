"""Share of the traced window in which no kernel ran on the device, in
percent: the window from its first host instant to its last, so host
time before the first kernel and after the last counts."""

from __future__ import annotations

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
