"""Device time in kernels that are neither matrix products, convolutions
nor attention, over the device's busy time, in percent
(``benchmark/trace.py::kernel_class``)."""

from __future__ import annotations

LAYER = "trainer"
UNIT = "%"
BETTER = "lower"
MOVES = "train_samples_per_s"

from benchmark.trace import kernel_class


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    glue = ctx.trace.seconds_by(kernel_class).get("glue", 0.0)
    return 100.0 * glue / ctx.trace.busy_s
