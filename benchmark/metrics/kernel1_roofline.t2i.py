"""Kernel 1's least time over its device time, in percent: for each of its
launches in the traced window the larger of its operations over the bf16
peak and its bytes over the memory rate (the visible score pairs of the
launch's shapes; q, k, v read once, the output written once:
``benchmark/roofline.py``), summed, over the summed device time of those
launches.  Its launches are the forward-core kernels of namespace
``agrad90`` (the tile map's kernel left out), told apart by head dim; a
count that differs from the cell's shapes leaves the metric out."""

from __future__ import annotations

LAYER = "attention kernel"
UNIT = "%"
BETTER = "higher"
MOVES = "images_per_min"

import re
import sys


# kernel 1's launches: the wgmma forward core of namespace agrad90, by
# head dim (its tile map is another kernel)
CORE = re.compile(r"agrad90::wgmma_fwd_kernel<\s*(64|128)\b")


def read(ctx):
    if ctx.trace is None:
        return None
    want = ctx.driver.kernel1_launches(ctx.records)
    got = {}
    for s, e, name, _ in ctx.trace.kernels:
        m = CORE.search(name)
        if m:
            got.setdefault(int(m.group(1)), []).append((e - s) / 1e6)
    if not got or set(got) != set(want) or any(
            len(got[d]) != len(want[d]) for d in want):
        print(f"kernel1_roofline: launches by head dim {dict((d, len(v)) for d, v in got.items())}"
              f", the shapes give {dict((d, len(v)) for d, v in want.items())}",
              file=sys.stderr)
        return None
    least = sum(x.least_s for d in want for x in want[d])
    return 100.0 * least / sum(sum(v) for v in got.values())
