"""Host seconds of one ``decode`` call (the image decoder, the pixels on
the host), synchronised before and after in the traced run, averaged over
the window's generates."""

from __future__ import annotations

LAYER = "image decoder"
UNIT = "s"
BETTER = "lower"
MOVES = "images_per_min"


def read(ctx):
    n = ctx.spans.count("decode")
    return ctx.spans.total("decode") / n if n else None
