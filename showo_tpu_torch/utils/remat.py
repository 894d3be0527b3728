"""Rematerialisation of a layer stack (counterpart of
``showo_tpu/utils/remat.py::wrap_remat``).

  False / None / "none"  no remat
  True / "full"          each layer under ``torch.utils.checkpoint``
                         (non-reentrant): only its inputs are kept, and the
                         whole layer is recomputed in the backward

The JAX package's named-tag rungs ("dots", "qkv", "qkv_fc1", "qkv_attn",
"qkv_fc1_attn"), which keep chosen matmul outputs, are not ported yet.
"""

from __future__ import annotations

import functools

from torch.utils.checkpoint import checkpoint

TAGGED_POLICIES = ("dots", "qkv", "qkv_fc1", "qkv_attn", "qkv_fc1_attn")


def wrap_remat(fn, remat):
    """``fn`` under the remat policy ``remat``."""
    if remat in (False, None, "none"):
        return fn
    if remat in (True, "full"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat in TAGGED_POLICIES:
        raise NotImplementedError(
            f"remat policy {remat!r} (save tagged matmul outputs) is not "
            f"ported yet; the port has 'full' and 'none'")
    raise ValueError(f"unknown remat policy {remat!r}")
