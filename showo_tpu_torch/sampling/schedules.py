"""Mask-ratio schedules for MaskGIT (counterpart of
``showo_tpu/sampling/schedules.py``).  ``t`` is an fp32 tensor."""

from __future__ import annotations

import math
from functools import partial

import torch


def cosine_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.cos(t * math.pi * 0.5)


def linear_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t, 1e-6, 1.0)


def pow_schedule(t: torch.Tensor, exponent: float) -> torch.Tensor:
    return torch.clamp(1.0 - t ** exponent, 1e-6, 1.0)


def sigmoid_schedule(t: torch.Tensor, start=-3.0, end=3.0, tau=1.0,
                     clip_min=1e-6) -> torch.Tensor:
    def sig(x):
        return 1.0 / (1.0 + torch.exp(-x))

    v_start = sig(torch.tensor(start / tau, dtype=torch.float32))
    v_end = sig(torch.tensor(end / tau, dtype=torch.float32))
    out = sig((t * (end - start) + start) / tau)
    out = (v_end - out) / (v_end - v_start)
    return torch.clamp(out, clip_min, 1.0)


def get_mask_schedule(method: str, **kwargs):
    """``get_mask_chedule`` (sic) dispatch of the reference."""
    if method == "cosine":
        return cosine_schedule
    if method == "linear":
        return linear_schedule
    if "pow" in method:
        return partial(pow_schedule, exponent=float(method.replace("pow", "")))
    if method == "sigmoid":
        return partial(sigmoid_schedule, **kwargs)
    raise ValueError(f"Unknown schedule method: {method}")
