"""Training-time discrete forward process (mask / random-replace
corruption of the image tokens).

Counterpart of ``showo_tpu/training/corruption.py``: timestep
t ~ U(0, 1) per row -> mask_prob = schedule(t) clipped below at
``min_masking_rate``; round(S * mask_prob) tokens (at least 1) are masked,
chosen by thresholding the argsort of per-token uniforms (the reference's
permutation trick), or, with probability ``mask_contiguous_region_prob``
for the whole batch, a rectangle of about that many tokens on the
sqrt(S) grid a row; noise_type "mask" writes ``mask_id`` there,
"random_replace" a uniform codebook token; labels are -100 outside the
masked set unless ``predict_all_tokens``.

The random numbers are drawn from an explicit ``torch.Generator``, or
passed in (``timesteps`` [B], ``uniforms`` [B, S], ``replace_tokens``
[B, S]; for the rectangles ``region_rows`` / ``region_cols`` [B],
integers in [0, side), and ``region_select``, one uniform), so that a
test can hand both packages the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def get_loss_weight(t, mask, min_val: float = 0.3):
    return 1 - (1 - mask) * ((1 - t) * (1 - min_val))[:, None]


def mask_or_random_replace_tokens(
    image_tokens: torch.Tensor,
    mask_id: int,
    mask_schedule: Callable,
    *,
    generator: Optional[torch.Generator] = None,
    timesteps: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    replace_tokens: Optional[torch.Tensor] = None,
    region_rows: Optional[torch.Tensor] = None,
    region_cols: Optional[torch.Tensor] = None,
    region_select: Optional[torch.Tensor] = None,
    min_masking_rate: float = 0.0,
    noise_type: str = "mask",
    predict_all_tokens: bool = False,
    mask_contiguous_region_prob: Optional[float] = None,
    codebook_size: int = 8192,
):
    """Returns (input_ids, labels, loss_weight or None, mask_prob).

    image_tokens: [B, S] codebook-space tokens.  Draws that are not passed
    in come from ``generator`` (on the tokens' device)."""
    if noise_type not in ("mask", "random_replace"):
        raise ValueError(f"unknown noise_type {noise_type}")
    B, S = image_tokens.shape
    dev = image_tokens.device
    if timesteps is None:
        timesteps = torch.rand(B, generator=generator, device=dev)
    if uniforms is None:
        uniforms = torch.rand(B, S, generator=generator, device=dev)
    mask_prob = mask_schedule(timesteps.float()).clamp(min=min_masking_rate)
    num_token_masked = torch.round(S * mask_prob).clamp(min=1)
    ranks = torch.argsort(uniforms, dim=-1, stable=True)
    mask = ranks < num_token_masked[:, None]
    if mask_contiguous_region_prob:
        mask = _contiguous_region(
            mask, num_token_masked, mask_contiguous_region_prob, generator,
            region_rows, region_cols, region_select)

    if noise_type == "mask":
        noised = torch.where(mask, mask_id, image_tokens)
    else:
        if replace_tokens is None:
            replace_tokens = torch.randint(0, codebook_size, (B, S),
                                           generator=generator, device=dev)
        noised = torch.where(mask, replace_tokens.to(image_tokens.dtype),
                             image_tokens)

    if predict_all_tokens:
        return (noised, image_tokens,
                get_loss_weight(timesteps, mask.float()), mask_prob)
    return noised, torch.where(mask, image_tokens, -100), None, mask_prob


def _contiguous_region(mask_random, num_token_masked, prob, generator,
                       rows0, cols0, select):
    """A rectangle a row on the sqrt(S) grid, h = floor(sqrt(n)) high and
    n // h wide (each at least 1, at most the side), at the top-left corner
    (rows0 % (side - h + 1), cols0 % (side - w + 1)); all rows take their
    rectangle when ``select`` < ``prob``, else keep ``mask_random`` (the
    JAX package's vectorised form of utils.py:107-127)."""
    B, S = mask_random.shape
    dev = mask_random.device
    side = int(round(S ** 0.5))
    if rows0 is None:
        rows0 = torch.randint(0, side, (B,), generator=generator, device=dev)
    if cols0 is None:
        cols0 = torch.randint(0, side, (B,), generator=generator, device=dev)
    if select is None:
        select = torch.rand((), generator=generator, device=dev)
    n = num_token_masked.to(torch.int32)
    h = torch.sqrt(n.float()).to(torch.int32).clamp(1, side)
    w = (n // h.clamp(min=1)).clamp(1, side)
    r0 = torch.as_tensor(rows0, device=dev) % (side - h + 1).clamp(min=1)
    c0 = torch.as_tensor(cols0, device=dev) % (side - w + 1).clamp(min=1)
    grid = torch.arange(side, device=dev)
    rows, cols = grid[None, :, None], grid[None, None, :]
    rect = ((rows >= r0[:, None, None]) & (rows < (r0 + h)[:, None, None])
            & (cols >= c0[:, None, None]) & (cols < (c0 + w)[:, None, None]))
    use = torch.as_tensor(select, device=dev) < prob
    return torch.where(use, rect.reshape(B, S), mask_random)
