"""Omni attention masks as vectorised tensor code.

Counterpart of ``showo_tpu/ops/masks.py`` for the v1 text-to-image,
stage-1 training, understanding and long-video paths:
``omni_mask_predict_next``, ``omni_mask_mmu``, ``omni_mask_mmu_vit``,
``omni_mask_lvg``, ``omni_mask_lvg_v2`` and their helpers, bit-exact with
the JAX functions including the ``rm_pad_in_image``, batch-first-eoi and
lvg_v2 column-0 quirks.  Boolean masks use
True = "may attend"; ``to_additive`` turns them into the additive bias
(0 where visible, ``NEG_INF`` elsewhere) that the dense attention path
adds to its scores.
"""

from __future__ import annotations

import torch

# Large-negative fill for masked logits: far below any attainable logit
# yet finite, so an fp32 or bf16 softmax stays NaN-free.
NEG_INF = -1e9


def to_additive(mask_bool: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., L, L] bool (True = attend) -> additive bias (0 / NEG_INF)."""
    zero = torch.zeros((), dtype=dtype, device=mask_bool.device)
    return torch.where(mask_bool, zero, torch.full_like(zero, NEG_INF))


def _causal(L: int, device=None) -> torch.Tensor:
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    return j <= i


def _image_segments(sequence: torch.Tensor, soi_id: int,
                    eoi_id: int) -> torch.Tensor:
    """True where a token lies inside (inclusive) an soi..eoi span."""
    is_soi = sequence == soi_id
    is_eoi = sequence == eoi_id
    c_soi = torch.cumsum(is_soi.int(), dim=1)
    c_eoi = torch.cumsum(is_eoi.int(), dim=1)
    return (c_soi > c_eoi) | is_soi | is_eoi


def _first_index(cond: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (its length if none)."""
    n = cond.shape[dim]
    idx = torch.argmax(cond.int(), dim=dim)
    return torch.where(cond.any(dim=dim), idx, torch.full_like(idx, n))


def _last_index(cond: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the last True along ``dim`` (-1 if none)."""
    n = cond.shape[dim]
    idx = n - 1 - torch.argmax(torch.flip(cond, dims=(dim,)).int(), dim=dim)
    return torch.where(cond.any(dim=dim), idx, torch.full_like(idx, -1))


def omni_mask_predict_next(
    sequence: torch.Tensor,
    pad_id: int,
    soi_id: int,
    eoi_id: int,
    rm_pad_in_image: bool = False,
    return_inverse_mask: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    """The v1 "omni" mask: causal for text rows, fully bidirectional for
    image-span rows.  sequence: [N, L] token ids.  Returns [N, 1, L, L]."""
    N, L = sequence.shape
    dev = sequence.device
    is_pad = sequence == pad_id
    in_image = _image_segments(sequence, soi_id, eoi_id)
    is_text = ~in_image
    causal = _causal(L, dev)

    mask_text = is_text[:, :, None] & causal[None, :, :]
    mask_bi = torch.ones((N, L, L), dtype=torch.bool, device=dev)

    if rm_pad_in_image:
        # rows after the last pad do not attend to columns <= last pad
        pad_end = _last_index(is_pad, dim=1)
        has_pad = is_pad.any(dim=1)
        i = torch.arange(L, device=dev)[None, :, None]
        j = torch.arange(L, device=dev)[None, None, :]
        after_rows = i > pad_end[:, None, None]
        upto_cols = j <= pad_end[:, None, None]
        mask_text = mask_text & ~(has_pad[:, None, None] & after_rows
                                  & upto_cols)
        # from the (first) soi row onward, no attending to pad columns
        sid = _first_index(sequence == soi_id, dim=1)
        from_soi = i >= sid[:, None, None]
        mask_bi = mask_bi & ~(from_soi & is_pad[:, None, :])

    mask = torch.where(in_image[:, :, None], mask_bi, mask_text)[:, None]
    if return_inverse_mask:
        return to_additive(mask, dtype)
    return mask


def omni_mask_mmu(
    sequence: torch.Tensor,
    eoi_id: int,
    return_inverse_mask: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    """The mmu mask: causal, plus full visibility of the image prefix.
    Reference quirk kept: the cutoff column is the first eoi of the batch
    flattened in row order (the first eoi of the first row that has one),
    applied to every row.  Returns [N, 1, L, L]."""
    N, L = sequence.shape
    is_eoi = sequence == eoi_id
    row_first = _first_index(is_eoi, dim=1)
    first_row = _first_index(is_eoi.any(dim=1), dim=0)
    eoi_col = row_first[first_row.clamp(0, N - 1)]
    j = torch.arange(L, device=sequence.device)[None, None, None, :]
    mask = _causal(L, sequence.device)[None, None] | (j <= eoi_col)
    mask = mask.expand(N, 1, L, L)
    if return_inverse_mask:
        return to_additive(mask, dtype)
    return mask


def omni_mask_mmu_vit(
    N: int,
    L: int,
    system_prompt_len: int = 0,
    num_patches: int = 576,
    return_inverse_mask: bool = True,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """The mmu mask of the CLIP-ViT path: causal, plus full visibility of
    the spliced image-feature span ``[2 + system_prompt_len, + num_patches)``
    (after ``[mmu] system [soi]``).  Shape-only.  Returns [N, 1, L, L]."""
    lo = 1 + system_prompt_len + 1
    j = torch.arange(L, device=device)[None, :]
    mask = _causal(L, device) | ((j >= lo) & (j < lo + num_patches))
    mask = mask[None, None].expand(N, 1, L, L)
    if return_inverse_mask:
        return to_additive(mask, dtype)
    return mask


def _span_positions(flags: torch.Tensor, count: int) -> torch.Tensor:
    """Positions of the first ``count`` True flags of each row, [N, count]
    int32 (L where a row has fewer: rows are expected to hold exactly
    ``count`` markers, as the reference's reshape to [N, count] needs)."""
    if count == 0:
        return torch.zeros((flags.shape[0], 0), dtype=torch.int32,
                           device=flags.device)
    order = torch.cumsum(flags.int(), dim=1) - 1   # occurrence index
    return torch.stack([_first_index(flags & (order == k), dim=1)
                        for k in range(count)], dim=1).int()


def omni_mask_lvg(
    sequence: torch.Tensor,
    pad_id: int,
    soi_id: int,
    eoi_id: int,
    num_images: int,
    return_inverse_mask: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    """The long-video mask (prompting_utils.py:513-538): causal, pad
    columns hidden from the first soi row on, then each of the
    ``num_images`` soi..eoi spans fully visible within itself (over the pad
    hiding).  Returns [N, 1, L, L]."""
    N, L = sequence.shape
    dev = sequence.device
    is_pad = sequence == pad_id
    soi_pos = _span_positions(sequence == soi_id, num_images)
    eoi_pos = _span_positions(sequence == eoi_id, num_images)
    i = torch.arange(L, device=dev)[None, :, None]
    j = torch.arange(L, device=dev)[None, None, :]
    first_soi = soi_pos[:, 0][:, None, None]
    mask = _causal(L, dev)[None] & ~((i >= first_soi) & is_pad[:, None, :])
    for k in range(num_images):
        s = soi_pos[:, k][:, None, None]
        e = eoi_pos[:, k][:, None, None]
        mask = mask | ((i >= s) & (i <= e) & (j >= s) & (j <= e))
    mask = mask[:, None]
    if return_inverse_mask:
        return to_additive(mask, dtype)
    return mask


def omni_mask_lvg_v2(
    sequence: torch.Tensor,
    pad_id: int,
    soi_id: int,
    eoi_id: int,
    sot_id: int,
    eot_id: int,
    num_images: int,
    num_texts: int,
    return_inverse_mask: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    """The lvg_v2 mask (prompting_utils.py:541-589): text tokens (ids below
    ``pad_id``) and the sot..eot text spans are visible to every row, the
    image spans only to non-text rows, under the causal mask; pad columns
    hidden from the first soi row on; each image span bidirectional; and
    column 0 visible to every row (the reference's line 580,
    ``mask[:, :, 0] = 1``).  With ``sot_id == eot_id`` the shared markers
    pair up in order (even occurrences open a span).  Returns
    [N, 1, L, L]."""
    N, L = sequence.shape
    dev = sequence.device
    is_pad = sequence == pad_id
    is_text = sequence < pad_id
    if sot_id == eot_id:
        marks = _span_positions(sequence == sot_id, 2 * num_texts)
        sot_pos, eot_pos = marks[:, 0::2], marks[:, 1::2]
    else:
        sot_pos = _span_positions(sequence == sot_id, num_texts)
        eot_pos = _span_positions(sequence == eot_id, num_texts)
    soi_pos = _span_positions(sequence == soi_id, num_images)
    eoi_pos = _span_positions(sequence == eoi_id, num_images)
    i = torch.arange(L, device=dev)[None, :, None]
    j = torch.arange(L, device=dev)[None, None, :]

    # the reference's visibility matrix before the causal cut
    allowed = is_text[:, None, :].expand(N, L, L)
    for k in range(num_texts):
        s = sot_pos[:, k][:, None, None]
        e = eot_pos[:, k][:, None, None]
        allowed = allowed | ((j >= s) & (j <= e))
    for k in range(num_images):
        s = soi_pos[:, k][:, None, None]
        e = eoi_pos[:, k][:, None, None]
        allowed = allowed | (~is_text[:, :, None] & (j >= s) & (j <= e))
    mask = _causal(L, dev)[None] & allowed
    first_soi = soi_pos[:, 0][:, None, None]
    mask = mask & ~((i >= first_soi) & is_pad[:, None, :])
    for k in range(num_images):
        s = soi_pos[:, k][:, None, None]
        e = eoi_pos[:, k][:, None, None]
        mask = mask | ((i >= s) & (i <= e) & (j >= s) & (j <= e))
    mask[:, :, 0] = True
    mask = mask[:, None]
    if return_inverse_mask:
        return to_additive(mask, dtype)
    return mask
