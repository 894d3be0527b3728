"""Show-o2 omni attention mask and the modality scatter / gather.

Counterpart of ``showo_tpu/show_o2/masks.py``: the semantics of
show-o2/models/omni_attention.py:56-70 ``omni_attn_mask_naive`` (a causal
base, each (offset, length) span of ``modality_positions`` made fully
bidirectional within itself; a (0, 0) padding entry is an empty span),
and the vectorized forms of the reference's per-sample loops that put
image and time embeddings into the text slots (modality_scatter) and take
the velocity runs back out (modality_gather).
"""

from __future__ import annotations

from typing import Optional

import torch

from showo_tpu_torch.ops.masks import to_additive


def _span_hits(modality_positions: torch.Tensor, L: int):
    """(pos [1, L, 1], off [B, 1, M], length [B, 1, M]) for span tests."""
    mp = modality_positions
    pos = torch.arange(L, device=mp.device)[None, :, None]
    return pos, mp[:, None, :, 0], mp[:, None, :, 1]


def omni_attn_mask(modality_positions: torch.Tensor, L: int,
                   inverted: bool = True,
                   dtype=torch.float32) -> torch.Tensor:
    """[B, M, 2] (offset, length) spans -> [B, 1, L, L] mask; inverted=True
    returns the additive form (0 visible / NEG_INF hidden)."""
    mp = modality_positions
    i = torch.arange(L, device=mp.device)[None, :, None, None]
    j = torch.arange(L, device=mp.device)[None, None, :, None]
    off = mp[:, None, None, :, 0]
    length = mp[:, None, None, :, 1]
    in_i = (i >= off) & (i < off + length)
    in_j = (j >= off) & (j < off + length)
    block = (in_i & in_j).any(dim=-1)                              # [B, L, L]
    causal = torch.ones((L, L), dtype=torch.bool, device=mp.device).tril()
    mask = (causal[None] | block)[:, None]
    return to_additive(mask, dtype) if inverted else mask


def _claiming_span(hits: torch.Tensor) -> torch.Tensor:
    """[B, L, M] bool -> the index of the last span that claims each
    position (0 where none does), as JAX's argmax over m + 1."""
    M = hits.shape[-1]
    ids = torch.arange(M, device=hits.device)[None, None, :] + 1
    return torch.argmax(torch.where(hits, ids, 0), dim=-1)


def modality_scatter(input_embeds: torch.Tensor, image_embeds: torch.Tensor,
                     time_embeds: Optional[torch.Tensor],
                     modality_positions: torch.Tensor,
                     add_time_embeds: bool = True) -> torch.Tensor:
    """Scatter per-image embeddings (and a leading time-embed token) into
    the text-token slots given by modality_positions.

    input_embeds [B, L, D]; image_embeds [B*M, N, D] (N tokens per image,
    the time slot excluded); time_embeds [B*M, D]; modality_positions
    [B, M, 2].  Returns the updated [B, L, D].  As in the reference, the
    time slot is written unconditionally, so a (0, 0) padding entry
    overwrites position 0 with its time embedding; later spans win."""
    B, L, D = input_embeds.shape
    M = modality_positions.shape[1]
    N = image_embeds.shape[1]
    pos, off, length = _span_hits(modality_positions, L)
    if add_time_embeds:
        is_time = pos == off                                      # [B, L, M]
        in_img = (pos > off) & (pos < off + length)
        tok_idx = pos - off - 1
    else:
        is_time = torch.zeros((B, L, M), dtype=torch.bool,
                              device=input_embeds.device)
        in_img = (pos >= off) & (pos < off + length)
        tok_idx = pos - off
    span_id = _claiming_span(is_time | in_img)                    # [B, L]
    pick = span_id[:, :, None]
    claimed_time = torch.gather(is_time, 2, pick)[..., 0]
    claimed_img = torch.gather(in_img, 2, pick)[..., 0]
    tok = torch.gather(tok_idx.expand(B, L, M), 2, pick)[..., 0]
    flat = torch.arange(B, device=span_id.device)[:, None] * M + span_id
    tok = tok.clamp(0, N - 1)
    out = torch.where(claimed_img[..., None],
                      image_embeds[flat, tok].to(input_embeds.dtype),
                      input_embeds)
    if add_time_embeds and time_embeds is not None:
        out = torch.where(claimed_time[..., None],
                          time_embeds[flat].to(out.dtype), out)
    return out


def modality_gather(x: torch.Tensor, modality_positions: torch.Tensor,
                    num_tokens: int) -> torch.Tensor:
    """Per-image token runs [B*M, num_tokens, D] of [B, L, D] from each
    span's offset (the inverse of modality_scatter for the velocity);
    positions past L are clipped to L - 1."""
    B, L, D = x.shape
    M = modality_positions.shape[1]
    off = modality_positions[:, :, 0]                                 # [B, M]
    idx = off[:, :, None] + torch.arange(num_tokens, device=x.device)
    idx = idx.clamp(0, L - 1).reshape(B, M * num_tokens)
    out = torch.gather(x, 1, idx[:, :, None].expand(B, M * num_tokens, D))
    return out.reshape(B * M, num_tokens, D)
