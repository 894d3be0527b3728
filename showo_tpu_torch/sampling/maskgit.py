"""MaskGIT discrete-diffusion sampling as a Python loop over steps.

Counterpart of ``showo_tpu/sampling/maskgit.py``, faithful to the
reference loop including its compounding temperature decay
(``temperature = temperature * (1 - ratio)`` each step), the ``finfo.max``
confidence of already-known tokens and the ``mask_len`` clamp.  The
cond/uncond CFG forward is one batched call.  The scalar schedule
arithmetic is kept in fp32 tensors so it rounds as the JAX loop does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from showo_tpu_torch.sampling.schedules import cosine_schedule


def _log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(torch.clamp(t, min=eps))


def gumbel_noise(shape, generator: Optional[torch.Generator], device,
                 dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -_log(-_log(u))


def _remask(selected, temp, noise, mask_len):
    """True where a token is re-masked: the ``mask_len`` lowest
    confidences (log p + temp * gumbel) of each row."""
    confidence = _log(selected) + temp * noise
    cut_off = torch.gather(torch.sort(confidence, dim=-1).values, -1,
                           mask_len.long())
    return confidence < cut_off


@torch.no_grad()
def maskgit_generate(
    forward_fn: Callable[[torch.Tensor], torch.Tensor],
    input_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    uncond_input_ids: Optional[torch.Tensor] = None,
    num_vq_tokens: int,
    mask_token_id: int,
    codebook_offset: int,
    codebook_size: int,
    prompt_len: int,
    timesteps: int = 18,
    guidance_scale: float = 0.0,
    temperature: float = 1.0,
    noise_schedule=cosine_schedule,
    injected_noise=None,
    forward_returns_sliced: bool = False,
) -> torch.Tensor:
    """Generate image tokens by iterative parallel decoding.

    forward_fn: ids [B', L] -> logits (the full [B', L, V], or with
        ``forward_returns_sliced`` only image rows x codebook columns).
    input_ids: [B, L] with the image slice (L-1-num_vq_tokens .. L-2) set
        to ``mask_token_id`` (or partly known tokens).
    generator: source of the Gumbel noise when ``injected_noise`` is None.
    injected_noise: optional (g_sample [T, B, N, C], g_conf [T, B, N])
        Gumbel arrays: sampling becomes argmax(log p + g), so tokens can be
        compared exactly with another implementation fed the same noise.
    Returns the final image tokens in codebook space, [B, num_vq_tokens].
    """
    B, L = input_ids.shape
    dev = input_ids.device
    img_lo = L - num_vq_tokens - 1
    ids = input_ids.clone()
    img = ids[:, img_lo:L - 1]
    codes = torch.where(img == mask_token_id, mask_token_id,
                        img - codebook_offset)
    use_cfg = uncond_input_ids is not None and guidance_scale > 0
    if use_cfg:
        uncond_prefix = uncond_input_ids[:, :prompt_len]
    if injected_noise is not None:
        g_sample, g_conf = (torch.as_tensor(g, device=dev)
                            for g in injected_noise)
    temp = torch.tensor(temperature, dtype=torch.float32, device=dev)

    sampled = codes
    for step in range(timesteps):
        if use_cfg:
            uncond_ids = torch.cat([uncond_prefix, ids[:, prompt_len:]], dim=1)
            logits_all = forward_fn(torch.cat([ids, uncond_ids], dim=0))
            cond_logits, uncond_logits = logits_all.chunk(2, dim=0)
            logits = ((1 + guidance_scale) * cond_logits
                      - guidance_scale * uncond_logits)
        else:
            logits = forward_fn(ids)
        if not forward_returns_sliced:
            logits = logits[:, img_lo:L - 1,
                            codebook_offset:codebook_offset + codebook_size]

        probs = torch.softmax(logits, dim=-1)
        if injected_noise is not None:
            noise = g_sample[step]
        else:
            noise = gumbel_noise(probs.shape, generator, dev)
        sampled = torch.argmax(_log(probs) + noise, dim=-1)

        unknown = codes == mask_token_id
        sampled = torch.where(unknown, sampled, codes)

        ratio = (torch.tensor(step + 1, dtype=torch.float32, device=dev)
                 / timesteps)
        mask_ratio = noise_schedule(ratio)

        selected = torch.gather(probs, -1, sampled[..., None])[..., 0]
        selected = torch.where(unknown, selected,
                               torch.finfo(selected.dtype).max)

        mask_len = torch.floor(num_vq_tokens * mask_ratio)
        mask_len = torch.clamp(
            torch.minimum(unknown.sum(dim=-1, keepdim=True) - 1.0, mask_len),
            min=1.0)

        temp = temp * (1.0 - ratio)  # compounding decay, as the reference
        conf_noise = (g_conf[step] if injected_noise is not None
                      else gumbel_noise(selected.shape, generator, dev))
        masking = _remask(selected, temp, conf_noise, mask_len)

        new_img = torch.where(masking, mask_token_id,
                              sampled + codebook_offset)
        ids[:, img_lo:img_lo + num_vq_tokens] = new_img.to(ids.dtype)
        codes = torch.where(masking, mask_token_id, sampled)
    return sampled
