"""Show-o v1 long-video generation (lvg).

Counterpart of ``showo_tpu/pipelines/lvg.py``.  The reference trains an
lvg task (training/prompting_utils.py:309-390, its mask
create_attention_mask_lvg :513-538) but ships no generation entry point;
this one generates the frames in order, each by uncached MaskGIT over the
whole sequence while it attends to a window of up to ``context_frames``
frames before it through the lvg mask:

    [pad.. t2i bos text eos] [soi F_{f-k} eoi] .. [soi F_{f-1} eoi]
    [soi ?? eoi]

Frame 0 is plain t2i, or with a first frame given its MAGVIT-v2 codes.
Attention is dense under the additive lvg mask, as in JAX; the frames are
decoded one by one, unclamped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from showo_tpu_torch.models.magvit import MagvitV2
from showo_tpu_torch.models.showo import Showo, showo_t2i_generate
from showo_tpu_torch.ops.masks import omni_mask_lvg
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.schedules import get_mask_schedule


@dataclasses.dataclass
class LVGPipeline:
    model: Showo
    vq: MagvitV2
    uni_prompting: UniversalPrompting
    guidance_scale: float = 1.75
    timesteps: int = 16
    temperature: float = 1.0
    mask_schedule: str = "cosine"
    context_frames: int = 2

    def __post_init__(self):
        self.cfg = self.model.cfg
        self._schedule = get_mask_schedule(self.mask_schedule)

    @property
    def device(self) -> torch.device:
        return self.model.showo.lm_head.weight.device

    def frame_payload(self, context: Sequence[np.ndarray],
                      batch: int) -> np.ndarray:
        """The image-token payload of a frame after ``context`` (codes
        [batch, N] each): ``F_a eoi soi F_b eoi soi .. ??_N`` (the unified
        ids of each context frame, then N mask tokens); the ``lvg_gen`` prompt
        adds the outer soi / eoi, so each frame is one span."""
        sp = self.uni_prompting.sptids
        parts = []
        for codes in context:
            parts += [codes + self.cfg.codebook_offset,
                      np.full((batch, 1), sp["<|eoi|>"], np.int64),
                      np.full((batch, 1), sp["<|soi|>"], np.int64)]
        parts.append(np.full((batch, self.cfg.num_vq_tokens),
                             self.cfg.mask_token_id, np.int64))
        return np.concatenate(parts, axis=1)

    def frame_codes(self, prompts: Sequence[str],
                    context: Sequence[np.ndarray],
                    generator: Optional[torch.Generator] = None,
                    injected_noise=None) -> np.ndarray:
        """The next frame's codes [B, N] in [0, codebook_size) after the
        ``context`` frames' codes, by MaskGIT with CFG under the lvg mask;
        ``injected_noise`` as ``maskgit_generate`` takes it."""
        B = len(prompts)
        sp = self.uni_prompting.sptids
        payload = self.frame_payload(context, B)
        ids, _ = self.uni_prompting((list(prompts), payload), "lvg_gen")
        uncond, _ = self.uni_prompting(([""] * B, payload), "lvg_gen")
        pair = (np.concatenate([ids, uncond], axis=0)
                if self.guidance_scale > 0 else ids)
        dev = self.device
        bias = omni_mask_lvg(torch.as_tensor(pair, device=dev),
                             pad_id=sp["<|pad|>"], soi_id=sp["<|soi|>"],
                             eoi_id=sp["<|eoi|>"],
                             num_images=len(context) + 1)
        # the prompt is everything before the last (masked) span's tokens
        codes = showo_t2i_generate(
            self.model, torch.as_tensor(ids, device=dev), generator,
            uncond_input_ids=torch.as_tensor(uncond, device=dev),
            attention_bias=bias, guidance_scale=self.guidance_scale,
            temperature=self.temperature, timesteps=self.timesteps,
            noise_schedule=self._schedule,
            max_seq_length=ids.shape[1] - self.cfg.num_vq_tokens - 2,
            injected_noise=injected_noise, pad_id=sp["<|pad|>"],
            soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"])
        codes = torch.clamp(codes, 0, self.cfg.codebook_size - 1)
        return codes.cpu().numpy().astype(np.int64)

    def generate_codes(self, prompts: Sequence[str], num_frames: int,
                       generator: Optional[torch.Generator] = None,
                       first_frame_nhwc: Optional[np.ndarray] = None,
                       injected_noise=None) -> List[np.ndarray]:
        """Each frame's codes [B, N]; ``first_frame_nhwc`` [B, H, W, 3] in
        [-1, 1] makes frame 0 its MAGVIT-v2 codes.  ``injected_noise``: one
        noise pair per generated frame."""
        frames: List[np.ndarray] = []
        if first_frame_nhwc is not None:
            vq_dtype = next(self.vq.parameters()).dtype
            pixels = torch.as_tensor(np.asarray(first_frame_nhwc),
                                     device=self.device, dtype=vq_dtype)
            frames.append(self.vq.get_code(pixels).cpu().numpy().astype(
                np.int64))
        noise = iter(injected_noise or ())
        while len(frames) < num_frames:
            frames.append(self.frame_codes(
                prompts, frames[-self.context_frames:], generator,
                next(noise, None)))
        return frames

    def decode(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """Codes [B, N] a frame -> NHWC float32 frames [B, T, H, W, 3]."""
        return np.stack([self.vq.decode_code(torch.as_tensor(
            c, device=self.device)).float().cpu().numpy() for c in frames],
            axis=1)

    def generate(self, prompts: Sequence[str], num_frames: int,
                 generator: Optional[torch.Generator] = None,
                 first_frame_nhwc: Optional[np.ndarray] = None,
                 injected_noise=None) -> np.ndarray:
        """NHWC float32 frames [B, T, H, W, 3], one video per prompt."""
        return self.decode(self.generate_codes(
            prompts, num_frames, generator, first_frame_nhwc,
            injected_noise))
