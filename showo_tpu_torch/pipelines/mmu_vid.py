"""Show-o2 video understanding pipeline.

Counterpart of ``showo_tpu/pipelines/mmu_vid.py`` (the reference
inference_mmu_vid.py): uniformly sampled frames through the Wan2.1 VAE
encoder as one clip (the time downsamples give 1 + (T-1)/4 latent frames),
the dual-path embedding per latent frame, then the scaffold, mask and
KV-cached decode of :class:`~showo_tpu_torch.pipelines.mmu_v2.MMUV2Pipeline`
with a span of every frame's patches and the time token.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from showo_tpu_torch.pipelines.mmu_v2 import SYSTEM_PROMPT, MMUV2Pipeline
from showo_tpu_torch.show_o2.showo2 import embed_images


@dataclasses.dataclass
class MMUVidPipeline(MMUV2Pipeline):
    num_frames: int = 9

    def span(self, latent_frames: int) -> int:
        """The mask's span: every latent frame's patches, plus the time
        token where the model adds one."""
        cfg = self.cfg
        per_frame = ((cfg.image_latent_height // cfg.patch_size)
                     * (cfg.image_latent_width // cfg.patch_size))
        return latent_frames * per_frame + (1 if cfg.add_time_embeds else 0)

    @torch.no_grad()
    def answer_video(self, frames_thwc: np.ndarray, question: str,
                     generator: Optional[torch.Generator] = None,
                     injected_gumbel=None, injected_eps=None,
                     system_prompt: str = SYSTEM_PROMPT) -> List[int]:
        """frames [T, H, W, 3] in [-1, 1] -> the answer's token ids (noise
        as :meth:`MMUV2Pipeline.answer` takes it; ``injected_eps`` of the
        clip's latents [1, C, T', h, w])."""
        frames = torch.as_tensor(np.asarray(frames_thwc, np.float32),
                                 device=self.device)
        latents = self.encode(frames.permute(3, 0, 1, 2)[None], generator,
                              injected_eps)
        embeds, bias = self.prompt(embed_images(self.model, latents),
                                   self.span(latents.shape[2]), question,
                                   system_prompt)
        return self.generate(embeds, bias, generator, injected_gumbel)
