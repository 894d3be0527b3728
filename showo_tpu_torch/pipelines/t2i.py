"""Show-o v1 text-to-image pipeline (t2i mode).

Counterpart of ``showo_tpu/pipelines/t2i.py``: assembles the t2i layout
with the numpy ``UniversalPrompting``, builds the omni mask, runs
prefix-cached MaskGIT with CFG and decodes the codes with MAGVIT-v2.
Inpainting and extrapolation are not ported yet (the MAGVIT encoder they
need is, for training).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from showo_tpu_torch.models.magvit import MagvitV2
from showo_tpu_torch.models.phi import check_route, fuse_parallel_mlp
from showo_tpu_torch.models.showo import Showo, showo_t2i_generate_cached
from showo_tpu_torch.ops.masks import omni_mask_predict_next
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.schedules import get_mask_schedule


def route_attention(attn_impl: str, num_vq_tokens: int) -> str:
    """``auto``: the packed omni kernel at 512^2 (1024 image tokens and
    more), dense attention below, as the JAX pipeline routes.  Any other
    name must be a ported inference route of
    ``models/phi.py::ATTN_ROUTES`` (``trainable`` is self-attention only,
    which the prefix-cached steps are not)."""
    if attn_impl == "auto":
        return "packed" if num_vq_tokens >= 1024 else "dense"
    if check_route(attn_impl) == "trainable":
        raise ValueError("the trainable route is for training (self-"
                         "attention); the t2i pipeline's cached steps "
                         "attend to a prefix")
    return attn_impl


@dataclasses.dataclass
class T2IPipeline:
    model: Showo
    vq: MagvitV2
    uni_prompting: UniversalPrompting
    guidance_scale: float = 1.75
    timesteps: int = 16
    temperature: float = 1.0
    mask_schedule: str = "cosine"
    max_seq_length: int = 128
    # auto | dense | packed | omni | decode | fused | streaming (JAX: auto,
    # dense, pallas_packed, pallas, pallas_decode, pallas_fused,
    # pallas_streaming)
    attn_impl: str = "auto"

    def __post_init__(self):
        # inference-only weight re-layout, as the JAX pipeline's default
        # param_fusion="mlp": two wide matmuls per layer (win, wout)
        fuse_parallel_mlp(self.model.showo)
        self.cfg = self.model.cfg
        self.attn_route = route_attention(self.attn_impl,
                                          self.cfg.num_vq_tokens)
        self._schedule = get_mask_schedule(self.mask_schedule)

    @property
    def device(self) -> torch.device:
        return self.model.showo.lm_head.weight.device

    def build_inputs(self, prompts: Sequence[str], image_tokens: np.ndarray):
        """(ids, uncond_ids or None, bias) on the model's device."""
        sp = self.uni_prompting.sptids
        ids, _ = self.uni_prompting((list(prompts), image_tokens), "t2i_gen")
        uncond_ids, _ = self.uni_prompting(
            ([""] * len(prompts), image_tokens), "t2i_gen")
        use_cfg = self.guidance_scale > 0
        pair = np.concatenate([ids, uncond_ids], axis=0) if use_cfg else ids
        bias = omni_mask_predict_next(
            torch.as_tensor(pair, device=self.device), pad_id=sp["<|pad|>"],
            soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"], rm_pad_in_image=True)
        uncond = (torch.as_tensor(uncond_ids, device=self.device)
                  if use_cfg else None)
        return torch.as_tensor(ids, device=self.device), uncond, bias

    def generate_codes(self, prompts: Sequence[str],
                       generator: Optional[torch.Generator] = None,
                       injected_noise=None) -> torch.Tensor:
        """t2i mode up to the image tokens: all-mask init, cached MaskGIT.
        Returns codes [B, num_vq_tokens] in [0, codebook_size)."""
        B = len(prompts)
        image_tokens = np.full((B, self.cfg.num_vq_tokens),
                               self.cfg.mask_token_id, np.int64)
        ids, uncond_ids, bias = self.build_inputs(prompts, image_tokens)
        sp = self.uni_prompting.sptids
        codes = showo_t2i_generate_cached(
            self.model, ids, generator, uncond_input_ids=uncond_ids,
            attention_bias=bias, guidance_scale=self.guidance_scale,
            temperature=self.temperature, timesteps=self.timesteps,
            noise_schedule=self._schedule,
            max_seq_length=self.max_seq_length,
            injected_noise=injected_noise, attn_impl=self.attn_route,
            pad_id=sp["<|pad|>"], soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"])
        return torch.clamp(codes, 0, self.cfg.codebook_size - 1)

    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 injected_noise=None) -> np.ndarray:
        """t2i mode.  Returns NHWC float32 images, clamped to [-1, 1]."""
        codes = self.generate_codes(prompts, generator, injected_noise)
        images = self.vq.decode_code(codes).float().clamp(-1.0, 1.0)
        return images.cpu().numpy()
