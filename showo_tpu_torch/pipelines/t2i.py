"""Show-o v1 text-to-image pipeline: t2i, inpainting and extrapolation.

Counterpart of ``showo_tpu/pipelines/t2i.py``: assembles the t2i layout
with the numpy ``UniversalPrompting``, builds the omni mask, runs
prefix-cached MaskGIT with CFG and decodes the codes with MAGVIT-v2.
Inpainting encodes the image with MAGVIT-v2 and re-generates the tokens
under the downsampled mask; extrapolation slides half-canvas windows and
stitches the re-generated halves (reference inference_t2i.py:80-284).
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
from showo_tpu_torch.utils.image import bicubic_resize_mask


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
    resolution: int = 256
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

    def run(self, prompts: Sequence[str], image_tokens: np.ndarray,
            generator: Optional[torch.Generator] = None,
            injected_noise=None) -> torch.Tensor:
        """Cached MaskGIT with CFG from the image tokens ``image_tokens``
        [B, num_vq_tokens] (unified vocabulary ids; ``mask_token_id`` where
        a token is to be generated).  Returns codes in [0,
        codebook_size)."""
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

    def generate_codes(self, prompts: Sequence[str],
                       generator: Optional[torch.Generator] = None,
                       injected_noise=None) -> torch.Tensor:
        """t2i mode up to the image tokens: all-mask init, cached MaskGIT.
        Returns codes [B, num_vq_tokens] in [0, codebook_size)."""
        image_tokens = np.full((len(prompts), self.cfg.num_vq_tokens),
                               self.cfg.mask_token_id, np.int64)
        return self.run(prompts, image_tokens, generator, injected_noise)

    def decode(self, codes: torch.Tensor, hw=None) -> np.ndarray:
        """Codes [B, h*w] -> NHWC float32 images clamped to [-1, 1]."""
        images = self.vq.decode_code(codes, hw).float().clamp(-1.0, 1.0)
        return images.cpu().numpy()

    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 injected_noise=None) -> np.ndarray:
        """t2i mode.  Returns NHWC float32 images, clamped to [-1, 1]."""
        return self.decode(self.generate_codes(prompts, generator,
                                               injected_noise))

    def encode(self, image_nhwc: np.ndarray) -> np.ndarray:
        """One NHWC image in [-1, 1] ([H, W, 3]) -> its MAGVIT-v2 codes
        [1, h*w] as unified vocabulary ids (codes + the text vocabulary),
        int64 on the host."""
        vq_dtype = next(self.vq.parameters()).dtype
        pixels = torch.as_tensor(np.asarray(image_nhwc)[None],
                                 device=self.device, dtype=vq_dtype)
        codes = self.vq.get_code(pixels)
        return codes.cpu().numpy().astype(np.int64) + self.cfg.codebook_offset

    def inpaint_codes(self, prompt: str, image_nhwc: np.ndarray,
                      mask_hw: np.ndarray,
                      generator: Optional[torch.Generator] = None,
                      batch_size: int = 1, injected_noise=None):
        """Inpainting up to the codes [batch_size, num_vq_tokens]: the
        image's tokens with the positions under the mask (bicubically
        downsampled to the token grid, binarized at 0.5) set to
        ``mask_token_id``, then the cached MaskGIT of :meth:`run`."""
        tokens = self.encode(image_nhwc).repeat(batch_size, axis=0)
        lowres = bicubic_resize_mask(mask_hw, self.resolution // 16)
        tokens[:, lowres.reshape(-1).astype(bool)] = self.cfg.mask_token_id
        return self.run([prompt] * batch_size, tokens, generator,
                        injected_noise)

    def inpaint(self, prompt: str, image_nhwc: np.ndarray,
                mask_hw: np.ndarray,
                generator: Optional[torch.Generator] = None,
                batch_size: int = 1, injected_noise=None) -> np.ndarray:
        """Inpainting mode (reference inference_t2i.py:80-131): NHWC
        float32 images in [-1, 1], ``batch_size`` of them."""
        return self.decode(self.inpaint_codes(
            prompt, image_nhwc, mask_hw, generator, batch_size,
            injected_noise))

    def extrapolate_codes(self, prompts: Sequence[str],
                          directions: Sequence[str], image_nhwc: np.ndarray,
                          generator: Optional[torch.Generator] = None,
                          offset: int = 0, batch_size: int = 1,
                          injected_noise=None) -> np.ndarray:
        """Extrapolation up to the stitched code grid [batch_size, h, w]
        (host int64).  For each (prompt, direction) a W x W window (W the
        token grid's side) holds ``W // 2 + offset`` rows or columns of
        ``mask_token_id`` on the side of ``direction`` and the canvas's
        edge on the other; one generate fills it, and its codes are
        stitched to the canvas.  The generates draw from ``generator`` in
        turn; ``injected_noise``, when given, holds one noise pair per
        direction.  As in the JAX package, ``down`` stitches the new
        codes below the canvas's upper part (the reference uses its left
        part there)."""
        W = self.resolution // 16
        shift = W // 2 - offset
        vocab, mask_id = self.cfg.codebook_offset, self.cfg.mask_token_id
        gen_grid = None
        for idx, (prompt, direction) in enumerate(zip(prompts, directions)):
            if direction not in ("left", "right", "up", "down"):
                raise ValueError(f"unknown extrapolation direction "
                                 f"{direction!r}")
            if idx == 0:
                grid = self.encode(image_nhwc).reshape(1, W, W).repeat(
                    batch_size, axis=0)
            else:
                grid = gen_grid + vocab
            left = grid[:, :, :-shift] - vocab
            right = grid[:, :, shift:] - vocab
            up = grid[:, :-shift, :] - vocab
            down = grid[:, shift:, :] - vocab
            if direction in ("left", "right"):
                blank = np.full((batch_size, W, W // 2 + offset), mask_id,
                                np.int64)
            else:
                blank = np.full((batch_size, W // 2 + offset, W), mask_id,
                                np.int64)
            if direction == "left":
                window = np.concatenate([blank, grid[:, :, :shift]], axis=-1)
            elif direction == "right":
                window = np.concatenate([grid[:, :, -shift:], blank], axis=-1)
            elif direction == "up":
                window = np.concatenate([blank, grid[:, :shift, :]], axis=-2)
            else:
                window = np.concatenate([grid[:, -shift:, :], blank], axis=-2)
            noise = None if injected_noise is None else injected_noise[idx]
            codes = self.run([prompt] * batch_size,
                             window.reshape(batch_size, -1), generator,
                             noise).cpu().numpy().reshape(batch_size, W, W)
            if direction == "left":
                gen_grid = np.concatenate([codes, right], axis=-1)
            elif direction == "right":
                gen_grid = np.concatenate([left, codes], axis=-1)
            elif direction == "up":
                gen_grid = np.concatenate([codes, down], axis=-2)
            else:
                gen_grid = np.concatenate([up, codes], axis=-2)
        return gen_grid

    def extrapolate(self, prompts: Sequence[str], directions: Sequence[str],
                    image_nhwc: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    offset: int = 0, batch_size: int = 1,
                    injected_noise=None) -> np.ndarray:
        """Extrapolation mode (reference inference_t2i.py:166-284): NHWC
        float32 images in [-1, 1] of the stitched, non-square canvas."""
        grid = self.extrapolate_codes(prompts, directions, image_nhwc,
                                      generator, offset, batch_size,
                                      injected_noise)
        _, h, w = grid.shape
        codes = torch.as_tensor(grid.reshape(batch_size, -1),
                                device=self.device)
        return self.decode(codes, (h, w))
