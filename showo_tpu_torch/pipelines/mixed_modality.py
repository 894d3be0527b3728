"""Show-o2 interleaved mixed-modality generation.

Counterpart of ``showo_tpu/pipelines/mixed_modality.py`` (show-o2/
inference_mixed_modality.py:128-267): rounds that alternate AR text (top-k
sampling over a KV cache, stopping at eos or the image-start token) with
flow-matching image generation, in which the images of earlier rounds are
clean history (t = 1) and only the last is denoised
(``only_denoise_last_image``).  The image rounds' attention is dense under
the additive omni mask with one span per image, as in JAX (which runs no
kernel here); the history is decoded as one-frame clips.

The cond and uncond halves of the CFG batch carry the same rows, as in
JAX, so the guided velocity is the conditional one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from showo_tpu_torch.ops.masks import _causal, to_additive
from showo_tpu_torch.sampling.ar import ar_generate
from showo_tpu_torch.show_o2.masks import omni_attn_mask
from showo_tpu_torch.show_o2.qwen2 import Qwen2KVCache
from showo_tpu_torch.show_o2.showo2 import (Showo2, fuse_inference,
                                            showo2_t2i_velocity)
from showo_tpu_torch.show_o2.transport import ode_timegrid, sample_ode_euler
from showo_tpu_torch.show_o2.wan_vae import WanVAE, wan_decode


@dataclasses.dataclass
class MixedModalityPipeline:
    model: Showo2
    vae: WanVAE
    tokenizer: object
    token_ids: dict
    guidance_scale: float = 5.0
    num_steps: int = 20
    time_shifting_factor: float = 3.0
    max_new_tokens: int = 60
    top_k: Optional[int] = 5
    top_p: Optional[float] = None

    def __post_init__(self):
        # inference-only weight re-layout (in place), as the JAX default
        fuse_inference(self.model)
        self.cfg = self.model.cfg
        self.t_grid = ode_timegrid(
            self.num_steps, time_shifting_factor=self.time_shifting_factor)

    @property
    def device(self) -> torch.device:
        return self.model.showo.model.embed_tokens.weight.device

    def _tok(self, text: str) -> List[int]:
        ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        return list(ids)

    @torch.no_grad()
    def lm_generate(self, prompt_ids: Sequence[int],
                    generator: Optional[torch.Generator] = None,
                    injected_gumbel=None) -> List[int]:
        """AR text after ``prompt_ids`` (reference lm_generate,
        modeling_showo2_qwen2_5.py:576-644): a prefill under the causal
        mask into a cache of ``len(prompt_ids) + max_new_tokens`` rows,
        then ``max_new_tokens`` decode forwards; the tokens up to and
        including the first eos or image-start token.  ``injected_gumbel``
        [max_new_tokens + 1, 1, V] replaces the draws."""
        qwen, ids = self.model.showo, self.token_ids
        prompt = torch.tensor([list(prompt_ids)], device=self.device)
        B, S = prompt.shape
        cap = S + self.max_new_tokens
        dtype = qwen.model.embed_tokens.weight.dtype

        def prefill(p_ids, _bias):
            cache = Qwen2KVCache.zeros(self.cfg.llm, B, cap, dtype=dtype,
                                       device=self.device)
            bias = to_additive(_causal(cap, self.device)[None, None, :S])
            logits, _ = qwen(input_ids=p_ids, attention_bias=bias,
                             cache=cache)
            return logits, cache

        def decode(tok_ids, bias, cache):
            logits, _ = qwen(input_ids=tok_ids, attention_bias=bias,
                             cache=cache)
            return logits, cache

        toks, valid = ar_generate(
            prefill, decode, prompt, generator,
            max_new_tokens=self.max_new_tokens, top_k=self.top_k,
            top_p=self.top_p, eot_token=ids["eos_id"],
            injected_gumbel=injected_gumbel)
        out = []
        for t in toks[0][valid[0]].tolist():
            out.append(int(t))
            if t in (ids["eos_id"], ids["boi_id"]):
                break
        return out

    @torch.no_grad()
    def denoise_last(self, text_tokens: torch.Tensor, mp: torch.Tensor,
                     history: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     noise=None) -> torch.Tensor:
        """JAX ``_denoise_last``: Euler over the last image's latents [1, C,
        h, w] (fp32) under CFG, the M - 1 ``history`` latents held at t = 1
        in the spans before it.  text_tokens [1, L]; mp [1, M, 2].  z is
        drawn from ``generator`` or taken from ``noise``."""
        cfg = self.cfg
        M = mp.shape[1]
        shape = (1, cfg.image_latent_dim, cfg.image_latent_height,
                 cfg.image_latent_width)
        if noise is None:
            z = torch.randn(shape, generator=generator, device=self.device)
        else:
            z = torch.as_tensor(noise, dtype=torch.float32,
                                device=self.device).reshape(shape)
        text2 = torch.cat([text_tokens, text_tokens], dim=0)
        mp2 = torch.cat([mp, mp], dim=0)
        bias = omni_attn_mask(mp2, text2.shape[1])
        ones = torch.ones((M - 1,), device=self.device)

        def drift(x_last, t):
            # x_last [2, C, h, w]: the cond and uncond copies of the image
            lat = torch.cat([history, x_last[:1]], dim=0)
            t_img = torch.cat([ones, t[:1]])
            v = showo2_t2i_velocity(
                self.model, text2, torch.cat([lat, lat], dim=0),
                torch.cat([t_img, t_img]), bias, mp2,
                guidance_scale=self.guidance_scale,
                only_denoise_last_image=True)
            return torch.stack([v[M - 1], v[2 * M - 1]])

        return sample_ode_euler(drift, torch.cat([z, z], dim=0),
                                self.t_grid)[:1]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """Image latents [N, C, h, w] -> NHWC float32 images in [-1, 1] (as
        one-frame clips)."""
        if latents.shape[0] == 0:
            return np.zeros((0, 1, 1, 3), np.float32)
        z = latents.to(self.vae.conv2.weight.dtype)[:, :, None]
        return wan_decode(self.vae, z)[:, :, 0].permute(
            0, 2, 3, 1).float().cpu().numpy()

    def generate(self, prompt: str,
                 generator: Optional[torch.Generator] = None,
                 num_rounds: int = 2, injected=None
                 ) -> Tuple[List[List[int]], np.ndarray]:
        """Alternate text and images for up to ``num_rounds`` rounds (a
        round that ends in eos, or makes no text, ends the story).  Returns
        (each round's text tokens, the images [N, H, W, 3]).  ``injected``:
        one (Gumbel noise, z) pair a round, replacing the round's draws."""
        ids, cfg = self.token_ids, self.cfg
        n_img = cfg.num_image_tokens
        tokens = [ids["bos_id"]] + self._tok(prompt)
        history = torch.zeros((0, cfg.image_latent_dim,
                               cfg.image_latent_height,
                               cfg.image_latent_width), device=self.device)
        rounds: List[List[int]] = []
        spans: List[Tuple[int, int]] = []
        for r in range(num_rounds):
            gumbel, z = injected[r] if injected is not None else (None, None)
            new_text = self.lm_generate(tokens, generator, gumbel)
            rounds.append(new_text)
            tokens = tokens + new_text
            if not new_text or new_text[-1] == ids["eos_id"]:
                break
            if new_text[-1] != ids["boi_id"]:
                tokens.append(ids["boi_id"])
            # the image span: [boi] (in tokens) [img_pad x n] [eoi]
            spans.append((len(tokens), n_img))
            tokens += [ids["img_pad_id"]] * n_img + [ids["eoi_id"]]
            latents = self.denoise_last(
                torch.tensor([tokens], device=self.device),
                torch.tensor([spans], device=self.device), history,
                generator, z)
            history = torch.cat([history, latents], dim=0)
        return rounds, self.decode(history)
