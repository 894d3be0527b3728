"""Show-o2 multimodal understanding pipeline (image VQA over VAE latents).

Counterpart of ``showo_tpu/pipelines/mmu_v2.py`` (show-o2/inference_mmu.py
:95-170): the image through the Wan2.1 VAE encoder (fp32, reparameterised
latents), the dual-path embedding with the clean-image time embedding
(t = 1), the Qwen chat scaffold ``[bos] system \\nuser\\n [boi] [t]
[img x N] [eoi] question \\nassistant\\n`` under the v2 omni mask (the image
span made bidirectional), then AR decode over a KV cache.  Attention is
dense under the additive mask, as in JAX (its prefill passes no attention
metadata).

``fuse_weights`` re-lays both towers' weights for inference and
``quantize_int8`` turns every Qwen2 matmul and a vocabulary head quantized
from the tied embedding into the int8 kernel's ``Int8Linear``
(weight-only int8 serving), both in place on the model the pipeline is
given (JAX makes new parameter trees).  The prefill computes the logits of
every prompt row, as JAX's does; the sampler reads the last one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from showo_tpu_torch.sampling.ar import ar_generate
from showo_tpu_torch.show_o2.masks import omni_attn_mask
from showo_tpu_torch.show_o2.qwen2 import Qwen2KVCache, quantize_int8
from showo_tpu_torch.show_o2.showo2 import (Showo2, _time_embeds,
                                            embed_images, fuse_inference)
from showo_tpu_torch.show_o2.wan_vae import WanVAE, wan_encode

SYSTEM_PROMPT = "system\nYou are a helpful assistant."


@dataclasses.dataclass
class MMUV2Pipeline:
    model: Showo2
    vae: WanVAE
    tokenizer: object
    token_ids: dict
    max_new_tokens: int = 300
    top_k: Optional[int] = 1
    top_p: Optional[float] = None
    temperature: float = 1.0
    fuse_weights: bool = True      # qkv and gate/up as one matmul each
    quantize_int8: bool = False    # weight-only int8 serving

    def __post_init__(self):
        if self.fuse_weights:
            fuse_inference(self.model)
        if self.quantize_int8:
            quantize_int8(self.model.showo)
        self.cfg = self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.showo.model.embed_tokens.weight.device

    @property
    def resolution(self) -> int:
        """Input image resolution (the eval sweep's transform size)."""
        return int(self.cfg.image_latent_height * 8)

    def decode(self, toks) -> str:
        """Token ids -> text (the eval sweep's prediction string)."""
        try:
            return self.tokenizer.decode(list(toks),
                                         skip_special_tokens=True)
        except (AttributeError, TypeError):
            return str(list(toks))

    def _tok(self, text: str) -> List[int]:
        ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        return list(ids)

    def encode(self, pixels: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               eps=None) -> torch.Tensor:
        """Pixels [B, 3, T, H, W] in [-1, 1] -> the VAE's reparameterised
        latents [B, C, T', h, w] (fp32); ``eps`` a given normal draw of
        their shape, else one from ``generator``."""
        vae_dtype = next(self.vae.parameters()).dtype
        return wan_encode(self.vae, pixels.to(vae_dtype), generator, eps)

    def prompt(self, image_embeds: torch.Tensor, n_img: int, question: str,
               system_prompt: str = SYSTEM_PROMPT):
        """The scaffold's embeddings [1, S, D] and its additive omni mask
        [1, 1, S, S] around ``image_embeds`` [1, N, D]; the mask's span
        starts after [boi] and the time token and is ``n_img`` rows
        long."""
        ids = self.token_ids
        tokens_a = ([ids["bos_id"]] + self._tok(system_prompt)
                    + self._tok("\nuser\n"))
        tokens_b = ([ids["boi_id"], ids["eoi_id"]] + self._tok(question)
                    + self._tok("\nassistant\n"))
        embed = self.model.showo.model.embed_tokens
        dev = self.device
        emb_a = embed(torch.tensor([tokens_a], device=dev))
        emb_b = embed(torch.tensor([tokens_b], device=dev))
        _, time_proj = _time_embeds(self.model, torch.ones(
            (1,), dtype=torch.float32, device=dev))
        dtype = emb_a.dtype
        input_embeds = torch.cat([
            emb_a, emb_b[:, :1], time_proj[:, None].to(dtype),
            image_embeds.to(dtype), emb_b[:, 1:]], dim=1)
        mp = torch.tensor([[[len(tokens_a) + 2, n_img]]], device=dev)
        return input_embeds, omni_attn_mask(mp, input_embeds.shape[1])

    def generate(self, input_embeds: torch.Tensor, bias: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 injected_gumbel=None) -> List[int]:
        """Prefill ``input_embeds`` under ``bias`` into a cache of the
        prompt's length + ``max_new_tokens`` rows (the mask padded with
        -1e9), then ``max_new_tokens`` decode forwards; the sampled ids up
        to the first eos (which is dropped)."""
        qwen = self.model.showo
        embed = qwen.model.embed_tokens
        B, S, _ = input_embeds.shape
        cap = S + self.max_new_tokens

        def prefill(_ids, pb):
            cache = Qwen2KVCache.zeros(self.cfg.llm, B, cap,
                                       dtype=embed.weight.dtype,
                                       device=input_embeds.device)
            pb = F.pad(pb, (0, cap - pb.shape[-1]), value=-1e9)
            logits, _ = qwen(input_embeds=input_embeds, attention_bias=pb,
                             cache=cache)
            return logits, cache

        def decode(tok_ids, b, cache):
            logits, _ = qwen(input_embeds=embed(tok_ids), attention_bias=b,
                             cache=cache)
            return logits, cache

        eos = self.token_ids["eos_id"]
        toks, valid = ar_generate(
            prefill, decode, torch.zeros((B, S), dtype=torch.long,
                                         device=input_embeds.device),
            generator, max_new_tokens=self.max_new_tokens,
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, eot_token=eos, prompt_bias=bias,
            injected_gumbel=injected_gumbel)
        toks, valid = toks[0].cpu().numpy(), valid[0].cpu().numpy()
        return [int(t) for t in toks[valid] if t != eos]

    @torch.no_grad()
    def answer(self, image_nhwc: np.ndarray, question: str,
               generator: Optional[torch.Generator] = None,
               injected_gumbel=None, injected_eps=None,
               system_prompt: str = SYSTEM_PROMPT) -> List[int]:
        """image [H, W, 3] in [-1, 1] -> the answer's token ids.  The VAE
        noise comes from ``generator`` (then the sampling does), or is
        ``injected_eps`` [1, C, 1, h, w]; ``injected_gumbel``
        [max_new_tokens + 1, 1, V] replaces the sampling draws."""
        pixels = torch.as_tensor(np.asarray(image_nhwc, np.float32),
                                 device=self.device)
        latents = self.encode(pixels.permute(2, 0, 1)[None, :, None],
                              generator, injected_eps)[:, :, 0]
        embeds, bias = self.prompt(embed_images(self.model, latents),
                                   self.cfg.num_image_tokens, question,
                                   system_prompt)
        return self.generate(embeds, bias, generator, injected_gumbel)
