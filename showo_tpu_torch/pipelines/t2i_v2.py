"""Show-o2 text-to-image pipeline: flow-matching Euler ODE, CFG, Wan2.1 VAE.

Counterpart of ``showo_tpu/pipelines/t2i_v2.py`` (show-o2/inference_t2i.py
:130-195): the cond and null prompt layouts (``prepare_gen_input``),
z ~ N(0, 1) in latent space, CFG by doubling the batch, Euler over the
time-shifted grid with one velocity evaluation per interval, and the VAE
decode of the cond half.

As in JAX, the sequence is cut at the end of the image span, rounded up to
128: the eoi / eos / pad rows after the span are seen by no image row, so
they do not change the velocity.  The attention route is ``dense`` (the
additive omni mask), ``packed`` (kernel 1 in every layer of both towers,
the mask recomputed from the span metadata: seg from the modality
positions, no pads, last_pad -1, prefix 0) or ``streaming`` (kernel 5 on
the same metadata); ``auto`` takes ``packed`` from 512 image tokens on.

``prefix_cache=True`` (off by default, as in JAX) prefills both towers'
K/V once a generate and re-forwards only the image span's rows in each
velocity evaluation, on every route: the dense route's mask rows of the
span are gathered once, a kernel route's metadata of the fresh rows (q at
per-row positions, Q != K) and its tile map are made once.  The sampler
is ``sampling_method``: euler, heun, dpm-solver (dpm) or dopri5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from showo_tpu_torch.ops.flash_attention import seg_from_modality_positions
from showo_tpu_torch.show_o2.formats import prepare_gen_input
from showo_tpu_torch.show_o2.masks import omni_attn_mask
from showo_tpu_torch.show_o2.qwen2 import (cache_rows, check_route,
                                           packed_meta)
from showo_tpu_torch.show_o2.showo2 import (Showo2, fuse_inference,
                                            showo2_t2i_prefill,
                                            showo2_t2i_velocity,
                                            showo2_t2i_velocity_cached)
from showo_tpu_torch.show_o2.transport import (check_sampler, ode_timegrid,
                                               sample)
from showo_tpu_torch.show_o2.wan_vae import WanVAE, wan_decode


def route_attention(attn_impl: str, num_image_tokens: int) -> str:
    """``auto``: the packed omni kernel from 512 image tokens on (the
    432x432 demo has 730), dense attention below, as the JAX pipeline
    routes; any other name must be a route of ``qwen2.ATTN_ROUTES``
    (``trainable`` raises NotImplementedError)."""
    if attn_impl == "auto":
        return "packed" if num_image_tokens >= 512 else "dense"
    return check_route(attn_impl)


def cut_at_span(toks, toks_null, mp, mp_null, guidance_scale: float,
                device):
    """(text [B', L], modality_positions [B', M, 2]) of the cond rows and,
    with CFG, the null rows after them (``prepare_gen_input``'s layouts),
    as int64 on ``device``; the rows cut at the end of the last span
    rounded up to 128 (the eoi / eos / pad rows after it are seen by no
    span row, so they do not change the velocity)."""
    if guidance_scale > 0:
        text = np.concatenate([toks, toks_null], axis=0)
        mp_all = np.concatenate([mp[:, 0], mp_null[:, 0]], axis=0)
    else:
        text, mp_all = toks, mp[:, 0]
    mp_all = mp_all.reshape(text.shape[0], -1, 2)
    span_end = int(np.max(mp_all[:, :, 0] + mp_all[:, :, 1]))
    L = min(text.shape[1], (span_end + 127) // 128 * 128)
    return (torch.as_tensor(text[:, :L], device=device),
            torch.as_tensor(mp_all, device=device))


def attention_inputs(route: str, text: torch.Tensor, mp: torch.Tensor,
                     q_positions=None):
    """(bias, attn_meta) of ``route``: the additive [B', 1, L, L] omni mask
    for ``dense``; for ``packed`` and ``streaming`` the kernel's span
    metadata (seg from the modality positions, no pads, last_pad -1,
    prefix 0) and tile map, computed once for every layer of every
    velocity evaluation.  ``q_positions`` [B', n]: the prefix cache's
    fresh rows, whose mask rows (dense) or metadata (the kernels') are
    made instead."""
    B, L = text.shape
    if route == "dense":
        bias = omni_attn_mask(mp, L)
        if q_positions is not None:
            n = q_positions.shape[1]
            bias = torch.gather(bias, 2, q_positions[:, None, :, None]
                                .expand(B, 1, n, L))
        return bias, None
    dev = text.device
    return None, packed_meta((
        route, seg_from_modality_positions(mp, L),
        torch.zeros((B, L), dtype=torch.int32, device=dev),
        torch.full((B,), -1, dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.int32, device=dev)), q_positions)


@dataclasses.dataclass
class T2IV2Pipeline:
    model: Showo2
    vae: WanVAE
    tokenizer: object
    token_ids: dict        # bos_id, eos_id, boi_id, eoi_id, pad_id, img_pad_id
    guidance_scale: float = 7.5
    num_steps: int = 50
    time_shifting_factor: float = 3.0
    max_text_len: int = 256
    attn_impl: str = "auto"           # auto | dense | packed | streaming
    sampling_method: str = "euler"    # euler | heun | dpm-solver | dopri5
    prefix_cache: bool = False

    def __post_init__(self):
        # inference-only weight re-layout (in place), as the JAX pipeline's
        # default: one qkv and one gate/up matmul per layer of both towers
        fuse_inference(self.model)
        self.cfg = self.model.cfg
        self.attn_route = route_attention(self.attn_impl,
                                          self.cfg.num_image_tokens)
        check_sampler(self.sampling_method)
        self.t_grid = ode_timegrid(
            self.num_steps, time_shifting_factor=self.time_shifting_factor)
        # the last generate's sampler counts (dopri5: nfe, accepted,
        # rejected steps) and its [cond; null] rows' shape (B', L)
        self.sampler_stats = {}
        self.last_rows = None

    @property
    def device(self) -> torch.device:
        return self.model.showo.model.embed_tokens.weight.device

    def build_inputs(self, prompts: Sequence[str]):
        """(text [B', L], modality_positions [B', 1, 2]) of the [cond;
        null] batch (B' = 2B with CFG), cut at the image span's end rounded
        up to 128, as int64 on the model's device."""
        ids = self.token_ids
        return cut_at_span(*prepare_gen_input(
            list(prompts), self.tokenizer, self.cfg.num_image_tokens,
            ids["bos_id"], ids["eos_id"], ids["boi_id"], ids["eoi_id"],
            ids["pad_id"], ids["img_pad_id"], self.max_text_len),
            self.guidance_scale, self.device)

    def drift(self, text: torch.Tensor, mp: torch.Tensor):
        """The velocity drift_fn(x, t) of one generate over the [cond;
        null] rows ``text`` / ``mp``: the plain one, or with
        ``prefix_cache`` the prefill of both towers (run here) and the
        cached evaluation of the span's rows."""
        bias, attn_meta = attention_inputs(self.attn_route, text, mp)
        kw = dict(guidance_scale=self.guidance_scale)
        if not self.prefix_cache:
            return lambda x, t: showo2_t2i_velocity(
                self.model, text, x, t, bias, mp, attn_meta=attn_meta, **kw)
        qwen_cache, dit_kv = showo2_t2i_prefill(self.model, text, bias, mp,
                                                attn_meta)
        n, offsets = self.cfg.num_image_tokens, mp[:, 0, 0]
        rows = cache_rows(offsets, n)
        bias_fresh, meta_fresh = attention_inputs(self.attn_route, text,
                                                  mp, rows[1])
        return lambda x, t: showo2_t2i_velocity_cached(
            self.model, x, t, bias_fresh, mp, qwen_cache, dit_kv,
            attn_meta=meta_fresh, rows=rows, **kw)

    @torch.no_grad()
    def generate_latents(self, prompts: Sequence[str],
                         generator: Optional[torch.Generator] = None,
                         noise=None) -> torch.Tensor:
        """Denoised latents [B, C, h, w] fp32 of the cond half.  z is drawn
        from ``generator`` ([B, C, h, w] N(0, 1) fp32 on the model's
        device), or taken from ``noise`` (the parity tests' injected z)."""
        cfg = self.cfg
        B = len(prompts)
        shape = (B, cfg.image_latent_dim, cfg.image_latent_height,
                 cfg.image_latent_width)
        if noise is None:
            z = torch.randn(shape, generator=generator, device=self.device)
        else:
            z = torch.as_tensor(noise, dtype=torch.float32,
                                device=self.device)
            if tuple(z.shape) != shape:
                raise ValueError(f"noise must be {shape}, got "
                                 f"{tuple(z.shape)}")
        text, mp = self.build_inputs(prompts)
        self.last_rows = tuple(text.shape)
        if self.guidance_scale > 0:
            z = torch.cat([z, z], dim=0)
        self.sampler_stats = {}
        return sample(self.sampling_method, self.drift(text, mp), z,
                      self.t_grid, self.sampler_stats)[:B]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """Latents [B, C, h, w] -> NHWC float32 images in [-1, 1] (the VAE
        in its own dtype, fp32 as built)."""
        z = latents.to(self.vae.conv2.weight.dtype)[:, :, None]
        pixels = wan_decode(self.vae, z)[:, :, 0]
        return pixels.permute(0, 2, 3, 1).float().cpu().numpy()

    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 noise=None) -> np.ndarray:
        """NHWC float32 images in [-1, 1], one per prompt."""
        return self.decode(self.generate_latents(prompts, generator, noise))
