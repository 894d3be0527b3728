"""Show-o2 unified model (Qwen2.5 LLM + flow-matching DiT head) in PyTorch.

Counterpart of ``showo_tpu/show_o2/showo2.py`` (the reference
show-o2/models/modeling_showo2_qwen2_5.py), its inference part:
  * dual-path visual embedding: PatchEmbed -> SigLIP semantic layers (und)
    and PatchEmbed -> LLM width (gen), fused by RMSNorm + MLP
    ``fusion_proj`` (:63-90, 288-326);
  * a time-embed token and the per-image embeddings scattered into the
    text slots given by ``modality_positions`` (:350-371);
  * the Qwen2 forward under the omni mask, then the 10-layer DiT head
    with adaLN by span and the FinalLayer producing the velocity
    (:373-393);
  * the velocity extraction with the reference's patchify / unpatchify
    reshape pair (:145-158, 410-433) and CFG (:467-514).

Latents are NCHW at the interface, as in the reference and JAX.  The
module tree carries the reference checkpoint's names, so the state dict
that ``showo_tpu/utils/torch_export.py::showo2_state_dict`` writes loads
with ``load_state_dict``.  The losses, the KV-cached prefill and velocity
and the video paths are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from showo_tpu_torch.show_o2.dit import (DiffusionHeadConfig, FinalLayer,
                                         ModulatedAttentionBlock, PatchEmbed,
                                         TimestepEmbedder, dit_forward)
from showo_tpu_torch.show_o2.dit import fuse_inference as fuse_dit
from showo_tpu_torch.show_o2.masks import modality_gather, modality_scatter
from showo_tpu_torch.show_o2.qwen2 import (Qwen2, Qwen2Config, RMSNorm,
                                           init_normal, packed_meta)
from showo_tpu_torch.show_o2.qwen2 import fuse_inference as fuse_qwen2
from showo_tpu_torch.show_o2.siglip import SigLipConfig, SiglipEncoder


@dataclasses.dataclass(frozen=True)
class Showo2Config:
    llm: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)
    siglip: SigLipConfig = dataclasses.field(default_factory=SigLipConfig)
    dit: DiffusionHeadConfig = dataclasses.field(
        default_factory=DiffusionHeadConfig)
    image_latent_dim: int = 16
    image_latent_height: int = 54   # 432px / 8 VAE downsample
    image_latent_width: int = 54    # -> 27x27 = 729 patches (+1 time token)
    patch_size: int = 2
    clip_latent_dim: int = 1152
    add_time_embeds: bool = True

    @property
    def num_image_tokens(self) -> int:
        n = (self.image_latent_height // self.patch_size) * \
            (self.image_latent_width // self.patch_size)
        return n + (1 if self.add_time_embeds else 0)


class Showo2(nn.Module):
    """The Show-o2 model (reference names: ``showo``, ``image_embedder_und``
    / ``_gen``, ``position_embedding``, ``und_trans``, ``fusion_proj``,
    ``time_embed``, ``diffusion_head_a`` / ``_b``, and ``diff_proj`` /
    ``time_embed_proj`` when the LLM and DiT widths differ)."""

    def __init__(self, cfg: Showo2Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        D_llm, D_clip, D_dit = (cfg.llm.hidden_size, cfg.clip_latent_dim,
                                cfg.dit.hidden_size)
        p, C = cfg.patch_size, cfg.image_latent_dim
        self.showo = Qwen2(cfg.llm, **kw)
        self.image_embedder_und = PatchEmbed(C, D_clip, p, **kw)
        self.image_embedder_gen = PatchEmbed(C, D_llm, p, **kw)
        self.position_embedding = nn.Embedding(cfg.siglip.num_positions,
                                               D_clip, **kw)
        self.und_trans = SiglipEncoder(cfg.siglip, **kw)
        self.fusion_proj = nn.Sequential(
            RMSNorm(D_clip + D_llm, 1e-6, **kw),
            nn.Linear(D_clip + D_llm, D_llm, **kw), nn.GELU(),
            nn.Linear(D_llm, D_llm, **kw))
        self.time_embed = TimestepEmbedder(D_dit, **kw)
        self.diffusion_head_a = nn.ModuleList(
            ModulatedAttentionBlock(cfg.dit, **kw)
            for _ in range(cfg.dit.num_layers))
        self.diffusion_head_b = FinalLayer(D_dit, p, C, **kw)
        if D_llm != D_dit:
            self.diff_proj = nn.Sequential(
                nn.Linear(D_llm, D_dit, **kw), nn.GELU(),
                nn.Linear(D_dit, D_dit, **kw))
            self.time_embed_proj = nn.Linear(D_dit, D_llm, **kw)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "Showo2":
        """Random init as JAX ``init_showo2_params``: N(0, 0.02) matmul,
        convolution and embedding weights, zero biases, unit norm scales,
        and the reference's zero init of the DiT's adaLN projections and
        of the whole FinalLayer (its norm scale one)."""
        init_normal(self, generator, zero=("adaLN_modulation",
                                           "diffusion_head_b.linear"))
        return self


def fuse_inference(model: Showo2) -> Showo2:
    """The inference weight fusions of both towers (Qwen2 qkv with biases
    and gate/up; DiT qkv and gate/up); idempotent, in place."""
    fuse_qwen2(model.showo)
    fuse_dit(model.diffusion_head_a)
    return model


def embed_images(model: Showo2, latents: torch.Tensor) -> torch.Tensor:
    """Dual-path embedding and fusion: image latents [B, C, H, W] ->
    [B, N, D_llm], N = (H/p)(W/p)."""
    x = latents.to(model.image_embedder_und.proj.weight.dtype)
    und = model.image_embedder_und(x)
    gen = model.image_embedder_gen(x)
    pos = model.position_embedding.weight
    if pos.shape[0] != und.shape[1]:
        raise NotImplementedError(
            f"{und.shape[1]} patches against a {pos.shape[0]}-entry SigLIP "
            f"position table: the bicubic position interpolation is not "
            f"ported yet")
    und = model.und_trans(und + pos[None])
    return model.fusion_proj(torch.cat([und, gen], dim=-1))


def showo2_forward(model: Showo2, text_tokens: torch.Tensor,
                   image_latents: torch.Tensor, t: torch.Tensor,
                   attention_bias: Optional[torch.Tensor],
                   modality_positions: torch.Tensor,
                   attn_meta=None) -> torch.Tensor:
    """The inference forward: the sequence-space velocity [B, L, p*p*C]
    (the LM logits, which the velocity does not read, are not computed).

    text_tokens [B, L]; image_latents [B*M, C, H, W]; t [B*M];
    attention_bias [B, 1, L, L] additive (the dense route; may be None
    with ``attn_meta``); modality_positions [B, M, 2].  attn_meta:
    optional ("packed", seg, pad, last_pad, prefix) sending every
    attention of both towers to the packed omni kernel."""
    cfg = model.cfg
    input_embeds = model.showo.model.embed_tokens(text_tokens)
    image_embeds = embed_images(model, image_latents)
    time_embeds = model.time_embed(t)                         # [B*M, D_dit]
    time_proj = (model.time_embed_proj(time_embeds)
                 if hasattr(model, "time_embed_proj") else time_embeds)
    input_embeds = modality_scatter(input_embeds, image_embeds, time_proj,
                                    modality_positions,
                                    add_time_embeds=cfg.add_time_embeds)
    meta = packed_meta(attn_meta)
    _, h = model.showo(input_embeds=input_embeds,
                       attention_bias=attention_bias, attn_meta=meta,
                       logits=False)
    if hasattr(model, "diff_proj"):
        h = model.diff_proj(h)
    h = dit_forward(cfg.dit, model.diffusion_head_a, h, time_embeds,
                    attention_bias, modality_positions, meta)
    return model.diffusion_head_b(h, time_embeds, modality_positions)


def unpatchify_v(cfg: Showo2Config, v: torch.Tensor, h_: int,
                 w_: int) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, C, H, W) by the reference's mirrored reshape
    chain (modeling_showo2_qwen2_5.py:145-158, 426-433)."""
    n = v.shape[0]
    p, c = cfg.patch_size, cfg.image_latent_dim
    x = v.reshape(n, h_, w_, p, p, c).reshape(n, h_ * p * w_ * p, c)
    return x.transpose(1, 2).reshape(n, c, h_ * p, w_ * p)


def extract_v(cfg: Showo2Config, v_seq: torch.Tensor,
              modality_positions: torch.Tensor, h_: int,
              w_: int) -> torch.Tensor:
    """Per-image velocity [B*M, C, H, W] from the sequence (every span a
    real image, the generation layout)."""
    span = h_ * w_ + (1 if cfg.add_time_embeds else 0)
    spans = modality_gather(v_seq, modality_positions, span)
    if cfg.add_time_embeds:
        spans = spans[:, 1:]
    return unpatchify_v(cfg, spans, h_, w_)


def showo2_t2i_velocity(model: Showo2, text_tokens: torch.Tensor,
                        image_latents: torch.Tensor, t: torch.Tensor,
                        attention_bias: Optional[torch.Tensor],
                        modality_positions: torch.Tensor,
                        guidance_scale: float = 0.0,
                        attn_meta=None) -> torch.Tensor:
    """One velocity evaluation with CFG (reference t2i_generate).  With
    guidance_scale > 0 the inputs are the doubled [cond; uncond] batch and
    the guided velocity is returned for both halves, as the reference
    hands it to the integrator."""
    cfg = model.cfg
    v_seq = showo2_forward(model, text_tokens, image_latents, t,
                           attention_bias, modality_positions, attn_meta)
    h_ = cfg.image_latent_height // cfg.patch_size
    w_ = cfg.image_latent_width // cfg.patch_size
    v = extract_v(cfg, v_seq, modality_positions, h_, w_)
    if guidance_scale > 0:
        v_cond, v_uncond = v.chunk(2, dim=0)
        v_g = v_uncond + guidance_scale * (v_cond - v_uncond)
        return torch.cat([v_g, v_g], dim=0)
    return v
