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
    reshape pair (:145-158, 410-433) and CFG (:467-514);
  * the prefix-cached velocity: a prefill of both towers' K/V with zero
    latents (:func:`showo2_t2i_prefill`), then each evaluation re-forwards
    only the image span's rows against it
    (:func:`showo2_t2i_velocity_cached`).

Latents are NCHW at the interface, as in the reference and JAX.  The
module tree carries the reference checkpoint's names, so the state dict
that ``showo_tpu/utils/torch_export.py::showo2_state_dict`` writes loads
with ``load_state_dict``.  :func:`embed_images` takes image and video
latents (the understanding pipelines'), and the velocity video latents
(``num_frames``, with the i2v first frame held) or several images a row
(``only_denoise_last_image``, the mixed-modality history).  The training
half: :func:`patchify_labels` (image and video), the losses
:func:`next_token_prediction_loss` and :func:`velocity_prediction_loss`
(the reference's misc.py:11-21), and :func:`showo2_forward` with labels,
which returns the logits, the velocity and both losses, every layer stack
under ``remat``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from showo_tpu_torch.show_o2.dit import (DiffusionHeadConfig, FinalLayer,
                                         ModulatedAttentionBlock, PatchEmbed,
                                         TimestepEmbedder, dit_forward)
from showo_tpu_torch.show_o2.dit import fuse_inference as fuse_dit
from showo_tpu_torch.models.showo import cross_entropy_ignore
from showo_tpu_torch.parallel.mesh import constrain, global_mean
from showo_tpu_torch.show_o2.masks import modality_gather, modality_scatter
from showo_tpu_torch.show_o2.qwen2 import (Qwen2, Qwen2Config, Qwen2KVCache,
                                           RMSNorm, cache_rows, init_normal,
                                           packed_meta)
from showo_tpu_torch.show_o2.qwen2 import fuse_inference as fuse_qwen2
from showo_tpu_torch.show_o2.siglip import (SigLipConfig, SiglipEncoder,
                                            interpolate_pos_encoding)


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


def with_config(model: Showo2, cfg: Showo2Config) -> Showo2:
    """``model``'s weights under ``cfg``, which may differ from the
    model's own config in the latent grid alone (no parameter depends on
    it; the resolution is read from ``model.cfg``): a shallow copy that
    shares every parameter and submodule, as JAX pairs one params tree
    with any such config.  Any other difference raises ValueError."""
    if cfg == model.cfg:
        return model
    own = model.cfg
    if dataclasses.replace(cfg, image_latent_height=own.image_latent_height,
                           image_latent_width=own.image_latent_width) != own:
        raise ValueError(f"the model's weights do not fit {cfg}: only the "
                         f"latent grid may differ from {own}")
    view = copy.copy(model)
    view.cfg = cfg
    return view


def fuse_inference(model: Showo2) -> Showo2:
    """The inference weight fusions of both towers (Qwen2 qkv with biases
    and gate/up; DiT qkv and gate/up); idempotent, in place."""
    fuse_qwen2(model.showo)
    fuse_dit(model.diffusion_head_a)
    return model


def semantic_features(model: Showo2, x: torch.Tensor,
                      remat=False) -> torch.Tensor:
    """The und path: latents [N, C, H, W] (in the weights' dtype) through
    ``image_embedder_und``, the SigLIP position table (interpolated where
    the patch grid is not its own) and ``und_trans`` -> [N, (H/p)(W/p),
    D_clip].  remat: the SigLIP layers' policy (``utils/remat.py``)."""
    und = model.image_embedder_und(x)
    pos = model.position_embedding.weight
    p = model.cfg.patch_size
    h_, w_ = x.shape[2] // p, x.shape[3] // p
    pos = (pos[None] if pos.shape[0] == h_ * w_
           else interpolate_pos_encoding(pos, h_, w_))
    return model.und_trans(und + pos, remat=remat)


def embed_images(model: Showo2, latents: torch.Tensor,
                 remat=False) -> torch.Tensor:
    """Dual-path embedding and fusion: image latents [B, C, H, W] ->
    [B, N, D_llm], N = (H/p)(W/p); video latents [B, C, T, H, W] ->
    [B, T*N, D_llm], both paths per frame over (b t), as JAX's.  The
    SigLIP position table is interpolated where the patch grid is not its
    own.  remat: the SigLIP layers' policy (``utils/remat.py``)."""
    x = latents.to(model.image_embedder_und.proj.weight.dtype)
    video = x.dim() == 5
    if video:
        B, C, T, H, W = x.shape
        x = x.transpose(1, 2).reshape(B * T, C, H, W)
    und = semantic_features(model, x, remat=remat)
    gen = model.image_embedder_gen(x)
    fused = model.fusion_proj(torch.cat([und, gen], dim=-1))
    if video:
        return fused.reshape(B, T * fused.shape[1], fused.shape[-1])
    return fused


def showo2_forward(model: Showo2, text_tokens: torch.Tensor,
                   image_latents: torch.Tensor, t: torch.Tensor,
                   attention_bias: Optional[torch.Tensor],
                   modality_positions: torch.Tensor, attn_meta=None,
                   text_labels: Optional[torch.Tensor] = None,
                   image_labels: Optional[torch.Tensor] = None,
                   image_masks: Optional[torch.Tensor] = None,
                   remat=False):
    """The Show-o2 forward (JAX ``showo2_forward``).

    text_tokens [B, L]; image_latents [B*M, C, H, W] (or video latents
    [B*M, C, T, H, W]); t [B*M]; attention_bias [B, 1, L, L] additive (the
    dense route; may be None with ``attn_meta``); modality_positions
    [B, M, 2].  attn_meta: optional (route, seg, pad, last_pad, prefix)
    sending every attention of both towers to the route's kernel
    (``packed``, ``streaming`` or ``trainable``).  remat: every layer stack
    (SigLIP, Qwen2, the DiT) under that policy of ``utils/remat.py``.

    Without labels (inference): the sequence-space velocity [B, L, p*p*C]
    (the LM logits, which it does not read, are not computed).  With
    ``text_labels`` [B, L] and / or ``image_labels`` (the flow target ut,
    shaped as the latents) and ``image_masks`` [B, L]: a dict of
    ``logits``, ``v_seq`` and ``loss_ntp`` / ``loss_flow``; the time slot
    of every span is left out of the flow loss (modeling_showo2_qwen2_5.py
    :346-365)."""
    cfg = model.cfg
    train = text_labels is not None or image_labels is not None
    input_embeds = model.showo.model.embed_tokens(text_tokens)
    image_embeds = embed_images(model, image_latents, remat=remat)
    time_embeds, time_proj = _time_embeds(model, t)
    input_embeds = modality_scatter(input_embeds, image_embeds, time_proj,
                                    modality_positions,
                                    add_time_embeds=cfg.add_time_embeds)
    meta = packed_meta(attn_meta)
    logits, h = model.showo(input_embeds=input_embeds,
                            attention_bias=attention_bias, attn_meta=meta,
                            logits=train, remat=remat)
    h = dit_forward(cfg.dit, model.diffusion_head_a, _diff_proj(model, h),
                    time_embeds, attention_bias, modality_positions, meta,
                    remat=remat)
    v_seq = model.diffusion_head_b(h, time_embeds, modality_positions)
    if not train:
        return v_seq
    out = {"logits": logits, "v_seq": v_seq}
    if text_labels is not None:
        out["loss_ntp"] = next_token_prediction_loss(logits, text_labels)
    if image_labels is not None:
        lab = patchify_labels(cfg, image_labels).float()
        seq_labels = modality_scatter(
            torch.zeros(v_seq.shape, dtype=torch.float32,
                        device=v_seq.device), lab,
            torch.zeros((lab.shape[0], lab.shape[-1]), dtype=torch.float32,
                        device=lab.device), modality_positions,
            add_time_embeds=cfg.add_time_embeds)
        if cfg.add_time_embeds:
            L = text_tokens.shape[1]
            pos = torch.arange(L, device=v_seq.device)[None, :, None]
            off = modality_positions[:, None, :, 0]
            length = modality_positions[:, None, :, 1]
            is_time = ((pos == off) & (length > 0)).any(dim=-1)
            image_masks = torch.where(is_time, 0, image_masks)
        out["loss_flow"] = velocity_prediction_loss(v_seq, seq_labels,
                                                    image_masks)
    return out


def patchify_labels(cfg: Showo2Config, labels: torch.Tensor) -> torch.Tensor:
    """The reference's label 'patchify' (modeling_showo2_qwen2_5.py
    :329-337), a pure reshape chain whose inverse is :func:`unpatchify_v`:
    image labels [B, C, H, W] -> [B, (H/p)(W/p), p*p*C], video labels
    [B, C, T, H, W] -> [B, T(H/p)(W/p), p*p*C]."""
    p = cfg.patch_size
    if labels.dim() == 5:
        b, c, T, H, W = labels.shape
        x = labels.reshape(b, c, T * H * W).transpose(1, 2)
        return x.reshape(b, T, H // p, W // p, p, p, c).reshape(
            b, T * (H // p) * (W // p), p * p * c)
    b, c, H, W = labels.shape
    x = labels.reshape(b, c, H * W).transpose(1, 2)
    return x.reshape(b, H // p, W // p, p, p, c).reshape(
        b, (H // p) * (W // p), p * p * c)


def next_token_prediction_loss(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """misc.py:11-13 in JAX's form: cross entropy over the whole logits
    against the labels shifted left by one (the last position ignored),
    the mean over the positions whose label is not -100, in fp32.  JAX
    pins the logits to the lm_head output's sharding first
    (``constrain``); here they are whole on every rank, and ``constrain``
    is the identity."""
    logits = constrain(logits, "dp", None, ("fsdp", "tp"))
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        -100)], dim=1)
    return cross_entropy_ignore(logits, shifted)


def velocity_prediction_loss(v_pred: torch.Tensor, labels: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """misc.py:16-21: the squared error of the velocity over the sequence
    positions where ``mask`` [B, L] is set, averaged over those entries
    (every channel counts), in fp32; 0 where no position is set.  Over
    the global batch under a mesh (``parallel/mesh.py::global_mean``)."""
    se = (v_pred.float() - labels.float()).square()
    m = mask[:, :, None].bool().expand(se.shape)
    return global_mean(torch.where(m, se, 0.0).sum(), m.sum())


def _time_embeds(model: Showo2, t: torch.Tensor):
    """(time embeddings [N, D_dit], their projection to the LLM width)."""
    time_embeds = model.time_embed(t)
    return time_embeds, (model.time_embed_proj(time_embeds)
                         if hasattr(model, "time_embed_proj")
                         else time_embeds)


def _diff_proj(model: Showo2, h: torch.Tensor) -> torch.Tensor:
    return model.diff_proj(h) if hasattr(model, "diff_proj") else h


def unpatchify_v(cfg: Showo2Config, v: torch.Tensor, h_: int, w_: int,
                 T: int = 0) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, C, H, W), or with ``T`` frames (N, C, T, H, W),
    by the reference's mirrored reshape chain
    (modeling_showo2_qwen2_5.py:145-158, 426-433)."""
    n = v.shape[0]
    p, c = cfg.patch_size, cfg.image_latent_dim
    if T:
        x = v.reshape(n, T, h_, w_, p, p, c).reshape(n, T, h_ * p * w_ * p, c)
        return x.permute(0, 3, 1, 2).reshape(n, c, T, h_ * p, w_ * p)
    x = v.reshape(n, h_, w_, p, p, c).reshape(n, h_ * p * w_ * p, c)
    return x.transpose(1, 2).reshape(n, c, h_ * p, w_ * p)


def extract_v(cfg: Showo2Config, v_seq: torch.Tensor,
              modality_positions: torch.Tensor, h_: int, w_: int,
              num_frames: int = 0) -> torch.Tensor:
    """Per-image velocity [B*M, C, H, W] from the sequence (every span a
    real image, the generation layout); with ``num_frames`` > 0 per-video
    [B*M, C, T, H, W]."""
    span = (max(num_frames, 1) * h_ * w_
            + (1 if cfg.add_time_embeds else 0))
    spans = modality_gather(v_seq, modality_positions, span)
    if cfg.add_time_embeds:
        spans = spans[:, 1:]
    return unpatchify_v(cfg, spans, h_, w_, T=num_frames)


def showo2_t2i_velocity(model: Showo2, text_tokens: torch.Tensor,
                        image_latents: torch.Tensor, t: torch.Tensor,
                        attention_bias: Optional[torch.Tensor],
                        modality_positions: torch.Tensor,
                        guidance_scale: float = 0.0,
                        first_frame_as_cond: bool = False,
                        only_denoise_last_image: bool = False,
                        num_frames: int = 0,
                        attn_meta=None) -> torch.Tensor:
    """One velocity evaluation with CFG (reference t2i_generate).  With
    guidance_scale > 0 the inputs are the doubled [cond; uncond] batch and
    the guided velocity is returned for both halves, as the reference
    hands it to the integrator.

    num_frames > 0: video latents [B, C, T, h, w] (one span a row) and
    velocity.  first_frame_as_cond (i2v): the first latent frame's
    velocity is zero (modeling_showo2_qwen2_5.py:436-441); its t is the
    row's, as in JAX.  only_denoise_last_image: every image but the last
    of each row has zero velocity (its history, :444-463)."""
    cfg = model.cfg
    v_seq = showo2_forward(model, text_tokens, image_latents, t,
                           attention_bias, modality_positions, attn_meta)
    h_ = cfg.image_latent_height // cfg.patch_size
    w_ = cfg.image_latent_width // cfg.patch_size
    v = extract_v(cfg, v_seq, modality_positions, h_, w_,
                  num_frames=num_frames)
    if first_frame_as_cond:
        v = torch.cat([torch.zeros_like(v[:, :, :1]), v[:, :, 1:]], dim=2)
    if only_denoise_last_image:
        M = modality_positions.shape[1]
        per = v.reshape(text_tokens.shape[0], M, *v.shape[1:])
        v = torch.cat([torch.zeros_like(per[:, :-1]), per[:, -1:]],
                      dim=1).reshape(v.shape)
    return _guided(v, guidance_scale)


def _guided(v: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    if guidance_scale > 0:
        v_cond, v_uncond = v.chunk(2, dim=0)
        v_g = v_uncond + guidance_scale * (v_cond - v_uncond)
        return torch.cat([v_g, v_g], dim=0)
    return v


def showo2_t2i_prefill(model: Showo2, text_tokens: torch.Tensor,
                       attention_bias: Optional[torch.Tensor],
                       modality_positions: torch.Tensor, attn_meta=None):
    """The latent-independent K/V of every layer of both towers, once per
    generate (JAX ``showo2_t2i_prefill``).  The text rows precede the
    image span and attend only backwards, so their K/V never see the
    latents: one forward with zero latents at t = 0 gives them exactly;
    the span rows' entries are placeholders that every cached evaluation
    overwrites.  Returns (qwen_cache, dit_kv): a :class:`Qwen2KVCache`
    [28, B, L, Hkv, Dh] and the DiT's (k, v) [10, B, L, Hkv, Dh].
    attn_meta: as :func:`showo2_forward` takes it (self-attention over the
    L rows)."""
    cfg = model.cfg
    B, L = text_tokens.shape
    M = modality_positions.shape[1]
    input_embeds = model.showo.model.embed_tokens(text_tokens)
    dtype, dev = input_embeds.dtype, input_embeds.device
    lat = torch.zeros((B * M, cfg.image_latent_dim, cfg.image_latent_height,
                       cfg.image_latent_width), dtype=dtype, device=dev)
    time_embeds, time_proj = _time_embeds(
        model, torch.zeros((B * M,), dtype=torch.float32, device=dev))
    input_embeds = modality_scatter(input_embeds, embed_images(model, lat),
                                    time_proj, modality_positions,
                                    add_time_embeds=cfg.add_time_embeds)
    meta = packed_meta(attn_meta)
    cache = Qwen2KVCache.zeros(cfg.llm, B, L, dtype=dtype, device=dev)
    _, h = model.showo(input_embeds=input_embeds,
                       attention_bias=attention_bias, attn_meta=meta,
                       logits=False, cache=cache)
    _, dit_kv = dit_forward(cfg.dit, model.diffusion_head_a,
                            _diff_proj(model, h), time_embeds,
                            attention_bias, modality_positions, meta,
                            return_kv=True)
    return cache, dit_kv


def showo2_t2i_velocity_cached(model: Showo2, image_latents: torch.Tensor,
                               t: torch.Tensor,
                               bias_fresh: Optional[torch.Tensor],
                               modality_positions: torch.Tensor,
                               qwen_cache: Qwen2KVCache, dit_kv,
                               guidance_scale: float = 0.0, attn_meta=None,
                               rows=None) -> torch.Tensor:
    """One velocity evaluation that re-forwards only the image span's n
    rows (its time token and patches) against the prefilled K/V of both
    towers (JAX ``showo2_t2i_velocity_cached``): the fresh rows see the
    same keys, rope positions and adaLN as in :func:`showo2_t2i_velocity`.

    image_latents [B, C, H, W] (one span a row); t [B]; bias_fresh
    [B, 1, n, L] (the dense route: the full mask's rows of the span);
    modality_positions the full sequence's [B, 1, 2], whose offsets may
    differ by row (the CFG null prompt's span starts at 2).  attn_meta: a
    :class:`~showo_tpu_torch.show_o2.qwen2.PackedMeta` of the fresh rows
    (``packed_meta(..., q_positions=offsets[:, None] + arange(n))``).
    rows: the ``cache_rows`` index of the fresh rows, made once per
    generate (made here when None).  The caches' span rows are
    overwritten in place."""
    cfg = model.cfg
    image_embeds = embed_images(model, image_latents)
    time_embeds, time_proj = _time_embeds(model, t)
    fresh = image_embeds
    if cfg.add_time_embeds:
        fresh = torch.cat([time_proj[:, None].to(image_embeds.dtype),
                           image_embeds], dim=1)
    B, n, _ = fresh.shape
    offsets = modality_positions[:, 0, 0]
    pos_ids = offsets[:, None] + torch.arange(n, device=fresh.device)
    if rows is None:
        rows = cache_rows(offsets, n)
    _, h = model.showo(input_embeds=fresh, attention_bias=bias_fresh,
                       position_ids=pos_ids, attn_meta=attn_meta,
                       logits=False, cache=qwen_cache, cache_offsets=rows)
    # the fresh rows are the whole span: the adaLN spans collapse to one
    # [B, 1, D] modulation a row (full_span)
    mp_fresh = torch.tensor([[[0, n]]], device=fresh.device).expand(B, 1, 2)
    h = dit_forward(cfg.dit, model.diffusion_head_a, _diff_proj(model, h),
                    time_embeds, bias_fresh, mp_fresh, attn_meta,
                    positions=pos_ids, full_span=True, cache=dit_kv,
                    cache_offsets=rows)
    v_seq = model.diffusion_head_b(h, time_embeds, mp_fresh, full_span=True)
    h_ = cfg.image_latent_height // cfg.patch_size
    w_ = cfg.image_latent_width // cfg.patch_size
    return _guided(extract_v(cfg, v_seq, mp_fresh, h_, w_), guidance_scale)
