"""Show-o unified model over Phi-1.5, and its text-to-image generators.

Counterpart of ``showo_tpu/models/showo.py`` (config, init, forward, the
fused three-task training losses ``showo_losses`` over
``cross_entropy_ignore``, ``showo_t2i_generate`` and the prefix-cached
``showo_t2i_generate_cached``), the understanding path's KV-cache AR
decode ``showo_mmu_generate`` and the CLIP-ViT projector ``mm_project``
(``w_clip_vit``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from showo_tpu_torch.models.phi import KVCache, Phi, PhiConfig, check_route
from showo_tpu_torch.parallel.mesh import global_mean
from showo_tpu_torch.sampling.ar import ar_generate
from showo_tpu_torch.sampling.maskgit import maskgit_generate
from showo_tpu_torch.sampling.schedules import cosine_schedule


@dataclasses.dataclass(frozen=True)
class ShowoConfig:
    vocab_size: int = 58498
    llm_vocab_size: int = 50295
    num_new_special_tokens: int = 10
    codebook_size: int = 8192
    num_vq_tokens: int = 256
    w_clip_vit: bool = False
    clip_feat_dim: int = 1024
    llm: PhiConfig = dataclasses.field(default_factory=PhiConfig)

    @property
    def mask_token_id(self) -> int:
        return self.vocab_size - 1

    @property
    def codebook_offset(self) -> int:
        return self.llm_vocab_size + self.num_new_special_tokens


class Showo(nn.Module):
    """``showo``: the Phi backbone, and with ``w_clip_vit`` the
    ``mm_projector`` (Linear, GELU, Linear: ``mm_projector.0`` /
    ``mm_projector.2``), under the reference checkpoint's names."""

    def __init__(self, cfg: ShowoConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.showo = Phi(cfg.llm, device, dtype)
        if cfg.w_clip_vit:
            d, kw = cfg.llm.hidden_size, dict(device=device, dtype=dtype)
            self.mm_projector = nn.Sequential(
                nn.Linear(cfg.clip_feat_dim, d, **kw), nn.GELU(),
                nn.Linear(d, d, **kw))


def init_showo(cfg: ShowoConfig, generator: torch.Generator, device=None,
               dtype=torch.float32) -> Showo:
    """Random-weight Show-o (counterpart of ``init_showo_params``): the
    projector's weights N(0, 0.02), its biases 0."""
    model = Showo(cfg, device=device, dtype=dtype)
    model.showo.init_random(generator)
    if cfg.w_clip_vit:
        with torch.no_grad():
            for lin in (model.mm_projector[0], model.mm_projector[2]):
                lin.weight.copy_(torch.randn(
                    lin.weight.shape, generator=generator,
                    device=generator.device) * 0.02)
                lin.bias.zero_()
    return model.eval().requires_grad_(False)


def mm_project(model: Showo, feats: torch.Tensor) -> torch.Tensor:
    """CLIP features [B, P, clip_feat_dim] -> [B, P, hidden]: Linear, exact
    GELU, Linear (JAX ``mm_project``)."""
    p = model.mm_projector
    return p[2](F.gelu(p[0](feats.to(p[0].weight.dtype)), approximate="none"))


def showo_forward(model: Showo, input_ids=None, input_embeds=None,
                  attention_bias=None, cache: Optional[KVCache] = None,
                  attn_meta=None):
    return model.showo(input_ids=input_ids, input_embeds=input_embeds,
                       attention_bias=attention_bias, cache=cache,
                       attn_meta=attn_meta)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_id: int = -100) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not
    ``ignore_id``, in fp32, in the logsumexp form
    ``nll = logsumexp(x) - x[label]`` (no [B, S, V] log-softmax tensor);
    over the global batch under a mesh (``parallel/mesh.py::
    global_mean``: this rank's share)."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    x = logits.float()
    picked = torch.gather(x, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, torch.logsumexp(x, dim=-1) - picked, 0.0)
    return global_mean(nll.sum(), valid.sum())


def showo_losses(model: Showo, input_ids, labels, attention_bias,
                 batch_size_t2i: int, batch_size_lm: int,
                 batch_size_mmu: int, max_seq_length: int = 128,
                 remat=True, input_embeds=None, attn_meta=None):
    """The fused three-task forward on a batch laid out [t2i | lm | mmu]:
    masked-token CE over the t2i rows' image span (from
    ``max_seq_length + 1`` on, no shift), next-token CE over the lm and mmu
    rows.  Returns (logits, loss_t2i, loss_lm, loss_mmu).  attn_meta: None
    (dense, under ``attention_bias``) or ("trainable", seg, pad, last_pad,
    prefix); remat: the layer policy of ``utils/remat.py``."""
    logits, _ = model.showo(input_ids=input_ids, input_embeds=input_embeds,
                            attention_bias=attention_bias,
                            attn_meta=attn_meta, remat=remat)
    t2i_end = batch_size_t2i
    lm_end = batch_size_t2i + batch_size_lm
    loss_t2i = cross_entropy_ignore(logits[:t2i_end, max_seq_length + 1:],
                                    labels[:t2i_end, max_seq_length + 1:])
    loss_lm = cross_entropy_ignore(logits[t2i_end:lm_end, :-1],
                                   labels[t2i_end:lm_end, 1:])
    loss_mmu = cross_entropy_ignore(
        logits[lm_end:lm_end + batch_size_mmu, :-1],
        labels[lm_end:lm_end + batch_size_mmu, 1:])
    return logits, loss_t2i, loss_lm, loss_mmu


def _attn_meta(attn_impl, ids, uncond_ids, use_cfg, pad_id, soi_id, eoi_id):
    """(route, span metadata) for a kernel route of ``ATTN_ROUTES``,
    computed once from the initial layout (special tokens and pads never
    move during MaskGIT); None for dense attention."""
    if attn_impl is None or check_route(attn_impl) == "dense":
        return None
    from showo_tpu_torch.ops.flash_attention import metadata_predict_next

    meta_ids = torch.cat([ids, uncond_ids], dim=0) if use_cfg else ids
    return (attn_impl,) + metadata_predict_next(meta_ids, pad_id, soi_id,
                                                eoi_id)


@torch.no_grad()
def showo_t2i_generate(
    model: Showo,
    input_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    uncond_input_ids: Optional[torch.Tensor] = None,
    attention_bias: Optional[torch.Tensor] = None,
    guidance_scale: float = 0.0,
    temperature: float = 1.0,
    timesteps: int = 18,
    noise_schedule=cosine_schedule,
    max_seq_length: int = 128,
    injected_noise=None,
    attn_impl: Optional[str] = None,
    pad_id: int = 50295,
    soi_id: int = 50296,
    eoi_id: int = 50297,
    sliced_head: bool = True,
):
    """MaskGIT generation, re-forwarding the whole sequence every step.

    attn_impl: None / "dense" (additive bias) or a kernel route of
    ``models/phi.py::ATTN_ROUTES`` ("packed", "omni", "decode", "fused";
    without a prefix cache "fused" runs as "omni")."""
    cfg = model.cfg
    use_cfg = uncond_input_ids is not None and guidance_scale > 0
    attn_meta = _attn_meta(attn_impl, input_ids, uncond_input_ids, use_cfg,
                           pad_id, soi_id, eoi_id)
    L = input_ids.shape[1]
    head_slice = None
    if sliced_head:
        # only image rows x codebook columns are sampled from
        head_slice = (L - cfg.num_vq_tokens - 1, L - 1, cfg.codebook_offset,
                      cfg.codebook_offset + cfg.codebook_size)

    def forward_fn(ids):
        logits, _ = model.showo(input_ids=ids, attention_bias=attention_bias,
                                attn_meta=attn_meta, lm_head_slice=head_slice)
        return logits

    return maskgit_generate(
        forward_fn, input_ids, generator,
        forward_returns_sliced=sliced_head,
        uncond_input_ids=uncond_input_ids,
        num_vq_tokens=cfg.num_vq_tokens, mask_token_id=cfg.mask_token_id,
        codebook_offset=cfg.codebook_offset,
        codebook_size=cfg.codebook_size, prompt_len=max_seq_length + 1,
        timesteps=timesteps, guidance_scale=guidance_scale,
        temperature=temperature, noise_schedule=noise_schedule,
        injected_noise=injected_noise)


@torch.no_grad()
def showo_t2i_generate_cached(
    model: Showo,
    input_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    uncond_input_ids: Optional[torch.Tensor] = None,
    attention_bias: torch.Tensor,
    guidance_scale: float = 0.0,
    temperature: float = 1.0,
    timesteps: int = 18,
    noise_schedule=cosine_schedule,
    max_seq_length: int = 128,
    injected_noise=None,
    attn_impl: Optional[str] = None,
    pad_id: int = 50295,
    soi_id: int = 50296,
    eoi_id: int = 50297,
):
    """MaskGIT generation with a prefix KV cache.

    The text prefix (positions < max_seq_length + 1) never changes and its
    keys/values depend only on itself, so it is prefilled once (dense
    attention); each step re-forwards only the soi..eoi span against the
    cached prefix.  Same tokens as :func:`showo_t2i_generate`.  attn_impl
    as there; on "fused" each step's attention is the one fused kernel.
    """
    cfg = model.cfg
    B, L = input_ids.shape
    P = max_seq_length + 1
    use_cfg = uncond_input_ids is not None and guidance_scale > 0
    full_prefix = (torch.cat([input_ids[:, :P], uncond_input_ids[:, :P]])
                   if use_cfg else input_ids[:, :P])
    attn_meta = _attn_meta(attn_impl, input_ids, uncond_input_ids, use_cfg,
                           pad_id, soi_id, eoi_id)

    embed = model.showo.model.embed_tokens.weight
    cache = KVCache.zeros(cfg.llm, full_prefix.shape[0], L, dtype=embed.dtype,
                          device=embed.device)
    showo_forward(model, input_ids=full_prefix,
                  attention_bias=attention_bias[:, :, :P, :], cache=cache)

    step_bias = attention_bias[:, :, P:, :]
    head_slice = (1, 1 + cfg.num_vq_tokens, cfg.codebook_offset,
                  cfg.codebook_offset + cfg.codebook_size)

    def forward_fn(ids):
        logits, _ = model.showo(input_ids=ids[:, P:], attention_bias=step_bias,
                                cache=cache, lm_head_slice=head_slice,
                                attn_meta=attn_meta, static_prefix_len=P)
        return logits

    return maskgit_generate(
        forward_fn, input_ids, generator,
        forward_returns_sliced=True,
        uncond_input_ids=uncond_input_ids,
        num_vq_tokens=cfg.num_vq_tokens, mask_token_id=cfg.mask_token_id,
        codebook_offset=cfg.codebook_offset,
        codebook_size=cfg.codebook_size, prompt_len=P,
        timesteps=timesteps, guidance_scale=guidance_scale,
        temperature=temperature, noise_schedule=noise_schedule,
        injected_noise=injected_noise)


@torch.no_grad()
def showo_mmu_generate(
    model: Showo,
    prompt_ids: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    *,
    prompt_bias: torch.Tensor,
    prompt_embeds: Optional[torch.Tensor] = None,
    max_new_tokens: int = 100,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eot_token: Optional[int] = None,
    injected_gumbel=None,
):
    """AR decode over a KV cache of the prompt's length + ``max_new_tokens``
    positions: prefill the prompt (token ids, or the embeddings
    ``prompt_embeds`` of the CLIP-ViT path) under ``prompt_bias`` [B, 1, S,
    S] padded to the capacity with -1e9, then one forward per new token.
    Returns (tokens, valid) of
    :func:`~showo_tpu_torch.sampling.ar.ar_generate`."""
    phi = model.showo
    first = prompt_ids if prompt_embeds is None else prompt_embeds
    B, S = first.shape[:2]
    cap = S + max_new_tokens
    emb = phi.model.embed_tokens.weight

    def prefill(ids, bias):
        cache = KVCache.zeros(model.cfg.llm, B, cap, dtype=emb.dtype,
                              device=emb.device)
        bias = F.pad(bias, (0, cap - bias.shape[-1]), value=-1e9)
        if prompt_embeds is not None:
            return phi(input_embeds=prompt_embeds, attention_bias=bias,
                       cache=cache)
        return phi(input_ids=ids, attention_bias=bias, cache=cache)

    def decode(ids, bias, cache):
        return phi(input_ids=ids, attention_bias=bias, cache=cache)

    return ar_generate(prefill, decode, prompt_ids, generator,
                       max_new_tokens=max_new_tokens,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       eot_token=eot_token, prompt_bias=prompt_bias,
                       injected_gumbel=injected_gumbel)
