"""Qwen2 / Qwen2.5 decoder as PyTorch modules.

Counterpart of ``showo_tpu/show_o2/qwen2.py`` (the reference fork
show-o2/models/qwen2.py):
  * RMSNorm with fp32 internals, SwiGLU MLP, GQA with q/k/v biases and no
    o bias;
  * full-head RoPE (default rope type), theta 1e6 for Qwen2.5;
  * the caller's dense [B, 1, L, L] additive omni mask is used as it is
    (the fork's raw mask passthrough), or an attention route
    (``ATTN_ROUTES``) sends attention to the packed omni kernel;
  * tied word embeddings (the 1.5B config): the logits are ``h @ embed.T``.

The module tree carries the reference checkpoint's names
(``model.layers.{i}.self_attn.q_proj`` ...), so a reference-layout state
dict loads with ``load_state_dict``.  :func:`fuse_inference` re-lays the
weights for inference (one qkv and one gate/up matmul per layer), as the
JAX transform of the same name does.  The KV cache, per-row cache offsets,
int8 weights and the trainable and streaming routes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from showo_tpu_torch.ops.flash_attention import (omni_attention_packed,
                                                 rows_tile_map,
                                                 q_rows, span_meta)

# Attention routes: the port's name -> the JAX package's attn impl string.
#   dense   einsum attention under the additive bias (no kernel)
#   packed  omni kernel on the packed [B, S, H*D] layout (kernel 1), with
#           the mask recomputed from (seg, pad, last_pad, prefix)
ATTN_ROUTES = {"dense": None, "packed": "pallas_packed"}


def check_route(name: str) -> str:
    """``name`` if it is a route of :data:`ATTN_ROUTES`; any other name (a
    JAX impl string among them) raises ValueError."""
    if name not in ATTN_ROUTES:
        port = {j: p for p, j in ATTN_ROUTES.items() if j}.get(name)
        hint = f" (the JAX package's name of route {port!r})" if port else ""
        raise ValueError(f"unknown Show-o2 attention route {name!r}{hint}; "
                         f"the routes are {sorted(ATTN_ROUTES)}")
    return name


@dataclasses.dataclass(frozen=True)
class PackedMeta:
    """The packed kernel's metadata for one forward, computed once for all
    layers of both towers (:func:`packed_meta`): seg / pad / last_pad /
    prefix int32 and contiguous, the q rows' (pos_q, seg_q), and on CUDA
    the tile map that the kernel reads (``rows_tile_map``; None on the
    CPU, whose plain version needs none).  The map depends on the metadata
    alone, not on heads or head dim, so Qwen's layers (head dim 128) and
    the DiT's (64) read the same one."""

    seg: torch.Tensor
    pad: torch.Tensor
    last_pad: torch.Tensor
    prefix: torch.Tensor
    pos_q: torch.Tensor
    seg_q: torch.Tensor
    tiles: Optional[torch.Tensor] = None


def packed_meta(attn_meta) -> Optional[PackedMeta]:
    """(route, seg, pad, last_pad, prefix) -> :class:`PackedMeta` of a
    self-attention forward over the metadata's rows; None and a
    :class:`PackedMeta` pass through."""
    if attn_meta is None or isinstance(attn_meta, PackedMeta):
        return attn_meta
    route, seg, pad, last_pad, prefix = attn_meta
    if check_route(route) != "packed":
        raise ValueError(f"the {route} route takes attn_meta=None")
    B, S = seg.shape
    meta = span_meta(seg, pad, last_pad, prefix, B, S, seg.device)
    pos_q, seg_q = q_rows(meta[0], torch.arange(S, device=seg.device), B, S)
    tiles = rows_tile_map(*meta, pos_q, seg_q) if seg.is_cuda else None
    return PackedMeta(*meta, pos_q, seg_q, tiles)


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151940      # 151936 + [PAD], <image>, vid_start/end
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    head_dim: int = 128
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    # fp32 attention scores and softmax on the dense path (the reference
    # upcasts); False keeps the scores in the activation dtype
    attn_fp32: bool = True


class RMSNorm(nn.Module):
    """RMSNorm (reference name ``weight``) computed in fp32, returned in
    the input's dtype."""

    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [..., head_dim] (full-head rotary), fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=positions.device)
                                / head_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh]; cos/sin [B or 1, S, Dh] fp32, applied in x's
    dtype (broadcast over heads)."""
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin


def gqa_attention(q, k, v, bias, meta: Optional[PackedMeta],
                  softmax_dtype=torch.float32) -> torch.Tensor:
    """q [B, S, H, Dh]; k, v [B, S, Hkv, Dh] (views are fine); bias
    [B, 1, S, S] additive.  Returns [B, S, H*Dh].

    With ``meta`` the packed omni kernel recomputes the mask from it (the
    bias is unused); otherwise the dense path: the kv-head groups folded
    into the einsum (no repeated K/V), scores in ``softmax_dtype`` from
    exact products of the stored operands, softmax, probabilities cast to
    v's dtype."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if meta is not None:
        return omni_attention_packed(
            q.reshape(B, S, H * Dh), k.reshape(B, S, Hkv * Dh),
            v.reshape(B, S, Hkv * Dh), meta.seg, meta.pad, meta.last_pad,
            meta.prefix, num_heads=H, num_kv_heads=Hkv,
            q_positions=meta.pos_q, seg_q=meta.seg_q, tiles=meta.tiles)
    qg = q.reshape(B, S, Hkv, H // Hkv, Dh)
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(softmax_dtype),
                              k.to(softmax_dtype)) / math.sqrt(Dh)
        if bias is not None:
            scores = scores + bias[:, :, None].to(softmax_dtype)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, S, H * Dh)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, device=None, dtype=None):
        super().__init__()
        D, Dh = cfg.hidden_size, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(D, cfg.num_heads * Dh, **kw)
        self.k_proj = nn.Linear(D, cfg.num_kv_heads * Dh, **kw)
        self.v_proj = nn.Linear(D, cfg.num_kv_heads * Dh, **kw)
        self.o_proj = nn.Linear(cfg.num_heads * Dh, D, bias=False, **kw)


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))`` (reference names), or one ``gu``
    matmul after :func:`fuse_attention_mlp`."""

    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(dim, hidden, **kw)
        self.up_proj = nn.Linear(dim, hidden, **kw)
        self.down_proj = nn.Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "gu"):
            gate, up = self.gu(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


def qkv_heads(attn: nn.Module, x: torch.Tensor, heads: int, kv_heads: int,
              head_dim: int):
    """(q [B, S, H, Dh], k, v [B, S, Hkv, Dh]) from separate projections
    or the fused ``qkv`` (then views of its output)."""
    B, S, _ = x.shape
    if hasattr(attn, "qkv"):
        q, k, v = attn.qkv(x).split([heads * head_dim, kv_heads * head_dim,
                                     kv_heads * head_dim], dim=-1)
    else:
        q, k, v = attn.q_proj(x), attn.k_proj(x), attn.v_proj(x)
    return (q.view(B, S, heads, head_dim), k.view(B, S, kv_heads, head_dim),
            v.view(B, S, kv_heads, head_dim))


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, device,
                                                dtype)
        self.self_attn = Qwen2Attention(cfg, device, dtype)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, device,
                          dtype)

    def forward(self, h, bias, cos, sin, meta: Optional[PackedMeta] = None):
        cfg = self.cfg
        B, S, _ = h.shape
        q, k, v = qkv_heads(self.self_attn, self.input_layernorm(h),
                            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = gqa_attention(
            q, k, v, bias, meta,
            softmax_dtype=torch.float32 if cfg.attn_fp32 else h.dtype)
        h = h + self.self_attn.o_proj(attn)
        return h + self.mlp(self.post_attention_layernorm(h))


class Qwen2Model(nn.Module):
    def __init__(self, cfg: Qwen2Config, device=None, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList(Qwen2DecoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)


class Qwen2(nn.Module):
    """Qwen2 causal LM.  ``forward`` is the counterpart of JAX
    ``qwen2_forward`` without a cache."""

    def __init__(self, cfg: Qwen2Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen2Model(cfg, device, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, device=device, dtype=dtype)

    def forward(self, input_ids=None, input_embeds=None, attention_bias=None,
                position_ids=None, attn_meta=None, logits: bool = True):
        """Returns (logits or None, last hidden state after the final norm).

        attention_bias: [B, 1, S, S] additive mask (the dense route).
        attn_meta: optional ``("packed", seg, pad, last_pad, prefix)``, or
        a :class:`PackedMeta` already computed, sending every layer's
        attention to the packed omni kernel.  ``logits=False`` skips the
        vocabulary projection (the velocity path reads only the hidden
        state)."""
        cfg = self.cfg
        if input_embeds is None:
            input_embeds = self.model.embed_tokens(input_ids)
        B, S, _ = input_embeds.shape
        if position_ids is None:
            position_ids = torch.arange(S, device=input_embeds.device)[None]
        cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
        meta = packed_meta(attn_meta)
        h = input_embeds
        for layer in self.model.layers:
            h = layer(h, attention_bias, cos, sin, meta)
        h = self.model.norm(h)
        if not logits:
            return None, h
        head = (self.lm_head.weight if hasattr(self, "lm_head")
                else self.model.embed_tokens.weight)
        return F.linear(h, head), h


@torch.no_grad()
def init_normal(module: nn.Module, generator: torch.Generator,
                zero=()) -> nn.Module:
    """N(0, 0.02) for every weight of two or more dims (drawn in fp32 on
    the generator's device, then cast), zeros for biases and for the
    parameters whose names contain one of ``zero``, ones for the 1-dim
    weights (norm scales)."""
    for name, p in module.named_parameters():
        if any(z in name for z in zero) or name.endswith("bias"):
            p.zero_()
        elif p.dim() >= 2:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * 0.02)
        else:
            p.fill_(1.0)
    return module


@torch.no_grad()
def fuse_attention_mlp(layers, qkv_bias: bool) -> None:
    """Fuse each layer's q/k/v into one ``self_attn.qkv`` and the SwiGLU
    gate/up into one ``mlp.gu`` (the same products; wider matmuls), in
    place; layers already fused are left alone."""
    for layer in layers:
        a, m = layer.self_attn, layer.mlp
        if not hasattr(a, "qkv"):
            w = torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight])
            a.qkv = nn.Linear(w.shape[1], w.shape[0], bias=qkv_bias,
                              device=w.device, dtype=w.dtype)
            a.qkv.weight.copy_(w)
            if qkv_bias:
                a.qkv.bias.copy_(torch.cat([a.q_proj.bias, a.k_proj.bias,
                                            a.v_proj.bias]))
            del a.q_proj, a.k_proj, a.v_proj
        if not hasattr(m, "gu"):
            w = torch.cat([m.gate_proj.weight, m.up_proj.weight])
            m.gu = nn.Linear(w.shape[1], w.shape[0], bias=False,
                             device=w.device, dtype=w.dtype)
            m.gu.weight.copy_(w)
            del m.gate_proj, m.up_proj


def fuse_inference(model: Qwen2) -> Qwen2:
    """Both inference-path weight fusions (qkv with its biases, gate/up);
    idempotent, in place."""
    fuse_attention_mlp(model.model.layers, qkv_bias=True)
    return model
