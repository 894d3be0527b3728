"""DiT diffusion head and the shared Show-o2 modules, as PyTorch modules.

Counterpart of ``showo_tpu/show_o2/dit.py`` (show-o2/models/modules.py):
  * DiffusionHeadConfig: hidden 2048, 32 q / 8 kv heads of dim 64, SwiGLU
    8192, per-head RMSNorm on q and k, llama3-scaled RoPE theta 5e5;
  * ModulatedAttentionBlock: adaLN 6-way modulation applied only inside
    the image spans of ``modality_positions`` (modules.py:109-218), the
    per-span scatter vectorized (:func:`span_modulation`);
  * FinalLayer: adaLN-modulated RMSNorm and a linear to p*p*C
    (modules.py:778-806);
  * TimestepEmbedder: sinusoidal embedding and an MLP (modules.py:737-775);
  * PatchEmbed: a p x p convolution of stride p (modules.py:705-734);
  * modulate() in fp32 (modules.py:98-106).

Attention takes the routes of ``qwen2.ATTN_ROUTES``: dense under the
additive mask, or the packed omni kernel (kernel 1 at head dim 64, GQA
32/8).  The per-head q/k RMSNorm is one plain per-head norm; the JAX
package's segment-matmul form of it is a TPU relayout workaround.  Module
names follow the reference's ``diffusion_head_a.{i}`` /
``diffusion_head_b``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from showo_tpu_torch.show_o2.qwen2 import (PackedMeta, RMSNorm, SwiGLU,
                                           apply_rope, fuse_attention_mlp,
                                           gqa_attention, qkv_heads)


@dataclasses.dataclass(frozen=True)
class DiffusionHeadConfig:
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 5e5
    qk_norm: bool = True
    # llama3 rope scaling
    rope_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    num_layers: int = 10
    attn_fp32: bool = True


QK_NORM_EPS = 1e-6       # the reference's q_norm / k_norm eps


def llama3_rope_tables(positions: torch.Tensor, cfg: DiffusionHeadConfig):
    """llama3-type scaled RoPE (transformers ROPE_INIT 'llama3'): cos/sin
    [..., head_dim] fp32."""
    d = cfg.head_dim
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=dev) / d))
    low_wav = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wav = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    inv_scaled = inv_freq / cfg.rope_factor
    smooth = ((cfg.rope_original_max_position / wavelen
               - cfg.rope_low_freq_factor)
              / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor))
    smoothed = (1 - smooth) * inv_scaled + smooth * inv_freq
    is_medium = (wavelen < low_wav) & (wavelen > high_wav)
    inv = torch.where(wavelen > low_wav, inv_scaled,
                      torch.where(is_medium, smoothed, inv_freq))
    freqs = positions[..., None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """x * (1 + scale) + shift in fp32, returned in x's dtype."""
    return (x.float() * (1 + scale.float()) + shift.float()).to(x.dtype)


def span_broadcast(values: torch.Tensor, modality_positions: torch.Tensor,
                   L: int, default: float) -> torch.Tensor:
    """Per-image vectors [B*M, D] onto sequence positions [B, L, D]:
    positions inside span j of row i get values[i*M + j] (the last span
    that claims them), every other position ``default``."""
    B, M = modality_positions.shape[:2]
    mp = modality_positions
    pos = torch.arange(L, device=mp.device)[None, :, None]
    off, length = mp[:, None, :, 0], mp[:, None, :, 1]
    in_span = (pos >= off) & (pos < off + length)                # [B, L, M]
    ids = torch.arange(M, device=mp.device)[None, None, :] + 1
    span_id = torch.argmax(torch.where(in_span, ids, 0), dim=-1)
    claimed = torch.gather(in_span, 2, span_id[:, :, None])[..., 0]
    flat = torch.arange(B, device=mp.device)[:, None] * M + span_id
    gathered = values[flat]
    return torch.where(claimed[..., None], gathered,
                       torch.full_like(gathered, default))


def span_modulation(ada: torch.Tensor, modality_positions: torch.Tensor,
                    L: int, n_chunks: int = 6, full_span: bool = False):
    """The adaLN modulation tensors of ``ada`` [B*M, n*D] (the per-span
    projection), as JAX ``span_modulation``: returns (chunks, claimed).

    * ``full_span`` (the caller knows the one span covers every row):
      n chunks [B, 1, D], claimed None;
    * one span per row: n chunks [B, 1, D] and claimed [B, L], the rows
      inside the span (the others pass through unmodulated);
    * several spans: n chunks [B, L, D], each row's span's chunk (0 outside
      every span), and claimed [B, L]."""
    BM, DN = ada.shape
    B, M = modality_positions.shape[:2]
    if full_span or M == 1:
        if full_span and M != 1:
            raise ValueError("full_span requires a single span")
        chunks = ada.reshape(B, 1, DN).chunk(n_chunks, dim=-1)
        if full_span:
            return chunks, None
        pos = torch.arange(L, device=ada.device)[None, :]
        off = modality_positions[:, 0, 0][:, None]
        length = modality_positions[:, 0, 1][:, None]
        return chunks, (pos >= off) & (pos < off + length)
    pos = torch.arange(L, device=ada.device)
    off = modality_positions[..., 0]                                 # [B, M]
    length = modality_positions[..., 1]
    in_span = ((pos[None, None, :] >= off[..., None])
               & (pos[None, None, :] < (off + length)[..., None]))  # [B,M,L]
    oh = in_span.to(ada.dtype)
    ada = ada.reshape(B, M, DN)
    D = DN // n_chunks
    chunks = [torch.einsum("bml,bmk->blk", oh, ada[..., i * D:(i + 1) * D])
              for i in range(n_chunks)]
    return chunks, in_span.any(dim=1)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000) -> torch.Tensor:
    """Sinusoidal embedding [N, dim] fp32 (modules.py:749-768)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """Reference ``time_embed``: ``mlp`` = Linear, SiLU, Linear over the
    256-dim sinusoidal embedding."""

    def __init__(self, hidden: int, freq_dim: int = 256, device=None,
                 dtype=None):
        super().__init__()
        self.freq_dim = freq_dim
        kw = dict(device=device, dtype=dtype)
        self.mlp = nn.Sequential(nn.Linear(freq_dim, hidden, **kw), nn.SiLU(),
                                 nn.Linear(hidden, hidden, **kw))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dtype = self.mlp[0].weight.dtype
        return self.mlp(timestep_embedding(t, self.freq_dim).to(dtype))


class PatchEmbed(nn.Module):
    """Reference ``image_embedder_*``: ``proj`` a p x p convolution of
    stride p; [B, C, H, W] -> [B, (H/p)(W/p), D] in row-major patch
    order."""

    def __init__(self, in_ch: int, hidden: int, patch_size: int, device=None,
                 dtype=None):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, hidden, patch_size, stride=patch_size,
                              device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class DiTAttention(nn.Module):
    def __init__(self, cfg: DiffusionHeadConfig, device=None, dtype=None):
        super().__init__()
        D, Dh = cfg.hidden_size, cfg.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(D, cfg.num_heads * Dh, **kw)
        self.k_proj = nn.Linear(D, cfg.num_kv_heads * Dh, **kw)
        self.v_proj = nn.Linear(D, cfg.num_kv_heads * Dh, **kw)
        self.o_proj = nn.Linear(cfg.num_heads * Dh, D, **kw)
        self.q_norm = RMSNorm(Dh, QK_NORM_EPS, device, dtype)
        self.k_norm = RMSNorm(Dh, QK_NORM_EPS, device, dtype)


class ModulatedAttentionBlock(nn.Module):
    """One DiT layer (modules.py:131-218)."""

    def __init__(self, cfg: DiffusionHeadConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.input_layernorm = RMSNorm(D, cfg.rms_norm_eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(D, cfg.rms_norm_eps, device,
                                                dtype)
        self.self_attn = DiTAttention(cfg, device, dtype)
        self.mlp = SwiGLU(D, cfg.intermediate_size, device, dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(D, 6 * D, device=device, dtype=dtype))

    def forward(self, h, adaln_input, bias, cos, sin, modality_positions,
                meta: Optional[PackedMeta] = None, full_span: bool = False):
        cfg = self.cfg
        B, L, _ = h.shape
        ada = self.adaLN_modulation(adaln_input)
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp), claimed = span_modulation(ada, modality_positions, L,
                                              full_span=full_span)
        if claimed is not None and shift_msa.shape[1] == 1:
            # one span per row: in-span rows modulated and gated, the
            # others pass through (modulate(x, 0, 0) == x, gate 1)
            c = claimed[..., None]

            def mod(x, sh, sc):
                return torch.where(c, modulate(x, sh, sc), x)

            def gate(g, y):
                return torch.where(c, g * y, y)
        else:
            if claimed is not None:
                # the gate is 1 outside every span
                out = (~claimed)[..., None].to(gate_msa.dtype)
                gate_msa, gate_mlp = gate_msa + out, gate_mlp + out
            mod = modulate

            def gate(g, y):
                return g * y

        a = self.self_attn
        x = mod(self.input_layernorm(h), shift_msa, scale_msa)
        q, k, v = qkv_heads(a, x, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim)
        if cfg.qk_norm:
            q, k = a.q_norm(q), a.k_norm(k)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = gqa_attention(
            q, k, v, bias, meta,
            softmax_dtype=torch.float32 if cfg.attn_fp32 else h.dtype)
        h = h + gate(gate_msa, a.o_proj(attn))
        x2 = mod(self.post_attention_layernorm(h), shift_mlp, scale_mlp)
        return h + gate(gate_mlp, self.mlp(x2))


class FinalLayer(nn.Module):
    """Reference ``diffusion_head_b`` (modules.py:787-806)."""

    def __init__(self, hidden: int, patch_size: int, out_channels: int,
                 rms_eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm_final = RMSNorm(hidden, rms_eps, device, dtype)
        self.linear = nn.Linear(hidden, patch_size * patch_size * out_channels,
                                **kw)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden, 2 * hidden, **kw))

    def forward(self, x, adaln_input, modality_positions,
                full_span: bool = False):
        L = x.shape[1]
        (shift, scale), claimed = span_modulation(
            self.adaLN_modulation(adaln_input), modality_positions, L,
            n_chunks=2, full_span=full_span)
        xn = self.norm_final(x)
        x = modulate(xn, shift, scale)
        if claimed is not None and shift.shape[1] == 1:
            x = torch.where(claimed[..., None], x, xn)
        return self.linear(x)


def dit_forward(cfg: DiffusionHeadConfig, layers, h, adaln_input,
                attention_bias, modality_positions,
                meta: Optional[PackedMeta] = None, positions=None,
                full_span: bool = False) -> torch.Tensor:
    """The stack of ModulatedAttentionBlocks (``layers``, reference
    ``diffusion_head_a``) over h [B, S, D] with the per-image adaLN input
    [B*M, D].  positions: optional [B or 1, S] rope positions (default
    arange).  ``meta`` sends attention to the packed omni kernel.  Its
    tile map, made once per forward with Qwen's (``packed_meta``), holds
    here too: the DiT attends over the same L rows of h as Qwen (q rows
    at kv positions 0..L-1, Q = S = L) under the same seg / pad /
    last_pad / prefix, and the map depends on nothing else."""
    B, S, _ = h.shape
    if positions is None:
        positions = torch.arange(S, device=h.device)[None]
    cos, sin = llama3_rope_tables(positions, cfg)
    for layer in layers:
        h = layer(h, adaln_input, attention_bias, cos, sin,
                  modality_positions, meta, full_span)
    return h


def fuse_inference(layers) -> None:
    """The DiT's inference fusions (qkv without biases, gate/up), in
    place; idempotent."""
    fuse_attention_mlp(layers, qkv_bias=False)
