"""CLIP ViT vision tower (frozen) as PyTorch modules.

Counterpart of ``showo_tpu/models/clip_vit.py``: the reference
``CLIPVisionTower`` (openai/clip-vit-large-patch14-336 by default),
penultimate-layer features (``select_layer = -2``) with the CLS token
dropped, 576 patch tokens of width 1024 that feed Show-o's
``mm_projector``.  Pre-LN ViT with QuickGELU MLPs, fp32 LayerNorms and
fp32 attention scores, as in JAX.  The modules carry the Hugging Face
``CLIPVisionModel`` names (``vision_model.embeddings.patch_embedding`` ...),
so its state dict loads with ``load_state_dict``; the layers past
``select_layer`` are built (they are in the checkpoint) but not run.

The tower's forward (JAX ``clip_vit_features``) takes NHWC pixels, as the
JAX functions do.  :func:`clip_vit_features_s2` is the S2 multiscale variant
(``CLIPVisionTowerS2``) with the JAX package's torch-bicubic resize
matrices.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from showo_tpu_torch.models.phi import layer_norm


@dataclasses.dataclass(frozen=True)
class ClipVitConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 24
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    select_layer: int = -2   # penultimate

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    def __init__(self, cfg: ClipVitConfig, **kw):
        super().__init__()
        D = cfg.hidden_size
        self.q_proj = nn.Linear(D, D, **kw)
        self.k_proj = nn.Linear(D, D, **kw)
        self.v_proj = nn.Linear(D, D, **kw)
        self.out_proj = nn.Linear(D, D, **kw)


class _MLP(nn.Module):
    def __init__(self, cfg: ClipVitConfig, **kw):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipVitConfig, **kw):
        super().__init__()
        self.cfg = cfg
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = _Attention(cfg, **kw)
        self.layer_norm1 = nn.LayerNorm(D, eps=eps, **kw)
        self.mlp = _MLP(cfg, **kw)
        self.layer_norm2 = nn.LayerNorm(D, eps=eps, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, S, D = h.shape
        H, Dh = self.cfg.num_heads, self.cfg.head_dim
        a = self.self_attn
        x = layer_norm(h, self.layer_norm1)
        q, k, v = (p(x).reshape(B, S, H, Dh)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) / math.sqrt(Dh)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D)
        h = h + a.out_proj(attn)
        x2 = layer_norm(h, self.layer_norm2)
        return h + self.mlp.fc2(quick_gelu(self.mlp.fc1(x2)))


class _Embeddings(nn.Module):
    def __init__(self, cfg: ClipVitConfig, **kw):
        super().__init__()
        D = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(D, **kw))
        self.patch_embedding = nn.Conv2d(3, D, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False,
                                         **kw)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, D, **kw)


class _Encoder(nn.Module):
    def __init__(self, cfg: ClipVitConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_layers))


class _VisionModel(nn.Module):
    def __init__(self, cfg: ClipVitConfig, **kw):
        super().__init__()
        self.embeddings = _Embeddings(cfg, **kw)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps, **kw)
        self.encoder = _Encoder(cfg, **kw)


class ClipVisionTower(nn.Module):
    """``vision_model``: embeddings, pre-LN and encoder layers under the HF
    names.  ``forward`` is JAX ``clip_vit_features``."""

    def __init__(self, cfg: ClipVitConfig = ClipVitConfig(), device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg, device=device, dtype=dtype)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "ClipVisionTower":
        """Random init as JAX ``init_clip_vit_params``: N(0, 0.02) for the
        embeddings and matmul weights, zero biases, unit norm scales."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * 0.02)
        return self

    @torch.no_grad()
    def forward(self, pixels_nhwc: torch.Tensor) -> torch.Tensor:
        """Penultimate-layer patch features [B, num_patches, D] (no CLS)."""
        cfg, vm = self.cfg, self.vision_model
        emb = vm.embeddings
        w = emb.patch_embedding.weight
        B = pixels_nhwc.shape[0]
        patches = emb.patch_embedding(
            pixels_nhwc.permute(0, 3, 1, 2).to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)          # [B, P, D]
        cls = emb.class_embedding[None, None].expand(B, 1, -1)
        h = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight
        h = layer_norm(h, vm.pre_layrnorm)
        n_run = cfg.num_layers + 1 + cfg.select_layer
        for layer in vm.encoder.layers[:n_run]:
            h = layer(h)
        return h[:, 1:]


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] interpolation weights of torch's bicubic (a = -0.75,
    half-pixel centres, edges clamped), as the JAX package builds them."""
    a = -0.75
    scale = n_in / n_out
    c = (np.arange(n_out) + 0.5) * scale - 0.5
    base = np.floor(c).astype(np.int64)
    frac = c - base
    w = np.zeros((n_out, n_in), np.float32)
    for k in range(-1, 3):
        t = np.abs(frac - k)
        wk = np.where(
            t <= 1, (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0))
        idx = np.clip(base + k, 0, n_in - 1)
        np.add.at(w, (np.arange(n_out), idx), wk.astype(np.float32))
    return w


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC resize by the two 1-D bicubic matrices, in fp32."""
    _, H, W, _ = x.shape
    wh = torch.as_tensor(bicubic_matrix(H, out_h), device=x.device)
    ww = torch.as_tensor(bicubic_matrix(W, out_w), device=x.device)
    x = torch.einsum("oh,bhwc->bowc", wh, x.float())
    return torch.einsum("ow,bhwc->bhoc", ww, x)


def clip_vit_features_s2(tower: ClipVisionTower, pixels_nhwc: torch.Tensor,
                         scales=None, max_split_size=None) -> torch.Tensor:
    """Multiscale (S2) patch features [B, num_patches, D * len(scales)]:
    per scale a bicubic resize, a chessboard split into tiles of
    ``max_split_size`` (default the smallest scale), every tile of every
    scale through the tower in one batch, the tiles merged back, area-
    pooled to the smallest scale's grid, and the scales concatenated on
    channels (JAX ``clip_vit_features_s2``)."""
    cfg = tower.cfg
    B, H0, W0, C = pixels_nhwc.shape
    scales = sorted(scales or (cfg.image_size, 2 * cfg.image_size,
                               3 * cfg.image_size))
    split = int(max_split_size or scales[0])
    tiles_per_scale, all_tiles = [], []
    for s in scales:
        n = math.ceil(s / split)
        t = s // n
        x = pixels_nhwc
        if (H0, W0) != (s, s):
            x = bicubic_resize(pixels_nhwc, s, s).to(pixels_nhwc.dtype)
        tiles = x.reshape(B, n, t, n, t, C).permute(1, 3, 0, 2, 4, 5)
        all_tiles.append(tiles.reshape(n * n * B, t, t, C))
        tiles_per_scale.append(n)
    feats = tower(torch.cat(all_tiles, 0))
    p = int(round(math.sqrt(feats.shape[1])))
    D = feats.shape[-1]
    out, off, base = [], 0, p
    for n in tiles_per_scale:
        f = feats[off:off + n * n * B]
        off += n * n * B
        f = f.reshape(n, n, B, p, p, D).permute(2, 0, 3, 1, 4, 5)
        f = f.reshape(B, n * p, n * p, D)
        factor = (n * p) // base
        if factor * base != n * p:
            raise ValueError(f"s2 scales must be integer multiples of the "
                             f"base scale (merged grid {n * p} vs {base})")
        f = f.reshape(B, base, factor, base, factor, D).mean(dim=(2, 4))
        out.append(f)
    return torch.cat(out, dim=-1).reshape(B, base * base, D * len(scales))
