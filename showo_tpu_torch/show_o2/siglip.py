"""SigLIP semantic tower as PyTorch modules.

Counterpart of ``showo_tpu/show_o2/siglip.py``: the vision encoder of
google/siglip-so400m-patch14-384 minus its last layer, fed with
patch-embedded VAE latents plus the SigLIP position embedding
(show-o2/models/modeling_showo2_qwen2_5.py:77-83).  A pre-LN ViT stack:
LayerNorm, biased multi-head attention, tanh-GELU MLP.  Attention is dense
(fp32 scores from exact products of the stored operands, as in JAX); the
JAX package runs no kernel here.  Module names follow the reference's
``und_trans.layers.{i}``.  :func:`interpolate_pos_encoding` resizes the
position table to another patch grid, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from showo_tpu_torch.models.phi import layer_norm
from showo_tpu_torch.utils.image import keys_cubic_weights
from showo_tpu_torch.utils.remat import project, wrap_remat


@dataclasses.dataclass(frozen=True)
class SigLipConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    num_layers: int = 26          # 27 minus the deleted last layer
    layer_norm_eps: float = 1e-6
    num_positions: int = 729      # 27x27 for so400m-384

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class SiglipAttention(nn.Module):
    def __init__(self, cfg: SigLipConfig, device=None, dtype=None):
        super().__init__()
        D = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(D, D, **kw)
        self.k_proj = nn.Linear(D, D, **kw)
        self.v_proj = nn.Linear(D, D, **kw)
        self.out_proj = nn.Linear(D, D, **kw)


class SiglipMLP(nn.Module):
    def __init__(self, cfg: SigLipConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)


class SiglipLayer(nn.Module):
    def __init__(self, cfg: SigLipConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(eps=cfg.layer_norm_eps, device=device, dtype=dtype)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, **kw)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, **kw)
        self.self_attn = SiglipAttention(cfg, device, dtype)
        self.mlp = SiglipMLP(cfg, device, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, S, D = h.shape
        H, Dh = self.cfg.num_heads, self.cfg.head_dim
        a = self.self_attn
        x = layer_norm(h, self.layer_norm1)
        q, k, v = (project(p, x).view(B, S, H, Dh)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        with torch.autocast(h.device.type, enabled=False):
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) / math.sqrt(Dh)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        h = h + project(a.out_proj, attn.reshape(B, S, D))
        x2 = layer_norm(h, self.layer_norm2)
        mlp = F.gelu(project(self.mlp.fc1, x2), approximate="tanh")
        return h + project(self.mlp.fc2, mlp, tail=True)


class SiglipEncoder(nn.Module):
    """The semantic layers (reference ``und_trans``)."""

    def __init__(self, cfg: SigLipConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(SiglipLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor, remat=False) -> torch.Tensor:
        """x [B, S, D]: patch embeddings, position embedding added.
        remat: the layer policy of ``utils/remat.py`` (under a gradient
        the 26 layers would otherwise keep every layer's fp32 [B, H, S, S]
        probabilities).  JAX tags nothing here: the named rungs keep only
        the layer's input, ``dots`` its projections' outputs."""
        for layer in self.layers:
            x = wrap_remat(layer, remat)(x)
        return x


def interpolate_pos_encoding(pos_embed: torch.Tensor, h: int,
                             w: int) -> torch.Tensor:
    """The [N, D] square grid position table resized to an (h, w) grid,
    [1, h*w, D] (show-o2/models/misc.py:305-334), as JAX's
    ``jax.image.resize(..., "bicubic")`` does it: the antialiased Keys
    cubic weights of each axis whose size changes, cast to the table's
    dtype, contracted rows first, then columns."""
    N, D = pos_embed.shape
    side = int(round(math.sqrt(N)))
    grid = pos_embed.reshape(side, side, D)
    if h != side:
        wh = keys_cubic_weights(side, h).to(grid)
        grid = torch.einsum("sxd,sh->hxd", grid, wh)
    if w != side:
        ww = keys_cubic_weights(side, w).to(grid)
        grid = torch.einsum("hsd,sw->hwd", grid, ww)
    return grid.reshape(1, h * w, D)
