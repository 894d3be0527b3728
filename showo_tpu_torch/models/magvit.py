"""MAGVIT-v2 with lookup-free quantisation (LFQ) codes.

Counterpart of ``showo_tpu/models/magvit.py``: ``GroupNorm(32,
eps=1e-6)``, ``ResnetBlock``, the mid-block ``AttnBlock`` (single-head
attention over the spatial grid, plain matmul + softmax), nearest-2x
``Upsample``, stride-2 ``Downsample`` with the reference's asymmetric
(0, 1) pad, ``VQGANEncoder`` (+ ``quant_conv``), ``VQGANDecoder``, the LFQ
bit arithmetic (``lfq_quantize``, ``lfq_indices``,
``lfq_codebook_entry``), LFQ's entropy and commitment losses
(``lfq_losses``) and the facade's ``encode`` / ``get_code`` /
``decode_code``.  NCHW inside; pixels go in and images come out NHWC, as
in the JAX package.  The module tree carries the reference checkpoint's
names (``encoder.down.{i}.block.{j}.conv1``, ``decoder.up.{i}...``), so a
reference state dict loads as it is (``utils/convert.py::load_magvit``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class VQConfig:
    ch: int = 128
    enc_ch_mult: Sequence[int] = (1, 2, 2, 4, 4)
    enc_num_res_blocks: Sequence[int] = (4, 3, 4, 3, 4)
    dec_ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    dec_num_res_blocks: Sequence[int] = (4, 4, 3, 4, 3)
    z_channels: int = 13
    in_ch: int = 3
    out_ch: int = 3


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def group_norm(channels: int, **kw) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6, **kw)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.norm1 = group_norm(in_channels, **kw)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.norm2 = group_norm(out_channels, **kw)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1, **kw)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over the spatial grid."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.norm = group_norm(channels, **kw)
        self.q = nn.Conv2d(channels, channels, 1, **kw)
        self.k = nn.Conv2d(channels, channels, 1, **kw)
        self.v = nn.Conv2d(channels, channels, 1, **kw)
        self.proj_out = nn.Conv2d(channels, channels, 1, **kw)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).flatten(2).transpose(1, 2)           # [B, HW, C]
        k = self.k(h).flatten(2)                           # [B, C, HW]
        v = self.v(h).flatten(2).transpose(1, 2)           # [B, HW, C]
        w = torch.softmax(torch.bmm(q, k) * (C ** -0.5), dim=2)
        out = torch.bmm(w, v).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """A 3x3 stride-2 conv after padding one row and one column at the
    bottom and right only (the reference's asymmetric pad)."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, **kw)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then a 3x3 conv."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, **kw)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, **kw)
        self.attn_1 = AttnBlock(channels, **kw)
        self.block_2 = ResnetBlock(channels, channels, **kw)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _UpLevel(nn.Module):
    def __init__(self, block_in: int, block_out: int, num_blocks: int,
                 upsample: bool, **kw):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(block_in if j == 0 else block_out, block_out, **kw)
            for j in range(num_blocks))
        if upsample:
            self.upsample = Upsample(block_out, **kw)


class _DownLevel(nn.Module):
    def __init__(self, block_in: int, block_out: int, num_blocks: int,
                 downsample: bool, **kw):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(block_in if j == 0 else block_out, block_out, **kw)
            for j in range(num_blocks))
        if downsample:
            self.downsample = Downsample(block_out, **kw)


class VQGANEncoder(nn.Module):
    """conv_in, the ch_mult levels (res blocks, then a downsample but on
    the last), mid (res + attn + res), GroupNorm / swish, conv_out to
    z_channels, quant_conv 1x1."""

    def __init__(self, cfg: VQConfig = VQConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(cfg.enc_ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_ch, cfg.ch, 3, padding=1, **kw)
        levels, block_in = [], cfg.ch
        for i in range(n):
            block_out = cfg.ch * cfg.enc_ch_mult[i]
            levels.append(_DownLevel(block_in, block_out,
                                     cfg.enc_num_res_blocks[i], i != n - 1,
                                     **kw))
            block_in = block_out
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, **kw)
        self.norm_out = group_norm(block_in, **kw)
        self.conv_out = nn.Conv2d(block_in, cfg.z_channels, 3, padding=1,
                                  **kw)
        self.quant_conv = nn.Conv2d(cfg.z_channels, cfg.z_channels, 1, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.conv_out(swish(self.norm_out(self.mid(h))))
        return self.quant_conv(h)


class VQGANDecoder(nn.Module):
    """post_quant_conv 1x1, conv_in, mid (res + attn + res), the ch_mult
    levels walked from the deepest up, GroupNorm / swish, conv_out."""

    def __init__(self, cfg: VQConfig = VQConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(cfg.dec_ch_mult)
        block_in = cfg.ch * cfg.dec_ch_mult[-1]
        self.post_quant_conv = nn.Conv2d(cfg.z_channels, cfg.z_channels, 1,
                                         **kw)
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1, **kw)
        self.mid = _Mid(block_in, **kw)
        levels = [None] * n
        for i in reversed(range(n)):
            block_out = cfg.ch * cfg.dec_ch_mult[i]
            levels[i] = _UpLevel(block_in, block_out,
                                 cfg.dec_num_res_blocks[i], i != 0, **kw)
            block_in = block_out
        self.up = nn.ModuleList(levels)      # up[i] is level i
        self.norm_out = group_norm(block_in, **kw)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1, **kw)

    def forward(self, z):
        h = self.mid(self.conv_in(self.post_quant_conv(z)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


def lfq_quantize(z: torch.Tensor) -> torch.Tensor:
    """sign(z) in {-1, +1} (0 -> -1) with a straight-through estimator."""
    q = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
    return z + (q - z).detach()


def lfq_indices(z_q: torch.Tensor, codebook_dim: int = 13) -> torch.Tensor:
    """[..., codebook_dim] signs -> integer codes; channel c carries
    2^(codebook_dim - 1 - c)."""
    power = 2 ** torch.arange(codebook_dim - 1, -1, -1, device=z_q.device)
    return ((z_q > 0).long() * power).sum(dim=-1)


def lfq_codebook_entry(indices: torch.Tensor,
                       codebook_dim: int = 13) -> torch.Tensor:
    """Integer codes -> sign vectors in {-1, +1}, [..., codebook_dim]
    (bit k, MSB first, is channel k)."""
    shifts = torch.arange(codebook_dim - 1, -1, -1, device=indices.device)
    bits = (indices[..., None] >> shifts) & 1
    return bits.float() * 2.0 - 1.0


def lfq_losses(z: torch.Tensor, beta: float = 0.25) -> dict:
    """LFQ's entropy and commitment losses (modeling_magvitv2.py:246-263)
    of pre-quantisation activations z [N, d]: each bit a categorical over
    {+1, -1} with logits -(z - 1)^2 / -(z + 1)^2; the entropy loss is the
    mean per-bit entropy less the entropy of each bit's batch marginal,
    the commitment loss ``mean((sg(z_q) - z)^2) + beta * mean((z_q -
    sg(z))^2)``."""
    z_q = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
    logits = torch.stack([-torch.square(z - 1.0), -torch.square(z + 1.0)],
                         dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    entropy = -torch.sum(p * logp, dim=-1).mean()
    mean_p = p.mean(dim=0)
    mean_entropy = (-torch.sum(mean_p * torch.log(mean_p.clamp(min=1e-20)),
                               dim=-1)).mean()
    commit = (torch.mean(torch.square(z_q.detach() - z))
              + beta * torch.mean(torch.square(z_q - z.detach())))
    return {"entropy_loss": entropy - mean_entropy, "commit_loss": commit}


class MagvitV2(nn.Module):
    """``encode`` / ``get_code`` / ``decode_code`` of the reference facade.
    Pixels are NHWC in [-1, 1]; codes are [B, h*w] ints (h, w = H/16,
    W/16 at the default depth); images come out NHWC."""

    def __init__(self, cfg: VQConfig = VQConfig(), device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = VQGANDecoder(cfg, device, dtype)
        # registered after the decoder, so a seeded init_magvit draws the
        # decoder's weights first, as before the encoder was ported
        self.encoder = VQGANEncoder(cfg, device, dtype)

    def encode(self, pixels: torch.Tensor):
        """(z_q NHWC in {-1, +1}, codes [B, h*w])."""
        p = next(self.parameters())
        z = self.encoder(pixels.permute(0, 3, 1, 2).to(p.dtype))
        z_q = lfq_quantize(z.permute(0, 2, 3, 1))
        codes = lfq_indices(z_q, self.cfg.z_channels)
        return z_q, codes.reshape(pixels.shape[0], -1)

    @torch.no_grad()
    def get_code(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.encode(pixels)[1]

    @torch.no_grad()
    def decode_code(self, codes: torch.Tensor, hw=None) -> torch.Tensor:
        b, n = codes.shape
        if hw is None:
            side = int(round(n ** 0.5))
            hw = (side, side)
        p = next(self.parameters())
        z = lfq_codebook_entry(codes, self.cfg.z_channels).reshape(
            b, hw[0], hw[1], self.cfg.z_channels)
        z = z.permute(0, 3, 1, 2).to(p.dtype)
        return self.decoder(z).permute(0, 2, 3, 1)


def init_magvit(cfg: VQConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> MagvitV2:
    """Random-weight codec: conv weights N(0, 1/fan_in) (the scale of
    flax's default lecun-normal init), zero biases, unit norm scales."""
    model = MagvitV2(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if prm.dim() == 4:
                fan_in = prm.shape[1] * prm.shape[2] * prm.shape[3]
                prm.copy_(torch.randn(prm.shape, generator=generator,
                                      device=generator.device)
                          * fan_in ** -0.5)
            elif "norm" in name and name.endswith("weight"):
                prm.fill_(1.0)
            else:
                prm.zero_()
    return model.eval().requires_grad_(False)
