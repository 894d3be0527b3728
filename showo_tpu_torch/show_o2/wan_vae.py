"""Wan2.1 3D causal VAE as PyTorch modules (full-clip form).

Counterpart of ``showo_tpu/show_o2/wan_vae.py``'s full-clip encoder and
decoder (show-o2/models/wan21_vae.py).  The reference streams the clip
through the encoder in chunks of 1 + 4k frames and through the decoder one
latent frame at a time, threading a cache of the last two frames through
every causal convolution; over a whole clip that reduces exactly to:

  * a stride-1 CausalConv3d: a convolution with 2*(kT//2) zero frames
    padded in front in time and symmetric spatial padding;
  * the downsample3d time path: frame 0 passes through, and a (3, 1, 1)
    convolution of stride 2 in time, unpadded, runs over every frame
    (its first window is frames 0, 1, 2);
  * the upsample3d time path: frame 0 passes through, frames 1..T-1 feed
    a causal (3, 1, 1) convolution to 2C channels, interleaved into two
    output frames each.

RMS_norm is the channel L2 norm times sqrt(C) and gamma; attention is
per-frame single-head spatial attention with fp32 scores.  Convolutions
are PyTorch's (the JAX package runs them outside any Pallas kernel).  The
layout is the reference's [B, C, T, H, W] throughout, and the module tree
carries the reference checkpoint's names (``encoder.conv1``,
``encoder.downsamples.{i}``, ``encoder.middle.{0,1,2}``,
``encoder.head.{0,2}``, ``conv1``, ``conv2``, ``decoder.conv1``,
``decoder.middle.{0,1,2}``, ``decoder.upsamples.{i}``,
``decoder.head.{0,2}``), so a Wan2.1_VAE.pth state dict, or the one
``showo_tpu_torch.utils.convert.wan_vae_state_dict`` makes from JAX
params, loads with ``load_state_dict``.

The streaming mode (JAX ``wan_encode_streaming`` / ``wan_decode_streaming``,
the reference's ``feat_cache`` path, wan21_vae.py:101-160, 516-568) runs
the same modules chunk by chunk in a Python loop, with a per-convolution
cache of the last ``CACHE_T = 2`` frames (a dict keyed by the module) in
place of the zero time padding: the encoder takes 1 pixel frame, then
``temporal_factor`` frames a chunk; the decoder 1 latent frame a chunk,
giving 1 pixel frame first (the time upsample passes its first chunk
through and starts its cache at zeros) and ``temporal_factor`` after.  A
time downsample passes its first chunk through and keeps its last frame.
Activation memory is constant in the clip's length.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))


# latent normalization constants (wan21_vae.py:632-642)
WAN_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)
# frames a streaming convolution keeps of the chunks before (wan21_vae.py)
CACHE_T = 2
# a streaming pass's cache: module -> its last frames
Cache = Dict[nn.Module, torch.Tensor]


def encoder_structure(cfg: WanVAEConfig) -> List[Tuple[str, dict]]:
    """The encoder's ``downsamples`` plan: residual blocks (in -> out) and
    down-resamples (2d, or 3d with the time path) of their width."""
    plan = []
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
        d = in_dim
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", {"in": d, "out": out_dim}))
            d = out_dim
        if i != len(cfg.dim_mult) - 1:
            mode = ("downsample3d" if cfg.temperal_downsample[i]
                    else "downsample2d")
            plan.append((mode, {"dim": out_dim}))
    return plan


def decoder_structure(cfg: WanVAEConfig) -> List[Tuple[str, dict]]:
    """The decoder's ``upsamples`` plan: residual blocks (in -> out) and
    up-resamples (2d, or 3d with the time path) of their width."""
    plan = []
    dims = [cfg.dim * u
            for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
        d = in_dim // 2 if i in (1, 2, 3) else in_dim
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", {"in": d, "out": out_dim}))
            d = out_dim
        if i != len(cfg.dim_mult) - 1:
            mode = ("upsample3d" if cfg.temperal_upsample[i]
                    else "upsample2d")
            plan.append((mode, {"dim": out_dim}))
    return plan


class CausalConv3d(nn.Conv3d):
    """A 3D convolution padded 2*(kT//2) frames in front in time (zeros)
    and kH//2, kW//2 on both sides in space.  On one frame (an image) only
    the last time tap meets data, so it runs as that tap's 2D convolution
    (the same sum without the zero frames' products: a third of the work
    and of the padded copy).  With a streaming ``cache`` the module's
    entry (the chunks' last ``CACHE_T`` frames, zeros before the first)
    takes the zero frames' place, and the entry moves on."""

    def __init__(self, in_ch: int, out_ch: int, kernel, device=None,
                 dtype=None):
        super().__init__(in_ch, out_ch, kernel, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        kT, kH, kW = self.kernel_size
        x = x.to(self.weight.dtype)
        if cache is not None and kT > 1:
            prev = cache.get(self)
            if prev is None:
                prev = x.new_zeros(x.shape[:2] + (CACHE_T,) + x.shape[3:])
            x = torch.cat([prev.to(x.dtype), x], dim=2)
            cache[self] = x[:, :, -CACHE_T:].clone()
            return F.conv3d(F.pad(x, (kW // 2, kW // 2, kH // 2, kH // 2)),
                            self.weight, self.bias)
        if x.shape[2] == 1:
            return F.conv2d(x[:, :, 0], self.weight[:, :, -1], self.bias,
                            padding=(kH // 2, kW // 2))[:, :, None]
        x = F.pad(x, (kW // 2, kW // 2, kH // 2, kH // 2, 2 * (kT // 2), 0))
        return super().forward(x)


class RMSNormChannel(nn.Module):
    """Reference RMS_norm over the channel dim 1: L2-normalise, times
    sqrt(C) and ``gamma`` ([C, 1, 1, 1], or [C, 1, 1] for images)."""

    def __init__(self, dim: int, images: bool, device=None, dtype=None):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.normalize(x, dim=1, eps=1e-12) * math.sqrt(x.shape[1])
                * self.gamma)


class ResidualBlock(nn.Module):
    """RMS, SiLU, conv, RMS, SiLU, (dropout), conv, plus the shortcut
    (wan21_vae.py:186-220); ``residual`` indices as the reference's."""

    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.residual = nn.Sequential(
            RMSNormChannel(in_dim, False, **kw), nn.SiLU(),
            CausalConv3d(in_dim, out_dim, 3, **kw),
            RMSNormChannel(out_dim, False, **kw), nn.SiLU(), nn.Identity(),
            CausalConv3d(out_dim, out_dim, 3, **kw))
        self.shortcut = (CausalConv3d(in_dim, out_dim, 1, **kw)
                         if in_dim != out_dim else nn.Identity())

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        return self.shortcut(x) + _forward(self.residual, x, cache)


def _frames(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B*T, C, H, W]."""
    B, C, T, H, W = x.shape
    return x.transpose(1, 2).reshape(B * T, C, H, W)


def _clip(x: torch.Tensor, B: int) -> torch.Tensor:
    """[B*T, C, H, W] -> [B, C, T, H, W]."""
    BT, C, H, W = x.shape
    return x.reshape(B, BT // B, C, H, W).transpose(1, 2)


class AttentionBlock(nn.Module):
    """Per-frame single-head spatial attention with a zero-init output
    projection (wan21_vae.py:223-262)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = RMSNormChannel(dim, True, **kw)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1, **kw)
        self.proj = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        qkv = self.to_qkv(self.norm(_frames(x)))          # [BT, 3C, H, W]
        q, k, v = qkv.flatten(2).transpose(1, 2).chunk(3, dim=-1)
        scores = torch.matmul(q.float(), k.float().transpose(1, 2)) \
            / math.sqrt(C)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B * T, C, H, W)
        return x + _clip(self.proj(out), B)


def _interleave(conv: torch.Tensor) -> torch.Tensor:
    """The time upsample's [B, 2C, T, H, W] -> [B, C, 2T, H, W]: the two
    channel halves become two frames each (the reference's reshape to
    (b, 2, c, t, h, w) and stack on time)."""
    B, C2, T = conv.shape[:3]
    conv = conv.reshape(B, 2, C2 // 2, T, *conv.shape[3:])
    return conv.permute(0, 2, 3, 1, 4, 5).reshape(B, C2 // 2, 2 * T,
                                                  *conv.shape[4:])


class Resample(nn.Module):
    """An up-resample of the decoder: nearest 2x and a 3x3 convolution that
    halves the channels, per frame (``resample.1``); with ``time`` the
    upsample3d time path first (``time_conv``).  Streaming, the time path
    passes the first chunk through and starts ``time_conv``'s cache at
    zeros (the reference's 'Rep' bootstrap); each later chunk's frames
    become two each."""

    def __init__(self, dim: int, time: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resample = nn.Sequential(
            nn.Upsample(scale_factor=2.0, mode="nearest-exact"),
            nn.Conv2d(dim, dim // 2, 3, padding=1, **kw))
        if time:
            self.time_conv = CausalConv3d(dim, 2 * dim, (3, 1, 1), **kw)

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        if hasattr(self, "time_conv"):
            x = self._time(x, cache)
        return _clip(self.resample(_frames(x)), x.shape[0])

    def _time(self, x: torch.Tensor, cache: Optional[Cache]) -> torch.Tensor:
        if cache is None:
            if x.shape[2] == 1:
                return x
            # frame 0 passes through; frames 1.. give two frames each
            return torch.cat([x[:, :, :1], _interleave(
                self.time_conv(x[:, :, 1:]))], dim=2)
        if self.time_conv in cache:
            return _interleave(self.time_conv(x, cache))
        cache[self.time_conv] = x.new_zeros(x.shape[:2] + (CACHE_T,)
                                            + x.shape[3:])
        return x


class DownResample(nn.Module):
    """A down-resample of the encoder: zero padding of one row and column
    at the bottom and right, then a 3x3 convolution of stride 2, per frame
    (``resample.1``); with ``time`` the downsample3d time path after it
    (``time_conv``: frame 0 passes through, then a (3, 1, 1) convolution
    of stride 2 over every frame).  Streaming, the time path passes the
    first chunk through; each later chunk goes through the convolution
    behind the last frame of the chunk before."""

    def __init__(self, dim: int, time: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                      nn.Conv2d(dim, dim, 3, stride=2, **kw))
        if time:
            self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1),
                                       **kw)

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        x = _clip(self.resample(_frames(x)), x.shape[0])
        if not hasattr(self, "time_conv"):
            return x
        if cache is not None:
            prev = cache.get(self)
            cache[self] = x[:, :, -1:].clone()
            if prev is None:
                return x
            return self.time_conv(torch.cat([prev, x], dim=2))
        if x.shape[2] > 1:
            x = torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)
        return x


class WanEncoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim * cfg.dim_mult[-1]
        self.conv1 = CausalConv3d(3, cfg.dim, 3, **kw)
        self.downsamples = nn.ModuleList(
            ResidualBlock(m["in"], m["out"], **kw) if kind == "res"
            else DownResample(m["dim"], kind == "downsample3d", **kw)
            for kind, m in encoder_structure(cfg))
        self.middle = nn.ModuleList([ResidualBlock(d, d, **kw),
                                     AttentionBlock(d, **kw),
                                     ResidualBlock(d, d, **kw)])
        self.head = nn.Sequential(RMSNormChannel(d, False, **kw), nn.SiLU(),
                                  CausalConv3d(d, 2 * cfg.z_dim, 3, **kw))

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.conv1(x, cache)
        h = _forward(self.downsamples, h, cache)
        h = _forward(self.middle, h, cache)
        return _forward(self.head, h, cache)


class WanDecoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim * cfg.dim_mult[-1]
        self.conv1 = CausalConv3d(cfg.z_dim, d, 3, **kw)
        self.middle = nn.ModuleList([ResidualBlock(d, d, **kw),
                                     AttentionBlock(d, **kw),
                                     ResidualBlock(d, d, **kw)])
        self.upsamples = nn.ModuleList(
            ResidualBlock(m["in"], m["out"], **kw) if kind == "res"
            else Resample(m["dim"], kind == "upsample3d", **kw)
            for kind, m in decoder_structure(cfg))
        self.head = nn.Sequential(RMSNormChannel(cfg.dim, False, **kw),
                                  nn.SiLU(), CausalConv3d(cfg.dim, 3, 3, **kw))

    def forward(self, z: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.conv1(z, cache)
        h = _forward(self.middle, h, cache)
        h = _forward(self.upsamples, h, cache)
        return _forward(self.head, h, cache)


_STREAMED = (CausalConv3d, ResidualBlock, Resample, DownResample)


def _forward(layers, h: torch.Tensor, cache: Optional[Cache]):
    """``layers`` in turn, handing ``cache`` to those that take it."""
    for layer in layers:
        h = layer(h, cache) if isinstance(layer, _STREAMED) else layer(h)
    return h


class WanVAE(nn.Module):
    """The reference WanVAE: ``encoder`` and ``conv1`` (1x1x1, to mean and
    log-variance), ``conv2`` (1x1x1) and ``decoder``.  The decoding half is
    registered first, so its random init draws what it drew before the
    encoder was ported."""

    def __init__(self, cfg: WanVAEConfig = WanVAEConfig(), device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.conv2 = CausalConv3d(cfg.z_dim, cfg.z_dim, 1, **kw)
        self.decoder = WanDecoder(cfg, **kw)
        self.encoder = WanEncoder(cfg, **kw)
        self.conv1 = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1, **kw)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "WanVAE":
        """Random init as JAX ``init_wan_vae_params``: convolution kernels
        uniform in +-1/sqrt(fan_in), zero biases, unit gammas, and the
        attention output projections zero."""
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            elif name.endswith("bias") or name.endswith("proj.weight"):
                p.zero_()
            else:
                s = 1.0 / math.sqrt(p[0].numel())
                p.copy_((torch.rand(p.shape, generator=generator,
                                    device=generator.device) * 2 - 1) * s)
        return self


def wan_encode_raw(vae: WanVAE, x: torch.Tensor):
    """pixels [B, 3, T, H, W] -> (mu, log_var), each
    [B, z_dim, 1 + (T-1)/4, H/8, W/8] at the released config."""
    h = vae.conv1(vae.encoder(x))
    return h.chunk(2, dim=1)


def _latent_stats(like: torch.Tensor):
    shape = (1, -1, 1, 1, 1)
    kw = dict(dtype=like.dtype, device=like.device)
    return (torch.tensor(WAN_LATENT_MEAN, **kw).view(shape),
            torch.tensor(WAN_LATENT_STD, **kw).view(shape))


def temporal_factor(cfg: WanVAEConfig) -> int:
    """Pixel frames a latent frame: 2 to the number of time downsamples
    (4 at the released config)."""
    return 2 ** sum(bool(d) for d in cfg.temperal_downsample)


def wan_encode_raw_streaming(vae: WanVAE, x: torch.Tensor):
    """``wan_encode_raw`` chunk by chunk (JAX ``wan_encode_raw_streaming``):
    pixels [B, 3, T, H, W] with T = 1 + f*k (f = ``temporal_factor``) go
    through the encoder as one frame, then k chunks of f frames, each
    giving one latent frame; the same (mu, log_var)."""
    f = temporal_factor(vae.cfg)
    T = x.shape[2]
    if (T - 1) % f:
        raise ValueError(f"streaming encode needs T = 1 + {f}k, got {T}")
    cache: Cache = {}
    chunks = [x[:, :, :1]] + list(x[:, :, 1:].split(f, dim=2) if T > 1
                                  else ())
    h = torch.cat([vae.encoder(c, cache) for c in chunks], dim=2)
    return vae.conv1(h).chunk(2, dim=1)


def _sample(mu: torch.Tensor, log_var: torch.Tensor,
            generator: Optional[torch.Generator], eps,
            deterministic: bool) -> torch.Tensor:
    mean, std = _latent_stats(mu)
    mu = (mu - mean) / std
    if deterministic:
        return mu
    std = torch.exp(0.5 * log_var.clamp(-30.0, 20.0))
    if eps is None:
        eps = torch.randn(std.shape, generator=generator, dtype=std.dtype,
                          device=std.device)
    return mu + std * torch.as_tensor(eps, dtype=std.dtype,
                                      device=std.device)


def wan_encode(vae: WanVAE, videos: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None,
               deterministic: bool = False) -> torch.Tensor:
    """Reference ``WanVAE.sample``: pixels [B, 3, T, H, W] in [-1, 1] ->
    scale-normalised latents [B, z_dim, T', h, w], ``mu`` alone with
    ``deterministic``, else ``mu + std * eps`` with ``std = exp(0.5 *
    clip(log_var, -30, 20))`` and ``eps`` the given normal draw (of the
    latents' shape) or one from ``generator``."""
    return _sample(*wan_encode_raw(vae, videos), generator, eps,
                   deterministic)


def wan_encode_streaming(vae: WanVAE, videos: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None,
                         deterministic: bool = False) -> torch.Tensor:
    """:func:`wan_encode` through the streaming encoder (constant
    activation memory in T)."""
    return _sample(*wan_encode_raw_streaming(vae, videos), generator, eps,
                   deterministic)


def wan_decode_raw(vae: WanVAE, z: torch.Tensor) -> torch.Tensor:
    """z [B, z_dim, T, h, w] -> pixels [B, 3, 4(T-1)+1, 8h, 8w]."""
    return vae.decoder(vae.conv2(z))


def wan_decode_raw_streaming(vae: WanVAE, z: torch.Tensor) -> torch.Tensor:
    """``wan_decode_raw`` one latent frame at a time (JAX
    ``wan_decode_raw_streaming``): the first gives 1 pixel frame, each
    later one ``temporal_factor``."""
    h = vae.conv2(z)
    cache: Cache = {}
    return torch.cat([vae.decoder(h[:, :, i:i + 1], cache)
                      for i in range(h.shape[2])], dim=2)


def wan_decode(vae: WanVAE, z: torch.Tensor) -> torch.Tensor:
    """Reference ``WanVAE.batch_decode``: scale-normalised latents
    [B, z_dim, T, h, w] -> pixels in [-1, 1]."""
    mean, std = _latent_stats(z)
    return wan_decode_raw(vae, z * std + mean).clamp(-1.0, 1.0)


def wan_decode_streaming(vae: WanVAE, z: torch.Tensor) -> torch.Tensor:
    """:func:`wan_decode` through the streaming decoder."""
    mean, std = _latent_stats(z)
    return wan_decode_raw_streaming(vae, z * std + mean).clamp(-1.0, 1.0)
