"""Plain PyTorch reference of Show-o2 1.5B text-to-image: the generation
layout and omni mask, one velocity evaluation with CFG (the dual-path
image embedding through SigLIP, Qwen2.5, the adaLN DiT head), the Euler
time grid, and the Wan2.1 VAE decoder on one frame.

It follows the published Show-o2 (showlab/Show-o2, modeling_showo2_qwen2_5
.py and modules.py; Wan2.1's VAE) and imports nothing of the program:
weights come in as a dict keyed by the checkpoint's names, made by
``benchmark/weights.py`` from the run's seed.  Attention is dense under
the additive mask, nothing is cached or fused, and every sum is in fp32.
``Precision`` as in ``showo_v1``: the control rounds every linear's
operands through fp8 e4m3 and runs the decoder in bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.showo_v1 import (CONTROL, FP32, NEG,  # noqa: F401
                                          Precision, linear, word_id)

# the stand-in tokenizer's special ids
IDS = dict(bos=1, eos=2, boi=3, eoi=4, pad=5, img_pad=6)


def lin(x, W, name, prec: Precision, bias=True):
    return linear(x, W[name + ".weight"], W[name + ".bias"] if bias else None,
                  prec)


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int = 151940
    d_llm: int = 1536
    ffn_llm: int = 8960
    layers_llm: int = 28
    heads_llm: int = 12
    kv_llm: int = 2
    hd_llm: int = 128
    d_clip: int = 1152
    ffn_clip: int = 4304
    heads_clip: int = 16
    layers_clip: int = 26
    positions: int = 729
    d_dit: int = 2048
    ffn_dit: int = 8192
    heads_dit: int = 32
    kv_dit: int = 8
    hd_dit: int = 64
    layers_dit: int = 10
    latent: int = 16
    grid_h: int = 54
    grid_w: int = 54
    patch: int = 2
    # the Wan2.1 VAE
    vae_dim: int = 96
    vae_mult: tuple = (1, 2, 4, 4)
    vae_res: int = 2
    vae_tdown: tuple = (False, True, True)

    @property
    def n_image(self) -> int:
        return (self.grid_h // self.patch) * (self.grid_w // self.patch) + 1


# ---------------------------------------------------------------- specs

def _w(name, *shape):
    return [(name + ".weight", tuple(shape))]


def _wb(name, dout, din):
    return [(name + ".weight", (dout, din)), (name + ".bias", (dout,))]


def model_specs(d: Dims) -> List[tuple]:
    out = _w("showo.model.embed_tokens", d.vocab, d.d_llm)
    for i in range(d.layers_llm):
        p = f"showo.model.layers.{i}."
        out += (_w(p + "input_layernorm", d.d_llm)
                + _w(p + "post_attention_layernorm", d.d_llm)
                + _wb(p + "self_attn.q_proj", d.heads_llm * d.hd_llm, d.d_llm)
                + _wb(p + "self_attn.k_proj", d.kv_llm * d.hd_llm, d.d_llm)
                + _wb(p + "self_attn.v_proj", d.kv_llm * d.hd_llm, d.d_llm)
                + _w(p + "self_attn.o_proj", d.d_llm, d.heads_llm * d.hd_llm)
                + _w(p + "mlp.gate_proj", d.ffn_llm, d.d_llm)
                + _w(p + "mlp.up_proj", d.ffn_llm, d.d_llm)
                + _w(p + "mlp.down_proj", d.d_llm, d.ffn_llm))
    out += _w("showo.model.norm", d.d_llm)
    p = d.patch
    for name, dout in (("image_embedder_und", d.d_clip),
                       ("image_embedder_gen", d.d_llm)):
        out += [(name + ".proj.weight", (dout, d.latent, p, p)),
                (name + ".proj.bias", (dout,))]
    out += _w("position_embedding", d.positions, d.d_clip)
    for i in range(d.layers_clip):
        q = f"und_trans.layers.{i}."
        out += [(q + "layer_norm1.weight", (d.d_clip,)),
                (q + "layer_norm1.bias", (d.d_clip,)),
                (q + "layer_norm2.weight", (d.d_clip,)),
                (q + "layer_norm2.bias", (d.d_clip,))]
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _wb(q + "self_attn." + n, d.d_clip, d.d_clip)
        out += (_wb(q + "mlp.fc1", d.ffn_clip, d.d_clip)
                + _wb(q + "mlp.fc2", d.d_clip, d.ffn_clip))
    cat = d.d_clip + d.d_llm
    out += [("fusion_proj.0.weight", (cat,), (0.1, 1.0))]
    out += _wb("fusion_proj.1", d.d_llm, cat) + _wb("fusion_proj.3", d.d_llm,
                                                     d.d_llm)
    out += _wb("time_embed.mlp.0", d.d_dit, 256) + _wb("time_embed.mlp.2",
                                                        d.d_dit, d.d_dit)
    for i in range(d.layers_dit):
        q = f"diffusion_head_a.{i}."
        out += (_w(q + "input_layernorm", d.d_dit)
                + _w(q + "post_attention_layernorm", d.d_dit)
                + _w(q + "self_attn.q_proj", d.heads_dit * d.hd_dit, d.d_dit)
                + _w(q + "self_attn.k_proj", d.kv_dit * d.hd_dit, d.d_dit)
                + _w(q + "self_attn.v_proj", d.kv_dit * d.hd_dit, d.d_dit)
                + _w(q + "self_attn.o_proj", d.d_dit, d.heads_dit * d.hd_dit)
                + _w(q + "self_attn.q_norm", d.hd_dit)
                + _w(q + "self_attn.k_norm", d.hd_dit)
                + _w(q + "mlp.gate_proj", d.ffn_dit, d.d_dit)
                + _w(q + "mlp.up_proj", d.ffn_dit, d.d_dit)
                + _w(q + "mlp.down_proj", d.d_dit, d.ffn_dit)
                + _wb(q + "adaLN_modulation.1", 6 * d.d_dit, d.d_dit))
    out += (_w("diffusion_head_b.norm_final", d.d_dit)
            + _wb("diffusion_head_b.linear", p * p * d.latent, d.d_dit)
            + _wb("diffusion_head_b.adaLN_modulation.1", 2 * d.d_dit,
                  d.d_dit))
    if d.d_llm != d.d_dit:
        out += (_wb("diff_proj.0", d.d_dit, d.d_llm)
                + _wb("diff_proj.2", d.d_dit, d.d_dit)
                + _wb("time_embed_proj", d.d_llm, d.d_dit))
    return out


def _decoder_plan(d: Dims):
    dims = [d.vae_dim * u for u in (d.vae_mult[-1],)
            + tuple(reversed(d.vae_mult))]
    tup = tuple(reversed(d.vae_tdown))
    plan = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        c = a // 2 if i in (1, 2, 3) else a
        for _ in range(d.vae_res + 1):
            plan.append(("res", c, b))
            c = b
        if i != len(d.vae_mult) - 1:
            plan.append(("up3d" if tup[i] else "up2d", b, b))
    return plan


def _conv3(name, cin, cout, k):
    kk = (k, k, k) if isinstance(k, int) else k
    return [(name + ".weight", (cout, cin) + kk), (name + ".bias", (cout,))]


def _res3(name, cin, cout):
    out = ([(name + ".residual.0.gamma", (cin, 1, 1, 1))]
           + _conv3(name + ".residual.2", cin, cout, 3)
           + [(name + ".residual.3.gamma", (cout, 1, 1, 1))]
           + _conv3(name + ".residual.6", cout, cout, 3))
    if cin != cout:
        out += _conv3(name + ".shortcut", cin, cout, 1)
    return out


def vae_specs(d: Dims, prefix: str = "vae.") -> List[tuple]:
    """The decoding half of the Wan2.1 VAE (``conv2`` and ``decoder``)."""
    z, top = d.latent, d.vae_dim * d.vae_mult[-1]
    p = prefix + "decoder."
    out = (_conv3(prefix + "conv2", z, z, 1) + _conv3(p + "conv1", z, top, 3)
           + _res3(p + "middle.0", top, top)
           + [(p + "middle.1.norm.gamma", (top, 1, 1))]
           + [(p + "middle.1.to_qkv.weight", (3 * top, top, 1, 1)),
              (p + "middle.1.to_qkv.bias", (3 * top,)),
              (p + "middle.1.proj.weight", (top, top, 1, 1)),
              (p + "middle.1.proj.bias", (top,))]
           + _res3(p + "middle.2", top, top))
    for i, (kind, a, b) in enumerate(_decoder_plan(d)):
        q = f"{p}upsamples.{i}"
        if kind == "res":
            out += _res3(q, a, b)
        else:
            out += [(q + ".resample.1.weight", (a // 2, a, 3, 3)),
                    (q + ".resample.1.bias", (a // 2,))]
            if kind == "up3d":
                out += _conv3(q + ".time_conv", a, 2 * a, (3, 1, 1))
    return out + [(p + "head.0.gamma", (d.vae_dim, 1, 1, 1))] + _conv3(
        p + "head.2", d.vae_dim, 3, 3)


# ---------------------------------------------------------------- layout

def gen_layout(prompts: Sequence[str], n_image: int, max_text_len: int,
               guidance: bool):
    """(text [B', L], offsets [B']) of the [cond; null] rows, cut at the
    span's end rounded up to 128."""
    rows, offs = [], []
    for p in prompts:
        ids = [word_id(w) for w in p.split()][:max_text_len]
        rows.append([IDS["bos"]] + ids + [IDS["boi"]]
                    + [IDS["img_pad"]] * n_image + [IDS["eoi"], IDS["eos"]]
                    + [IDS["pad"]] * (max_text_len - len(ids)))
        offs.append(len(ids) + 2)
    if guidance:
        for _ in prompts:
            rows.append([IDS["bos"], IDS["boi"]] + [IDS["img_pad"]] * n_image
                        + [IDS["eoi"], IDS["eos"]]
                        + [IDS["pad"]] * max_text_len)
            offs.append(2)
    end = max(o + n_image for o in offs)
    L = min(len(rows[0]), (end + 127) // 128 * 128)
    return torch.tensor([r[:L] for r in rows]), torch.tensor(offs)


def gen_mask(offsets: torch.Tensor, n: int, L: int) -> torch.Tensor:
    """Bool [B', L, L]: causal, and the image span bidirectional."""
    i = torch.arange(L)[None, :, None]
    j = torch.arange(L)[None, None, :]
    o = offsets[:, None, None]
    span = (i >= o) & (i < o + n) & (j >= o) & (j < o + n)
    return (j <= i) | span


def time_grid(steps: int, shift: float) -> np.ndarray:
    t = np.linspace(0.0, 1.0, steps, dtype=np.float32)
    f = np.float32(shift)
    return t / (t + f - f * t)


# ---------------------------------------------------------------- model

def _rope(x, pos, inv):
    f = pos[:, None].float() * inv
    e = torch.cat([f, f], -1)
    cos, sin = e.cos()[None, :, None], e.sin()[None, :, None]
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _inv_freq(hd, theta, device):
    return 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=device) / hd)


def _llama3_inv(hd, device, theta=5e5, factor=32.0, low=1.0, high=4.0,
                orig=8192):
    inv = _inv_freq(hd, theta, device)
    wav = 2 * math.pi / inv
    smooth = (orig / wav - low) / (high - low)
    mid = (1 - smooth) * inv / factor + smooth * inv
    return torch.where(wav > orig / low, inv / factor,
                       torch.where((wav < orig / low) & (wav > orig / high),
                                   mid, inv))


def _attend(q, k, v, bias):
    """q [B, S, H, Dh], k / v [B, S, Hkv, Dh]; GQA by repetition."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).flatten(2)


def _swiglu(x, W, p, prec):
    return lin(F.silu(lin(x, W, p + "gate_proj", prec, False))
               * lin(x, W, p + "up_proj", prec, False), W, p + "down_proj",
               prec, False)


def siglip(x, W, d: Dims, prec):
    B, S, D = x.shape
    H = d.heads_clip
    for i in range(d.layers_clip):
        p = f"und_trans.layers.{i}."
        a = F.layer_norm(x, (D,), W[p + "layer_norm1.weight"],
                         W[p + "layer_norm1.bias"], 1e-6)
        q, k, v = (lin(a, W, p + "self_attn." + n, prec).view(B, S, H, -1)
                   for n in ("q_proj", "k_proj", "v_proj"))
        x = x + lin(_attend(q, k, v, None), W, p + "self_attn.out_proj",
                    prec)
        m = F.layer_norm(x, (D,), W[p + "layer_norm2.weight"],
                         W[p + "layer_norm2.bias"], 1e-6)
        x = x + lin(F.gelu(lin(m, W, p + "mlp.fc1", prec),
                           approximate="tanh"), W, p + "mlp.fc2", prec)
    return x


def cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] weights of a Keys cubic (a = -0.5) resize with
    half-pixel centres, the kernel widened by the scale when shrinking,
    each output's weights summing to one."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale - 0.5
    x = (centre[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]
         ).abs() / width
    w = torch.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                    torch.where(x < 2.0,
                                ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))
    return (w / w.sum(0, keepdim=True)).float()


def position_table(W, d: Dims, h: int, w: int) -> torch.Tensor:
    """The SigLIP position table [1, h*w, D], resized from its square
    grid where the patch grid differs (bicubic, rows then columns)."""
    pos = W["position_embedding.weight"]
    if pos.shape[0] == h * w:
        return pos[None]
    side = int(round(math.sqrt(pos.shape[0])))
    grid = pos.reshape(side, side, -1)
    grid = torch.einsum("sxd,sh->hxd", grid,
                        cubic_weights(side, h).to(grid.device))
    grid = torch.einsum("hsd,sw->hwd", grid,
                        cubic_weights(side, w).to(grid.device))
    return grid.reshape(1, h * w, -1)


def _patch(x, W, name, p):
    y = F.conv2d(x, W[name + ".proj.weight"], W[name + ".proj.bias"],
                 stride=p)
    return y.flatten(2).transpose(1, 2)


def forward(W, d: Dims, text, offsets, x, t, prec: Precision = FP32,
            logits: bool = False):
    """(sequence velocity [B', L, p*p*C], logits [B', L, V] or None) of
    rows ``text`` [B', L] with one image span a row at ``offsets`` [B']
    (its time token first), latents x [B', C, H, W] and times t [B'].
    The semantic path (the frozen SigLIP tower) runs without gradient."""
    dev = x.device
    Bp, L = text.shape
    n = d.n_image
    mask = gen_mask(offsets.cpu(), n, L).to(dev)
    bias = torch.where(mask, 0.0, NEG)[:, None]
    # dual-path image embedding, fused
    with torch.no_grad():
        und = _patch(x, W, "image_embedder_und", d.patch)
        und = siglip(und + position_table(W, d, d.grid_h // d.patch,
                                          d.grid_w // d.patch), W, d, prec)
    gen = _patch(x, W, "image_embedder_gen", d.patch)
    cat = torch.cat([und, gen], -1)
    img = lin(F.gelu(lin(rms(cat, W["fusion_proj.0.weight"], 1e-6), W,
                         "fusion_proj.1", prec)), W, "fusion_proj.3", prec)
    # the time token
    half = 128
    fr = torch.exp(-math.log(10000.0) * torch.arange(half, device=dev,
                                                     dtype=torch.float32)
                   / half)
    arg = t.to(dev).float()[:, None] * fr[None]
    temb = torch.cat([arg.cos(), arg.sin()], -1)
    temb = lin(F.silu(lin(temb, W, "time_embed.mlp.0", prec)), W,
               "time_embed.mlp.2", prec)
    tproj = (lin(temb, W, "time_embed_proj", prec)
             if "time_embed_proj.weight" in W else temb)
    emb = W["showo.model.embed_tokens.weight"]
    rows = []
    for r in range(Bp):
        o = int(offsets[r])
        rows.append(torch.cat([emb[text[r, :o]], tproj[r:r + 1], img[r],
                               emb[text[r, o + n:]]]))
    h = torch.stack(rows)
    # Qwen2.5
    pos = torch.arange(L, device=dev)
    inv = _inv_freq(d.hd_llm, 1e6, dev)
    for i in range(d.layers_llm):
        p = f"showo.model.layers.{i}."
        a = rms(h, W[p + "input_layernorm.weight"], 1e-6)
        q = lin(a, W, p + "self_attn.q_proj", prec).view(Bp, L, -1, d.hd_llm)
        k = lin(a, W, p + "self_attn.k_proj", prec).view(Bp, L, -1, d.hd_llm)
        v = lin(a, W, p + "self_attn.v_proj", prec).view(Bp, L, -1, d.hd_llm)
        att = _attend(_rope(q, pos, inv), _rope(k, pos, inv), v, bias)
        h = h + lin(att, W, p + "self_attn.o_proj", prec, False)
        h = h + _swiglu(rms(h, W[p + "post_attention_layernorm.weight"],
                            1e-6), W, p + "mlp.", prec)
    h = rms(h, W["showo.model.norm.weight"], 1e-6)
    lg = None
    if logits:
        lg = linear(h, emb, None, prec)
    if "diff_proj.0.weight" in W:
        h = lin(F.gelu(lin(h, W, "diff_proj.0", prec)), W, "diff_proj.2",
                prec)
    # the DiT head, modulated inside the span
    span = ((pos[None] >= offsets.to(dev)[:, None])
            & (pos[None] < offsets.to(dev)[:, None] + n))[..., None]
    inv = _llama3_inv(d.hd_dit, dev)
    st = F.silu(temb)
    for i in range(d.layers_dit):
        p = f"diffusion_head_a.{i}."
        ada = lin(st, W, p + "adaLN_modulation.1", prec)[:, None]
        sh1, sc1, g1, sh2, sc2, g2 = ada.chunk(6, -1)

        def mod(y, sh, sc):
            return torch.where(span, y * (1 + sc) + sh, y)

        def gate(gv, y):
            return torch.where(span, gv * y, y)

        a = mod(rms(h, W[p + "input_layernorm.weight"], 1e-5), sh1, sc1)
        q = lin(a, W, p + "self_attn.q_proj", prec, False).view(
            Bp, L, -1, d.hd_dit)
        k = lin(a, W, p + "self_attn.k_proj", prec, False).view(
            Bp, L, -1, d.hd_dit)
        v = lin(a, W, p + "self_attn.v_proj", prec, False).view(
            Bp, L, -1, d.hd_dit)
        q = _rope(rms(q, W[p + "self_attn.q_norm.weight"], 1e-6), pos, inv)
        k = _rope(rms(k, W[p + "self_attn.k_norm.weight"], 1e-6), pos, inv)
        h = h + gate(g1, lin(_attend(q, k, v, bias), W,
                             p + "self_attn.o_proj", prec, False))
        m = mod(rms(h, W[p + "post_attention_layernorm.weight"], 1e-5), sh2,
                sc2)
        h = h + gate(g2, _swiglu(m, W, p + "mlp.", prec))
    ada = lin(st, W, "diffusion_head_b.adaLN_modulation.1", prec)[:, None]
    sh, sc = ada.chunk(2, -1)
    xn = rms(h, W["diffusion_head_b.norm_final.weight"], 1e-6)
    out = lin(torch.where(span, xn * (1 + sc) + sh, xn), W,
              "diffusion_head_b.linear", prec)
    return out, lg


def patchify(d: Dims, lat: torch.Tensor) -> torch.Tensor:
    """Latents [B, C, H, W] -> [B, (H/p)(W/p), p*p*C] by the published
    model's reshape chain (the row-major H*W sequence regrouped), whose
    inverse is :func:`unpatchify`."""
    b, c, H, W_ = lat.shape
    p = d.patch
    x = lat.reshape(b, c, H * W_).transpose(1, 2)
    return x.reshape(b, H // p, W_ // p, p, p, c).reshape(
        b, (H // p) * (W_ // p), p * p * c)


def unpatchify(d: Dims, v: torch.Tensor) -> torch.Tensor:
    n = v.shape[0]
    hp, wp, p, c = d.grid_h // d.patch, d.grid_w // d.patch, d.patch, \
        d.latent
    x = v.reshape(n, hp, wp, p, p, c).reshape(n, hp * p * wp * p, c)
    return x.transpose(1, 2).reshape(n, c, hp * p, wp * p)


def velocity(W, d: Dims, text, offsets, x, t, guidance: float,
             prec: Precision = FP32) -> torch.Tensor:
    """The guided velocity [B, C, H, W] of the cond rows at latents x
    [B, C, H, W] (the null rows see the same latents) and time t."""
    Bp, B, n = text.shape[0], x.shape[0], d.n_image
    if guidance > 0:
        x = torch.cat([x, x])
    out, _ = forward(W, d, text, offsets, x,
                     torch.full((Bp,), float(t)), prec)
    vs = unpatchify(d, torch.stack([
        out[r, int(offsets[r]) + 1:int(offsets[r]) + n] for r in range(Bp)]))
    if guidance > 0:
        vc, vu = vs[:B], vs[B:]
        return vu + guidance * (vc - vu)
    return vs


# ---------------------------------------------------------------- VAE

MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
       3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


def _cconv(x, W, name, k):
    """A causal 3D convolution on one frame: its last time tap, 2D."""
    w = W[name + ".weight"][:, :, -1]
    return F.conv2d(x, w, W[name + ".bias"], padding=k // 2)


def _vrms(x, g):
    return F.normalize(x, dim=1, eps=1e-12) * math.sqrt(x.shape[1]) * \
        g.reshape(1, -1, 1, 1)


def _vres(x, W, name):
    h = _cconv(F.silu(_vrms(x, W[name + ".residual.0.gamma"])), W,
               name + ".residual.2", 3)
    h = _cconv(F.silu(_vrms(h, W[name + ".residual.3.gamma"])), W,
               name + ".residual.6", 3)
    if name + ".shortcut.weight" in W:
        x = _cconv(x, W, name + ".shortcut", 1)
    return x + h


def decode(W, d: Dims, latents, dtype=torch.float32,
           prefix: str = "vae.") -> torch.Tensor:
    """Latents [B, C, h, w] -> NHWC images in [-1, 1] (one frame)."""
    W = {k[len(prefix):]: v.to(dtype) for k, v in W.items()
         if k.startswith(prefix)}
    z = latents.to(dtype)
    kw = dict(dtype=dtype, device=z.device)
    z = z * torch.tensor(STD, **kw).view(1, -1, 1, 1) + torch.tensor(
        MEAN, **kw).view(1, -1, 1, 1)
    p = "decoder."
    h = _cconv(_cconv(z, W, "conv2", 1), W, p + "conv1", 3)
    h = _vres(h, W, p + "middle.0")
    B, C, H, Wd = h.shape
    a = _vrms(h, W[p + "middle.1.norm.gamma"])
    qkv = F.conv2d(a, W[p + "middle.1.to_qkv.weight"],
                   W[p + "middle.1.to_qkv.bias"])
    q, k, v = qkv.flatten(2).transpose(1, 2).chunk(3, -1)
    att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), -1) @ v
    att = att.transpose(1, 2).reshape(B, C, H, Wd)
    h = h + F.conv2d(att, W[p + "middle.1.proj.weight"],
                     W[p + "middle.1.proj.bias"])
    h = _vres(h, W, p + "middle.2")
    for i, (kind, _, _) in enumerate(_decoder_plan(d)):
        q_ = f"{p}upsamples.{i}"
        if kind == "res":
            h = _vres(h, W, q_)
        else:
            h = F.conv2d(F.interpolate(h, scale_factor=2.0,
                                       mode="nearest-exact"),
                         W[q_ + ".resample.1.weight"],
                         W[q_ + ".resample.1.bias"], padding=1)
    h = _cconv(F.silu(_vrms(h, W[p + "head.0.gamma"])), W, p + "head.2", 3)
    return h.clamp(-1.0, 1.0).permute(0, 2, 3, 1).float()
