"""Plain PyTorch reference of Show-o 1.3B text-to-image: the prompt layout,
the omni mask, Phi-1.5's forward with CFG, the MaskGIT step and the
MAGVIT-v2 decoder.

It follows the published Show-o model (Phi-1.5 with per-head q/k
LayerNorm, a parallel attention + MLP residual, partial NeoX rotary on the
first half of each head; MAGVIT-v2 with LFQ codes) and imports nothing of
the program: weights come in as a dict keyed by the checkpoint's names,
made by ``benchmark/weights.py`` from the run's seed.  Attention is dense
under the additive omni mask; nothing is cached or fused.

``Precision`` says how a forward rounds: ``fp32`` (TF32 off, the
reference) or the control's lower precisions, fp8 e4m3 operands in every
linear of Phi and bf16 throughout the decoder.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

NEG = -1e9
SPECIAL = ("<|soi|>", "<|eoi|>", "<|sov|>", "<|eov|>", "<|t2i|>",
           "<|mmu|>", "<|t2v|>", "<|v2v|>", "<|lvg|>")


@dataclasses.dataclass(frozen=True)
class Precision:
    """``linear``: "fp32" or "fp8" (e4m3 operands, one scale a tensor,
    products in fp32); ``decoder``: the decoder's dtype."""

    linear: str = "fp32"
    decoder: torch.dtype = torch.float32


FP32 = Precision()
CONTROL = Precision("fp8", torch.bfloat16)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor."""
    amax = x.abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Fp8Linear(torch.autograd.Function):
    """``F.linear`` with its operands, and in the backward the incoming
    gradient, rounded through fp8 e4m3 (one scale a tensor), products in
    fp32; it keeps the unrounded x and w for the backward (the parameter
    and an activation the fp32 path keeps too), not rounded copies."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return F.linear(fp8_round(x), fp8_round(w), b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = fp8_round(g)
        gx = gq @ fp8_round(w)
        gw = gq.flatten(0, -2).t() @ fp8_round(x).flatten(0, -2)
        gb = g.flatten(0, -2).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def linear(x, w, b, prec: Precision):
    if prec.linear == "fp8":
        return Fp8Linear.apply(x, w, b)
    return F.linear(x, w, b)


# ---------------------------------------------------------------- layout

def word_id(word: str) -> int:
    """The stand-in tokenizer's id of a word: md5 into [10, 1000)."""
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
    return 10 + h % 990


def special_ids() -> Dict[str, int]:
    """bos 1, eos 2; the pad token, then the task tokens, from 1000 on."""
    ids = {"<|pad|>": 1000, "<|sot|>": 1, "<|eot|>": 2}
    ids.update({t: 1001 + i for i, t in enumerate(SPECIAL)})
    return ids


def t2i_layout(prompts: Sequence[str], image_tokens: torch.Tensor,
               max_text_len: int) -> torch.Tensor:
    """[pad..][t2i][bos] words [eos][soi] image [eoi], the text left-padded
    (or cut with a closing eos) to ``max_text_len + 1``.  image_tokens:
    [B, N] unified ids."""
    sp = special_ids()
    rows = []
    width = max_text_len + 1
    for i, p in enumerate(prompts):
        text = [sp["<|t2i|>"], 1] + [word_id(w) for w in p.split()] + [2]
        if len(text) > width:
            text = text[:width - 1] + [2]
        text = [sp["<|pad|>"]] * (width - len(text)) + text
        rows.append(text + [sp["<|soi|>"]] + image_tokens[i].tolist()
                    + [sp["<|eoi|>"]])
    return torch.tensor(rows, dtype=torch.long)


def omni_mask(seq: torch.Tensor) -> torch.Tensor:
    """Bool [B, L, L] (True = may attend): causal text rows; rows inside
    the soi..eoi span see every key but pads; text rows after the last pad
    see no pad."""
    sp = special_ids()
    B, L = seq.shape
    is_pad = seq == sp["<|pad|>"]
    c_soi = torch.cumsum((seq == sp["<|soi|>"]).int(), 1)
    c_eoi = torch.cumsum((seq == sp["<|eoi|>"]).int(), 1)
    in_img = (c_soi > c_eoi) | (seq == sp["<|soi|>"]) | (seq == sp["<|eoi|>"])
    i = torch.arange(L)[:, None]
    j = torch.arange(L)[None, :]
    causal = (j <= i)[None]
    idx = torch.arange(L)[None]
    last_pad = torch.where(is_pad, idx, -1).amax(1)
    text_rows = causal & ~((i[None] > last_pad[:, None, None])
                           & (j[None] <= last_pad[:, None, None]))
    img_rows = ~is_pad[:, None, :].expand(B, L, L)
    return torch.where(in_img[:, :, None], img_rows, text_rows)


# ---------------------------------------------------------------- Phi

@dataclasses.dataclass(frozen=True)
class PhiDims:
    vocab_size: int = 58498
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 24
    num_heads: int = 32
    rope_theta: float = 10000.0
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def phi_specs(d: PhiDims, prefix: str = "showo.") -> List[tuple]:
    """(name, shape) of every weight, in the checkpoint's names."""
    D, F_ = d.hidden_size, d.intermediate_size
    out = [(prefix + "model.embed_tokens.weight", (d.vocab_size, D))]
    for i in range(d.num_layers):
        p = f"{prefix}model.layers.{i}."
        out += [(p + "input_layernorm.weight", (D,)),
                (p + "input_layernorm.bias", (D,))]
        for n in ("q_proj", "k_proj", "v_proj", "dense"):
            out += [(p + f"self_attn.{n}.weight", (D, D)),
                    (p + f"self_attn.{n}.bias", (D,))]
        for n in ("q_layernorm", "k_layernorm"):
            out += [(p + f"self_attn.{n}.weight", (d.head_dim,)),
                    (p + f"self_attn.{n}.bias", (d.head_dim,))]
        out += [(p + "mlp.fc1.weight", (F_, D)), (p + "mlp.fc1.bias", (F_,)),
                (p + "mlp.fc2.weight", (D, F_)), (p + "mlp.fc2.bias", (D,))]
    out += [(prefix + "model.final_layernorm.weight", (D,)),
            (prefix + "model.final_layernorm.bias", (D,)),
            (prefix + "lm_head.weight", (d.vocab_size, D)),
            (prefix + "lm_head.bias", (d.vocab_size,))]
    return out


def _ln(x, W, name, eps):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], eps)


def _rope(x, pos, rot, theta):
    """NeoX half rotation of the first ``rot`` dims; x [B, S, H, Dh]."""
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    f = pos[:, None].float() * inv
    cos = torch.cat([f, f], -1).cos()[None, :, None]
    sin = torch.cat([f, f], -1).sin()[None, :, None]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.chunk(2, -1)
    return torch.cat([xr * cos + torch.cat([-x2, x1], -1) * sin, xp], -1)


def phi_logits(W, d: PhiDims, ids: torch.Tensor, mask: torch.Tensor,
               rows: slice, cols: slice, prec: Precision = FP32,
               prefix: str = "showo.") -> torch.Tensor:
    """Logits [B, rows, cols] of a full (uncached) forward of ids [B, L]
    under the bool mask [B, L, L]."""
    B, L = ids.shape
    H, Dh = d.num_heads, d.head_dim
    rot = Dh // 2
    pos = torch.arange(L, device=ids.device)
    bias = torch.where(mask, 0.0, NEG)[:, None].to(ids.device)
    h = W[prefix + "model.embed_tokens.weight"][ids].float()
    for i in range(d.num_layers):
        p = f"{prefix}model.layers.{i}."
        x = _ln(h, W, p + "input_layernorm", d.eps)

        def lin(n, t):
            return linear(t, W[p + n + ".weight"], W[p + n + ".bias"], prec)

        q = lin("self_attn.q_proj", x).view(B, L, H, Dh)
        k = lin("self_attn.k_proj", x).view(B, L, H, Dh)
        v = lin("self_attn.v_proj", x).view(B, L, H, Dh)
        q = _rope(_ln(q, W, p + "self_attn.q_layernorm", d.eps), pos, rot,
                  d.rope_theta)
        k = _rope(_ln(k, W, p + "self_attn.k_layernorm", d.eps), pos, rot,
                  d.rope_theta)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh) + bias
        a = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).reshape(B, L, -1)
        m = F.gelu(lin("mlp.fc1", x), approximate="tanh")
        h = h + lin("self_attn.dense", a) + lin("mlp.fc2", m)
    h = _ln(h, W, prefix + "model.final_layernorm", d.eps)[:, rows]
    return linear(h, W[prefix + "lm_head.weight"][cols],
                  W[prefix + "lm_head.bias"][cols], prec)


# ---------------------------------------------------------------- MaskGIT

def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.clamp(-torch.log(torch.clamp(u, min=1e-20)),
                                  min=1e-20))


def step_temperatures(timesteps: int, temperature: float) -> List[float]:
    """The confidence noise's scale at each step: the temperature decayed
    by (1 - (s + 1) / T) at every step s, compounding, in fp32."""
    temp = torch.tensor(temperature, dtype=torch.float32)
    out = []
    for s in range(timesteps):
        temp = temp * (1.0 - torch.tensor(s + 1, dtype=torch.float32)
                       / timesteps)
        out.append(temp)
    return out


def cosine_mask_len(step: int, timesteps: int, n: int, device=None) -> int:
    """floor(n cos(pi/2 (step + 1) / T)) in fp32, on ``device``."""
    r = torch.tensor(step + 1, dtype=torch.float32, device=device) / timesteps
    return int(torch.floor(n * torch.cos(r * math.pi * 0.5)))


# ---------------------------------------------------------------- MAGVIT

@dataclasses.dataclass(frozen=True)
class VQDims:
    ch: int = 128
    dec_ch_mult: tuple = (1, 1, 2, 2, 4)
    dec_num_res_blocks: tuple = (4, 4, 3, 4, 3)
    z_channels: int = 13
    out_ch: int = 3


def _conv_specs(name, cin, cout, k):
    return [(name + ".weight", (cout, cin, k, k)), (name + ".bias", (cout,))]


def _norm_specs(name, c):
    return [(name + ".weight", (c,)), (name + ".bias", (c,))]


def _res_specs(name, cin, cout):
    out = (_norm_specs(name + ".norm1", cin)
           + _conv_specs(name + ".conv1", cin, cout, 3)
           + _norm_specs(name + ".norm2", cout)
           + _conv_specs(name + ".conv2", cout, cout, 3))
    if cin != cout:
        out += _conv_specs(name + ".nin_shortcut", cin, cout, 1)
    return out


def decoder_specs(d: VQDims, prefix: str = "decoder.") -> List[tuple]:
    n = len(d.dec_ch_mult)
    c = d.ch * d.dec_ch_mult[-1]
    out = (_conv_specs(prefix + "post_quant_conv", d.z_channels,
                       d.z_channels, 1)
           + _conv_specs(prefix + "conv_in", d.z_channels, c, 3)
           + _res_specs(prefix + "mid.block_1", c, c)
           + _norm_specs(prefix + "mid.attn_1.norm", c))
    for m in ("q", "k", "v", "proj_out"):
        out += _conv_specs(prefix + f"mid.attn_1.{m}", c, c, 1)
    out += _res_specs(prefix + "mid.block_2", c, c)
    for i in reversed(range(n)):
        cout = d.ch * d.dec_ch_mult[i]
        for j in range(d.dec_num_res_blocks[i]):
            out += _res_specs(prefix + f"up.{i}.block.{j}", c if j == 0
                              else cout, cout)
        if i != 0:
            out += _conv_specs(prefix + f"up.{i}.upsample.conv", cout, cout, 3)
        c = cout
    return (out + _norm_specs(prefix + "norm_out", c)
            + _conv_specs(prefix + "conv_out", c, d.out_ch, 3))


def _conv(x, W, name, pad):
    return F.conv2d(x, W[name + ".weight"], W[name + ".bias"], padding=pad)


def _gn(x, W, name):
    return F.group_norm(x, 32, W[name + ".weight"], W[name + ".bias"], 1e-6)


def _res(x, W, name):
    h = _conv(F.silu(_gn(x, W, name + ".norm1")), W, name + ".conv1", 1)
    h = _conv(F.silu(_gn(h, W, name + ".norm2")), W, name + ".conv2", 1)
    if name + ".nin_shortcut.weight" in W:
        x = _conv(x, W, name + ".nin_shortcut", 0)
    return x + h


def decode_codes(W, d: VQDims, codes: torch.Tensor,
                 dtype=torch.float32, prefix: str = "decoder.") -> torch.Tensor:
    """LFQ codes [B, h*w] -> NHWC images clamped to [-1, 1], fp32."""
    W = {k: v.to(dtype) for k, v in W.items() if k.startswith(prefix)}
    b, n = codes.shape
    side = int(round(n ** 0.5))
    shifts = torch.arange(d.z_channels - 1, -1, -1, device=codes.device)
    z = ((codes[..., None] >> shifts) & 1).to(dtype) * 2 - 1
    z = z.reshape(b, side, side, -1).permute(0, 3, 1, 2)
    p = prefix
    h = _conv(_conv(z, W, p + "post_quant_conv", 0), W, p + "conv_in", 1)
    h = _res(h, W, p + "mid.block_1")
    B, C, Hh, Ww = h.shape
    a = _gn(h, W, p + "mid.attn_1.norm")
    q, k, v = (_conv(a, W, p + f"mid.attn_1.{m}", 0).flatten(2)
               for m in ("q", "k", "v"))
    att = torch.softmax(q.transpose(1, 2) @ k * C ** -0.5, dim=2)
    o = (att @ v.transpose(1, 2)).transpose(1, 2).reshape(B, C, Hh, Ww)
    h = _res(h + _conv(o, W, p + "mid.attn_1.proj_out", 0), W,
             p + "mid.block_2")
    for i in reversed(range(len(d.dec_ch_mult))):
        for j in range(d.dec_num_res_blocks[i]):
            h = _res(h, W, p + f"up.{i}.block.{j}")
        if i != 0:
            h = _conv(F.interpolate(h, scale_factor=2.0, mode="nearest"), W,
                      p + f"up.{i}.upsample.conv", 1)
    h = _conv(F.silu(_gn(h, W, p + "norm_out")), W, p + "conv_out", 1)
    return h.permute(0, 2, 3, 1).float().clamp(-1.0, 1.0)
