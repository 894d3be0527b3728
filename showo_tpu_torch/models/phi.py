"""Phi-1.5 decoder as PyTorch modules.

Counterpart of ``showo_tpu/models/phi.py``:
  * parallel attention + MLP residual with one shared input LayerNorm;
  * partial rotary embedding (GPT-NeoX half rotation) on the first
    ``partial_rotary_factor * head_dim`` dims;
  * per-head q/k LayerNorm;
  * fp32 QK scores and softmax on the dense path;
  * the caller's [B, 1, Q, K] additive mask flows through unchanged, or
    an attention route (``ATTN_ROUTES``) sends attention to a kernel.

The module tree carries the reference checkpoint's names
(``model.layers.{i}.self_attn.q_proj`` ...), so a reference-layout state
dict loads with ``load_state_dict``.  ``fuse_qkv`` / ``fuse_parallel_mlp``
re-lay the weights for inference, as the JAX transforms of the same names
do.  Layers are an ``nn.ModuleList`` walked by a Python loop (the JAX
package scans stacked params).

Per-head LayerNorm has one plain form here; the JAX package switches to a
segment-matmul form between 400 and 4096 rows, which differs at fp32 eps.

Training keeps the reference layout (separate q/k/v, ``dense``, ``fc1``,
``fc2``) and passes ``remat`` to ``Phi.forward`` ("full": each layer
recomputed in the backward, ``utils/remat.py``).

Weight-only int8 serving (:func:`quantize_int8`, JAX ``quantize_int8``)
turns every matmul of any layout, and ``lm_head``, into an
:class:`Int8Linear`, whose forward is the int8 kernel
(``ops/int8_matmul.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from showo_tpu_torch.ops.decode_attention import (bias_tile_map,
                                                  decode_attention)
from showo_tpu_torch.ops.flash_attention import (omni_attention,
                                                 omni_attention_packed,
                                                 omni_tile_map, q_rows,
                                                 rows_tile_map, span_meta)
from showo_tpu_torch.ops.fused_decode import (fused_decode_attention,
                                              fused_rows, fused_tile_map)
from showo_tpu_torch.ops.int8_matmul import WeightStream, linear_i8
from showo_tpu_torch.ops.packed_attention_grad import \
    omni_attention_packed_trainable
from showo_tpu_torch.ops.streaming_attention import (
    omni_attention_streaming, streaming_tile_map)
from showo_tpu_torch.utils.remat import wrap_remat

# Attention routes: the port's name -> the JAX package's attn impl string.
#   dense      einsum attention under the additive bias (no kernel)
#   packed     omni kernel on the packed [B, S, H*D] layout
#   omni       omni kernel on head-major [B, H, S, D] views
#   decode     kernel under the explicit additive bias
#   fused      the cached step's LN + RoPE + concat + attention kernel off
#              the ``win`` output; elsewhere (no static prefix, or no
#              ``win``) it falls through to ``omni``, as in JAX
#   streaming  K-blocked omni kernel on head-major views; a row that sees
#              no key emits 0
#   trainable  forward, dq and dk/dv kernels under autograd, packed
#              layout, self-attention only (the training route); past the
#              packed budget the K-blocked trainable kernels, as in JAX
ATTN_ROUTES = {
    "dense": None,
    "packed": "pallas_packed",
    "omni": "pallas",
    "decode": "pallas_decode",
    "fused": "pallas_fused",
    "streaming": "pallas_streaming",
    "trainable": "pallas_trainable",
}


def check_route(name: str) -> str:
    """``name`` if it is a route of :data:`ATTN_ROUTES`; an unknown name
    (a JAX impl string among them) raises ValueError."""
    if name not in ATTN_ROUTES:
        port = {j: p for p, j in ATTN_ROUTES.items() if j}.get(name)
        hint = f" (the JAX package's name of route {port!r})" if port else ""
        raise ValueError(f"unknown attention route {name!r}{hint}; the "
                         f"routes are {sorted(ATTN_ROUTES)}")
    return name


@dataclasses.dataclass(frozen=True)
class AttnStep:
    """One forward's attention route and the metadata its kernel reads,
    computed once for all layers (:func:`attn_step`): seg / pad /
    last_pad / prefix int32 and contiguous; ``pos_q`` / ``seg_q``: int32
    [B, Q] rows of the omni kernels (None for ``decode`` and
    ``trainable``); ``fused``: the :func:`fused_rows` tuple when the
    forward is a static-prefix cached step on the ``fused`` route, else
    None; ``tiles``: the tile map the route's kernel reads (``packed``,
    ``omni``, ``streaming``: ``rows_tile_map`` of the metadata under the
    kernel's entry; ``fused``: ``fused_tile_map`` of ``fused``, or
    outside the static-prefix step the ``omni`` map; ``decode``:
    ``bias_tile_map`` of the forward's bias, made in
    :meth:`Phi.forward`), on CUDA only (None on the CPU, whose plain
    versions need none, and on ``trainable``)."""

    route: str
    seg: torch.Tensor
    pad: torch.Tensor
    last_pad: torch.Tensor
    prefix: torch.Tensor
    pos_q: Optional[torch.Tensor] = None
    seg_q: Optional[torch.Tensor] = None
    fused: Optional[tuple] = None
    tiles: Optional[torch.Tensor] = None


def attn_step(attn_meta, q_start: int, rows: int,
              static_prefix_len: Optional[int] = None) -> AttnStep:
    """(route, seg, pad, last_pad, prefix) -> :class:`AttnStep` for a
    forward whose ``rows`` q rows sit at kv positions ``q_start`` on."""
    route, seg, pad, last_pad, prefix = attn_meta
    check_route(route)
    if route == "dense":
        raise ValueError("the dense route takes attn_meta=None")
    B, S = seg.shape
    if route == "trainable" and (q_start != 0 or rows != S):
        raise ValueError(f"the trainable route is self-attention over the "
                         f"{S} rows of its metadata; got {rows} rows from "
                         f"position {q_start}")
    step = AttnStep(route, *span_meta(seg, pad, last_pad, prefix, B, S,
                                      seg.device))
    if route in ("decode", "trainable"):
        return step
    positions = q_start + torch.arange(rows, device=seg.device)
    if route == "fused" and static_prefix_len is not None:
        fused = fused_rows(seg, pad, positions, static_prefix_len,
                           seg.shape[0])
        tiles = (fused_tile_map(fused, step.last_pad, step.prefix)
                 if seg.is_cuda else None)
        return dataclasses.replace(step, pos_q=fused[0], seg_q=fused[1],
                                   fused=fused, tiles=tiles)
    pos_q, seg_q = q_rows(seg, positions, seg.shape[0], rows)
    tiles = None
    if seg.is_cuda:
        # packed, streaming, omni, and fused falling through to omni
        tile_map = {"packed": rows_tile_map,
                    "streaming": streaming_tile_map}.get(route, omni_tile_map)
        tiles = tile_map(step.seg, step.pad, step.last_pad, step.prefix,
                         pos_q, seg_q)
    return dataclasses.replace(step, pos_q=pos_q, seg_q=seg_q, tiles=tiles)


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 58498
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 24
    num_heads: int = 32
    partial_rotary_factor: float = 0.5
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    max_position_embeddings: int = 2048
    # fp32 QK/softmax on the dense path (reference parity); False keeps
    # the scores in the activation dtype
    attn_fp32: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim)


@dataclasses.dataclass
class KVCache:
    """Decode cache.  k/v: [L, B, S_max, H, Dh]; ``length`` is the number
    of valid positions: an int, or an int32 [B] tensor of per-lane lengths
    (serving).  Updated in place by a forward that writes to it (the JAX
    package returns a new cache instead)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def zeros(cls, cfg: PhiConfig, batch: int, max_len: int,
              dtype=torch.float32, device=None) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def lane_rows(start: torch.Tensor, rows: int, size: int) -> torch.Tensor:
    """[B, rows] int64 index of ``rows`` consecutive positions from each
    lane's ``start`` [B] in an axis of ``size``, the start clamped into
    [0, size - rows] as ``jax.lax.dynamic_update_slice`` clamps it (an
    update never lands out of bounds)."""
    start = start.long().clamp(0, size - rows)
    return start[:, None] + torch.arange(rows, device=start.device)


def _cache_scatter(ck, cv, k, v, index) -> None:
    """Write fresh K/V rows [B, S, H, Dh] into the layer cache [B, S_max,
    H, Dh] in place at ``index``: an int (the offset shared by every lane)
    or an int32 [B] tensor of per-lane offsets, the continuous-batching
    serving path where every batch lane decodes its own request at its own
    length (``serving/engine.py``); that write is one ``index_put_``, with
    no host sync."""
    S = k.shape[1]
    if torch.is_tensor(index):
        b = torch.arange(ck.shape[0], device=ck.device)[:, None]
        rows = lane_rows(index, S, ck.shape[1])
        ck[b, rows] = k.to(ck.dtype)
        cv[b, rows] = v.to(cv.dtype)
        return
    ck[:, index:index + S] = k.to(ck.dtype)
    cv[:, index:index + S] = v.to(cv.dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def head_layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
                    head_dim: int) -> torch.Tensor:
    """Per-head LayerNorm of packed [..., H*Dh] -> [..., H, Dh]."""
    return layer_norm(x.unflatten(-1, (-1, head_dim)), norm)


def rope_tables(positions: torch.Tensor, rotary_dim: int, theta: float):
    """cos/sin tables [..., rotary_dim] (GPT-NeoX convention), fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2,
                                             dtype=torch.float32,
                                             device=positions.device)
                                / rotary_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin, rotary_dim: int):
    """Partial rotary on the first rotary_dim dims.  q, k: [B, S, H, Dh];
    cos/sin: [B, S, rotary_dim] (broadcast over heads)."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    q_rot, q_pass = q[..., :rotary_dim], q[..., rotary_dim:]
    k_rot, k_pass = k[..., :rotary_dim], k[..., rotary_dim:]
    q_rot = q_rot * cos + _rotate_half(q_rot) * sin
    k_rot = k_rot * cos + _rotate_half(k_rot) * sin
    return torch.cat([q_rot, q_pass], -1), torch.cat([k_rot, k_pass], -1)


def attention(q, k, v, bias, attn_meta: Optional[AttnStep] = None,
              softmax_dtype=torch.float32):
    """q: [B, Q, H, Dh]; k, v: [B, K, H, Dh]; bias: [B, 1, Q, K] additive.

    attn_meta: optional :class:`AttnStep` sending attention to its
    route's kernel: ``packed`` / ``omni`` / ``fused`` / ``streaming`` /
    ``trainable`` recompute the mask from metadata (the bias is unused),
    ``decode`` adds the bias.  None takes the dense path: scores in
    ``softmax_dtype`` from exact products of the stored operands, softmax,
    probabilities cast to v's dtype, outside autocast (so a bf16 autocast
    region keeps fp32 scores).  The kernels' scores and softmax are fp32 whatever
    ``softmax_dtype`` says, as in JAX.
    """
    if attn_meta is not None:
        m = attn_meta
        B, Q, H, Dh = q.shape
        if m.route == "decode":
            if bias is None:
                raise ValueError("the decode route needs the additive bias")
            return decode_attention(q, k, v, bias, tiles=m.tiles)
        if m.route == "trainable":
            out = omni_attention_packed_trainable(
                q.reshape(B, Q, H * Dh), k.reshape(B, k.shape[1], H * Dh),
                v.reshape(B, v.shape[1], H * Dh), m.seg, m.pad, m.last_pad,
                m.prefix, num_heads=H)
            return out.reshape(B, Q, H, Dh)
        if m.route == "packed":
            out = omni_attention_packed(
                q.reshape(B, Q, H * Dh), k.reshape(B, k.shape[1], H * Dh),
                v.reshape(B, v.shape[1], H * Dh), m.seg, m.pad, m.last_pad,
                m.prefix, num_heads=H, q_positions=m.pos_q, seg_q=m.seg_q,
                tiles=m.tiles)
            return out.reshape(B, Q, H, Dh)
        if m.route == "streaming":
            out = omni_attention_streaming(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                m.seg, m.pad, m.last_pad, m.prefix, q_positions=m.pos_q,
                seg_q=m.seg_q, tiles=m.tiles)
            return out.transpose(1, 2)
        # omni, and fused outside its kernel (no static prefix, or no
        # ``win``; with a static prefix the step's map is kernel 2's, so
        # the omni kernel makes its own)
        out = omni_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), m.seg, m.pad, m.last_pad,
                             m.prefix, q_positions=m.pos_q, seg_q=m.seg_q,
                             tiles=None if m.fused is not None else m.tiles)
        return out.transpose(1, 2)
    head_dim = q.shape[-1]
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.einsum("bqhd,bkhd->bhqk", q.to(softmax_dtype),
                              k.to(softmax_dtype)) / math.sqrt(head_dim)
        if bias is not None:
            scores = scores + bias.to(softmax_dtype)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class PhiAttention(nn.Module):
    """Projections and q/k norms of one layer (reference names)."""

    def __init__(self, cfg: PhiConfig, device=None, dtype=None):
        super().__init__()
        D, Dh = cfg.hidden_size, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(D, D, **kw)
        self.k_proj = nn.Linear(D, D, **kw)
        self.v_proj = nn.Linear(D, D, **kw)
        self.dense = nn.Linear(D, D, **kw)
        self.q_layernorm = nn.LayerNorm(Dh, eps=cfg.layer_norm_eps, **kw)
        self.k_layernorm = nn.LayerNorm(Dh, eps=cfg.layer_norm_eps, **kw)


class PhiMLP(nn.Module):
    def __init__(self, cfg: PhiConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)


class PhiDecoderLayer(nn.Module):
    """One parallel-residual layer.  Its projections are in one of three
    layouts: separate q/k/v (reference), fused ``self_attn.qkv``
    (:func:`fuse_qkv`), or the two wide ``win`` / ``wout`` matmuls
    (:func:`fuse_parallel_mlp`)."""

    def __init__(self, cfg: PhiConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = nn.LayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps,
                                            device=device, dtype=dtype)
        self.self_attn = PhiAttention(cfg, device, dtype)
        self.mlp = PhiMLP(cfg, device, dtype)

    def _qkv_mlp(self, x):
        """(q, k, v, mlp_pre) packed [B, S, *] in any layout."""
        D = self.cfg.hidden_size
        if hasattr(self, "win"):
            y = self.win(x)
            return (y[..., :D], y[..., D:2 * D], y[..., 2 * D:3 * D],
                    y[..., 3 * D:])
        a = self.self_attn
        if hasattr(a, "qkv"):
            q, k, v = a.qkv(x).split(D, dim=-1)
        else:
            q, k, v = a.q_proj(x), a.k_proj(x), a.v_proj(x)
        return q, k, v, self.mlp.fc1(x)

    def project_out(self, h, attn, mlp_pre):
        """The residual output of the layer from attention [B, S, D] and
        the MLP input ``mlp_pre`` of :meth:`_qkv_mlp`, in any layout."""
        mlp = F.gelu(mlp_pre, approximate="tanh")
        if hasattr(self, "wout"):
            return h + self.wout(torch.cat([attn, mlp], dim=-1))
        return h + self.self_attn.dense(attn) + self.mlp.fc2(mlp)

    def forward(self, h, bias, cos, sin, cache_kv=None, cache_index=None,
                attn_meta: Optional[AttnStep] = None,
                static_prefix: bool = False):
        """h: [B, S, D].  cache_kv: (ck, cv) of this layer, [B, S_max, H, Dh]
        written in place at ``cache_index`` (an int, or per-lane offsets
        [B]: :func:`_cache_scatter`), or with ``static_prefix`` the
        [B, P, H, Dh] prefix the fresh rows are appended to (not written)."""
        cfg = self.cfg
        B, S, D = h.shape
        Dh = cfg.head_dim
        x = layer_norm(h, self.input_layernorm)
        if (attn_meta is not None and attn_meta.fused is not None
                and static_prefix and hasattr(self, "win")):
            return self._fused_step(h, x, cos, sin, cache_kv, attn_meta)
        q, k, v, mlp_pre = self._qkv_mlp(x)
        q = head_layer_norm(q, self.self_attn.q_layernorm, Dh)
        k = head_layer_norm(k, self.self_attn.k_layernorm, Dh)
        v = v.reshape(B, S, cfg.num_heads, Dh)
        q, k = apply_rope(q, k, cos, sin, cfg.rotary_dim)

        if cache_kv is not None:
            ck, cv = cache_kv
            if static_prefix:
                k_att = torch.cat([ck, k.to(ck.dtype)], dim=1)
                v_att = torch.cat([cv, v.to(cv.dtype)], dim=1)
            else:
                _cache_scatter(ck, cv, k, v, cache_index)
                k_att, v_att = ck, cv
        else:
            k_att, v_att = k, v
        attn = attention(
            q, k_att, v_att, bias, attn_meta,
            softmax_dtype=torch.float32 if cfg.attn_fp32 else h.dtype,
        ).reshape(B, S, D)
        return self.project_out(h, attn, mlp_pre)

    def _fused_step(self, h, x, cos, sin, cache_kv, m: AttnStep):
        """The static-prefix cached step on the ``fused`` route: kernel 2
        does the per-head LN, RoPE, [prefix | fresh] concat and attention
        straight off the ``win`` output (JAX ``_layer``'s pallas_fused
        branch), on the step's tile map."""
        cfg = self.cfg
        D = cfg.hidden_size
        y = self.win(x)
        ck, cv = cache_kv                                  # [B, P, H, Dh]
        a = self.self_attn
        attn = fused_decode_attention(
            y, ck.flatten(2), cv.flatten(2),
            (a.q_layernorm.weight, a.q_layernorm.bias),
            (a.k_layernorm.weight, a.k_layernorm.bias), cos[0], sin[0],
            m.seg, m.pad, m.last_pad, m.prefix, m.pos_q[0], hidden=D,
            num_heads=cfg.num_heads, rotary_dim=cfg.rotary_dim,
            eps=cfg.layer_norm_eps,
            softmax_dtype=torch.float32 if cfg.attn_fp32 else h.dtype,
            rows=m.fused, tiles=m.tiles)
        return self.project_out(h, attn, y[..., 3 * D:])


class PhiModel(nn.Module):
    def __init__(self, cfg: PhiConfig, device=None, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            PhiDecoderLayer(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.final_layernorm = nn.LayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps,
                                            device=device, dtype=dtype)


class Phi(nn.Module):
    """Phi-1.5 causal LM.  ``forward`` is the counterpart of JAX
    ``phi_forward``."""

    def __init__(self, cfg: PhiConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.model = PhiModel(cfg, device, dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 device=device, dtype=dtype)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "Phi":
        """Random init as JAX ``init_phi_params``: N(0, 0.02) for embedding
        and matmul weights, zero biases, unit norm scales.  Draws in fp32
        on the generator's device, then casts."""
        for name, p in self.named_parameters():
            if name.endswith("weight") and p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * 0.02)
            elif "layernorm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, input_ids=None, input_embeds=None, attention_bias=None,
                position_ids=None, cache: Optional[KVCache] = None,
                attn_meta=None, lm_head_slice=None,
                static_prefix_len: Optional[int] = None, remat=False):
        """Returns (logits, cache_or_None).

        attention_bias: [B, 1, Q, K] additive mask.  Three modes:
          * no cache: K = S;
          * ``cache``: fresh K/V are written at ``cache.length`` (in place;
            per lane where it is a [B] tensor, the rows then at positions
            ``length[b] + arange(S)``) and attention runs over the cache
            capacity (K = S_max);
          * ``cache`` + ``static_prefix_len`` P: the first P cached rows are
            a constant prefix; attention runs over [prefix | fresh]
            (K = P + S) and nothing is written.
        attn_meta: optional (route, seg, pad, last_pad, prefix) with a
        route of :data:`ATTN_ROUTES` other than ``dense``; the metadata its
        kernel reads is computed here, once for all layers
        (:func:`attn_step`).
        lm_head_slice: optional (row_lo, row_hi, col_lo, col_hi) computing
        logits only for those rows / vocab columns (col_lo None: every
        column).
        remat: the layer policy of ``utils/remat.py`` for the forward
        without a cache (training); "full" recomputes each layer in the
        backward.
        """
        cfg = self.cfg
        if input_embeds is None:
            input_embeds = self.model.embed_tokens(input_ids)
        B, S, _ = input_embeds.shape
        dev = input_embeds.device
        if position_ids is None:
            start = cache.length if cache is not None else 0
            if torch.is_tensor(start):
                start = start[:, None]
            position_ids = torch.atleast_2d(start + torch.arange(S,
                                                                 device=dev))
        cos, sin = rope_tables(position_ids, cfg.rotary_dim, cfg.rope_theta)

        static = cache is not None and static_prefix_len is not None
        bias = attention_bias
        if static and bias is not None:
            bias = bias[..., :static_prefix_len + S]
        if attn_meta is not None:
            q_start = (static_prefix_len if static
                       else cache.length if cache is not None else 0)
            attn_meta = attn_step(attn_meta, q_start, S,
                                  static_prefix_len if static else None)
            if (attn_meta.route == "decode" and bias is not None
                    and bias.is_cuda):
                # the bias's tile map, read by every layer's kernel
                attn_meta = dataclasses.replace(attn_meta,
                                                tiles=bias_tile_map(bias))
        h = input_embeds
        if static:
            P = static_prefix_len
            for i, layer in enumerate(self.model.layers):
                h = layer(h, bias, cos, sin,
                          (cache.k[i, :, :P], cache.v[i, :, :P]), P,
                          attn_meta, static_prefix=True)
        elif cache is not None:
            for i, layer in enumerate(self.model.layers):
                h = layer(h, bias, cos, sin,
                          (cache.k[i], cache.v[i]), cache.length, attn_meta)
            cache.length = cache.length + S
        else:
            for layer in self.model.layers:
                h = wrap_remat(layer, remat)(h, bias, cos, sin,
                                             attn_meta=attn_meta)

        h = layer_norm(h, self.model.final_layernorm)
        cols = None
        if lm_head_slice is not None:
            r0, r1, c0, c1 = lm_head_slice
            h = h[:, r0:r1]
            cols = None if c0 is None else slice(c0, c1)
        if isinstance(self.lm_head, Int8Linear):
            return self.lm_head(h, cols), cache
        weight, bias_h = self.lm_head.weight, self.lm_head.bias
        if cols is not None:
            weight, bias_h = weight[cols], bias_h[cols]
        return F.linear(h, weight, bias_h), cache


@torch.no_grad()
def fuse_qkv(model: Phi) -> Phi:
    """Fuse each layer's q/k/v projections into one ``self_attn.qkv``
    (numerically the same products; one wider matmul).  In place."""
    for layer in model.model.layers:
        a = layer.self_attn
        if hasattr(layer, "win") or hasattr(a, "qkv"):
            continue
        qkv = nn.Linear(a.q_proj.in_features, 3 * a.q_proj.out_features,
                        device=a.q_proj.weight.device,
                        dtype=a.q_proj.weight.dtype)
        qkv.weight.copy_(torch.cat([a.q_proj.weight, a.k_proj.weight,
                                    a.v_proj.weight], dim=0))
        qkv.bias.copy_(torch.cat([a.q_proj.bias, a.k_proj.bias,
                                  a.v_proj.bias], dim=0))
        a.qkv = qkv
        del a.q_proj, a.k_proj, a.v_proj
    return model


@torch.no_grad()
def fuse_parallel_mlp(model: Phi) -> Phi:
    """Collapse each layer's four projections into two wide matmuls, using
    the parallel residual (qkv and fc1 read the same normed input; the
    attention-dense and fc2 outputs are summed):

        win  = [Wqkv | Wfc1]            x_ln @ win -> [qkv | mlp_pre]
        wout = [Wdense; Wfc2]           [attn, gelu(mlp_pre)] @ wout

    Same function up to fp32 accumulation order.  In place."""
    fuse_qkv(model)
    for layer in model.model.layers:
        if hasattr(layer, "win"):
            continue
        a, m = layer.self_attn, layer.mlp
        kw = dict(device=a.qkv.weight.device, dtype=a.qkv.weight.dtype)
        D, F_ = a.dense.in_features, m.fc1.out_features
        win = nn.Linear(D, 3 * D + F_, **kw)
        win.weight.copy_(torch.cat([a.qkv.weight, m.fc1.weight], dim=0))
        win.bias.copy_(torch.cat([a.qkv.bias, m.fc1.bias], dim=0))
        wout = nn.Linear(D + F_, D, **kw)
        wout.weight.copy_(torch.cat([a.dense.weight, m.fc2.weight], dim=1))
        wout.bias.copy_(a.dense.bias + m.fc2.bias)
        layer.win, layer.wout = win, wout
        del a.qkv, a.dense, layer.mlp
    return model


class Int8Linear(nn.Module):
    """Weight-only int8 ``nn.Linear`` (JAX ``kernel_i8`` / ``scale``
    params): ``w_i8`` [K, N] int8 in the JAX layout, its rows padded to a
    multiple of 16 bytes so the kernel reads them with 16-byte loads
    (``kernel_i8`` is the [K, N] view), ``scale`` [1, N] bf16 per output
    column, ``bias`` [N] in the model's dtype, or None (``bias=False``).
    The forward is :func:`~showo_tpu_torch.ops.int8_matmul.linear_i8`: the
    kernel for CUDA tensors (through a :class:`WeightStream` kept for
    these buffers), its plain version for CPU tensors."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        padded = -(-out_features // 16) * 16
        self.register_buffer("w_i8", torch.zeros(
            (in_features, padded), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.zeros(
            (1, out_features), dtype=torch.bfloat16, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=dtype, device=device) if bias else None)
        self._stream = None

    @property
    def kernel_i8(self) -> torch.Tensor:
        return self.w_i8[:, :self.out_features]

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        """:meth:`from_weight` of an ``nn.Linear``'s weight and bias."""
        return cls.from_weight(lin.weight, lin.bias)

    @classmethod
    @torch.no_grad()
    def from_weight(cls, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> "Int8Linear":
        """Per-output-channel symmetric int8 of ``weight`` [N, K] (an
        ``nn.Linear``'s, or a tied embedding table), as JAX
        ``quantize_int8``: amax over K in fp32, ``scale = max(amax / 127,
        1e-8)``, round half to even, clip to +-127; the scale stored in
        bf16."""
        w = weight.float()                                     # [N, K]
        scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-8)
        q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
        del w
        N, K = weight.shape
        out = cls(K, N, weight.device, weight.dtype if bias is None
                  else bias.dtype, bias=bias is not None)
        out.w_i8[:, :N] = q.t()
        out.scale.copy_(scale[None].to(torch.bfloat16))
        if bias is not None:
            out.bias.copy_(bias)
        return out

    @torch.no_grad()
    def load_quantized(self, kernel_i8, scale, bias=None) -> "Int8Linear":
        """Set the buffers from JAX-layout arrays: ``kernel_i8`` [K, N]
        int8, ``scale`` [1, N], ``bias`` [N] (numpy, bf16 ones too; None
        for a module without bias)."""
        k = torch.tensor(np.asarray(kernel_i8))
        if tuple(k.shape) != (self.in_features, self.out_features):
            raise ValueError(f"kernel_i8 {tuple(k.shape)} does not fit "
                             f"[{self.in_features}, {self.out_features}]")
        if (bias is None) != (self.bias is None):
            raise ValueError(f"bias {'missing' if bias is None else 'given'}"
                             f" for a module "
                             f"{'with' if bias is None else 'without'} one")
        self.w_i8[:, :self.out_features] = k.to(torch.int8)
        self.scale.copy_(torch.tensor(
            np.asarray(scale, np.float32)).reshape(1, -1))
        if bias is not None:
            self.bias.copy_(torch.tensor(np.asarray(bias, np.float32)))
        return self

    def forward(self, x: torch.Tensor, cols: Optional[slice] = None):
        """x [..., K] -> [..., N], or only the output columns ``cols``."""
        w, scale, bias = self.kernel_i8, self.scale, self.bias
        if cols is not None:
            w, scale = w[:, cols], scale[:, cols]
            bias = None if bias is None else bias[cols]
        elif x.is_cuda:
            key = (w.data_ptr(), scale.data_ptr(),
                   None if bias is None else bias.data_ptr())
            if self._stream is None or self._stream[0] != key:
                self._stream = key, WeightStream(
                    "int8_matmul", w, scale, bias, self.in_features)
            x2 = x.reshape(-1, self.in_features)
            if x2.stride(-1) != 1:
                x2 = x2.contiguous()
            return self._stream[1](x2).view(*x.shape[:-1], self.out_features)
        return linear_i8(x, w, scale, bias)


# the matmuls quantize_int8 converts, by their place in a layer (JAX names:
# q, k, v, qkv, dense, fc1, fc2, win, wout)
INT8_LINEARS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                "v": "self_attn.v_proj", "qkv": "self_attn.qkv",
                "dense": "self_attn.dense", "fc1": "mlp.fc1",
                "fc2": "mlp.fc2", "win": "win", "wout": "wout"}


def _replace(root: nn.Module, path: str, module: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, name, module)


@torch.no_grad()
def quantize_int8(model: Phi) -> Phi:
    """Weight-only int8 serving (JAX ``quantize_int8``): every matmul of
    each layer's layout (plain, ``fuse_qkv``, ``fuse_parallel_mlp``) and
    ``lm_head`` become :class:`Int8Linear`; biases, norms and the
    embedding stay as they are.  In place; a matmul already quantized is
    left alone."""
    for layer in model.model.layers:
        for path in INT8_LINEARS.values():
            try:
                lin = layer.get_submodule(path)
            except AttributeError:
                continue
            if isinstance(lin, nn.Linear):
                _replace(layer, path, Int8Linear.from_linear(lin))
    if isinstance(model.lm_head, nn.Linear):
        model.lm_head = Int8Linear.from_linear(model.lm_head)
    return model
