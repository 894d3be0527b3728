"""Qwen2 / Qwen2.5 decoder as PyTorch modules.

Counterpart of ``showo_tpu/show_o2/qwen2.py`` (the reference fork
show-o2/models/qwen2.py):
  * RMSNorm with fp32 internals, SwiGLU MLP, GQA with q/k/v biases and no
    o bias;
  * full-head RoPE (default rope type), theta 1e6 for Qwen2.5;
  * the caller's dense [B, 1, L, L] additive omni mask is used as it is
    (the fork's raw mask passthrough), or an attention route
    (``ATTN_ROUTES``) sends attention to an omni kernel: the packed one
    (kernel 1) or the K-blocked one on head-major views (kernel 5);
  * tied word embeddings (the 1.5B config): the logits are ``h @ embed.T``;
  * a KV cache (:class:`Qwen2KVCache`) written in place at a shared offset
    or at per-row offsets ``cache_offsets`` [B] (the text-to-image
    prefix cache, whose CFG null rows start their image span elsewhere
    than the prompts' rows); the q rows then sit at per-row positions
    against every cached key (Q != K).

The module tree carries the reference checkpoint's names
(``model.layers.{i}.self_attn.q_proj`` ...), so a reference-layout state
dict loads with ``load_state_dict``.  :func:`fuse_inference` re-lays the
weights for inference (one qkv and one gate/up matmul per layer), as the
JAX transform of the same name does.  :func:`quantize_int8` turns every
matmul of a layer, and a vocabulary head quantized from the tied
embedding, into the int8 kernel's ``Int8Linear`` (weight-only int8
serving, as JAX ``quantize_int8``).  The ``trainable`` route sends every
layer's self-attention through the differentiable packed kernels (kernel
7, or kernel 8 past its budget) at head dim 128, and ``remat`` runs each
layer under a policy of ``utils/remat.py``, its tags at JAX's places.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from showo_tpu_torch.models.phi import qk_scores
from showo_tpu_torch.ops.flash_attention import (omni_attention_packed,
                                                 rows_tile_map,
                                                 q_rows, span_meta)
from showo_tpu_torch.ops.packed_attention_grad import \
    omni_attention_packed_trainable
from showo_tpu_torch.ops.streaming_attention import (omni_attention_streaming,
                                                     streaming_tile_map)
from showo_tpu_torch.utils.remat import keep, project, wrap_remat

# Attention routes: the port's name -> the JAX package's attn impl string.
#   dense      einsum attention under the additive bias (no kernel)
#   packed     omni kernel on the packed [B, S, H*D] layout (kernel 1), with
#              the mask recomputed from (seg, pad, last_pad, prefix)
#   streaming  K-blocked omni kernel (kernel 5) on head-major views of the
#              same q / k / v, the same mask
#   trainable  the differentiable packed kernels (forward with lse, dq,
#              dk / dv; kernel 7 within ``packed_trainable_fits``, kernel 8
#              past it), self-attention only: the training route
ATTN_ROUTES = {"dense": None, "packed": "pallas_packed",
               "streaming": "pallas_streaming",
               "trainable": "pallas_trainable"}


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
    """An omni kernel's metadata for one forward, computed once for all
    layers of both towers (:func:`packed_meta`): the route (``packed`` or
    ``streaming``), seg / pad / last_pad / prefix int32 and contiguous,
    the q rows' (pos_q, seg_q) [B, Q], and on CUDA the tile map that the
    kernel reads (``rows_tile_map`` under the route's source; None on the
    CPU, whose plain version needs none, and on ``trainable``, whose
    autograd Function makes its kernels' map in each forward).  The map
    depends on the metadata and the q rows alone, not on heads or head
    dim, so Qwen's layers (head dim 128) and the DiT's (64) read the same
    one."""

    seg: torch.Tensor
    pad: torch.Tensor
    last_pad: torch.Tensor
    prefix: torch.Tensor
    pos_q: torch.Tensor
    seg_q: torch.Tensor
    tiles: Optional[torch.Tensor] = None
    route: str = "packed"


def packed_meta(attn_meta, q_positions=None) -> Optional[PackedMeta]:
    """(route, seg, pad, last_pad, prefix) -> :class:`PackedMeta`: of a
    self-attention forward over the metadata's rows, or, with
    ``q_positions`` [B, Q], of Q query rows at those kv positions (the
    prefix-cached forward of the fresh rows).  None and a
    :class:`PackedMeta` pass through."""
    if attn_meta is None or isinstance(attn_meta, PackedMeta):
        return attn_meta
    route, seg, pad, last_pad, prefix = attn_meta
    if check_route(route) == "dense":
        raise ValueError("the dense route takes attn_meta=None")
    B, S = seg.shape
    meta = span_meta(seg, pad, last_pad, prefix, B, S, seg.device)
    if route == "trainable":
        if q_positions is not None:
            raise ValueError("the trainable route is self-attention: it "
                             "takes no q_positions (no prefix cache)")
        return PackedMeta(*meta, None, None, None, route)
    if q_positions is None:
        q_positions = torch.arange(S, device=seg.device)
    pos_q, seg_q = q_rows(meta[0], q_positions, B,
                          torch.atleast_2d(q_positions).shape[1])
    tiles = None
    if seg.is_cuda:
        make = streaming_tile_map if route == "streaming" else rows_tile_map
        tiles = make(*meta, pos_q, seg_q)
    return PackedMeta(*meta, pos_q, seg_q, tiles, route)


@dataclasses.dataclass
class Qwen2KVCache:
    """Per-layer K/V [L, B, S_max, Hkv, Dh] (roped K), written in place by
    :meth:`Qwen2.forward`; ``length`` the rows written at the shared
    offset so far (the per-row path leaves it alone)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def zeros(cls, cfg: "Qwen2Config", batch: int, max_len: int,
              dtype=torch.float32, device=None) -> "Qwen2KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cache_rows(offsets: torch.Tensor, rows: int):
    """(batch index [B, 1], row index [B, rows]) of ``rows`` fresh rows at
    per-row cache offsets [B]: the index of an in-place write of fresh K/V
    into a [B, S_max, ...] cache.  It does not change between layers or
    steps, so a generate makes it once (no host sync)."""
    b = torch.arange(offsets.shape[0], device=offsets.device)[:, None]
    return b, offsets[:, None].long() + torch.arange(rows,
                                                     device=offsets.device)


def write_rows(cache: torch.Tensor, fresh: torch.Tensor, rows) -> None:
    """cache [B, S_max, ...] <- fresh [B, S, ...] at ``rows`` (a
    :func:`cache_rows` pair, or an int: the same offset for every row)."""
    if isinstance(rows, int):
        cache[:, rows:rows + fresh.shape[1]] = fresh
    else:
        cache[rows] = fresh.to(cache.dtype)


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
    """q [B, Q, H, Dh]; k, v [B, S, Hkv, Dh] (views are fine; S = Q but for
    the prefix-cached rows); bias [B, 1, Q, S] additive.  Returns
    [B, Q, H*Dh].

    With ``meta`` its route's omni kernel recomputes the mask from it (the
    bias is unused): ``packed`` on the [B, *, H*Dh] layout, ``streaming``
    on head-major views, ``trainable`` the differentiable packed kernels
    (self-attention: Q == S).  Otherwise the dense path: the kv-head groups
    folded into the einsum (no repeated K/V), scores in ``softmax_dtype``
    from the products of the stored operands (``phi.qk_scores``),
    softmax, probabilities cast to v's dtype."""
    B, Q, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if meta is not None:
        rows = dict(q_positions=meta.pos_q, seg_q=meta.seg_q,
                    tiles=meta.tiles)
        m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
        if meta.route == "trainable":
            if Q != S:
                raise ValueError("the trainable route is self-attention: "
                                 f"{Q} q rows against {S} keys")
            return omni_attention_packed_trainable(
                q.reshape(B, Q, H * Dh), k.reshape(B, S, Hkv * Dh),
                v.reshape(B, S, Hkv * Dh), *m, num_heads=H,
                num_kv_heads=Hkv)
        if meta.route == "streaming":
            out = omni_attention_streaming(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), *m,
                **rows)
            return out.transpose(1, 2).reshape(B, Q, H * Dh)
        return omni_attention_packed(
            q.reshape(B, Q, H * Dh), k.reshape(B, S, Hkv * Dh),
            v.reshape(B, S, Hkv * Dh), *m, num_heads=H, num_kv_heads=Hkv,
            **rows)
    qg = q.reshape(B, Q, Hkv, H // Hkv, Dh)
    with torch.autocast(q.device.type, enabled=False):
        scores = qk_scores("bqhgd,bkhd->bhgqk", qg, k,
                           softmax_dtype) / math.sqrt(Dh)
        if bias is not None:
            scores = scores + bias[:, :, None].to(softmax_dtype)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Q, H * Dh)


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
    matmul after :func:`fuse_attention_mlp`.  gate / up (or ``gu``) are
    tagged ``fc1_out`` for the remat policies (``utils/remat.py``);
    ``tail``: the output joins only the residual sum (Qwen's layer, not
    the DiT's, whose gate multiplies it)."""

    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(dim, hidden, **kw)
        self.up_proj = nn.Linear(dim, hidden, **kw)
        self.down_proj = nn.Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor, tail: bool = False) -> torch.Tensor:
        if hasattr(self, "gu"):
            gate, up = project(self.gu, x, "fc1_out").chunk(2, dim=-1)
        else:
            gate, up = (project(p, x, "fc1_out")
                        for p in (self.gate_proj, self.up_proj))
        return project(self.down_proj, F.silu(gate) * up, tail=tail)


def qkv_heads(attn: nn.Module, x: torch.Tensor, heads: int, kv_heads: int,
              head_dim: int):
    """(q [B, S, H, Dh], k, v [B, S, Hkv, Dh]) from separate projections
    or the fused ``qkv`` (then views of its output), tagged ``qkv_out``."""
    B, S, _ = x.shape
    if hasattr(attn, "qkv"):
        q, k, v = project(attn.qkv, x, "qkv_out").split(
            [heads * head_dim, kv_heads * head_dim, kv_heads * head_dim],
            dim=-1)
    else:
        q, k, v = (project(p, x, "qkv_out")
                   for p in (attn.q_proj, attn.k_proj, attn.v_proj))
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

    def forward(self, h, bias, cos, sin, meta: Optional[PackedMeta] = None,
                cache_kv=None, rows=None):
        """cache_kv: this layer's (k, v) cache [B, S_max, Hkv, Dh]; the
        fresh rows' K/V are written at ``rows`` (:func:`write_rows`) and
        the q rows attend to every cached key."""
        cfg = self.cfg
        q, k, v = qkv_heads(self.self_attn, self.input_layernorm(h),
                            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if cache_kv is not None:
            write_rows(cache_kv[0], k, rows)
            write_rows(cache_kv[1], v, rows)
            k, v = cache_kv
        attn = keep("attn_out", gqa_attention(
            q, k, v, bias, meta,
            softmax_dtype=torch.float32 if cfg.attn_fp32
            else torch.bfloat16))
        h = h + project(self.self_attn.o_proj, attn)
        return h + self.mlp(self.post_attention_layernorm(h), tail=True)


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
    ``qwen2_forward``."""

    def __init__(self, cfg: Qwen2Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen2Model(cfg, device, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, device=device, dtype=dtype)

    def forward(self, input_ids=None, input_embeds=None, attention_bias=None,
                position_ids=None, attn_meta=None, logits: bool = True,
                cache: Optional[Qwen2KVCache] = None, cache_offsets=None,
                remat=False):
        """Returns (logits or None, last hidden state after the final norm).

        attention_bias: [B, 1, S, S] additive mask (the dense route; [B, 1,
        S, S_max] with a cache).  attn_meta: optional ``(route, seg, pad,
        last_pad, prefix)``, or a :class:`PackedMeta` already computed (it
        must be, with per-row cache offsets: its q rows are the fresh
        rows), sending every layer's attention to the route's omni kernel.
        ``logits=False`` skips the vocabulary projection (the velocity path
        reads only the hidden state); the projection is ``lm_head`` where
        the model has one (untied, or int8 after :func:`quantize_int8`),
        else the tied embedding.

        cache: the fresh rows' K/V are written into it in place, at
        ``cache.length`` (which then grows by S) or, with
        ``cache_offsets`` ([B] tensor, or the pair of :func:`cache_rows`
        made once), at each row's own offset; position_ids must then be
        given.  The q rows attend to all S_max cached rows.

        remat: the layer policy of ``utils/remat.py`` (tags ``qkv_out``
        on q / k / v, ``attn_out`` on the attention's output, ``fc1_out``
        on gate / up)."""
        cfg = self.cfg
        if input_embeds is None:
            input_embeds = self.model.embed_tokens(input_ids)
        B, S, _ = input_embeds.shape
        rows = None
        if cache is not None:
            rows = cache.length
            if cache_offsets is not None:
                rows = (cache_rows(cache_offsets, S)
                        if torch.is_tensor(cache_offsets) else cache_offsets)
            elif position_ids is None:
                position_ids = rows + torch.arange(
                    S, device=input_embeds.device)[None]
        if position_ids is None:
            position_ids = torch.arange(S, device=input_embeds.device)[None]
        cos, sin = rope_tables(position_ids, cfg.head_dim, cfg.rope_theta)
        meta = packed_meta(attn_meta)
        h = input_embeds
        for i, layer in enumerate(self.model.layers):
            kv = None if cache is None else (cache.k[i], cache.v[i])
            h = wrap_remat(layer, remat)(h, attention_bias, cos, sin, meta,
                                         kv, rows)
        if cache is not None and cache_offsets is None:
            cache.length += S
        h = self.model.norm(h)
        if not logits:
            return None, h
        if hasattr(self, "lm_head"):
            return self.lm_head(h), h
        return F.linear(h, self.model.embed_tokens.weight), h


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


# the matmuls quantize_int8 converts, by their place in a layer (JAX names:
# q, k, v, qkv, o, gate, up, down, gu; JAX ``_QUANT_KERNELS``)
INT8_LINEARS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                "v": "self_attn.v_proj", "qkv": "self_attn.qkv",
                "o": "self_attn.o_proj", "gate": "mlp.gate_proj",
                "up": "mlp.up_proj", "down": "mlp.down_proj", "gu": "mlp.gu"}


@torch.no_grad()
def quantize_int8(model: Qwen2) -> Qwen2:
    """Weight-only int8 serving (JAX ``quantize_int8``): every matmul of
    each layer, in the plain or the fused layout, becomes an
    ``Int8Linear`` (q / k / v and qkv keep their biases; o, gate / up / gu
    and down have none), and the vocabulary head too: ``lm_head`` where it
    is untied, else one quantized from the embedding table (``embed.T``),
    so that decode streams an int8 head while the input gather keeps the
    table.  Norms and the embedding stay as they are.  In place; a matmul
    already quantized is left alone."""
    from showo_tpu_torch.models.phi import Int8Linear

    for layer in model.model.layers:
        for path in INT8_LINEARS.values():
            parent, _, name = path.rpartition(".")
            owner = layer.get_submodule(parent)
            lin = getattr(owner, name, None)
            if isinstance(lin, nn.Linear):
                setattr(owner, name, Int8Linear.from_linear(lin))
    head = getattr(model, "lm_head", None)
    if head is None:
        model.lm_head = Int8Linear.from_weight(
            model.model.embed_tokens.weight)
    elif isinstance(head, nn.Linear):
        model.lm_head = Int8Linear.from_linear(head)
    return model
