"""Chunk-local fresh-KV decode for the serving engine, and the int8 KV cache.

Counterpart of ``showo_tpu/serving/decode_chunk.py``.  Within a decode
chunk the big cache [L, slots, cap, H, Dh] is read-only:

  * each step's fresh K/V rows go to a side buffer [L, slots, Fcap, H, Dh]
    at the lane's chunk-relative offset (``lens - lens0``);
  * each layer computes two score blocks, one of the query rows against
    the big cache (masked at the chunk-start lengths ``lens0``) and one
    against the fresh rows j <= i, and concatenates them before one
    softmax, so the probability mass is over exactly the logit set of a
    step against the whole cache;
  * the side buffer is scattered into the cache once per chunk, at each
    lane's chunk-start length (one ``index_put_``).

A window of W rows (W = 1 for plain decode, 1 + draft_k on the speculative
path) sits at positions ``lens .. lens + W - 1``.  Idle lanes, pinned to
length 0 by the engine, write rows that a later admission's prefill
overwrites and whose bias never exposes.

The int8 KV cache is a pair (int8 data [..., h, Dh], fp32 per-row-per-head
absmax scales [..., h]).  It is never dequantized: the K scale multiplies
the scores after the q . k dot, the V scale folds into the probabilities
before the p . v dot.

The layer bodies use the models' own modules (``models/phi.py``,
``show_o2/qwen2.py``): every projection is the model's ``nn.Linear`` or,
under weight-only int8, its ``Int8Linear`` (the int8 kernel on the card),
at M = slots x W rows.  Attention is plain PyTorch, as JAX's is einsums
here.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from showo_tpu_torch.models.phi import (apply_rope, head_layer_norm,
                                        lane_rows, layer_norm, rope_tables)
from showo_tpu_torch.ops.masks import NEG_INF


def kv_quantize(x: torch.Tensor):
    """[..., h, Dh] -> (int8 rounded half to even, fp32 absmax / 127
    scales [..., h])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp(min=1e-8)[..., None])
    return q.to(torch.int8), scale


def kv_cache_zeros(shape, int8: bool, dtype, device=None):
    """A zero cache of ``shape`` [L, slots, cap, h, Dh]: a tensor in
    ``dtype``, or with ``int8`` the (data, scales) pair."""
    if int8:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_cache_write(cache, rows: torch.Tensor, slot: int) -> None:
    """Write ``rows`` [L, 1, S, h, Dh] into lane ``slot`` of the cache at
    positions 0 .. S-1, in place (quantized for an int8 pair)."""
    S = rows.shape[2]
    if isinstance(cache, tuple):
        q, s = kv_quantize(rows[:, 0])
        cache[0][:, slot, :S] = q
        cache[1][:, slot, :S] = s
    else:
        cache[:, slot, :S] = rows[:, 0].to(cache.dtype)


def scatter_fresh(cache_k, cache_v, fk: torch.Tensor, fv: torch.Tensor,
                  lens0: torch.Tensor) -> None:
    """Scatter the side buffers [L, slots, Fcap, h, Dh] into the caches at
    each lane's chunk-start length ``lens0`` [slots], in place.  Rows past
    a lane's final length are never exposed and are overwritten later.

    The engine admits a request only when its budget and the chunk margin
    fit the cap, so ``lens0 + Fcap <= cap`` for every active lane; where
    it does not hold (an idle lane) the start is clamped as JAX's
    ``dynamic_update_slice`` clamps it.  An int8 pair gets the buffers
    quantized here, once per chunk."""
    slots, Fcap = fk.shape[1], fk.shape[2]
    cache = cache_k[0] if isinstance(cache_k, tuple) else cache_k
    b = torch.arange(slots, device=fk.device)[:, None]
    rows = lane_rows(lens0, Fcap, cache.shape[2])
    for c, f in ((cache_k, fk), (cache_v, fv)):
        if isinstance(c, tuple):
            q, s = kv_quantize(f)
            c[0][:, b, rows] = q
            c[1][:, b, rows] = s
        else:
            c[:, b, rows] = f.to(c.dtype)


def _layer_cache(cache, i: int):
    """Layer ``i`` of a cache tensor or int8 pair."""
    if isinstance(cache, tuple):
        return cache[0][i], cache[1][i]
    return cache[i]


def two_block_attention(qg, ck, cv, fk, fv, big_bias, fresh_bias, scale,
                        sdt, out_dtype):
    """Attention of q rows against [cache | fresh] in one softmax.

    qg [B, W, Hkv, G, Dh] (G q heads of each kv head; 1 without GQA);
    ck / cv: the layer's cache [B, cap, Hkv, Dh] or its int8 pair; fk / fv
    the side buffer [B, Fcap, Hkv, Dh]; biases broadcast to [B, Hkv, G,
    W, cap] and [.., Fcap].  Scores in ``sdt`` from exact products,
    times ``scale``; the int8 K scales multiply the cache scores, the V
    scales the cache probabilities.  Returns [B, W, Hkv * G * Dh] in
    ``out_dtype``."""
    B, W = qg.shape[:2]
    cap = (ck[0] if isinstance(ck, tuple) else ck).shape[1]
    q = qg.to(sdt)
    with torch.autocast(qg.device.type, enabled=False):
        if isinstance(ck, tuple):
            (ckq, cks), (cvq, cvs) = ck, cv
            s1 = torch.einsum("bqhgd,bkhd->bhgqk", q, ckq.to(sdt)) * scale
            s1 = s1 * cks.transpose(1, 2)[:, :, None, None, :].to(sdt)
        else:
            s1 = torch.einsum("bqhgd,bkhd->bhgqk", q, ck.to(sdt)) * scale
        s2 = torch.einsum("bqhgd,bkhd->bhgqk", q, fk.to(sdt)) * scale
        s = torch.cat([s1 + big_bias.to(sdt), s2 + fresh_bias.to(sdt)],
                      dim=-1)
        pr = torch.softmax(s, dim=-1)
        if isinstance(cv, tuple):
            pr_big = (pr[..., :cap] * cvs.transpose(1, 2)[
                :, :, None, None, :].to(pr.dtype)).to(out_dtype)
            big = torch.einsum("bhgqk,bkhd->bqhgd", pr_big,
                               cvq.to(out_dtype))
        else:
            big = torch.einsum("bhgqk,bkhd->bqhgd",
                               pr[..., :cap].to(cv.dtype), cv)
        fresh = torch.einsum("bhgqk,bkhd->bqhgd", pr[..., cap:].to(fv.dtype),
                             fv)
        out = big.float() + fresh.float()
    return out.to(out_dtype).reshape(B, W, -1)


def _biases(lens0, lens, W: int, cap: int, Fcap: int, dtype):
    """(big [B, 1, 1, 1, cap], fresh [B, 1, 1, W, Fcap]) additive biases of
    a window at ``lens``: cache columns below ``lens0``, fresh rows j <=
    (lens - lens0) + r for row r."""
    dev = lens.device
    off = (lens - lens0)[:, None, None, None, None]
    kpos = torch.arange(cap, device=dev)
    big = torch.where(kpos < lens0[:, None, None, None, None], 0.0,
                      NEG_INF).to(dtype)
    jpos = torch.arange(Fcap, device=dev)
    r = torch.arange(W, device=dev)[:, None]
    fresh = torch.where(jpos < off + r + 1, 0.0, NEG_INF).to(dtype)
    return big, fresh


def _write_fresh(f: torch.Tensor, x: torch.Tensor, rows: torch.Tensor):
    """side buffer layer [B, Fcap, h, Dh] <- x [B, W, h, Dh] at rows [B, W]."""
    b = torch.arange(f.shape[0], device=f.device)[:, None]
    f[b, rows] = x.to(f.dtype)


def make_v1_window_forward(phi, *, slots: int, cap: int, Fcap: int):
    """Chunk-local forward over a token window for the v1 (Phi) tower.

    Returns (fwd, fresh_shape):
      fwd(window [slots, W] ids, lens0 [slots], lens [slots], cache_k,
          cache_v, fk, fv) -> logits [slots, W, V]
    fk / fv (``fresh_shape``) get the window's K/V in place.  Row r of the
    window sits at position lens + r; it sees cache columns < lens0 and
    fresh rows j <= (lens - lens0) + r.  Every lane needs lens - lens0 + W
    <= Fcap (the engine's chunk accounting).  The layer body covers the
    plain, ``fuse_qkv`` and ``fuse_parallel_mlp`` layouts, bf16 or int8
    weights (``models/phi.py``)."""
    cfg = phi.cfg
    H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    fresh_shape = (cfg.num_layers, slots, Fcap, H, Dh)
    scale = 1.0 / (Dh ** 0.5)

    def fwd(window, lens0, lens, cache_k, cache_v, fk, fv):
        W = window.shape[1]
        h = phi.model.embed_tokens(window)
        sdt = torch.float32 if cfg.attn_fp32 else h.dtype
        pos = lens[:, None] + torch.arange(W, device=lens.device)
        cos, sin = rope_tables(pos, cfg.rotary_dim, cfg.rope_theta)
        big, fresh = _biases(lens0, lens, W, cap, Fcap, h.dtype)
        rows = lane_rows(lens - lens0, W, Fcap)
        for i, layer in enumerate(phi.model.layers):
            x = layer_norm(h, layer.input_layernorm)
            q, k, v, mlp_pre = layer._qkv_mlp(x)
            a = layer.self_attn
            q = head_layer_norm(q, a.q_layernorm, Dh)
            k = head_layer_norm(k, a.k_layernorm, Dh)
            v = v.reshape(slots, W, H, Dh)
            q, k = apply_rope(q, k, cos, sin, cfg.rotary_dim)
            _write_fresh(fk[i], k, rows)
            _write_fresh(fv[i], v, rows)
            attn = two_block_attention(
                q[:, :, :, None], _layer_cache(cache_k, i),
                _layer_cache(cache_v, i), fk[i], fv[i], big, fresh, scale,
                sdt, h.dtype)
            h = layer.project_out(h, attn, mlp_pre)
        h = layer_norm(h, phi.model.final_layernorm)
        return phi.lm_head(h)

    return fwd, fresh_shape


def qwen_logits(qwen, h: torch.Tensor) -> torch.Tensor:
    """Qwen2's vocabulary projection of normed hidden rows: ``lm_head``
    where the model has one (untied, or int8 after ``quantize_int8``),
    else the tied embedding (``Qwen2.forward``'s)."""
    if hasattr(qwen, "lm_head"):
        return qwen.lm_head(h)
    return torch.nn.functional.linear(h, qwen.model.embed_tokens.weight)


def make_v2_window_forward(qwen, *, slots: int, cap: int, Fcap: int):
    """The same for the v2 (Qwen2, GQA) tower: full-head RoPE, RMSNorm,
    the q heads of each kv head folded into the score einsum; the head is
    ``lm_head`` where the model has one (untied, or int8 after
    ``quantize_int8``), else the tied embedding.  Decode rows sit after
    every image span, so they are purely causal."""
    from showo_tpu_torch.show_o2.qwen2 import (apply_rope as rope_full,
                                               qkv_heads)
    from showo_tpu_torch.show_o2.qwen2 import rope_tables as rope_tables_v2

    cfg = qwen.cfg
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fresh_shape = (cfg.num_layers, slots, Fcap, Hkv, Dh)
    scale = 1.0 / math.sqrt(Dh)

    def fwd(window, lens0, lens, cache_k, cache_v, fk, fv):
        W = window.shape[1]
        h = qwen.model.embed_tokens(window)
        sdt = torch.float32 if cfg.attn_fp32 else h.dtype
        pos = lens[:, None] + torch.arange(W, device=lens.device)
        cos, sin = rope_tables_v2(pos, Dh, cfg.rope_theta)
        big, fresh = _biases(lens0, lens, W, cap, Fcap, torch.float32)
        rows = lane_rows(lens - lens0, W, Fcap)
        for i, layer in enumerate(qwen.model.layers):
            q, k, v = qkv_heads(layer.self_attn, layer.input_layernorm(h),
                                H, Hkv, Dh)
            q, k = rope_full(q, cos, sin), rope_full(k, cos, sin)
            _write_fresh(fk[i], k, rows)
            _write_fresh(fv[i], v, rows)
            attn = two_block_attention(
                q.reshape(slots, W, Hkv, H // Hkv, Dh),
                _layer_cache(cache_k, i), _layer_cache(cache_v, i), fk[i],
                fv[i], big, fresh, scale, sdt, h.dtype)
            h = h + layer.self_attn.o_proj(attn)
            h = h + layer.mlp(layer.post_attention_layernorm(h))
        return qwen_logits(qwen, qwen.model.norm(h))

    return fwd, fresh_shape


def _decode_chunk(fwd, fresh_shape, *, chunk: int, dtype,
                  sample: Callable):
    """The engine's plain decode chunk over a window forward with W = 1:
    step i's row sits at lengths + i and writes fresh row i; one scatter at
    the end."""

    def decode_chunk(cache_k, cache_v, lengths, tok, generator):
        dev = lengths.device
        fk = torch.zeros(fresh_shape, dtype=dtype, device=dev)
        fv = torch.zeros(fresh_shape, dtype=dtype, device=dev)
        toks = []
        for i in range(chunk):
            logits = fwd(tok[:, None], lengths, lengths + i, cache_k,
                         cache_v, fk, fv)
            tok = sample(logits[:, -1], generator)
            toks.append(tok)
        scatter_fresh(cache_k, cache_v, fk, fv, lengths)
        toks = torch.stack(toks)                         # [chunk, slots]
        return (lengths + chunk, tok, toks[..., None],
                torch.ones_like(toks, dtype=torch.int32))

    return decode_chunk


def build_v1_decode_chunk(phi, *, cap: int, chunk: int, slots: int,
                          sample: Callable):
    """The engine's decode chunk for ShowoMMUServer:
    fn(cache_k, cache_v, lengths [slots] int32, tok [slots], generator) ->
    (lengths + chunk, cur, toks [chunk, slots, 1], nvalid [chunk, slots]);
    the caches are updated in place, the side buffers are in the model's
    dtype.  ``sample``: fn(logits [slots, V], generator) -> ids
    (``sampling/ar.py::sampler``)."""
    fwd, fresh_shape = make_v1_window_forward(phi, slots=slots, cap=cap,
                                              Fcap=chunk)
    return _decode_chunk(fwd, fresh_shape, chunk=chunk,
                         dtype=phi.model.embed_tokens.weight.dtype,
                         sample=sample)


def build_v2_decode_chunk(qwen, *, cap: int, chunk: int, slots: int,
                          sample: Callable):
    """The v2 analog of :func:`build_v1_decode_chunk` for
    Showo2MMUServer."""
    fwd, fresh_shape = make_v2_window_forward(qwen, slots=slots, cap=cap,
                                              Fcap=chunk)
    return _decode_chunk(fwd, fresh_shape, chunk=chunk,
                         dtype=qwen.model.embed_tokens.weight.dtype,
                         sample=sample)
