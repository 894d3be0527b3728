"""Fused admission: prefill a new request inside one decode step.

Counterpart of ``showo_tpu/serving/fused_admit.py``.  Admitting a request
with a standalone prefill stalls every decode lane for its duration.
Chunked prefill is unsound for Show-o's layout (the image span attends
bidirectionally, so a prompt row's K/V depends on later rows of the same
span), but the whole prefill can ride one decode step:

  * every row-wise op (the norms, the projections, qk-LN, RoPE, GELU) is
    blind to which row is which, so the decode lanes' ``slots`` rows and
    the prompt's ``bucket`` rows form one [slots + bucket, D] row block
    for every matmul: one weight stream (one int8 kernel launch a
    product under int8) instead of two;
  * only attention differs: decode rows attend to their own lane's cache,
    prefill rows within the padded prompt under the omni mask, so the two
    attentions stay separate and are the math of the two programs;
  * the admitted lane is idle (length 0) during its admission step: the
    decode half writes a row at its position 0, which the prefill half
    then overwrites with the prompt's rows.

The result is the tokens of (prefill; one decode step) run in turn.  The
engine uses this step when at least one lane is mid-decode; an admission
into an idle engine takes the plain prefill.  v1 needs the
``fuse_parallel_mlp`` layout (``win`` / ``wout``); int8 weights ride
through the model's ``Int8Linear`` modules.
"""

from __future__ import annotations

from typing import Callable

import torch

from showo_tpu_torch.models.phi import (_cache_scatter, apply_rope, attention,
                                        head_layer_norm, layer_norm,
                                        rope_tables)
from showo_tpu_torch.ops.masks import NEG_INF, omni_mask_mmu
from showo_tpu_torch.serving.decode_chunk import qwen_logits


def _finish(logits, lengths, cur_tok, slot: int, sample: Callable,
            generator):
    """(cur', decode tokens [slots], tok0) from the slots + 1 logit rows:
    lanes of length 0 (idle, and the admitted one) keep their token, the
    admitted lane gets tok0."""
    slots = lengths.shape[0]
    nxt = sample(logits[:slots], generator)
    tok0 = sample(logits[slots:], generator)[0]
    cur = torch.where(lengths > 0, nxt, cur_tok.long())
    cur[slot] = tok0
    return cur, nxt, tok0


def _decode_bias(lengths, cap: int, dtype):
    """[slots, 1, 1, cap]: each lane's columns up to its fresh row."""
    kpos = torch.arange(cap, device=lengths.device)
    return torch.where(kpos < lengths[:, None, None, None] + 1, 0.0,
                       NEG_INF).to(dtype)


def _prefill_bias(bias, true_len: int):
    """The prompt's mask with the padded columns hidden."""
    cols = torch.arange(bias.shape[-1], device=bias.device)
    return torch.where(cols < true_len, bias, NEG_INF)


def build_v1_fused_admit(server, *, eoi: int, cap: int, sample: Callable):
    """fused_admit_for(bucket) -> fn(cache_k, cache_v, lengths [slots],
    cur_tok [slots], padded [1, bucket] ids, true_len, slot, generator) ->
    (cur_tok', decode tokens [slots], tok0).  The caches are updated in
    place: one decode step for every lane (the lanes of length 0 write
    rows never exposed) and the prompt's K/V into lane ``slot``."""
    phi = server.phi
    cfg = phi.cfg
    H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    if not hasattr(phi.model.layers[0], "win"):
        raise ValueError("fused admission needs the fuse_parallel_mlp "
                         "layout (win / wout)")

    def make(bucket: int):
        def fused(cache_k, cache_v, lengths, cur_tok, padded, true_len: int,
                  slot: int, generator):
            slots = lengths.shape[0]
            dev = lengths.device
            embed = phi.model.embed_tokens
            h = torch.cat([embed(cur_tok.long()), embed(padded[0].long())]
                          )[None]                           # [1, N, D]
            dtype = h.dtype
            N = h.shape[1]
            positions = torch.cat([lengths.long(),
                                   torch.arange(bucket, device=dev)])
            cos, sin = rope_tables(positions[None], cfg.rotary_dim,
                                   cfg.rope_theta)
            dec_bias = _decode_bias(lengths, cap, dtype)
            pre_bias = _prefill_bias(
                omni_mask_mmu(padded, eoi_id=eoi, dtype=dtype), true_len)
            sdt = torch.float32 if cfg.attn_fp32 else dtype
            for i, layer in enumerate(phi.model.layers):
                x = layer_norm(h, layer.input_layernorm)
                q, k, v, mlp_pre = layer._qkv_mlp(x)
                a = layer.self_attn
                q = head_layer_norm(q, a.q_layernorm, Dh)
                k = head_layer_norm(k, a.k_layernorm, Dh)
                v = v.reshape(1, N, H, Dh)
                q, k = apply_rope(q, k, cos, sin, cfg.rotary_dim)
                ck, cv = cache_k[i], cache_v[i]     # [slots, cap, H, Dh]
                # decode rows: one a lane, against the lane's cache
                _cache_scatter(ck, cv, k[0, :slots, None], v[0, :slots, None],
                               lengths)
                attn_d = attention(q[0, :slots, None], ck, cv, dec_bias,
                                   softmax_dtype=sdt)
                # prefill rows: among themselves under the omni mask, then
                # into the admitted lane (over the decode half's row 0)
                kp, vp = k[:, slots:], v[:, slots:]
                attn_p = attention(q[:, slots:], kp, vp, pre_bias,
                                   softmax_dtype=sdt)
                ck[slot, :bucket] = kp[0].to(ck.dtype)
                cv[slot, :bucket] = vp[0].to(cv.dtype)
                attn = torch.cat([attn_d.reshape(slots, D),
                                  attn_p.reshape(bucket, D)])[None]
                h = layer.project_out(h, attn, mlp_pre)
            h = layer_norm(h[0], phi.model.final_layernorm)
            rows = torch.cat([h[:slots], h[slots + true_len - 1][None]])
            return _finish(phi.lm_head(rows), lengths, cur_tok, slot, sample,
                           generator)

        return fused

    return make


def build_v2_fused_admit(server, *, n_img: int, cap: int, sample: Callable):
    """The Show-o2 analog: the prompt arrives as assembled embeddings
    [1, bucket, D] with its image span at ``img_start`` (meta).  Qwen2's
    layer is sequential-residual, but every matmul (qkv, o, gate-up, down,
    the head) is row-wise, so decode and prefill rows share each one and
    only the two GQA attentions split.  fn(..., generator, img_start) ->
    as :func:`build_v1_fused_admit`."""
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.show_o2.qwen2 import (apply_rope as rope_full,
                                               gqa_attention, qkv_heads)
    from showo_tpu_torch.show_o2.qwen2 import rope_tables as rope_tables_v2

    qwen = server.qwen
    cfg = qwen.cfg
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def make(bucket: int):
        def fused(cache_k, cache_v, lengths, cur_tok, padded_emb,
                  true_len: int, slot: int, generator, img_start: int):
            slots = lengths.shape[0]
            dev = lengths.device
            dec = qwen.model.embed_tokens(cur_tok.long())
            h = torch.cat([dec, padded_emb[0].to(dec.dtype)])[None]
            sdt = torch.float32 if cfg.attn_fp32 else h.dtype
            positions = torch.cat([lengths.long(),
                                   torch.arange(bucket, device=dev)])
            cos, sin = rope_tables_v2(positions[None], Dh, cfg.rope_theta)
            dec_bias = _decode_bias(lengths, cap, h.dtype)
            mp = torch.empty((1, 1, 2), dtype=torch.long, device=dev)
            mp[..., 0], mp[..., 1] = img_start, n_img
            pre_bias = _prefill_bias(omni_attn_mask(mp, bucket, dtype=h.dtype),
                                     true_len)
            for i, layer in enumerate(qwen.model.layers):
                q, k, v = qkv_heads(layer.self_attn, layer.input_layernorm(h),
                                    H, Hkv, Dh)
                q, k = rope_full(q, cos, sin), rope_full(k, cos, sin)
                ck, cv = cache_k[i], cache_v[i]   # [slots, cap, Hkv, Dh]
                _cache_scatter(ck, cv, k[0, :slots, None], v[0, :slots, None],
                               lengths)
                attn_d = gqa_attention(q[0, :slots, None], ck, cv, dec_bias,
                                       None, softmax_dtype=sdt)
                kp, vp = k[:, slots:], v[:, slots:]
                attn_p = gqa_attention(q[:, slots:], kp, vp, pre_bias, None,
                                       softmax_dtype=sdt)
                ck[slot, :bucket] = kp[0].to(ck.dtype)
                cv[slot, :bucket] = vp[0].to(cv.dtype)
                attn = torch.cat([attn_d.reshape(slots, H * Dh),
                                  attn_p.reshape(bucket, H * Dh)])[None]
                h = h + layer.self_attn.o_proj(attn)
                h = h + layer.mlp(layer.post_attention_layernorm(h))
            h = qwen.model.norm(h[0])
            rows = torch.cat([h[:slots], h[slots + true_len - 1][None]])
            return _finish(qwen_logits(qwen, rows), lengths, cur_tok, slot,
                           sample, generator)

        return fused

    return make
