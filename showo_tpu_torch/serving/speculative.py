"""Speculative decoding for the serving engine: prompt-lookup drafting.

Counterpart of ``showo_tpu/serving/speculative.py``.  Decode streams every
layer's weights for one row per lane, so verifying K drafted tokens in one
(K + 1)-row forward reuses the same weight reads.  Drafts come from the
lane's own context (prompt lookup: the latest earlier occurrence of the
last bigram, else of the last token), kept in a device token ring
``buf`` [slots, cap]: positions 0 .. len hold the prompt and the accepted
tokens with ``buf[len]`` the token to feed next; positions of unknown ids
(the v2 image span, text the caller did not give) hold -1, which no
sampled token equals.

Two verify rules:
  * greedy (top_k = 1): accept the longest draft prefix the argmax agrees
    with, then the model's own next token: the same tokens as plain greedy
    decode;
  * sampling: rejection resampling (Leviathan et al. 2023) for a
    point-mass draft: accept draft x with probability p(x) under the
    filtered softmax; at the first rejection sample from p with x masked
    out; after K acceptances sample the bonus token from p_K.  Every
    emitted token is a draw from the filtered softmax that plain sampling
    uses.

A fixed draft length keeps every shape static; lanes advance by their own
accepted count, so the chunk-local program writes each step's window at
the lane's chunk-relative offset.  Nothing here syncs with the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from showo_tpu_torch.models.phi import lane_rows
from showo_tpu_torch.ops.masks import NEG_INF
from showo_tpu_torch.sampling.ar import filter_logits, gumbel
from showo_tpu_torch.serving.decode_chunk import scatter_fresh


def verify_greedy(logits, draft, generator=None):
    """logits [slots, K+1, V], draft [slots, K] -> (out [slots, K+1],
    m [slots]): lane s emits out[s, :m[s] + 1], the accepted draft prefix
    and the model's own next token."""
    K = draft.shape[1]
    nxt = torch.argmax(logits, dim=-1)
    acc = torch.cumprod((nxt[:, :K] == draft).long(), dim=1)
    return nxt, acc.sum(dim=1)


def make_verify_sample(temperature: float, top_k: Optional[int],
                       top_p: Optional[float]) -> Callable:
    """Rejection-resampling verify for point-mass drafts:
    fn(logits [slots, K+1, V], draft [slots, K], generator) -> (out, m) as
    :func:`verify_greedy`.  Categorical draws are Gumbel-max with noise
    from the generator."""

    def verify(logits, draft, generator):
        K = draft.shape[1]
        flog = filter_logits(logits.float(), temperature, top_k, top_p)
        p = torch.softmax(flog, dim=-1)                   # [slots, K+1, V]
        u = torch.rand(draft.shape, generator=generator, device=p.device)
        # a -1 draft (an unknown id of the ring) has probability 0: it is
        # always rejected and masks nothing, so it is never emitted
        known = draft >= 0
        safe = draft.long().clamp(min=0)[..., None]
        p_draft = torch.where(
            known, torch.gather(p[:, :K], -1, safe)[..., 0], 0.0)
        acc = torch.cumprod((u < p_draft).long(), dim=1)
        m = acc.sum(dim=1)                                # 0..K
        # the residual at each draft position: p with the drafted token
        # masked out (never chosen where the position accepted)
        rlog = flog[:, :K]
        rlog = torch.where(known[..., None], rlog.scatter(-1, safe, -torch.inf),
                           rlog)
        resamp = torch.argmax(rlog + gumbel(rlog.shape, generator, p.device),
                              dim=-1)                     # [slots, K]
        bonus = torch.argmax(
            flog[:, K] + gumbel(flog[:, K].shape, generator, p.device),
            dim=-1)
        ridx = m.clamp(max=K - 1)
        chosen = torch.where(m < K, torch.gather(resamp, 1, ridx[:, None])
                             [:, 0], bonus)
        ar = torch.arange(K + 1, device=p.device)[None, :]
        d1 = torch.cat([draft.long(), torch.zeros_like(draft[:, :1]).long()],
                       dim=1)
        out = torch.where(ar < m[:, None], d1,
                          torch.where(ar == m[:, None], chosen[:, None], 0))
        return out, m

    return verify


def pick_verify(temperature: float, top_k, top_p) -> Callable:
    """:func:`verify_greedy` for greedy sampling, else
    :func:`make_verify_sample`."""
    greedy = top_k == 1 and (top_p is None or top_p >= 1.0)
    return verify_greedy if greedy else make_verify_sample(temperature,
                                                           top_k, top_p)


def make_draft(cap: int, K: int) -> Callable:
    """fn(buf [slots, cap], lens [slots], cur [slots]) -> draft [slots, K]:
    longest match first: the latest earlier bigram (prev, cur) gives the
    tokens after it, else the latest earlier cur, else position 0
    (acceptance ~0, still correct)."""

    def draft(buf, lens, cur):
        dev = buf.device
        idx = torch.arange(cap, device=dev)
        ln = lens.long()[:, None]
        cur = cur.long()[:, None]
        prev = torch.gather(buf, 1, (ln - 1).clamp(min=0)).long()
        m2 = ((buf[:, :-1] == prev) & (buf[:, 1:] == cur)
              & (idx[:-1] < ln - 1))
        j2 = torch.where(m2, idx[:-1], -1).amax(dim=1)
        m1 = (buf == cur) & (idx < ln)
        j1 = torch.where(m1, idx, -1).amax(dim=1)
        start = torch.where(j2 >= 0, j2 + 2, torch.where(j1 >= 0, j1 + 1, 0))
        start = start.clamp(max=cap - K)
        return torch.gather(buf, 1, start[:, None] + torch.arange(K,
                                                                  device=dev))

    return draft


def _ring_write(buf, out, lens):
    """buf [slots, cap] <- out [slots, K+1] at each lane's lens + 1 (the
    start clamped as ``dynamic_update_slice`` clamps it)."""
    b = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[b, lane_rows(lens + 1, out.shape[1], buf.shape[1])] = out.to(
        buf.dtype)


def _window(tok, draft, vocab: int):
    """[slots, K+1] ids: the token to feed and the draft, a -1 draft id
    wrapped to the table's last row as JAX's gather wraps it (its rows are
    never accepted)."""
    return torch.cat([tok.long()[:, None], draft.long()], dim=1) % vocab


def _step_outputs(out, m):
    """(cur [slots]: the token each lane feeds next, nvalid [slots])."""
    return torch.gather(out, 1, m[:, None])[:, 0], (m + 1).to(torch.int32)


def make_spec_decode_chunk_local(window_fwd, fresh_shape, *, cap: int,
                                 chunk: int, K: int, vocab: int, dtype,
                                 verify: Callable = verify_greedy):
    """Chunk-local draft -> verify -> accept chunk:
    fn(cache_k, cache_v, buf, lengths, tok, generator) -> (lengths', cur,
    toks [chunk, slots, K+1], nvalid [chunk, slots]); caches and ring in
    place.  Each step's K + 1 window rows land in the side buffer at the
    lane's chunk-relative offset (rejected rows are overwritten by the
    next step's window), and the buffer scatters into the cache once per
    chunk.  ``window_fwd``: a maker of ``decode_chunk.py``;
    fresh_shape[2] >= chunk * (K + 1)."""
    draft_of = make_draft(cap, K)

    def decode_chunk_spec(cache_k, cache_v, buf, lengths, tok, generator):
        dev = lengths.device
        lens0 = lens = lengths
        fk = torch.zeros(fresh_shape, dtype=dtype, device=dev)
        fv = torch.zeros(fresh_shape, dtype=dtype, device=dev)
        toks, nvalid = [], []
        for _ in range(chunk):
            draft = draft_of(buf, lens, tok)                  # [slots, K]
            window = _window(tok, draft, vocab)
            logits = window_fwd(window, lens0, lens, cache_k, cache_v, fk, fv)
            out, m = verify(logits, draft, generator)
            _ring_write(buf, out, lens)
            tok, nv = _step_outputs(out, m)
            lens = lens + nv
            toks.append(out)
            nvalid.append(nv)
        scatter_fresh(cache_k, cache_v, fk, fv, lens0)
        return lens, tok, torch.stack(toks), torch.stack(nvalid)

    return decode_chunk_spec


def make_spec_decode_chunk(forward_step, *, cap: int, chunk: int, K: int,
                           vocab: int, verify: Callable = verify_greedy):
    """The naive chunk (``spec_chunk_local=False``): every step writes its
    window into the cache through the model's own per-lane cache path.
    forward_step(window [slots, K+1], bias [slots, 1, K+1, cap], ck, cv,
    lens) -> logits [slots, K+1, V]; same contract as
    :func:`make_spec_decode_chunk_local`."""
    draft_of = make_draft(cap, K)

    def decode_chunk_spec(cache_k, cache_v, buf, lengths, tok, generator):
        dev = lengths.device
        kpos = torch.arange(cap, device=dev)
        rows = torch.arange(K + 1, device=dev)[:, None]
        lens = lengths
        toks, nvalid = [], []
        for _ in range(chunk):
            draft = draft_of(buf, lens, tok)
            window = _window(tok, draft, vocab)
            bias = torch.where(kpos < lens[:, None, None, None] + rows + 1,
                               0.0, NEG_INF)
            logits = forward_step(window, bias, cache_k, cache_v, lens)
            out, m = verify(logits, draft, generator)
            _ring_write(buf, out, lens)
            tok, nv = _step_outputs(out, m)
            lens = lens + nv
            toks.append(out)
            nvalid.append(nv)
        return lens, tok, torch.stack(toks), torch.stack(nvalid)

    return decode_chunk_spec


def _spec_wrapper(server, decode_chunk_spec):
    """The engine's decode_chunk over a spec chunk and ``server.buf``."""

    def decode_wrapper(cache_k, cache_v, lengths, tok, generator):
        return decode_chunk_spec(cache_k, cache_v, server.buf, lengths, tok,
                                 generator)

    return decode_wrapper


def build_v1_speculative(server, *, eoi: int, cap: int, chunk: int,
                         draft_k: int, temperature: float = 1.0, top_k=1,
                         top_p=None, chunk_local: bool = True):
    """(make_prefill, decode_wrapper) for ShowoMMUServer.  The prefill is
    the server's, then records the padded prompt and tok0 in the ring."""
    K = draft_k
    phi = server.phi
    verify = pick_verify(temperature, top_k, top_p)
    slots = server.buf.shape[0]

    def make_prefill(bucket: int):
        base = server.make_prefill(bucket)

        def prefill(cache_k, cache_v, padded, true_len: int, slot: int,
                    generator):
            tok0 = base(cache_k, cache_v, padded, true_len, slot, generator)
            server.buf[slot, :bucket] = padded[0].to(server.buf.dtype)
            server.buf[slot, true_len] = tok0.to(server.buf.dtype)
            return tok0

        return prefill

    dtype = phi.model.embed_tokens.weight.dtype
    vocab = phi.cfg.vocab_size
    if chunk_local:
        from showo_tpu_torch.serving.decode_chunk import make_v1_window_forward

        fwd, fresh_shape = make_v1_window_forward(
            phi, slots=slots, cap=cap, Fcap=chunk * (K + 1))
        spec = make_spec_decode_chunk_local(fwd, fresh_shape, cap=cap,
                                            chunk=chunk, K=K, vocab=vocab,
                                            dtype=dtype, verify=verify)
    else:
        from showo_tpu_torch.models.phi import KVCache

        def forward_step(window, bias, ck, cv, lens):
            logits, _ = phi(input_ids=window, attention_bias=bias,
                            cache=KVCache(ck, cv, lens))
            return logits

        spec = make_spec_decode_chunk(forward_step, cap=cap, chunk=chunk,
                                      K=K, vocab=vocab, verify=verify)
    return make_prefill, _spec_wrapper(server, spec)


def build_v2_speculative(server, *, cap: int, chunk: int, draft_k: int,
                         temperature: float = 1.0, top_k=1, top_p=None,
                         chunk_local: bool = True):
    """(make_prefill, decode_wrapper) for Showo2MMUServer.  Prompts are
    embeddings, so the ring gets the request's ``lookup_row`` meta (the
    known ids at their sequence positions, -1 elsewhere) and tok0."""
    K = draft_k
    qwen = server.qwen
    verify = pick_verify(temperature, top_k, top_p)
    slots = server.buf.shape[0]

    def make_prefill(bucket: int):
        base = server.make_prefill(bucket)

        def prefill(cache_k, cache_v, padded, true_len: int, slot: int,
                    generator, img_start: int, lookup_row):
            tok0 = base(cache_k, cache_v, padded, true_len, slot, generator,
                        img_start)
            server.buf[slot] = lookup_row.to(server.buf.dtype)
            server.buf[slot, true_len] = tok0.to(server.buf.dtype)
            return tok0

        return prefill

    dtype = qwen.model.embed_tokens.weight.dtype
    vocab = qwen.cfg.vocab_size
    if chunk_local:
        from showo_tpu_torch.serving.decode_chunk import make_v2_window_forward

        fwd, fresh_shape = make_v2_window_forward(
            qwen, slots=slots, cap=cap, Fcap=chunk * (K + 1))
        spec = make_spec_decode_chunk_local(fwd, fresh_shape, cap=cap,
                                            chunk=chunk, K=K, vocab=vocab,
                                            dtype=dtype, verify=verify)
    else:
        from showo_tpu_torch.show_o2.qwen2 import Qwen2KVCache

        def forward_step(window, bias, ck, cv, lens):
            W = window.shape[1]
            logits, _ = qwen(
                input_ids=window, attention_bias=bias,
                cache=Qwen2KVCache(ck, cv),
                position_ids=lens[:, None] + torch.arange(W,
                                                          device=lens.device),
                cache_offsets=lens)
            return logits

        spec = make_spec_decode_chunk(forward_step, cap=cap, chunk=chunk,
                                      K=K, vocab=vocab, verify=verify)
    return make_prefill, _spec_wrapper(server, spec)


def spec_buf_update(buf, toks, lengths, prompt_row, tok0, slot: int,
                    true_len: int) -> None:
    """Record a fused-admission step in the ring, in place.  The admission
    rides a plain fused decode step (each active lane advances exactly one
    sampled token), so the ring gets toks[s] at lengths[s] + 1 for every
    active lane (length > 0), the admitted lane's known-id row (the padded
    prompt ids for v1, the -1-masked lookup row for v2) from position 0,
    and its first sampled token at ``true_len``."""
    b = torch.arange(buf.shape[0], device=buf.device)
    at = (lengths.long() + 1).clamp(max=buf.shape[1] - 1)
    old = buf[b, at]
    buf[b, at] = torch.where(lengths > 0, toks.to(buf.dtype), old)
    buf[slot, :prompt_row.shape[0]] = prompt_row.to(buf.dtype)
    buf[slot, true_len] = tok0.to(buf.dtype)
