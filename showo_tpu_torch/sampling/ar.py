"""Autoregressive decode over a KV cache.

Counterpart of ``showo_tpu/sampling/ar.py``: prefill the prompt, sample a
token, then exactly ``max_new_tokens`` decode forwards of one token each,
each under a length bias over the cache capacity (``kpos < length + 1``:
every position written so far, the fresh one included).  The JAX package
runs the loop as one compiled scan; here it is a Python loop whose tokens
stay on the device (no host sync per token).  JAX keys become an explicit
``torch.Generator``; tests feed both sides the same Gumbel noise
(``injected_gumbel``), under which ``argmax(logits + g)`` is the sample.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from showo_tpu_torch.ops.masks import NEG_INF


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering with the reference's exclusive-cumsum semantics:
    sort descending, softmax, drop the tokens whose cumulative probability
    *before* them exceeds ``top_p`` (the first token crossing it, and the
    top token, are kept).  Ties keep their order (stable sort), as JAX's
    argsort."""
    sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sorted_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = exclusive <= top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, sorted_idx, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, -torch.inf))


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int],
                  top_p: Optional[float] = None) -> torch.Tensor:
    """The logits sampling draws from: / temperature, top-k (ties with the
    k-th value kept), top-p; removed entries -inf."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf),
                             logits)
    if top_p is not None and top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    return logits


def sample_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int],
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """[B, V] logits -> [B] token ids: :func:`filter_logits`, then
    ``argmax(logits + gumbel)`` when noise is given, else a draw from the
    softmax with ``generator``."""
    logits = filter_logits(logits, temperature, top_k, top_p)
    if gumbel is not None:
        return torch.argmax(logits + torch.as_tensor(
            gumbel, dtype=logits.dtype, device=logits.device), dim=-1)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of ``shape`` in fp32, u
    uniform in (0, 1) from ``generator``, drawn on its device: with it
    ``argmax(logits + noise)`` is a draw from ``softmax(logits)`` and
    nothing leaves the device."""
    u = torch.rand(shape, generator=generator,
                   device=device or generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sampler(temperature: float, top_k: Optional[int],
            top_p: Optional[float]) -> Callable:
    """fn(logits [B, V], generator) -> [B] int64 ids on the logits' device,
    with no host sync: greedy (``top_k == 1``, no nucleus) is the argmax;
    otherwise :func:`sample_logits` under :func:`gumbel` noise from the
    generator (temperature, top-k, top-p, then Gumbel-max)."""
    if top_k == 1 and (top_p is None or top_p >= 1.0):
        return lambda logits, generator: torch.argmax(logits, dim=-1)

    def sample(logits, generator):
        logits = logits.float()
        return sample_logits(logits, temperature, top_k,
                             gumbel=gumbel(logits.shape, generator,
                                           logits.device), top_p=top_p)
    return sample


def ar_generate(
    prefill_fn: Callable,
    decode_fn: Callable,
    prompt_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eot_token: Optional[int] = None,
    prompt_bias: Optional[torch.Tensor] = None,
    injected_gumbel=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_new_tokens], valid [B, max_new_tokens]).

    prefill_fn(ids, bias) -> (logits [B, S, V], cache) with
    ``cache.k`` [L, B, capacity, H, D] and ``cache.length``;
    decode_fn(ids_step [B, 1], bias [1, 1, 1, capacity], cache) ->
    (logits [B, 1, V], cache).  ``valid`` marks the tokens up to and
    including the first ``eot_token``.  ``injected_gumbel``: noise
    [max_new_tokens + 1, B, V] replacing the draws.
    """
    logits, cache = prefill_fn(prompt_ids, prompt_bias)
    cap = cache.k.shape[2]
    dev = logits.device
    kpos = torch.arange(cap, device=dev)[None, None, None, :]

    def noise(i):
        return injected_gumbel[i] if injected_gumbel is not None else None

    tok = sample_logits(logits[:, -1, :], temperature, top_k, generator,
                        noise(0), top_p)
    toks = []
    for step in range(max_new_tokens):
        toks.append(tok)
        bias = torch.where(kpos < cache.length + 1, 0.0, NEG_INF)
        logits, cache = decode_fn(tok[:, None], bias, cache)
        tok = sample_logits(logits[:, -1, :], temperature, top_k, generator,
                            noise(step + 1), top_p)
    toks = torch.stack(toks, dim=1)
    if eot_token is not None:
        hit = toks == eot_token
        seen = torch.cumsum(hit.int(), dim=1)
        valid = (seen == 0) | (hit & (seen == 1))
    else:
        valid = torch.ones_like(toks, dtype=torch.bool)
    return toks, valid
