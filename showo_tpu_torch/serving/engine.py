"""Continuous-batching serving engine (iteration-level scheduling).

Counterpart of ``showo_tpu/serving/engine.py``.  The engine keeps a fixed
set of batch lanes ("slots"), each holding one request at its own length,
and refills a lane the moment its request ends, instead of running a
static batch to its longest budget.

  * One decode program for all slots: per-lane lengths ride in as a
    device int32 [slots] tensor, per-lane cache writes are one
    ``index_put_`` (``models/phi.py::_cache_scatter``,
    ``decode_chunk.py``), and the attention bias is computed from the
    lengths on the device.
  * Decode runs ``chunk`` steps a dispatch, and a window of up to
    ``lookahead`` chunks runs between host syncs: the host reads the
    device exactly once a window (the window's tokens, the final lengths,
    pending prefill first tokens and fused-admission step tokens in one
    copy), and schedules at window boundaries.
  * Prompts are right-padded to a length bucket; padded columns are masked
    and their cache rows overwritten as decode advances.
  * The KV cache is updated in place by every program.
  * Sampling stays on the device: one ``torch.Generator`` on the device,
    given to :meth:`run`, draws every token (Gumbel-max,
    ``sampling/ar.py::sampler``).

The engine core is model-agnostic (prefill / decode callables);
:class:`ShowoMMUServer` wires it to the v1 understanding path and
:class:`Showo2MMUServer` to Show-o2's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from showo_tpu_torch.ops.masks import NEG_INF
from showo_tpu_torch.sampling.ar import sampler
from showo_tpu_torch.serving.decode_chunk import (kv_cache_write,
                                                  kv_cache_zeros)


@dataclasses.dataclass
class Request:
    """One generation request."""

    uid: int
    prompt: Any                         # int ids [S] (numpy), or [S, D]
    max_new_tokens: int
    meta: tuple = ()                    # extra per-request prefill args
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


def _round_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: on CUDA through a
    fresh pinned buffer and a non-blocking copy (the caching host
    allocator keeps the buffer until the copy is done); on the CPU a copy,
    so that later host edits of ``a`` do not reach it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


class ContinuousBatchingEngine:
    """Model-agnostic slot scheduler.

    prefill_for(bucket) -> fn(cache_k, cache_v, padded [1, bucket, ...],
        true_len, slot, generator, *request_meta) -> tok0 (a device
        scalar); the prompt's K/V go into lane ``slot`` in place.
    decode_chunk: fn(cache_k, cache_v, lengths [slots] int32, tok [slots],
        generator) -> (lengths, tok, toks [chunk, slots, T],
        nvalid [chunk, slots]); toks[c, s, :nvalid[c, s]] are the tokens
        lane s sampled at step c (T = max_tokens_per_step: 1 for plain
        decode, k + 1 for speculative decode).
    fused_admit_for(bucket) -> fn(cache_k, cache_v, lengths, cur_tok,
        padded, true_len, slot, generator, *meta) -> (cur_tok, toks
        [slots], tok0): one decode step of every lane with the prefill of
        the admitted one (``fused_admit.py``).

    The host syncs with the device exactly once a scheduling round:
    ``stat_syncs`` counts those reads, ``stat_windows`` the windows and
    ``stat_steps`` the decode steps dispatched; over the windows'
    lanes that were active, ``stat_lane_steps`` counts steps and
    ``stat_step_tokens`` the tokens they sampled (the accepted drafts are
    their difference).
    """

    def __init__(self, *, slots: int, cap: int, chunk: int,
                 prefill_for: Callable[[int], Callable],
                 decode_chunk: Callable,
                 init_cache: Callable[[], Any],
                 buckets: Sequence[int],
                 device: torch.device,
                 eot_token: Optional[int] = None,
                 lookahead: int = 4,
                 max_tokens_per_step: int = 1,
                 fused_admit_for: Optional[Callable[[int], Callable]] = None,
                 alt_decode_chunk: Optional[Callable] = None,
                 alt_max_tokens_per_step: int = 1,
                 probe_windows: int = 1):
        self.slots, self.cap, self.chunk = slots, cap, chunk
        self.device = torch.device(device)
        self.lookahead = max(1, lookahead)
        self.max_tokens_per_step = max(1, max_tokens_per_step)
        self.buckets = sorted(buckets)
        self._prefill_for = prefill_for
        self._prefill_cache: Dict[int, Callable] = {}
        self._decode_chunk = decode_chunk
        # adaptive A/B between two decode programs (speculative vs plain
        # under temperature sampling, where whether drafts pay depends on
        # the weights and the workload): measure the alt (the safe
        # baseline) then the primary over ``probe_windows`` windows each
        # (a window is discarded as warm-up only the first time a program
        # ever runs; candidate windows are one chunk), then commit to the
        # faster by measured wall time.  reset_ab() restarts probation.
        self._alt_decode_chunk = alt_decode_chunk
        self._alt_mts = max(1, alt_max_tokens_per_step)
        self._probe_windows = max(1, probe_windows)
        self.ab_choice: Optional[str] = None   # "primary" | "alt" when done
        self._ab = None
        if alt_decode_chunk is not None:
            self.reset_ab()
        # fused admission: used whenever at least one lane is mid-decode,
        # the plain prefill otherwise (the initial fill)
        self._fused_admit_for = fused_admit_for
        self._fused_cache: Dict[int, Callable] = {}
        self.eot_token = eot_token
        self.cache_k, self.cache_v = init_cache()
        self.lengths = np.zeros(slots, np.int32)          # host-tracked
        self.cur_tok = torch.zeros(slots, dtype=torch.long,
                                   device=self.device)    # device-resident
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: deque = deque()
        self._pending: List = []   # (slot, request, device tok0) to sync
        self._events: List = []    # (active snapshot, device toks [slots])
        #                            per fused-admission step, in order
        self._unsynced = np.zeros(slots, np.int64)  # device tokens not yet
        #                                             appended, per lane
        self._uid = 0
        self.stat_steps = 0        # decode steps dispatched (all lanes)
        self.stat_windows = 0      # decode windows
        self.stat_syncs = 0        # host reads of the device
        self.stat_lane_steps = 0   # window steps x lanes active in them
        self.stat_step_tokens = 0  # tokens those lane steps sampled (1 a
        #                            step, 1 + accepted drafts speculating)

    # -- client API ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, meta: tuple = ()
               ) -> Request:
        """Queue a prompt: token ids [S] (any int array) or embeddings
        [S, D] (a tensor, kept as it is)."""
        if not torch.is_tensor(prompt):
            prompt = np.asarray(prompt)
            if prompt.ndim == 1:
                prompt = prompt.astype(np.int64)
        r = Request(self._uid, prompt, int(max_new_tokens), meta=tuple(meta),
                    submitted_at=time.perf_counter())
        self._uid += 1
        self.queue.append(r)
        return r

    def run(self, generator: torch.Generator) -> List[Request]:
        """Drain the queue; returns the completed requests in finishing
        order.  Every draw comes from ``generator`` (on the device)."""
        finished: List[Request] = []
        while self.queue or any(r is not None for r in self.active):
            self._fill_slots(generator)
            self._decode_once(generator, finished)
        return finished

    # -- internals ----------------------------------------------------

    def reset_ab(self) -> None:
        """(Re)start decode-program probation: phase 0 measures the alt
        first, phase 1 the primary, each over ``probe_windows`` windows of
        one chunk; a window is discarded as warm-up only the first time a
        program ever runs."""
        if self._alt_decode_chunk is None:
            return
        self._ab = {"phase": 0, "left": self._probe_windows,
                    "stats": [[0, 0.0], [0, 0.0]]}
        if not hasattr(self, "_prog_runs"):
            self._prog_runs = [0, 0]     # [alt, primary] window counts
        self.ab_choice = None
        self.ab_trace = []               # (prog_idx, emitted, secs)

    def force_ab(self, choice: str) -> None:
        """Commit the A/B at once (warm-up helper: lets a caller run
        choice-gated programs, fused admission among them, off the clock;
        reset_ab() afterwards restarts probation)."""
        if self._ab is not None:
            self._ab["phase"] = 2
            self.ab_choice = choice

    def _ab_current(self):
        """(decode_chunk, max_tokens_per_step, prog_idx) for this window;
        prog_idx 0 = alt, 1 = primary."""
        primary = (self._decode_chunk, self.max_tokens_per_step, 1)
        alt = (self._alt_decode_chunk, self._alt_mts, 0)
        if self._ab is None:
            return primary
        ph = self._ab["phase"]
        if ph == 0:
            return alt
        if ph == 1:
            return primary
        return primary if self.ab_choice == "primary" else alt

    def _ab_record(self, prog_idx: int, emitted: int, seconds: float
                   ) -> None:
        if self._ab is None:
            return
        if len(self.ab_trace) < 200:
            self.ab_trace.append((prog_idx, emitted, round(seconds, 4)))
        first_run = self._prog_runs[prog_idx] == 0
        self._prog_runs[prog_idx] += 1
        st = self._ab
        if st["phase"] >= 2 or first_run:
            return                       # committed, or a warm-up window
        st["stats"][st["phase"]][0] += emitted
        st["stats"][st["phase"]][1] += seconds
        st["left"] -= 1
        if st["left"] == 0:
            if st["phase"] == 0:
                st.update(phase=1, left=self._probe_windows)
                return
            (t_alt, s_alt), (t_pri, s_pri) = st["stats"]
            r_alt = t_alt / max(s_alt, 1e-9)
            r_pri = t_pri / max(s_pri, 1e-9)
            self.ab_choice = "primary" if r_pri >= r_alt else "alt"
            st["phase"] = 2

    def _prefill(self, bucket: int) -> Callable:
        if bucket not in self._prefill_cache:
            self._prefill_cache[bucket] = self._prefill_for(bucket)
        return self._prefill_cache[bucket]

    def _fused(self, bucket: int) -> Callable:
        if bucket not in self._fused_cache:
            self._fused_cache[bucket] = self._fused_admit_for(bucket)
        return self._fused_cache[bucket]

    def _padded(self, r: Request, bucket: int):
        """The prompt right-padded to ``bucket`` rows, [1, bucket, ...] on
        the device."""
        S = len(r.prompt)
        if torch.is_tensor(r.prompt):
            padded = r.prompt.new_zeros((1, bucket) + tuple(r.prompt.shape[1:]))
            padded[0, :S] = r.prompt
            return padded.to(self.device)
        padded = np.zeros((1, bucket) + r.prompt.shape[1:], r.prompt.dtype)
        padded[0, :S] = r.prompt
        return to_device(padded, self.device)

    def _fill_slots(self, generator) -> None:
        # dispatch only: a prefill's first token stays on the device
        # (_decode_once reads it with the window's tokens, in one copy)
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            r = self.queue.popleft()
            S = len(r.prompt)
            # overshoot margin: without EOT the lookahead window is sized
            # so a lane never finishes before the window's last chunk, so
            # overshoot stays under one chunk of steps; EOT finishes are
            # unpredictable and the whole window can run on
            per_chunk = self.chunk * self.max_tokens_per_step
            margin = (per_chunk if self.eot_token is None
                      else per_chunk * self.lookahead)
            if self._fused_admit_for is not None:
                margin += self.slots   # fused admissions advance decode
                #                        between windows
            if S + r.max_new_tokens + margin > self.cap:
                raise ValueError(
                    f"request {r.uid}: prompt {S} + budget "
                    f"{r.max_new_tokens} does not fit cap {self.cap}")
            bucket = _round_bucket(S, self.buckets)
            padded = self._padded(r, bucket)
            # fused admission goes with plain decode: under the adaptive
            # A/B it starts once the engine commits to the alt (plain)
            fused_ok = self._fused_admit_for is not None and (
                self._ab is None or self.ab_choice == "alt")
            if fused_ok and any(a is not None for a in self.active):
                for s2 in range(self.slots):
                    if self.active[s2] is None:
                        self.lengths[s2] = 0
                snapshot = list(self.active)
                self.cur_tok, toks, tok0 = self._fused(bucket)(
                    self.cache_k, self.cache_v,
                    to_device(self.lengths, self.device), self.cur_tok,
                    padded, S, s, generator, *r.meta)
                # lengths advance host-deterministically: + 1 for each
                # active lane, the admitted lane = its prompt length
                for s2, r2 in enumerate(snapshot):
                    if r2 is not None:
                        self.lengths[s2] += 1
                        self._unsynced[s2] += 1
                self.lengths[s] = S
                self.active[s] = r
                self._events.append((snapshot, toks))
                self._pending.append((s, r, tok0))
                self._unsynced[s] += 1
                self.stat_steps += 1
                continue
            tok0 = self._prefill(bucket)(self.cache_k, self.cache_v, padded,
                                         S, s, generator, *r.meta)
            self.lengths[s] = S
            self.cur_tok[s] = tok0
            self.active[s] = r
            self._pending.append((s, r, tok0))
            self._unsynced[s] += 1

    def _finish_check(self, r: Request, now: float) -> bool:
        if (self.eot_token is not None and r.tokens
                and r.tokens[-1] == self.eot_token):
            r.done = True
        if len(r.tokens) >= r.max_new_tokens:
            r.done = True
        if r.done:
            r.finished_at = now
        return r.done

    def _read(self, parts) -> List[np.ndarray]:
        """THE host sync: every device tensor of ``parts`` in one copy."""
        self.stat_syncs += 1
        flat = torch.cat([p.reshape(-1).long() for p in parts]).cpu().numpy()
        out, at = [], 0
        for p in parts:
            n = p.numel()
            out.append(flat[at:at + n].reshape(tuple(p.shape)))
            at += n
        return out

    def _decode_once(self, generator, finished: List[Request]) -> None:
        if not any(r is not None for r in self.active):
            return
        # idle lanes decode garbage; their length is pinned to 0 so they
        # never overflow the cache
        for s in range(self.slots):
            if self.active[s] is None:
                self.lengths[s] = 0
        snapshot = list(self.active)
        pend, self._pending = self._pending, []
        events, self._events = self._events, []
        # budget-aware lookahead: run enough chunks that the lane finishing
        # first still works through the window's last chunk (finishing
        # times are host-predictable, EOT and speculative acceptance
        # aside); _unsynced counts tokens on the device not yet appended
        rem = [r.max_new_tokens - len(r.tokens) - int(self._unsynced[s])
               for s, r in enumerate(snapshot) if r is not None]
        self._unsynced[:] = 0
        dec, mts, prog_idx = self._ab_current()
        denom = self.chunk * mts
        if mts == 1:
            n = max(1, min(self.lookahead, -(-max(1, min(rem)) // denom)))
        else:  # acceptance varies: the floor is the conservative window
            n = max(1, min(self.lookahead, max(1, min(rem)) // denom))
        if self._ab is not None and self._ab["phase"] == 1:
            n = 1        # short candidate-probe windows
        toks_parts, nvalid_parts = [], []
        t_window = time.perf_counter()
        # the first dispatch uploads the host lengths (refills, idle pins);
        # later dispatches take the lengths the device returned
        lens = to_device(self.lengths, self.device)
        for _ in range(n):
            lens, self.cur_tok, toks, nvalid = dec(
                self.cache_k, self.cache_v, lens, self.cur_tok, generator)
            toks_parts.append(toks)
            nvalid_parts.append(nvalid)
            self.stat_steps += self.chunk
        self.stat_windows += 1
        host = self._read([lens, *toks_parts, *nvalid_parts,
                           *(t for _, _, t in pend),
                           *(t for _, t in events)])
        lens_h = host[0]
        toks_h = np.concatenate(host[1:1 + n], axis=0)  # [n*chunk, slots, T]
        nvalid_h = np.concatenate(host[1 + n:1 + 2 * n], axis=0)
        tok0s = host[1 + 2 * n:1 + 2 * n + len(pend)]
        event_toks = host[1 + 2 * n + len(pend):]
        for s in range(self.slots):
            if snapshot[s] is not None:
                self.lengths[s] = lens_h[s]
                self.stat_lane_steps += nvalid_h.shape[0]
                self.stat_step_tokens += int(nvalid_h[:, s].sum())
        now = time.perf_counter()
        # chronological per lane: an admitted lane's tok0 precedes the
        # fused-admission step tokens it produced (it was idle during its
        # own admission step), which precede the window's tokens
        for (s, r, _), t0 in zip(pend, tok0s):
            r.first_token_at = now
            r.tokens.append(int(t0))
            if self._finish_check(r, now):
                finished.append(r)
                self.active[s] = None
        for (esnap, _), etoks in zip(events, event_toks):
            for s, r in enumerate(esnap):
                if r is None or r.done:
                    continue
                r.tokens.append(int(etoks[s]))
                if self._finish_check(r, now):
                    finished.append(r)
                    self.active[s] = None
        emitted = 0
        for s in range(self.slots):
            r = snapshot[s]
            if r is None or r.done:
                continue
            for c in range(toks_h.shape[0]):
                for t in toks_h[c, s, :nvalid_h[c, s]]:
                    r.tokens.append(int(t))
                    emitted += 1
                    if self._finish_check(r, now):
                        break
                if r.done:
                    break
            if r.done:
                finished.append(r)
                self.active[s] = None
        self._ab_record(prog_idx, emitted, now - t_window)


def _check_kv_int8(kv_int8: bool, fused_admit, speculative_k: int,
                   spec_chunk_local: bool):
    """The int8 KV cache needs the chunk-local decode programs (plain and
    speculative); the fused-admission step writes rows in the model dtype.
    Returns fused_admit (False under kv_int8)."""
    if kv_int8:
        if fused_admit:
            raise ValueError("kv_int8 requires fused_admit=False")
        if speculative_k and not spec_chunk_local:
            raise ValueError("kv_int8 requires spec_chunk_local=True")
        return False
    return fused_admit


def _spec_fused(server, base_for, prompt_row: Callable):
    """fused_admit_for under speculation: the admission rides a plain fused
    decode step, and the draft ring records it afterwards
    (``speculative.py::spec_buf_update``)."""
    from showo_tpu_torch.serving.speculative import spec_buf_update

    def fused_for(bucket):
        base = base_for(bucket)

        def wrap(ck, cv, lengths, cur, padded, true_len, slot, generator,
                 *meta):
            cur, toks, tok0 = base(ck, cv, lengths, cur, padded, true_len,
                                   slot, generator, *meta[:1])
            spec_buf_update(server.buf, toks, lengths,
                            prompt_row(padded, meta), tok0, slot, true_len)
            return cur, toks, tok0

        return wrap

    return fused_for


class ShowoMMUServer:
    """v1 Show-o understanding over the continuous-batching engine.

    ``model``: a :class:`~showo_tpu_torch.models.showo.Showo` (any weight
    layout, bf16 / fp32 or int8 after ``quantize_int8``), on the device
    the engine runs on.  Requests are token prompts ``[mmu][soi] image
    codes [eoi] ...``; each prefill runs in a single-lane cache of the
    bucket's length under ``omni_mask_mmu`` (padded columns masked), is
    written into the lane, and samples the first token.  Options as JAX's:
    ``kv_int8`` (the int8 KV cache), ``speculative_k`` (prompt-lookup
    drafts; greedy exact, sampling by rejection resampling),
    ``spec_chunk_local`` (False: the naive speculative chunk),
    ``fused_admit`` (default: on for the ``win`` / ``wout`` layout without
    speculation, or with the adaptive A/B) and ``spec_adaptive`` (A/B the
    plain program against the speculative one under sampling).
    """

    def __init__(self, model, *, slots: int = 8, cap: int = 512,
                 chunk: int = 16, buckets: Sequence[int] = (320, 384, 448),
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eot_token: Optional[int] = None, lookahead: int = 4,
                 speculative_k: int = 0,
                 spec_chunk_local: bool = True,
                 fused_admit: Optional[bool] = None,
                 kv_int8: bool = False,
                 spec_adaptive: bool = True):
        from showo_tpu_torch.serving.decode_chunk import build_v1_decode_chunk

        self.model, self.phi = model, model.showo
        cfg = model.cfg
        embed = self.phi.model.embed_tokens.weight
        device, dtype = embed.device, embed.dtype
        L, H, Dh = cfg.llm.num_layers, cfg.llm.num_heads, cfg.llm.head_dim
        eoi = cfg.llm_vocab_size + 2          # [EOI] in the unified vocab
        self._eoi, self._sample = eoi, sampler(temperature, top_k, top_p)
        fused_admit = _check_kv_int8(kv_int8, fused_admit, speculative_k,
                                     spec_chunk_local)

        def init_cache():
            shape = (L, slots, cap, H, Dh)
            return (kv_cache_zeros(shape, kv_int8, dtype, device),
                    kv_cache_zeros(shape, kv_int8, dtype, device))

        decode = build_v1_decode_chunk(self.phi, cap=cap, chunk=chunk,
                                       slots=slots, sample=self._sample)
        prefill_for, alt_decode = self.make_prefill, None
        greedy = top_k == 1 and (top_p is None or top_p >= 1.0)
        if speculative_k:
            from showo_tpu_torch.serving.speculative import \
                build_v1_speculative

            # under sampling keep the plain program as the A/B alternative
            # and let the engine commit to the faster (both sample the same
            # filtered distribution)
            if spec_adaptive and not greedy:
                alt_decode = decode
            self.buf = torch.zeros((slots, cap), dtype=torch.long,
                                   device=device)
            prefill_for, decode = build_v1_speculative(
                self, eoi=eoi, cap=cap, chunk=chunk, draft_k=speculative_k,
                temperature=temperature, top_k=top_k, top_p=top_p,
                chunk_local=spec_chunk_local)
        if fused_admit is None:
            fused_admit = (hasattr(self.phi.model.layers[0], "win")
                           and (not speculative_k or alt_decode is not None))
        fused_for = None
        if fused_admit:
            from showo_tpu_torch.serving.fused_admit import \
                build_v1_fused_admit

            fused_for = build_v1_fused_admit(self, eoi=eoi, cap=cap,
                                             sample=self._sample)
            if speculative_k:
                fused_for = _spec_fused(self, fused_for,
                                        lambda padded, meta: padded[0])
        self.engine = ContinuousBatchingEngine(
            slots=slots, cap=cap, chunk=chunk, prefill_for=prefill_for,
            decode_chunk=decode, init_cache=init_cache, buckets=buckets,
            device=device, eot_token=eot_token, lookahead=lookahead,
            max_tokens_per_step=1 + speculative_k,
            fused_admit_for=fused_for, alt_decode_chunk=alt_decode)

    def make_prefill(self, bucket: int) -> Callable:
        """fn(cache_k, cache_v, padded [1, bucket] ids, true_len, slot,
        generator) -> tok0: the prompt under ``omni_mask_mmu`` (padded
        columns masked) into a single-lane cache of ``bucket`` rows, then
        lane ``slot``; the first token from the last prompt row."""
        from showo_tpu_torch.models.phi import KVCache
        from showo_tpu_torch.ops.masks import omni_mask_mmu

        phi = self.phi

        def prefill(cache_k, cache_v, padded, true_len: int, slot: int,
                    generator):
            embed = phi.model.embed_tokens.weight
            tmp = KVCache.zeros(phi.cfg, 1, bucket, dtype=embed.dtype,
                                device=embed.device)
            bias = omni_mask_mmu(padded, eoi_id=self._eoi, dtype=embed.dtype)
            cols = torch.arange(bucket, device=embed.device)
            bias = torch.where(cols < true_len, bias, NEG_INF)
            logits, _ = phi(input_ids=padded, attention_bias=bias, cache=tmp,
                            lm_head_slice=(true_len - 1, true_len, None,
                                           None))
            kv_cache_write(cache_k, tmp.k, slot)
            kv_cache_write(cache_v, tmp.v, slot)
            return self._sample(logits[0], generator)[0]

        return prefill

    def submit(self, prompt, max_new_tokens: int) -> Request:
        return self.engine.submit(prompt, max_new_tokens)

    def run(self, generator: torch.Generator) -> List[Request]:
        return self.engine.run(generator)


class Showo2MMUServer:
    """Show-o2 understanding over the continuous-batching engine.

    ``model``: a :class:`~showo_tpu_torch.show_o2.showo2.Showo2` (its Qwen2
    tower ``model.showo`` serves).  Requests arrive as assembled prompt
    embeddings [S, D] (text, the time token and the image embeddings, as
    ``pipelines/mmu_v2.py::prompt`` lays them out) with the image span's
    offset; the prefill runs under ``show_o2/masks.py::omni_attn_mask``
    with the span (``num_image_tokens`` rows) at ``img_start``, and decode
    is purely causal over each lane's cache.  Options as
    :class:`ShowoMMUServer` (fused admission defaults on without
    speculation).
    """

    def __init__(self, model, *, slots: int = 4, cap: int = 1024,
                 chunk: int = 16, buckets: Sequence[int] = (512, 768),
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_token: Optional[int] = None, lookahead: int = 4,
                 speculative_k: int = 0,
                 spec_chunk_local: bool = True,
                 fused_admit: Optional[bool] = None,
                 kv_int8: bool = False,
                 spec_adaptive: bool = True):
        from showo_tpu_torch.serving.decode_chunk import build_v2_decode_chunk

        self.model, self.qwen = model, model.showo
        llm = model.cfg.llm
        embed = self.qwen.model.embed_tokens.weight
        device, dtype = embed.device, embed.dtype
        L, Hkv, Dh = llm.num_layers, llm.num_kv_heads, llm.head_dim
        self._n_img = model.cfg.num_image_tokens   # span rows incl. time
        self._sample = sampler(temperature, top_k, top_p)
        fused_admit = _check_kv_int8(kv_int8, fused_admit, speculative_k,
                                     spec_chunk_local)

        def init_cache():
            shape = (L, slots, cap, Hkv, Dh)
            return (kv_cache_zeros(shape, kv_int8, dtype, device),
                    kv_cache_zeros(shape, kv_int8, dtype, device))

        decode = build_v2_decode_chunk(self.qwen, cap=cap, chunk=chunk,
                                       slots=slots, sample=self._sample)
        self._spec, self._cap = speculative_k, cap
        prefill_for, alt_decode = self.make_prefill, None
        greedy = top_k == 1 and (top_p is None or top_p >= 1.0)
        if speculative_k:
            from showo_tpu_torch.serving.speculative import \
                build_v2_speculative

            if spec_adaptive and not greedy:
                alt_decode = decode
            self.buf = torch.zeros((slots, cap), dtype=torch.long,
                                   device=device)
            prefill_for, decode = build_v2_speculative(
                self, cap=cap, chunk=chunk, draft_k=speculative_k,
                temperature=temperature, top_k=top_k, top_p=top_p,
                chunk_local=spec_chunk_local)
        if fused_admit is None:
            fused_admit = not speculative_k or alt_decode is not None
        fused_for = None
        if fused_admit:
            from showo_tpu_torch.serving.fused_admit import \
                build_v2_fused_admit

            fused_for = build_v2_fused_admit(self, n_img=self._n_img,
                                             cap=cap, sample=self._sample)
            if speculative_k:
                fused_for = _spec_fused(self, fused_for,
                                        lambda padded, meta: meta[1])
        self.engine = ContinuousBatchingEngine(
            slots=slots, cap=cap, chunk=chunk, prefill_for=prefill_for,
            decode_chunk=decode, init_cache=init_cache, buckets=buckets,
            device=device, eot_token=eos_token, lookahead=lookahead,
            max_tokens_per_step=1 + speculative_k,
            fused_admit_for=fused_for, alt_decode_chunk=alt_decode)

    def make_prefill(self, bucket: int) -> Callable:
        """fn(cache_k, cache_v, padded [1, bucket, D] embeddings, true_len,
        slot, generator, img_start) -> tok0 (see the class doc)."""
        from showo_tpu_torch.serving.decode_chunk import qwen_logits
        from showo_tpu_torch.show_o2.masks import omni_attn_mask
        from showo_tpu_torch.show_o2.qwen2 import Qwen2KVCache

        qwen = self.qwen

        def prefill(cache_k, cache_v, padded, true_len: int, slot: int,
                    generator, img_start: int):
            embed = qwen.model.embed_tokens.weight
            dev = embed.device
            tmp = Qwen2KVCache.zeros(qwen.cfg, 1, bucket, dtype=embed.dtype,
                                     device=dev)
            mp = torch.empty((1, 1, 2), dtype=torch.long, device=dev)
            mp[..., 0], mp[..., 1] = img_start, self._n_img
            bias = omni_attn_mask(mp, bucket, dtype=embed.dtype)
            cols = torch.arange(bucket, device=dev)
            bias = torch.where(cols < true_len, bias, NEG_INF)
            _, h = qwen(input_embeds=padded.to(embed.dtype),
                        attention_bias=bias, cache=tmp, logits=False)
            kv_cache_write(cache_k, tmp.k, slot)
            kv_cache_write(cache_v, tmp.v, slot)
            logits = qwen_logits(qwen, h[0, true_len - 1:true_len])
            return self._sample(logits, generator)[0]

        return prefill

    def submit(self, input_embeds, img_start: int, max_new_tokens: int,
               lookup_ids=None) -> Request:
        """input_embeds: [S, D] assembled prompt rows (a tensor, or an
        array); img_start: the image span's offset in them (its time row
        included).  lookup_ids (speculative mode): the ids of the trailing
        text rows (e.g. the question), which seed the draft ring at their
        sequence positions."""
        emb = torch.as_tensor(input_embeds)
        meta = [int(img_start)]
        if self._spec:
            row = np.full(self._cap, -1, np.int64)
            if lookup_ids is not None and len(lookup_ids):
                ids = np.asarray(lookup_ids, np.int64)
                row[emb.shape[0] - len(ids):emb.shape[0]] = ids
            meta.append(to_device(row, self.engine.device))
        return self.engine.submit(emb, max_new_tokens, meta=tuple(meta))

    def run(self, generator: torch.Generator) -> List[Request]:
        return self.engine.run(generator)
