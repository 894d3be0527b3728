"""Show-o text-to-image through ``T2IPipeline.generate_codes`` then
``decode``: the closed loop of a t2i cell, and its check.

Set-up builds the pipeline as ``inference_t2i.build_pipeline`` does, on
weights made from the seed, and warms it up with one generate of the cell's
batch.  A request is one batch of prompts: the prefix-cached MaskGIT loop
with CFG on its own generator (seeded from the run's seed and the request's
index), then the MAGVIT-v2 decode and the pixels on the host.

The check follows the program step by step: a hook on the token embedding
keeps the image tokens each step's forward reads (the program's state).
For a sample of the window's generates and steps, drawn from the seed, the
reference forwards that state in fp32 with CFG and reproduces the step's
Gumbel draws from the request's generator (the sampler's two draws a step,
token then confidence), so sampling is an argmax and every token committed
at that step can be judged by how far its score lies below the reference's
best (``token_gap``).  Every step's update is judged by the number of
tokens it keeps masked, never more than the schedule's, and the tokens it
keeps, to the final codes (``commit_errors``, exact); by the tokens it
commits beyond the schedule's count while the confidences' noise is
large enough that no two confidences tie (``overcommit``); and by the
order of the confidences (``remask_gap``); the decode by the relative
error of the program's pixels against the reference decoder's on the
program's final codes (``decode_rel``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark import traffic
from benchmark.drivers.common import (NoTF32, checked_steps, program_config,
                                      rel, release, request_seed, sample)
from benchmark.reference import showo_v1 as ref
from benchmark.roofline import attention_launch, conv_flops
from benchmark.weights import load_into, make_weights


def dims(conf):
    m = conf.model.showo
    phi = dict(m.get("phi", {}))
    d = ref.PhiDims(vocab_size=int(m.vocab_size),
                    **{k: int(v) for k, v in phi.items()})
    vq = dict(conf.model.vq_model.get("dims", {}))
    v = ref.VQDims(**{k: (tuple(x) if isinstance(x, list) else int(x))
                      for k, x in vq.items()
                      if k in ("ch", "dec_ch_mult", "dec_num_res_blocks",
                               "z_channels", "out_ch")})
    return d, v


def decoder_flops(v: ref.VQDims, batch: int, side: int) -> float:
    """Convolution FLOPs of the decoder from a side x side code grid."""
    c = v.ch * v.dec_ch_mult[-1]
    f = conv_flops(batch, side, side, v.z_channels, v.z_channels, 1)
    f += conv_flops(batch, side, side, v.z_channels, c, 3)

    def res(cin, cout, s):
        out = conv_flops(batch, s, s, cin, cout, 3)
        out += conv_flops(batch, s, s, cout, cout, 3)
        return out + (conv_flops(batch, s, s, cin, cout, 1)
                      if cin != cout else 0.0)

    f += 2 * res(c, c, side) + 4 * conv_flops(batch, side, side, c, c, 1)
    f += 2 * 2.0 * batch * (side * side) ** 2 * c
    s = side
    for i in reversed(range(len(v.dec_ch_mult))):
        cout = v.ch * v.dec_ch_mult[i]
        for j in range(v.dec_num_res_blocks[i]):
            f += res(c if j == 0 else cout, cout, s)
        if i != 0:
            s *= 2
            f += conv_flops(batch, s, s, cout, cout, 3)
        c = cout
    return f + conv_flops(batch, s, s, c, v.out_ch, 3)


# a masked position's token counts in the update's check where the
# reference's best score leads the next by more than this (the program's
# tokens lie within ~0.3 of the reference's best: ``token_gap``)
SURE = 1.0
# steps whose confidence noise has at least this scale count towards
# ``overcommit``: there two confidences (log p in bf16 + scale x Gumbel in
# fp32) tie at the cut-off with a chance of ~1e-4 a step at most, so a step
# commits the schedule's count exactly; at the later steps' smaller scales
# bf16 probabilities tie and the sampler rightly commits every tie
TIE_FREE = 0.1


class Driver:
    RATE = "images_per_min"
    RATE_SCALE = 60.0

    def __init__(self, wl: dict, seed: int, device: str, overrides: dict):
        self.wl, self.seed = wl, int(seed)
        self.device = torch.device(device)
        self.conf = program_config(wl, overrides)
        self.d, self.v = dims(self.conf)
        self.tr = wl["traffic"]
        self.batch = int(self.tr["batch"])
        self.requests = traffic.batches(self.seed, self.tr, 512)
        self.records: List[dict] = []
        c = self.conf
        self.T = int(c.get("generation_timesteps",
                           c.training.generation_timesteps))
        self.g = float(c.get("guidance_scale", c.training.guidance_scale))
        self.P = int(c.dataset.preprocessing.max_seq_length) + 1
        from showo_tpu_torch.inference_t2i import build_showo_config

        self.cfg = build_showo_config(c)

    # ------------------------------------------------------------ set-up
    def weight_specs(self):
        return (ref.phi_specs(self.d)
                + [("vq." + n, s) for n, s in ref.decoder_specs(self.v)])

    def make_weights(self, dtype):
        return make_weights(self.weight_specs(), self.seed, self.device,
                            dtype, {"vq.": torch.float32})

    def setup(self, spans) -> None:
        from showo_tpu_torch import inference_t2i as it
        from showo_tpu_torch.models.magvit import MagvitV2, VQConfig
        from showo_tpu_torch.models.showo import Showo
        from showo_tpu_torch.pipelines.t2i import T2IPipeline

        conf, dev = self.conf, self.device
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        self.dtype = dtype
        cfg = self.cfg
        w = self.make_weights(dtype)
        model = Showo(cfg, device=dev, dtype=dtype)
        load_into(model, {k: v for k, v in w.items()
                          if not k.startswith("vq.")})
        ov = dict(conf.model.vq_model.get("dims", {}))
        vq = MagvitV2(VQConfig(**{k: (tuple(x) if isinstance(x, list)
                                      else int(x)) for k, x in ov.items()}),
                      device=dev)
        load_into(vq, w, prefix="vq.")
        del w
        self.pipe = T2IPipeline(
            model=model.eval().requires_grad_(False),
            vq=vq.eval().requires_grad_(False),
            uni_prompting=it.build_prompting(conf),
            guidance_scale=self.g, timesteps=self.T,
            mask_schedule=conf.training.get("mask_schedule", "cosine"),
            max_seq_length=int(conf.dataset.preprocessing.max_seq_length),
            resolution=int(conf.dataset.params.resolution))
        self._states = None
        n = cfg.num_vq_tokens
        b = self.batch

        def keep_state(module, args):
            ids = args[0]
            if self._states is not None and ids.shape[1] == n + 2:
                self._states.append(ids[:b, 1:n + 1].to(torch.int32))

        self.pipe.model.showo.model.embed_tokens.register_forward_pre_hook(
            keep_state)
        warm = traffic.batches(self.seed + 1, self.tr, 1)[0]
        images = self.pipe.generate(warm, torch.Generator(
            device=dev).manual_seed(request_seed(self.seed, -1)))
        assert images.shape[0] == b

    # ------------------------------------------------------------ window
    def step(self, k: int, spans) -> int:
        prompts = self.requests[k]
        gen = torch.Generator(device=self.device).manual_seed(
            request_seed(self.seed, k))
        self._states = []
        with spans("generate_codes"):
            codes = self.pipe.generate_codes(prompts, gen)
        with spans("decode", sync=spans.profile):
            images = self.pipe.decode(codes)
        self.records.append({"k": k, "prompts": prompts, "codes": codes,
                             "states": self._states, "images": images})
        self._states = None
        return len(prompts)

    def finish(self) -> None:
        pass

    # ------------------------------------------------------------ counts
    def layout_counts(self, prompts):
        """(visible key pairs of the cached step's rows, prefix tokens) of
        one generate's [cond; null] rows."""
        n, P = self.cfg.num_vq_tokens, self.P
        img = torch.zeros((len(prompts), n), dtype=torch.long)
        seq = torch.cat([ref.t2i_layout(prompts, img, P - 1),
                         ref.t2i_layout([""] * len(prompts), img, P - 1)])
        mask = ref.omni_mask(seq)
        return int(mask[:, P:].sum()), int(mask[:, :P, :P].sum())

    def unit_flops(self, prompts) -> float:
        """Model FLOPs of one generate: the prefix prefill, every cached
        step of both towers of CFG (the sampled rows' logits over the
        codebook), and the decode."""
        d, cfg = self.d, self.cfg
        D, F_, Lr = d.hidden_size, d.intermediate_size, d.num_layers
        n, T, P = cfg.num_vq_tokens, self.T, self.P
        rows = 2 * len(prompts)
        per_tok = Lr * 2.0 * (4 * D * D + 2 * D * F_)
        vis_step, vis_prefix = self.layout_counts(prompts)
        prefill = rows * P * per_tok + Lr * 4.0 * D * vis_prefix
        step = (rows * (n + 2) * per_tok + Lr * 4.0 * D * vis_step
                + 2.0 * rows * n * D * cfg.codebook_size)
        side = int(round(math.sqrt(n)))
        return prefill + T * step + decoder_flops(self.v, len(prompts), side)

    def window_flops(self, records) -> float:
        return sum(self.unit_flops(r["prompts"]) for r in records)

    def kernel1_launches(self, records) -> Dict[int, list]:
        """Kernel 1's launches in the window: head dim -> [Launch, ...]."""
        d, n, P, T = self.d, self.cfg.num_vq_tokens, self.P, self.T
        out = []
        for r in records:
            vis, _ = self.layout_counts(r["prompts"])
            b2 = 2 * len(r["prompts"])
            one = attention_launch(b2, n + 2, P + n + 2, d.num_heads,
                                   d.num_heads, d.head_dim, vis)
            out += [one] * (T * d.num_layers)
        return {d.head_dim: out}

    # ------------------------------------------------------------ check
    def check(self, control: bool = False) -> Dict[str, tuple]:
        """{number: (value, limit)}; with ``control`` the control's
        readings at the same states are returned too, under
        ``<number>.control``."""
        chk = self.wl["check"]
        picked = sample(self.seed, self.records, int(chk["requests"]))
        self.pipe = None
        release(self.device)
        limits = chk["limits"]
        with NoTF32(), torch.no_grad():
            W = {k: v.float() for k, v in
                 self.make_weights(self.dtype).items()}
            vals = self.compare(W, picked, control)
        return {k: (v, limits.get(k.split(".")[0], 0.0))
                for k, v in vals.items()}

    def compare(self, W, sample, control) -> Dict[str, float]:
        d, cfg, dev = self.d, self.cfg, self.device
        n, C, off = cfg.num_vq_tokens, cfg.codebook_size, cfg.codebook_offset
        mask_id = cfg.mask_token_id
        T, g, P = self.T, self.g, self.P
        temps = ref.step_temperatures(T, 1.0)
        chk = checked_steps(self.seed, T, int(self.wl["check"]["steps"]))
        out = {"token_gap": 0.0, "remask_gap": 0.0, "commit_errors": 0.0,
               "overcommit": 0.0, "decode_rel": 0.0}
        if control:
            out.update({"token_gap.control": 0.0, "remask_gap.control": 0.0,
                        "decode_rel.control": 0.0})
        W_dec = {k[3:]: v for k, v in W.items() if k.startswith("vq.")}
        for r in sample:
            B = len(r["prompts"])
            states = [s.to(dev).long() for s in r["states"]]
            final = r["codes"].to(dev).long()
            if len(states) != T:
                out["commit_errors"] += abs(T - len(states)) * n
                continue
            out["commit_errors"] += float((states[0] != mask_id).sum())
            last = states[-1]
            out["commit_errors"] += float(((last != mask_id)
                                           & (final + off != last)).sum())
            gen = torch.Generator(device=dev).manual_seed(
                request_seed(self.seed, r["k"]))
            for s in range(T):
                u1 = torch.rand((B, n, C), generator=gen, device=dev)
                u2 = torch.rand((B, n), generator=gen, device=dev)
                unknown = states[s] == mask_id
                if s + 1 < T:
                    nxt = states[s + 1]
                    kept = (~unknown) & (nxt != states[s])
                    want = torch.clamp(torch.minimum(
                        unknown.sum(-1) - 1,
                        torch.tensor(ref.cosine_mask_len(s, T, n, dev),
                                     device=dev)), min=1)
                    masked = (nxt == mask_id).sum(-1)
                    # ties at the cut-off commit more than the schedule
                    # says; masking more never happens
                    out["commit_errors"] += float(
                        torch.clamp(masked - want, min=0).sum() + kept.sum())
                    if float(temps[s]) >= TIE_FREE:
                        out["overcommit"] += float(
                            torch.clamp(want - masked, min=0).sum())
                    committed = unknown & (nxt != mask_id)
                else:
                    committed = unknown
                if s not in chk:
                    continue
                img = torch.where(states[s] == mask_id, mask_id,
                                  states[s]).cpu()
                seq = torch.cat([
                    ref.t2i_layout(r["prompts"], img, P - 1),
                    ref.t2i_layout([""] * B, img, P - 1)])
                mask = ref.omni_mask(seq)
                rows, cols = slice(P + 1, P + 1 + n), slice(off, off + C)

                def scores(prec):
                    lg = ref.phi_logits(W, d, seq.to(dev), mask, rows, cols,
                                        prec)
                    lg = (1 + g) * lg[:B] - g * lg[B:]
                    return torch.log_softmax(lg, -1)

                logp = scores(ref.FP32)
                g1 = ref.gumbel(u1)
                score = logp + g1
                best = score.max(-1).values
                tok = final.clamp(0, C - 1)
                gap = best - score.gather(-1, tok[..., None])[..., 0]
                if committed.any():
                    out["token_gap"] = max(out["token_gap"],
                                           float(gap[committed].max()))
                conf_noise = temps[s].to(dev) * ref.gumbel(u2)
                top2 = score.topk(2, -1).values
                sure = (top2[..., 0] - top2[..., 1]) > SURE
                own = score.argmax(-1)
                if s + 1 < T:
                    out["remask_gap"] = max(out["remask_gap"], _remask_gap(
                        logp, conf_noise, unknown, committed, sure,
                        torch.where(committed, tok, own)))
                if control:
                    sc = scores(ref.CONTROL) + g1
                    pick_c = sc.argmax(-1)
                    gap_c = best - score.gather(-1, pick_c[..., None])[..., 0]
                    out["token_gap.control"] = max(
                        out["token_gap.control"],
                        float(gap_c[committed].max()))
                    if s + 1 < T:
                        lpc = sc - g1
                        conf_c = (lpc.gather(-1, pick_c[..., None])[..., 0]
                                  + conf_noise)
                        conf_c = torch.where(unknown, conf_c, -math.inf)
                        k_c = committed.sum(-1, keepdim=True)
                        top = conf_c.argsort(-1, descending=True)
                        rank = top.argsort(-1)
                        com_c = unknown & (rank < k_c)
                        out["remask_gap.control"] = max(
                            out["remask_gap.control"], _remask_gap(
                                logp, conf_noise, unknown, com_c, sure,
                                torch.where(com_c, pick_c, own)))
            pix = ref.decode_codes(W_dec, self.v, final)
            prog = torch.as_tensor(r["images"], device=dev)
            out["decode_rel"] = max(out["decode_rel"], rel(prog, pix))
            if control:
                pc = ref.decode_codes(W_dec, self.v, final,
                                       ref.CONTROL.decoder)
                out["decode_rel.control"] = max(out["decode_rel.control"],
                                                rel(pc, pix))
        return out


def _remask_gap(logp, conf_noise, unknown, committed, sure,
                tokens) -> float:
    """How far the best confidence the step left masked lies above the
    worst it committed (0 when the committed ones are the most
    confident), confidences log p + noise under the reference.  A masked
    position's sampled token is not seen: only those whose reference score
    leads by more than ``SURE`` (``sure``), where the program's token is the
    reference's, count among the masked."""
    conf = logp.gather(-1, tokens[..., None])[..., 0] + conf_noise
    left = unknown & ~committed & sure
    hi = torch.where(left, conf, -math.inf).max(-1).values
    lo = torch.where(committed, conf, math.inf).min(-1).values
    gap = torch.clamp(hi - lo, min=0.0)
    gap = torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap))
    return float(gap.max())
