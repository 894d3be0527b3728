"""Show-o2 stage-1 training through ``Stage1Trainer.train_step``: the
training cell's steps, and its check.

Set-up builds the trainer as ``train_stage_one.build_trainer`` does, on
fp32 master weights made from the seed, and drives that one trainer
through its first three steps; the window runs the same trainer on.  A
step is one host batch of the stage-1 layouts (``batch_size_t2i`` t2i rows,
then ``batch_size_mmu`` understanding rows of ``max_seq_length`` tokens,
pixels uniform in [-1, 1]), made on the host from the seed in a pool
before the window and staged to the card by the step as a loader's batch
would be, with the step's posterior, time and noise draws made on the
device from the seed (``noise``).  The step is the program's: the VAE
encode, the plan, forward, backward under remat, the clip and AdamW.

The check follows the first three steps with the reference (fp32, dense):
each step's losses (``loss_rel``), the first step's clipped gradient by
the worst leaf, as AdamW's first moment holds it (``grad_gap``), and the
parameters' change after the three steps by the worst leaf
(``change_gap``), each leaf's gap of norms over the larger of its own
reference norm and the median leaf's.  Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change.  Then it follows one step after the window, taken
through the window's own call and feed from the trainer as the window left
it: the reference replays that step from the program's state before it
(the trained parameters and AdamW's moments, at the step count and
learning rate the benchmark counts), and the step's losses
(``late_loss_rel``) and the change by leaf (``late_change_gap``) are
compared as above.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark import traffic
from benchmark.drivers.common import NoTF32, program_config, release, seed_of
from benchmark.drivers.t2i_v2 import dims
from benchmark.reference import showo2_train as rt
from benchmark.reference import showo2_v2 as ref
from benchmark.reference.showo_v1 import word_id
from benchmark.weights import load_into, make_weights

CHECKED_STEPS = 3
# leaves whose reference gradient is under this share of the median
# leaf's are left out of the change (round-off moves them under AdamW)
SILENT_LEAF = 1e-3


def host_batch(seed: int, k: int, n_t2i: int, n_mmu: int, L: int,
               n_image: int, res: int, captions: List[str],
               max_text: int) -> dict:
    """Batch ``k`` of the stage-1 layouts, one caption a row: t2i rows
    ([bos] text [boi] image [eoi][eos] pads, no labels), then understanding
    rows ([bos][boi] image [eoi] text [eos] pads, labels on the text), the
    stand-in tokenizer's ids; pixels uniform in [-1, 1]."""
    rng = np.random.default_rng([int(seed), 7, k])
    tt, tl, mp, im, und = [], [], [], [], []
    for i, caption in enumerate(captions):
        ids = [word_id(w) for w in caption.split()][:max_text]
        I = ref.IDS
        if i < n_t2i:
            toks = ([I["bos"]] + ids + [I["boi"]] + [I["img_pad"]] * n_image
                    + [I["eoi"], I["eos"]])
            labs = [-100] * len(toks)
            off = len(ids) + 2
        else:
            toks = ([I["bos"], I["boi"]] + [I["img_pad"]] * n_image
                    + [I["eoi"]] + ids + [I["eos"]])
            labs = ([I["bos"], I["boi"]] + [-100] * n_image + [I["eoi"]]
                    + ids + [I["eos"]])
            off = 2
        toks += [I["pad"]] * (L - len(toks))
        labs += [-100] * (L - len(labs))
        tt.append(toks)
        tl.append(labs)
        mp.append([[off, n_image]])
        im.append([int(x == I["img_pad"]) for x in toks])
        und.append(int(i >= n_t2i))
    B = n_t2i + n_mmu
    return {"text_tokens": np.asarray(tt, np.int64),
            "text_labels": np.asarray(tl, np.int64),
            "modality_positions": np.asarray(mp, np.int64),
            "image_masks": np.asarray(im, np.int64),
            "is_und": np.asarray(und, np.int32),
            "images": rng.uniform(-1, 1, size=(B, res, res, 3))
            .astype(np.float32)}


class Driver:
    RATE = "train_samples_per_s"
    RATE_SCALE = 1.0

    def __init__(self, wl: dict, seed: int, device: str, overrides: dict):
        self.wl, self.seed = wl, int(seed)
        self.device = torch.device(device)
        self.conf = program_config(wl, overrides)
        self.d = dims(self.conf)
        c = self.conf
        tr = c.training
        self.n_t2i, self.n_mmu = int(tr.batch_size_t2i), int(
            tr.batch_size_mmu)
        self.L = int(c.dataset.preprocessing.max_seq_length)
        self.res = int(c.dataset.preprocessing.resolution)
        B = self.n_t2i + self.n_mmu
        n_pool = int(wl["traffic"]["pool"])
        caps = traffic.prompts(self.seed, wl["traffic"], n_pool * B)
        self.pool = [host_batch(self.seed, k, self.n_t2i, self.n_mmu,
                                self.L, self.d.n_image, self.res,
                                caps[k * B:(k + 1) * B],
                                int(c.dataset.preprocessing.get(
                                    "max_text_len", 256)))
                     for k in range(n_pool)]
        self.records: List[dict] = []
        self.lr = float(tr.learning_rate)
        self.warmup = int(tr.get("warmup_steps", 0))
        self.und_t0 = tr.get("und_max_t0", 1.0)
        self.frozen = tuple(c.model.get("frozen_params", []) or [])

    # ------------------------------------------------------------ feed
    def noise(self, k: int) -> dict:
        """The step's draws: the posterior's normal draw and the noise x0
        (the latents' shape), the times t (sigmoid of a normal, the
        understanding rows' in [und_max_t0, 1])."""
        d, B = self.d, self.n_t2i + self.n_mmu
        g = torch.Generator(device=self.device).manual_seed(
            seed_of(self.seed, 8, k))
        shape = (B, d.latent, d.grid_h, d.grid_w)
        eps = torch.randn(shape, generator=g, device=self.device)
        x0 = torch.randn(shape, generator=g, device=self.device)
        t = torch.sigmoid(torch.randn((B,), generator=g, device=self.device))
        if self.und_t0 is not None:
            t0 = float(self.und_t0)
            und = torch.arange(B, device=self.device) >= self.n_t2i
            t = torch.where(und, t * (1 - t0) + t0, t)
        # the posterior's draw has the latents' time axis (one frame)
        return {"vae_eps": eps[:, :, None], "x0": x0, "t": t}

    def batch(self, k: int) -> dict:
        return self.pool[k % len(self.pool)]

    # ------------------------------------------------------------ set-up
    def weight_specs(self):
        return ref.model_specs(self.d) + rt.encoder_specs(self.d)

    def make_weights(self):
        return make_weights(self.weight_specs(), self.seed, self.device,
                            torch.float32)

    def trained(self) -> List[str]:
        return [s[0] for s in ref.model_specs(self.d)
                if not any(f in s[0] for f in self.frozen)]

    def setup(self, spans) -> None:
        from showo_tpu_torch import inference_t2i_v2 as it
        from showo_tpu_torch.show_o2 import train_stage_one as ts
        from showo_tpu_torch.show_o2.showo2 import Showo2
        from showo_tpu_torch.show_o2.wan_vae import WanVAE

        conf, dev = self.conf, self.device
        w = self.make_weights()
        model = Showo2(it.build_showo2_config(conf), device=dev,
                       dtype=torch.float32)
        load_into(model, {k: v for k, v in w.items()
                          if not k.startswith("vae.")})
        vae = WanVAE(it.vae_config(conf), device=dev)
        load_into(vae, w, prefix="vae.")
        del w
        model.train().requires_grad_(True)
        self.trainer = ts.Stage1Trainer(
            model=model, vae=vae,
            sc=ts.stage1_config(conf),
            transport=ts.build_transport(conf, model),
            frozen_substrings=self.frozen)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        if names != self.trained():
            raise ValueError("the program trains other leaves than the "
                             "configuration's frozen_params leave")
        self.prog = {"losses": []}
        for k in range(CHECKED_STEPS):
            m = self.trainer.train_step(self.batch(k), noise=self.noise(k))
            self.prog["losses"].append(tuple(
                float(m[x]) for x in ("loss", "loss_ntp", "loss_flow")))
            if k == 0:
                # AdamW's first moment after one step is 0.1 g (none: the
                # optimizer got no gradient)
                st = self.trainer.optimizer.adamw.state
                self.prog["grad_norms"] = {
                    n: float(st[p]["exp_avg"].norm()) / 0.1
                    if "exp_avg" in st.get(p, {}) else 0.0
                    for n, p in zip(names, self.trainer.optimizer.params)}
        w0 = {k: v for k, v in self.make_weights().items()
              if k in set(names)}
        params = dict(model.named_parameters())
        self.prog["changes"] = {n: float((params[n].detach() - w0[n]).norm())
                                for n in names}
        del w0
        self.next = CHECKED_STEPS

    # ------------------------------------------------------------ window
    def step(self, k: int, spans) -> int:
        i = self.next + k
        with spans("train_step"):
            self.trainer.train_step(self.batch(i), noise=self.noise(i))
        self.records.append({"k": i})
        return self.n_t2i + self.n_mmu

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ counts
    def step_flops(self) -> float:
        """Model FLOPs of one step: 6 per trained parameter a token that
        passes it (forward and backward), the attention's visible pairs
        three times over, the frozen SigLIP tower's and VAE encoder's
        forward; nothing for recomputation."""
        d, B, L = self.d, self.n_t2i + self.n_mmu, self.L
        n = d.n_image - 1
        toks = B * L
        qd = d.heads_llm * d.hd_llm + 2 * d.kv_llm * d.hd_llm
        qwen = d.layers_llm * (d.d_llm * qd + d.heads_llm * d.hd_llm
                               * d.d_llm + 3 * d.d_llm * d.ffn_llm)
        dd = d.heads_dit * d.hd_dit + 2 * d.kv_dit * d.hd_dit
        dit = d.layers_dit * (d.d_dit * dd + d.heads_dit * d.hd_dit
                              * d.d_dit + 3 * d.d_dit * d.ffn_dit)
        proj = d.d_llm * d.d_dit + d.d_dit ** 2 + d.d_dit * 4 * d.latent
        head = d.d_llm * d.vocab
        img = ((d.d_clip + d.d_llm) * d.d_llm + d.d_llm ** 2
               + 4 * d.latent * d.d_llm)
        trained = 6.0 * (toks * (qwen + dit + proj + head) + B * n * img)
        offs = [int(x) for x in self.pool[0]["modality_positions"][:, 0, 0]]
        vis = int(ref.gen_mask(torch.tensor(offs), d.n_image, L).sum())
        attn = 3 * 4.0 * vis * (d.layers_llm * d.heads_llm * d.hd_llm
                                + d.layers_dit * d.heads_dit * d.hd_dit)
        sig = d.layers_clip * (B * n * 2.0 * (4 * d.d_clip ** 2 + 2
                                              * d.d_clip * d.ffn_clip)
                               + B * 4.0 * d.d_clip * n * n)
        sig += B * n * 2.0 * 4 * d.latent * d.d_clip
        return trained + attn + sig + self.encoder_flops(B)

    def encoder_flops(self, batch: int) -> float:
        from benchmark.roofline import conv_flops

        d, s = self.d, self.res
        f = conv_flops(batch, s, s, 3, d.vae_dim, 3)
        for kind, a, b in rt._encoder_plan(d):
            if kind == "res":
                f += (conv_flops(batch, s, s, a, b, 3)
                      + conv_flops(batch, s, s, b, b, 3)
                      + (conv_flops(batch, s, s, a, b, 1) if a != b
                         else 0.0))
            else:
                s //= 2
                f += conv_flops(batch, s, s, a, a, 3)
        top = d.vae_dim * d.vae_mult[-1]
        f += 4 * conv_flops(batch, s, s, top, top, 3)
        f += conv_flops(batch, s, s, top, 4 * top, 1)
        f += 4.0 * batch * (s * s) ** 2 * top
        return f + conv_flops(batch, s, s, top, 2 * d.latent, 3)

    def window_flops(self, records) -> float:
        return len(records) * self.step_flops()

    # ------------------------------------------------------------ check
    def lr_at(self, step: int) -> float:
        w = self.warmup
        return self.lr * (min(step, w) / w if w > 0 else 1.0)

    def late_step(self) -> dict:
        """One step after the window through the window's own call and
        feed, from the trainer as the window left it: the state before it
        (the trained parameters, kept on the card; AdamW's moments, on the
        host), the step's losses and the change by leaf."""
        opt = self.trainer.optimizer
        names = self.trained()
        k = self.next + len(self.records)
        st = opt.adamw.state
        before, moments = {}, {}
        for n, p in zip(names, opt.params):
            before[n] = p.detach().clone()
            s = st.get(p, {})
            moments[n] = ((s["exp_avg"].to("cpu", copy=True),
                           s["exp_avg_sq"].to("cpu", copy=True))
                          if "exp_avg" in s else None)
        m = self.trainer.train_step(self.batch(k), noise=self.noise(k))
        return {"k": k, "before": before, "moments": moments,
                "losses": [tuple(float(m[x]) for x in
                                 ("loss", "loss_ntp", "loss_flow"))],
                "changes": {n: float((p.detach() - before[n]).norm())
                            for n, p in zip(names, opt.params)}}

    def ref_batch(self, W, k: int) -> dict:
        """Step ``k``'s host batch and draws as the reference takes them:
        the posterior sample encoded by the reference's VAE encoder, the
        flow plan's x_t, u_t and t."""
        hb, nz = self.batch(k), self.noise(k)
        dev = self.device
        b = {x: torch.as_tensor(hb[x], device=dev) for x in
             ("text_tokens", "text_labels", "modality_positions",
              "image_masks")}
        x1 = rt.encode(W, self.d, torch.as_tensor(hb["images"], device=dev),
                       nz["vae_eps"][:, :, 0])
        t = nz["t"][:, None, None, None]
        b["xt"] = t * x1 + (1 - t) * nz["x0"]
        b["ut"] = x1 - nz["x0"]
        b["t"] = nz["t"]
        return b

    def ref_steps(self, W, ks: List[int], prec, rows_kept: int,
                  state=None) -> dict:
        sc = self.conf.training
        trained = self.trained()
        for k in trained:
            W[k].requires_grad_(True)
        batches = [self.ref_batch(W, k) for k in ks]
        return rt.train_steps(
            W, self.d, batches, trained, [self.lr_at(k) for k in ks],
            (float(sc.get("ntp_coeff", 0.2)), float(sc.get("flow_coeff",
                                                          1.0))),
            float(sc.get("max_grad_norm", 1.0)), 0.01, prec,
            rows_kept=rows_kept, state=state, first_step=ks[0])

    def reference(self, prec=ref.FP32, rows_kept: int = 0) -> dict:
        """The reference's three steps from the seed's weights: losses,
        the first step's clipped gradient norms, the changes by leaf."""
        W = self.make_weights()
        out = self.ref_steps(W, list(range(CHECKED_STEPS)), prec, rows_kept)
        w0 = self.make_weights()
        out["changes"] = {k: float((W[k].detach() - w0[k]).norm())
                          for k in self.trained()}
        return out

    def late_reference(self, late: dict, prec=ref.FP32,
                       rows_kept: int = 0) -> dict:
        """The reference's replay of the step after the window from the
        program's state before it; the frozen weights from the seed."""
        dev = self.device
        W = self.make_weights()
        state = []
        for n in self.trained():
            W[n] = late["before"][n].clone()
            mo = late["moments"][n]
            state.append(None if mo is None else
                         tuple(x.to(dev, copy=True) for x in mo))
        out = self.ref_steps(W, [late["k"]], prec, rows_kept, state)
        out["changes"] = {n: float((W[n].detach() - late["before"][n])
                                   .norm()) for n in self.trained()}
        return out

    def check(self, control: bool = False) -> Dict[str, tuple]:
        late = self.late_step()
        self.trainer = None
        release(self.device)
        limits = self.wl["check"]["limits"]
        with NoTF32():
            r = self.reference()
            rl = self.late_reference(late)
            vals = dict(compare(self.prog, r), **compare_late(late, rl))
            if control:
                for tag, kw in (("control", dict(prec=ref.CONTROL)),
                                ("half_batch", dict(rows_kept=(
                                    self.n_t2i + self.n_mmu) // 2))):
                    f = dict(compare(self.reference(**kw), r),
                             **compare_late(self.late_reference(late, **kw),
                                            rl))
                    vals.update({f"{k}.{tag}": v for k, v in f.items()})
        return {k: (v, limits.get(k.split(".")[0], 0.0))
                for k, v in vals.items()}


def _loss_gap(prog: list, ref_: list) -> float:
    """The largest relative gap of a step's ntp and flow losses."""
    if len(prog) != len(ref_):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-12)
               for ps, rs in zip(prog, ref_)
               for p, r in zip(ps[1:], rs[1:]))


def _change_gap(prog: dict, ref_: dict, grads: dict) -> float:
    """The worst leaf's gap of change norms over the larger of its own
    reference norm and the median leaf's, the leaves whose reference
    gradient is under ``SILENT_LEAF`` of the median leaf's left out."""
    med = statistics.median(grads.values())
    counted = [k for k, v in grads.items() if v >= SILENT_LEAF * med]
    med_c = statistics.median(ref_[k] for k in counted)
    return max(abs(prog[k] - ref_[k]) / max(ref_[k], med_c, 1e-30)
               for k in counted)


def compare_late(prog: dict, ref_: dict) -> Dict[str, float]:
    return {"late_loss_rel": _loss_gap(prog["losses"], ref_["losses"]),
            "late_change_gap": _change_gap(prog["changes"], ref_["changes"],
                                           ref_["grad_norms"])}


def compare(prog: dict, ref_: dict) -> Dict[str, float]:
    gr = ref_["grad_norms"]
    med = statistics.median(gr.values())
    grad = max(abs(prog["grad_norms"][k] - v) / max(v, med)
               for k, v in gr.items())
    return {"loss_rel": _loss_gap(prog["losses"], ref_["losses"]),
            "grad_gap": grad,
            "change_gap": _change_gap(prog["changes"], ref_["changes"], gr)}
