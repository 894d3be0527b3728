"""Show-o2 text-to-image through ``T2IV2Pipeline.generate_latents`` then
``decode``: the closed loop of a t2i cell, and its check.

Set-up builds the pipeline with ``inference_t2i_v2.build_pipeline(config,
models=...)`` on weights made from the seed, and warms it up with one
generate of the cell's batch.  A request is one batch of prompts: the
Euler ODE with CFG from latents z ~ N(0, 1) drawn from the run's seed (the
``noise`` the pipeline takes), then the VAE decode and the pixels on the
host.

The check follows the program step by step: a wrapper on the pipeline's
``drift`` keeps the latents each velocity evaluation reads (the program's
state).  For a sample of the window's generates and steps, drawn from the
seed, the program's velocity at that step, read off its Euler update
((x_{s+1} - x_s) / dt), is compared with the reference's guided velocity
at x_s (``velocity_rel``, the largest relative L2 error of an image's
velocity); the start and the number of evaluations exactly
(``state_errors``); the decode by the relative error of the program's
pixels against the reference decoder's on the program's final latents
(``decode_rel``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import traffic
from benchmark.drivers.common import (NoTF32, checked_steps, program_config,
                                      rel, release, sample, seed_of)
from benchmark.reference import showo2_v2 as ref
from benchmark.roofline import attention_launch, conv_flops
from benchmark.weights import load_into, make_weights


def dims(conf) -> ref.Dims:
    m = conf.model.showo
    sig = dict(m.get("siglip", {}))
    dit = dict(m.get("dit", {}))
    vae = dict(conf.model.vae_model.get("dims", {}))
    kw = dict(
        vocab=int(m.get("llm_vocab_size") or 151940),
        d_llm=int(m.hidden_size),
        ffn_llm=int(m.get("llm_intermediate_size", 8960)),
        layers_llm=int(m.get("llm_num_layers", 28)),
        heads_llm=int(m.get("llm_num_heads", 12)),
        kv_llm=int(m.get("llm_num_kv_heads", 2)),
        hd_llm=int(m.get("llm_head_dim", 128)),
        d_clip=int(m.clip_latent_dim),
        latent=int(m.image_latent_dim),
        grid_h=int(m.image_latent_height), grid_w=int(m.image_latent_width),
        patch=int(m.patch_size),
        layers_dit=int(m.get("num_diffusion_layers", 10)))
    names = {"hidden_size": "d_clip", "intermediate_size": "ffn_clip",
             "num_heads": "heads_clip", "num_layers": "layers_clip",
             "num_positions": "positions"}
    kw.update({names[k]: int(v) for k, v in sig.items() if k in names})
    names = {"hidden_size": "d_dit", "intermediate_size": "ffn_dit",
             "num_heads": "heads_dit", "num_kv_heads": "kv_dit",
             "head_dim": "hd_dit"}
    kw.update({names[k]: int(v) for k, v in dit.items() if k in names})
    names = {"dim": "vae_dim", "dim_mult": "vae_mult",
             "num_res_blocks": "vae_res", "temperal_downsample": "vae_tdown"}
    kw.update({names[k]: (tuple(v) if isinstance(v, list) else int(v))
               for k, v in vae.items() if k in names})
    return ref.Dims(**kw)


class Driver:
    RATE = "images_per_min"
    RATE_SCALE = 60.0

    def __init__(self, wl: dict, seed: int, device: str, overrides: dict):
        self.wl, self.seed = wl, int(seed)
        self.device = torch.device(device)
        self.conf = program_config(wl, overrides)
        self.d = dims(self.conf)
        self.tr = wl["traffic"]
        self.batch = int(self.tr["batch"])
        self.requests = traffic.batches(self.seed, self.tr, 512)
        self.records: List[dict] = []
        c = self.conf
        self.g = float(c.get("guidance_scale", 7.5))
        tr = c.transport
        self.grid = ref.time_grid(int(tr.get("num_inference_steps", 50)),
                                  float(tr.get("time_shifting_factor", 3.0)))
        self.max_text = int(c.dataset.preprocessing.get("max_text_len", 256))

    # ------------------------------------------------------------ set-up
    def weight_specs(self):
        return ref.model_specs(self.d) + ref.vae_specs(self.d)

    def make_weights(self, dtype):
        return make_weights(self.weight_specs(), self.seed, self.device,
                            dtype, {"vae.": torch.float32})

    def noise(self, k: int) -> torch.Tensor:
        d = self.d
        gen = torch.Generator(device=self.device).manual_seed(
            seed_of(self.seed, 6, k + 1))
        return torch.randn((self.batch, d.latent, d.grid_h, d.grid_w),
                           generator=gen, device=self.device)

    def setup(self, spans) -> None:
        from showo_tpu_torch import inference_t2i_v2 as it
        from showo_tpu_torch.show_o2.showo2 import Showo2
        from showo_tpu_torch.show_o2.wan_vae import WanVAE

        conf, dev = self.conf, self.device
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        self.dtype = dtype
        w = self.make_weights(dtype)
        model = Showo2(it.build_showo2_config(conf), device=dev, dtype=dtype)
        load_into(model, {k: v for k, v in w.items()
                          if not k.startswith("vae.")})
        vae = WanVAE(it.vae_config(conf), device=dev)
        load_into(vae, w, prefix="vae.")
        del w
        self.pipe = it.build_pipeline(
            conf, dev, models=(model.eval().requires_grad_(False),
                               vae.eval().requires_grad_(False)))
        self._states = None
        b = self.batch
        drift = self.pipe.drift

        def kept_drift(text, mp):
            f = drift(text, mp)

            def g(x, t):
                if self._states is not None:
                    self._states.append(x[:b].clone())
                return f(x, t)

            return g

        self.pipe.drift = kept_drift
        self._rf = None
        self._spans = spans

        def enter(module, args):
            if self._spans.profile:
                self._rf = torch.profiler.record_function("bench/siglip")
                self._rf.__enter__()

        def leave(module, args, out):
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
                self._rf = None

        self.pipe.model.und_trans.register_forward_pre_hook(enter)
        self.pipe.model.und_trans.register_forward_hook(leave)
        warm = traffic.batches(self.seed + 1, self.tr, 1)[0]
        images = self.pipe.generate(warm, noise=self.noise(-1))
        assert images.shape[0] == b

    # ------------------------------------------------------------ window
    def step(self, k: int, spans) -> int:
        prompts = self.requests[k]
        z = self.noise(k)
        self._states = []
        with spans("generate_latents"):
            lat = self.pipe.generate_latents(prompts, noise=z)
        with spans("decode", sync=spans.profile):
            images = self.pipe.decode(lat)
        self.records.append({"k": k, "prompts": prompts, "z": z,
                             "latents": lat, "states": self._states,
                             "images": images, "rows": self.pipe.last_rows})
        self._states = None
        return len(prompts)

    def finish(self) -> None:
        pass

    # ------------------------------------------------------------ counts
    def layout(self, prompts):
        return ref.gen_layout(prompts, self.d.n_image, self.max_text,
                              self.g > 0)

    def visible(self, prompts) -> int:
        text, offs = self.layout(prompts)
        return int(ref.gen_mask(offs, self.d.n_image, text.shape[1]).sum())

    def unit_flops(self, prompts) -> float:
        """Model FLOPs of one generate: every velocity evaluation (SigLIP,
        the two patch embeddings and the fusion, Qwen2.5, the DiT head
        over all rows of both CFG halves) and the VAE decode."""
        d = self.d
        text, _ = self.layout(prompts)
        R, L = text.shape
        n = d.n_image - 1
        vis = self.visible(prompts)
        hp = d.patch * d.patch * d.latent
        sig = d.layers_clip * (R * n * 2.0 * (4 * d.d_clip ** 2 + 2 * d.d_clip
                                              * d.ffn_clip)
                               + R * 4.0 * d.d_clip * n * n)
        emb = R * n * 2.0 * hp * (d.d_clip + d.d_llm)
        fus = R * n * 2.0 * ((d.d_clip + d.d_llm) * d.d_llm + d.d_llm ** 2)
        qd = d.heads_llm * d.hd_llm + 2 * d.kv_llm * d.hd_llm
        llm = d.layers_llm * (R * L * 2.0 * (d.d_llm * qd + d.heads_llm
                                             * d.hd_llm * d.d_llm
                                             + 3 * d.d_llm * d.ffn_llm)
                              + 4.0 * d.heads_llm * d.hd_llm * vis)
        dd = d.heads_dit * d.hd_dit + 2 * d.kv_dit * d.hd_dit
        dit = d.layers_dit * (R * L * 2.0 * (d.d_dit * dd + d.heads_dit
                                             * d.hd_dit * d.d_dit
                                             + 3 * d.d_dit * d.ffn_dit)
                              + 4.0 * d.heads_dit * d.hd_dit * vis)
        proj = R * L * 2.0 * (d.d_llm * d.d_dit + d.d_dit ** 2
                              + d.d_dit * hp)
        evals = len(self.grid) - 1
        return evals * (sig + emb + fus + llm + dit + proj) + \
            self.decode_flops(len(prompts))

    def decode_flops(self, batch: int) -> float:
        d = self.d
        s = d.grid_h
        top = d.vae_dim * d.vae_mult[-1]
        f = conv_flops(batch, s, s, d.latent, d.latent, 1)
        f += conv_flops(batch, s, s, d.latent, top, 3)

        def res(a, b, s):
            return (conv_flops(batch, s, s, a, b, 3)
                    + conv_flops(batch, s, s, b, b, 3)
                    + (conv_flops(batch, s, s, a, b, 1) if a != b else 0.0))

        f += 2 * res(top, top, s) + conv_flops(batch, s, s, top, 4 * top, 1)
        f += 4.0 * batch * (s * s) ** 2 * top
        for kind, a, b in ref._decoder_plan(d):
            if kind == "res":
                f += res(a, b, s)
            else:
                s *= 2
                f += conv_flops(batch, s, s, a, a // 2, 3)
        return f + conv_flops(batch, s, s, d.vae_dim, 3, 3)

    def window_flops(self, records) -> float:
        return sum(self.unit_flops(r["prompts"]) for r in records)

    def kernel1_launches(self, records) -> Dict[int, list]:
        """Kernel 1's launches in the window: head dim -> [Launch, ...]
        (Qwen's at its head dim, the DiT's at its own)."""
        d = self.d
        evals = len(self.grid) - 1
        out: Dict[int, list] = {d.hd_llm: [], d.hd_dit: []}
        for r in records:
            text, _ = self.layout(r["prompts"])
            R, L = text.shape
            vis = self.visible(r["prompts"])
            out[d.hd_llm] += [attention_launch(
                R, L, L, d.heads_llm, d.kv_llm, d.hd_llm, vis)] * (
                    evals * d.layers_llm)
            out[d.hd_dit] += [attention_launch(
                R, L, L, d.heads_dit, d.kv_dit, d.hd_dit, vis)] * (
                    evals * d.layers_dit)
        return out

    # ------------------------------------------------------------ check
    def check(self, control: bool = False) -> Dict[str, tuple]:
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
        d, dev, grid = self.d, self.device, self.grid
        evals = len(grid) - 1
        chk = checked_steps(self.seed, evals, int(self.wl["check"]["steps"]))
        out = {"velocity_rel": 0.0, "state_errors": 0.0, "decode_rel": 0.0}
        if control:
            out.update({"velocity_rel.control": 0.0,
                        "decode_rel.control": 0.0})
        for r in sample:
            states = r["states"]
            if len(states) != evals:
                out["state_errors"] += abs(evals - len(states))
                continue
            out["state_errors"] += float((states[0] != r["z"]).sum())
            text, offs = self.layout(r["prompts"])
            if tuple(text.shape) != tuple(r["rows"]):
                out["state_errors"] += 1
            xs = states + [r["latents"].float()]
            for s in chk:
                dt = float(grid[s + 1] - grid[s])
                v_prog = (xs[s + 1] - xs[s]) / dt
                v_ref = ref.velocity(W, d, text.to(dev), offs, xs[s],
                                     grid[s], self.g)
                out["velocity_rel"] = max(out["velocity_rel"],
                                          _rel_rows(v_prog, v_ref))
                if control:
                    v_c = ref.velocity(W, d, text.to(dev), offs, xs[s],
                                       grid[s], self.g, ref.CONTROL)
                    out["velocity_rel.control"] = max(
                        out["velocity_rel.control"], _rel_rows(v_c, v_ref))
            pix = ref.decode(W, d, r["latents"].float())
            prog = torch.as_tensor(r["images"], device=dev)
            out["decode_rel"] = max(out["decode_rel"], rel(prog, pix))
            if control:
                pc = ref.decode(W, d, r["latents"].float(),
                                ref.CONTROL.decoder)
                out["decode_rel.control"] = max(out["decode_rel.control"],
                                                rel(pc, pix))
        return out


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error over the batch's images."""
    num = (a.float() - b).flatten(1).norm(dim=1)
    return float((num / b.flatten(1).norm(dim=1).clamp(min=1e-12)).max())
