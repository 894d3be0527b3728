"""Show-o2 stage-1 trainer (show-o2/train_stage_one.py).

    python -m showo_tpu_torch.show_o2.train_stage_one \
        config=configs/showo2_1.5b_stage_1_a.yaml [device=cpu]

Counterpart of ``showo_tpu/show_o2/train_stage_one.py``.  One step does
what the reference's ``prepare_latents_and_labels`` and forward do
(train_stage_one.py:345-471):
  1. the frozen Wan2.1 VAE encodes the pixels, images [B, H, W, 3] or
     videos [B, T, H, W, 3] (the time axis kept);
  2. a time t per sample from the transport; understanding samples take
     the ``und_max_t0`` path (t0 set before the draw and the shift), from
     the same draw, and with ``und_max_t0`` 1.0 their flow rows are
     zeroed;
  3. the noise x0 and the linear plan (xt, ut);
  4. the attention inputs of the route: the dense omni bias, or on
     ``trainable`` the kernels' metadata (``seg_from_modality_positions``);
  5. ``ntp_coeff * loss_ntp + flow_coeff * loss_flow`` and its gradient;
  6. the gradient norm, then the optimizer (``training/train_step.py``'s):
     clip by global norm, AdamW, linear warmup, gradient accumulation,
     with the ``frozen_params`` substrings frozen (``requires_grad=False``:
     their tensors stay as they are, bit for bit).

Precision: fp32 master weights; on CUDA the forward runs under
``torch.autocast(bfloat16)`` (the kernels take bf16), the VAE in fp32.
The draws come from one ``torch.Generator`` a step (:func:`step_generator`
of (seed, step)): the VAE's posterior noise, the time draw, then x0; the
tests hand in JAX's draws instead (``noise``).  The CLI reads the jsonl
image-text data (``data/image_text.py``), saves a ring of checkpoints
(``utils/checkpoint.py``) with the loader state every ``save_every``
steps and resumes from ``latest``; ``generate_every`` writes validation
images and VAE reconstruction panels.  The entry points run on CUDA
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from showo_tpu_torch.ops.flash_attention import seg_from_modality_positions
from showo_tpu_torch.show_o2.masks import omni_attn_mask
from showo_tpu_torch.show_o2.qwen2 import check_route
from showo_tpu_torch.show_o2.showo2 import Showo2, showo2_forward
from showo_tpu_torch.show_o2.transport import Transport
from showo_tpu_torch.show_o2.wan_vae import WanVAE, wan_decode, wan_encode
from showo_tpu_torch.training.train_showo import step_generator
from showo_tpu_torch.training.optim import jax_tensors
from showo_tpu_torch.training.train_step import Optimizer, global_norm
from showo_tpu_torch.utils.device import entry_device

logger = logging.getLogger(__name__)

TRAIN_ROUTES = ("dense", "trainable")


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    learning_rate: float = 1e-4
    max_grad_norm: float = 1.0
    ntp_coeff: float = 0.2
    flow_coeff: float = 1.0
    und_max_t0: Optional[float] = 1.0
    weight_decay: float = 0.01
    warmup_steps: int = 0
    grad_accum_steps: int = 1
    # "dense" (the additive omni bias) | "trainable" (kernels 7 / 8)
    attn_impl: str = "dense"
    # "adamw" | "adamw_bf16" | "adafactor" (training/optim.py)
    optimizer: str = "adamw"
    # the layer remat policy of utils/remat.py: "none" | "full" | "dots" |
    # "qkv" | "qkv_fc1" | "qkv_attn" | "qkv_fc1_attn"
    remat: str = "full"


def freeze(model: torch.nn.Module,
           frozen_substrings: Sequence[str]) -> torch.nn.Module:
    """Every parameter trainable but those whose name holds one of
    ``frozen_substrings`` (the reference's ``_freeze_params``,
    utils.py:75-80)."""
    for n, p in model.named_parameters():
        p.requires_grad_(not any(s in n for s in frozen_substrings))
    return model


def warmup(sc: Stage1Config):
    """The learning-rate factor at an optimizer step: linear from 0 over
    ``warmup_steps`` (optax.linear_schedule), 1 without warmup."""
    w = sc.warmup_steps
    return lambda step: min(step, w) / w if w > 0 else 1.0


def make_stage1_optimizer(sc: Stage1Config, model: Showo2,
                          frozen_substrings: Sequence[str] = ()
                          ) -> Optimizer:
    """Clip + the optimizer ``sc.optimizer`` over every parameter not
    frozen, at ``learning_rate`` after the warmup (``adafactor`` on the
    JAX package's tensors, ``training/optim.py::jax_tensors``)."""
    freeze(model, frozen_substrings)
    return Optimizer([(model.parameters(), sc.learning_rate)], sc,
                     warmup(sc), tensors=jax_tensors(model))


@dataclasses.dataclass
class Stage1Batch:
    """One step's model inputs: the noised latents and their targets, and
    the attention inputs of the route."""

    text_tokens: torch.Tensor
    text_labels: torch.Tensor
    modality_positions: torch.Tensor
    image_masks: torch.Tensor
    t: torch.Tensor
    xt: torch.Tensor
    ut: torch.Tensor
    bias: Optional[torch.Tensor]
    attn_meta: Optional[tuple]


class Stage1Step:
    """The stage-1 step (JAX ``make_stage1_step``): :meth:`prepare` makes
    the inputs, :meth:`loss_and_grads` the forward and backward, a call
    both and the update, returning the metrics."""

    def __init__(self, model: Showo2, vae: WanVAE, sc: Stage1Config,
                 transport: Transport, optimizer: Optimizer,
                 autocast_dtype: Optional[torch.dtype] = None):
        if check_route(sc.attn_impl) not in TRAIN_ROUTES:
            raise ValueError(f"attention route {sc.attn_impl!r} has no "
                             f"backward; training takes {TRAIN_ROUTES}")
        self.model, self.vae, self.sc = model, vae, sc
        self.transport, self.optimizer = transport, optimizer
        self.autocast_dtype = autocast_dtype

    def encode(self, images: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixels [N, H, W, 3] or [N, T, H, W, 3] in [-1, 1] -> the frozen
        VAE's latents [N, C, h, w] or [N, C, T', h, w] (posterior noise
        ``eps`` shaped as the latents, else drawn from ``generator``)."""
        images = images.float()
        video = images.dim() == 5
        pixels = (images.permute(0, 4, 1, 2, 3) if video
                  else images.permute(0, 3, 1, 2)[:, :, None])
        latents = wan_encode(self.vae, pixels, generator, eps=eps)
        return latents if video else latents[:, :, 0]

    def noised(self, t: torch.Tensor, latents: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               x0: Optional[torch.Tensor] = None):
        """(t, xt, ut) of the linear plan from the noise ``x0`` (latents'
        shape, else drawn from ``generator``) to ``latents``."""
        t = torch.as_tensor(t, dtype=torch.float32, device=latents.device)
        if x0 is None:
            x0 = torch.randn(latents.shape, generator=generator,
                             dtype=latents.dtype, device=latents.device)
        x0 = torch.as_tensor(x0, dtype=latents.dtype, device=latents.device)
        _, xt, ut = self.transport.path_sampler.plan(t, x0, latents)
        return t, xt, ut

    def attention(self, modality_positions: torch.Tensor, L: int):
        """(bias, attn_meta) of the route: the dense omni bias, or the
        trainable kernels' metadata."""
        if self.sc.attn_impl == "trainable":
            return None, ("trainable", seg_from_modality_positions(
                modality_positions, L), None, None, None)
        return omni_attn_mask(modality_positions, L), None

    @torch.no_grad()
    def prepare(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None) -> Stage1Batch:
        """batch: ``text_tokens`` / ``text_labels`` / ``image_masks``
        [B, L], ``images`` [B, H, W, 3] or [B, T, H, W, 3] in [-1, 1],
        ``modality_positions`` [B, 1, 2], ``is_und`` [B], on the model's
        device.  noise: optional ``vae_eps`` (the posterior draw, shaped as
        the latents [B, C, (T',) h, w]), ``t`` [B] (the per-sample times,
        the und path already applied) and ``x0`` (latents' shape), used
        instead of draws from ``generator``."""
        sc, noise = self.sc, noise or {}
        latents = self.encode(batch["images"], generator,
                              noise.get("vae_eps"))
        B, L = batch["text_tokens"].shape
        is_und = batch["is_und"]
        image_masks = batch["image_masks"]
        t = noise.get("t")
        draw = None if t is not None else self.transport.base_draw(
            B, generator, latents.device)
        if t is None:
            t = self.transport.sample_t(B, draw=draw, device=latents.device)
        if sc.und_max_t0 is not None:
            if "t" not in noise:
                t_und = self.transport.sample_t(B, max_t0=sc.und_max_t0,
                                                draw=draw,
                                                device=latents.device)
                t = torch.where(is_und > 0, t_und, t)
            if sc.und_max_t0 == 1.0:
                # und samples are clean: their flow rows leave the loss
                image_masks = image_masks * (1 - is_und)[:, None]
        t, xt, ut = self.noised(t, latents, generator, noise.get("x0"))
        mp = batch["modality_positions"]
        bias, meta = self.attention(mp, L)
        return Stage1Batch(batch["text_tokens"], batch["text_labels"], mp,
                           image_masks, t, xt, ut, bias, meta)

    def loss_and_grads(self, b: Stage1Batch):
        """(total, (loss_ntp, loss_flow), gradients in the optimizer's
        parameter order)."""
        sc = self.sc
        dev = b.text_tokens.device
        with torch.autocast(dev.type, dtype=self.autocast_dtype,
                            enabled=self.autocast_dtype is not None):
            out = showo2_forward(
                self.model, b.text_tokens, b.xt, b.t, b.bias,
                b.modality_positions, b.attn_meta,
                text_labels=b.text_labels, image_labels=b.ut,
                image_masks=b.image_masks, remat=sc.remat)
            total = (sc.ntp_coeff * out["loss_ntp"]
                     + sc.flow_coeff * out["loss_flow"])
        grads = torch.autograd.grad(total, self.optimizer.params)
        return total.detach(), (out["loss_ntp"].detach(),
                                out["loss_flow"].detach()), list(grads)

    def __call__(self, batch, generator=None, noise=None) -> Dict:
        b = self.prepare(batch, generator, noise)
        total, (l_ntp, l_flow), grads = self.loss_and_grads(b)
        grad_norm = global_norm(grads)
        self.optimizer.update(grads)
        return {"loss": total, "loss_ntp": l_ntp, "loss_flow": l_flow,
                "grad_norm": grad_norm}


BATCH_KEYS = ("text_tokens", "text_labels", "images", "modality_positions",
              "image_masks", "is_und")


@dataclasses.dataclass
class Stage1Trainer:
    """Host batches -> the stage-1 step -> metrics, with the reference's
    periodic hooks (checkpoints, validation images, reconstructions).
    The model holds fp32 master weights; ``vae`` is frozen."""

    model: Showo2
    vae: WanVAE
    sc: Stage1Config
    transport: Transport
    frozen_substrings: Sequence[str] = ()

    step_class = Stage1Step
    batch_keys = BATCH_KEYS

    def __post_init__(self):
        self.vae.eval().requires_grad_(False)
        self.model.train()
        self.optimizer = self.make_optimizer()
        self.step_fn = self.step_class(
            self.model, self.vae, self.sc, self.transport, self.optimizer,
            torch.bfloat16 if self.device.type == "cuda" else None)
        self.global_step = 0

    def make_optimizer(self) -> Optimizer:
        return make_stage1_optimizer(self.sc, self.model,
                                     self.frozen_substrings)

    @property
    def device(self) -> torch.device:
        return self.model.showo.model.embed_tokens.weight.device

    def device_batch(self, batch: dict) -> Dict[str, torch.Tensor]:
        """A collated host batch -> the step's tensors on the model's
        device; ``is_und`` from ``data_type`` ('mmu' is understanding)
        when the batch has no such column."""
        if "is_und" in self.batch_keys and "is_und" not in batch:
            types = batch.get("data_type",
                              ["t2i"] * len(batch["text_tokens"]))
            batch = dict(batch, is_und=np.asarray(
                [1 if d == "mmu" else 0 for d in types], np.int32))
        return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                for k in self.batch_keys}

    def train_step(self, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[dict] = None) -> Dict:
        metrics = self.step_fn(self.device_batch(batch), generator, noise)
        self.global_step += 1
        return metrics

    def _pipeline(self, tokenizer, token_ids, num_steps, guidance_scale):
        """A T2IV2Pipeline on a copy of the model (the pipeline fuses its
        weights in place), bf16 on CUDA."""
        from showo_tpu_torch.pipelines.t2i_v2 import T2IV2Pipeline

        dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        copy = Showo2(self.model.cfg, device=self.device, dtype=dtype)
        copy.load_state_dict(self.model.state_dict())
        return T2IV2Pipeline(model=copy.eval().requires_grad_(False),
                             vae=self.vae, tokenizer=tokenizer,
                             token_ids=token_ids,
                             guidance_scale=guidance_scale,
                             num_steps=num_steps)

    @torch.no_grad()
    def generate_validation_images(self, prompts, tokenizer, token_ids,
                                   generator, output_dir: str,
                                   num_steps: int = 20,
                                   guidance_scale: float = 5.0):
        """ODE samples of ``prompts`` (train_stage_one.py:602-698
        ``generate_images``), saved as ``samples/step<N>_<i>.png``."""
        from showo_tpu_torch.utils.image import to_pil_images

        pipe = self._pipeline(tokenizer, token_ids, num_steps,
                              guidance_scale)
        images = pipe.generate(list(prompts), generator)
        self._save(to_pil_images(images), output_dir, "samples")
        return images

    def _save(self, images, output_dir, sub, suffix=""):
        out = os.path.join(output_dir, sub)
        os.makedirs(out, exist_ok=True)
        for i, im in enumerate(images):
            im.save(os.path.join(
                out, f"step{self.global_step:07d}_{i:02d}{suffix}.png"))

    @torch.no_grad()
    def visualize_reconstruction(self, pixels, output_dir: str,
                                 generator=None) -> np.ndarray:
        """[input | VAE reconstruction] panels: images [B, H, W, 3] as
        ``recon/step<N>_<i>.png``, videos [B, T, H, W, 3] frame by frame
        as ``recon_video/step<N>_<i>_f<t>.png`` (train_stage_one.py
        :702-720, :817-832)."""
        from showo_tpu_torch.utils.image import to_pil_images

        x = torch.as_tensor(np.asarray(pixels, np.float32),
                            device=self.device)
        video = x.dim() == 5
        cf = x.permute(0, 4, 1, 2, 3) if video \
            else x.permute(0, 3, 1, 2)[:, :, None]
        recon = wan_decode(self.vae, wan_encode(self.vae, cf, generator))
        recon = recon.permute(0, 2, 3, 4, 1)            # [B, T, H, W, 3]
        if not video:
            recon = recon[:, 0]
        panel = np.concatenate([np.asarray(pixels, np.float32),
                                recon.float().cpu().numpy()], axis=-2)
        if not video:
            self._save(to_pil_images(panel), output_dir, "recon")
            return panel
        out = os.path.join(output_dir, "recon_video")
        os.makedirs(out, exist_ok=True)
        for i in range(panel.shape[0]):
            for f, im in enumerate(to_pil_images(panel[i])):
                im.save(os.path.join(
                    out, f"step{self.global_step:07d}_{i:02d}_f{f:03d}.png"))
        return panel

    def fit(self, loader, max_steps: int, log_every: int = 50,
            save_every: Optional[int] = None, output_dir: str = "output",
            seed: int = 0, tracker=None, generate_every: Optional[int] = None,
            validation_prompts: Sequence[str] = (), tokenizer=None,
            token_ids=None, checkpoints_total_limit: Optional[int] = None):
        """Steps over ``loader``'s host batches until ``max_steps``
        (train_stage_one.py:528-576): metrics every ``log_every`` steps,
        a checkpoint and the loader's state every ``save_every``, and
        every ``generate_every`` validation images of
        ``validation_prompts`` and a reconstruction panel of the batch.
        Each step's draws depend on (seed, step) alone, so a resumed run
        draws what an unbroken one would."""
        from showo_tpu_torch.data.loader import save_loader_state
        from showo_tpu_torch.utils.checkpoint import save_checkpoint

        t0 = time.perf_counter()
        for batch in loader:
            if self.global_step >= max_steps:
                break
            gen = step_generator(self.device, seed, self.global_step)
            metrics = self.train_step(batch, gen)
            if self.global_step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["batch_time"] = (time.perf_counter() - t0) / log_every
                logger.info("step %d: %s", self.global_step, m)
                if tracker is not None:
                    tracker.log(m, step=self.global_step)
                t0 = time.perf_counter()
            if save_every and self.global_step % save_every == 0:
                save_checkpoint(output_dir, self.global_step, self.model,
                                self.optimizer, checkpoints_total_limit)
                if hasattr(loader, "state_dict"):
                    save_loader_state(loader, output_dir, self.global_step)
            if generate_every and self.global_step % generate_every == 0:
                g = step_generator(self.device, seed + 1, self.global_step)
                if validation_prompts and tokenizer is not None:
                    self.generate_validation_images(
                        validation_prompts, tokenizer, token_ids, g,
                        output_dir)
                self.visualize_reconstruction(batch["images"], output_dir, g)
        return self.model


# ---------------------------------------------------------------------------
# the CLI and build_trainer
# ---------------------------------------------------------------------------

def stage1_config(config, attn_impl: Optional[str] = None) -> Stage1Config:
    """The config's ``training`` keys as a :class:`Stage1Config`
    (``attn_impl`` overrides ``training.attn_impl``)."""
    tr = config.training
    und = tr.get("und_max_t0", 1.0)
    return Stage1Config(
        learning_rate=float(tr.get("learning_rate", 1e-4)),
        max_grad_norm=float(tr.get("max_grad_norm", 1.0)),
        ntp_coeff=float(tr.get("ntp_coeff", 0.2)),
        flow_coeff=float(tr.get("flow_coeff", 1.0)),
        und_max_t0=None if und is None else float(und),
        warmup_steps=int(tr.get("warmup_steps", 0)),
        grad_accum_steps=int(tr.get("gradient_accumulation_steps", 1)),
        attn_impl=str(attn_impl
                      or config_route(tr.get("attn_impl", "dense"))),
        optimizer=str(tr.get("optimizer", "adamw")),
        remat=str(tr.get("remat", "full")))


def config_route(name: str) -> str:
    """A config's ``training.attn_impl`` as the port's route: the configs
    are the JAX package's too, and may name a route by its JAX string
    (``pallas_trainable`` -> ``trainable``); any other name is kept, for
    :class:`Stage1Step` to check."""
    from showo_tpu_torch.show_o2.qwen2 import ATTN_ROUTES

    name = str(name)
    return {j: p for p, j in ATTN_ROUTES.items() if j}.get(name, name)


def build_models(config, device: torch.device):
    """(Show-o2 with fp32 master weights, trainable; the frozen fp32
    Wan2.1 VAE): checkpoints when the config's paths exist, else random
    init from fixed seeds (the inference CLIs' loaders)."""
    from showo_tpu_torch.inference_t2i_v2 import (build_showo2_config,
                                                  load_model, load_vae)

    # the training configs may leave the checkpoint out (random init)
    showo = config.model.showo
    showo.setdefault("pretrained_model_path", "random")
    model = load_model(config, build_showo2_config(config), device,
                       torch.float32)
    return model.train().requires_grad_(True), load_vae(config, device)


def build_transport(config, model: Showo2) -> Transport:
    n_img = num_image_tokens(config, model)
    tr = config.transport
    return Transport(path_type=tr.get("path_type", "Linear"),
                     snr_type=tr.get("snr_type", "lognorm"),
                     do_shift=tr.get("do_shift", True), seq_len=n_img)


def build_trainer(config, device=None,
                  attn_impl: Optional[str] = None) -> Stage1Trainer:
    """Config -> Stage1Trainer (the CLI builds it so).  device defaults to
    CUDA and raises without a card; the CPU runs only when asked for
    (``device="cpu"``).  attn_impl overrides ``training.attn_impl``
    ("dense" or "trainable")."""
    device = entry_device(device)
    model, vae = build_models(config, device)
    return Stage1Trainer(
        model=model, vae=vae, sc=stage1_config(config, attn_impl),
        transport=build_transport(config, model),
        frozen_substrings=tuple(config.model.get("frozen_params", []) or []))


def num_image_tokens(config, model: Showo2) -> int:
    """The image span's length: the config's t2i image tokens, and the
    time token when the model adds one."""
    return (config.dataset.preprocessing.num_t2i_image_tokens
            + (1 if model.cfg.add_time_embeds else 0))


def jsonl_loaders(config, tokenizer, token_ids, model: Showo2,
                  sources: Sequence[Tuple[str, str, str]]) -> list:
    """A checkpointable loader of each jsonl of ``sources`` ((config key,
    batch size key, default data type)) that the config names."""
    from showo_tpu_torch.data.image_text import create_imagetext_dataloader

    pre, dp, tr = (config.dataset.preprocessing, config.dataset.params,
                   config.training)
    return [create_imagetext_dataloader(
        dp.get(key), tokenizer, token_ids, batch_size=int(tr.get(bs_key, 1)),
        resolution=pre.resolution,
        num_image_tokens=num_image_tokens(config, model),
        max_seq_len=pre.max_seq_length,
        max_text_len=int(pre.get("max_text_len", 256)),
        default_data_type=dtype)
        for key, bs_key, dtype in sources if dp.get(key)]


def build_loader(config, tokenizer, token_ids, model: Showo2,
                 sources: Sequence[Tuple[str, str, str]]):
    """The jsonl loaders of ``sources`` (:func:`jsonl_loaders`), mixed by
    ``concat_max_size_cycle``."""
    from showo_tpu_torch.data.mixed import MixedDataLoader

    loaders = jsonl_loaders(config, tokenizer, token_ids, model, sources)
    if not loaders:
        raise ValueError("no training data: set dataset.params."
                         + " or ".join(k for k, _, _ in sources))
    return MixedDataLoader(loaders, mode="concat_max_size_cycle")


def validation_prompts(config) -> List[str]:
    """``dataset.params.validation_prompts_file`` (the in-tree list when
    the file is absent), else the inline ``validation_prompts``, else
    none (JAX ``load_validation_prompts``)."""
    from showo_tpu_torch.utils.assets import validation_prompts_file

    vp = config.dataset.params.get("validation_prompts_file")
    if vp:
        vp = validation_prompts_file(str(vp))
        if vp:
            with open(vp) as f:
                return [ln.strip() for ln in f if ln.strip()]
    return list(config.get("validation_prompts") or [])


def run(config, trainer: Stage1Trainer,
        sources: Sequence[Tuple[str, str, str]] = (),
        make_loader=None) -> Stage1Trainer:
    """The CLIs' common part: data, config snapshot, resume from
    ``latest``, the tracker and the loop.  The data: the jsonl loaders of
    ``sources`` (:func:`build_loader`), or ``make_loader(config, tokenizer,
    token_ids, model)``."""
    from showo_tpu_torch.config import snapshot_config
    from showo_tpu_torch.data.loader import restore_loader_state
    from showo_tpu_torch.inference_t2i_v2 import load_tokenizer_and_ids
    from showo_tpu_torch.utils.checkpoint import resume_latest
    from showo_tpu_torch.utils.tracker import Tracker

    exp, tr = config.experiment, config.training
    tokenizer, token_ids = load_tokenizer_and_ids(config)
    loader = (make_loader or (lambda *a: build_loader(*a, sources)))(
        config, tokenizer, token_ids, trainer.model)
    snapshot_config(config, exp.output_dir)
    if exp.get("resume_from_checkpoint") == "latest":
        step = resume_latest(exp.output_dir, trainer.model,
                             trainer.optimizer, params_only_fallback=True)
        if step:
            trainer.global_step = step
            restore_loader_state(loader, exp.output_dir, step)
            logger.info("resumed from step %d", step)
    tracker = Tracker(project=exp.get("project"), name=exp.get("name"),
                      enabled=bool(config.get("wandb_enabled", False)))
    trainer.fit(loader, max_steps=int(tr.max_train_steps),
                log_every=int(exp.get("log_every", 50)),
                save_every=exp.get("save_every"),
                output_dir=exp.output_dir, seed=int(tr.get("seed", 0)),
                tracker=tracker, generate_every=exp.get("generate_every"),
                validation_prompts=validation_prompts(config),
                tokenizer=tokenizer, token_ids=token_ids,
                checkpoints_total_limit=exp.get("checkpoints_total_limit"))
    return trainer


STAGE1_SOURCES = (("t2i_jsonl", "batch_size_t2i", "t2i"),
                  ("mmu_jsonl", "batch_size_mmu", "mmu"))


def main(argv=None) -> Stage1Trainer:
    from showo_tpu_torch.config import get_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    trainer = build_trainer(config, device=config.get("device"))
    return run(config, trainer, STAGE1_SOURCES)


if __name__ == "__main__":
    main()
