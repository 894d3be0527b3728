"""Show-o v1 unified trainer (stage 1: t2i + lm + mmu in one fused step).

    python -m showo_tpu_torch.training.train_showo \
        config=configs/showo_pretraining_stage1.yaml [device=cpu]

Counterpart of ``showo_tpu/training/train_showo.py``.  One step does what
the reference does per step: the frozen MAGVIT-v2 encodes the t2i and mmu
pixels to codes, the t2i codes are masked or replaced
(``corruption.py``), the rows are assembled as ``[pad..text][soi] image
[eoi]`` (t2i), ``[bos] text [eos][pad..]`` (lm) and
``[mmu][soi] image [eoi] text`` (mmu), the attention mask is built for
the route (dense: three additive biases; ``trainable``: O(S) kernel
metadata: t2i rows prune pads, lm rows keep pads visible, mmu rows see
the batch-first-eoi prefix), then the fused three-task loss, its
backward, the gradient norm, clipping, the optimizer (``adamw``,
``adamw_bf16`` or ``adafactor``, ``training.optimizer``) and the LR
schedule, the layers under the remat policy ``training.remat``.

Precision: fp32 master weights; on CUDA the forward runs under
``torch.autocast(bfloat16)`` when ``training.mixed_precision`` is "bf16"
(the reference config's setting); the CPU runs all fp32.  MAGVIT encodes
in fp32.  The entry points run on CUDA unless the caller asks for the CPU.

The loop (:meth:`ShowoTrainer.fit`) zips the t2i, lm and mmu loaders of
:func:`_build_loaders` (an ImageNet class folder or tar shards, RefinedWeb
parquet, caption tar shards), and every ``save_every`` steps saves a
checkpoint ring (``utils/checkpoint.py``) with the EMA of the weights
(``training.ema``, ``training/ema.py``) and each loader's state; every
``generate_every`` steps it writes validation images of the config's
prompts (``samples/``) and [original | reconstruction | prediction]
panels of the step's t2i batch (``predictions/``).  The CLI resumes from
``latest``: the weights, the optimizer, the EMA and the loaders'
positions.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.inference_t2i import (build_showo_config, load_model,
                                           load_tokenizer, load_vq)
from showo_tpu_torch.models.magvit import MagvitV2
from showo_tpu_torch.models.phi import check_route
from showo_tpu_torch.models.showo import Showo, showo_forward, showo_losses
from showo_tpu_torch.ops.flash_attention import (metadata_mmu,
                                                 metadata_predict_next,
                                                 seg_from_soi_eoi)
from showo_tpu_torch.ops.masks import omni_mask_mmu, omni_mask_predict_next
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.schedules import get_mask_schedule
from showo_tpu_torch.training.corruption import mask_or_random_replace_tokens
from showo_tpu_torch.training.ema import EMA, EMAConfig
from showo_tpu_torch.training.lr_schedules import get_lr_schedule
from showo_tpu_torch.training.optim import jax_tensors
from showo_tpu_torch.training.train_step import (Optimizer, TrainConfig,
                                                 global_norm)
from showo_tpu_torch.utils.device import entry_device

logger = logging.getLogger(__name__)

TRAIN_ROUTES = ("dense", "trainable")
_PRECISION = {"bf16": torch.bfloat16, "no": None, None: None}


def max_size_cycle_zip(*loaders):
    """Zip loaders, restarting exhausted ones until every loader has
    completed at least one pass (the reference's 'max_size_cycle')."""
    its = [iter(ld) for ld in loaders]
    exhausted = [False] * len(its)
    while True:
        out = []
        for i in range(len(its)):
            try:
                b = next(its[i])
            except StopIteration:
                exhausted[i] = True
                if all(exhausted):
                    return
                its[i] = iter(loaders[i])
                try:
                    b = next(its[i])
                except StopIteration:
                    raise ValueError(
                        f"loader {i} yielded no batches after restart "
                        "(empty dataset or shard?)") from None
            out.append(b)
        if all(exhausted):
            return
        yield tuple(out)


def _col(B: int, value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((B, 1), value, dtype=like.dtype, device=like.device)


def assemble_t2i(text_block, img_ids, img_labels, soi, eoi, pad_id,
                 ignore_id=-100):
    """[pad..text][soi] image [eoi] ids and labels (pads -> ignore_id)."""
    B = text_block.shape[0]
    ends = (_col(B, soi, text_block), _col(B, eoi, text_block))
    ids = torch.cat([text_block, ends[0], img_ids, ends[1]], dim=1)
    labels = torch.cat([text_block, ends[0], img_labels, ends[1]], dim=1)
    return ids, torch.where(labels == pad_id, ignore_id, labels)


def assemble_mmu(text_block, text_labels, img_ids, mmu, soi, eoi,
                 ignore_id=-100):
    """[mmu][soi] image [eoi] text; labels ignore everything before the
    text."""
    B, n_img = img_ids.shape
    ids = torch.cat([_col(B, mmu, text_block), _col(B, soi, text_block),
                     img_ids, _col(B, eoi, text_block), text_block], dim=1)
    prefix = torch.full((B, n_img + 3), ignore_id, dtype=text_labels.dtype,
                        device=text_labels.device)
    return ids, torch.cat([prefix, text_labels], dim=1)


@dataclasses.dataclass
class FusedBatch:
    """One step's assembled [t2i | lm | mmu] rows and their attention
    inputs: ``bias`` [B, 1, L, L] on the dense route, ``attn_meta``
    ("trainable", seg, pad, last_pad, prefix) on the trainable route."""

    input_ids: torch.Tensor
    labels: torch.Tensor
    bias: Optional[torch.Tensor]
    attn_meta: Optional[tuple]
    mask_prob: torch.Tensor


class FusedTrainStep:
    """The fused training step (counterpart of the step the JAX
    ``make_fused_train_step`` builds): :meth:`prepare` builds a batch,
    :meth:`loss_and_grads` runs the forward and backward, a call does both
    and the optimizer update and returns the metrics."""

    def __init__(self, model: Showo, vq: MagvitV2, tc: TrainConfig,
                 optimizer: Optimizer, sp: Dict[str, int],
                 batch_size_t2i: int, batch_size_lm: int,
                 batch_size_mmu: int, mask_schedule,
                 min_masking_rate: float = 0.0, noise_type: str = "mask",
                 predict_all_tokens: bool = False,
                 autocast_dtype: Optional[torch.dtype] = None):
        if check_route(tc.attn_impl) not in TRAIN_ROUTES:
            raise ValueError(f"attention route {tc.attn_impl!r} has no "
                             f"backward; training takes {TRAIN_ROUTES}")
        self.model, self.vq = model, vq
        self.tc, self.optimizer = tc, optimizer
        self.cfg = model.cfg
        self.sp = sp
        self.sizes = (batch_size_t2i, batch_size_lm, batch_size_mmu)
        self.mask_schedule = mask_schedule
        self.corruption = dict(min_masking_rate=min_masking_rate,
                               noise_type=noise_type,
                               predict_all_tokens=predict_all_tokens,
                               codebook_size=self.cfg.codebook_size)
        self.autocast_dtype = autocast_dtype

    @torch.no_grad()
    def prepare(self, t2i_pixels, t2i_text_block, lm_ids, lm_labels,
                mmu_pixels, mmu_text_block, mmu_text_labels,
                generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None) -> FusedBatch:
        """Codes, corruption, assembly and masks.  Pixels NHWC in [-1, 1];
        the rest int tensors on the model's device.  ``noise``: optional
        corruption draws (``timesteps``, ``uniforms``, ``replace_tokens``)
        instead of ``generator`` draws."""
        cfg, sp = self.cfg, self.sp
        mask_id, offset = cfg.mask_token_id, cfg.codebook_offset
        pad, soi, eoi = sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"]
        img_tokens = self.vq.get_code(t2i_pixels)
        noised, img_labels, _, mask_prob = mask_or_random_replace_tokens(
            img_tokens, mask_id, self.mask_schedule, generator=generator,
            **self.corruption, **(noise or {}))
        img_unified = torch.where(noised == mask_id, mask_id, noised + offset)
        img_label_unified = torch.where(img_labels == -100, -100,
                                        img_labels + offset)
        t2i_ids, t2i_labels = assemble_t2i(t2i_text_block, img_unified,
                                           img_label_unified, soi, eoi, pad)
        mmu_img = self.vq.get_code(mmu_pixels) + offset
        mmu_ids, mmu_labels = assemble_mmu(mmu_text_block, mmu_text_labels,
                                           mmu_img, sp["<|mmu|>"], soi, eoi)
        input_ids = torch.cat([t2i_ids, lm_ids, mmu_ids])
        labels = torch.cat([t2i_labels, lm_labels, mmu_labels])

        if self.tc.attn_impl == "trainable":
            # t2i rows prune pads, lm rows keep pads visible (pad map
            # zeroed), mmu rows see the batch-first-eoi prefix
            seg_l = seg_from_soi_eoi(lm_ids, soi, eoi)
            lm = (seg_l, torch.zeros_like(seg_l),
                  torch.full((lm_ids.shape[0],), -1, dtype=torch.int32,
                             device=lm_ids.device),
                  torch.zeros((lm_ids.shape[0],), dtype=torch.int32,
                              device=lm_ids.device))
            parts = zip(metadata_predict_next(t2i_ids, pad, soi, eoi), lm,
                        metadata_mmu(mmu_ids, eoi))
            meta = ("trainable",) + tuple(torch.cat(p) for p in parts)
            return FusedBatch(input_ids, labels, None, meta, mask_prob)
        bias = torch.cat([
            omni_mask_predict_next(t2i_ids, pad, soi, eoi,
                                   rm_pad_in_image=True),
            omni_mask_predict_next(lm_ids, pad, soi, eoi,
                                   rm_pad_in_image=False),
            omni_mask_mmu(mmu_ids, eoi)])
        return FusedBatch(input_ids, labels, bias, None, mask_prob)

    def loss_and_grads(self, batch: FusedBatch):
        """(total loss, (loss_t2i, loss_lm, loss_mmu), gradients in the
        optimizer's parameter order)."""
        tc = self.tc
        dev = batch.input_ids.device
        with torch.autocast(dev.type, dtype=self.autocast_dtype,
                            enabled=self.autocast_dtype is not None):
            _, l_t2i, l_lm, l_mmu = showo_losses(
                self.model, batch.input_ids, batch.labels, batch.bias,
                *self.sizes, max_seq_length=tc.max_seq_length,
                remat=tc.remat, attn_meta=batch.attn_meta)
            total = (tc.t2i_coeff * l_t2i + tc.lm_coeff * l_lm
                     + tc.mmu_coeff * l_mmu)
        grads = torch.autograd.grad(total, self.optimizer.params)
        return total.detach(), (l_t2i.detach(), l_lm.detach(),
                                l_mmu.detach()), list(grads)

    def __call__(self, *inputs, generator=None, noise=None) -> Dict:
        batch = self.prepare(*inputs, generator=generator, noise=noise)
        total, (l_t2i, l_lm, l_mmu), grads = self.loss_and_grads(batch)
        grad_norm = global_norm(grads)
        self.optimizer.update(grads)
        return {"loss": total, "loss_t2i": l_t2i, "loss_lm": l_lm,
                "loss_mmu": l_mmu, "grad_norm": grad_norm,
                "masking_rate": batch.mask_prob.mean()}


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The corruption generator of one step: a function of (seed, step)
    alone, so a resumed run draws what an unbroken one would."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))


@dataclasses.dataclass
class ShowoTrainer:
    """Host batches -> fused step -> metrics.  ``attn_impl``, when given,
    overrides ``training.attn_impl`` of the config."""

    config: Any
    model: Showo
    vq: MagvitV2
    uni_prompting: UniversalPrompting
    attn_impl: Optional[str] = None

    def __post_init__(self):
        c = self.config
        tr = c.training
        self.cfg = self.model.cfg
        self.tc = self.train_config()
        lr_cfg = c.get("lr_scheduler", {}) or {}
        lr = get_lr_schedule(
            lr_cfg.get("scheduler", "constant"), self.tc.learning_rate,
            num_warmup_steps=(lr_cfg.get("params", {}) or {}).get(
                "warmup_steps", 0),
            num_training_steps=tr.get("max_train_steps", 1))
        self.optimizer = Optimizer(self.model.parameters(), self.tc, lr,
                                   tensors=jax_tensors(self.model))
        self.step_fn = FusedTrainStep(
            self.model, self.vq, self.tc, self.optimizer,
            self.uni_prompting.sptids, tr.batch_size_t2i, tr.batch_size_lm,
            tr.batch_size_mmu,
            get_mask_schedule(tr.get("mask_schedule", "cosine")),
            min_masking_rate=tr.get("min_masking_rate", 0.0),
            noise_type=tr.get("noise_type", "mask"),
            predict_all_tokens=tr.get("predict_all_tokens", False),
            autocast_dtype=self.autocast_dtype())
        self.global_step = 0
        self.ema = self._init_ema(tr.get("ema") or {})

    def train_config(self) -> TrainConfig:
        """The config's ``training`` keys as a TrainConfig (``attn_impl``
        overrides ``training.attn_impl``)."""
        c = self.config
        tr = c.training
        opt_params = c.get_path("optimizer.params", {}) or {}
        # float(): YAML reads "1e-4" (no dot) as a string
        max_norm = tr.get("max_grad_norm", 1.0)
        return TrainConfig(
            learning_rate=float(tr.get(
                "learning_rate", opt_params.get("learning_rate", 1e-4))),
            max_grad_norm=None if max_norm is None else float(max_norm),
            t2i_coeff=tr.get("t2i_coeff", 1.0),
            lm_coeff=tr.get("lm_coeff", 0.1),
            mmu_coeff=tr.get("mmu_coeff", 1.0),
            max_seq_length=c.dataset.preprocessing.max_seq_length,
            grad_accum_steps=int(tr.get("gradient_accumulation_steps", 1)),
            attn_impl=str(self.attn_impl or tr.get("attn_impl", "dense")),
            remat=str(tr.get("remat", "full")),
            optimizer=str(tr.get("optimizer", "adamw")))

    def autocast_dtype(self) -> Optional[torch.dtype]:
        """The forward's autocast type on CUDA (``training.mixed_precision``
        "bf16"), None on the CPU or with "no"; another setting raises."""
        precision = self.config.training.get("mixed_precision", "no")
        if precision not in _PRECISION:
            raise NotImplementedError(
                f"mixed_precision={precision!r} is not ported; the port "
                f"has 'bf16' and 'no'")
        return _PRECISION[precision] if self.device.type == "cuda" else None

    def _init_ema(self, ema_cfg) -> Optional[EMA]:
        """The EMA of every weight when ``training.ema.enabled`` (the
        reference ships ``EMAModel`` unwired, training_utils.py:61; JAX
        makes it a config block)."""
        if not ema_cfg.get("enabled", False):
            return None
        ec = EMAConfig(
            decay=float(ema_cfg.get("decay", 0.9999)),
            min_decay=float(ema_cfg.get("min_decay", 0.0)),
            update_after_step=int(ema_cfg.get("update_after_step", 0)),
            use_ema_warmup=bool(ema_cfg.get("use_ema_warmup", False)))
        return EMA(ec, self.model.named_parameters())

    @property
    def device(self) -> torch.device:
        return self.model.showo.lm_head.weight.device

    def host_batch(self, t2i_batch, lm_texts, mmu_batch):
        """Host batches -> the step's tensors: the prompting's text blocks
        (lm rows as long as the t2i rows) and the NHWC pixels, on the
        model's device."""
        uni, dev = self.uni_prompting, self.device
        t2i_text = uni.t2i_text_block(t2i_batch["text"])
        L = t2i_text.shape[1] + self.cfg.num_vq_tokens + 2
        lm_ids, _, lm_labels = uni.lm_prompt(
            uni.text_tokenizer(list(lm_texts))["input_ids"], L)
        mmu_text, mmu_labels = uni.mmu_text_block(mmu_batch["text"])

        def put(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return (put(t2i_batch["image"], torch.float32), put(t2i_text),
                put(lm_ids), put(lm_labels),
                put(mmu_batch["image"], torch.float32), put(mmu_text),
                put(mmu_labels))

    def train_step(self, t2i_batch, lm_texts, mmu_batch,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[dict] = None) -> Dict:
        """One call of the fused step from raw host batches (with gradient
        accumulation, one micro-step); the EMA follows every optimizer
        step, not every call."""
        metrics = self.step_fn(*self.host_batch(t2i_batch, lm_texts,
                                                mmu_batch),
                               generator=generator, noise=noise)
        k = max(1, self.tc.grad_accum_steps)
        if self.ema is not None and (self.global_step + 1) % k == 0:
            self.ema.update(self.model.parameters())
        self.global_step += 1
        return metrics

    def _model_copy(self) -> Showo:
        """The weights on a new Show-o (the pipeline fuses its model in
        place), bf16 on CUDA."""
        dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        copy = Showo(self.cfg, device=self.device, dtype=dtype)
        copy.load_state_dict(self.model.state_dict())
        return copy.eval().requires_grad_(False)

    @torch.no_grad()
    def generate_validation_images(self, prompts: Sequence[str], generator,
                                   output_dir: str) -> np.ndarray:
        """MaskGIT samples of ``prompts`` at the config's guidance and steps
        (train.py:671-693, 766-848 ``generate_images``) through
        ``T2IPipeline`` on its ``auto`` route, saved as
        ``samples/step<N>_<i>.png``."""
        from showo_tpu_torch.utils.image import to_pil_images
        from showo_tpu_torch.pipelines.t2i import T2IPipeline

        tr = self.config.training
        pipe = T2IPipeline(
            model=self._model_copy(), vq=self.vq,
            uni_prompting=self.uni_prompting,
            guidance_scale=tr.get("guidance_scale", 1.5),
            timesteps=tr.get("generation_timesteps", 12),
            max_seq_length=self.tc.max_seq_length,
            resolution=self.config.dataset.params.get("resolution", 256))
        images = pipe.generate(list(prompts), generator)
        out = os.path.join(output_dir, "samples")
        os.makedirs(out, exist_ok=True)
        for i, im in enumerate(to_pil_images(images)):
            im.save(os.path.join(out,
                                 f"step{self.global_step:07d}_{i:02d}.png"))
        return images

    @torch.no_grad()
    def predict_tokens(self, t2i_batch, generator=None,
                       noise: Optional[dict] = None):
        """The step's corruption of the t2i batch's codes again (the same
        generator, or the same ``noise`` draws), the model's argmax over
        the codebook at each masked position: (codes, predicted codes,
        each row's masked share)."""
        cfg, sp = self.cfg, self.uni_prompting.sptids
        pad, soi, eoi = sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"]
        tr = self.config.training
        pixels = torch.as_tensor(np.asarray(t2i_batch["image"]),
                                 dtype=torch.float32, device=self.device)
        text = torch.as_tensor(self.uni_prompting.t2i_text_block(
            t2i_batch["text"]), device=self.device)
        tokens = self.vq.get_code(pixels)
        noised = mask_or_random_replace_tokens(
            tokens, cfg.mask_token_id,
            get_mask_schedule(tr.get("mask_schedule", "cosine")),
            generator=generator,
            min_masking_rate=tr.get("min_masking_rate", 0.0),
            codebook_size=cfg.codebook_size, **(noise or {}))[0]
        unified = torch.where(noised == cfg.mask_token_id, cfg.mask_token_id,
                              noised + cfg.codebook_offset)
        ids, _ = assemble_t2i(text, unified, unified, soi, eoi, pad)
        bias = omni_mask_predict_next(ids, pad, soi, eoi,
                                      rm_pad_in_image=True)
        dtype = self.step_fn.autocast_dtype
        with torch.autocast(self.device.type, dtype=dtype,
                            enabled=dtype is not None):
            logits = showo_forward(self.model, input_ids=ids,
                                   attention_bias=bias)
        logits = logits[0] if isinstance(logits, tuple) else logits
        n, off = cfg.num_vq_tokens, cfg.codebook_offset
        pred = torch.argmax(logits[:, -(n + 1):-1,
                                   off:off + cfg.codebook_size].float(), -1)
        masked = noised == cfg.mask_token_id
        return (tokens, torch.where(masked, pred, tokens),
                masked.float().mean(-1))

    @torch.no_grad()
    def visualize_predictions(self, t2i_batch, generator, output_dir: str,
                              noise: Optional[dict] = None) -> np.ndarray:
        """[original | VQ reconstruction | prediction] panels of the t2i
        batch (train.py:715-763): :meth:`predict_tokens`, both code sets
        decoded, saved as ``predictions/step<N>_<i>_mask<r>.png``."""
        tokens, predicted, mask_ratio = self.predict_tokens(
            t2i_batch, generator, noise)
        recon = self.vq.decode_code(tokens).float().cpu().numpy()
        pred = self.vq.decode_code(predicted).float().cpu().numpy()
        return self._save_viz(np.asarray(t2i_batch["image"], np.float32),
                              recon, pred, mask_ratio.cpu().numpy(),
                              output_dir)

    def _save_viz(self, pixels, recon, predicted, mask_ratio,
                  output_dir: str) -> np.ndarray:
        from showo_tpu_torch.utils.image import to_pil_images

        panel = np.concatenate([pixels, recon, predicted], axis=2)
        out = os.path.join(output_dir, "predictions")
        os.makedirs(out, exist_ok=True)
        for i, im in enumerate(to_pil_images(panel)):
            im.save(os.path.join(
                out, f"step{self.global_step:07d}_{i:02d}"
                f"_mask{float(mask_ratio[i]):.2f}.png"))
        return panel

    def save(self, output_dir: str, loaders: Dict[str, Any],
             checkpoints_total_limit: Optional[int] = None) -> str:
        """``checkpoint-<step>/``: the weights and the optimizer, the EMA
        (``ema_state.pt``) and each loader's state
        (``<name>_state.json``)."""
        from showo_tpu_torch.data.loader import save_loader_state
        from showo_tpu_torch.utils.checkpoint import save_checkpoint

        path = save_checkpoint(output_dir, self.global_step, self.model,
                               self.optimizer, checkpoints_total_limit)
        if self.ema is not None:
            torch.save(self.ema.state_dict(),
                       os.path.join(path, "ema_state.pt"))
        for name, ld in loaders.items():
            if hasattr(ld, "state_dict"):
                save_loader_state(ld, output_dir, self.global_step,
                                  name=name)
        return path

    def resume(self, output_dir: str, loaders: Dict[str, Any]) -> int:
        """``resume_from_checkpoint: 'latest'``: the newest checkpoint's
        weights and optimizer, its EMA (or a warning that the EMA restarts
        from the weights) and each loader's position; returns the step (0
        when there is none)."""
        from showo_tpu_torch.data.loader import restore_loader_state
        from showo_tpu_torch.utils.checkpoint import resume_latest

        step = resume_latest(output_dir, self.model, self.optimizer)
        if not step:
            return 0
        self.global_step = step
        logger.info("resumed from step %d", step)
        if self.ema is not None:
            path = os.path.join(output_dir, f"checkpoint-{step}",
                                "ema_state.pt")
            if os.path.exists(path):
                self.ema.load_state_dict(torch.load(
                    path, map_location=self.device, weights_only=False))
                logger.info("restored EMA state at step %d", step)
            else:
                self.ema = self._init_ema(self.config.training.get("ema"))
                logger.warning("no ema_state in checkpoint-%d; EMA restarts "
                               "from the resumed raw params", step)
        for name, ld in loaders.items():
            if hasattr(ld, "load_state_dict"):
                restore_loader_state(ld, output_dir, step, name=name)
        return step

    def fit(self, t2i_loader, lm_loader, mmu_loader, max_steps: int,
            log_every: int = 50, save_every: Optional[int] = None,
            output_dir: str = "output",
            checkpoints_total_limit: Optional[int] = None, seed: int = 0,
            generate_every: Optional[int] = None,
            validation_prompts: Optional[Sequence[str]] = None):
        """Steps over the zipped loaders until ``max_steps`` (train.py
        :467-693): metrics every ``log_every`` steps; every ``save_every``
        :meth:`save`; every ``generate_every`` validation images of
        ``validation_prompts`` and the prediction panels of the step's t2i
        batch.  Each step's corruption generator depends on (seed, step)
        only, so a resumed run draws what an unbroken one would; the
        panels re-run the step's corruption from a generator of the same
        (seed, step)."""
        sizes = sum(self.step_fn.sizes)
        loaders = {"t2i": t2i_loader, "lm": lm_loader, "mmu": mmu_loader}
        t0 = time.perf_counter()
        for t2i_b, lm_b, mmu_b in max_size_cycle_zip(t2i_loader, lm_loader,
                                                     mmu_loader):
            step = self.global_step
            metrics = self.train_step(t2i_b, lm_b["input_ids"], mmu_b,
                                      step_generator(self.device, seed, step))
            if self.global_step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                lap = (time.perf_counter() - t0) / log_every
                m.update(batch_time=lap, samples_per_sec=sizes / lap)
                logger.info("step %d: %s", self.global_step, m)
                t0 = time.perf_counter()
            if save_every and self.global_step % save_every == 0:
                self.save(output_dir, loaders, checkpoints_total_limit)
            if generate_every and self.global_step % generate_every == 0:
                if validation_prompts:
                    self.generate_validation_images(
                        validation_prompts,
                        step_generator(self.device, seed + 1, step),
                        output_dir)
                self.visualize_predictions(
                    t2i_b, step_generator(self.device, seed, step),
                    output_dir)
            if self.global_step >= max_steps:
                break
        return self.model


def build_trainer(config, device=None,
                  attn_impl: Optional[str] = None) -> ShowoTrainer:
    """Config -> ShowoTrainer: Show-o (checkpoint or random init, fp32
    master weights, trainable), the frozen MAGVIT-v2, the prompting with
    the config's conditioning dropout.  device defaults to CUDA and raises
    without a card; the CPU runs only when asked for (``device="cpu"``).
    attn_impl overrides ``training.attn_impl`` ("dense" or "trainable")."""
    device = entry_device(device)
    cfg = build_showo_config(config)
    model = load_model(config, cfg, device, torch.float32)
    uni = UniversalPrompting(
        load_tokenizer(config),
        max_text_len=config.dataset.preprocessing.max_seq_length,
        cond_dropout_prob=config.training.get("cond_dropout_prob", 0.1))
    return ShowoTrainer(config=config,
                        model=model.train().requires_grad_(True),
                        vq=load_vq(config, device), uni_prompting=uni,
                        attn_impl=attn_impl)


def t2i_lm_loaders(config):
    """The t2i (an ImageNet class folder, ``dataset.gen_type:
    imagenet1k``, or tar shards) and lm (RefinedWeb parquet, this
    process's rows) loaders of the config (train.py:271-412), each
    checkpointable."""
    from showo_tpu_torch.data.loader import (CheckpointableDataLoader,
                                             process_rank)
    from showo_tpu_torch.data.refinedweb import RefinedWebDataset
    from showo_tpu_torch.data.tar_shards import Text2ImageTarDataset

    p, tr = config.dataset.params, config.training
    if config.dataset.gen_type == "imagenet1k":
        from showo_tpu_torch.data.imagenet import ImageNetDataset

        t2i_ds = ImageNetDataset(p.train_t2i_shards_path_or_url, p.resolution)
    else:
        t2i_ds = Text2ImageTarDataset(p.train_t2i_shards_path_or_url,
                                      p.resolution,
                                      p.get("shuffle_buffer_size", 1000))
    rank, world = process_rank()
    lm_ds = RefinedWebDataset(p.train_lm_shards_path_or_url, rank=rank,
                              world_size=world)
    return tuple(CheckpointableDataLoader(lambda ds=ds: iter(ds), bs)
                 for ds, bs in ((t2i_ds, tr.batch_size_t2i),
                                (lm_ds, tr.batch_size_lm)))


def _build_loaders(config, tokenizer=None):
    """:func:`t2i_lm_loaders` and the mmu loader (caption tar shards),
    each checkpointable."""
    from showo_tpu_torch.data.loader import CheckpointableDataLoader
    from showo_tpu_torch.data.tar_shards import Text2ImageTarDataset

    p = config.dataset.params
    t2i, lm = t2i_lm_loaders(config)
    mmu_ds = Text2ImageTarDataset(p.train_mmu_shards_path_or_url,
                                  p.resolution,
                                  p.get("shuffle_buffer_size", 1000))
    return t2i, lm, CheckpointableDataLoader(lambda: iter(mmu_ds),
                                             config.training.batch_size_mmu)


def load_validation_prompts(config) -> Optional[List[str]]:
    """The config's validation prompts: the lines of
    ``dataset.params.validation_prompts_file`` (the in-tree list of that
    name when the path is absent), else the inline
    ``validation_prompts``, else None (train.py:672-683)."""
    from showo_tpu_torch.utils.assets import validation_prompts_file

    vp = config.dataset.params.get("validation_prompts_file")
    if vp:
        if not os.path.exists(str(vp)):
            vp = validation_prompts_file(str(vp))
        if vp:
            with open(str(vp)) as f:
                return [ln.strip() for ln in f if ln.strip()]
    inline = config.get("validation_prompts")
    return list(inline) if inline else None


def main(argv=None) -> ShowoTrainer:
    from showo_tpu_torch.config import snapshot_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    exp = config.experiment
    trainer = build_trainer(config, device=config.get("device"))
    loaders = _build_loaders(config, trainer.uni_prompting.text_tokenizer)
    snapshot_config(config, exp.output_dir)
    if exp.get("resume_from_checkpoint") == "latest":
        trainer.resume(exp.output_dir, dict(zip(("t2i", "lm", "mmu"),
                                                loaders)))
    trainer.fit(*loaders, max_steps=config.training.max_train_steps,
                log_every=exp.get("log_every", 50),
                save_every=exp.get("save_every"),
                output_dir=exp.output_dir,
                checkpoints_total_limit=exp.get("checkpoints_total_limit"),
                seed=config.training.get("seed", 0),
                generate_every=exp.get("generate_every"),
                validation_prompts=load_validation_prompts(config))
    return trainer


if __name__ == "__main__":
    main()
