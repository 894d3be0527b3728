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

Not ported yet: the dataset loaders of ``showo_tpu/data/`` behind the CLI,
checkpoints and resume, EMA, validation images and prediction panels.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.inference_t2i import (build_showo_config, load_model,
                                           load_tokenizer, load_vq)
from showo_tpu_torch.models.magvit import MagvitV2
from showo_tpu_torch.models.phi import check_route
from showo_tpu_torch.models.showo import Showo, showo_losses
from showo_tpu_torch.ops.flash_attention import (metadata_mmu,
                                                 metadata_predict_next,
                                                 seg_from_soi_eoi)
from showo_tpu_torch.ops.masks import omni_mask_mmu, omni_mask_predict_next
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.schedules import get_mask_schedule
from showo_tpu_torch.training.corruption import mask_or_random_replace_tokens
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
        opt_params = c.get_path("optimizer.params", {}) or {}
        self.cfg = self.model.cfg
        # float(): YAML reads "1e-4" (no dot) as a string
        max_norm = tr.get("max_grad_norm", 1.0)
        self.tc = TrainConfig(
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
        if (tr.get("ema") or {}).get("enabled", False):
            raise NotImplementedError("training.ema is not ported yet")
        precision = tr.get("mixed_precision", "no")
        if precision not in _PRECISION:
            raise NotImplementedError(
                f"mixed_precision={precision!r} is not ported; the port "
                f"has 'bf16' and 'no'")
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
            autocast_dtype=(_PRECISION[precision]
                            if self.device.type == "cuda" else None))
        self.global_step = 0

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
        accumulation, one micro-step)."""
        metrics = self.step_fn(*self.host_batch(t2i_batch, lm_texts,
                                                mmu_batch),
                               generator=generator, noise=noise)
        self.global_step += 1
        return metrics

    def fit(self, t2i_loader, lm_loader, mmu_loader, max_steps: int,
            log_every: int = 50, save_every: Optional[int] = None,
            seed: int = 0, generate_every: Optional[int] = None):
        """Steps over the zipped loaders until ``max_steps``; logs every
        ``log_every`` steps.  Each step's corruption generator depends on
        (seed, step) only."""
        if save_every or generate_every:
            raise NotImplementedError(
                "checkpoints (save_every) and validation images "
                "(generate_every) are not ported yet")
        sizes = sum(self.step_fn.sizes)
        t0 = time.perf_counter()
        for t2i_b, lm_b, mmu_b in max_size_cycle_zip(t2i_loader, lm_loader,
                                                     mmu_loader):
            gen = step_generator(self.device, seed, self.global_step)
            metrics = self.train_step(t2i_b, lm_b["input_ids"], mmu_b, gen)
            if self.global_step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                lap = (time.perf_counter() - t0) / log_every
                m.update(batch_time=lap, samples_per_sec=sizes / lap)
                logger.info("step %d: %s", self.global_step, m)
                t0 = time.perf_counter()
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


def _build_loaders(config, tokenizer):
    """The t2i (ImageNet folder or tar shards), mmu (tar shards) and lm
    (RefinedWeb parquet) loaders of the config."""
    raise NotImplementedError(
        "the training data loaders (showo_tpu/data/: ImageNet folders, tar "
        "shards, RefinedWeb parquet) are not ported yet; they are the data "
        "slice of the port. ShowoTrainer.fit takes any three iterables of "
        "host batches meanwhile")


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config()
    trainer = build_trainer(config, device=config.get("device"))
    if config.experiment.get("resume_from_checkpoint"):
        logger.warning("resume_from_checkpoint: checkpoints are not ported "
                       "yet; starting from step 0")
    loaders = _build_loaders(config, trainer.uni_prompting.text_tokenizer)
    trainer.fit(*loaders, max_steps=config.training.max_train_steps,
                log_every=config.experiment.get("log_every", 50),
                save_every=config.experiment.get("save_every"),
                seed=config.training.get("seed", 0),
                generate_every=config.experiment.get("generate_every"))


if __name__ == "__main__":
    main()
