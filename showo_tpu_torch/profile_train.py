"""Device-time breakdown of one warm Show-o v1 training step.

    python -m showo_tpu_torch.profile_train --route trainable \
        [--config stage1|tuning512]

Builds the trainer of one configuration (Show-o 1.3B: Phi-1.5 24 layers,
hidden 2048, 32 heads; the full MAGVIT-v2 encoder, frozen; AdamW, remat
"full", bf16 autocast over fp32 master weights; random weights from a
fixed seed; warmup 0 so that every step moves the weights):

* ``stage1`` (default): ``configs/showo_pretraining_stage1.yaml``, 15 t2i
  + 4 lm + 10 mmu rows of 387 tokens at 256x256, clip 1.0;
* ``tuning512``: ``configs/showo_instruction_tuning_1_512x512.yaml``, 5
  t2i + 2 lm + 5 mmu rows of 1408 tokens at 512x512, no clipping (past
  the packed trainable budget, so ``trainable`` runs kernel 8);

on one attention route, runs one step on the seeded batch of
:func:`train_batch` to warm up, and profiles the next one with
``torch.profiler``: wall time, device busy time and idle share, kernel
launches, and the largest rows of device time by operator (or by kernel,
for the port's own kernels).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from showo_tpu_torch.config import load_config
from showo_tpu_torch.inference_t2i import load_prompts
from showo_tpu_torch.profile_t2i import profile
from showo_tpu_torch.training.train_showo import build_trainer

STAGE1 = "configs/showo_pretraining_stage1.yaml"
TUNING512 = "configs/showo_instruction_tuning_1_512x512.yaml"


def stage1_config(*overrides):
    """The stage-1 config with warmup 0 (the cosine schedule's first
    steps would otherwise have a learning rate of ~0)."""
    return load_config(STAGE1, ["lr_scheduler.params.warmup_steps=0",
                                *overrides])


def tuning512_config(*overrides):
    """The 512x512 instruction-tuning config (stage 1) with warmup 0."""
    return load_config(TUNING512, ["lr_scheduler.params.warmup_steps=0",
                                   *overrides])


CONFIGS = {"stage1": stage1_config, "tuning512": tuning512_config}


def train_batch(trainer, seed: int = 0):
    """A seeded in-memory batch of the trainer's sizes: pixels uniform in
    [-1, 1] at the config's resolution (on the trainer's device), the
    in-tree prompts as t2i and mmu text, lm documents of one prompt up to
    all of them joined (the longest is cut at the row length), and fixed
    corruption draws.  Returns ((t2i_batch, lm_texts, mmu_batch), noise)
    for ``ShowoTrainer.train_step(*batch, noise=noise)``."""
    tr, dev = trainer.config.training, trainer.device
    res = int(trainer.config.dataset.params.resolution)
    prompts = load_prompts(trainer.config)
    g = torch.Generator(device=dev).manual_seed(seed)

    def images(n):
        return torch.rand(n, res, res, 3, generator=g, device=dev) * 2 - 1

    def texts(n, skip=0):
        return [prompts[(skip + i) % len(prompts)] for i in range(n)]

    n_lm = tr.batch_size_lm
    lm = [" ".join(prompts[:max(1, len(prompts) * i // max(1, n_lm - 1))])
          for i in range(n_lm)]
    noise = {"timesteps": torch.rand(tr.batch_size_t2i, generator=g,
                                     device=dev),
             "uniforms": torch.rand(tr.batch_size_t2i,
                                    trainer.cfg.num_vq_tokens, generator=g,
                                    device=dev)}
    return ({"image": images(tr.batch_size_t2i),
             "text": texts(tr.batch_size_t2i)}, lm,
            {"image": images(tr.batch_size_mmu),
             "text": texts(tr.batch_size_mmu, skip=7)}), noise


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", default="trainable",
                    choices=("trainable", "dense"))
    ap.add_argument("--config", default="stage1", choices=tuple(CONFIGS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    trainer = build_trainer(CONFIGS[args.config](), torch.device("cuda"),
                            attn_impl=args.route)
    batch, noise = train_batch(trainer)
    trainer.train_step(*batch, noise=noise)                  # warm-up
    torch.cuda.synchronize()
    rows = sum(trainer.step_fn.sizes)
    tokens = trainer.tc.max_seq_length + 3 + trainer.cfg.num_vq_tokens
    profile(lambda: trainer.train_step(*batch, noise=noise),
            f"route {args.route}: {args.config} step ({rows} rows x "
            f"{tokens})", rows_shown=25)


if __name__ == "__main__":
    main()
