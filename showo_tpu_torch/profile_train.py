"""Device-time breakdown of one warm training step.

    python -m showo_tpu_torch.profile_train --route trainable \
        [--config stage1|tuning512] [--slice v1|v2] \
        [--optimizer adamw|adamw_bf16|adafactor] \
        [--remat none|full|dots|qkv|qkv_fc1|qkv_attn|qkv_fc1_attn] \
        [--softmax fp32|bf16]

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
for the port's own kernels).  ``--optimizer``, ``--remat`` and
``--softmax`` set the configuration's ``training.optimizer``,
``training.remat`` and ``model.showo.attn_fp32`` (bf16: the dense
route's softmax in bf16), as bench.py's ``opt=``, ``remat=`` and
``softmax=`` do (:func:`mode_overrides`).

``--slice v2`` does the same for the Show-o2 1.5B stage-1 trainer
(``configs/showo2_1.5b_stage_1_a.yaml``, warmup 0: Qwen2.5 28 layers, 12
q / 2 kv heads of 128; the DiT 10 layers, 32 / 8 of 64; SigLIP and the
Wan2.1 VAE frozen; AdamW, remat "full", bf16 autocast over fp32 master
weights) on the seeded batch of :func:`v2_batch` (``--batch`` rows of
``--seq`` tokens, 432x432 images; ``trainable`` runs kernel 7 to S = 1280
for Qwen, 1024 for the DiT, kernel 8 past).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from showo_tpu_torch.config import load_config
from showo_tpu_torch.inference_t2i import load_prompts
from showo_tpu_torch.profile_t2i import profile
from showo_tpu_torch.training.optim import OPTIMIZERS
from showo_tpu_torch.training.train_showo import build_trainer
from showo_tpu_torch.utils.remat import POLICIES

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


def mode_overrides(optimizer: str = "adamw", remat: str = "full",
                   softmax: str = "fp32") -> list:
    """Config overrides of a training mode (v1 and Show-o2 configs alike):
    the optimizer, the layer remat policy and the dense route's softmax
    dtype."""
    if softmax not in ("fp32", "bf16"):
        raise ValueError(f"softmax {softmax!r}: fp32 or bf16")
    return [f"training.optimizer={optimizer}", f"training.remat={remat}",
            f"model.showo.attn_fp32={softmax == 'fp32'}"]
V2_STAGE1 = "configs/showo2_1.5b_stage_1_a.yaml"


def v2_config(*overrides):
    """The Show-o2 1.5B stage-1a config with warmup 0 (its 2000 warmup
    steps would hold the first steps' learning rate at ~0)."""
    return load_config(V2_STAGE1, ["training.warmup_steps=0", *overrides])


def v2_batch(num_image_tokens: int, batch_size: int = 2,
             seq_len: int = None, und: int = 0, seed: int = 0,
             resolution: int = None) -> dict:
    """A seeded host batch for ``Stage1Trainer.train_step``: the in-tree
    prompts in the stage-1 jsonl layouts (t2i rows, then ``und``
    understanding rows) of ``seq_len`` tokens (the config's
    ``max_seq_length`` by default) with spans of ``num_image_tokens``,
    pixels uniform in [-1, 1] at ``resolution`` (the config's by
    default)."""
    from showo_tpu_torch.inference_t2i_v2 import load_tokenizer_and_ids
    from showo_tpu_torch.show_o2.formats import (format_sequence_gen_qwen2_5,
                                                 format_sequence_und)

    config = load_config(V2_STAGE1)
    pre = config.dataset.preprocessing
    seq_len = seq_len or pre.max_seq_length
    tok, ids = load_tokenizer_and_ids(config)
    prompts = load_prompts(config)
    n_img = num_image_tokens
    rows, types = [], []
    for i in range(batch_size):
        mmu = i >= batch_size - und
        fmt = format_sequence_und if mmu else format_sequence_gen_qwen2_5
        text = tok(prompts[i % len(prompts)])["input_ids"][:pre.max_text_len]
        rows.append(fmt(text, ids["bos_id"], ids["eos_id"], ids["boi_id"],
                        ids["eoi_id"], ids["pad_id"], ids["img_pad_id"],
                        n_img, seq_len))
        types.append("mmu" if mmu else "t2i")
    tt, tl, mp, _, im = (np.stack(c) for c in zip(*rows))
    rng = np.random.default_rng(seed)
    res = resolution or pre.resolution
    return {"text_tokens": tt, "text_labels": tl, "modality_positions": mp,
            "image_masks": im, "data_type": types,
            "images": rng.uniform(-1, 1, size=(batch_size, res, res, 3))
            .astype(np.float32)}


def v2_trainer(route: str = "trainable", *overrides):
    """The full-width Show-o2 stage-1 trainer on ``route``."""
    from showo_tpu_torch.show_o2.train_stage_one import \
        build_trainer as build_v2

    return build_v2(v2_config(*overrides), torch.device("cuda"),
                    attn_impl=route)


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
    ap.add_argument("--slice", default="v1", choices=("v1", "v2"))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    ap.add_argument("--remat", default="full", choices=POLICIES)
    ap.add_argument("--softmax", default="fp32", choices=("fp32", "bf16"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    mode = mode_overrides(args.optimizer, args.remat, args.softmax)
    what = f"{args.optimizer}, remat {args.remat}, {args.softmax} softmax"
    if args.slice == "v2":
        trainer = v2_trainer(args.route, *mode)
        batch = v2_batch(trainer.model.cfg.num_image_tokens, args.batch,
                         args.seq)
        trainer.train_step(batch)                            # warm-up
        torch.cuda.synchronize()
        profile(lambda: trainer.train_step(batch),
                f"route {args.route}: Show-o2 stage-1 step ({args.batch} "
                f"rows x {args.seq}; {what})", rows_shown=25)
        return
    trainer = build_trainer(CONFIGS[args.config](*mode),
                            torch.device("cuda"), attn_impl=args.route)
    batch, noise = train_batch(trainer)
    trainer.train_step(*batch, noise=noise)                  # warm-up
    torch.cuda.synchronize()
    rows = sum(trainer.step_fn.sizes)
    tokens = trainer.tc.max_seq_length + 3 + trainer.cfg.num_vq_tokens
    profile(lambda: trainer.train_step(*batch, noise=noise),
            f"route {args.route}: {args.config} step ({rows} rows x "
            f"{tokens}; {what})", rows_shown=25)


if __name__ == "__main__":
    main()
