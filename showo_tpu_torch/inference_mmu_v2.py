"""CLI entry: Show-o2 multimodal understanding (image VQA) on PyTorch.

    python -m showo_tpu_torch.inference_mmu_v2 \\
        config=configs/showo2_1.5b_demo_432x432.yaml \\
        mmu_image_root=./mmu_validation 'question=Describe this image.'

Counterpart of ``showo_tpu/inference_mmu_v2.py``: every image of
``mmu_image_root`` (png, jpg, jpeg, webp, in name order) is read at
``dataset.preprocessing.resolution`` and asked each question of
``question`` split on ``' *** '``.  Keys: ``int8=1`` (weight-only int8
serving: every Qwen2 matmul and the vocabulary head on the int8 kernel),
``max_new_tokens`` (default 300), ``top_k`` (default 1, greedy),
``top_p``, ``seed``, ``device=cpu``.  The model, VAE, config and
tokenizer come from ``inference_t2i_v2``'s loaders (random init from
fixed seeds where a checkpoint path is absent; the stand-in tokenizer
without a local one).  Show-o2 runs on CUDA in bf16 and the VAE in fp32,
or both in fp32 on the CPU when asked; without a card and without
``device=cpu`` it raises.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.inference_t2i_v2 import (load_models,
                                              load_tokenizer_and_ids)
from showo_tpu_torch.pipelines.mmu_v2 import MMUV2Pipeline
from showo_tpu_torch.pipelines.mmu_vid import MMUVidPipeline
from showo_tpu_torch.utils.device import entry_device

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def build_pipeline(config, device: Optional[torch.device] = None,
                   video: bool = False, models=None) -> MMUV2Pipeline:
    """Config -> ready MMUV2Pipeline, or with ``video`` MMUVidPipeline
    (``num_frames``, default 9); weights loaded or random-init.

    device defaults to CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``).  ``models``: a (Show-o2, VAE) pair
    of this config's dims already built (``load_models``), to share one
    build between pipelines; the pipeline fuses (and with ``int8``
    quantizes) it in place."""
    device = entry_device(device)
    tokenizer, token_ids = load_tokenizer_and_ids(config)
    model, vae = models or load_models(config, device)
    kw = dict(model=model, vae=vae, tokenizer=tokenizer,
              token_ids=token_ids,
              max_new_tokens=int(config.get("max_new_tokens", 300)),
              top_k=int(config.get("top_k", 1)),
              top_p=(float(config["top_p"]) if "top_p" in config else None),
              quantize_int8=bool(int(config.get("int8", 0))))
    if video:
        return MMUVidPipeline(num_frames=int(config.get("num_frames", 9)),
                              **kw)
    return MMUV2Pipeline(**kw)


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    from PIL import Image

    from showo_tpu_torch.utils.image import image_transform

    config = get_config()
    pipe = build_pipeline(config, device=config.get("device"))
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    root = config.mmu_image_root
    questions = str(config.question).split(" *** ")
    res = config.dataset.preprocessing.resolution
    for fname in sorted(os.listdir(root)):
        if not fname.lower().endswith(_IMAGE_EXTS):
            continue
        img = image_transform(
            Image.open(os.path.join(root, fname)).convert("RGB"), res)
        for q in questions:
            toks = pipe.answer(img, q, generator)
            print(f"[{fname}] User: {q}\n Answer: {pipe.decode(toks)}")


if __name__ == "__main__":
    main()
