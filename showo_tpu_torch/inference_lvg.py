"""CLI entry: Show-o v1 long-video generation (lvg) on PyTorch.

    python -m showo_tpu_torch.inference_lvg config=configs/showo_demo.yaml \\
        num_frames=8 context_frames=2 batch_size=2 \\
        [validation_prompts_file=prompts.txt] [image_path=first_frame.png]

Counterpart of ``showo_tpu/inference_lvg.py``: ``LVGPipeline`` (MaskGIT a
frame over the lvg masks) on every prompt of the prompt file, a batch at a
time (the last batch filled with its last prompt), each video written as
a horizontal strip ``lvg_NNNN_strip.png`` and per-frame
``lvg_NNNN_fTTT.png`` into ``output_dir``.  ``image_path`` gives every
video the same first frame.  The model, codec, tokenizer and prompt file
come from the text-to-image CLI's loaders (random init from fixed seeds
where a checkpoint path is absent; the stand-in tokenizer and the in-tree
prompts without local ones).  Show-o runs on CUDA in bf16 and MAGVIT-v2
in fp32, or both in fp32 on the CPU with ``device=cpu``; without a card
and without that key it raises.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.inference_t2i import (build_prompting,
                                           build_showo_config, load_model,
                                           load_prompts, load_vq)
from showo_tpu_torch.pipelines.lvg import LVGPipeline
from showo_tpu_torch.utils.device import entry_device
from showo_tpu_torch.utils.image import to_pil_images

logger = logging.getLogger(__name__)


def build_pipeline(config, device: Optional[torch.device] = None
                   ) -> LVGPipeline:
    """Config -> ready LVGPipeline (weights loaded or random-init), on CUDA
    unless ``device="cpu"`` is asked for."""
    device = entry_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return LVGPipeline(
        model=load_model(config, build_showo_config(config), device, dtype),
        vq=load_vq(config, device), uni_prompting=build_prompting(config),
        guidance_scale=float(config.get("guidance_scale",
                                        config.training.guidance_scale)),
        timesteps=int(config.get("generation_timesteps",
                                 config.training.generation_timesteps)),
        mask_schedule=config.training.get("mask_schedule", "cosine"),
        context_frames=int(config.get("context_frames", 2)))


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config()
    pipe = build_pipeline(config, device=config.get("device"))
    prompts = load_prompts(config)
    batch_size = int(config.get("batch_size", 2))
    num_frames = int(config.get("num_frames", 8))
    outdir = config.get("output_dir", "outputs_lvg")
    os.makedirs(outdir, exist_ok=True)
    first = None
    if config.get("image_path"):
        from PIL import Image

        from showo_tpu_torch.utils.image import image_transform

        im = image_transform(Image.open(config.image_path).convert("RGB"),
                             config.dataset.params.resolution)
        first = np.broadcast_to(im[None], (batch_size, *im.shape)).copy()
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    for step in range(0, len(prompts), batch_size):
        chunk = prompts[step:step + batch_size]
        chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
        videos = pipe.generate(chunk, num_frames, generator,
                               first_frame_nhwc=first)   # [B, T, H, W, 3]
        for i in range(len(chunk)):
            strip = np.concatenate(list(videos[i]), axis=1)
            to_pil_images(strip[None])[0].save(
                os.path.join(outdir, f"lvg_{step + i:04d}_strip.png"))
            for t, im in enumerate(to_pil_images(videos[i])):
                im.save(os.path.join(outdir,
                                     f"lvg_{step + i:04d}_f{t:03d}.png"))
        logger.info("generated %d videos x %d frames (step %d)", len(chunk),
                    num_frames, step)


if __name__ == "__main__":
    main()
