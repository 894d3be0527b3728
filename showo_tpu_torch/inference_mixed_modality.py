"""CLI entry: Show-o2 interleaved mixed-modality generation on PyTorch.

    python -m showo_tpu_torch.inference_mixed_modality \\
        config=configs/showo2_1.5b_demo_432x432.yaml \\
        'prompt=Tell me a short story with pictures.' num_rounds=3

Counterpart of ``showo_tpu/inference_mixed_modality.py``: rounds of text
and images from one prompt (``MixedModalityPipeline``), each round's text
printed and each image written to ``output_dir`` as ``mixed_NNN.png``.
Keys: ``prompt``, ``num_rounds`` (default 3), ``guidance_scale`` (5.0),
``transport.num_inference_steps`` (20), ``max_new_tokens`` (60),
``seed``, ``device=cpu``.  The models, config and tokenizer come from the
text-to-image CLI's loaders (random init from fixed
seeds where a checkpoint path is absent; the stand-in tokenizer without a
local one); without a card and without ``device=cpu`` it raises.
"""

from __future__ import annotations

import logging
import os

import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.inference_t2i_v2 import (load_models,
                                              load_tokenizer_and_ids)
from showo_tpu_torch.pipelines.mixed_modality import MixedModalityPipeline
from showo_tpu_torch.utils.device import entry_device
from showo_tpu_torch.utils.image import to_pil_images

logger = logging.getLogger(__name__)


def build_pipeline(config, device=None) -> MixedModalityPipeline:
    """Config -> ready MixedModalityPipeline on ``device`` (CUDA unless
    ``device="cpu"`` is asked for)."""
    device = entry_device(device)
    tokenizer, token_ids = load_tokenizer_and_ids(config)
    model, vae = load_models(config, device)
    return MixedModalityPipeline(
        model=model, vae=vae, tokenizer=tokenizer, token_ids=token_ids,
        guidance_scale=float(config.get("guidance_scale", 5.0)),
        num_steps=int(config.transport.get("num_inference_steps", 20)),
        max_new_tokens=int(config.get("max_new_tokens", 60)))


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config()
    pipe = build_pipeline(config, device=config.get("device"))
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    rounds, images = pipe.generate(
        str(config.prompt), generator,
        num_rounds=int(config.get("num_rounds", 3)))
    outdir = config.get("output_dir", "outputs_mixed")
    os.makedirs(outdir, exist_ok=True)
    for i, r in enumerate(rounds):
        try:
            text = pipe.tokenizer.batch_decode([r],
                                               skip_special_tokens=True)[0]
        except AttributeError:
            text = str(r)
        print(f"round {i}: {text}")
    for i, im in enumerate(to_pil_images(images)):
        im.save(os.path.join(outdir, f"mixed_{i:03d}.png"))
    logger.info("wrote %d images to %s", len(images), outdir)


if __name__ == "__main__":
    main()
