"""CLI entry: Show-o v1 text-to-image on PyTorch.

    python -m showo_tpu_torch.inference_t2i \
        config=configs/showo_demo_512x512.yaml mode=t2i batch_size=2

Counterpart of ``showo_tpu/inference_t2i.py``, its three modes:

* ``mode=t2i``: one PNG per prompt of the prompt file, ``t2i_%05d.png``;
* ``mode=inpainting``: ``prompt``, ``image_path`` and
  ``inpainting_mask_path`` (the in-tree pair
  ``assets/validation/inpainting/`` when they are not given or do not
  exist), ``batch_size`` images ``inpaint_%03d.png``;
* ``mode=extrapolation``: ``prompt`` and ``extra_direction`` each split on
  ``" *** "`` (one prompt per direction: left, right, up, down),
  ``image_path``, ``offset``; ``batch_size`` images
  ``extrapolate_%03d.png`` of the stitched canvas.

Weights:
``model.showo.pretrained_model_path`` / ``model.vq_model.vq_model_name``
are loaded when they exist locally as reference checkpoints (file or
directory); otherwise the model is random-initialised from a fixed seed.
The tokenizer loads from a local ``model.showo.llm_model_path`` through
``transformers``; otherwise the deterministic
``showo_tpu_torch.utils.fake_tokenizer`` stands in.  Prompts come from
``validation_prompts_file`` when it exists, else from the in-tree
``assets/validation/text2image_prompts.txt``.  Runs on CUDA in bf16, or
on the CPU in fp32 when the config key ``device=cpu`` asks for it;
without a card and without that key it raises.  Writes one PNG per
prompt into ``output_dir``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.models.magvit import MagvitV2, VQConfig, init_magvit
from showo_tpu_torch.models.phi import PhiConfig
from showo_tpu_torch.models.showo import Showo, ShowoConfig, init_showo
from showo_tpu_torch.pipelines.t2i import T2IPipeline
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.utils.assets import (inpainting_pair,
                                          validation_prompts_file)
from showo_tpu_torch.utils.convert import (load_magvit,
                                           load_reference_weights, load_showo)
from showo_tpu_torch.utils.device import entry_device
from showo_tpu_torch.utils.image import image_transform, to_pil_images

logger = logging.getLogger(__name__)

def build_showo_config(config) -> ShowoConfig:
    m = config.model.showo
    return ShowoConfig(
        vocab_size=m.vocab_size,
        llm_vocab_size=m.llm_vocab_size,
        num_new_special_tokens=m.num_new_special_tokens,
        codebook_size=m.codebook_size,
        num_vq_tokens=m.num_vq_tokens,
        w_clip_vit=m.get("w_clip_vit", False),
        # the projector's input: the CLIP width, times the S2 scales
        clip_feat_dim=(int(dict(m.get("clip_vit", {})).get("hidden_size", 1024))
                       * (len(str(m["clip_s2_scales"]).split(","))
                          if m.get("clip_s2_scales", None) else 1)),
        llm=PhiConfig(vocab_size=m.vocab_size,
                      attn_fp32=bool(m.get("attn_fp32", True)),
                      # optional dim overrides for tiny e2e CLI runs
                      **{k: int(v) for k, v in dict(m.get("phi", {})).items()}),
    )


def load_model(config, cfg: ShowoConfig, device, dtype) -> Showo:
    path = config.model.showo.pretrained_model_path
    if os.path.exists(path):
        logger.info("loading Show-o weights from %s", path)
        model = Showo(cfg, device=device, dtype=dtype)
        load_showo(model, load_reference_weights(path))
        return model.eval().requires_grad_(False)
    logger.warning("pretrained_model_path=%s not found; random init", path)
    return init_showo(cfg, torch.Generator(device=device).manual_seed(0),
                      device=device, dtype=dtype)


def load_vq(config, device) -> MagvitV2:
    # optional dim overrides (tiny e2e CLI runs); defaults = MAGVIT-v2
    ov = dict(config.model.vq_model.get("dims", {}))
    vq_cfg = VQConfig(**{k: (tuple(v) if isinstance(v, (list, tuple))
                             else int(v)) for k, v in ov.items()})
    path = config.model.vq_model.vq_model_name
    if os.path.exists(path):
        logger.info("loading MAGVIT-v2 weights from %s", path)
        vq = load_magvit(MagvitV2(vq_cfg, device=device),
                         load_reference_weights(path))
        return vq.eval().requires_grad_(False)
    logger.warning("vq_model_name=%s not found; random init", path)
    return init_magvit(vq_cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)


def load_tokenizer(config):
    path = config.model.showo.llm_model_path
    if os.path.isdir(path):
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path, padding_side="left",
                                             local_files_only=True)
    logger.warning("tokenizer %s not found locally; using FakeTokenizer",
                   path)
    from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer

    return FakeTokenizer()


def build_prompting(config) -> UniversalPrompting:
    return UniversalPrompting(
        load_tokenizer(config),
        max_text_len=config.dataset.preprocessing.max_seq_length)


def load_prompts(config) -> List[str]:
    """Every line of ``validation_prompts_file`` (top level, else
    ``dataset.params``) when it exists, else of the in-tree prompt list,
    blank lines included, as the JAX CLI reads it (image ``i`` is the
    prompt of line ``i``)."""
    path = validation_prompts_file(config.get(
        "validation_prompts_file",
        config.dataset.params.get("validation_prompts_file")))
    with open(path) as f:
        return f.read().splitlines()


def build_pipeline(config, device: Optional[torch.device] = None,
                   attn_impl: str = "auto") -> T2IPipeline:
    """Config -> ready T2IPipeline (weights loaded or random-init).

    device defaults to CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``).  Show-o runs in bf16 on CUDA (the
    kernels' type) and fp32 on the CPU; MAGVIT runs in fp32, as in the JAX
    pipeline.  attn_impl: the pipeline's attention route
    (``T2IPipeline.attn_impl``)."""
    device = entry_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = build_showo_config(config)
    return T2IPipeline(
        model=load_model(config, cfg, device, dtype),
        vq=load_vq(config, device),
        uni_prompting=build_prompting(config),
        guidance_scale=float(config.get("guidance_scale",
                                        config.training.guidance_scale)),
        timesteps=int(config.get("generation_timesteps",
                                 config.training.generation_timesteps)),
        mask_schedule=config.training.get("mask_schedule", "cosine"),
        max_seq_length=config.dataset.preprocessing.max_seq_length,
        resolution=config.dataset.params.resolution,
        attn_impl=attn_impl,
    )


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config()
    mode = config.get("mode", "t2i")
    if mode not in ("t2i", "inpainting", "extrapolation"):
        raise SystemExit(f"unknown mode {mode}")
    pipe = build_pipeline(config, device=config.get("device"))
    batch_size = int(config.get("batch_size", 4))
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    outdir = config.get("output_dir", "outputs")
    os.makedirs(outdir, exist_ok=True)
    resolution = config.dataset.params.resolution

    if mode == "t2i":
        prompts = load_prompts(config)
        for step in range(0, len(prompts), batch_size):
            chunk = prompts[step:step + batch_size]
            images = pipe.generate(chunk, generator)
            for i, im in enumerate(to_pil_images(images)):
                im.save(os.path.join(outdir, f"t2i_{step + i:05d}.png"))
            logger.info("generated %d images (step %d)", len(chunk), step)
        return

    from PIL import Image

    if mode == "inpainting":
        src_path, mask_path = inpainting_pair(
            config.get("image_path"), config.get("inpainting_mask_path"))
        img = image_transform(Image.open(src_path).convert("RGB"),
                              resolution)
        mask = image_transform(Image.open(mask_path).convert("L"),
                               resolution, normalize=False)[:, :, 0]
        images = pipe.inpaint(config.prompt, img, mask, generator,
                              batch_size=batch_size)
        name = "inpaint"
    else:
        prompts = [p for p in config.prompt.split(" *** ") if p]
        directions = [d for d in config.extra_direction.split(" *** ") if d]
        img = image_transform(Image.open(config.image_path).convert("RGB"),
                              resolution)
        images = pipe.extrapolate(prompts, directions, img, generator,
                                  offset=int(config.get("offset", 0)),
                                  batch_size=batch_size)
        name = "extrapolate"
    for i, im in enumerate(to_pil_images(images)):
        im.save(os.path.join(outdir, f"{name}_{i:03d}.png"))
    logger.info("%s: wrote %d images of %s", mode, len(images),
                tuple(images.shape[1:3]))


if __name__ == "__main__":
    main()
