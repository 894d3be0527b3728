"""CLI entry: Show-o v1 multimodal understanding (captioning, VQA) on
PyTorch.

    python -m showo_tpu_torch.inference_mmu config=configs/showo_demo.yaml \\
        mmu_image_root=./mmu_validation \\
        'question=Describe this image. *** Is it cute?' int8=1

Counterpart of ``showo_tpu/inference_mmu.py``: every image of
``mmu_image_root`` (png, jpg, jpeg, webp, in name order) is asked each
question of ``question`` split on ``' *** '``.  The discrete path (MAGVIT
codes in the prompt) by default; with ``model.showo.w_clip_vit`` the
CLIP-ViT path (CLIP-L/14-336 features, or the S2 multiscale tower with
``model.showo.clip_s2_scales=336,672,1008``, projected and spliced after
the LLaVA system prompt).  Keys: ``int8=1`` (weight-only int8 serving:
every matmul of Phi on the int8 kernel), ``top_k`` (default 1, greedy),
``top_p``, ``max_new_tokens`` (default 100), ``seed``, ``device=cpu``.
Weights, tokenizer and MAGVIT come from ``inference_t2i``'s loaders (random
init from fixed seeds where a path is absent); the CLIP tower from a
local ``model.showo.vision_tower_path`` (HF ``CLIPVisionModel`` layout),
else random init.  Runs on CUDA in bf16, or on the CPU in fp32 when
asked; without a card and without ``device=cpu`` it raises.
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
                                           load_vq)
from showo_tpu_torch.models.clip_vit import (ClipVisionTower, ClipVitConfig,
                                             clip_vit_features_s2)
from showo_tpu_torch.pipelines.mmu import MMUPipeline
from showo_tpu_torch.utils.convert import (load_clip_vit,
                                           load_reference_weights)
from showo_tpu_torch.utils.device import entry_device

logger = logging.getLogger(__name__)

# the LLaVA system prompt of the reference's CLIP-ViT path
SYSTEM_PROMPT = ("A chat between a curious user and an artificial "
                 "intelligence assistant. The assistant gives helpful, "
                 "detailed, and polite answers to the user's questions.")
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def build_pipeline(config, device: Optional[torch.device] = None
                   ) -> MMUPipeline:
    """Config -> ready MMUPipeline (weights loaded or random-init).

    device defaults to CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``).  Show-o runs in bf16 on CUDA and
    fp32 on the CPU; MAGVIT in fp32, as in the JAX pipeline."""
    device = entry_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = build_showo_config(config)
    return MMUPipeline(
        model=load_model(config, cfg, device, dtype),
        vq=load_vq(config, device),
        uni_prompting=build_prompting(config),
        max_new_tokens=int(config.get("max_new_tokens", 100)),
        top_k=int(config.get("top_k", 1)),
        top_p=(float(config["top_p"]) if "top_p" in config else None),
        quantize_int8=bool(int(config.get("int8", 0))))


def build_clip(config, device: Optional[torch.device] = None):
    """(features function, input size) of the CLIP-ViT path: pixels NHWC
    [B, size, size, 3] -> [B, patches, clip_feat_dim].  The tower runs in
    the pipeline's dtype on ``device`` (CUDA by default, as
    :func:`build_pipeline`)."""
    device = entry_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    m = config.model.showo
    # optional dim overrides (tiny e2e runs); defaults = CLIP-L/14-336
    clip_cfg = ClipVitConfig(**{k: int(v) for k, v in
                                dict(m.get("clip_vit", {})).items()})
    tower = ClipVisionTower(clip_cfg, device=device, dtype=dtype)
    path = str(m.get("vision_tower_path", "openai/clip-vit-large-patch14-336"))
    if os.path.exists(path):
        logger.info("loading CLIP-ViT weights from %s", path)
        load_clip_vit(tower, load_reference_weights(path))
    else:
        logger.warning("vision_tower_path=%s not found; random init", path)
        tower.init_random(torch.Generator(device=device).manual_seed(2))
    tower.eval().requires_grad_(False)
    s2 = m.get("clip_s2_scales", None)
    if s2:
        scales = tuple(int(v) for v in str(s2).split(","))
        return (lambda px: clip_vit_features_s2(tower, px, scales=scales),
                max(scales))
    return tower, clip_cfg.image_size


def system_prompt_ids(pipe: MMUPipeline) -> np.ndarray:
    return np.asarray(pipe.uni_prompting.text_tokenizer(
        [SYSTEM_PROMPT])["input_ids"][0], np.int64)


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    from PIL import Image

    from showo_tpu_torch.utils.image import (clip_image_transform,
                                             image_transform)

    config = get_config()
    device = config.get("device")
    pipe = build_pipeline(config, device=device)
    w_clip = bool(config.model.showo.get("w_clip_vit", False))
    if w_clip:
        clip_fn, clip_size = build_clip(config, device=device)
        sys_ids = system_prompt_ids(pipe)
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    root = config.mmu_image_root
    questions = str(config.question).split(" *** ")
    for fname in sorted(os.listdir(root)):
        if not fname.lower().endswith(_IMAGE_EXTS):
            continue
        pil = Image.open(os.path.join(root, fname)).convert("RGB")
        if w_clip:
            px = torch.as_tensor(clip_image_transform(pil, clip_size),
                                 device=pipe.device)[None]
            feats = clip_fn(px)[0]
        else:
            img = image_transform(pil, config.dataset.params.resolution)
        for q in questions:
            if w_clip:
                toks = pipe.answer_with_clip(feats, q, sys_ids, generator)
            else:
                toks = pipe.answer(img, q, generator)
            print(f"[{fname}] User: {q}\n Answer: {pipe.decode(toks)}")


if __name__ == "__main__":
    main()
