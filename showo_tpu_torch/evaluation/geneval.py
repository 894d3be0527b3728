"""GenEval and DPG-Bench image sweeps on the port's pipelines.

Counterpart of ``showo_tpu/evaluation/geneval.py`` (the reference's
show-o2/evaluation/inference_geneval.py and inference_dpg.py): GenEval
metadata jsonl prompts -> per-prompt sample folders
(``outdir/<idx:05d>/samples/xxxxx.png`` + ``metadata.jsonl``); DPG txt
prompts -> 2x2 grids ``outdir/<name>.png``; the same tree and PNG bytes
as the JAX package's for the same images.  Prompts are split into
contiguous shards by ``torch.distributed``'s rank and world size when a
process group is initialised (JAX: the process index and count), else
one shard; explicit ``device_id`` / ``num_devices`` keep their meaning.
One ``torch.Generator`` seeded ``seed + device_id`` on the pipeline's
device draws for every prompt in turn, where JAX splits a key per prompt.
GenEval's scoring runs in the external GenEval harness, as in the
reference; DPG's in ``dpg_bench.py``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from showo_tpu_torch.utils.device import process_grid
from showo_tpu_torch.utils.image import to_pil_images

logger = logging.getLogger(__name__)


def _generator(pipeline, seed: int) -> torch.Generator:
    return torch.Generator(
        device=getattr(pipeline, "device", "cpu")).manual_seed(seed)


def run_geneval_sweep(pipeline, metadata_file: str, outdir: str,
                      batch_size: int = 4, seed: int = 0,
                      device_id: Optional[int] = None,
                      num_devices: Optional[int] = None):
    """pipeline: any object with .generate(prompts, generator) -> NHWC
    [-1, 1]."""
    if device_id is None:
        device_id, num_devices = process_grid()

    with open(metadata_file) as f:
        metadatas = [json.loads(line) for line in f if line.strip()]
    indices = np.array_split(np.arange(len(metadatas)), num_devices)[device_id]

    generator = _generator(pipeline, seed + device_id)
    for idx in indices:
        meta = metadatas[idx]
        prompts = [meta["prompt"]] * batch_size
        outpath = os.path.join(outdir, f"{idx:05d}")
        sample_path = os.path.join(outpath, "samples")
        os.makedirs(sample_path, exist_ok=True)
        with open(os.path.join(outpath, "metadata.jsonl"), "w") as fp:
            json.dump(meta, fp)

        images = pipeline.generate(prompts, generator)
        for i, im in enumerate(to_pil_images(images)):
            im.save(os.path.join(sample_path, f"{i:05d}.png"))
        logger.info("geneval prompt %d done (%s)", idx, meta["prompt"][:40])


def run_dpg_sweep(pipeline, prompts_dir: str, outdir: str,
                  batch_size: int = 4, seed: int = 0,
                  device_id: Optional[int] = None,
                  num_devices: Optional[int] = None):
    """DPG-Bench: one txt prompt per file -> ``outdir/<name>.png`` 2x2
    grids of the first four images (show-o2/evaluation/inference_dpg.py
    pattern); scored by ``dpg_bench.run_dpg_scoring``."""
    from PIL import Image

    if device_id is None:
        device_id, num_devices = process_grid()

    files = sorted(f for f in os.listdir(prompts_dir) if f.endswith(".txt"))
    files = np.array_split(np.asarray(files), num_devices)[device_id]
    os.makedirs(outdir, exist_ok=True)

    generator = _generator(pipeline, seed + device_id)
    for fname in files:
        with open(os.path.join(prompts_dir, fname)) as f:
            prompt = f.read().strip()
        images = pipeline.generate([prompt] * batch_size, generator)
        pil = to_pil_images(images)
        w, h = pil[0].size
        grid = Image.new("RGB", (2 * w, 2 * h))
        for i, im in enumerate(pil[:4]):
            grid.paste(im, ((i % 2) * w, (i // 2) * h))
        grid.save(os.path.join(outdir, fname.replace(".txt", ".png")))
