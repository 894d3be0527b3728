"""Host-side video loading.

A copy of ``showo_tpu/utils/video.py`` (show-o2/utils.py:236-253
``load_video`` without the decord C++ dependency): frame directories
(image files in name order), GIFs and anything else PIL iterates, sampled
uniformly to ``num_frames``, the last frame repeated when there are fewer,
each read as :func:`~showo_tpu_torch.utils.image.image_transform` reads an
image.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from showo_tpu_torch.utils.image import image_transform

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def _uniform_indices(total: int, num_frames: int) -> List[int]:
    if total <= 0:
        return []
    return [round(i * (total - 1) / max(num_frames - 1, 1))
            for i in range(num_frames)]


def load_video(path: str, num_frames: int = 9, resolution: int = 432
               ) -> np.ndarray:
    """[T, H, W, 3] float32 in [-1, 1] with T = num_frames."""
    from PIL import Image, ImageSequence

    frames: List = []
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path)
                       if f.lower().endswith(_IMAGE_EXTS))
        for i in _uniform_indices(len(files), num_frames):
            frames.append(Image.open(os.path.join(path, files[i]))
                          .convert("RGB"))
    else:
        with Image.open(path) as img:
            every = [f.convert("RGB") for f in ImageSequence.Iterator(img)]
        frames = [every[i] for i in _uniform_indices(len(every), num_frames)]
    if not frames:
        raise ValueError(f"no frames found in {path}")
    while len(frames) < num_frames:
        frames.append(frames[-1])
    return np.stack([image_transform(f, resolution) for f in frames])
