"""Host-side image preprocessing (PIL + numpy) of the understanding path.

Copies of ``showo_tpu/utils/image.py``'s ``image_transform`` (bicubic
resize of the short side, centre crop, [-1, 1]) and
``clip_image_transform`` (the same crop, CLIP mean / std), so that the
port reads images as the JAX package does.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_crop(img, size: int):
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def image_transform(img, resolution: int = 256) -> np.ndarray:
    """PIL image -> [H, W, C] float32 (NHWC, in [-1, 1])."""
    arr = np.asarray(_resize_crop(img, resolution), dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr * 2.0 - 1.0


def clip_image_transform(img, image_size: int = 336) -> np.ndarray:
    """CLIPImageProcessor's preprocessing: short-side bicubic resize, centre
    crop, CLIP mean / std.  [H, W, 3] float32."""
    x = np.asarray(_resize_crop(img, image_size).convert("RGB"),
                   np.float32) / 255.0
    return ((x - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32))
