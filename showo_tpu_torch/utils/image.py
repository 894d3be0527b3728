"""Host-side image preprocessing (PIL + numpy) and the inpainting mask.

Copies of ``showo_tpu/utils/image.py``'s ``image_transform`` (bicubic
resize of the short side, centre crop, [0, 1], then [-1, 1] unless
``normalize=False``), ``clip_image_transform`` (the same crop, CLIP mean
/ std) and ``to_pil_images`` (NHWC in [-1, 1] -> PIL images, truncated to
uint8), so that the port reads and writes images as the JAX package does,
and :func:`bicubic_resize_mask`, the mask's downsampling of the inpainting
mode.
"""

from __future__ import annotations

import numpy as np
import torch

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


def image_transform(img, resolution: int = 256,
                    normalize: bool = True) -> np.ndarray:
    """PIL image -> [H, W, C] float32 (NHWC): in [-1, 1], or in [0, 1] with
    ``normalize=False`` (the inpainting mask)."""
    arr = np.asarray(_resize_crop(img, resolution), dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if normalize:
        arr = arr * 2.0 - 1.0
    return arr


def clip_image_transform(img, image_size: int = 336) -> np.ndarray:
    """CLIPImageProcessor's preprocessing: short-side bicubic resize, centre
    crop, CLIP mean / std.  [H, W, 3] float32."""
    x = np.asarray(_resize_crop(img, image_size).convert("RGB"),
                   np.float32) / 255.0
    return ((x - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32))


def to_pil_images(batch_nhwc):
    """[-1, 1] NHWC floats -> list of PIL images (scaled to [0, 255] and
    truncated to uint8, as the JAX package writes its PNGs)."""
    from PIL import Image

    x = np.clip((np.asarray(batch_nhwc) + 1.0) / 2.0, 0.0, 1.0) * 255.0
    return [Image.fromarray(im) for im in x.astype(np.uint8)]


def keys_cubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """[in_size, out_size] float32 resampling weights of an antialiased
    Keys cubic (a = -0.5) resize, as ``jax.image.resize(method="bicubic")``
    builds them (``compute_weight_mat``): half-centred samples, the kernel
    widened by the inverse scale when downsampling, each output's weights
    divided by their sum, every step in float32 as there."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)        # the Python double
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample = ((torch.arange(out_size, dtype=f32) + 0.5)
              * torch.tensor(inv_scale, dtype=f32) - 0.0 - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros((), dtype=f32), w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros((), dtype=f32))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros((), dtype=f32))


def bicubic_resize_mask(mask_hw: np.ndarray, size: int) -> np.ndarray:
    """Downsample a [H, W] mask to [size, size] as
    ``jax.image.resize(method="bicubic")`` does (antialiased Keys cubic;
    not torch's a = -0.75 without antialiasing) and binarize at 0.5
    (reference inference_t2i.py:103-109).  int32 [size, size].

    The weights are JAX's bit for bit.  An output that is exactly 0.5 in
    exact arithmetic (a mask edge through the middle of an output pixel's
    footprint) lands on either side of it by the summation order of the
    float32 products, which on XLA's CPU follows its matmul blocking; there
    the two packages may differ."""
    m = torch.as_tensor(np.asarray(mask_hw, np.float32))
    H, W = m.shape
    wh, ww = keys_cubic_weights(H, size), keys_cubic_weights(W, size)
    # the two float32 products in JAX's order (rows, then columns)
    out = (wh.T @ m) @ ww
    return (out >= 0.5).numpy().astype(np.int32)
