"""The VQ round-trip PSNR gate: MAGVIT-v2 ``get_code`` -> ``decode_code``
on the validation image at 256^2.

    python -m showo_tpu_torch.evaluation.vq_psnr \\
        [vq_model_path=<dir-or-file>] [image=<path>] [resolution=256] \\
        [device=cpu]

Counterpart of the JAX repository's ``tools/eval_vq_psnr.py``: the image
is the in-tree ``assets/validation/test_image.png`` unless ``image`` names
one (``utils/assets.py::validation_image``), read as the pipelines read
images (``image_transform``: [-1, 1]).  With ``vq_model_path`` (a
reference-layout MAGVIT-v2 checkpoint, loaded by ``utils/convert.py``'s
loader) it measures the codec's reconstruction; without one the
full-width codec's random init from a fixed seed, as a smoke run.  Prints
one line, ``vq_roundtrip_psnr=<dB> dB (<pretrained|random-init>, <image>
@<resolution>)``.  The codec runs in fp32 on CUDA unless ``device=cpu``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB of two arrays in [-1, 1]."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float(10 * np.log10(peak ** 2 / max(mse, 1e-12)))


@torch.no_grad()
def roundtrip(vq, pixels: np.ndarray) -> np.ndarray:
    """NHWC pixels in [-1, 1] -> the codec's reconstruction of their codes,
    clipped to [-1, 1] (float32 numpy, the input's shape)."""
    x = torch.as_tensor(np.asarray(pixels, np.float32),
                        device=next(vq.parameters()).device)
    recon = vq.decode_code(vq.get_code(x)).float().cpu().numpy()
    return np.clip(recon, -1, 1)


def load_codec(path, device):
    """(MAGVIT-v2 at the released width on ``device``, tag): the weights of
    ``path`` when it exists, else a random init from seed 0."""
    from showo_tpu_torch.models.magvit import MagvitV2, VQConfig, init_magvit

    if path and os.path.exists(path):
        from showo_tpu_torch.utils.convert import (load_magvit,
                                                   load_reference_weights)

        vq = load_magvit(MagvitV2(VQConfig(), device=device),
                         load_reference_weights(path))
        return vq.eval(), "pretrained"
    vq = init_magvit(VQConfig(), torch.Generator(device=device).manual_seed(0),
                     device=device)
    return vq.eval(), "random-init"


def main(argv=None) -> float:
    """The CLI (module doc); returns the PSNR it prints."""
    from PIL import Image

    from showo_tpu_torch.utils.assets import validation_image
    from showo_tpu_torch.utils.device import entry_device
    from showo_tpu_torch.utils.image import image_transform

    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    image_path = validation_image(args.get("image"))
    if image_path is None:
        raise SystemExit("no validation image found (pass image=...)")
    res = int(args.get("resolution", 256))
    device = entry_device(args.get("device"))
    pixels = image_transform(Image.open(image_path).convert("RGB"),
                             resolution=res)[None]  # [1, H, W, 3] in [-1, 1]
    vq, tag = load_codec(args.get("vq_model_path", ""), device)
    value = psnr(pixels, roundtrip(vq, pixels))
    print(f"vq_roundtrip_psnr={value:.2f} dB "
          f"({tag}, {os.path.basename(image_path)} @{res})")
    return value


if __name__ == "__main__":
    main()
