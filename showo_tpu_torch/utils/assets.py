"""In-tree validation assets (``assets/validation/``).

Copy of ``showo_tpu/utils/assets.py``'s path resolution: a configured path
if it exists, else the in-tree asset.  (The JAX package's last resort, a
checkout of the reference repository, is left out: the port never reads
outside its own tree.)  The t2i prompt list, the inpainting pair
(``inpainting/{source,mask}.png``) and the natural test image of the VQ
PSNR gate (``test_image.png``) resolve through here.
"""

import os
from typing import Optional

ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "validation")


def asset_path(*names: str) -> str:
    """Absolute path of an in-tree validation asset (may not exist)."""
    return os.path.join(ASSETS_DIR, *names)


def resolve(preferred: Optional[str], asset: str) -> Optional[str]:
    """``preferred`` if it exists, else the in-tree asset
    ``assets/validation/<asset>`` if it exists, else None."""
    if preferred and os.path.exists(str(preferred)):
        return str(preferred)
    cand = asset_path(asset)
    return cand if os.path.exists(cand) else None


def validation_image(preferred: Optional[str] = None) -> Optional[str]:
    """Natural test image of the VQ PSNR gate."""
    return resolve(preferred, "test_image.png")


def validation_prompts_file(preferred: Optional[str] = None) -> Optional[str]:
    """The t2i prompt list."""
    return resolve(preferred, "text2image_prompts.txt")


def inpainting_pair(image: Optional[str] = None,
                    mask: Optional[str] = None):
    """(source, mask) of the inpainting mode."""
    return (resolve(image, os.path.join("inpainting", "source.png")),
            resolve(mask, os.path.join("inpainting", "mask.png")))
