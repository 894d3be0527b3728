"""NSFW safety-check hook (show-o2/inference_t2i.py:92-93, 201-208 uses
StableDiffusionSafetyChecker).

Copy of ``showo_tpu/utils/safety.py``.  diffusers is not a dependency, so
the checker is gated: when a local CLIP safety-checker checkpoint and
diffusers are both available it runs, otherwise it warns, disables itself
and passes images through, reporting them safe.  A hub name is never
fetched (``local_files_only``).  No entry point calls it, as in the JAX
package.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class SafetyChecker:
    def __init__(self, checkpoint_path: Optional[str] = None):
        self._checker = None
        if checkpoint_path:
            try:
                from diffusers.pipelines.stable_diffusion import \
                    safety_checker
                from transformers import CLIPImageProcessor

                self._checker = (safety_checker.StableDiffusionSafetyChecker
                                 .from_pretrained(checkpoint_path,
                                                  local_files_only=True))
                self._processor = CLIPImageProcessor()
            except Exception as e:
                logger.warning("safety checker unavailable (%s); disabled", e)

    def __call__(self, images_nhwc: np.ndarray
                 ) -> Tuple[np.ndarray, List[bool]]:
        """Returns (possibly black-boxed images, has_nsfw flags)."""
        if self._checker is None:
            return images_nhwc, [False] * len(images_nhwc)
        import torch

        x01 = np.clip((images_nhwc + 1.0) / 2.0, 0, 1)
        inputs = self._processor(list((x01 * 255).astype(np.uint8)),
                                 return_tensors="pt")
        checked, flags = self._checker(
            images=torch.tensor(x01.transpose(0, 3, 1, 2)),
            clip_input=inputs.pixel_values)
        out = np.asarray(checked).transpose(0, 2, 3, 1) * 2.0 - 1.0
        return out, list(flags)
