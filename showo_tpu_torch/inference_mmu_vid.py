"""CLI entry: Show-o2 video understanding on PyTorch.

    python -m showo_tpu_torch.inference_mmu_vid \\
        config=configs/showo2_1.5b_demo_432x432.yaml \\
        video_path=./videos/clip.gif 'question=What happens in this video?'

Counterpart of ``showo_tpu/inference_mmu_vid.py``: ``num_frames``
(default 9) frames sampled uniformly from ``video_path`` (a directory of
frame images or a GIF, :func:`~showo_tpu_torch.utils.video.load_video`)
at ``dataset.preprocessing.resolution``, each question of ``question``
split on ``' *** '`` asked about the clip.  The other keys are those of
``inference_mmu_v2`` (``max_new_tokens``, ``top_k``, ``top_p``, ``seed``,
``device=cpu``; ``int8=1`` as there, which the JAX CLI does not read).
Without a card and without ``device=cpu`` it raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from showo_tpu_torch import inference_mmu_v2
from showo_tpu_torch.config import get_config
from showo_tpu_torch.pipelines.mmu_vid import MMUVidPipeline
from showo_tpu_torch.utils.video import load_video


def build_pipeline(config, device: Optional[torch.device] = None
                   ) -> MMUVidPipeline:
    """Config -> ready MMUVidPipeline (``inference_mmu_v2.build_pipeline``
    with ``video=True``)."""
    return inference_mmu_v2.build_pipeline(config, device, video=True)


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config()
    pipe = build_pipeline(config, device=config.get("device"))
    frames = load_video(str(config.video_path), num_frames=pipe.num_frames,
                        resolution=config.dataset.preprocessing.resolution)
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    for q in str(config.question).split(" *** "):
        toks = pipe.answer_video(frames, q, generator)
        print(f"User: {q}\n Answer: {pipe.decode(toks)}")


if __name__ == "__main__":
    main()
