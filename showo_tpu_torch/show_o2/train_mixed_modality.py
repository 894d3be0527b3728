"""Show-o2 mixed-modality (interleaved) trainer
(show-o2/train_mixed_modality_simple.py).

    python -m showo_tpu_torch.show_o2.train_mixed_modality \
        config=configs/showo2_1.5b_downstream_mixed_modality_simple.yaml \
        dataset.params.mixed_modal_json=A.json \
        dataset.params.mixed_modal_image_root=DIR [device=cpu]

Counterpart of ``showo_tpu/show_o2/train_mixed_modality.py``.  A batch
holds up to M images a sample: pixels [B, M, H, W, 3] and spans
[B, M, 2], (0, 0) where a sample has fewer (``data/vist_dataset.py``).
One step encodes the B*M images with the frozen VAE (no gradient), draws
a time an image (1.0, clean, for a (0, 0) span, whose rows
``image_masks`` leave out of the loss), noises each image's latents
along the linear plan and trains ``ntp_coeff * loss_ntp + flow_coeff *
loss_flow`` under remat.  It reuses :class:`Stage1Step`'s VAE, noise and
attention pieces and its loss, gradient and update.

The route: JAX's step runs dense whatever the config says (its
``showo2_forward`` gets no kernel metadata); the port's takes
``training.attn_impl`` as the stage-1 step does, ``dense`` (JAX's
arithmetic) or ``trainable`` (the config's ``pallas_trainable``: at its
2 x 4352 rows both towers are past ``packed_trainable_fits``, so every
attention runs kernel 8, head dim 128 on Qwen and 64 on the DiT).

The two-phase recipe (show-o2/README.md:293-309) is two calls of the CLI:
the config as it is (``frozen_params`` freezes the und path and the LLM),
then ``model.frozen_params=[]`` with a larger
``training.max_train_steps``.  The second resumes from ``latest`` with
the weights-only fallback: its trained set changed, so the saved
optimizer state does not load, and it starts a fresh one, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from showo_tpu_torch.show_o2.train_stage_one import (Stage1Batch, Stage1Step,
                                                     Stage1Trainer,
                                                     build_models,
                                                     build_transport, run,
                                                     stage1_config)
from showo_tpu_torch.utils.device import entry_device

logger = logging.getLogger(__name__)

MIXED_BATCH_KEYS = ("text_tokens", "text_labels", "images",
                    "modality_positions", "image_masks")


class MixedModalStep(Stage1Step):
    """The mixed-modality step (JAX ``make_mixed_modal_step``); only
    :meth:`prepare` differs from the stage-1 step."""

    @torch.no_grad()
    def prepare(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None) -> Stage1Batch:
        """batch: ``text_tokens`` / ``text_labels`` / ``image_masks``
        [B, L], ``images`` [B, M, H, W, 3] in [-1, 1],
        ``modality_positions`` [B, M, 2], on the model's device.  noise:
        optional ``vae_eps`` (latents' shape [B*M, C, 1, h, w]), ``t``
        [B*M] (the draws, before the (0, 0) spans are set to 1) and ``x0``
        [B*M, C, h, w], used instead of draws from ``generator``."""
        noise = noise or {}
        mp = batch["modality_positions"]
        B, M = mp.shape[:2]
        images = batch["images"]
        latents = self.encode(images.reshape(B * M, *images.shape[2:]),
                              generator, noise.get("vae_eps"))
        t = noise.get("t")
        if t is None:
            t = self.transport.sample_t(B * M, generator,
                                        device=latents.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=latents.device)
        # idle (0, 0) spans are clean (t = 1); image_masks drop their rows
        t = torch.where(mp[:, :, 1].reshape(-1) > 0, t, 1.0)
        t, xt, ut = self.noised(t, latents, generator, noise.get("x0"))
        bias, meta = self.attention(mp, batch["text_tokens"].shape[1])
        return Stage1Batch(batch["text_tokens"], batch["text_labels"], mp,
                           batch["image_masks"], t, xt, ut, bias, meta)


@dataclasses.dataclass
class MixedModalTrainer(Stage1Trainer):
    """Host batches of :class:`VISTDataset` -> the mixed-modality step ->
    metrics, with the stage-1 trainer's loop (checkpoints and the loader
    state every ``save_every``).  ``frozen_substrings`` go through
    ``train_stage_one.freeze`` / ``make_stage1_optimizer``."""

    step_class = MixedModalStep
    batch_keys = MIXED_BATCH_KEYS

    def visualize_reconstruction(self, pixels, output_dir: str,
                                 generator=None) -> np.ndarray:
        """The stage-1 panels of every image of the batch: [B, M, H, W, 3]
        is B*M images, not videos."""
        pixels = np.asarray(pixels, np.float32)
        return super().visualize_reconstruction(
            pixels.reshape(-1, *pixels.shape[2:]), output_dir, generator)


def build_trainer(config, device=None,
                  attn_impl: Optional[str] = None) -> MixedModalTrainer:
    """Config -> MixedModalTrainer.  device defaults to CUDA and raises
    without a card; the CPU runs only when asked for (``device="cpu"``).
    attn_impl overrides ``training.attn_impl`` ("dense" or "trainable"; a
    config's ``pallas_trainable`` reads as ``trainable``)."""
    device = entry_device(device)
    model, vae = build_models(config, device)
    # JAX's mixed-modality CLI weighs the NTP loss 1.0 by default (the
    # stage-1 CLI 0.2)
    sc = dataclasses.replace(
        stage1_config(config, attn_impl),
        ntp_coeff=float(config.training.get("ntp_coeff", 1.0)))
    return MixedModalTrainer(
        model=model, vae=vae, sc=sc,
        transport=build_transport(config, model),
        frozen_substrings=tuple(config.model.get("frozen_params") or ()))


def vist_loader(config, tokenizer, token_ids, model):
    """The config's VIST json as a checkpointable loader of
    ``training.batch_size_mixed_modal`` samples of ``model``'s data shard
    (``data/loader.py::data_shard``)."""
    from showo_tpu_torch.data.loader import (CheckpointableDataLoader,
                                             data_shard)
    from showo_tpu_torch.data.vist_dataset import VISTDataset

    pre, dp = config.dataset.preprocessing, config.dataset.params
    ds = VISTDataset(
        dp.mixed_modal_json, dp.get("mixed_modal_image_root", ""),
        tokenizer, token_ids, resolution=pre.resolution,
        num_image_tokens=pre.num_t2i_image_tokens
        + (1 if model.cfg.add_time_embeds else 0),
        max_seq_len=pre.get("max_mixed_modal_seq_length",
                            pre.max_seq_length),
        max_num_images=int(pre.get("max_num_images", 5)),
        process=data_shard(model))
    return CheckpointableDataLoader(
        lambda: iter(ds),
        batch_size=int(config.training.get("batch_size_mixed_modal", 1)))


def main(argv=None) -> MixedModalTrainer:
    from showo_tpu_torch.config import get_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    trainer = build_trainer(config, device=config.get("device"))
    return run(config, trainer, make_loader=vist_loader)


if __name__ == "__main__":
    main()
