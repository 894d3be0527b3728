"""Show-o2 stage-2 trainer (show-o2/train_stage_two.py).

    python -m showo_tpu_torch.show_o2.train_stage_two \
        config=configs/showo2_1.5b_stage_2_a.yaml [device=cpu]

Counterpart of ``showo_tpu/show_o2/train_stage_two.py``: the stage-1 step
and trainer with the reference's three-group optimizer (train_stage_two.py
~:157-180): one learning rate for the understanding tower and the patch
embedders (``und``: ``learning_rate_ve``), one for ``fusion_proj``
(``fusion``: ``learning_rate_proj``) and one for the rest, Qwen2 and the
DiT head (``main``: ``learning_rate_showo``), each group clipped by its own
global norm as JAX's ``multi_transform`` of one chain a group does;
``frozen_params`` freezes any of them.  The CLI mixes, one batch of each
a step, the jsonl t2i data (``t2i_jsonl``) with the understanding data:
the LLaVA-OneVision conversations of ``annotation_path`` (images under
``mmu_image_root``; ``data/mmu_dataset.py``, its stage ``config.stage``,
default ``tuning``) when it is set, else the jsonl captions of
``mmu_jsonl``.  A step's batch keeps the keys the two batches share
(``data/mixed.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence

import torch

from showo_tpu_torch.show_o2.showo2 import Showo2
from showo_tpu_torch.show_o2.train_stage_one import (STAGE1_SOURCES,
                                                     Stage1Config,
                                                     Stage1Trainer,
                                                     build_loader,
                                                     build_models,
                                                     build_transport, freeze,
                                                     jsonl_loaders,
                                                     num_image_tokens, run,
                                                     stage1_config, warmup)
from showo_tpu_torch.training.train_step import Optimizer
from showo_tpu_torch.utils.device import entry_device

logger = logging.getLogger(__name__)

# name substrings of each group (JAX GROUP_UND / GROUP_FUSION; the JAX
# package's SigLIP ``pos_embed`` is the port's ``position_embedding``)
GROUP_UND = ("und_trans", "image_embedder_und", "image_embedder_gen",
             "position_embedding")
GROUP_FUSION = ("fusion_proj",)
GROUPS = ("und", "fusion", "main")


def param_groups(model: torch.nn.Module) -> Dict[str, str]:
    """Parameter name -> 'und' / 'fusion' / 'main'."""
    def pick(name):
        if any(s in name for s in GROUP_UND):
            return "und"
        if any(s in name for s in GROUP_FUSION):
            return "fusion"
        return "main"

    return {n: pick(n) for n, _ in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class Stage2Config(Stage1Config):
    lr_und: float = 1e-5
    lr_fusion: float = 5e-5
    lr_main: float = 1e-4


def make_stage2_optimizer(sc: Stage2Config, model: Showo2,
                          frozen_substrings: Sequence[str] = ()
                          ) -> Optimizer:
    """Clip + AdamW in three groups at ``lr_und`` / ``lr_fusion`` /
    ``lr_main``, each clipped by its own norm; the frozen parameters in
    none.  AdamW whatever ``sc.optimizer`` says, as in JAX."""
    freeze(model, frozen_substrings)
    labels = param_groups(model)
    lrs = {"und": sc.lr_und, "fusion": sc.lr_fusion, "main": sc.lr_main}
    params = dict(model.named_parameters())
    return Optimizer([([p for n, p in params.items() if labels[n] == g],
                       lrs[g]) for g in GROUPS],
                     dataclasses.replace(sc, optimizer="adamw"), warmup(sc))


@dataclasses.dataclass
class Stage2Trainer(Stage1Trainer):
    """The stage-1 trainer with the three-group optimizer; pass a
    :class:`Stage2Config` as ``sc``."""

    def make_optimizer(self) -> Optimizer:
        return make_stage2_optimizer(self.sc, self.model,
                                     self.frozen_substrings)


def stage2_config(config, attn_impl: Optional[str] = None) -> Stage2Config:
    """The config's ``training`` keys as a :class:`Stage2Config`: the
    stage-1 fields but the warmup, and the three rates."""
    tr = config.training
    # no warmup and no single learning rate: the JAX CLI reads neither
    base = dict(dataclasses.asdict(stage1_config(config, attn_impl)),
                warmup_steps=0)
    return Stage2Config(
        **base, lr_und=float(tr.get("learning_rate_ve", 5e-5)),
        lr_fusion=float(tr.get("learning_rate_proj", 5e-5)),
        lr_main=float(tr.get("learning_rate_showo", 5e-5)))


def build_trainer(config, device=None,
                  attn_impl: Optional[str] = None) -> Stage2Trainer:
    """Config -> Stage2Trainer, as the stage-1 ``build_trainer``."""
    device = entry_device(device)
    model, vae = build_models(config, device)
    return Stage2Trainer(
        model=model, vae=vae, sc=stage2_config(config, attn_impl),
        transport=build_transport(config, model),
        frozen_substrings=tuple(config.model.get("frozen_params", []) or []))


def build_stage2_loader(config, tokenizer, token_ids, model: Showo2):
    """The CLI's data (JAX ``train_stage_two.main``, :157-189): the t2i
    jsonl loader and, with ``annotation_path``, an ``MMUDataset`` under a
    checkpointable loader of ``batch_size_mmu``, mixed by
    ``concat_max_size_cycle``; without it the stage-1 jsonl loaders."""
    from showo_tpu_torch.data.loader import (CheckpointableDataLoader,
                                             data_shard)
    from showo_tpu_torch.data.mixed import MixedDataLoader
    from showo_tpu_torch.data.mmu_dataset import MMUDataset

    dp, pre = config.dataset.params, config.dataset.preprocessing
    if not dp.get("annotation_path"):
        return build_loader(config, tokenizer, token_ids, model,
                            STAGE1_SOURCES)
    loaders = jsonl_loaders(config, tokenizer, token_ids, model,
                            STAGE1_SOURCES[:1])
    mmu_ds = MMUDataset(
        dp.annotation_path, dp.get("mmu_image_root", ""), tokenizer,
        token_ids, resolution=pre.resolution,
        num_image_tokens=num_image_tokens(config, model),
        max_seq_len=pre.max_seq_length, stage=config.get("stage", "tuning"),
        process=data_shard(model))
    loaders.append(CheckpointableDataLoader(
        lambda: iter(mmu_ds), batch_size=int(config.training.batch_size_mmu)))
    return MixedDataLoader(loaders, mode="concat_max_size_cycle")


def main(argv=None) -> Stage2Trainer:
    from showo_tpu_torch.config import get_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    trainer = build_trainer(config, device=config.get("device"))
    return run(config, trainer, make_loader=build_stage2_loader)


if __name__ == "__main__":
    main()
