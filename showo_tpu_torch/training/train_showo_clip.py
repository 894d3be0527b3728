"""Show-o v1 trainer with CLIP-ViT understanding features
(training/train_w_clip_vit.py).

    python -m showo_tpu_torch.training.train_showo_clip \
        config=configs/showo_instruction_tuning_1_w_clip_vit.yaml [device=cpu]

Counterpart of ``showo_tpu/training/train_showo_clip.py``.  It differs
from the fused step of ``training/train_showo.py`` in the understanding
rows (train_w_clip_vit.py:216-219, 512-619): they are LLaVA samples
(``data/llava.py``) whose images become the frozen CLIP-ViT's penultimate
features, projected by ``mm_projector`` inside the graph and spliced into
the token embeddings after ``[mmu][system][soi]`` (576 patches); their
mask is ``omni_mask_mmu_vit``; every row is padded to the widest, the
padded columns of the bias set to -1e9, and one forward on embeddings
gives the three losses.  ``mm_projector`` learns at
``training.projector_lr_scale`` (2.0) times the base rate, each of the two
parameter groups clipped by its own norm (the reference's optimizer
groups, :205-212), at a constant rate as in JAX.

``dataset.und_type`` picks the data: ``llava_pretrain`` (caption pairs,
no system prompt: the features at position 2) or ``llava_tuning``
(conversations after the system prompt, whose length is
``preprocessing.system_prompt_len`` when set, else that of the tokenized
prompt).  The t2i and lm loaders are the v1 CLI's; checkpoints, the EMA,
the loaders' states and the resume from ``latest`` work as there.

The route is ``dense``, as in JAX: ``omni_mask_mmu_vit`` lets the rows
before the image span see it, which the attention kernels' mask predicate
(``j <= i`` or the same non-zero segment or ``j < prefix``) cannot
express, so another ``training.attn_impl`` raises ValueError.  Two
deliberate differences from the JAX package: ``max_grad_norm: null`` (all
four CLIP configs) means no clipping, where JAX's
``optax.clip_by_global_norm(None)`` raises TypeError at the first update;
and the loaders are checkpointable, as the v1 CLI's.  The entry points
run on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from showo_tpu_torch.config import get_config
from showo_tpu_torch.data.loader import data_shard
from showo_tpu_torch.inference_t2i import (build_showo_config, load_model,
                                           load_tokenizer, load_vq)
from showo_tpu_torch.models.clip_vit import ClipVisionTower, ClipVitConfig
from showo_tpu_torch.models.phi import check_route
from showo_tpu_torch.models.showo import Showo, mm_project, showo_losses
from showo_tpu_torch.ops.masks import omni_mask_mmu_vit, omni_mask_predict_next
from showo_tpu_torch.parallel.mesh import (is_writer, load_config_mesh,
                                           shard_params)
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.schedules import get_mask_schedule
from showo_tpu_torch.training.corruption import mask_or_random_replace_tokens
from showo_tpu_torch.training.train_showo import (FusedTrainStep,
                                                  ShowoTrainer, assemble_t2i)
from showo_tpu_torch.training.train_step import Optimizer, TrainConfig
from showo_tpu_torch.utils.device import entry_device

logger = logging.getLogger(__name__)

DENSE_ONLY = (
    "the CLIP-ViT trainer runs the dense route only: omni_mask_mmu_vit lets "
    "the rows before the image span see it, which the attention kernels' "
    "mask (j <= i, the same non-zero segment, or j < prefix) cannot express")
PAD_BIAS = -1e9


def make_projector_lr_optimizer(tc: TrainConfig, model: Showo,
                                projector_lr_scale: float = 2.0
                                ) -> Optimizer:
    """AdamW in two groups, the rest of the model at ``tc.learning_rate``
    and ``mm_projector`` at ``projector_lr_scale`` times it, each clipped
    by its own global norm (``max_grad_norm`` None: not at all), at a
    constant rate."""
    named = list(model.named_parameters())
    proj = [p for n, p in named if "mm_projector" in n]
    base = [p for n, p in named if "mm_projector" not in n]
    return Optimizer([(base, 1.0), (proj, projector_lr_scale)],
                     dataclasses.replace(tc, optimizer="adamw"))


@dataclasses.dataclass
class ClipBatch:
    """One step's rows before the embedding: the t2i and lm ids padded to
    ``L``, the mmu text ids (the features go after position
    ``2 + system_prompt_len``), the frozen CLIP features, every row's
    labels and the additive bias [B, 1, L, L]."""

    ids: torch.Tensor
    mmu_ids: torch.Tensor
    feats: torch.Tensor
    labels: torch.Tensor
    bias: torch.Tensor
    mask_prob: torch.Tensor


def _pad_cols(x: torch.Tensor, fill, width: int) -> torch.Tensor:
    return F.pad(x, (0, width - x.shape[1]), value=fill)


def _pad_bias(b: torch.Tensor, width: int) -> torch.Tensor:
    """New key columns at PAD_BIAS, then new query rows at 0."""
    d = width - b.shape[-1]
    return F.pad(F.pad(b, (0, d), value=PAD_BIAS), (0, 0, 0, d), value=0.0)


class FusedClipTrainStep(FusedTrainStep):
    """The fused step with CLIP features in the mmu rows (JAX
    ``make_fused_clip_train_step``): :meth:`prepare` makes the codes, the
    corruption, the rows, the features and the biases; the inherited call
    runs :meth:`loss_and_grads` and the update."""

    def __init__(self, model: Showo, vq, clip: ClipVisionTower,
                 tc: TrainConfig, optimizer: Optimizer, sp: Dict[str, int],
                 batch_size_t2i: int, batch_size_lm: int,
                 batch_size_mmu: int, mask_schedule, system_prompt_len: int,
                 min_masking_rate: float = 0.0,
                 autocast_dtype: Optional[torch.dtype] = None):
        if check_route(tc.attn_impl) != "dense":
            raise ValueError(f"training.attn_impl={tc.attn_impl!r}: "
                             + DENSE_ONLY)
        super().__init__(model, vq, tc, optimizer, sp, batch_size_t2i,
                         batch_size_lm, batch_size_mmu, mask_schedule,
                         min_masking_rate=min_masking_rate,
                         autocast_dtype=autocast_dtype)
        self.clip = clip
        self.system_prompt_len = system_prompt_len

    @torch.no_grad()
    def prepare(self, t2i_pixels, t2i_text_block, lm_ids, lm_labels,
                mmu_clip_pixels, mmu_ids, mmu_labels,
                generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None) -> ClipBatch:
        """Pixels NHWC in [-1, 1] (the mmu ones at the tower's size);
        ``mmu_ids`` / ``mmu_labels`` [B, 3 + system + text] =
        [mmu][system][soi][eoi] text.  ``noise``: optional corruption draws
        (``timesteps``, ``uniforms``, ``replace_tokens``) instead of
        ``generator`` draws."""
        cfg, sp = self.cfg, self.sp
        mask_id, offset = cfg.mask_token_id, cfg.codebook_offset
        pad, soi, eoi = sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"]
        codes = self.vq.get_code(t2i_pixels)
        noised, img_labels, _, mask_prob = mask_or_random_replace_tokens(
            codes, mask_id, self.mask_schedule, generator=generator,
            **self.corruption, **(noise or {}))
        img = torch.where(noised == mask_id, mask_id, noised + offset)
        img_labels = torch.where(img_labels == -100, -100,
                                 img_labels + offset)
        t2i_ids, t2i_labels = assemble_t2i(t2i_text_block.long(), img.long(),
                                           img_labels.long(), soi, eoi, pad)
        lm_ids, lm_labels = lm_ids.long(), lm_labels.long()
        bias_t2i = omni_mask_predict_next(t2i_ids, pad, soi, eoi,
                                          rm_pad_in_image=True)
        bias_lm = omni_mask_predict_next(lm_ids, pad, soi, eoi)

        dtype = self.autocast_dtype
        with torch.autocast(t2i_pixels.device.type, dtype=dtype,
                            enabled=dtype is not None):
            feats = self.clip(mmu_clip_pixels)
        lo = 2 + self.system_prompt_len          # after [mmu][system][soi]
        Bm, n_patch = mmu_ids.shape[0], feats.shape[1]
        Sm = mmu_ids.shape[1] + n_patch
        dev = mmu_ids.device
        bias_mmu = omni_mask_mmu_vit(Bm, Sm,
                                     system_prompt_len=self.system_prompt_len,
                                     num_patches=n_patch, device=dev)
        mmu_labels = torch.cat([
            torch.full((Bm, lo + n_patch), -100, dtype=torch.long,
                       device=dev), mmu_labels[:, lo:].long()], dim=1)

        L = max(t2i_ids.shape[1], lm_ids.shape[1], Sm)
        ids = torch.cat([_pad_cols(t2i_ids, pad, L),
                         _pad_cols(lm_ids, pad, L)])
        labels = torch.cat([_pad_cols(x, -100, L)
                            for x in (t2i_labels, lm_labels, mmu_labels)])
        bias = torch.cat([_pad_bias(b, L) for b in (bias_t2i, bias_lm,
                                                     bias_mmu)])
        return ClipBatch(ids, mmu_ids.long(), feats, labels, bias, mask_prob)

    def loss_and_grads(self, batch: ClipBatch):
        """(total loss, (loss_t2i, loss_lm, loss_mmu), gradients): the
        projection and every embedding lookup inside the graph, so that
        ``mm_projector`` and the embedding table get gradients."""
        tc = self.tc
        L = batch.ids.shape[1]
        lo = 2 + self.system_prompt_len
        dev = batch.ids.device
        embed = self.model.showo.model.embed_tokens
        with torch.autocast(dev.type, dtype=self.autocast_dtype,
                            enabled=self.autocast_dtype is not None):
            text = embed(batch.mmu_ids)
            feats = mm_project(self.model, batch.feats).to(text.dtype)
            mmu = torch.cat([text[:, :lo], feats, text[:, lo:]], dim=1)
            embeds = torch.cat([embed(batch.ids),
                                F.pad(mmu, (0, 0, 0, L - mmu.shape[1]))])
            _, l_t2i, l_lm, l_mmu = showo_losses(
                self.model, None, batch.labels, batch.bias, *self.sizes,
                max_seq_length=tc.max_seq_length, remat=tc.remat,
                input_embeds=embeds)
            total = (tc.t2i_coeff * l_t2i + tc.lm_coeff * l_lm
                     + tc.mmu_coeff * l_mmu)
        grads = torch.autograd.grad(total, self.optimizer.params)
        return total.detach(), (l_t2i.detach(), l_lm.detach(),
                                l_mmu.detach()), list(grads)


def collate_llava(samples):
    """LLaVA samples -> a batch: the images stacked, the variable-length
    id / label rows kept as lists."""
    out = {"image": np.stack([s["image"] for s in samples]),
           "input_ids": [s["input_ids"] for s in samples],
           "labels": [s["labels"] for s in samples]}
    if "input_ids_system" in samples[0]:
        out["input_ids_system"] = [s["input_ids_system"] for s in samples]
    return out


@dataclasses.dataclass
class ClipShowoTrainer(ShowoTrainer):
    """The v1 trainer on LLaVA understanding batches (train_w_clip_vit.py
    :73-920): ``clip`` is the frozen tower; the mmu rows are
    ``[mmu][system (system_prompt_len)][soi][eoi] text (mmu_text_len)``
    with the features spliced between soi and eoi."""

    clip: Optional[ClipVisionTower] = None
    system_prompt_len: int = 28
    mmu_text_len: int = 128

    def __post_init__(self):
        from showo_tpu_torch.utils.tracker import (Tracker,
                                                   resolve_wandb_run_id)

        c = self.config
        tr = c.training
        self.cfg = self.model.cfg
        self.tc = dataclasses.replace(self.train_config(), optimizer="adamw")
        self.optimizer = make_projector_lr_optimizer(
            self.tc, self.model,
            projector_lr_scale=float(tr.get("projector_lr_scale", 2.0)))
        self.step_fn = FusedClipTrainStep(
            self.model, self.vq, self.clip, self.tc, self.optimizer,
            self.uni_prompting.sptids, tr.batch_size_t2i, tr.batch_size_lm,
            tr.batch_size_mmu,
            get_mask_schedule(tr.get("mask_schedule", "cosine")),
            system_prompt_len=self.system_prompt_len,
            min_masking_rate=tr.get("min_masking_rate", 0.0),
            autocast_dtype=self.autocast_dtype())
        wandb_on = bool(c.get("wandb_enabled", False))
        run_id, resume = resolve_wandb_run_id(c, c.experiment.output_dir,
                                              enabled=wandb_on)
        self.tracker = Tracker(project=c.experiment.get("project"),
                               name=c.experiment.get("name"),
                               enabled=wandb_on, run_id=run_id,
                               resume=resume)
        self.global_step = 0
        self.ema = self._init_ema(tr.get("ema") or {})

    def mmu_clip_block(self, mmu_batch):
        """LLaVA samples -> fixed-shape [mmu][system][soi][eoi] text id /
        label blocks [B, 3 + system_prompt_len + mmu_text_len] (pads ->
        -100 in the labels; the system and text rows cut to their
        widths)."""
        sp = self.uni_prompting.sptids
        ids_list, labels_list = mmu_batch["input_ids"], mmu_batch["labels"]
        sys_list = mmu_batch.get("input_ids_system")
        B, S, W = len(ids_list), self.system_prompt_len, self.mmu_text_len
        ids = np.full((B, 3 + S + W), sp["<|pad|>"], np.int32)
        labels = np.full((B, 3 + S + W), -100, np.int32)
        ids[:, 0] = sp["<|mmu|>"]
        ids[:, 1 + S] = sp["<|soi|>"]
        ids[:, 2 + S] = sp["<|eoi|>"]
        for i in range(B):
            if S:
                sys_ids = np.asarray(sys_list[i])[:S]
                ids[i, 1:1 + len(sys_ids)] = sys_ids
            row = np.asarray(ids_list[i])[:W]
            lab = np.asarray(labels_list[i])[:W]
            ids[i, 3 + S:3 + S + len(row)] = row
            labels[i, 3 + S:3 + S + len(lab)] = lab
        return ids, labels

    def host_batch(self, t2i_batch, lm_texts, mmu_batch):
        """Host batches -> the step's tensors on the model's device: the t2i
        text blocks, the lm rows as long as the t2i rows, the mmu blocks of
        :meth:`mmu_clip_block` and the NHWC pixels."""
        uni, dev = self.uni_prompting, self.device
        t2i_text = uni.t2i_text_block(t2i_batch["text"])
        L = t2i_text.shape[1] + self.cfg.num_vq_tokens + 2
        lm_ids, _, lm_labels = uni.lm_prompt(
            uni.text_tokenizer(list(lm_texts))["input_ids"], L)
        mmu_ids, mmu_labels = self.mmu_clip_block(mmu_batch)

        def put(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        return (put(t2i_batch["image"], torch.float32), put(t2i_text),
                put(lm_ids), put(lm_labels),
                put(mmu_batch["image"], torch.float32), put(mmu_ids),
                put(mmu_labels))


def build_clip_tower(config, device) -> ClipVisionTower:
    """The frozen fp32 CLIP-ViT (L/14-336 unless ``model.showo.clip_vit``
    overrides its dims): the weights of ``model.showo.vision_tower_path``
    when it exists locally, else a random init from a fixed seed."""
    from showo_tpu_torch.utils.convert import (load_clip_vit,
                                               load_reference_weights)

    m = config.model.showo
    clip_cfg = ClipVitConfig(**{k: int(v) for k, v in
                                dict(m.get("clip_vit", {})).items()})
    tower = ClipVisionTower(clip_cfg, device=device, dtype=torch.float32)
    path = str(m.get("vision_tower_path", "") or "")
    if path and os.path.exists(path):
        logger.info("loading CLIP-ViT weights from %s", path)
        load_clip_vit(tower, load_reference_weights(path))
    else:
        logger.warning("random-init CLIP tower (%s)", path)
        tower.init_random(torch.Generator(device=device).manual_seed(7))
    return tower.eval().requires_grad_(False)


def system_prompt_len(config, tokenizer) -> int:
    """The system prompt's length in the mmu rows: 0 for
    ``llava_pretrain``; for ``llava_tuning``
    ``preprocessing.system_prompt_len`` when set, else the tokenized
    prompt's (``data/llava.py::SYSTEM_PROMPT``)."""
    from showo_tpu_torch.data.llava import SYSTEM_PROMPT

    if config.dataset.get("und_type", "llava_tuning") == "llava_pretrain":
        return 0
    n = len(tokenizer([SYSTEM_PROMPT])["input_ids"][0])
    return int(config.dataset.preprocessing.get("system_prompt_len", n))


def build_trainer(config, device=None, attn_impl: Optional[str] = None,
                  mesh=None) -> ClipShowoTrainer:
    """Config -> ClipShowoTrainer: Show-o with ``mm_projector`` (checkpoint
    or random init, fp32 master weights, trainable), the frozen MAGVIT-v2
    and CLIP-ViT, the prompting with the config's conditioning dropout.
    device defaults to CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``).  attn_impl overrides
    ``training.attn_impl`` (only "dense" trains).  mesh: a ("dp", "fsdp",
    "tp") DeviceMesh to shard Show-o (``mm_projector`` with it) over, as
    JAX ``main`` shards its params; the CLIP tower stays whole.  The
    loaders then take ``shard=data_shard(trainer.model)``."""
    device = entry_device(device)
    cfg = build_showo_config(config)
    if not cfg.w_clip_vit:
        raise ValueError("the CLIP-ViT trainer needs model.showo.w_clip_vit")
    tokenizer = load_tokenizer(config)
    uni = UniversalPrompting(
        tokenizer, max_text_len=config.dataset.preprocessing.max_seq_length,
        cond_dropout_prob=config.training.get("cond_dropout_prob", 0.1))
    model = load_model(config, cfg, device, torch.float32)
    if mesh is not None:
        shard_params(model, mesh)
    return ClipShowoTrainer(
        config=config, model=model.train().requires_grad_(True),
        vq=load_vq(config, device), uni_prompting=uni, attn_impl=attn_impl,
        clip=build_clip_tower(config, device),
        system_prompt_len=system_prompt_len(config, tokenizer),
        mmu_text_len=int(config.dataset.preprocessing.get(
            "max_mmu_text_len", 128)))


def mmu_loader(config, tokenizer, resolution: int, shard=None):
    """A checkpointable loader of ``batch_size_mmu`` LLaVA samples of the
    config's json (``train_mmu_shards_path_or_url``, images under
    ``mmu_image_root``) at the tower's resolution: caption pairs for
    ``llava_pretrain``, else conversations; the records of ``shard``,
    (rank, world) of the data ranks (``data/loader.py::data_shard`` of
    the trainer's model; the process's rank by default)."""
    from showo_tpu_torch.data.llava import LLaVADataset, LLaVAPretrainDataset
    from showo_tpu_torch.data.loader import CheckpointableDataLoader

    p = config.dataset.params
    cls = (LLaVAPretrainDataset
           if config.dataset.get("und_type", "llava_tuning")
           == "llava_pretrain" else LLaVADataset)
    ds = cls(p.train_mmu_shards_path_or_url, p.get("mmu_image_root", ""),
             tokenizer, resolution=resolution, process=shard)
    return CheckpointableDataLoader(lambda: iter(ds),
                                    config.training.batch_size_mmu,
                                    collate_fn=collate_llava)


def main(argv=None) -> ClipShowoTrainer:
    from showo_tpu_torch.config import snapshot_config
    from showo_tpu_torch.training.train_showo import (load_validation_prompts,
                                                      t2i_lm_loaders)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    exp = config.experiment
    mesh, device = load_config_mesh(config)
    trainer = build_trainer(config, device=device, mesh=mesh)
    shard = data_shard(trainer.model)
    mmu = mmu_loader(config, trainer.uni_prompting.text_tokenizer,
                     trainer.clip.cfg.image_size, shard)
    t2i, lm = t2i_lm_loaders(config, shard)
    loaders = {"t2i": t2i, "lm": lm, "mmu": mmu}
    if exp.get("resume_from_checkpoint") == "latest":
        trainer.resume(exp.output_dir, loaders)
    if is_writer():
        snapshot_config(config, exp.output_dir)
    trainer.fit(t2i, lm, mmu, max_steps=config.training.max_train_steps,
                log_every=exp.get("log_every", 50),
                save_every=exp.get("save_every"),
                output_dir=exp.output_dir,
                checkpoints_total_limit=exp.get("checkpoints_total_limit"),
                seed=config.training.get("seed", 0),
                generate_every=exp.get("generate_every"),
                validation_prompts=load_validation_prompts(config))
    return trainer


if __name__ == "__main__":
    main()
