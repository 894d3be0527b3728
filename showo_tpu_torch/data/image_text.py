"""Show-o2 jsonl image-text dataset (show-o2/datasets/image_text_dataset.py).

Counterpart of ``showo_tpu/data/image_text.py``.  jsonl records
{"path": ..., "prompt" | "caption": ...} become fixed-shape samples:
text_tokens / text_labels [L], images [H, W, 3] in [-1, 1],
modality_positions [1, 2], text_masks / image_masks [L], the prompt
(``texts``) and ``data_type`` ('t2i' | 'mmu').  As the reference: records
below ``min_res`` are refused, a bad record passes to the next one (ten
tries), a t2i prompt is dropped with ``cond_dropout_prob``, and
``random_und_or_gen`` flips a sample between generation and
understanding.  Draws come from ``random.Random(seed)``, as JAX's.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Dict, List, Optional, Tuple

from showo_tpu_torch.data.loader import (CheckpointableDataLoader,
                                         shard_for_process)
from showo_tpu_torch.show_o2.formats import (format_sequence_gen_qwen2_5,
                                             format_sequence_und)
from showo_tpu_torch.utils.image import image_transform

logger = logging.getLogger(__name__)


class ImageTextDataset:
    def __init__(self, jsonl_path: str, tokenizer,
                 showo_token_ids: Dict[str, int], image_root: str = "",
                 resolution: int = 432, clip_resolution: int = 384,
                 num_image_tokens: int = 730, max_seq_len: int = 1024,
                 max_text_len: int = 256, cond_dropout_prob: float = 0.1,
                 random_und_or_gen: float = 0.0, min_res: int = 0,
                 seed: int = 0, default_data_type: str = "t2i",
                 with_clip: bool = False, shard: bool = True,
                 process: Optional[Tuple[int, int]] = None):
        self.records: List[dict] = []
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.records.append(json.loads(line))
        if shard:
            # each process reads its own records (DistributedSampler):
            # ``process`` (index, count), ``process_rank`` by default
            self.records = shard_for_process(self.records,
                                             *(process or (None, None)))
        self.image_root = image_root
        self.tokenizer = tokenizer
        self.ids = showo_token_ids
        self.resolution = resolution
        self.clip_resolution = clip_resolution
        self.num_image_tokens = num_image_tokens
        self.max_seq_len = max_seq_len
        self.max_text_len = max_text_len
        self.cond_dropout_prob = cond_dropout_prob
        self.random_und_or_gen = random_und_or_gen
        self.min_res = min_res
        self.rng = random.Random(seed)
        self.default_data_type = default_data_type
        self.with_clip = with_clip

    def __len__(self):
        return len(self.records)

    def _tokenize(self, text: str) -> List[int]:
        ids = self.tokenizer(text)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        return list(ids)[: self.max_text_len]

    def __getitem__(self, idx: int):
        for attempt in range(10):
            rec = self.records[(idx + attempt) % len(self.records)]
            try:
                return self._build(rec)
            except Exception as e:
                logger.warning("bad image-text record %s: %s",
                               rec.get("path"), e)
        raise RuntimeError("too many consecutive bad records")

    def _build(self, rec: dict):
        from PIL import Image

        img = Image.open(os.path.join(self.image_root, rec["path"]))
        if img.mode in ("RGBA", "P", "L"):
            img = img.convert("RGB")
        if min(img.size) < self.min_res:
            raise ValueError(f"below min resolution {img.size}")
        prompt = rec.get("prompt") or rec.get("caption") or ""

        data_type = self.default_data_type
        if self.random_und_or_gen > 0 and \
                self.rng.random() < self.random_und_or_gen:
            data_type = "mmu" if data_type == "t2i" else "t2i"
        text = prompt
        if data_type == "t2i" and self.rng.random() < self.cond_dropout_prob:
            text = ""
        fmt = (format_sequence_gen_qwen2_5 if data_type == "t2i"
               else format_sequence_und)
        ids = self.ids
        tt, tl, mp, tm, im = fmt(
            self._tokenize(text), ids["bos_id"], ids["eos_id"],
            ids["boi_id"], ids["eoi_id"], ids["pad_id"], ids["img_pad_id"],
            self.num_image_tokens, self.max_seq_len)
        out = {"text_tokens": tt, "text_labels": tl,
               "modality_positions": mp, "text_masks": tm,
               "image_masks": im,
               "images": image_transform(img, self.resolution),
               "texts": prompt, "data_type": data_type}
        if self.with_clip:
            out["images_clip"] = image_transform(img, self.clip_resolution)
        return out

    def __iter__(self):
        order = list(range(len(self)))
        self.rng.shuffle(order)
        for i in order:
            yield self[i]


def create_imagetext_dataloader(jsonl_path: str, tokenizer, showo_token_ids,
                                batch_size: int, **kwargs):
    """A :class:`CheckpointableDataLoader` of batch_size samples of an
    :class:`ImageTextDataset` (image_text_dataset.py:187-234)."""
    ds = ImageTextDataset(jsonl_path, tokenizer, showo_token_ids, **kwargs)
    return CheckpointableDataLoader(lambda: iter(ds), batch_size=batch_size)
