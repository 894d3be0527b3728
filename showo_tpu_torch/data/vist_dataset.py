"""VIST interleaved storytelling dataset (show-o2/datasets/vist_dataset.py).

Counterpart of ``showo_tpu/data/vist_dataset.py``.  A json list of
records {"images": [...], "sentences": [...]} becomes interleaved
sequences through ``show_o2/formats.py::format_interleaved_sequence``:
one (offset, length) span an image, (0, 0) spans padding up to
``max_num_images``, and zero images in the place of the missing ones.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from showo_tpu_torch.data.loader import process_rank, shard_for_process
from showo_tpu_torch.show_o2.formats import format_interleaved_sequence
from showo_tpu_torch.utils.image import image_transform


class VISTDataset:
    def __init__(self, json_path: str, image_root: str, tokenizer,
                 showo_token_ids: Dict[str, int], resolution: int = 432,
                 num_image_tokens: int = 730, max_seq_len: int = 5120,
                 max_num_images: int = 5,
                 process: Optional[Tuple[int, int]] = None):
        """process: (index, count) of this process's records, every
        count-th (``data/loader.py::process_rank`` by default)."""
        with open(json_path) as f:
            self.records = json.load(f)
        self.image_root = image_root
        self.tokenizer = tokenizer
        self.ids = showo_token_ids
        self.resolution = resolution
        self.num_image_tokens = num_image_tokens
        self.max_seq_len = max_seq_len
        self.max_num_images = max_num_images
        self.process = tuple(process or process_rank())

    def _tok(self, text: str) -> List[int]:
        try:
            ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
        except TypeError:
            ids = self.tokenizer(text)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        return list(ids)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int):
        from PIL import Image

        rec = self.records[idx % len(self.records)]
        sentences = rec["sentences"][: self.max_num_images]
        image_paths = rec["images"][: self.max_num_images]
        tokens, labels, mp, tm, im = format_interleaved_sequence(
            ["img"] * len(image_paths), [self._tok(s) for s in sentences],
            self.ids["bos_id"], self.ids["eos_id"], self.ids["boi_id"],
            self.ids["eoi_id"], self.ids["pad_id"], self.ids["img_pad_id"],
            self.num_image_tokens, self.max_seq_len, self.max_num_images)
        imgs = []
        for p in image_paths:
            img = Image.open(os.path.join(self.image_root, p)).convert("RGB")
            imgs.append(image_transform(img, self.resolution))
        while len(imgs) < self.max_num_images:
            imgs.append(np.zeros_like(imgs[0]))
        return {"text_tokens": tokens, "text_labels": labels,
                "modality_positions": mp, "text_masks": tm,
                "image_masks": im, "images": np.stack(imgs),
                "data_type": "interleaved"}

    def __iter__(self):
        for i in shard_for_process(list(range(len(self))), *self.process):
            yield self[i]
