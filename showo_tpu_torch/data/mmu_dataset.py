"""Show-o2 understanding conversations (show-o2/datasets/mmu_dataset.py).

Counterpart of ``showo_tpu/data/mmu_dataset.py``: LLaVA-OneVision-style
records ``{"image": ..., "conversations": [{"from": "human" | "gpt",
"value": ...}, ...]}`` become the stage trainers' fixed-shape samples
(text_tokens / text_labels / text_masks / image_masks [L],
modality_positions [M, 2], images [H, W, 3] in [-1, 1], data_type 'mmu').
Each human turn is wrapped in the Qwen chat template (the system prompt
before the first), an ``<image>`` marker in it becomes [boi][img_pad x
N][eoi] with its span at (position + 1, N), and with ``ignore_question``
the questions are left out of the labels
(format_multi_sequence_und_qwen2_5, :95-156).  The ``pre-training`` stage
takes the turns without the template.  A tokenizer id table without
``img_id`` (the stand-in tokenizer's) marks an image with -1, as JAX does.

One difference from the JAX package: a turn's ``<image>`` marker is put
between every two parts of the text split on it.  JAX's loop puts it only
once some ids came before it, so a turn that opens with ``<image>`` (as
LLaVA's first turns do) loses its image: no span, no image tokens.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from showo_tpu_torch.data.loader import process_rank, shard_for_process
from showo_tpu_torch.utils.image import image_transform

IGNORE_INDEX = -100
DEFAULT_SYSTEM_PROMPT = "system\nYou are a helpful assistant.<|im_end|>"
ROLE_USER = "\n<|im_start|>user\n"
ROLE_ASSISTANT = "\n<|im_start|>assistant\n"


def format_multi_sequence_und_qwen2_5(
    sources: List[List[int]], targets: List[List[int]], *,
    bos_id: int, eos_id: int, boi_id: int, eoi_id: int, pad_id: int,
    img_pad_id: int, img_id: int, num_image_tokens: int, max_seq_len: int,
    system_prompt_ids: Optional[List[int]] = None,
    role_a: Optional[List[int]] = None, role_b: Optional[List[int]] = None,
    ignore_question: bool = True, pretraining: bool = False,
):
    """(tokens, labels, modality_positions, text_masks, image_masks) of one
    conversation of (question ids, answer ids) turns, cut or padded to
    ``max_seq_len``; modality_positions [(0, 0)] when no turn has an
    image."""
    text_tokens: List[int] = []
    text_labels: List[int] = []
    modality_positions: List[Tuple[int, int]] = []

    cur_len = 1  # bos
    for source_ids, target_ids in zip(sources, targets):
        source_ids = list(source_ids)
        if not pretraining:
            source_ids = list(role_a) + source_ids + [eos_id] + list(role_b)
            if cur_len == 1:
                source_ids = list(system_prompt_ids) + source_ids
        if img_id in source_ids:
            i = source_ids.index(img_id)
            source_ids = (source_ids[:i] + [boi_id]
                          + [img_pad_id] * num_image_tokens + [eoi_id]
                          + source_ids[i + 1:])
            modality_positions.append((cur_len + i + 1, num_image_tokens))
        text_tokens.extend(source_ids + list(target_ids))
        if ignore_question:
            text_labels.extend([IGNORE_INDEX] * len(source_ids)
                               + copy.deepcopy(list(target_ids)))
        else:
            text_labels.extend(copy.deepcopy(source_ids + list(target_ids)))
        cur_len = len(text_tokens) + 1

    text_labels = [IGNORE_INDEX] + text_labels
    text_tokens = [bos_id] + text_tokens
    text_labels = (text_labels + [IGNORE_INDEX]
                   * (max_seq_len - len(text_labels)))[:max_seq_len]
    text_tokens = (text_tokens + [pad_id]
                   * (max_seq_len - len(text_tokens)))[:max_seq_len]
    tokens = np.asarray(text_tokens, np.int64)
    labels = np.asarray(text_labels, np.int64)

    mp = np.asarray(modality_positions or [(0, 0)], np.int64)
    tm = ((tokens != img_pad_id) & (tokens != pad_id)).astype(np.int64)
    im = (tokens == img_pad_id).astype(np.int64)
    return tokens, labels, mp, tm, im


class MMUDataset:
    """Conversation JSON records -> understanding samples; ``stage`` names
    starting with ``pre-training`` take the turns without the template.
    ``process``: (index, count) of this process's records, every count-th
    (``data/loader.py::process_rank`` by default)."""

    def __init__(self, json_path: str, image_root: str, tokenizer,
                 showo_token_ids: Dict[str, int], resolution: int = 432,
                 num_image_tokens: int = 730, max_seq_len: int = 1024,
                 stage: str = "tuning",
                 process: Optional[Tuple[int, int]] = None):
        with open(json_path) as f:
            self.records = json.load(f)
        self.image_root = image_root
        self.tokenizer = tokenizer
        self.ids = showo_token_ids
        self.resolution = resolution
        self.num_image_tokens = num_image_tokens
        self.max_seq_len = max_seq_len
        self.pretraining = stage.startswith("pre-training")
        self.process = tuple(process or process_rank())
        self._sys = self._tok(DEFAULT_SYSTEM_PROMPT)[:100]
        self._role_a = self._tok(ROLE_USER)
        self._role_b = self._tok(ROLE_ASSISTANT)

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
        sources, targets = [], []
        img_marker = self.ids.get("img_id", -1)
        for turn in rec["conversations"]:
            out: List[int] = []
            for j, part in enumerate(turn["value"].split("<image>")):
                if j:
                    out.append(img_marker)
                out.extend(self._tok(part))
            (sources if turn["from"] == "human" else targets).append(out)
        n = min(len(sources), len(targets))
        ids = self.ids
        tokens, labels, mp, tm, im = format_multi_sequence_und_qwen2_5(
            sources[:n], targets[:n],
            bos_id=ids["bos_id"], eos_id=ids["eos_id"],
            boi_id=ids["boi_id"], eoi_id=ids["eoi_id"],
            pad_id=ids["pad_id"], img_pad_id=ids["img_pad_id"],
            img_id=img_marker, num_image_tokens=self.num_image_tokens,
            max_seq_len=self.max_seq_len, system_prompt_ids=self._sys,
            role_a=self._role_a, role_b=self._role_b,
            pretraining=self.pretraining)
        out = {"text_tokens": tokens, "text_labels": labels,
               "modality_positions": mp, "text_masks": tm, "image_masks": im,
               "data_type": "mmu"}
        if "image" in rec:
            img = Image.open(os.path.join(self.image_root, rec["image"]))
            out["images"] = image_transform(img.convert("RGB"),
                                            self.resolution)
        return out

    def __iter__(self):
        for i in shard_for_process(list(range(len(self))), *self.process):
            yield self[i]
