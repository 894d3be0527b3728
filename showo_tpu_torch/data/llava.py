"""LLaVA conversation data for the v1 CLIP-ViT trainer
(llava/llava_data_vq_unified.py, llava/llava_pretrain_data.py).

Counterpart of ``showo_tpu/data/llava.py``, with its own copies of the
prompt strings.  Instruction data takes the Phi-1.5 conversation template
("USER: ... ASSISTANT: ...", separator two-style with sep2 the
end-of-text marker) and masks each round's instruction span in the labels
(preprocess_v0, :37-124); a tokenization mismatch voids the whole target.
Pretraining data (CC3M-style captions) takes the plain template: an empty
prompt and the caption as the target.  The tokenizer is called in batch
form (``tokenizer([text])["input_ids"][0]``) as the reference calls it.

One difference from the JAX package: :func:`preprocess_plain` calls the
tokenizer on one string, and a tokenizer that answers a string with one
row of ids (the word-hash stand-in of ``utils/fake_tokenizer.py``) has
that row taken, as ``MMUDataset`` does; JAX's function builds a ragged
array from such an answer and raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from showo_tpu_torch.data.loader import process_rank, shard_for_process
from showo_tpu_torch.utils.image import image_transform

IGNORE_INDEX = -100
DEFAULT_IMAGE_TOKEN = "<image>"
SYSTEM_PROMPT = ("A chat between a curious user and an artificial "
                 "intelligence assistant. The assistant gives helpful, "
                 "detailed, and polite answers to the user's questions.")
SEP = " "
SEP2 = "<|endoftext|>"
ROLES = ("USER", "ASSISTANT")


def build_conversation(source: List[Dict[str, str]]) -> str:
    """Phi-1.5 two-style prompt: 'USER: x ASSISTANT: y<|endoftext|>...'
    (a leading turn that is not the user's is dropped)."""
    role_map = {"human": ROLES[0], "gpt": ROLES[1]}
    if role_map.get(source[0]["from"]) != ROLES[0]:
        source = source[1:]
    parts = []
    for sentence in source:
        role = role_map[sentence["from"]]
        value = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
        parts.append(f"{role}: {value}{SEP if role == ROLES[0] else SEP2}")
    return "".join(parts).strip()


def _ids(tokenizer, text: str) -> List[int]:
    return list(tokenizer([text])["input_ids"][0])


def preprocess_conversation(source: List[Dict[str, str]], tokenizer,
                            max_length: int = 2048):
    """(input_ids, labels, input_ids_system) int64 arrays.  Per round
    (split on sep2) the instruction through ' ASSISTANT: ' is ignored in
    the labels; when the rounds' lengths do not add up to the tokenized
    conversation's (a tokenizer round-trip mismatch) every label is."""
    conversation = build_conversation(source)
    ids = _ids(tokenizer, conversation)[:max_length]
    target = np.asarray(ids, np.int64).copy()

    sep = SEP + ROLES[1] + ": "
    cur_len = 0
    for rou in conversation.split(SEP2):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        round_len = len(_ids(tokenizer, rou)) + 1             # + eos
        instruction_len = len(_ids(tokenizer, parts[0] + sep)) - 1
        target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    target[cur_len:] = IGNORE_INDEX
    if cur_len < max_length and cur_len != len(ids):
        target[:] = IGNORE_INDEX

    sys_ids = np.asarray(_ids(tokenizer, SYSTEM_PROMPT), np.int64)
    return np.asarray(ids, np.int64), target, sys_ids


def _flat(ids) -> List[int]:
    """A tokenizer's answer to one string: its ids, or its one row."""
    ids = list(ids)
    return list(ids[0]) if ids and isinstance(ids[0], list) else ids


def preprocess_plain(source: List[Dict[str, str]], tokenizer,
                     eos_id: Optional[int] = None, sep: str = "\n"):
    """(input_ids, labels) int64 arrays of a pretraining caption pair under
    the plain template (llava_pretrain_data.py:32-55): the human turn is
    emptied, caption + sep + eos is the target, the (empty) prompt's
    tokens are ignored."""
    assert len(source) == 2
    caption = source[1]["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
    if eos_id is None:
        eos_id = getattr(tokenizer, "eos_token_id", 0)
    ids = _flat(tokenizer("" + caption + sep)["input_ids"]) + [eos_id]
    labels = list(ids)
    prompt_len = len(_flat(tokenizer("")["input_ids"]))
    for i in range(min(prompt_len, len(labels))):
        labels[i] = IGNORE_INDEX
    return np.asarray(ids, np.int64), np.asarray(labels, np.int64)


class LLaVADataset:
    """Conversation JSON + image folder -> instruction samples ``{image,
    input_ids, labels, input_ids_system}``; records without an image are
    dropped.  ``process``: (index, count) of this process's records, every
    count-th (``data/loader.py::process_rank`` by default)."""

    def __init__(self, json_path: str, image_root: str, tokenizer,
                 resolution: int = 256, max_length: int = 2048,
                 process: Optional[Tuple[int, int]] = None):
        with open(json_path) as f:
            self.records = [r for r in json.load(f) if "image" in r]
        self.image_root = image_root
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.max_length = max_length
        self.process = tuple(process or process_rank())

    def __len__(self):
        return len(self.records)

    def _image(self, rec) -> np.ndarray:
        from PIL import Image

        img = Image.open(os.path.join(self.image_root, rec["image"]))
        return image_transform(img.convert("RGB"), self.resolution)

    def __getitem__(self, idx: int):
        rec = self.records[idx % len(self.records)]
        ids, labels, sys_ids = preprocess_conversation(
            rec["conversations"], self.tokenizer, self.max_length)
        return {"image": self._image(rec), "input_ids": ids,
                "labels": labels, "input_ids_system": sys_ids}

    def __iter__(self):
        for i in shard_for_process(list(range(len(self))), *self.process):
            yield self[i]


class LLaVAPretrainDataset(LLaVADataset):
    """CC3M-style caption pretraining set (llava_pretrain_data.py): the
    instruction json layout, every record one (empty prompt, caption)
    pair under the plain template."""

    def __getitem__(self, idx: int):
        rec = self.records[idx % len(self.records)]
        ids, labels = preprocess_plain(rec["conversations"], self.tokenizer)
        return {"image": self._image(rec), "input_ids": ids[:self.max_length],
                "labels": labels[:self.max_length]}
