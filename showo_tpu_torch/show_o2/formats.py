"""Show-o2 sequence formats (host-side, numpy).

The port's copy of ``showo_tpu/show_o2/formats.py``, held to it by
``tests/test_torch_host.py``.  Parity with show-o2/datasets/utils.py:52-156
(format_sequence_gen_qwen2_5 / format_sequence_und /
format_interleaved_sequence) and show-o2/models/misc.py:24-97
(prepare_gen_input / mixed-modal variant).

All functions return fixed-shape numpy buffers:
  text_tokens, text_labels [L]; modality_positions [M, 2];
  text_mask, image_mask [L].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _masks(text_tokens: np.ndarray, img_pad_id: int, pad_id: int):
    text_mask = ((text_tokens != img_pad_id) & (text_tokens != pad_id)).astype(np.int64)
    image_mask = (text_tokens == img_pad_id).astype(np.int64)
    return text_mask, image_mask


def format_sequence_gen_qwen2_5(text_tokens: Sequence[int], bos_id, eos_id,
                                boi_id, eoi_id, pad_id, img_pad_id,
                                num_image_tokens: int, max_seq_len: int):
    """T2I training layout: labels all -100 (T2I trains only the flow
    head, datasets/utils.py:52-79)."""
    n = len(text_tokens)
    modality_positions = np.array([[n + 1 + 1, num_image_tokens]], np.int64)
    labels = [-100] * (1 + n + 1 + num_image_tokens + 1 + 1)
    tokens = ([bos_id] + list(text_tokens) + [boi_id]
              + [img_pad_id] * num_image_tokens + [eoi_id] + [eos_id])
    labels = labels + [-100] * (max_seq_len - len(labels))
    tokens = tokens + [pad_id] * (max_seq_len - len(tokens))
    tokens = np.asarray(tokens, np.int64)
    labels = np.asarray(labels, np.int64)
    tm, im = _masks(tokens, img_pad_id, pad_id)
    return tokens, labels, modality_positions, tm, im


def format_sequence_und(text_tokens: Sequence[int], bos_id, eos_id, boi_id,
                        eoi_id, pad_id, img_pad_id, num_image_tokens: int,
                        max_seq_len: int):
    """Understanding layout: image prefix, labels over text
    (datasets/utils.py:81-101)."""
    modality_positions = np.array([[1 + 1, num_image_tokens]], np.int64)
    labels = ([bos_id, boi_id] + [-100] * num_image_tokens + [eoi_id]
              + list(text_tokens) + [eos_id])
    tokens = ([bos_id, boi_id] + [img_pad_id] * num_image_tokens + [eoi_id]
              + list(text_tokens) + [eos_id])
    labels = labels + [-100] * (max_seq_len - len(labels))
    tokens = tokens + [pad_id] * (max_seq_len - len(tokens))
    tokens = np.asarray(tokens, np.int64)
    labels = np.asarray(labels, np.int64)
    tm, im = _masks(tokens, img_pad_id, pad_id)
    return tokens, labels, modality_positions, tm, im


def format_interleaved_sequence(image_list: Sequence, text_token_list: Sequence,
                                bos_id, eos_id, boi_id, eoi_id, pad_id,
                                img_pad_id, num_image_tokens: int,
                                max_seq_len: int, max_num_images: int):
    """Interleaved multi-image layout with (0,0)-padded modality tuples
    (datasets/utils.py:104-156)."""
    tokens: List[int] = []
    labels: List[int] = []
    modality_positions: List[Tuple[int, int]] = []
    cur_len = 1
    for txt, image in zip(text_token_list, image_list):
        if txt is not None:
            tokens.extend(txt)
            labels.extend(list(txt))
            cur_len += len(txt)
        if image is not None:
            tokens.extend([boi_id] + [img_pad_id] * num_image_tokens + [eoi_id])
            labels.extend([boi_id] + [img_pad_id] * num_image_tokens + [eoi_id])
            modality_positions.append((cur_len + 1, num_image_tokens))
            cur_len += 1 + num_image_tokens + 1
    labels = [bos_id] + labels + [eos_id]
    tokens = [bos_id] + tokens + [eos_id]
    labels = labels + [-100] * (max_seq_len - len(labels))
    tokens = tokens + [pad_id] * (max_seq_len - len(tokens))
    tokens = np.asarray(tokens, np.int64)
    labels = np.asarray(labels, np.int64)
    while len(modality_positions) < max_num_images:
        modality_positions.append((0, 0))
    mp = np.asarray(modality_positions, np.int64)
    tm, im = _masks(tokens, img_pad_id, pad_id)
    return tokens, labels, mp, tm, im


def prepare_gen_input(prompts: Sequence[str], text_tokenizer,
                      num_image_tokens: int, bos_id, eos_id, boi_id, eoi_id,
                      pad_id, img_pad_id, max_text_len: int):
    """Inference T2I input + paired null prompts for CFG
    (show-o2/models/misc.py:24-54).  Returns (tokens, null_tokens,
    modality_positions, null_modality_positions) as numpy arrays."""
    toks, mps, toks_null, mps_null = [], [], [], []
    for prompt in prompts:
        ids = text_tokenizer(prompt, add_special_tokens=False)["input_ids"][:max_text_len]
        if ids and isinstance(ids[0], list):  # batch-tokenizer output
            ids = ids[0]
        mp = np.array([[len(ids) + 1 + 1, num_image_tokens]], np.int64)
        seq = ([bos_id] + list(ids) + [boi_id] + [img_pad_id] * num_image_tokens
               + [eoi_id] + [eos_id] + [pad_id] * (max_text_len - len(ids)))
        toks.append(seq)
        mps.append(mp)

        mp_null = np.array([[0 + 1 + 1, num_image_tokens]], np.int64)
        seq_null = ([bos_id] + [boi_id] + [img_pad_id] * num_image_tokens
                    + [eoi_id] + [eos_id] + [pad_id] * max_text_len)
        toks_null.append(seq_null)
        mps_null.append(mp_null)
    return (np.asarray(toks, np.int64), np.asarray(toks_null, np.int64),
            np.stack(mps), np.stack(mps_null))


def prepare_mixed_modal_gen_input(prompts: Sequence[str], nulls: Sequence[str],
                                  text_tokenizer, num_image_tokens: int,
                                  bos_id, boi_id, eoi_id, pad_id, img_pad_id):
    """Mixed-modal generation input padded to a multiple of 128
    (show-o2/models/misc.py:57-97)."""
    toks, mps, toks_null, mps_null = [], [], [], []
    for prompt, null in zip(prompts, nulls):
        ids = text_tokenizer(prompt, add_special_tokens=False)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        mp = np.array([[len(ids) + 1 + 1, num_image_tokens]], np.int64)
        seq = [bos_id] + list(ids) + [boi_id] + [img_pad_id] * num_image_tokens + [eoi_id]

        ids_n = text_tokenizer(null, add_special_tokens=False)["input_ids"]
        if ids_n and isinstance(ids_n[0], list):
            ids_n = ids_n[0]
        mp_n = np.array([[len(ids_n) + 1 + 1, num_image_tokens]], np.int64)
        seq_n = [bos_id] + list(ids_n) + [boi_id] + [img_pad_id] * num_image_tokens + [eoi_id]

        max_len = max(len(seq), len(seq_n))
        if max_len % 128 != 0:
            max_len = (max_len // 128 + 1) * 128
        seq += [pad_id] * (max_len - len(seq))
        seq_n += [pad_id] * (max_len - len(seq_n))
        toks.append(seq)
        mps.append(mp)
        toks_null.append(seq_n)
        mps_null.append(mp_n)
    return (np.asarray(toks, np.int64), np.asarray(toks_null, np.int64),
            np.stack(mps), np.stack(mps_null))
