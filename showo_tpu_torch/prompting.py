"""UniversalPrompting for the text-to-image, long-video and stage-1
training paths (numpy, host side).

Counterpart of ``showo_tpu/prompting.py``, reduced to what the ported
slices run:

* the ``t2i_gen`` layout

      [pad ... pad][t2i][bos] text [eos][soi] image tokens [eoi]

  with the text left-padded to ``max_text_len + 1`` (the +1 is the task
  token) and cut to ``max_text_len`` with a closing eos when it is longer;
  ``lvg_gen`` is the same layout (the t2i task token, one outer soi / eoi)
  around a payload that holds the context frames' spans itself;
* the training step's text blocks, which the step assembles with the
  image tokens itself: ``t2i_text_block`` (that left-padded block, with
  conditioning dropout drawn from the numpy ``rng``: a dropped row's text
  becomes ``[t2i][bos][eos]``), ``lm_prompt`` (right-padded documents
  with labels) and ``mmu_text_block`` (right-padded caption blocks with
  labels, pads -> ``ignore_id``).

The tasks with labels (``t2i``, ``mmu``, ``t2v``, ``t2v_gen``, ``i2v``,
``lvg``) are training's and wait for its slice.

The tokenizer is any object with ``__call__(texts) -> {'input_ids': ...}``,
``bos_token_id`` / ``eos_token_id`` / ``pad_token_id`` and
``convert_tokens_to_ids``; :class:`showo_tpu_torch.utils.fake_tokenizer.
FakeTokenizer` is a deterministic one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

SPECIAL_TOKENS = ("<|soi|>", "<|eoi|>", "<|sov|>", "<|eov|>", "<|t2i|>",
                  "<|mmu|>", "<|t2v|>", "<|v2v|>", "<|lvg|>")


class UniversalPrompting:
    def __init__(self, text_tokenizer, special_tokens=SPECIAL_TOKENS,
                 max_text_len: int = 8000, ignore_id: int = -100,
                 cond_dropout_prob: float = 0.1,
                 rng: Optional[np.random.Generator] = None):
        self.text_tokenizer = text_tokenizer
        if getattr(text_tokenizer, "pad_token", None) is None:
            try:
                text_tokenizer.add_special_tokens({"pad_token": "[PAD]"})
            except AttributeError:
                pass
        try:
            text_tokenizer.add_tokens(list(special_tokens))
        except AttributeError:
            pass
        self.sptids = {t: int(text_tokenizer.convert_tokens_to_ids([t])[0])
                       for t in special_tokens}
        self.sptids["<|sot|>"] = int(text_tokenizer.bos_token_id)
        self.sptids["<|eot|>"] = int(text_tokenizer.eos_token_id)
        self.sptids["<|pad|>"] = int(text_tokenizer.pad_token_id)
        self.max_text_len = max_text_len + 1   # + the task token
        self.pad_id = int(text_tokenizer.pad_token_id)
        self.ignore_id = ignore_id
        self.cond_dropout_prob = cond_dropout_prob
        self.rng = rng or np.random.default_rng(0)

    def _with_bos(self, ids: List[int]) -> List[int]:
        bos = int(self.text_tokenizer.bos_token_id)
        if not ids or ids[0] != bos:
            return [bos] + list(ids)
        return list(ids)

    def _gen_text(self, ids: List[int], task_token: int,
                  dropout: bool) -> List[int]:
        """[task][bos] ids [eos]; with dropout [task][bos][eos]."""
        eos = int(self.text_tokenizer.eos_token_id)
        if dropout:
            return [task_token, int(self.text_tokenizer.bos_token_id), eos]
        return [task_token] + self._with_bos(ids) + [eos]

    def _pad_left(self, ids: List[int]) -> List[int]:
        """Left-padded, or cut, to ``max_text_len`` with a closing eos."""
        if self.max_text_len >= len(ids):
            return [self.pad_id] * (self.max_text_len - len(ids)) + ids
        eos = int(self.text_tokenizer.eos_token_id)
        return ids[:self.max_text_len - 1] + [eos]

    def t2i_gen_prompt(self, text_ids, image_ids) -> Tuple[np.ndarray,
                                                           np.ndarray]:
        """(sequences [B, max_text_len + n_img + 2], text masks of ones)."""
        image_ids = np.asarray(image_ids)
        soi, eoi = self.sptids["<|soi|>"], self.sptids["<|eoi|>"]
        seqs, masks = [], []
        for i in range(len(text_ids)):
            text = self._pad_left(self._gen_text(
                list(text_ids[i]), self.sptids["<|t2i|>"], False))
            seqs.append(np.concatenate([np.asarray(text, np.int64), [soi],
                                        image_ids[i], [eoi]]))
            masks.append(np.ones(len(text), np.int64))
        return np.stack(seqs), np.stack(masks)

    # lvg uses the t2i task token and markers (prompting_utils.py:324)
    lvg_gen_prompt = t2i_gen_prompt

    def t2i_text_block(self, texts, dropout: bool = True) -> np.ndarray:
        """Left-padded text blocks [B, max_text_len] of the t2i layout; the
        training step appends [soi] image [eoi].  Each row's text is
        dropped with probability ``cond_dropout_prob`` (one ``rng`` draw per
        row)."""
        text_ids = self.text_tokenizer(list(texts))["input_ids"]
        probs = (self.rng.random(len(text_ids)) if dropout
                 else np.ones(len(text_ids)))
        return np.asarray([
            self._pad_left(self._gen_text(list(ids), self.sptids["<|t2i|>"],
                                          probs[i] < self.cond_dropout_prob))
            for i, ids in enumerate(text_ids)], np.int64)

    def lm_prompt(self, text_ids, max_seq_len: int):
        """(ids, masks, labels) [B, max_seq_len]: [bos] text [eos]
        right-padded with pad (labels: ``ignore_id``), or cut."""
        eos = int(self.text_tokenizer.eos_token_id)
        seqs, labs = [], []
        for ids in text_ids:
            ids = self._with_bos(list(ids)) + [eos]
            fill = max(0, max_seq_len - len(ids))
            seqs.append(ids[:max_seq_len] + [self.pad_id] * fill)
            labs.append(ids[:max_seq_len] + [self.ignore_id] * fill)
        seqs = np.asarray(seqs, np.int64)
        return seqs, np.ones_like(seqs), np.asarray(labs, np.int64)

    def mmu_text_block(self, texts):
        """(blocks, labels) [B, max_text_len - 1]: [bos] text [eos]
        right-padded, or cut with a closing eos; labels are the block with
        pads -> ``ignore_id``.  The step prepends [mmu][soi] image [eoi]."""
        eos = int(self.text_tokenizer.eos_token_id)
        max_text_len = self.max_text_len - 1
        text_ids = self.text_tokenizer(list(texts))["input_ids"]
        blocks = []
        for ids in text_ids:
            ids = self._with_bos(list(ids)) + [eos]
            if max_text_len >= len(ids):
                ids = ids + [self.pad_id] * (max_text_len - len(ids))
            else:
                ids = ids[:max_text_len - 1] + [eos]
            blocks.append(ids)
        blocks = np.asarray(blocks, np.int64)
        return blocks, np.where(blocks == self.pad_id, self.ignore_id, blocks)

    def __call__(self, input: Tuple[Sequence[str], np.ndarray], task: str):
        """``t2i_gen`` or ``lvg_gen`` of (texts, image token payload)."""
        if task not in ("t2i_gen", "lvg_gen"):
            raise NotImplementedError(
                f"prompting task {task!r} is not ported yet")
        texts, image_ids = input
        prompt = (self.t2i_gen_prompt if task == "t2i_gen"
                  else self.lvg_gen_prompt)
        return prompt(self.text_tokenizer(list(texts))["input_ids"],
                      image_ids)
