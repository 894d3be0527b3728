"""UniversalPrompting for the text-to-image path (numpy, host side).

Counterpart of ``showo_tpu/prompting.py``, reduced to what the ported
slice runs: the ``t2i_gen`` layout

    [pad ... pad][t2i][bos] text [eos][soi] image tokens [eoi]

with the text left-padded to ``max_text_len + 1`` (the +1 is the task
token) and cut to ``max_text_len`` with a closing eos when it is longer.
The other tasks (training layouts with labels, lm, mmu, t2v, lvg, i2v)
belong to later slices.

The tokenizer is any object with ``__call__(texts) -> {'input_ids': ...}``,
``bos_token_id`` / ``eos_token_id`` / ``pad_token_id`` and
``convert_tokens_to_ids``; :class:`showo_tpu_torch.utils.fake_tokenizer.
FakeTokenizer` is a deterministic one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SPECIAL_TOKENS = ("<|soi|>", "<|eoi|>", "<|sov|>", "<|eov|>", "<|t2i|>",
                  "<|mmu|>", "<|t2v|>", "<|v2v|>", "<|lvg|>")


class UniversalPrompting:
    def __init__(self, text_tokenizer, special_tokens=SPECIAL_TOKENS,
                 max_text_len: int = 8000):
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

    def _text_block(self, ids: List[int]) -> List[int]:
        """[t2i][bos] ids [eos], left-padded or cut to ``max_text_len``."""
        bos = int(self.text_tokenizer.bos_token_id)
        eos = int(self.text_tokenizer.eos_token_id)
        if not ids or ids[0] != bos:
            ids = [bos] + list(ids)
        ids = [self.sptids["<|t2i|>"]] + ids + [eos]
        if self.max_text_len >= len(ids):
            return [self.pad_id] * (self.max_text_len - len(ids)) + ids
        return ids[:self.max_text_len - 1] + [eos]

    def t2i_gen_prompt(self, text_ids, image_ids) -> Tuple[np.ndarray,
                                                           np.ndarray]:
        """(sequences [B, max_text_len + n_img + 2], text masks of ones)."""
        image_ids = np.asarray(image_ids)
        soi, eoi = self.sptids["<|soi|>"], self.sptids["<|eoi|>"]
        seqs, masks = [], []
        for i in range(len(text_ids)):
            text = self._text_block(list(text_ids[i]))
            seqs.append(np.concatenate([np.asarray(text, np.int64), [soi],
                                        image_ids[i], [eoi]]))
            masks.append(np.ones(len(text), np.int64))
        return np.stack(seqs), np.stack(masks)

    def __call__(self, input: Tuple[Sequence[str], np.ndarray], task: str):
        if task != "t2i_gen":
            raise NotImplementedError(
                f"prompting task {task!r} is not ported yet")
        texts, image_ids = input
        return self.t2i_gen_prompt(
            self.text_tokenizer(list(texts))["input_ids"], image_ids)
