"""Deterministic word-level tokenizer for runs without a local tokenizer.

Gives the same ids as ``tools/fake_tokenizer.py`` (md5 of each
whitespace-separated word into [10, 1000); added tokens from 1000 on), so
layouts built by the port and by the JAX package agree.  It offers the
surface :class:`showo_tpu_torch.prompting.UniversalPrompting` uses.
"""

from __future__ import annotations

import hashlib

BASE_VOCAB = 1000  # word ids in [10, 1000)
BOS_ID = 1
EOS_ID = 2


class FakeTokenizer:
    def __init__(self):
        self.bos_token_id = BOS_ID
        self.eos_token_id = EOS_ID
        self.pad_token = None
        self.pad_token_id = None
        self._added: dict = {}

    def _add(self, token: str) -> int:
        if token not in self._added:
            self._added[token] = BASE_VOCAB + len(self._added)
        return self._added[token]

    def add_special_tokens(self, tokens: dict) -> None:
        if "pad_token" in tokens:
            self.pad_token = tokens["pad_token"]
            self.pad_token_id = self._add(self.pad_token)

    def add_tokens(self, tokens) -> None:
        for t in tokens:
            self._add(t)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._added.get(tokens, 0)
        return [self._added.get(t, 0) for t in tokens]

    def _word_id(self, word: str) -> int:
        if word in self._added:
            return self._added[word]
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return 10 + h % (BASE_VOCAB - 10)

    def __call__(self, texts, truncation: bool = False):
        if isinstance(texts, str):
            texts = [texts]
        return {"input_ids": [[self._word_id(w) for w in t.split()]
                              for t in texts]}
