"""UniversalPrompting: task-tagged token layouts for the unified model
(numpy, host side).

Counterpart of ``showo_tpu/prompting.py`` (training/prompting_utils.py
:18-464), its quirks included:

* the generation layouts (``t2i``, ``t2i_gen``, ``t2v``, ``t2v_gen``,
  ``lvg``, ``lvg_gen``)

      [pad ... pad][task][bos] text [eos][soi] image tokens [eoi]

  with the text left-padded to ``max_text_len + 1`` (the +1 is the task
  token) and cut to ``max_text_len`` with a closing eos when it is longer;
  ``t2v`` takes the video task token and sov / eov, ``lvg`` the t2i ones
  around a payload that holds the context frames' spans itself; every
  call draws one ``rng`` number a row, and with labels a row below
  ``cond_dropout_prob`` has its text dropped to ``[task][bos][eos]``;
* ``lm`` (right-padded documents with labels), ``mmu`` ([mmu][soi] image
  [eoi] text, right-padded, labels on the text) and ``i2v`` ([v2v][soi]
  image [eoi][sov] video [eov]);
* the training step's text blocks, which the step assembles with the
  image tokens itself: ``t2i_text_block`` (the left-padded block, with
  the same dropout), ``lm_prompt`` and ``mmu_text_block`` (labels with
  pads -> ``ignore_id``).

The tokenizer is any object with ``__call__(texts) -> {'input_ids': ...}``,
``bos_token_id`` / ``eos_token_id`` / ``pad_token_id`` and
``convert_tokens_to_ids``; :class:`showo_tpu_torch.utils.fake_tokenizer.
FakeTokenizer` is a deterministic one.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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

    def _gen_family(self, text_ids, image_ids, labels, soi: int, eoi: int,
                    task: int, with_labels: bool):
        """The generation layouts: [pad..][task][bos] text [eos][soi]
        image [eoi].  One ``rng`` draw a row whatever the task (as JAX);
        with labels a row's text is dropped below ``cond_dropout_prob``,
        its labels are the sequence with ``labels`` for the image and pads
        -> ``ignore_id``, and its mask covers text + image + 3 positions
        (the reference's length quirk); without, the mask covers the
        text."""
        image_ids = np.asarray(image_ids)
        n_img = image_ids.shape[1]
        probs = self.rng.random(len(text_ids))
        seqs, masks, labs = [], [], []
        for i in range(len(text_ids)):
            drop = with_labels and probs[i] < self.cond_dropout_prob
            text = np.asarray(self._pad_left(self._gen_text(
                list(text_ids[i]), task, drop)), np.int64)
            seqs.append(np.concatenate([text, [soi], image_ids[i], [eoi]]))
            masks.append(np.ones(len(text) + n_img + 3 if with_labels
                                 else len(text), np.int64))
            if with_labels:
                lab = np.concatenate([text, [soi], np.asarray(
                    labels[i], np.int64), [eoi]])
                labs.append(np.where(lab == self.pad_id, self.ignore_id,
                                     lab))
        if with_labels:
            return np.stack(seqs), np.stack(masks), np.stack(labs)
        return np.stack(seqs), np.stack(masks)

    def _tokens(self, *names):
        return [self.sptids[n] for n in names]

    def t2i_prompt(self, text_ids, image_ids, labels):
        """(sequences, masks, labels) of the t2i layout with labels."""
        return self._gen_family(text_ids, image_ids, labels,
                                *self._tokens("<|soi|>", "<|eoi|>",
                                              "<|t2i|>"), True)

    def t2i_gen_prompt(self, text_ids, image_ids) -> Tuple[np.ndarray,
                                                           np.ndarray]:
        """(sequences [B, max_text_len + n_img + 2], text masks of ones)."""
        return self._gen_family(text_ids, image_ids, None,
                                *self._tokens("<|soi|>", "<|eoi|>",
                                              "<|t2i|>"), False)

    def t2v_prompt(self, text_ids, image_ids, labels):
        """The t2i layout under the video task token and sov / eov."""
        return self._gen_family(text_ids, image_ids, labels,
                                *self._tokens("<|sov|>", "<|eov|>",
                                              "<|t2v|>"), True)

    def t2v_gen_prompt(self, text_ids, image_ids):
        return self._gen_family(text_ids, image_ids, None,
                                *self._tokens("<|sov|>", "<|eov|>",
                                              "<|t2v|>"), False)

    # lvg uses the t2i task token and markers (prompting_utils.py:324)
    lvg_prompt = t2i_prompt
    lvg_gen_prompt = t2i_gen_prompt

    def i2v_prompt(self, image_ids, video_ids, labels=None):
        """[v2v][soi] image [eoi][sov] video [eov] (the JAX package's
        completion of the reference's empty ``i2v_prompt`` stub); labels,
        when given, ignore the conditioning prefix and cover the video and
        eov."""
        image_ids, video_ids = np.asarray(image_ids), np.asarray(video_ids)
        n_img = image_ids.shape[1]
        v2v, soi, eoi, sov, eov = self._tokens(
            "<|v2v|>", "<|soi|>", "<|eoi|>", "<|sov|>", "<|eov|>")
        seqs, masks, labs = [], [], []
        for i in range(image_ids.shape[0]):
            seq = np.concatenate([[v2v, soi], image_ids[i], [eoi, sov],
                                  video_ids[i], [eov]])
            seqs.append(seq)
            masks.append(np.ones(len(seq), np.int64))
            if labels is not None:
                labs.append(np.concatenate([
                    np.full(n_img + 4, self.ignore_id, np.int64),
                    np.asarray(labels[i], np.int64), [eov]]))
        if labels is not None:
            return np.stack(seqs), np.stack(masks), np.stack(labs)
        return np.stack(seqs), np.stack(masks)

    def mmu_prompt(self, image_ids, text_ids):
        """(sequences, masks, labels): [mmu][soi] image [eoi][bos] text
        [eos] right-padded to ``max_text_len - 1`` text positions (or cut
        with a closing eos); labels ignore everything before the text and
        the pads."""
        image_ids = np.asarray(image_ids)
        n_img = image_ids.shape[-1]
        soi, eoi, mmu = self._tokens("<|soi|>", "<|eoi|>", "<|mmu|>")
        blocks, _ = self._text_blocks(text_ids)
        seqs, labs = [], []
        for i, ids in enumerate(blocks):
            lab = np.concatenate([np.full(n_img + 3, self.ignore_id,
                                          np.int64), ids])
            labs.append(np.where(lab == self.pad_id, self.ignore_id, lab))
            seqs.append(np.concatenate([[mmu, soi], image_ids[i], [eoi],
                                        ids]))
        masks = np.ones((len(blocks), blocks.shape[1] + n_img + 3), np.int64)
        return np.stack(seqs), masks, np.stack(labs)

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

    def _text_blocks(self, text_ids):
        """[bos] ids [eos] right-padded to ``max_text_len - 1``, or cut
        with a closing eos; and the blocks with pads -> ``ignore_id``."""
        eos = int(self.text_tokenizer.eos_token_id)
        max_text_len = self.max_text_len - 1
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

    def mmu_text_block(self, texts):
        """(blocks, labels) [B, max_text_len - 1] of :meth:`_text_blocks`;
        the step prepends [mmu][soi] image [eoi]."""
        return self._text_blocks(self.text_tokenizer(list(texts))["input_ids"])

    def __call__(self, input: Tuple, task: str,
                 max_lm_seq_len: Optional[int] = None,
                 t2i_batch_size: Optional[int] = None):
        """The reference's task dispatch (prompting_utils.py:437-464): the
        texts of ``input`` tokenized, then the task's layout; an unknown
        task raises NotImplementedError."""
        tok = self.text_tokenizer
        if task == "t2i_plus_lm":
            text_ids = tok(input[0])["input_ids"]
            return (self.t2i_prompt(text_ids[:t2i_batch_size], input[1],
                                    input[2]),
                    self.lm_prompt(text_ids[t2i_batch_size:], input[3]))
        if task == "lm":
            return self.lm_prompt(tok(input[0], truncation=True)["input_ids"],
                                  input[1])
        if task == "mmu":
            return self.mmu_prompt(input[0], tok(input[1])["input_ids"])
        if task == "i2v":
            return self.i2v_prompt(input[0], input[1],
                                   input[2] if len(input) > 2 else None)
        labelled = {"t2i": self.t2i_prompt, "t2v": self.t2v_prompt,
                    "lvg": self.lvg_prompt}
        gen = {"t2i_gen": self.t2i_gen_prompt, "t2v_gen": self.t2v_gen_prompt,
               "lvg_gen": self.lvg_gen_prompt}
        if task in labelled:
            return labelled[task](tok(input[0])["input_ids"], input[1],
                                  input[2])
        if task in gen:
            return gen[task](tok(input[0])["input_ids"], input[1])
        raise NotImplementedError(task)
