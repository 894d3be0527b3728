"""The LLaVA conversation data of showo_tpu_torch (``data/llava.py``, the
CLIP trainer's ``collate_llava``) against the JAX package, exact.

The tokenizer is the word-hash stand-in with ``<|endoftext|>`` a word of
its own, answering a string with one row and a list with a row each, as a
Hugging Face tokenizer does: the rounds' lengths then add up to the
conversation's, so the per-round masking is what is compared.  With the
plain stand-in (``<|endoftext|>`` glued to the words around it) they do
not, and the mismatch guard voids every label in both packages.
"""

import json

import numpy as np
import pytest

from showo_tpu.data import llava as jllava
from showo_tpu.training.train_showo_clip import collate_llava as j_collate
from showo_tpu_torch.data import llava as tllava
from showo_tpu_torch.training.train_showo_clip import collate_llava
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer


class HFLike:
    eos_token_id = 2

    def __init__(self):
        self._t = FakeTokenizer()

    def _row(self, text):
        return self._t(text.replace(jllava.SEP2, f" {jllava.SEP2} "))[
            "input_ids"][0]

    def __call__(self, texts, **kwargs):
        if isinstance(texts, str):
            return {"input_ids": self._row(texts)}
        return {"input_ids": [self._row(t) for t in texts]}


def _conversation(rounds, first="human"):
    turns = [] if first == "human" else [
        {"from": "gpt", "value": "an opening remark to drop"}]
    for r in range(rounds):
        q = ("<image>\nWhat is in the picture?" if r == 0
             else f"And what colour is thing number {r}?")
        turns += [{"from": "human", "value": q},
                  {"from": "gpt", "value": f"It is answer {r} with words."}]
    return turns


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_constants_match_jax():
    for name in ("IGNORE_INDEX", "DEFAULT_IMAGE_TOKEN", "SYSTEM_PROMPT",
                 "SEP", "SEP2", "ROLES"):
        assert getattr(tllava, name) == getattr(jllava, name), name


@pytest.mark.parametrize("rounds", [1, 2, 3])
@pytest.mark.parametrize("first", ["human", "gpt"])
def test_conversation_vs_jax(rounds, first):
    src = _conversation(rounds, first)
    assert tllava.build_conversation(src) == jllava.build_conversation(src)
    got = tllava.preprocess_conversation(src, HFLike())
    _same(got, jllava.preprocess_conversation(src, HFLike()))
    ids, labels, _ = got
    # a round's targets: its answer (6 words) and eos, and, with a word
    # tokenizer, the 'ASSISTANT:' word that the instruction's "- 1" (for
    # a subword tokenizer's merge of the trailing space) leaves
    assert (labels != -100).sum() == rounds * (1 + 6 + 1)


def test_mismatch_guard_vs_jax():
    """The plain stand-in tokenizes '...words.<|endoftext|>USER:' as one
    word, so the rounds are one token short of the whole each: every
    label is voided."""
    src = _conversation(2)
    got = tllava.preprocess_conversation(src, FakeTokenizer())
    _same(got, jllava.preprocess_conversation(src, FakeTokenizer()))
    assert (got[1] == -100).all()


@pytest.mark.parametrize("max_length", [7, 12, 19])
def test_truncation_vs_jax(max_length):
    src = _conversation(3)
    got = tllava.preprocess_conversation(src, HFLike(), max_length)
    _same(got, jllava.preprocess_conversation(src, HFLike(), max_length))
    assert len(got[0]) == max_length


def test_plain_vs_jax():
    """The pretraining pair with a tokenizer that answers a string with one
    row: the same in both.  The plain stand-in answers with a list of one
    row: JAX's function raises on the ragged ids, the port takes the row
    and gives the same pair."""
    src = [{"from": "human", "value": "<image>\n"},
           {"from": "gpt", "value": "a small dog on the grass"}]
    want = jllava.preprocess_plain(src, HFLike())
    _same(tllava.preprocess_plain(src, HFLike()), want)
    assert (want[1] != -100).all() and want[0][-1] == 2
    with pytest.raises(ValueError):
        jllava.preprocess_plain(src, FakeTokenizer())
    _same(tllava.preprocess_plain(src, FakeTokenizer()), want)


def _llava_json(tmp_path, pretrain):
    """Four records over images of four sizes (1-3 rounds each, or one
    caption pair each for pretraining) and one without an image."""
    from PIL import Image

    recs = []
    for i in range(4):
        Image.new("RGB", (40 + 8 * i, 32), (30 * i, 90, 150)).save(
            tmp_path / f"{i}.png")
        recs.append({"image": f"{i}.png", "conversations": _conversation(
            1 if pretrain else 1 + i % 3)})
    recs.insert(2, {"conversations": _conversation(1)})
    path = tmp_path / "llava.json"
    path.write_text(json.dumps(recs))
    return str(path), str(tmp_path)


@pytest.mark.parametrize("pretrain", [False, True])
def test_datasets_and_collate_vs_jax(tmp_path, pretrain):
    path, root = _llava_json(tmp_path, pretrain)
    cls = "LLaVAPretrainDataset" if pretrain else "LLaVADataset"
    kw = dict(resolution=16, max_length=24)
    got = getattr(tllava, cls)(path, root, HFLike(), **kw)
    want = getattr(jllava, cls)(path, root, HFLike(), **kw)
    assert len(got) == len(want) == 4
    samples = list(got)
    for g, w in zip(samples, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype
    assert samples[0]["image"].shape == (16, 16, 3)
    batch, jbatch = collate_llava(samples[:3]), j_collate(list(want)[:3])
    assert sorted(batch) == sorted(jbatch)
    np.testing.assert_array_equal(batch["image"], jbatch["image"])
    for k in set(batch) - {"image"}:
        for a, b in zip(batch[k], jbatch[k]):
            np.testing.assert_array_equal(a, b)
    assert ("input_ids_system" in batch) is not pretrain
