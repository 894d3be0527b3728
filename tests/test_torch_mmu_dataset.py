"""The Show-o2 understanding conversations of showo_tpu_torch
(``data/mmu_dataset.py``) against the JAX package, exact: the format
function over tuning and pretraining, with and without the questions in
the labels, with no image, an image in a later turn and truncation at
``max_seq_len``, and against tests/test_mmu_dataset.py's golden; then
``MMUDataset`` on a json in a temporary directory.

One deliberate difference: a turn that opens with ``<image>`` keeps its
image in the port and loses it in JAX (its splice loop adds the marker
only after some ids), so the records whose images open a turn are held to
that, and the rest to JAX's samples.
"""

import json
import os

import numpy as np
import pytest

from showo_tpu.data import mmu_dataset as jmmu
from showo_tpu_torch.data import mmu_dataset as tmmu
from showo_tpu_torch.inference_t2i_v2 import FAKE_TOKEN_IDS, FakeQwenTokenizer

from test_mmu_dataset import GOLDEN, Tok

IDS = dict(bos_id=1, eos_id=2, boi_id=3, eoi_id=4, pad_id=5, img_pad_id=6,
           img_id=7)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_constants_match_jax():
    assert tmmu.IGNORE_INDEX == jmmu.IGNORE_INDEX
    assert tmmu.DEFAULT_SYSTEM_PROMPT == jmmu.DEFAULT_SYSTEM_PROMPT


def _turns(image_turn, rounds=3):
    """(sources, targets) of ``rounds`` turns, the image marker (7) in
    turn ``image_turn`` (None: none)."""
    rng = np.random.default_rng(rounds)
    sources, targets = [], []
    for r in range(rounds):
        q = list(rng.integers(10, 900, size=3 + r))
        if r == image_turn:
            q = q[:1] + [7] + q[1:]
        sources.append(q)
        targets.append(list(rng.integers(10, 900, size=2 + r)))
    return sources, targets


@pytest.mark.parametrize("image_turn", [0, 2, None])
@pytest.mark.parametrize("pretraining", [False, True])
@pytest.mark.parametrize("ignore_question", [True, False])
@pytest.mark.parametrize("max_seq_len", [24, 64])
def test_format_vs_jax(image_turn, pretraining, ignore_question,
                       max_seq_len):
    sources, targets = _turns(image_turn)
    kw = dict(IDS, num_image_tokens=5, max_seq_len=max_seq_len,
              system_prompt_ids=[11, 12, 13], role_a=[21, 22],
              role_b=[23, 24], ignore_question=ignore_question,
              pretraining=pretraining)
    got = tmmu.format_multi_sequence_und_qwen2_5(sources, targets, **kw)
    _same(got, jmmu.format_multi_sequence_und_qwen2_5(sources, targets, **kw))
    tokens, _, mp, _, im = got
    assert tokens.shape == (max_seq_len,)
    if image_turn is None:
        assert mp.tolist() == [[0, 0]] and im.sum() == 0


def test_format_matches_golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("run tools/make_golden_mmu_dataset.py")
    golden = np.load(GOLDEN)
    tok = Tok()
    sources = [golden["sources_0"].tolist(), golden["sources_1"].tolist()]
    targets = [golden["targets_0"].tolist(), golden["targets_1"].tolist()]
    got = tmmu.format_multi_sequence_und_qwen2_5(
        sources, targets, **IDS, num_image_tokens=5, max_seq_len=64,
        system_prompt_ids=tok(tmmu.DEFAULT_SYSTEM_PROMPT,
                              max_length=100)["input_ids"],
        role_a=tok(tmmu.ROLE_USER)["input_ids"],
        role_b=tok(tmmu.ROLE_ASSISTANT)["input_ids"])
    for g, name in zip(got, ("tokens", "labels", "mp", "tm", "im")):
        np.testing.assert_array_equal(g, golden[name], err_msg=name)


def _records(tmp_path):
    from PIL import Image

    Image.new("RGB", (40, 28), (20, 140, 60)).save(tmp_path / "a.png")
    mid = [{"from": "human", "value": "Look at this <image> now. What?"},
           {"from": "gpt", "value": "A green field."},
           {"from": "human", "value": "Any animals?"},
           {"from": "gpt", "value": "No animals at all."}]
    later = [{"from": "human", "value": "Hello there."},
             {"from": "gpt", "value": "Hi."},
             {"from": "human", "value": "Then see <image> please."},
             {"from": "gpt", "value": "A field it is."}]
    leading = [{"from": "human", "value": "<image>\nDescribe the image."},
               {"from": "gpt", "value": "A green rectangle."}]
    text_only = [{"from": "human", "value": "Say hi."},
                 {"from": "gpt", "value": "Hi."}]
    recs = [{"image": "a.png", "conversations": mid},
            {"image": "a.png", "conversations": later},
            {"image": "a.png", "conversations": leading},
            {"conversations": text_only}]
    path = tmp_path / "mmu.json"
    path.write_text(json.dumps(recs))
    return str(path)


@pytest.mark.parametrize("stage", ["tuning", "pre-training"])
@pytest.mark.parametrize("ids", ["fake", "with_img_id"])
def test_dataset_vs_jax(tmp_path, stage, ids):
    """``MMUDataset`` on four records (an image mid-turn, in a later turn,
    opening a turn; none) with the stand-in tokenizer, whose id table has
    no ``img_id`` (the marker is -1, as in JAX), and with one that has
    one."""
    path = _records(tmp_path)
    table = dict(FAKE_TOKEN_IDS, **({"img_id": 7} if ids != "fake" else {}))
    kw = dict(resolution=16, num_image_tokens=9, max_seq_len=96, stage=stage)
    got = tmmu.MMUDataset(path, str(tmp_path), FakeQwenTokenizer(), table,
                          **kw)
    want = jmmu.MMUDataset(path, str(tmp_path), FakeQwenTokenizer(), table,
                           **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        assert ("images" in g) == (i < 3)
        if i == 2:
            # the opening marker: the port's image span, JAX's none
            assert w["modality_positions"].tolist() == [[0, 0]]
            start, n = g["modality_positions"][0]
            assert n == 9 and (g["image_masks"][start:start + n] == 1).all()
            assert g["image_masks"].sum() == 9
            continue
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        if i in (0, 1):
            assert g["modality_positions"][0, 1] == 9
    assert got[0]["images"].shape == (16, 16, 3)
