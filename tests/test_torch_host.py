"""Host code of showo_tpu_torch held to the JAX package's.

The port keeps its own copies of the config loader, the t2i and training
prompting and the stand-in tokenizer so that it never imports the JAX
package.  These tests show the copies agree with the originals exactly:
the same config tree, the same token ids, the same t2i layout, the same
training text blocks (conditioning dropout included) and lm / mmu blocks,
also against the reference-generated golden (tests/golden/prompting.npz).  A static scan
shows that neither the package nor ``chip_smoke.py`` imports jax, flax or
the JAX package, even inside a function.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from showo_tpu import config as jconfig
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu_torch import config as tconfig
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "showo_tpu", "fake_tokenizer")

PROMPTS = [
    "a red cat",
    "",
    "an old stone bridge over water at dusk",
    # longer than max_text_len words: cut, with a closing eos
    " ".join(f"word{i}" for i in range(40)),
]


@pytest.mark.parametrize("overrides", [
    [],
    ["mode=t2i", "batch_size=2", "guidance_scale=1.75",
     "model.showo.phi={hidden_size: 64, num_layers: 2}",
     "dataset.params.resolution=64", "output_dir=out/${mode}"],
], ids=["plain", "overrides"])
@pytest.mark.parametrize("path", ["configs/showo_demo_512x512.yaml",
                                  "configs/showo_demo.yaml"])
def test_config_matches_jax(path, overrides):
    path = os.path.join(REPO, path)
    want = jconfig.load_config(path, overrides)
    got = tconfig.load_config(path, overrides)
    assert got == want
    argv = [f"config={path}"] + overrides
    assert tconfig.get_config(argv) == jconfig.get_config(argv)


def test_fake_tokenizer_matches_tools():
    ours, ref = FakeTokenizer(), jfake.FakeTokenizer()
    for tok in (ours, ref):
        tok.add_special_tokens({"pad_token": "[PAD]"})
        tok.add_tokens(["<|soi|>", "<|eoi|>", "<|t2i|>"])
    assert ours(PROMPTS) == ref(PROMPTS)
    assert ours("one two <|soi|>") == ref("one two <|soi|>")
    for t in ("[PAD]", "<|soi|>", "<|t2i|>", "never-added"):
        assert ours.convert_tokens_to_ids([t]) == ref.convert_tokens_to_ids([t])
    assert (ours.bos_token_id, ours.eos_token_id, ours.pad_token_id) == (
        ref.bos_token_id, ref.eos_token_id, ref.pad_token_id)


@pytest.mark.parametrize("max_text_len", [8, 128])
def test_t2i_prompting_matches_jax(max_text_len):
    ours = UniversalPrompting(FakeTokenizer(), max_text_len=max_text_len)
    ref = JaxPrompting(jfake.FakeTokenizer(), max_text_len=max_text_len)
    assert ours.sptids == ref.sptids
    rng = np.random.default_rng(max_text_len)
    img = rng.integers(0, 50, size=(len(PROMPTS), 9))
    got_ids, got_mask = ours((PROMPTS, img), "t2i_gen")
    want_ids, want_mask = ref((PROMPTS, img), "t2i_gen")
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_ids.shape == (len(PROMPTS), max_text_len + 1 + 9 + 2)


GOLDEN_TEXTS = ["a photo of a cat", "an oil painting of mountains at dusk",
                ""]


@pytest.mark.parametrize("dropout", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("max_text_len", [8, 128])
def test_training_text_blocks_match_jax(max_text_len, dropout):
    """t2i_text_block (with the numpy rng's conditioning dropout, over
    several calls), lm_prompt and mmu_text_block."""
    kw = dict(max_text_len=max_text_len, cond_dropout_prob=dropout)
    ours = UniversalPrompting(FakeTokenizer(), **kw,
                              rng=np.random.default_rng(5))
    ref = JaxPrompting(jfake.FakeTokenizer(), **kw,
                       rng=np.random.default_rng(5))
    for _ in range(3):
        np.testing.assert_array_equal(ours.t2i_text_block(PROMPTS),
                                      ref.t2i_text_block(PROMPTS))
    np.testing.assert_array_equal(ours.t2i_text_block(PROMPTS, dropout=False),
                                  ref.t2i_text_block(PROMPTS, dropout=False))
    ids = ours.text_tokenizer(PROMPTS)["input_ids"]
    for L in (5, 30):
        for got, want in zip(ours.lm_prompt(ids, L), ref.lm_prompt(ids, L)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ours.mmu_text_block(PROMPTS),
                         ref.mmu_text_block(PROMPTS)):
        np.testing.assert_array_equal(got, want)


def test_training_text_blocks_match_golden():
    """lm_prompt is the golden ``lm`` task; mmu_text_block is the text part
    of the golden ``mmu`` rows and labels (after [mmu][soi] img [eoi])."""
    golden = np.load(os.path.join(REPO, "tests", "golden", "prompting.npz"))
    uni = UniversalPrompting(FakeTokenizer(), max_text_len=8,
                             cond_dropout_prob=0.0)
    ids, masks, labels = uni.lm_prompt(
        uni.text_tokenizer(GOLDEN_TEXTS)["input_ids"], 12)
    np.testing.assert_array_equal(ids, golden["lm_ids"])
    np.testing.assert_array_equal(masks, golden["lm_masks"])
    np.testing.assert_array_equal(labels, golden["lm_labels"])
    block, block_labels = uni.mmu_text_block(GOLDEN_TEXTS)
    n = golden["image_ids"].shape[1] + 3
    np.testing.assert_array_equal(block, golden["mmu_ids"][:, n:])
    np.testing.assert_array_equal(block_labels, golden["mmu_labels"][:, n:])


def test_other_prompting_tasks_raise():
    uni = UniversalPrompting(FakeTokenizer(), max_text_len=8)
    with pytest.raises(NotImplementedError):
        uni((["a"], np.zeros((1, 4), np.int64)), "mmu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "showo_tpu_torch")):
        yield from (os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, REPO)
                                        for p in _port_sources()))
def test_port_source_imports_no_jax(path):
    bad = [m for m in _imports(os.path.join(REPO, path))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
