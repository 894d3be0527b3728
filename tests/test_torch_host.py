"""Host code of showo_tpu_torch held to the JAX package's.

The port keeps its own copies of the config loader, the t2i and training
prompting, the stand-in tokenizer, the Show-o2 sequence formats, the v2
tokenizer loader, the in-tree asset paths, the image transform, the
prompt-file reading of the t2i CLIs and the video loader so that it never
imports the JAX package.  These
tests show the copies agree with the originals exactly: the same config
tree, the same token ids, the same t2i layout, the same training text
blocks (conditioning dropout included) and lm / mmu blocks, also against
the reference-generated golden (tests/golden/prompting.npz), and the same
v2 layouts (also against tests/golden/formats.npz), fallback and local
tokenizer ids, every line of a prompt file (blank ones too), and the same
frames of a frame directory and a GIF; and the Show-o2 trainers' jsonl
data path (``data/image_text.py``, ``data/mixed.py``, ``data/loader.py``):
the dataset's samples on the same records and seed, collate, the per-process
shard, every mixing mode, the loader state; the v1 trainer's host readers
(``csrc/host/*.cpp`` the JAX package's ``native/`` sources byte for byte,
their g++ build, the readers' fallbacks when it fails; the readers' samples
are held to JAX's in tests/test_torch_data_loaders.py).  A static scan
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


@pytest.mark.parametrize("context", [0, 1, 2])
@pytest.mark.parametrize("max_text_len", [8, 128])
def test_lvg_prompting_matches_jax(max_text_len, context):
    """The ``lvg_gen`` task around a long-video payload (``context`` frames'
    spans and the masked frame): JAX's rows, one soi / eoi per frame."""
    ours = UniversalPrompting(FakeTokenizer(), max_text_len=max_text_len)
    ref = JaxPrompting(jfake.FakeTokenizer(), max_text_len=max_text_len)
    sp = ours.sptids
    rng = np.random.default_rng(context)
    parts = []
    for _ in range(context):
        parts += [rng.integers(60000, 60100, size=(len(PROMPTS), 9)),
                  np.full((len(PROMPTS), 1), sp["<|eoi|>"]),
                  np.full((len(PROMPTS), 1), sp["<|soi|>"])]
    payload = np.concatenate(parts + [np.full((len(PROMPTS), 9), 58497)],
                             axis=1)
    got = ours((PROMPTS, payload), "lvg_gen")
    want = ref((PROMPTS, payload), "lvg_gen")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ((got[0] == sp["<|soi|>"]).sum(axis=1) == context + 1).all()
    assert ((got[0] == sp["<|eoi|>"]).sum(axis=1) == context + 1).all()


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
    """A task the reference's dispatch does not know raises
    NotImplementedError in both packages (every task of JAX's is ported:
    ``test_labelled_prompting_tasks_match_jax``)."""
    for uni in (UniversalPrompting(FakeTokenizer(), max_text_len=8),
                JaxPrompting(jfake.FakeTokenizer(), max_text_len=8)):
        with pytest.raises(NotImplementedError):
            uni((["a"], np.zeros((1, 4), np.int64)), "v2v")


@pytest.mark.parametrize("task", ["t2i", "t2i_plus_lm", "t2v", "t2v_gen",
                                  "lm", "mmu", "i2v", "lvg"])
@pytest.mark.parametrize("max_text_len", [8, 128])
def test_labelled_prompting_tasks_match_jax(task, max_text_len):
    """The tasks with labels of ``UniversalPrompting.__call__`` (and
    ``t2v_gen``), on the same prompts (one cut), image / video ids and
    labels, at conditioning dropout 0.5: the same arrays and dtypes, and
    the same numpy generator state after the call (one draw a row in every
    generation task, as JAX's ``_gen_family``)."""
    ours = UniversalPrompting(FakeTokenizer(), max_text_len=max_text_len,
                              cond_dropout_prob=0.5)
    ref = JaxPrompting(jfake.FakeTokenizer(), max_text_len=max_text_len,
                       cond_dropout_prob=0.5)
    rng = np.random.default_rng(max_text_len)
    n = len(PROMPTS)
    img = rng.integers(0, 50, size=(n, 9))
    labels = np.where(rng.random((n, 9)) < 0.5, -100, img)
    inputs = {"t2i": (PROMPTS, img, labels), "t2v": (PROMPTS, img, labels),
              "t2v_gen": (PROMPTS, img), "lvg": (PROMPTS, img, labels),
              "lm": (PROMPTS, 20), "mmu": (img, PROMPTS),
              "i2v": (img, img + 7, labels),
              "t2i_plus_lm": (PROMPTS + PROMPTS[::-1], img, labels, 20)}
    kw = {"t2i_batch_size": n} if task == "t2i_plus_lm" else {}
    got, want = ours(inputs[task], task, **kw), ref(inputs[task], task, **kw)
    if task == "t2i_plus_lm":
        got, want = got[0] + got[1], want[0] + want[1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype
    assert ours.rng.random() == ref.rng.random()
    if task == "i2v":
        two = ours((img, img + 7), "i2v")
        for g, w in zip(two, ref((img, img + 7), "i2v")):
            np.testing.assert_array_equal(g, w)


def test_generate_prompts_draw_as_jax():
    """``t2i_gen`` draws one number a row from the prompting's generator,
    as JAX's does, so the training text blocks' dropout after a validation
    generate is JAX's."""
    ours = UniversalPrompting(FakeTokenizer(), max_text_len=8,
                              cond_dropout_prob=0.5)
    ref = JaxPrompting(jfake.FakeTokenizer(), max_text_len=8,
                       cond_dropout_prob=0.5)
    img = np.zeros((len(PROMPTS), 4), np.int64)
    for uni in (ours, ref):
        uni((PROMPTS, img), "t2i_gen")
        uni(([""] * len(PROMPTS), img), "t2i_gen")
    np.testing.assert_array_equal(ours.t2i_text_block(PROMPTS * 3),
                                  ref.t2i_text_block(PROMPTS * 3))


V2_IDS = dict(bos_id=1, eos_id=2, boi_id=3, eoi_id=4, pad_id=5, img_pad_id=6)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("fn", ["format_sequence_gen_qwen2_5",
                                "format_sequence_und"])
@pytest.mark.parametrize("n_text", [0, 4, 9])
def test_v2_formats_match_jax(fn, n_text):
    from showo_tpu.show_o2 import formats as jformats
    from showo_tpu_torch.show_o2 import formats as tformats

    text = list(range(11, 11 + n_text))
    kw = dict(num_image_tokens=5, max_seq_len=20, **V2_IDS)
    _same(getattr(tformats, fn)(text, **kw), getattr(jformats, fn)(text, **kw))


def test_v2_formats_match_golden():
    """The interleaved layout and prepare_gen_input against the
    reference-generated golden and the JAX originals."""
    from showo_tpu.show_o2 import formats as jformats
    from showo_tpu_torch.inference_t2i_v2 import FakeQwenTokenizer
    from showo_tpu_torch.show_o2 import formats as tformats

    golden = np.load(os.path.join(REPO, "tests", "golden", "formats.npz"))
    args = ([None, "img", "img"], [[21, 22], [23], None])
    kw = dict(num_image_tokens=3, max_seq_len=30, max_num_images=3, **V2_IDS)
    got = tformats.format_interleaved_sequence(*args, **kw)
    _same(got, jformats.format_interleaved_sequence(*args, **kw))
    for name, g in zip(("tokens", "labels", "mp", "tm", "im"), got):
        np.testing.assert_array_equal(g, golden[f"int_{name}"])
    prompts = ["a cat on a mat", "hello world"]
    got = tformats.prepare_gen_input(prompts, FakeQwenTokenizer(),
                                     num_image_tokens=5, max_text_len=10,
                                     **V2_IDS)
    for name, g in zip(("tokens", "null", "mp", "mp_null"), got):
        np.testing.assert_array_equal(g, golden[f"pg_{name}"])
    nulls = ["", "a b"]
    kw = dict(num_image_tokens=5, bos_id=1, boi_id=3, eoi_id=4, pad_id=5,
              img_pad_id=6)
    _same(tformats.prepare_mixed_modal_gen_input(prompts, nulls,
                                                 FakeQwenTokenizer(), **kw),
          jformats.prepare_mixed_modal_gen_input(prompts, nulls,
                                                 _jax_v2_tokenizer(), **kw))


def _jax_v2_tokenizer():
    class Tok:
        def __init__(self):
            self._t = jfake.FakeTokenizer()

        def __call__(self, text, add_special_tokens=False):
            return {"input_ids": self._t(text)["input_ids"][0]}

    return Tok()


def test_v2_tokenizer_loader_matches_jax():
    """Without a local tokenizer both loaders fall back to the word-hash
    stand-in with ids 1..7; the same prompts give the same ids.  The JAX
    loader asks ``transformers`` first: a stub that refuses stands in for
    it, so nothing is looked up."""
    import types
    from unittest import mock

    from showo_tpu import inference_t2i_v2 as jinf
    from showo_tpu_torch import inference_t2i_v2 as tinf

    config = tconfig.load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"))
    stub = types.ModuleType("transformers")

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(*args, **kwargs):
            raise OSError("no tokenizer here")

    stub.AutoTokenizer = AutoTokenizer
    with mock.patch.dict(sys.modules, {"transformers": stub}):
        jtok, jids = jinf.load_tokenizer_and_ids(config)
    ttok, tids = tinf.load_tokenizer_and_ids(config)
    assert tids == jids
    assert tinf.QWEN_TOKEN_IDS == jinf.QWEN_TOKEN_IDS
    for p in PROMPTS + ["<|soi|> x"]:
        assert (ttok(p, add_special_tokens=False)
                == jtok(p, add_special_tokens=False))


class _StubQwenTokenizer:
    """What the v2 loaders ask of a local Qwen2.5 tokenizer: its vocabulary
    (the vision tokens native), an eos id, added tokens appended."""

    eos_token_id = 151645

    def __init__(self):
        self.vocab = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                      "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                      "<|image_pad|>": 151655, "<|video_pad|>": 151656}
        self.pad_token_id = None

    def add_tokens(self, token):
        self.vocab.setdefault(token, 151936 + len(self.vocab) - 6)

    def add_special_tokens(self, tokens):
        self.add_tokens(tokens["pad_token"])
        self.pad_token_id = self.vocab[tokens["pad_token"]]

    def get_vocab(self):
        return dict(self.vocab)


def test_v2_tokenizer_ids_of_a_local_tokenizer_match_jax(tmp_path):
    """With a local tokenizer directory the port's loader gives the ids of
    JAX ``show_o2/tokenizer.py::get_text_tokenizer`` (the video and
    ``<image>`` ids among them), asking only for local files."""
    import types
    from unittest import mock

    from showo_tpu.show_o2.tokenizer import get_text_tokenizer
    from showo_tpu_torch import inference_t2i_v2 as tinf

    asked = []
    stub = types.ModuleType("transformers")

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, **kwargs):
            asked.append(kwargs)
            return _StubQwenTokenizer()

    stub.AutoTokenizer = AutoTokenizer
    config = tconfig.load_config(
        os.path.join(REPO, "configs", "showo2_1.5b_demo_432x432.yaml"),
        [f"model.showo.llm_model_path={tmp_path}"])
    with mock.patch.dict(sys.modules, {"transformers": stub}):
        _, want = get_text_tokenizer(str(tmp_path),
                                     return_showo_token_ids=True)
        _, got = tinf.load_tokenizer_and_ids(config)
    assert got == want
    assert {"bov_id", "eov_id", "img_id"} <= set(got)
    assert asked[-1] == {"local_files_only": True}


def test_fake_qwen_tokenizer_decodes_what_it_encoded():
    from showo_tpu_torch import inference_t2i_v2 as tinf

    tok = tinf.FakeQwenTokenizer()
    ids = tok("a small red boat", add_special_tokens=False)["input_ids"]
    eos = tinf.FAKE_TOKEN_IDS["eos_id"]
    assert tok.decode(ids + [eos], skip_special_tokens=True) == \
        "a small red boat"
    assert tok.batch_decode([[ids[2], 999], [eos]]) == ["red <999>",
                                                        f"<{eos}>"]


@pytest.mark.parametrize("module", ["inference_t2i", "inference_t2i_v2"])
def test_load_prompts_keeps_blank_lines_as_jax(tmp_path, module):
    """Both t2i CLIs read the prompt file as the JAX CLIs do
    (``f.read().splitlines()``): 4 lines in, blank and whitespace-only
    ones among them, 4 prompts out, so image i is line i's prompt."""
    import importlib

    path = tmp_path / "prompts.txt"
    path.write_text("a cat\n\n   \na dog on a hill\n")
    with open(path) as f:
        want = f.read().splitlines()
    config_file = ("showo_demo_512x512.yaml" if module == "inference_t2i"
                   else "showo2_1.5b_demo_432x432.yaml")
    config = tconfig.load_config(os.path.join(REPO, "configs", config_file),
                                 [f"validation_prompts_file={path}"])
    got = importlib.import_module(f"showo_tpu_torch.{module}").load_prompts(
        config)
    assert got == want == ["a cat", "", "   ", "a dog on a hill"]


@pytest.mark.parametrize("source", ["frames", "gif"])
@pytest.mark.parametrize("num_frames", [3, 9])
def test_load_video_matches_jax(tmp_path, source, num_frames):
    """``load_video`` gives the JAX loader's frames bit for bit: a frame
    directory (image files only, name order) and a GIF, sampled down (3 of
    5) and padded with the last frame (9 of 5)."""
    from PIL import Image

    from showo_tpu.utils.video import load_video as jload
    from showo_tpu_torch.utils.video import load_video as tload

    frames = [Image.fromarray(np.random.default_rng(i).integers(
        0, 256, (24, 30, 3), dtype=np.uint8)) for i in range(5)]
    if source == "frames":
        path = tmp_path / "clip"
        path.mkdir()
        for i, f in enumerate(frames):
            f.save(path / f"f{i:02d}.png")
        (path / "notes.txt").write_text("not a frame")
    else:
        path = tmp_path / "clip.gif"
        frames[0].save(path, save_all=True, append_images=frames[1:])
    got = tload(str(path), num_frames=num_frames, resolution=16)
    want = jload(str(path), num_frames=num_frames, resolution=16)
    assert got.shape == (num_frames, 16, 16, 3)
    np.testing.assert_array_equal(got, want)


def test_v2_config_matches_jax():
    """build_showo2_config reads the same keys as the JAX original, with
    and without the tiny override dicts."""
    from showo_tpu import inference_t2i_v2 as jinf
    from showo_tpu_torch import inference_t2i_v2 as tinf

    path = os.path.join(REPO, "configs", "showo2_1.5b_demo_432x432.yaml")
    for ov in ([], ["model.showo.llm_num_layers=2",
                    "model.showo.dit={hidden_size: 96, num_heads: 4}",
                    "model.showo.siglip={num_layers: 3}"]):
        want = jinf.build_showo2_config(jconfig.load_config(path, ov))
        got = tinf.build_showo2_config(tconfig.load_config(path, ov))
        assert got.num_image_tokens == want.num_image_tokens == 730
        for part in ("llm", "siglip", "dit"):
            w, g = getattr(want, part), getattr(got, part)
            for f in g.__dataclass_fields__:
                assert getattr(g, f) == getattr(w, f), (part, f)
        for f in ("image_latent_dim", "image_latent_height",
                  "image_latent_width", "patch_size", "clip_latent_dim",
                  "add_time_embeds"):
            assert getattr(got, f) == getattr(want, f), f


def test_assets_match_jax(tmp_path):
    """The asset paths resolve as the JAX package's do: the in-tree
    inpainting pair and prompt list, a given path that exists, and
    nothing where neither exists."""
    from showo_tpu.utils import assets as jassets
    from showo_tpu_torch.utils import assets as tassets

    assert tassets.ASSETS_DIR == jassets.ASSETS_DIR
    pair = tassets.inpainting_pair()
    assert pair == jassets.inpainting_pair() and all(map(os.path.exists,
                                                         pair))
    own = tmp_path / "mask.png"
    own.write_bytes(b"")
    for args in ((None, str(own)), (str(own), "no/such/mask.png")):
        assert tassets.inpainting_pair(*args) == jassets.inpainting_pair(*args)
    for preferred in (None, str(own), "no/such/prompts.txt"):
        assert (tassets.validation_prompts_file(preferred)
                == jassets.validation_prompts_file(preferred))
    assert tassets.resolve(None, "no-such-asset") is None
    assert jassets.resolve(None, "no-such-asset") is None


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("asset", ["inpainting/mask.png",
                                   "inpainting/source.png"])
def test_image_transform_matches_jax(asset, normalize):
    """``image_transform`` with and without ``normalize`` (the inpainting
    mask is read in [0, 1]) equals the JAX package's, bit for bit."""
    from PIL import Image

    from showo_tpu.utils import image as jimage
    from showo_tpu_torch.utils import image as timage

    img = Image.open(os.path.join(REPO, "assets", "validation", asset))
    img = img.convert("L" if "mask" in asset else "RGB")
    for res in (64, 256, 512):
        np.testing.assert_array_equal(
            timage.image_transform(img, res, normalize=normalize),
            jimage.image_transform(img, res, normalize=normalize))


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


def test_serving_host_code_matches_jax(tmp_path):
    """The serving engine's bucket rounding and the serve CLI's request
    gathering (a requests.jsonl, else every image of ``mmu_image_root``
    times every question) are the JAX package's."""
    from showo_tpu import inference_serve as jserve
    from showo_tpu.serving import engine as jengine
    from showo_tpu_torch import inference_serve as tserve
    from showo_tpu_torch.serving import engine as tengine

    for n in (1, 320, 321, 448):
        assert (tengine._round_bucket(n, (320, 384, 448))
                == jengine._round_bucket(n, (320, 384, 448)))
    for mod in (tengine, jengine):
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            mod._round_bucket(449, (320, 384, 448))
    for name in ("b.png", "a.JPG", "c.txt"):
        (tmp_path / name).write_bytes(b"")
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text('{"image": "x.png", "question": "q"}\n\n'
                    '{"image": "y.png", "question": "r", '
                    '"max_new_tokens": 3}\n')
    for cfg in ({"requests": str(reqs)},
                {"mmu_image_root": str(tmp_path), "question": "A? *** B?"}):
        cfg = tconfig.Config(cfg)
        assert tserve.gather_requests(cfg) == jserve.gather_requests(cfg)
        assert len(tserve.gather_requests(cfg)) in (2, 4)
    for a, b in ((7, 32), (64, 64), (65, 64)):
        assert tserve._round_up(a, b) == jserve._round_up(a, b)


# -- the Show-o2 trainers' jsonl data path ---------------------------------------

V2_TRAIN_IDS = dict(bos_id=1, eos_id=2, boi_id=3, eoi_id=4, pad_id=5,
                    img_pad_id=6)


def _jsonl(tmp_path, n=6, size=20):
    """A jsonl of ``n`` PNG records of growing widths under ``tmp_path``,
    alternating the "caption" and "prompt" keys."""
    import json

    from PIL import Image

    imdir = tmp_path / "imgs"
    imdir.mkdir(exist_ok=True)
    path = tmp_path / "data.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            p = imdir / f"{i}.png"
            Image.new("RGB", (size + 4 * i, size), (i * 40 % 255, 90,
                                                    200 - 10 * i)).save(p)
            key = "prompt" if i % 2 else "caption"
            f.write(json.dumps({"path": str(p), key: f"a sample {i}"}) + "\n")
    return str(path)


@pytest.mark.parametrize("data_type,flip", [("t2i", 0.0), ("mmu", 0.0),
                                            ("t2i", 0.5)])
def test_image_text_dataset_vs_jax(tmp_path, data_type, flip):
    from showo_tpu.data.image_text import ImageTextDataset as JDataset
    from showo_tpu_torch.data.image_text import ImageTextDataset as TDataset
    from showo_tpu_torch.inference_t2i_v2 import FakeQwenTokenizer

    path = _jsonl(tmp_path)
    kw = dict(resolution=16, num_image_tokens=17, max_seq_len=40,
              max_text_len=8, cond_dropout_prob=0.3, random_und_or_gen=flip,
              seed=3, default_data_type=data_type, with_clip=True)
    tok = FakeQwenTokenizer()
    got = list(TDataset(path, tok, V2_TRAIN_IDS, **kw))
    want = list(JDataset(path, tok, V2_TRAIN_IDS, **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_loader_pieces_vs_jax(tmp_path):
    from showo_tpu.data import loader as jloader
    from showo_tpu.data import mixed as jmixed
    from showo_tpu_torch.data import loader as tloader
    from showo_tpu_torch.data import mixed as tmixed

    samples = [{"x": np.full((2,), i), "s": f"t{i}"} for i in range(7)]
    got = tloader.default_collate(samples)
    want = jloader.default_collate(samples)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(got["s"], want["s"])
    items = list(range(7))
    for i, n in ((0, 3), (2, 3), (5, 9)):
        assert tloader.shard_for_process(items, i, n) \
            == jloader.shard_for_process(items, i, n)
    assert tloader.shard_for_process(items) == items

    def loaders(mod):
        return [mod.CheckpointableDataLoader(
            lambda k=k: iter(samples[:k]), batch_size=2, num_epochs=1)
            for k in (7, 4)]

    for mode in ("max_size_cycle", "min_size", "concat_max_size_cycle",
                 "concat_min_size", "sequential_max_size_cycle"):
        got = list(tmixed.MixedDataLoader(loaders(tloader), mode=mode,
                                          seed=1))
        want = list(jmixed.MixedDataLoader(loaders(jloader), mode=mode,
                                           seed=1))
        assert len(got) == len(want), mode
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])
    assert len(list(tmixed.MixedDataLoader(loaders(tloader)))) == 3

    # the loader state: a restored loader skips what the first one yielded
    ld = tloader.CheckpointableDataLoader(lambda: iter(samples),
                                          batch_size=2, num_epochs=1)
    it = iter(ld)
    first = next(it)
    tloader.save_loader_state(ld, str(tmp_path), 5)
    ld2 = tloader.CheckpointableDataLoader(lambda: iter(samples),
                                           batch_size=2, num_epochs=1)
    assert tloader.restore_loader_state(ld2, str(tmp_path), 5)
    assert not tloader.restore_loader_state(ld2, str(tmp_path), 6)
    rest = list(ld2)
    np.testing.assert_array_equal(rest[0]["x"], next(it)["x"])
    assert len(rest) == 2 and first["s"].tolist() == ["t0", "t1"]




# -- the v1 trainer's host readers (csrc/host, data/) ---------------------------

@pytest.mark.parametrize("name", ["tario.cpp", "imgdec.cpp"])
def test_native_sources_are_the_reference_byte_for_byte(name):
    """The port builds its own copies of ``native/*.cpp``; they are the
    JAX package's sources, byte for byte."""
    with open(os.path.join(REPO, "native", name), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "showo_tpu_torch", "csrc", "host", name),
              "rb") as f:
        assert f.read() == want


def test_host_build_names_and_loads(tmp_path, monkeypatch):
    """``utils/host_build.py`` builds a source once under a name of its
    hash; a failed build raises and leaves no library behind."""
    from showo_tpu_torch.utils import host_build

    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path))
    src, out = host_build.library_path("tario")
    assert os.path.dirname(out) == str(tmp_path)
    assert host_build.library_path("tario", ("-ljpeg",))[1] != out
    lib = host_build.load_host_library("tario")
    assert os.path.exists(out) and hasattr(lib, "tario_index")
    mtime = os.path.getmtime(out)
    host_build.load_host_library("tario")
    assert os.path.getmtime(out) == mtime
    with pytest.raises(RuntimeError, match="failed"):
        host_build.load_host_library("imgdec", libs=("-lno_such_lib_x",))
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(out)]


def test_readers_fall_back_as_jax(tmp_path, monkeypatch):
    """Without a compiler both readers take JAX's fallbacks (tarfile, PIL)
    and say so through their path counters."""
    import io
    import tarfile

    from PIL import Image

    from showo_tpu_torch.data import native_image, native_tar
    from showo_tpu_torch.utils import host_build

    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native_tar, "_lib", None)
    monkeypatch.setattr(native_image, "_lib", None)
    buf = io.BytesIO()
    Image.new("RGB", (12, 10), (200, 30, 60)).save(buf, format="JPEG")
    shard = tmp_path / "s.tar"
    with tarfile.open(shard, "w") as tf:
        info = tarfile.TarInfo("a.jpg")
        info.size = len(buf.getvalue())
        tf.addfile(info, io.BytesIO(buf.getvalue()))
    before = (native_tar.paths["tarfile"], native_image.paths["pil"])
    idx = native_tar.TarIndex(str(shard))
    out, valid = native_image.decode_batch(idx.read([0]), 8)
    assert not idx.native and native_tar._lib is False
    assert native_image._lib is False and valid == [True]
    assert (native_tar.paths["tarfile"], native_image.paths["pil"]) == (
        before[0] + 1, before[1] + 1)


NEW_PORT_MODULES = (
    "showo_tpu_torch/data/imagenet.py", "showo_tpu_torch/data/native_image.py",
    "showo_tpu_torch/data/native_tar.py", "showo_tpu_torch/data/refinedweb.py",
    "showo_tpu_torch/data/tar_shards.py",
    "showo_tpu_torch/data/vist_dataset.py",
    "showo_tpu_torch/show_o2/semantic_layers.py",
    "showo_tpu_torch/show_o2/train_mixed_modality.py",
    "showo_tpu_torch/training/ema.py", "showo_tpu_torch/utils/host_build.py",
    "showo_tpu_torch/evaluation/__init__.py",
    "showo_tpu_torch/evaluation/dpg_bench.py",
    "showo_tpu_torch/evaluation/fid.py",
    "showo_tpu_torch/evaluation/geneval.py",
    "showo_tpu_torch/evaluation/lmms_benchmarks.py",
    "showo_tpu_torch/evaluation/mmu_eval.py",
    "showo_tpu_torch/evaluation/run_quality.py",
    "showo_tpu_torch/evaluation/vq_psnr.py",
    "showo_tpu_torch/utils/safety.py")


def test_import_scan_covers_the_trainers_modules():
    """The scan of ``test_port_source_imports_no_jax`` reaches the modules
    of the trainers' data and options and every module of the evaluation
    chain (``evaluation/``, ``utils/safety.py``)."""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert set(NEW_PORT_MODULES) <= scanned
    evaluation = os.path.join(REPO, "showo_tpu_torch", "evaluation")
    assert {os.path.join("showo_tpu_torch", "evaluation", f)
            for f in os.listdir(evaluation) if f.endswith(".py")} \
        <= set(NEW_PORT_MODULES)
    for path in NEW_PORT_MODULES:
        assert not [m for m in _imports(os.path.join(REPO, path))
                    if m.split(".")[0] in FORBIDDEN], path


def test_determinism_seeds_every_generator():
    """``set_seed`` seeds random, numpy and torch as JAX's seeds random and
    numpy (the same draws after it) and returns a generator of the seed;
    ``enable_full_determinism`` turns torch's deterministic algorithms on
    and sets cuBLAS's workspace."""
    import random

    from showo_tpu.utils import determinism as jdet
    from showo_tpu_torch.utils import determinism as tdet

    jdet.set_seed(11)
    want = (random.random(), np.random.rand())
    gen = tdet.set_seed(11)
    assert (random.random(), np.random.rand()) == want
    first = torch.rand(3)
    tdet.set_seed(11)
    assert torch.equal(torch.rand(3), first)
    assert torch.equal(torch.rand(2, generator=gen),
                       torch.rand(2, generator=torch.Generator()
                                  .manual_seed(11)))
    env = {k: os.environ.get(k) for k in ("CUBLAS_WORKSPACE_CONFIG",)}
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        tdet.enable_full_determinism(3)
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
        torch.backends.cudnn.benchmark = flags[2]
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("llm_name", ["qwen2_5", "llama3"])
def test_get_text_tokenizer_matches_jax(llm_name):
    """``show_o2/tokenizer.py::get_text_tokenizer`` against JAX's on a stub
    of ``transformers`` (a vocabulary with each model's native tokens): the
    same added tokens and ids; the port asks for local files only."""
    import types
    from unittest import mock

    from showo_tpu.show_o2.tokenizer import get_text_tokenizer as jget
    from showo_tpu_torch.show_o2.tokenizer import get_text_tokenizer

    native = {"llama3": {"<|begin_of_text|>": 128000,
                         "<|eot_id|>": 128009},
              "qwen2_5": dict(_StubQwenTokenizer().vocab)}[llm_name]

    class Stub(_StubQwenTokenizer):
        eos_token_id = max(native.values())

        def __init__(self):
            self.vocab = dict(native)
            self.pad_token_id = None

        def add_tokens(self, token):
            self.vocab.setdefault(token, 200000 + len(self.vocab))

    asked = []
    stub = types.ModuleType("transformers")

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, **kwargs):
            asked.append(kwargs)
            return Stub()

    stub.AutoTokenizer = AutoTokenizer
    with mock.patch.dict(sys.modules, {"transformers": stub}):
        jtok, want = jget("any", return_showo_token_ids=True,
                          llm_name=llm_name)
        tok, got = get_text_tokenizer("any", return_showo_token_ids=True,
                                      llm_name=llm_name)
        assert get_text_tokenizer("any").get_vocab() == jget(
            "any").get_vocab()
        with pytest.raises(NotImplementedError):
            get_text_tokenizer("any", llm_name="gpt2")
    assert got == want and tok.get_vocab() == jtok.get_vocab()
    assert asked[1] == {"local_files_only": True}


def test_logging_pieces_match_jax(tmp_path):
    """``utils/tracker.py``'s AverageMeter, Stopwatch, get_logger and
    resolve_wandb_run_id against ``utils/logging.py``'s: the same means,
    a lap, one handler, and the same run ids (from the config, none when
    disabled, persisted and reread in ``output_dir``)."""
    from showo_tpu.utils import logging as jlog
    from showo_tpu_torch.utils import tracker as tlog

    ours, ref = tlog.AverageMeter(), jlog.AverageMeter()
    for v, n in ((1.5, 2), (3.0, 1), (-0.5, 4)):
        ours.update(v, n)
        ref.update(v, n)
    assert vars(ours) == vars(ref)
    assert tlog.Stopwatch().lap() >= 0
    logger = tlog.get_logger("showo_tpu_torch.test_host")
    assert len(logger.handlers) == 1 and not logger.propagate
    assert tlog.get_logger("showo_tpu_torch.test_host") is logger
    for cfg in ({"wandb": {"run_id": "abc", "resume": "must"}}, {}):
        config = tconfig.load_config(os.path.join(REPO, "configs",
                                                  "showo_demo.yaml"))
        config.update(cfg)
        for enabled in (False, True):
            out = tmp_path / f"{len(cfg)}{enabled}"
            got = tlog.resolve_wandb_run_id(config, str(out), enabled)
            assert out.exists() == (enabled and not cfg)
            if enabled and not cfg:
                want = jlog.resolve_wandb_run_id(config, str(out), enabled)
                assert want == (got[0], "auto") and len(got[0]) == 8
                assert got[1] is False
            else:
                assert got == jlog.resolve_wandb_run_id(config, str(out),
                                                        enabled)


def test_profile_reads_device_events_of_the_raw_trace():
    """profile_t2i reads the device events straight from the profiler's
    raw results: times from the trace's start in us, the host's events,
    hidden events and the profiler's own rows left out; busy time is the
    union of the intervals and the launches are counted by kernel."""
    from types import SimpleNamespace

    from showo_tpu_torch import profile_t2i

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    t0 = 1_792_320_448_235_886_427        # epoch ns, as kineto gives them

    def event(kind, name, start_us, end_us, hidden=False):
        return SimpleNamespace(
            device_type=lambda: kind, name=lambda: name,
            start_ns=lambda: t0 + start_us * 1000,
            end_ns=lambda: t0 + end_us * 1000, is_hidden_event=lambda: hidden)

    events = [event(cuda, "gemv_kernel", 10, 14),
              event(cpu, "aten::mm", 0, 100),
              event(cuda, "gemv_kernel", 12, 20),
              event(cuda, "Buffer Flush", 30, 90),
              event(cuda, "hidden", 40, 95, hidden=True),
              event(cuda, "fused::omni", 50, 51)]
    results = SimpleNamespace(trace_start_ns=lambda: t0,
                              events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    got = profile_t2i._device_events(prof)
    assert got == [(10.0, 14.0, "gemv_kernel"), (12.0, 20.0, "gemv_kernel"),
                   (50.0, 51.0, "fused::omni")]
    assert profile_t2i._busy_ms(got) == (0.011, 0.041, 3)
    assert profile_t2i._by_kernel(got) == {"gemv_kernel": [2, 0.012],
                                           "fused::omni": [1, 0.001]}
