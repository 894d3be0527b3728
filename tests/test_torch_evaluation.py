"""The evaluation chain of showo_tpu_torch (``evaluation/``, and
``utils/safety.py``, ``utils/assets.py::validation_image``,
``utils/image.py::to_pil_images``) held to the JAX package's on the CPU,
the same inputs made from numpy seeds:

* the scorers (``normalize_answer``, ``score_predictions``,
  ``parse_yes_no``, ``parse_multi_choice``, MME / POPE / GQA / MMMU and the
  dispatch): every returned dict and string exactly, on seeded random
  items and on the quirks the port copies (the first yes / no anywhere,
  MME's acc+ by question id, an ambiguous option, an unknown benchmark);
* the GenEval and DPG sweeps on one deterministic dummy pipeline: the same
  file tree and PNG bytes, the same shard for each (device_id,
  num_devices), and ``torch.distributed``'s rank / world size where JAX
  reads its process grid;
* ``run_dpg_scoring`` with a fixed fake scorer (the csv's first row
  skipped, dependency zeroing, a grid that fails): the same dict and the
  same result and detail files, exactly;
* FID: ``RandomProjectionExtractor`` features exactly, the statistics and
  the distance within 1e-9 relative (bit for bit in practice: the same
  numpy), FID(x, x) 0 up to 1e-9 (the eigendecomposition's round-off) and
  below FID(x, y);
* ``run_mmu_eval`` with real tiny pipelines, greedy: v1 ``MMUPipeline``
  (weights carried by the port's converter) and Show-o2 ``MMUV2Pipeline``
  (the VAE draw injected on both sides), predictions and metrics
  token-exact; ``MMUPipelineScorer`` answers as JAX's;
* ``run_chain`` on a tiny v1 ``T2IPipeline`` pair: the summary's keys and
  the file layout equal JAX's, the absent-input skips the same strings
  (the images' values are held through the pipeline itself in
  tests/test_torch_t2i_slice.py);
* ``SafetyChecker``, the assets and ``vq_psnr``: the PSNR as the JAX
  tool's, the tiny MAGVIT round trip within the codec's tolerance of
  tests/test_torch_magvit.py (codes exact, pixels atol 2e-4 / rtol 1e-3);
* the CLIs (``run_quality``, ``mmu_eval``, ``vq_psnr``) run on the CPU in
  subprocesses without importing jax or the JAX package.
"""

import csv
import importlib.util
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from showo_tpu.evaluation import dpg_bench as jdpg
from showo_tpu.evaluation import fid as jfid
from showo_tpu.evaluation import geneval as jgeneval
from showo_tpu.evaluation import lmms_benchmarks as jlmms
from showo_tpu.evaluation import mmu_eval as jmmu_eval
from showo_tpu.evaluation import run_quality as jrun
from showo_tpu.models import magvit as jmv
from showo_tpu.models import phi as jphi
from showo_tpu.models import showo as jshowo
from showo_tpu.pipelines import mmu_v2 as jmmu_v2
from showo_tpu.pipelines.mmu import MMUPipeline as JaxMMUPipeline
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.utils.torch_export import showo_state_dict
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.evaluation import dpg_bench as tdpg
from showo_tpu_torch.evaluation import fid as tfid
from showo_tpu_torch.evaluation import geneval as tgeneval
from showo_tpu_torch.evaluation import lmms_benchmarks as tlmms
from showo_tpu_torch.evaluation import mmu_eval as tmmu_eval
from showo_tpu_torch.evaluation import run_quality as trun
from showo_tpu_torch.evaluation import vq_psnr
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.pipelines.mmu import MMUPipeline
from showo_tpu_torch.pipelines.mmu_v2 import MMUV2Pipeline
from showo_tpu_torch.pipelines.t2i import T2IPipeline
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.utils.convert import (load_magvit, load_showo,
                                           magvit_state_dict)
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from test_quality_chain import _tiny_pipeline as jax_tiny_t2i
from test_quality_chain import VQ_TINY
from test_torch_mmu_v2 import (PIXELS, VAE_TINY, _jax_injected, _port_vae,
                               _vae_params)
from test_torch_show_o2 import port_showo2, showo2_params, tiny_showo2_cfgs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_IMAGE = os.path.join(REPO, "assets", "validation", "test_image.png")
FORBIDDEN = ("jax", "jaxlib", "flax", "showo_tpu", "fake_tokenizer")


# -- the scorers --------------------------------------------------------------

REPLIES = ["Yes", "no", "Yes. The image shows a cat.", "Not a cat, no",
           "maybe", "I cannot say", "NO!", "yes and no", "nope", "Noted.",
           "(B)", "The answer is C because", "it shows a blue boat",
           "a red car or a blue boat", "A", "j", "(Z) then A",
           "The cat.", "an apple", "Left", "on the left", "  two dogs ",
           "the red ball", "", "a green tree", "E"]
OPTIONS = [["a red car", "a blue boat", "a green tree"],
           ["cat", "dog", "", "a cat"], ["apple", "an apple", "pear", "fig",
                                         "kiwi"]]


def _items(seed, n=40):
    """Seeded random items carrying every benchmark's fields."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        opts = OPTIONS[rng.integers(len(OPTIONS))]
        out.append({
            "question_id": f"q{rng.integers(6)}", "image": f"im{i % 5}.png",
            "category": ["existence", "count", "color"][rng.integers(3)],
            "answer": [str(x) for x in ("yes", "no", "Yes", "the cat",
                                        "left", "A", "B", "c", "red ball",
                                        "")][rng.integers(10)],
            "options": opts,
            "prediction": REPLIES[rng.integers(len(REPLIES))]})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["mme", "pope", "gqa", "mmmu"])
def test_scorers_match_jax(name, seed):
    items = _items(seed)
    got = getattr(tlmms, f"score_{name}")(items)
    assert got == getattr(jlmms, f"score_{name}")(items)
    assert tlmms.score_benchmark(name.upper(), iter(items)) == \
        jlmms.score_benchmark(name.upper(), iter(items)) == got


def test_parsers_match_jax():
    """Every reply through both parsers and the answer normalisation, and
    the quirks by name: the first standalone yes / no wins wherever it
    stands, two option texts found is wrong."""
    for reply in REPLIES:
        assert tlmms.parse_yes_no(reply) == jlmms.parse_yes_no(reply)
        assert tmmu_eval.normalize_answer(reply) == \
            jmmu_eval.normalize_answer(reply)
        for opts in OPTIONS:
            assert tlmms.parse_multi_choice(reply, opts) == \
                jlmms.parse_multi_choice(reply, opts)
        assert tlmms._gqa_normalize(reply) == jlmms._gqa_normalize(reply)
    assert tlmms.parse_yes_no("Not a cat, no") == "no"
    assert tlmms.parse_multi_choice("a red car or a blue boat",
                                    OPTIONS[0]) == ""


def test_mme_groups_by_question_id_as_jax():
    """acc+ groups by ``question_id`` before ``image``: ids unique per
    question make every question its own group (ADVICE.md's quirk)."""
    items = [{"question_id": f"q{i}", "image": "a.png", "answer": a,
              "prediction": p, "category": "existence"}
             for i, (a, p) in enumerate([("yes", "yes"), ("no", "yes")])]
    got = tlmms.score_mme(items)
    assert got == jlmms.score_mme(items)
    assert got["existence"]["acc_plus"] == 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_score_predictions_match_jax(seed):
    items = _items(seed)
    assert tmmu_eval.score_predictions(items) == \
        jmmu_eval.score_predictions(items)


def test_unknown_benchmark_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jlmms.score_benchmark("vqav2", [])
    with pytest.raises(ValueError) as got:
        tlmms.score_benchmark("vqav2", [])
    assert str(got.value) == str(want.value)


# -- the sweeps -----------------------------------------------------------------

class DummyPipeline:
    """Deterministic images a call, whatever the key or generator."""

    def __init__(self):
        self.calls = []

    def generate(self, prompts, rng):
        self.calls.append(list(prompts))
        return np.random.RandomState(len(self.calls)).uniform(
            -1, 1, (len(prompts), 8, 8, 3)).astype(np.float32)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _sweep_inputs(tmp_path, n_meta=5, n_dpg=3):
    meta = tmp_path / "meta.jsonl"
    meta.write_text("\n".join(json.dumps({"prompt": f"prompt {i}",
                                          "tag": "color", "i": i})
                              for i in range(n_meta)) + "\n\n")
    pdir = tmp_path / "prompts"
    pdir.mkdir()
    for i in range(n_dpg):
        (pdir / f"item{i}.txt").write_text(f"  a photo of thing {i}\n")
    (pdir / "notes.md").write_text("not a prompt")
    return str(meta), str(pdir)


@pytest.mark.parametrize("grid", [(0, 1), (0, 2), (1, 2), (2, 3)],
                         ids=lambda g: f"{g[0]}of{g[1]}")
def test_sweeps_match_jax(tmp_path, grid):
    device_id, num_devices = grid
    meta, pdir = _sweep_inputs(tmp_path)
    trees = []
    for name, mod in (("jax", jgeneval), ("port", tgeneval)):
        pipe = DummyPipeline()
        out = tmp_path / name
        mod.run_geneval_sweep(pipe, meta, str(out / "geneval"), batch_size=2,
                              device_id=device_id, num_devices=num_devices)
        mod.run_dpg_sweep(pipe, pdir, str(out / "dpg"), batch_size=4,
                          device_id=device_id, num_devices=num_devices)
        trees.append((_tree(out), pipe.calls))
    (want, want_calls), (got, got_calls) = trees
    assert got_calls == want_calls and got.keys() == want.keys()
    assert got == want
    assert any(k.endswith(".png") and k.startswith("dpg") for k in got)


def test_sweeps_shard_by_the_process_group(tmp_path):
    """Without device_id the port shards by torch.distributed's rank and
    world size (JAX: its process index and count); without a process
    group one shard holds everything."""
    import torch.distributed as dist

    meta, pdir = _sweep_inputs(tmp_path)
    with mock.patch.object(dist, "is_initialized", lambda: True), \
            mock.patch.object(dist, "get_rank", lambda: 1), \
            mock.patch.object(dist, "get_world_size", lambda: 2):
        tgeneval.run_geneval_sweep(DummyPipeline(), meta,
                                   str(tmp_path / "port"), batch_size=1)
    jgeneval.run_geneval_sweep(DummyPipeline(), meta, str(tmp_path / "jax"),
                               batch_size=1, device_id=1, num_devices=2)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port")) == ["00003", "00004"]
    pipe = DummyPipeline()
    tgeneval.run_dpg_sweep(pipe, pdir, str(tmp_path / "all"))
    assert len(pipe.calls) == 3


def test_to_pil_images_matches_jax():
    from showo_tpu.utils.image import to_pil_images as jpil
    from showo_tpu_torch.utils.image import to_pil_images as tpil

    x = np.random.default_rng(0).uniform(-1.2, 1.2, (3, 5, 7, 3)).astype(
        np.float32)
    for a, b in zip(tpil(x), jpil(x)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- DPG scoring --------------------------------------------------------------------

DPG_ROWS = [
    # the reference skips the FIRST data row (iterrows i == 0)
    ("skipme", 1, "0", "entity - junk", "junk?"),
    ("img_a", 1, "0", "entity - whole (dog)", "is there a dog?"),
    ("img_a", 2, "1", "attribute - color (dog, red)", "is the dog red?"),
    ("img_a", 3, "0", "entity - whole (tree)", "is there a tree?"),
    ("img_a", 4, "1,3", "relation - spatial (dog, tree, near)",
     "is the dog near the tree?"),
    ("img_b", 1, "0", "entity - whole (cat)", "is there a cat?"),
    ("img_b", 2, "1", "attribute - color (cat, black)", "is the cat black?"),
    ("img_c", 1, "0", "global - (photo)", "is this a photo?"),
]
DPG_ANSWERS = {"is there a dog?": "no", "is the dog red?": "yes",
               "is there a tree?": "yes", "is the dog near the tree?": "yes",
               "is there a cat?": "yes", "is the cat black?": "no",
               "is this a photo?": "yes"}


def _dpg_inputs(tmp_path):
    csv_path = tmp_path / "dpg_bench.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["item_id", "proposition_id", "dependency", "tuple",
                    "question_natural_language"])
        w.writerows(DPG_ROWS)
    root = tmp_path / "grids"
    root.mkdir()
    rng = np.random.default_rng(4)
    # img_zzz has no csv entry: its scoring fails and is skipped
    for name in ("img_a", "img_b", "img_c", "img_zzz"):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                        ).save(root / f"{name}.png")
    return str(csv_path), str(root)


def _crop_scorer(answers):
    """Answers that depend on the crop, so each crop scores its own."""
    def scorer(image, question):
        flip = int(np.asarray(image).mean()) % 2
        a = answers[question]
        return a if not flip else {"yes": "no", "no": "yes"}[a]
    return scorer


@pytest.mark.parametrize("grid", [(0, 1), (0, 2), (1, 2)],
                         ids=lambda g: f"{g[0]}of{g[1]}")
@pytest.mark.parametrize("pic_num", [1, 4])
def test_dpg_scoring_matches_jax(tmp_path, grid, pic_num):
    csv_path, root = _dpg_inputs(tmp_path)
    assert tdpg.prepare_dpg_data(csv_path) == jdpg.prepare_dpg_data(csv_path)
    outs, files = [], []
    for name, mod in (("jax", jdpg), ("port", tdpg)):
        res = str(tmp_path / f"{name}_results.txt")
        outs.append(mod.run_dpg_scoring(
            root, csv_path, _crop_scorer(DPG_ANSWERS), resolution=16,
            pic_num=pic_num, res_path=res, process_index=grid[0],
            process_count=grid[1]))
        files.append([open(p).read() for p in
                      (res, res.replace(".txt", "_detail.txt"))])
    assert outs[1] == outs[0]
    assert files[1] == files[0]
    if grid == (0, 1):
        assert outs[1]["n"] == 3 and "entity - whole" in outs[1]["l2"]


def test_dpg_dependency_zeroing_as_jax(tmp_path):
    csv_path, root = _dpg_inputs(tmp_path)
    qd = tdpg.prepare_dpg_data(csv_path)
    scorer = lambda image, q: DPG_ANSWERS[q]  # noqa: E731
    got = tdpg.compute_dpg_one_sample(qd, os.path.join(root, "img_a.png"),
                                      scorer, resolution=32)
    want = jdpg.compute_dpg_one_sample(jdpg.prepare_dpg_data(csv_path),
                                       os.path.join(root, "img_a.png"),
                                       scorer, resolution=32)
    assert got == want
    # the dog is absent: its colour and its relation are zeroed, the tree
    # survives; the returned scores are the ones before the zeroing
    assert got[0] == 0.25 and got[2] == {1: 0.0, 2: 1.0, 3: 1.0, 4: 1.0}


# -- FID ----------------------------------------------------------------------------

def _image_sets():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (8, 16, 16, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + 120, 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("pool", [2, 4, 8])
def test_random_projection_features_exact(pool):
    a, _ = _image_sets()
    np.testing.assert_array_equal(
        tfid.RandomProjectionExtractor(pool=pool, seed=3)(a),
        jfid.RandomProjectionExtractor(pool=pool, seed=3)(a))
    f = np.random.default_rng(1).uniform(-1, 1, (5, 16, 16, 3))
    np.testing.assert_array_equal(
        tfid.extract_features(f, tfid.RandomProjectionExtractor(), 2),
        jfid.extract_features(f, jfid.RandomProjectionExtractor(), 2))


def test_fid_math_matches_jax():
    a, b = _image_sets()
    feats = np.random.default_rng(2).normal(size=(30, 6))
    for got, want in zip(tfid.activation_statistics(feats),
                         jfid.activation_statistics(feats)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    mu, s = tfid.activation_statistics(feats)
    mu2, s2 = tfid.activation_statistics(feats[::-1] * 1.5 + 0.3)
    assert tfid.frechet_distance(mu, s, mu2, s2) == pytest.approx(
        jfid.frechet_distance(mu, s, mu2, s2), rel=1e-9, abs=0)
    ex_t, ex_j = (tfid.RandomProjectionExtractor(pool=4),
                  jfid.RandomProjectionExtractor(pool=4))
    same, apart = tfid.compute_fid(a, a, ex_t), tfid.compute_fid(a, b, ex_t)
    assert same == pytest.approx(jfid.compute_fid(a, a, ex_j), rel=1e-9)
    assert apart == pytest.approx(jfid.compute_fid(a, b, ex_j), rel=1e-9)
    assert abs(same) < 1e-9 < 1e-3 < apart
    with pytest.raises(ValueError, match="N>=2"):
        tfid.activation_statistics(feats[:1])


def test_fid_from_dirs_matches_jax(tmp_path):
    a, b = _image_sets()
    for name, imgs in (("a", a), ("b", b)):
        (tmp_path / name).mkdir()
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(tmp_path / name / f"{i}.png")
    args = (str(tmp_path / "a"), str(tmp_path / "b"))
    got = tfid.fid_from_dirs(*args, tfid.RandomProjectionExtractor(),
                             resolution=24)
    assert got == pytest.approx(jfid.fid_from_dirs(
        *args, jfid.RandomProjectionExtractor(), resolution=24), rel=1e-9)


def test_inception_extractor_is_gated():
    """Without torchvision (or its weights in the local cache) the
    extractor raises ImportError, which run_quality's CLI turns into a
    skipped FID step."""
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="torchvision"):
            tfid.TorchInceptionExtractor()
        return
    with mock.patch("torch.hub.get_dir", lambda: "/nonexistent/hub"), \
            pytest.raises(ImportError, match="never downloads"):
        tfid.TorchInceptionExtractor()


# -- the MMU eval sweep on real tiny pipelines ------------------------------

class _At:
    """A pipeline read at ``resolution`` (the tiny codecs' input size), its
    answers given ``kw`` (the injected VAE draw)."""

    def __init__(self, pipe, resolution, **kw):
        self.pipe, self.resolution, self.kw = pipe, resolution, kw

    def answer(self, image, question, rng):
        return self.pipe.answer(image, question, rng, **self.kw)

    def decode(self, toks):
        return self.pipe.decode(toks)


V1_VQ = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
             dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 1), z_channels=4)
# FakeTokenizer ids reach 1009: text vocab 1010, 16 codes, then mask
V1_PIPE = dict(vocab_size=1027, llm_vocab_size=1010,
               num_new_special_tokens=0, codebook_size=16, num_vq_tokens=16)
V1_PHI = dict(hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, max_position_embeddings=128)


@pytest.fixture(scope="module")
def v1_pair():
    """(JAX, port) v1 MMUPipeline on the same weights (x4 the init scale,
    so answers vary with the image), fp32, greedy."""
    jcfg = jshowo.ShowoConfig(**V1_PIPE, llm=jphi.PhiConfig(
        vocab_size=1027, **V1_PHI))
    jparams = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                           jshowo.init_showo_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    vq_cfg = jmv.VQConfig(**V1_VQ)
    vq_params = jmv.MagvitV2(vq_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"]
    kw = dict(max_new_tokens=5, top_k=1)
    jpipe = JaxMMUPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, jparams), vq_cfg=vq_cfg,
        vq_params=vq_params, uni_prompting=JaxPrompting(
            jfake.FakeTokenizer(), max_text_len=8), **kw)
    tcfg = tshowo.ShowoConfig(**V1_PIPE, llm=tphi.PhiConfig(
        vocab_size=1027, **V1_PHI))
    model = load_showo(tshowo.Showo(tcfg),
                       showo_state_dict(jparams, num_layers=2)).eval()
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**V1_VQ)),
                     magvit_state_dict(vq_params, vq_cfg))
    tpipe = MMUPipeline(model=model, vq=vq, uni_prompting=UniversalPrompting(
        FakeTokenizer(), max_text_len=8), **kw)
    return jpipe, tpipe


def _eval_inputs(tmp_path, n, benchmark):
    """``n`` crops of the in-tree image as PNGs and an eval jsonl over
    them with the benchmark's fields."""
    root = tmp_path / "images"
    root.mkdir(exist_ok=True)
    src = Image.open(TEST_IMAGE).convert("RGB")
    rng = np.random.default_rng(n)
    items = []
    for i in range(n):
        x, y = rng.integers(0, src.size[0] - 96, size=2)
        src.crop((int(x), int(y), int(x) + 96, int(y) + 80)).save(
            root / f"c{i}.png")
        item = {"image": f"c{i}.png", "question": f"is there a cat {i}",
                "answer": ["yes", "no"][i % 2]}
        if benchmark == "mme":
            item.update(question_id=f"c{i // 2}", category="existence")
        if benchmark == "mmmu":
            item.update(options=["a cat", "a dog"], answer="A")
        items.append(item)
    items[-1]["answer"] = ""       # carried, not scored
    path = tmp_path / "eval.jsonl"
    path.write_text("".join(json.dumps(it) + "\n" for it in items))
    return str(path), str(root)


def _mmu_eval_pair(jpipe, tpipe, tmp_path, benchmark, n, **kw):
    ej, root = _eval_inputs(tmp_path, n, benchmark)
    res = []
    for name, mod, pipe in (("jax", jmmu_eval, jpipe),
                            ("port", tmmu_eval, tpipe)):
        out = tmp_path / name
        metrics = mod.run_mmu_eval(pipe, ej, root, str(out),
                                   benchmark=benchmark, **kw)
        shard = kw.get("device_id", 0)
        files = [(out / f"predictions_{shard}.jsonl").read_text(),
                 json.loads((out / f"metrics_{shard}.json").read_text())]
        res.append((metrics, files))
    return res


@pytest.mark.parametrize("benchmark", [None, "pope", "mmmu"])
def test_run_mmu_eval_v1_token_exact(v1_pair, tmp_path, benchmark):
    jpipe, tpipe = v1_pair
    (want, want_files), (got, got_files) = _mmu_eval_pair(
        _At(jpipe, 8), _At(tpipe, 8), tmp_path, benchmark, 5,
        device_id=0, num_devices=1)
    assert got == want and got_files == want_files
    assert got_files[1] == got
    preds = [json.loads(ln) for ln in got_files[0].splitlines()]
    assert len(preds) == 5 and len({p["prediction"] for p in preds}) > 1


def test_run_mmu_eval_shard_as_jax(v1_pair, tmp_path):
    """Shard 1 of 2 over 5 items, and max_items, as JAX's; the port's
    default shard is the process group's (here none: 0 of 1)."""
    jpipe, tpipe = v1_pair
    (want, wf), (got, gf) = _mmu_eval_pair(
        _At(jpipe, 8), _At(tpipe, 8), tmp_path, "gqa", 5, device_id=1,
        num_devices=2, max_items=4)
    assert (got, gf) == (want, wf) and got["num"] == 2
    ej, root = _eval_inputs(tmp_path, 3, None)
    tmmu_eval.run_mmu_eval(_At(tpipe, 8), ej, root, str(tmp_path / "d"))
    assert sorted(os.listdir(tmp_path / "d")) == ["metrics_0.json",
                                                   "predictions_0.jsonl"]


@pytest.fixture(scope="module")
def v2_pair():
    """(JAX, port) Show-o2 MMUV2Pipeline on the same weights, fp32, greedy,
    fused; the stand-in Qwen tokenizer (with its decode) on both sides."""
    jcfg, tcfg = tiny_showo2_cfgs()
    params, vae_params = showo2_params(jcfg), _vae_params(VAE_TINY)
    kw = dict(max_new_tokens=4, top_k=1)
    jpipe = jmmu_v2.MMUV2Pipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params),
        vae_cfg=VAE_TINY, vae_params=jax.tree.map(jnp.asarray, vae_params),
        tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
        token_ids=inference_t2i_v2.FAKE_TOKEN_IDS, **kw)
    tpipe = MMUV2Pipeline(model=port_showo2(tcfg, jcfg, params),
                          vae=_port_vae(VAE_TINY, vae_params),
                          tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
                          token_ids=inference_t2i_v2.FAKE_TOKEN_IDS, **kw)
    return jpipe, tpipe, jcfg.llm.vocab_size


def test_run_mmu_eval_v2_token_exact(v2_pair, tmp_path):
    """MME over 4 items (two questions an id): the VAE's normal draw
    injected on both sides (JAX's patched, as tests/test_torch_mmu_v2.py
    does), the answers greedy."""
    jpipe, tpipe, vocab = v2_pair
    rng = np.random.default_rng(9)
    eps = rng.normal(size=(1, 16, 1, 8, 8)).astype(np.float32)
    gumbel = np.zeros((jpipe.max_new_tokens + 1, 1, vocab), np.float32)
    with _jax_injected(eps, gumbel):
        (want, wf), (got, gf) = _mmu_eval_pair(
            _At(jpipe, PIXELS), _At(tpipe, PIXELS, injected_eps=eps),
            tmp_path, "mme", 4, device_id=0, num_devices=1)
    assert got == want and gf == wf
    assert set(got) == {"existence", "total"}
    assert all(json.loads(ln)["prediction"] for ln in gf[0].splitlines())


def test_mmu_pipeline_scorer_matches_jax(v1_pair):
    """The DPG self-scorer on the tiny v1 pair, greedy: the same answer to
    every question on every crop (a tokenizer that decodes ids into words
    among yes / no, so that both mappings are met)."""
    jpipe, tpipe = v1_pair

    class Words:
        WORDS = ["Yes.", "no", "maybe", "yes,", "No!"]

        def decode(self, ids):
            return " ".join(self.WORDS[int(i) % 5] for i in ids)

    jscore = jdpg.MMUPipelineScorer(jpipe, Words(), resolution=8)
    tscore = tdpg.MMUPipelineScorer(tpipe, Words(), resolution=8)
    src = Image.open(TEST_IMAGE)
    got, want = [], []
    for i, box in enumerate([(0, 0, 64, 64), (100, 40, 300, 200),
                             (250, 250, 512, 512)]):
        crop = src.crop(box)
        for q in ("is there a cat?", f"is it red {i}?"):
            want.append(jscore(crop, q))
            got.append(tscore(crop, q))
    assert got == want and set(got) <= {"yes", "no", "maybe"}
    assert "yes" in got


# -- the one-command chain ----------------------------------------------------------

@pytest.fixture(scope="module")
def t2i_pair():
    """(JAX, port) tiny v1 T2IPipeline on the same weights, the JAX one as
    tests/test_quality_chain.py builds it."""
    jpipe = jax_tiny_t2i()
    tcfg = tshowo.ShowoConfig(
        vocab_size=jpipe.cfg.vocab_size,
        llm_vocab_size=jpipe.cfg.llm_vocab_size, num_new_special_tokens=0,
        codebook_size=16, num_vq_tokens=16,
        llm=tphi.PhiConfig(vocab_size=jpipe.cfg.vocab_size, hidden_size=64,
                           intermediate_size=128, num_layers=2, num_heads=4))
    # the unfused weights _tiny_pipeline draws (its pipeline fuses them)
    params = jshowo.init_showo_params(jpipe.cfg, jax.random.PRNGKey(0))
    model = load_showo(tshowo.Showo(tcfg), showo_state_dict(
        jax.tree.map(np.asarray, params), num_layers=2)).eval()
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**{
        f: getattr(VQ_TINY, f) for f in ("ch", "enc_ch_mult",
                                         "enc_num_res_blocks", "dec_ch_mult",
                                         "dec_num_res_blocks",
                                         "z_channels")})),
        magvit_state_dict(jpipe.vq_params, VQ_TINY))
    tpipe = T2IPipeline(model=model, vq=vq, uni_prompting=UniversalPrompting(
        FakeTokenizer(), max_text_len=8, cond_dropout_prob=0.0),
        guidance_scale=1.5, timesteps=2, max_seq_length=8, resolution=8)
    return jpipe, tpipe


def _chain_inputs(tmp_path):
    meta = tmp_path / "geneval.jsonl"
    meta.write_text("\n".join(json.dumps({"prompt": p, "tag": "single"})
                              for p in ["a cat", "a dog"]))
    pdir = tmp_path / "dpg_prompts"
    pdir.mkdir()
    (pdir / "sample.txt").write_text("a red square")
    csv_path = tmp_path / "dpg.csv"
    csv_path.write_text(
        "item_id,proposition_id,dependency,tuple,question_natural_language\n"
        "skipped,1,0,entity - whole (x),is there an x?\n"
        "sample,1,0,entity - whole (square),is there a red square?\n"
        "sample,2,1,attribute - color (square),is the square red?\n")
    rdir = tmp_path / "refs"
    rdir.mkdir()
    for i, c in enumerate([(200, 30, 30), (30, 200, 30), (30, 30, 200)]):
        Image.new("RGB", (12, 12), c).save(rdir / f"{i}.png")
    return dict(geneval_metadata=str(meta), dpg_prompts_dir=str(pdir),
                dpg_csv=str(csv_path), fid_ref_dir=str(rdir))


def _shape(x, root):
    """The summary with its output paths made relative and the FID value
    reduced to its type (the images differ: the draws do)."""
    if isinstance(x, dict):
        return {k: (type(v).__name__ if k == "value" else _shape(v, root))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v, root) for v in x]
    if isinstance(x, str) and x.startswith(root):
        return os.path.relpath(x, root)
    return x


def test_run_chain_matches_jax(t2i_pair, tmp_path):
    inputs = _chain_inputs(tmp_path)
    out = {}
    for name, mod, fid, pipe in (("jax", jrun, jfid, t2i_pair[0]),
                                 ("port", trun, tfid, t2i_pair[1])):
        root = str(tmp_path / name)
        summary = mod.run_chain(
            pipe, root, ["geneval", "dpg", "fid"],
            dpg_scorer=lambda im, q: "yes" if "red" in q else "no",
            fid_prompts=["a cat", "a dog", "a bird"],
            fid_extractor=fid.RandomProjectionExtractor(pool=2),
            batch_size=2, dpg_resolution=8, **inputs)
        with open(os.path.join(root, "quality_summary.json")) as f:
            assert json.load(f) == json.loads(json.dumps(summary))
        out[name] = (_shape(summary, root), sorted(_tree(root)))
    assert out["port"] == out["jax"]
    summary, files = out["port"]
    assert summary["fid"]["n_gen"] == 3 and summary["fid"]["n_ref"] == 3
    assert summary["dpg"]["result"]["n"] == 1
    assert "geneval/00001/samples/00001.png" in files


def test_run_chain_skips_as_jax(t2i_pair, tmp_path):
    """Absent inputs: every step skipped with JAX's reason, word for
    word; a DPG sweep without csv or scorer records why it did not
    score."""
    jpipe, tpipe = t2i_pair
    for kw in ({}, dict(geneval_metadata=str(tmp_path / "no.jsonl"),
                        dpg_prompts_dir="nowhere", fid_prompts=["a"],
                        fid_ref_dir=str(tmp_path))):
        want = jrun.run_chain(jpipe, str(tmp_path / "j"),
                              ["geneval", "dpg", "fid"], **kw)
        got = trun.run_chain(tpipe, str(tmp_path / "t"),
                             ["geneval", "dpg", "fid"], **kw)
        assert got == want
        assert all("skipped" in got[s] for s in ("geneval", "dpg", "fid"))
    inputs = _chain_inputs(tmp_path)
    kw = dict(dpg_prompts_dir=inputs["dpg_prompts_dir"], batch_size=1)
    want = jrun.run_chain(jpipe, str(tmp_path / "j2"), ["dpg"], **kw)
    got = trun.run_chain(tpipe, str(tmp_path / "t2"), ["dpg"], **kw)
    assert got["dpg"]["scoring_skipped"] == want["dpg"]["scoring_skipped"]


def test_build_scorer_as_jax(t2i_pair):
    """v1: an MMUPipeline on the t2i pipeline's own model (no second
    fusion), 16 new tokens, at the pipeline's resolution; v2: none."""
    _, tpipe = t2i_pair
    scorer = trun._build_scorer(None, "v1", tpipe)
    assert scorer.pipe.model is tpipe.model and scorer.pipe.vq is tpipe.vq
    assert scorer.pipe.max_new_tokens == 16 and scorer.resolution == 8
    assert scorer.pipe.param_fusion == "none"
    assert trun._build_scorer(None, "v2", tpipe) is None


# -- safety, assets, the VQ gate ----------------------------------------------------

def test_safety_checker_passes_through_as_jax():
    from showo_tpu.utils.safety import SafetyChecker as JaxSafety
    from showo_tpu_torch.utils.safety import SafetyChecker

    x = np.random.default_rng(0).uniform(-1, 1, (3, 8, 8, 3)).astype(
        np.float32)
    for path in (None, "no/such/checker"):
        got, flags = SafetyChecker(path)(x)
        want, want_flags = JaxSafety(path)(x)
        assert got is x and want is x
        assert flags == want_flags == [False] * 3


def test_validation_assets_match_jax(tmp_path):
    from showo_tpu.utils import assets as jassets
    from showo_tpu_torch.utils import assets as tassets

    assert tassets.validation_image() == jassets.validation_image() \
        == TEST_IMAGE
    own = tmp_path / "dog.png"
    own.write_bytes(b"")
    for preferred in (str(own), "no/such/dog.png"):
        assert tassets.validation_image(preferred) == \
            jassets.validation_image(preferred)
    for names in (("test_image.png",), ("inpainting", "mask.png"),
                  ("no", "such")):
        assert tassets.asset_path(*names) == jassets.asset_path(*names)


def _jax_vq_tool():
    spec = importlib.util.spec_from_file_location(
        "eval_vq_psnr", os.path.join(REPO, "tools", "eval_vq_psnr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_psnr_matches_the_jax_tool():
    tool = _jax_vq_tool()
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    for b in (a, a + 0.01, rng.uniform(-1, 1, a.shape)):
        assert vq_psnr.psnr(a, b) == tool.psnr(a, b)
    assert vq_psnr.psnr(a, a, peak=1.0) == tool.psnr(a, a, peak=1.0)


def test_vq_roundtrip_matches_jax():
    """get_code -> decode_code on the tiny codec of tests/test_torch_magvit
    .py: the codes exactly, the pixels at its atol 2e-4 / rtol 1e-3, and
    so the PSNR to 1e-3 dB."""
    dims = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
                dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 2), z_channels=4)
    jcfg = jmv.VQConfig(**dims)
    model = jmv.MagvitV2(jcfg)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 16, 16, 3)))["params"]
    from showo_tpu_torch.utils.image import image_transform

    pixels = image_transform(Image.open(TEST_IMAGE).convert("RGB"), 32)[None]
    codes = model.apply({"params": params}, jnp.asarray(pixels),
                        method=model.get_code)
    want = np.clip(np.asarray(model.apply({"params": params}, codes,
                                          method=model.decode_code)), -1, 1)
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**dims)),
                     magvit_state_dict(params, jcfg))
    np.testing.assert_array_equal(
        vq.get_code(torch.as_tensor(pixels)).numpy(), np.asarray(codes))
    got = vq_psnr.roundtrip(vq, pixels)
    assert got.shape == pixels.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert vq_psnr.psnr(pixels, got) == pytest.approx(
        _jax_vq_tool().psnr(pixels, want), abs=1e-3)


# -- the CLIs without JAX -------------------------------------------------------------

def _run_cli(module, args):
    """``python -m showo_tpu_torch.<module>`` in a subprocess; asserts that
    no jax, flax, JAX package or tools' tokenizer module was imported."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}] + {args!r}\n"
        f"runpy.run_module('showo_tpu_torch.{module}', run_name='__main__')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    return proc.stdout.splitlines()


T2I_TINY = [
    "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
    "dataset.preprocessing.max_seq_length=16", "generation_timesteps=2",
    "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
    "num_layers: 2, num_heads: 4}",
    "model.vq_model.dims={ch: 32, enc_ch_mult: [1, 1, 1, 1, 2], "
    "enc_num_res_blocks: [1, 1, 1, 1, 1], dec_ch_mult: [1, 1, 2], "
    "dec_num_res_blocks: [1, 1, 1]}"]


def test_run_quality_cli_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.evaluation.run_quality`` at a tiny size
    on the CPU: the GenEval sweep and FID with the smoke extractor over a
    prompt file; DPG skipped for its absent prompts, as the summary
    says."""
    inputs = _chain_inputs(tmp_path)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\n\na dog on a hill\na bird\n")
    out = tmp_path / "out"
    lines = _run_cli("evaluation.run_quality", [
        "config=configs/showo_demo_512x512.yaml", "device=cpu",
        "steps=geneval,dpg,fid", "fid_extractor=smoke", "batch_size=2",
        f"output_dir={out}", f"validation_prompts_file={prompts}",
        f"geneval_metadata={inputs['geneval_metadata']}",
        f"fid_ref_dir={inputs['fid_ref_dir']}"] + T2I_TINY)
    summary = json.loads(lines[-2])
    with open(out / "quality_summary.json") as f:
        assert json.load(f) == summary
    assert summary["geneval"]["prompts"] == 2
    assert summary["fid"]["n_gen"] == 3 and np.isfinite(
        summary["fid"]["value"])
    assert summary["dpg"] == {"skipped": "prompts dir not found: None"}
    assert len(os.listdir(out / "geneval" / "00001" / "samples")) == 2


def test_mmu_eval_cli_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.evaluation.mmu_eval`` on the v1 CLI
    pipeline at a tiny size (the codec downsamples 16x: 256 codes of the
    256x256 read), int8 through the plain version, GQA scoring."""
    ej, root = _eval_inputs(tmp_path, 3, "gqa")
    out = tmp_path / "out"
    lines = _run_cli("evaluation.mmu_eval", [
        "config=configs/showo_demo.yaml", "device=cpu", "int8=1",
        "max_new_tokens=3", f"eval_jsonl={ej}", f"image_root={root}",
        f"outdir={out}", "benchmark=gqa"] + T2I_TINY)
    metrics = json.loads(lines[-2])
    assert metrics == json.loads((out / "metrics_0.json").read_text())
    assert metrics["num"] == 2
    preds = (out / "predictions_0.jsonl").read_text().splitlines()
    assert len(preds) == 3


def test_mmu_eval_builds_the_v2_pipeline_as_jax():
    """``v2=1``: MMUV2Pipeline with the JAX CLI's keys (max_new_tokens 100,
    top_k 1 by default; no int8, even when asked)."""
    from showo_tpu_torch.config import load_config
    from test_torch_t2i_v2 import TINY_OVERRIDES

    config = load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"),
        TINY_OVERRIDES + ["v2=1", "int8=1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmmu_eval.build_pipeline(config)
    pipe = tmmu_eval.build_pipeline(config, "cpu")
    assert isinstance(pipe, MMUV2Pipeline)
    assert (pipe.max_new_tokens, pipe.top_k, pipe.quantize_int8) == (
        100, 1, False)
    v1 = tmmu_eval.build_pipeline(load_config(
        os.path.join(REPO, "configs", "showo_demo.yaml"),
        T2I_TINY + ["int8=1", "max_new_tokens=7"]), "cpu")
    assert isinstance(v1, MMUPipeline) and v1.quantize_int8
    assert v1.max_new_tokens == 7


def test_vq_psnr_cli_runs_without_jax():
    """``python -m showo_tpu_torch.evaluation.vq_psnr`` on the CPU at the
    released width (random init), at 32x32 to stay quick: one line in the
    JAX tool's format."""
    lines = _run_cli("evaluation.vq_psnr", ["device=cpu", "resolution=32"])
    line = [ln for ln in lines if ln.startswith("vq_roundtrip_psnr=")]
    assert len(line) == 1
    assert line[0].endswith(" dB (random-init, test_image.png @32)")
    assert np.isfinite(float(line[0].split("=")[1].split()[0]))


def test_no_kernel_launch_on_the_cpu(v1_pair, tmp_path):
    """The eval sweeps on CPU tensors reach no kernel."""
    before = sum(cuda_build.launches.values())
    ej, root = _eval_inputs(tmp_path, 2, None)
    tmmu_eval.run_mmu_eval(_At(v1_pair[1], 8), ej, root, str(tmp_path / "o"))
    assert sum(cuda_build.launches.values()) == before
