"""The v1 multimodal-understanding slice of showo_tpu_torch on the CPU:
nucleus filtering, the KV-cache AR decode, int8 serving, the discrete and
CLIP-ViT pipelines and the CLI.

* ``top_p_filter`` keeps exactly JAX's tokens; top-k then top-p through
  ``sample_logits`` picks JAX's token under the same (zero) noise.
* ``showo_mmu_generate`` is token-exact against the reference golden
  (tests/golden/ar_tiny.npz, as tests/test_ar.py) and against JAX under
  injected Gumbel noise, in every weight layout.
* Phi on JAX's int8 params: logits against JAX ``phi_forward`` on the same
  params.  JAX's ``_wk`` rounds ``w_i8 * scale`` to bf16 before the
  product; the port (as Pallas ``_i8_kernel``) scales the fp32 sum, so the
  two differ by up to half a bf16 ulp per weight: argmax agreement >= 0.95
  and max |difference| / peak <= 1e-2 (read on the CPU: agreement 1.0 in
  both dtypes, 1.8e-3 of the peak in fp32, 7.5e-3 in bf16, where the
  activations round to bf16 between the layers too).
* ``MMUPipeline.answer`` / ``answer_with_clip`` are token-exact against the
  JAX pipeline (fp32, unquantized, greedy), and ``build_pipeline`` runs on
  the CPU only when asked.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import magvit as jmv
from showo_tpu.models import phi as jphi
from showo_tpu.models import showo as jshowo
from showo_tpu.ops.masks import omni_mask_mmu as j_mask_mmu
from showo_tpu.pipelines.mmu import MMUPipeline as JaxMMUPipeline
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.sampling.ar import _sample_logits as j_sample
from showo_tpu.sampling.ar import top_p_filter as j_top_p
from showo_tpu.utils.torch_export import phi_state_dict, showo_state_dict
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops.masks import omni_mask_mmu
from showo_tpu_torch.pipelines.mmu import MMUPipeline
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.ar import sample_logits, top_p_filter
from showo_tpu_torch.utils.convert import (load_int8_params, load_magvit,
                                           load_showo, magvit_state_dict)
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "ar_tiny.npz")
TINY_PHI = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=4, max_position_embeddings=128)
GOLDEN_CFG = dict(vocab_size=120, llm_vocab_size=100,
                  num_new_special_tokens=3, codebook_size=16,
                  num_vq_tokens=9)
# int8 logits vs JAX: argmax agreement and max |diff| / peak (module doc)
INT8_AGREE, INT8_REL = 0.95, 1e-2


def _port_showo(cfg_kw, sd, w_clip=False, clip_dim=1024):
    cfg = tshowo.ShowoConfig(**cfg_kw, w_clip_vit=w_clip,
                             clip_feat_dim=clip_dim,
                             llm=tphi.PhiConfig(vocab_size=cfg_kw["vocab_size"],
                                                **TINY_PHI))
    return load_showo(tshowo.Showo(cfg), sd).eval()


# -- nucleus filtering and sampling ------------------------------------------

@pytest.mark.parametrize("top_p", [0.05, 0.3, 0.9, 0.999])
def test_top_p_mask_matches_jax(top_p):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 97)).astype(np.float32) * 3.0
    logits[1, 10:20] = logits[1, 9]              # ties keep their order
    want = np.asarray(j_top_p(jnp.asarray(logits), top_p))
    got = top_p_filter(torch.as_tensor(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  logits[np.isfinite(want)])


@pytest.mark.parametrize("top_k,top_p,temperature",
                         [(10, 0.8, 1.0), (None, 0.5, 0.7), (3, None, 1.3),
                          (1, None, 1.0)])
def test_sample_logits_matches_jax(top_k, top_p, temperature):
    """Temperature, top-k and top-p, then argmax under the same Gumbel
    noise: the same token as JAX ``_sample_logits``."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 50)).astype(np.float32) * 2.0
    g = rng.gumbel(size=(6, 50)).astype(np.float32)
    want = j_sample(jax.random.PRNGKey(0), jnp.asarray(logits), temperature,
                    top_k, gumbel=jnp.asarray(g), top_p=top_p)
    got = sample_logits(torch.as_tensor(logits), temperature, top_k,
                        gumbel=torch.as_tensor(g), top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_logits_draws_from_the_generator():
    """Without noise: a draw from the filtered softmax, the same for the
    same seed, never outside the top-k."""
    logits = torch.randn(8, 40, generator=torch.Generator().manual_seed(0))

    def draw(seed):
        return sample_logits(logits, 1.0, 5,
                             torch.Generator().manual_seed(seed))

    a = draw(3)
    assert torch.equal(a, draw(3))
    top5 = torch.topk(logits, 5).indices
    assert bool((top5 == a[:, None]).any(-1).all())


# -- AR decode -----------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("fusion", ["none", "qkv", "mlp"])
def test_mmu_generate_token_exact_vs_golden(golden, fusion):
    """As tests/test_ar.py: prefill + 6 cached decode steps, temperature
    0.9, top-k 12, the golden's Gumbel noise; in every weight layout."""
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    model = _port_showo(GOLDEN_CFG, sd)
    if fusion == "qkv":
        tphi.fuse_qkv(model.showo)
    elif fusion == "mlp":
        tphi.fuse_parallel_mlp(model.showo)
    bias = torch.where(torch.as_tensor(golden["bias"]) < 0, -1e9, 0.0)
    before = sum(cuda_build.launches.values())
    tokens, valid = tshowo.showo_mmu_generate(
        model, torch.as_tensor(golden["prompt"]), prompt_bias=bias,
        max_new_tokens=6, temperature=0.9, top_k=12,
        injected_gumbel=golden["gumbel"])
    np.testing.assert_array_equal(tokens[0].numpy(), golden["tokens"])
    assert bool(valid.all())
    assert sum(cuda_build.launches.values()) == before


@pytest.mark.parametrize("top_p", [None, 0.6])
def test_mmu_generate_token_exact_vs_jax(top_p):
    """Random weights (x4 the init scale), the mmu mask, 8 new tokens with
    top-k 20 / top-p, a mid-sequence eot: tokens and the valid mask equal
    JAX ``showo_mmu_generate``'s under the same noise."""
    jcfg = jshowo.ShowoConfig(**GOLDEN_CFG, llm=jphi.PhiConfig(
        vocab_size=120, **TINY_PHI))
    jparams = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                           jshowo.init_showo_params(jcfg,
                                                    jax.random.PRNGKey(5)))
    model = _port_showo(GOLDEN_CFG, phi_state_dict(jparams["showo"],
                                                   num_layers=2))
    prompt = np.array([[102, 100, 110, 111, 112, 113, 101, 5, 6, 7]])
    rng = np.random.default_rng(2)
    g = rng.gumbel(size=(9, 1, 120)).astype(np.float32)
    kw = dict(max_new_tokens=8, temperature=1.0, top_k=20, top_p=top_p)
    def jax_run(eot):
        return jshowo.showo_mmu_generate(
            jcfg, jax.tree.map(jnp.asarray, jparams), jnp.asarray(prompt),
            jax.random.PRNGKey(0),
            prompt_bias=j_mask_mmu(jnp.asarray(prompt), 101),
            injected_gumbel=jnp.asarray(g), eot_token=eot, **kw)

    eot = int(np.asarray(jax_run(None)[0])[0, 3])   # a token it emits
    jt, jv = jax_run(eot)
    ids = torch.as_tensor(prompt)
    tt, tv = tshowo.showo_mmu_generate(
        model, ids, prompt_bias=omni_mask_mmu(ids, 101), eot_token=eot,
        injected_gumbel=g, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not bool(tv.all())                # the eot cut the answer


# -- int8 serving ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_vs_jax(dtype):
    """Phi on JAX's int8 params (fused, quantized by JAX and loaded with
    ``load_int8_params``) against JAX ``phi_forward`` on the same params;
    tolerance and reason in the module doc."""
    jcfg = jphi.PhiConfig(vocab_size=128, **TINY_PHI)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jphi.init_phi_params(jcfg, jax.random.PRNGKey(0))
    jq = jphi.quantize_int8(jphi.fuse_parallel_mlp(
        jax.tree.map(lambda x: x.astype(jdt), jp)))
    sd = phi_state_dict(jax.tree.map(np.asarray, jp), num_layers=2)
    model = load_showo(tshowo.Showo(tshowo.ShowoConfig(
        vocab_size=128, llm=tphi.PhiConfig(vocab_size=128, **TINY_PHI))),
        sd).showo.to(tdt)
    tphi.quantize_int8(tphi.fuse_parallel_mlp(model))
    load_int8_params(model, jq)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                        128))
    want, _ = jphi.phi_forward(jcfg, jq, input_ids=jnp.asarray(ids))
    with torch.no_grad():
        got, _ = model(input_ids=torch.as_tensor(ids))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    agree = (want.argmax(-1) == got.argmax(-1)).mean()
    rel = np.abs(want - got).max() / np.abs(want).max()
    assert agree >= INT8_AGREE, agree
    assert rel <= INT8_REL, rel


def test_int8_cached_decode_matches_full_forward():
    """On an int8 model the prefill + one cached step gives the last row
    of the full forward (the cache and the quantized matmuls agree), and
    greedy decode stays in the vocabulary."""
    cfg = tshowo.ShowoConfig(vocab_size=128, llm_vocab_size=100,
                             num_new_special_tokens=0, codebook_size=16,
                             num_vq_tokens=4,
                             llm=tphi.PhiConfig(vocab_size=128, **TINY_PHI))
    model = tshowo.init_showo(cfg, torch.Generator().manual_seed(0))
    tphi.quantize_int8(tphi.fuse_parallel_mlp(model.showo))
    ids = torch.tensor([[102, 100, 110, 111, 112, 113, 101, 5, 6]])
    bias = omni_mask_mmu(ids, eoi_id=101)
    with torch.no_grad():
        full, _ = model.showo(input_ids=ids, attention_bias=bias)
        cache = tphi.KVCache.zeros(cfg.llm, 1, 9)
        model.showo(input_ids=ids[:, :8], attention_bias=bias[:, :, :8],
                    cache=cache)
        step, _ = model.showo(input_ids=ids[:, 8:],
                              attention_bias=bias[:, :, 8:], cache=cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)
    toks, _ = tshowo.showo_mmu_generate(model, ids, prompt_bias=bias,
                                        max_new_tokens=4, top_k=1)
    assert toks.shape == (1, 4) and int(toks.max()) < 128


# -- the pipeline against JAX ------------------------------------------------

VQ_DIMS = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
               dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 1), z_channels=4)
# FakeTokenizer ids reach 1009: text vocab 1010, 16 codes, then mask
PIPE = dict(vocab_size=1027, llm_vocab_size=1010, num_new_special_tokens=0,
            codebook_size=16, num_vq_tokens=16)
CLIP_DIM, PATCHES = 32, 5


@pytest.fixture(scope="module")
def weights():
    jcfg = jshowo.ShowoConfig(**PIPE, w_clip_vit=True, clip_feat_dim=CLIP_DIM,
                              llm=jphi.PhiConfig(vocab_size=1027, **TINY_PHI))
    jparams = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                           jshowo.init_showo_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    vq_params = jmv.MagvitV2(jmv.VQConfig(**VQ_DIMS)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"]
    return jcfg, jparams, vq_params


def _pipelines(weights, fusion, max_new_tokens=6):
    jcfg, jparams, vq_params = weights
    kw = dict(max_new_tokens=max_new_tokens, top_k=1, param_fusion=fusion)
    jpipe = JaxMMUPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, jparams),
        vq_cfg=jmv.VQConfig(**VQ_DIMS), vq_params=vq_params,
        uni_prompting=JaxPrompting(jfake.FakeTokenizer(), max_text_len=8),
        **kw)
    model = _port_showo(PIPE, showo_state_dict(jparams, num_layers=2),
                        w_clip=True, clip_dim=CLIP_DIM)
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, jmv.VQConfig(**VQ_DIMS)))
    tpipe = MMUPipeline(model=model, vq=vq, uni_prompting=UniversalPrompting(
        FakeTokenizer(), max_text_len=8), **kw)
    return jpipe, tpipe


@pytest.mark.parametrize("fusion", ["mlp", "none"])
def test_answer_token_exact_vs_jax(weights, fusion):
    """The discrete path: MAGVIT codes in the prompt, the mmu mask, greedy
    decode; the same prompt and tokens as the JAX pipeline."""
    jpipe, tpipe = _pipelines(weights, fusion)
    image = np.random.default_rng(3).uniform(-1, 1, (8, 8, 3)).astype(
        np.float32)
    q = "what is in the picture"
    ids, bias = tpipe.prompt(image, q)
    assert ids.shape == (1, 2 + 16 + 2 + 7)
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(j_mask_mmu(jnp.asarray(ids.numpy()),
                                            eoi_id=tpipe.uni_prompting
                                            .sptids["<|eoi|>"])))
    want = jpipe.answer(image, q, jax.random.PRNGKey(0))
    got = tpipe.answer(image, q)
    assert got == want and len(got) > 0


def test_answer_with_clip_token_exact_vs_jax(weights):
    """The CLIP-ViT path: features projected by mm_projector and spliced
    after [mmu] system [soi]; greedy tokens equal the JAX pipeline's."""
    jpipe, tpipe = _pipelines(weights, "mlp")
    feats = np.random.default_rng(4).normal(size=(PATCHES, CLIP_DIM)).astype(
        np.float32)
    system = np.asarray(FakeTokenizer()(["be helpful and polite"])
                        ["input_ids"][0], np.int64)
    embeds, bias = tpipe.clip_prompt(feats, "describe it", system)
    assert embeds.shape[1] == 1 + len(system) + 2 + PATCHES + 4
    want = jpipe.answer_with_clip(feats, "describe it", system,
                                  jax.random.PRNGKey(0))
    got = tpipe.answer_with_clip(feats, "describe it", system)
    assert got == want and len(got) > 0


def test_int8_pipeline_answers(weights):
    """``quantize_int8=True``: every matmul of the fused layout and the
    lm_head are Int8Linear; both paths answer with tokens of the
    vocabulary (on the CPU through the plain version, no launch)."""
    _, tpipe = _pipelines(weights, "mlp")
    pipe = MMUPipeline(model=tpipe.model, vq=tpipe.vq,
                       uni_prompting=tpipe.uni_prompting, max_new_tokens=5,
                       quantize_int8=True)
    phi = pipe.model.showo
    assert all(isinstance(m, tphi.Int8Linear)
               for layer in phi.model.layers for m in (layer.win, layer.wout))
    assert isinstance(phi.lm_head, tphi.Int8Linear)
    before = sum(cuda_build.launches.values())
    toks = pipe.answer(np.zeros((8, 8, 3), np.float32), "what is this")
    toks += pipe.answer_with_clip(np.ones((PATCHES, CLIP_DIM), np.float32),
                                  "and this", np.array([11, 12]))
    assert all(0 <= t < PIPE["vocab_size"] for t in toks)
    assert sum(cuda_build.launches.values()) == before


def test_unknown_fusion_raises(weights):
    _, tpipe = _pipelines(weights, "none")
    with pytest.raises(ValueError, match="param_fusion"):
        MMUPipeline(model=tpipe.model, vq=tpipe.vq,
                    uni_prompting=tpipe.uni_prompting, param_fusion="win")


def test_image_transforms_match_jax():
    """The port's copies of the image preprocessing give the JAX package's
    arrays bit for bit (a non-square image, so the crop matters)."""
    from PIL import Image

    from showo_tpu.utils import image as jimage
    from showo_tpu_torch.utils import image as timage

    rng = np.random.default_rng(6)
    pil = Image.fromarray(rng.integers(0, 256, (45, 70, 3), dtype=np.uint8))
    np.testing.assert_array_equal(timage.image_transform(pil, 32),
                                  jimage.image_transform(pil, 32))
    np.testing.assert_array_equal(timage.clip_image_transform(pil, 28),
                                  jimage.clip_image_transform(pil, 28))


# -- the entry points ------------------------------------------------------------

TINY_OVERRIDES = [
    "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
    "dataset.preprocessing.max_seq_length=16",
    "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
    "num_layers: 2, num_heads: 4}",
    "model.vq_model.dims={ch: 32, enc_ch_mult: [1, 1, 2], "
    "enc_num_res_blocks: [1, 1, 1], dec_ch_mult: [1, 1, 2], "
    "dec_num_res_blocks: [1, 1, 1]}",
    "model.showo.clip_vit={hidden_size: 32, intermediate_size: 64, "
    "num_heads: 4, num_layers: 2, image_size: 28, patch_size: 14}",
]


def test_build_pipeline_needs_the_card_unless_cpu_is_asked():
    """CUDA by default: without a card build_pipeline raises; device="cpu"
    builds the int8 pipeline, fp32, on the CPU."""
    from showo_tpu_torch import inference_mmu
    from showo_tpu_torch.config import load_config

    config = load_config(os.path.join(REPO, "configs", "showo_demo.yaml"),
                         TINY_OVERRIDES + ["int8=1", "max_new_tokens=3",
                                           "top_k=2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            inference_mmu.build_pipeline(config)
    pipe = inference_mmu.build_pipeline(config, device="cpu")
    assert pipe.quantize_int8 and pipe.max_new_tokens == 3
    assert pipe.top_k == 2 and pipe.top_p is None
    assert isinstance(pipe.model.showo.lm_head, tphi.Int8Linear)
    assert pipe.model.showo.model.embed_tokens.weight.dtype == torch.float32


@pytest.mark.parametrize("config_file", ["showo_demo.yaml",
                                         "showo_demo_w_clip_vit.yaml"])
def test_cli_runs_without_jax(tmp_path, config_file):
    """``python -m showo_tpu_torch.inference_mmu`` at a tiny size answers
    every question for every image of ``mmu_image_root`` (discrete path, or
    the CLIP-ViT path with a random tower), int8, and imports no jax, no
    JAX package and not the tools' tokenizer."""
    from PIL import Image

    root = tmp_path / "images"
    root.mkdir()
    for name in ("b.png", "a.jpg"):
        Image.new("RGB", (40, 30), (90, 20, 200)).save(root / name)
    (root / "notes.txt").write_text("not an image")
    args = [f"config=configs/{config_file}", "device=cpu", "int8=1",
            "max_new_tokens=4", f"mmu_image_root={root}",
            "question=What is it? *** Is it cute?"] + TINY_OVERRIDES
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['inference_mmu'] + {args!r}\n"
        "runpy.run_module('showo_tpu_torch.inference_mmu', "
        "run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'showo_tpu', 'fake_tokenizer'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    answers = [ln for ln in proc.stdout.splitlines() if "User:" in ln]
    assert [a.split("]")[0] for a in answers] == ["[a.jpg"] * 2 + ["[b.png"] * 2
