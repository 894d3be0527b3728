"""The v1 text-to-image slice of showo_tpu_torch, end to end, on the CPU.

* Prefix-cached and uncached MaskGIT with injected Gumbel noise are
  token-exact against the reference golden (tests/golden/maskgit_tiny.npz),
  on the dense route and every kernel route (packed, omni, decode, fused,
  streaming; uncached fused falls through to the omni kernel).
* The pipeline (prompting, omni mask, cached MaskGIT with CFG through the
  packed route, code clamp, MAGVIT decode) matches the JAX package fed
  the same weights and noise: inputs bit-exact, tokens exact, images at
  atol 2e-4 / rtol 1e-3 (the MAGVIT tolerance of tests/test_magvit.py).
  JAX runs its Pallas kernel in interpret mode.
  The port builds its layout with its own prompting and tokenizer.
* The CLI runs in a subprocess, writes PNGs, and never imports jax or the
  JAX package.
fp32 throughout.
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import magvit as jmv
from showo_tpu.models import phi as jphi
from showo_tpu.models import showo as jshowo
from showo_tpu.ops import flash_attention as jfa
from showo_tpu.pipelines.t2i import T2IPipeline as JaxT2IPipeline
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.utils.torch_export import phi_state_dict
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.pipelines.t2i import T2IPipeline, route_attention
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.utils.convert import (load_magvit, load_showo,
                                           magvit_state_dict)
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from tests.test_torch_phi import jax_kernels_interpreted, spy_route

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "maskgit_tiny.npz")
TINY_PHI = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=4, max_position_embeddings=128)
GOLDEN_CFG = tshowo.ShowoConfig(
    vocab_size=120, llm_vocab_size=100, num_new_special_tokens=3,
    codebook_size=16, num_vq_tokens=9,
    llm=tphi.PhiConfig(vocab_size=120, **TINY_PHI))


def _interpret_packed():
    """Run the JAX packed kernel in interpret mode (as
    tests/test_maskgit_cached_pallas.py does for the head-major one)."""
    orig = jfa.omni_attention_packed

    def interp(*args, **kw):
        kw["interpret"] = True
        kw.setdefault("block_q", 8)
        return orig(*args, **kw)

    return mock.patch.object(jfa, "omni_attention_packed", interp)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
@pytest.mark.parametrize("route", ["dense", "packed", "omni", "decode",
                                   "fused", "streaming"])
def test_maskgit_token_exact_vs_golden(golden, cached, route):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    model = load_showo(tshowo.Showo(GOLDEN_CFG), sd).eval()
    if route == "fused":
        # the one-kernel step reads the win projection (as JAX's
        # tests/test_fused_decode.py fuses the params)
        tphi.fuse_parallel_mlp(model.showo)
    bias = torch.where(torch.as_tensor(golden["bias"]) < 0, -1e9, 0.0)
    gen = (tshowo.showo_t2i_generate_cached if cached
           else tshowo.showo_t2i_generate)
    before = sum(cuda_build.launches.values())
    tokens = gen(model, torch.as_tensor(golden["input_ids"]),
                 uncond_input_ids=torch.as_tensor(golden["uncond_ids"]),
                 attention_bias=bias, guidance_scale=1.75, temperature=1.1,
                 timesteps=4, max_seq_length=5,
                 injected_noise=(golden["g_sample"], golden["g_conf"]),
                 attn_impl=route, pad_id=99, soi_id=101, eoi_id=102)
    np.testing.assert_array_equal(tokens.numpy(), golden["tokens"])
    # CPU tensors never reach a kernel
    assert sum(cuda_build.launches.values()) == before


def test_maskgit_generator_noise_is_seeded(golden):
    """Without injected noise the sampler draws from the torch.Generator:
    the same seed gives the same tokens, all within the codebook."""
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    model = load_showo(tshowo.Showo(GOLDEN_CFG), sd).eval()
    bias = torch.where(torch.as_tensor(golden["bias"]) < 0, -1e9, 0.0)

    def run(seed):
        return tshowo.showo_t2i_generate_cached(
            model, torch.as_tensor(golden["input_ids"]),
            torch.Generator().manual_seed(seed),
            uncond_input_ids=torch.as_tensor(golden["uncond_ids"]),
            attention_bias=bias, guidance_scale=1.75, timesteps=4,
            max_seq_length=5)

    a, b = run(7), run(7)
    assert torch.equal(a, b)
    assert a.shape == (2, 9) and int(a.min()) >= 0 and int(a.max()) < 16


# -- the pipeline against the JAX package ----------------------------------

PROMPTS = ["a red cat", "an old stone bridge over water"]
VQ_DIMS = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
               dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 2), z_channels=4)
# FakeTokenizer ids reach 1009: text vocab 1010, then 16 codes, then mask
PIPE = dict(vocab_size=1027, llm_vocab_size=1000, num_new_special_tokens=10,
            codebook_size=16, num_vq_tokens=16)
STEPS, MAX_SEQ = 4, 8


@pytest.fixture(scope="module")
def pipelines():
    jcfg = jshowo.ShowoConfig(**PIPE, llm=jphi.PhiConfig(vocab_size=1027,
                                                         **TINY_PHI))
    # x4 the init scale so the logits carry structure beyond the noise
    jparams = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                           jshowo.init_showo_params(jcfg, jax.random.PRNGKey(0)))
    vq_params = jmv.MagvitV2(jmv.VQConfig(**VQ_DIMS)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"]
    kw = dict(guidance_scale=1.75, timesteps=STEPS, max_seq_length=MAX_SEQ)
    jpipe = JaxT2IPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, jparams), resolution=8,
        vq_cfg=jmv.VQConfig(**VQ_DIMS), vq_params=vq_params,
        uni_prompting=JaxPrompting(jfake.FakeTokenizer(),
                                   max_text_len=MAX_SEQ), **kw)

    tcfg = tshowo.ShowoConfig(**PIPE, llm=tphi.PhiConfig(vocab_size=1027,
                                                         **TINY_PHI))
    model = load_showo(tshowo.Showo(tcfg),
                       phi_state_dict(jparams["showo"], num_layers=2)).eval()
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, jmv.VQConfig(**VQ_DIMS)))
    tpipe = T2IPipeline(
        model=model, vq=vq, attn_impl="packed",
        uni_prompting=UniversalPrompting(FakeTokenizer(),
                                         max_text_len=MAX_SEQ), **kw)
    return jpipe, tpipe


def test_pipeline_inputs_bit_exact(pipelines):
    jpipe, tpipe = pipelines
    image_tokens = np.full((2, 16), 1026, np.int64)
    jids, juncond, jbias = jpipe._build_inputs(PROMPTS, image_tokens)
    tids, tuncond, tbias = tpipe.build_inputs(PROMPTS, image_tokens)
    assert int((tids == 1000).sum()) > 0  # the layout is left-padded
    for j, t in ((jids, tids), (juncond, tuncond), (jbias, tbias)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pipeline_vs_jax(pipelines):
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(0)
    g_sample = rng.gumbel(size=(STEPS, 2, 16, 16)).astype(np.float32)
    g_conf = rng.gumbel(size=(STEPS, 2, 16)).astype(np.float32)

    image_tokens = np.full((2, 16), 1026, np.int64)
    ids, uncond, bias = jpipe._build_inputs(PROMPTS, image_tokens)
    sp = jpipe.uni_prompting.sptids
    with _interpret_packed():
        jcodes = jshowo.showo_t2i_generate_cached(
            jpipe.cfg, jpipe.params, ids, jax.random.PRNGKey(0),
            uncond_input_ids=uncond, attention_bias=bias,
            guidance_scale=1.75, temperature=1.0, timesteps=STEPS,
            max_seq_length=MAX_SEQ,
            injected_noise=(jnp.asarray(g_sample), jnp.asarray(g_conf)),
            use_pallas_attention="pallas_packed", pad_id=sp["<|pad|>"],
            soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"])
    jcodes = jnp.clip(jcodes, 0, 15)
    jimages = np.clip(np.asarray(jpipe._decode(jpipe.vq_params, jcodes)),
                      -1.0, 1.0)

    assert tpipe.attn_route == "packed"
    tcodes = tpipe.generate_codes(PROMPTS, injected_noise=(g_sample, g_conf))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    timages = tpipe.generate(PROMPTS, injected_noise=(g_sample, g_conf))
    assert timages.shape == (2, 8, 8, 3) and timages.dtype == np.float32
    np.testing.assert_allclose(timages, jimages, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("route", ["omni", "decode", "fused", "streaming"])
def test_pipeline_routes_vs_jax(pipelines, route):
    """The pipeline's codes on each new kernel route, on the weights of
    the packed pipeline, equal the JAX pipeline's codes on the same route
    (its Pallas kernels in interpret mode) under the same noise."""
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(1)
    g_sample = rng.gumbel(size=(STEPS, 2, 16, 16)).astype(np.float32)
    g_conf = rng.gumbel(size=(STEPS, 2, 16)).astype(np.float32)
    ids, uncond, bias = jpipe._build_inputs(
        PROMPTS, np.full((2, 16), 1026, np.int64))
    sp = jpipe.uni_prompting.sptids
    with jax_kernels_interpreted():
        jcodes = jshowo.showo_t2i_generate_cached(
            jpipe.cfg, jpipe.params, ids, jax.random.PRNGKey(0),
            uncond_input_ids=uncond, attention_bias=bias,
            guidance_scale=1.75, temperature=1.0, timesteps=STEPS,
            max_seq_length=MAX_SEQ,
            injected_noise=(jnp.asarray(g_sample), jnp.asarray(g_conf)),
            use_pallas_attention=tphi.ATTN_ROUTES[route],
            pad_id=sp["<|pad|>"], soi_id=sp["<|soi|>"],
            eoi_id=sp["<|eoi|>"])
    pipe = T2IPipeline(model=tpipe.model, vq=tpipe.vq,
                       uni_prompting=tpipe.uni_prompting, attn_impl=route,
                       guidance_scale=1.75, timesteps=STEPS,
                       max_seq_length=MAX_SEQ)
    assert pipe.attn_route == route
    with spy_route(route) as spy:
        tcodes = pipe.generate_codes(PROMPTS,
                                     injected_noise=(g_sample, g_conf))
    assert spy.call_count == STEPS * 2          # steps x layers
    np.testing.assert_array_equal(tcodes.numpy(),
                                  np.clip(np.asarray(jcodes), 0, 15))


def test_build_pipeline_takes_the_route():
    """``build_pipeline(config, device, attn_impl=...)`` builds the
    pipeline on that route (tiny dims, random weights)."""
    from showo_tpu_torch import inference_t2i
    from showo_tpu_torch.config import load_config

    config = load_config(os.path.join(REPO, "configs",
                                      "showo_demo_512x512.yaml"), [
        "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
        "dataset.preprocessing.max_seq_length=16", "generation_timesteps=2",
        "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
        "num_layers: 2, num_heads: 4}",
        "model.vq_model.dims={ch: 32, dec_ch_mult: [1, 1, 2], "
        "dec_num_res_blocks: [1, 1, 1]}"])
    pipe = inference_t2i.build_pipeline(config, torch.device("cpu"),
                                        attn_impl="fused")
    assert pipe.attn_route == "fused"
    with spy_route("fused") as spy:
        codes = pipe.generate_codes(["a cat"],
                                    torch.Generator().manual_seed(0))
    assert spy.call_count == 2 * 2
    assert codes.shape == (1, 16)
    assert inference_t2i.build_pipeline(
        config, torch.device("cpu")).attn_route == "dense"


def test_build_pipeline_takes_the_streaming_route():
    """``build_pipeline(..., attn_impl="streaming")``: every layer of every
    cached step goes through the K-blocked kernel's wrapper."""
    from showo_tpu_torch import inference_t2i
    from showo_tpu_torch.config import load_config

    config = load_config(os.path.join(REPO, "configs",
                                      "showo_demo_512x512.yaml"), [
        "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
        "dataset.preprocessing.max_seq_length=16", "generation_timesteps=2",
        "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
        "num_layers: 2, num_heads: 4}",
        "model.vq_model.dims={ch: 32, dec_ch_mult: [1, 1, 2], "
        "dec_num_res_blocks: [1, 1, 1]}"])
    pipe = inference_t2i.build_pipeline(config, torch.device("cpu"),
                                        attn_impl="streaming")
    assert pipe.attn_route == "streaming"
    with spy_route("streaming") as spy:
        images = pipe.generate(["a cat", "a dog"],
                               torch.Generator().manual_seed(0))
    assert spy.call_count == 2 * 2
    assert images.shape == (2, 16, 16, 3) and np.isfinite(images).all()


def test_auto_route_follows_the_jax_pipeline():
    assert route_attention("auto", 1024) == "packed"
    assert route_attention("auto", 256) == "dense"
    assert route_attention("dense", 1024) == "dense"


@pytest.mark.parametrize("route", ["packed", "omni", "decode", "fused",
                                   "streaming"])
def test_named_routes_pass_through(route):
    assert route_attention(route, 1024) == route
    assert route_attention(route, 256) == route


def test_route_names_are_checked():
    """JAX impl strings raise, with the port's name in the message;
    ``streaming`` (which used to raise) is a route of the pipeline now,
    and ``trainable`` is for training only."""
    with pytest.raises(ValueError, match="pallas_fused"):
        route_attention("pallas_fused", 1024)
    with pytest.raises(ValueError, match="'streaming'"):
        route_attention("pallas_streaming", 1024)
    assert route_attention("streaming", 1024) == "streaming"
    with pytest.raises(ValueError, match="training"):
        route_attention("trainable", 1024)


def test_cli_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.inference_t2i`` at a tiny size writes one
    PNG per prompt; neither it nor any module of the package imports jax,
    flax, the JAX package or the tools' tokenizer."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\na red dog on a hill\nthird prompt\n")
    out = tmp_path / "out"
    args = [
        "config=configs/showo_demo_512x512.yaml", "mode=t2i", "batch_size=2",
        "device=cpu", f"output_dir={out}", f"validation_prompts_file={prompts}",
        "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
        "dataset.preprocessing.max_seq_length=16", "generation_timesteps=3",
        "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
        "num_layers: 2, num_heads: 4}",
        "model.vq_model.dims={ch: 32, dec_ch_mult: [1, 1, 2], "
        "dec_num_res_blocks: [1, 1, 1]}",
    ]
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import showo_tpu_torch\n"
        "for m in pkgutil.walk_packages(showo_tpu_torch.__path__, "
        "'showo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"sys.argv = ['inference_t2i'] + {args!r}\n"
        "runpy.run_module('showo_tpu_torch.inference_t2i', "
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
    assert sorted(p.name for p in out.iterdir()) == [
        "t2i_00000.png", "t2i_00001.png", "t2i_00002.png"]
