"""The Show-o2 text-to-image slice of showo_tpu_torch, end to end, on the
CPU (fp32), at the sizes of tests/test_t2i_v2_pipeline.py.

* The pipeline against the JAX ``T2IV2Pipeline`` on the same weights
  (carried by ``showo2_state_dict`` and ``wan_vae_state_dict``) and the
  same injected z, 3 Euler steps with CFG 5.0, on the ``dense`` route
  (JAX ``auto`` at 17 image tokens) and on ``packed`` (JAX
  ``pallas_packed``, its kernel in interpret mode): token rows and spans
  bit-exact, latents within atol 1e-4 (velocities agree to ~2e-5 and CFG
  multiplies their difference by 5), images within atol 1e-4 / rtol 1e-3
  (the decoder's tolerance against its golden).
* ``build_pipeline`` routes, counts its kernel wrapper's calls, raises
  without a card unless asked for the CPU; the samplers heun and dopri5
  and ``prefix_cache=True`` (which used to raise) match JAX's pipeline;
  the CLI writes PNGs without importing jax or the JAX package.
* On the card: the pipeline at real head dims (128 in the LLM, 64 in the
  DiT), packed against dense latents, with the kernel's launch count.
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

from showo_tpu.pipelines.t2i_v2 import T2IV2Pipeline as JaxPipeline
from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu.show_o2.formats import prepare_gen_input
from showo_tpu.show_o2.masks import omni_attn_mask
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.config import load_config
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.pipelines.t2i_v2 import T2IV2Pipeline, route_attention
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.utils.convert import load_wan_vae, wan_vae_state_dict
from test_t2i_v2_pipeline import IDS, VAE_TINY, Tok
from test_torch_show_o2 import (_jax_packed_interpreted, port_showo2,
                                      showo2_params, tiny_showo2_cfgs)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a cat", "an old stone bridge over water"]
STEPS = 3

# the CLI's tiny override set: the v2 1.5B demo config cut to the sizes of
# tests/test_t2i_v2_pipeline.py (random weights, the stand-in tokenizer)
TINY_OVERRIDES = [
    "model.showo.hidden_size=64", "model.showo.llm_vocab_size=1100",
    "model.showo.llm_intermediate_size=128", "model.showo.llm_num_layers=2",
    "model.showo.llm_num_heads=4", "model.showo.llm_num_kv_heads=2",
    "model.showo.llm_head_dim=16", "model.showo.clip_latent_dim=48",
    "model.showo.siglip={hidden_size: 48, intermediate_size: 96, "
    "num_heads: 4, num_layers: 2, num_positions: 16}",
    "model.showo.dit={hidden_size: 96, intermediate_size: 192, "
    "num_heads: 4, num_kv_heads: 2, head_dim: 24}",
    "model.showo.num_diffusion_layers=2",
    "model.showo.image_latent_height=8", "model.showo.image_latent_width=8",
    "model.vae_model.dims={dim: 16, dim_mult: [1, 2], num_res_blocks: 1, "
    "temperal_downsample: [true]}",
    f"transport.num_inference_steps={STEPS}",
    "dataset.preprocessing.max_text_len=12",
]


def _tiny_config(*extra):
    return load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"),
        TINY_OVERRIDES + list(extra))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = tiny_showo2_cfgs()
    params = showo2_params(jcfg)
    vae_params = jwan.init_wan_vae_params(VAE_TINY, jax.random.PRNGKey(1))
    # the zero-init attention projection would hide the attention block
    proj = vae_params["decoder"]["mid_attn"]["proj"]
    proj["kernel"] = jax.random.normal(jax.random.PRNGKey(2),
                                       proj["kernel"].shape) * 0.1
    return jcfg, tcfg, params, vae_params


def _pipelines(weights, route, **options):
    """(JAX pipeline, port pipeline) on the same weights, the port's on
    ``route`` (JAX: auto, dense at this size, or pallas_packed: JAX's
    streaming kernel takes no per-row q positions), both with
    ``options`` (sampling_method, prefix_cache)."""
    jcfg, tcfg, params, vae_params = weights
    kw = dict(guidance_scale=5.0, num_steps=STEPS, max_text_len=12,
              **options)
    jpipe = JaxPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params), vae_cfg=VAE_TINY,
        vae_params=vae_params, tokenizer=Tok(), token_ids=IDS,
        attn_impl="auto" if route == "dense" else "pallas_packed", **kw)
    vae = twan.WanVAE(twan.WanVAEConfig(
        **{f: getattr(VAE_TINY, f) for f in (
            "dim", "z_dim", "dim_mult", "num_res_blocks",
            "temperal_downsample")}))
    tpipe = T2IV2Pipeline(
        model=port_showo2(tcfg, jcfg, params),
        vae=load_wan_vae(vae, wan_vae_state_dict(vae_params, vae.cfg)),
        tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
        token_ids=inference_t2i_v2.FAKE_TOKEN_IDS, attn_impl=route, **kw)
    return jpipe, tpipe


def _jax_generate(jpipe, z):
    """JAX ``generate`` with z injected: its inputs, latents and images."""
    cfg, ids = jpipe.cfg, jpipe.token_ids
    toks, toks_null, mp, mp_null = prepare_gen_input(
        PROMPTS, jpipe.tokenizer, cfg.num_image_tokens, ids["bos_id"],
        ids["eos_id"], ids["boi_id"], ids["eoi_id"], ids["pad_id"],
        ids["img_pad_id"], jpipe.max_text_len)
    B = len(PROMPTS)
    text = np.concatenate([toks, toks_null], axis=0)
    mp_r = np.concatenate([mp[:, 0], mp_null[:, 0]], axis=0)[:, None]
    L = min(text.shape[1], (int(np.max(mp_r[:, :, 0] + mp_r[:, :, 1]))
                            + 127) // 128 * 128)
    text = jnp.asarray(text[:, :L])
    with _jax_packed_interpreted():
        samples = jpipe._denoise(
            jpipe.params, jnp.concatenate([z, z], axis=0), text,
            omni_attn_mask(jnp.asarray(mp_r), L), jnp.asarray(mp_r),
            jax.random.PRNGKey(0))[:B]
    return (np.asarray(text), mp_r, np.asarray(samples),
            np.asarray(jpipe._decode(jpipe.vae_params, samples)))


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_pipeline_vs_jax(weights, route):
    jpipe, tpipe = _pipelines(weights, route)
    assert tpipe.attn_route == route
    z = np.random.default_rng(7).normal(size=(2, 16, 8, 8)).astype(
        np.float32)
    jtext, jmp, jlat, jimg = _jax_generate(jpipe, jnp.asarray(z))
    text, mp = tpipe.build_inputs(PROMPTS)
    np.testing.assert_array_equal(text.numpy(), jtext)
    np.testing.assert_array_equal(mp.numpy(), jmp)
    lat = tpipe.generate_latents(PROMPTS, noise=z)
    assert float(np.abs(jlat - z).max()) > 1e-2       # the steps move z
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4, rtol=0)
    img = tpipe.generate(PROMPTS, noise=z)
    assert img.shape == (2, 16, 16, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, jimg, atol=1e-4, rtol=1e-3)


def test_generator_noise_is_seeded(weights):
    _, tpipe = _pipelines(weights, "dense")
    a, b = (tpipe.generate_latents(PROMPTS, torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, 16, 8, 8)
    with pytest.raises(ValueError, match="noise must be"):
        tpipe.generate_latents(PROMPTS, noise=np.zeros((1, 16, 8, 8)))


def test_auto_route_and_route_names():
    """``auto`` as JAX; ``streaming`` (kernel 5) is a route now; JAX
    strings raise ValueError naming the port's route; ``trainable`` is
    the route of the differentiable kernels 7 / 8, which JAX's T2I
    pipeline runs under ``pallas_trainable``."""
    assert route_attention("auto", 730) == "packed"
    assert route_attention("auto", 512) == "packed"
    assert route_attention("auto", 511) == "dense"
    assert route_attention("dense", 730) == "dense"
    assert route_attention("streaming", 730) == "streaming"
    with pytest.raises(ValueError, match="'packed'"):
        route_attention("pallas_packed", 730)
    with pytest.raises(ValueError, match="'streaming'"):
        route_attention("pallas_streaming", 730)
    assert route_attention("trainable", 730) == "trainable"
    with pytest.raises(ValueError, match="'trainable'"):
        route_attention("pallas_trainable", 730)
    with pytest.raises(ValueError, match="unknown"):
        route_attention("flash", 730)


def test_build_pipeline_on_the_cpu():
    """``build_pipeline(config, "cpu", attn_impl=...)``: ``auto`` is dense
    at 17 image tokens; ``packed`` sends every attention of both towers
    through the packed kernel's wrapper, once per layer per velocity
    evaluation; CPU tensors launch no kernel."""
    config = _tiny_config()
    assert inference_t2i_v2.build_pipeline(
        config, torch.device("cpu")).attn_route == "dense"
    pipe = inference_t2i_v2.build_pipeline(config, torch.device("cpu"),
                                           attn_impl="packed")
    assert pipe.attn_route == "packed" and pipe.cfg.llm.num_layers == 2
    before = sum(cuda_build.launches.values())
    with mock.patch.object(tqwen2, "omni_attention_packed",
                           wraps=tqwen2.omni_attention_packed) as spy:
        images = pipe.generate(["a cat", "a dog"],
                               torch.Generator().manual_seed(0))
    assert spy.call_count == (STEPS - 1) * (2 + 2)
    assert sum(cuda_build.launches.values()) == before
    assert images.shape == (2, 16, 16, 3) and np.isfinite(images).all()
    assert images.min() >= -1.0 and images.max() <= 1.0


def test_build_pipeline_needs_a_card_or_the_cpu():
    config = _tiny_config()
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            inference_t2i_v2.build_pipeline(config)


# dopri5 against JAX: the two velocities differ by fp32 summation order
# (~2e-5), which moves the adaptive steps a little; the two solutions then
# differ by the integrator's own error, held to its rtol 1e-3 on latents of
# size ~1
DOPRI5_ATOL = 1e-3


@pytest.mark.parametrize("extra,method", [
    (["transport.sampling_method=heun"], "heun"),
    (["transport.sampling_method=dopri5"], "dopri5"),
])
def test_unported_options_raise(weights, extra, method):
    """The samplers that used to raise: the config key builds the pipeline
    with the sampler, which runs and matches JAX's pipeline on the same
    weights and z (latents within atol 1e-4); an unknown one still
    raises."""
    pipe = inference_t2i_v2.build_pipeline(_tiny_config(*extra),
                                           torch.device("cpu"))
    assert pipe.sampling_method == method
    jpipe, tpipe = _pipelines(weights, "dense", sampling_method=method)
    z = np.random.default_rng(8).normal(size=(2, 16, 8, 8)).astype(
        np.float32)
    _, _, jlat, _ = _jax_generate(jpipe, jnp.asarray(z))
    lat = tpipe.generate_latents(PROMPTS, noise=z)
    np.testing.assert_allclose(lat.numpy(), jlat, rtol=0,
                               atol=DOPRI5_ATOL if method == "dopri5"
                               else 1e-4)
    with pytest.raises(ValueError, match="unknown sampling_method"):
        inference_t2i_v2.build_pipeline(
            _tiny_config("transport.sampling_method=rk4"),
            torch.device("cpu"))


def test_prefix_cache_raises(weights):
    """``prefix_cache=True``, which used to raise: the cached pipeline's
    latents match JAX's cached pipeline (packed route, JAX's kernel in
    interpret mode) and the port's uncached ones."""
    jpipe, tpipe = _pipelines(weights, "packed", prefix_cache=True)
    assert tpipe.prefix_cache
    z = np.random.default_rng(9).normal(size=(2, 16, 8, 8)).astype(
        np.float32)
    _, _, jlat, _ = _jax_generate(jpipe, jnp.asarray(z))
    lat = tpipe.generate_latents(PROMPTS, noise=z)
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4, rtol=0)
    _, plain = _pipelines(weights, "packed")
    np.testing.assert_allclose(
        lat.numpy(), plain.generate_latents(PROMPTS, noise=z).numpy(),
        atol=1e-4, rtol=0)


def test_cli_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.inference_t2i_v2`` at the tiny size
    writes one PNG per prompt; neither it nor any module of the package
    imports jax, flax, the JAX package or the tools' tokenizer."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\na red dog on a hill\nthird prompt\n")
    out = tmp_path / "out"
    args = ["config=configs/showo2_1.5b_demo_432x432.yaml", "batch_size=2",
            "device=cpu", f"output_dir={out}",
            f"validation_prompts_file={prompts}"] + TINY_OVERRIDES
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import showo_tpu_torch\n"
        "for m in pkgutil.walk_packages(showo_tpu_torch.__path__, "
        "'showo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"sys.argv = ['inference_t2i_v2'] + {args!r}\n"
        "runpy.run_module('showo_tpu_torch.inference_t2i_v2', "
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


@pytest.mark.cuda
def test_pipeline_on_card_packed_vs_dense():
    """At real head dims (Qwen 2 q / 1 kv heads of 128, DiT 4 / 1 of 64,
    two layers each, 432x432 latents, no CFG) the packed route launches
    kernel 1 once per layer per velocity evaluation and the dense route
    never; with the zero-init adaLN and final projections drawn N(0, 0.02)
    (so that the velocity depends on attention) the two routes' latents
    agree within 5e-2 of their peak (bf16 attention rounded in two orders,
    3 Euler steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    config = load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"), [
        "model.showo.hidden_size=256", "model.showo.llm_vocab_size=1100",
        "model.showo.llm_intermediate_size=512",
        "model.showo.llm_num_layers=2", "model.showo.llm_num_heads=2",
        "model.showo.llm_num_kv_heads=1", "model.showo.llm_head_dim=128",
        "model.showo.dit={hidden_size: 256, intermediate_size: 512, "
        "num_heads: 4, num_kv_heads: 1, head_dim: 64}",
        "model.showo.siglip={num_layers: 2}",
        "model.showo.num_diffusion_layers=2",
        "model.vae_model.dims={dim: 16}", "guidance_scale=0",
        f"transport.num_inference_steps={STEPS}"])
    latents = {}
    for route in ("packed", "dense"):
        pipe = inference_t2i_v2.build_pipeline(config, attn_impl=route)
        g = torch.Generator(device="cuda").manual_seed(5)
        with torch.no_grad():
            for name, p in pipe.model.named_parameters():
                if ("adaLN_modulation" in name
                        or "diffusion_head_b.linear" in name):
                    p.copy_(torch.randn(p.shape, generator=g,
                                        device="cuda") * 0.02)
        before = cuda_build.launches["omni_attention_packed"]
        latents[route] = pipe.generate_latents(
            ["a cat", "a dog"], torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        launches = cuda_build.launches["omni_attention_packed"] - before
        assert launches == ((STEPS - 1) * 4 if route == "packed" else 0)
    assert latents["packed"].shape == (2, 16, 54, 54)
    diff = (latents["packed"] - latents["dense"]).abs().max()
    assert diff <= 5e-2 * latents["dense"].abs().max()
