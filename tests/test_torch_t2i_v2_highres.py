"""The Show-o2 text-to-image slice of showo_tpu_torch off the SigLIP
table's own grid, and the high-resolution demos' layouts, on the CPU.

* The pipeline against the JAX ``T2IV2Pipeline`` on the same weights and
  the same injected z where the latents give a patch grid other than the
  SigLIP position table's (the tiny table holds 16 positions, a 4x4 grid;
  latents 12x12 and 16x16 give 6x6 and 8x8), so every velocity evaluation
  resizes the table, as the 512x512 and 1024x1024 demos resize 27x27 to
  32x32 and 64x64: 3 Euler steps with CFG 5.0 on ``dense`` and on
  ``packed`` (JAX ``pallas_packed``, its kernel in interpret mode), token
  rows and spans bit-exact, latents within atol 1e-4, images within atol
  1e-4 / rtol 1e-3 (the tolerances of tests/test_torch_t2i_v2.py).  The
  port's pipeline runs the weights of a model built at 8x8 latents
  (``build_pipeline(models=...)``: no parameter depends on the grid).
* The demos' layouts at their real sizes (1024 and 4096 patches and the
  time token) with the stand-in tokenizer against JAX's, no forward: the
  rows, their length after the cut at the span's end (1152 and 4224 for
  the in-tree prompts), the spans and ``auto``'s route.
* On the card: kernel 1 against its plain version at those rows (B=8 with
  CFG), Qwen2.5's heads (12 / 2, D=128) and the DiT's (32 / 8, D=64).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu import inference_t2i_v2 as jinference
from showo_tpu.config import load_config as jload_config
from showo_tpu.pipelines.t2i_v2 import T2IV2Pipeline as JaxPipeline
from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu.show_o2.formats import prepare_gen_input as jprepare
from showo_tpu.show_o2.masks import omni_attn_mask
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.config import load_config
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.pipelines.t2i_v2 import (T2IV2Pipeline, cut_at_span,
                                              route_attention)
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.show_o2.formats import prepare_gen_input
from showo_tpu_torch.show_o2.qwen2 import ATTN_ROUTES
from showo_tpu_torch.show_o2.showo2 import with_config
from showo_tpu_torch.utils.convert import load_wan_vae, wan_vae_state_dict
from test_t2i_v2_pipeline import IDS, VAE_TINY, Tok
from test_torch_show_o2 import (_jax_packed_interpreted, port_showo2,
                                showo2_params, tiny_showo2_cfgs)
from test_torch_t2i_v2 import TINY_OVERRIDES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a cat", "an old stone bridge over water"]
STEPS = 3
# the demos: config, latent side, the rows' length after the cut for the
# in-tree prompts
DEMOS = {"512": ("showo2_1.5b_demo_512x512.yaml", 64, 1152),
         "1024": ("showo2_1.5b_demo_1024x1024.yaml", 128, 4224)}


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port model, JAX VAE params,
    port VAE): the tiny model of tests/test_torch_t2i_v2.py, built at its
    8x8 latents."""
    jcfg, tcfg = tiny_showo2_cfgs()
    params = showo2_params(jcfg)
    vae_params = jwan.init_wan_vae_params(VAE_TINY, jax.random.PRNGKey(1))
    proj = vae_params["decoder"]["mid_attn"]["proj"]
    proj["kernel"] = jax.random.normal(jax.random.PRNGKey(2),
                                       proj["kernel"].shape) * 0.1
    vae = twan.WanVAE(twan.WanVAEConfig(
        **{f: getattr(VAE_TINY, f) for f in (
            "dim", "z_dim", "dim_mult", "num_res_blocks",
            "temperal_downsample")}))
    vae = load_wan_vae(vae, wan_vae_state_dict(vae_params, vae.cfg))
    return (jcfg, tcfg, params, port_showo2(tcfg, jcfg, params), vae_params,
            vae)


def _grid(cfg, side):
    return dataclasses.replace(cfg, image_latent_height=side,
                               image_latent_width=side)


def _jax_generate(jpipe, z):
    """JAX ``generate`` with z injected: its rows, spans, latents, images."""
    cfg, ids = jpipe.cfg, jpipe.token_ids
    toks, toks_null, mp, mp_null = jprepare(
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
@pytest.mark.parametrize("side", [12, 16])
def test_pipeline_vs_jax_on_an_interpolated_grid(weights, route, side):
    jcfg, tcfg, params, model, vae_params, vae = weights
    jcfg, cfg = _grid(jcfg, side), _grid(tcfg, side)
    grid = side // cfg.patch_size
    assert grid * grid != cfg.siglip.num_positions == 16
    kw = dict(guidance_scale=5.0, num_steps=STEPS, max_text_len=12)
    jpipe = JaxPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params), vae_cfg=VAE_TINY,
        vae_params=vae_params, tokenizer=Tok(), token_ids=IDS,
        attn_impl="auto" if route == "dense" else "pallas_packed", **kw)
    tpipe = T2IV2Pipeline(
        model=with_config(model, cfg), vae=vae,
        tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
        token_ids=inference_t2i_v2.FAKE_TOKEN_IDS, attn_impl=route, **kw)
    assert tpipe.attn_route == route and tpipe.cfg == cfg
    assert model.cfg == tcfg          # the shared build keeps its own grid
    z = np.random.default_rng(side).normal(
        size=(2, 16, side, side)).astype(np.float32)
    jtext, jmp, jlat, jimg = _jax_generate(jpipe, jnp.asarray(z))
    text, mp = tpipe.build_inputs(PROMPTS)
    np.testing.assert_array_equal(text.numpy(), jtext)
    np.testing.assert_array_equal(mp.numpy(), jmp)
    assert int(mp[0, 0, 1]) == grid * grid + 1
    lat = tpipe.generate_latents(PROMPTS, noise=z)
    assert float(np.abs(jlat - z).max()) > 1e-2       # the steps move z
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4, rtol=0)
    img = tpipe.generate(PROMPTS, noise=z)
    assert img.shape == (2, 2 * side, 2 * side, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, jimg, atol=1e-4, rtol=1e-3)


def test_build_pipeline_shares_one_build_across_grids(weights):
    """``build_pipeline(config, "cpu", models=...)`` runs a model built at
    8x8 latents on a 12x12 config: the same parameters, the config's grid
    in the pipeline, the shared model's own untouched; a model whose
    widths differ from the config's is refused."""
    *_, model, _, vae = weights
    tiny = [o for o in TINY_OVERRIDES if "image_latent_" not in o]
    config = load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"),
        tiny + ["model.showo.image_latent_height=12",
                "model.showo.image_latent_width=12"])
    pipe = inference_t2i_v2.build_pipeline(config, torch.device("cpu"),
                                           models=(model, vae))
    assert pipe.cfg.image_latent_height == 12 == pipe.model.cfg.image_latent_width
    assert model.cfg.image_latent_height == 8
    assert pipe.model is not model
    assert all(a is b for a, b in zip(pipe.model.parameters(),
                                      model.parameters()))
    assert pipe.cfg.num_image_tokens == 37 and pipe.vae is vae
    images = pipe.generate(["a cat"], torch.Generator().manual_seed(0))
    assert images.shape == (1, 24, 24, 3) and np.isfinite(images).all()
    wider = load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"),
        tiny + ["model.showo.llm_num_layers=3"])
    with pytest.raises(ValueError, match="only the latent grid"):
        inference_t2i_v2.build_pipeline(wider, torch.device("cpu"),
                                        models=(model, vae))


def _demo_layout(name):
    """(port rows [B', L], port spans, JAX rows, JAX spans, port config,
    JAX config) of the demo's first four in-tree prompts."""
    path = os.path.join(REPO, "configs", DEMOS[name][0])
    config = load_config(path)
    cfg = inference_t2i_v2.build_showo2_config(config)
    jcfg = jinference.build_showo2_config(jload_config(path))
    prompts = inference_t2i_v2.load_prompts(config)[:4]
    max_text_len = int(config.dataset.preprocessing.max_text_len)
    ids = inference_t2i_v2.FAKE_TOKEN_IDS
    text, mp = cut_at_span(*prepare_gen_input(
        prompts, inference_t2i_v2.FakeQwenTokenizer(), cfg.num_image_tokens,
        ids["bos_id"], ids["eos_id"], ids["boi_id"], ids["eoi_id"],
        ids["pad_id"], ids["img_pad_id"], max_text_len), float(
            config.guidance_scale), torch.device("cpu"))
    toks, toks_null, jmp, jmp_null = jprepare(
        prompts, Tok(), jcfg.num_image_tokens, IDS["bos_id"], IDS["eos_id"],
        IDS["boi_id"], IDS["eoi_id"], IDS["pad_id"], IDS["img_pad_id"],
        max_text_len)
    jtext = np.concatenate([toks, toks_null], axis=0)
    mp_r = np.concatenate([jmp[:, 0], jmp_null[:, 0]], axis=0)[:, None]
    L = min(jtext.shape[1], (int(np.max(mp_r[:, :, 0] + mp_r[:, :, 1]))
                             + 127) // 128 * 128)
    return text, mp, jtext[:, :L], mp_r, cfg, jcfg


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_layout_vs_jax_at_full_size(name):
    _, side, length = DEMOS[name]
    text, mp, jtext, jmp, cfg, jcfg = _demo_layout(name)
    n = (side // 2) ** 2 + 1
    assert cfg.num_image_tokens == jcfg.num_image_tokens == n
    assert (cfg.image_latent_height, cfg.image_latent_width) == (side, side)
    assert tuple(text.shape) == jtext.shape == (8, length)
    np.testing.assert_array_equal(text.numpy(), jtext)
    np.testing.assert_array_equal(mp.numpy(), jmp)
    assert (mp[:, 0, 1] == n).all()
    route = route_attention("auto", cfg.num_image_tokens)
    jpipe = JaxPipeline(cfg=jcfg, params={}, vae_cfg=jwan.WanVAEConfig(),
                        vae_params={}, tokenizer=Tok(), token_ids=IDS,
                        fuse_weights=False)
    assert route == "packed" and ATTN_ROUTES[route] == jpipe._impl


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(12, 2, 128), (32, 8, 64)],
                         ids=["qwen", "dit"])
@pytest.mark.parametrize("name", sorted(DEMOS))
def test_kernel1_vs_plain_at_the_demo_rows(name, H, Hkv, D):
    """Kernel 1 on the tile map the pipeline makes, against its plain
    version, at atol 2e-2 (tests/test_torch_gqa_attention.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs

    dev = torch.device("cuda")
    text, mp, *_ = _demo_layout(name)
    text, mp = text.to(dev), mp.to(dev)
    meta = attention_inputs("packed", text, mp)[1]
    B, L = text.shape
    g = torch.Generator(device=dev).manual_seed(H + D + L)
    q, k, v = (torch.randn(B, L, n * D, generator=g, device=dev).bfloat16()
               for n in (H, Hkv, Hkv))
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
    got = tfa.omni_attention_packed(q, k, v, *m, num_heads=H,
                                    num_kv_heads=Hkv, q_positions=meta.pos_q,
                                    seg_q=meta.seg_q, tiles=meta.tiles)
    want = tfa.omni_attention_packed_plain(q, k, v, *m, meta.pos_q,
                                           num_heads=H, num_kv_heads=Hkv,
                                           sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
