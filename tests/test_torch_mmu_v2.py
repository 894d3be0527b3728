"""Show-o2 multimodal understanding (image and video) of showo_tpu_torch on
the CPU, at the sizes of tests/test_t2i_v2_pipeline.py, against the JAX
package on the same weights (carried by ``showo2_state_dict`` and
``wan_vae_state_dict``).

* The Wan2.1 encoder: ``wan_encode_raw`` against tests/golden/wanvae_tiny
  .npz (an image and a 9-frame clip), atol 1e-4 / rtol 1e-3 (the JAX
  test's); ``wan_encode`` against JAX with the same normal draw, and
  deterministic, atol 1e-4 / rtol 1e-3.
* SigLIP's position interpolation against JAX at an up-, a down- and an
  h != w grid, within 1e-6 of the output's peak (a few float32 ulps: the
  same float32 weights, contracted in other orders); ``embed_images`` of
  video latents against JAX, atol 2e-5.
* Qwen2 int8: ``quantize_int8`` bit-exact against JAX (fused and unfused,
  the tied head included); logits on JAX's int8 params against JAX
  ``qwen2_forward`` in fp32 and bf16 with the limits of
  tests/test_torch_mmu.py (top-1 agreement >= 0.95, max |diff| / peak <=
  1e-2: JAX rounds ``w_i8 * scale`` to bf16 before the product, the
  port scales the fp32 sum); a cached int8 decode gives the full forward.
* ``MMUV2Pipeline.answer`` and ``MMUVidPipeline.answer_video`` token-exact
  against JAX's pipelines (fp32) under the same VAE draw and Gumbel noise
  (JAX's ``jax.random.normal`` and ``ar_generate`` patched to take them),
  fused and unfused, greedy and with top-k / top-p; the int8 pipeline
  answers within the vocabulary without a kernel launch.
* The CLIs run at a tiny size on the CPU without importing jax, and
  ``build_pipeline`` needs the card unless asked for the CPU.
* On the card: the int8 pipeline's launches of kernel 9 by core.
"""

import contextlib
import functools
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.pipelines import mmu_v2 as jmmu_v2
from showo_tpu.pipelines.mmu_vid import MMUVidPipeline as JaxVidPipeline
from showo_tpu.sampling import ar as jar
from showo_tpu.show_o2 import qwen2 as jqwen2
from showo_tpu.show_o2 import showo2 as jshowo2
from showo_tpu.show_o2 import siglip as jsiglip
from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu_torch import (inference_mmu_v2, inference_mmu_vid,
                             inference_t2i_v2)
from showo_tpu_torch.config import load_config
from showo_tpu_torch.models.phi import Int8Linear
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.pipelines.mmu_v2 import MMUV2Pipeline
from showo_tpu_torch.pipelines.mmu_vid import MMUVidPipeline
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.show_o2 import siglip as tsiglip
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.utils.convert import (load_qwen2_int8_params,
                                           load_wan_vae, wan_vae_state_dict)
from test_t2i_v2_pipeline import IDS, VAE_TINY, Tok
from test_torch_show_o2 import (WAN_TINY, _golden, _weights, port_showo2,
                                showo2_params, tiny_showo2_cfgs)
from test_torch_t2i_v2 import TINY_OVERRIDES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# int8 logits vs JAX: argmax agreement and max |diff| / peak (module doc)
INT8_AGREE, INT8_REL = 0.95, 1e-2
QUESTION = "what is shown in the picture"
NEW_TOKENS = 6
# the tiny VAE downsamples 2x in space and once in time: 16x16 pixels give
# the 8x8 latents of the tiny model, 5 frames 3 latent frames
PIXELS, FRAMES, LATENT_FRAMES = 16, 5, 3
VAE_KEYS = ("dim", "z_dim", "dim_mult", "num_res_blocks",
            "temperal_downsample")


def _port_vae(jcfg, params):
    vae = twan.WanVAE(twan.WanVAEConfig(**{f: getattr(jcfg, f)
                                           for f in VAE_KEYS}))
    return load_wan_vae(vae, wan_vae_state_dict(params, vae.cfg)).eval()


def _vae_params(cfg, seed=1):
    """JAX VAE params with both attention projections drawn (their zero
    init would hide the attention blocks)."""
    params = jwan.init_wan_vae_params(cfg, jax.random.PRNGKey(seed))
    for i, side in enumerate(("encoder", "decoder")):
        proj = params[side]["mid_attn"]["proj"]
        proj["kernel"] = jax.random.normal(jax.random.PRNGKey(seed + 10 + i),
                                           proj["kernel"].shape) * 0.1
    return params


# -- the Wan2.1 encoder --------------------------------------------------------

@pytest.mark.parametrize("clip", ["i", "v"], ids=["image", "video"])
def test_wan_encoder_vs_golden(clip):
    g = _golden("wanvae_tiny")
    vae = load_wan_vae(twan.WanVAE(twan.WanVAEConfig(**WAN_TINY)),
                       _weights(g)).eval()
    x = torch.as_tensor(g["image" if clip == "i" else "video"])
    with torch.no_grad():
        mu, log_var = twan.wan_encode_raw(vae, x)
    np.testing.assert_allclose(mu.numpy(), g[f"mu_{clip}"], atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(log_var.numpy(), g[f"logvar_{clip}"],
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("frames", [1, 9])
@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["sampled", "deterministic"])
def test_wan_encode_vs_jax(frames, deterministic):
    """``wan_encode`` against JAX's on the same weights: the normalised
    mean, or mean + std * eps with JAX's own ``jax.random.normal`` draw
    handed to the port; the time downsample path at 9 frames."""
    cfg = jwan.WanVAEConfig(dim=16, z_dim=16, dim_mult=(1, 2),
                            num_res_blocks=1, temperal_downsample=(True,))
    params = _vae_params(cfg)
    x = np.random.default_rng(2).uniform(
        -1, 1, (2, 3, frames, PIXELS, PIXELS)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jwan.wan_encode(cfg, params, jnp.asarray(x), key,
                                      deterministic=deterministic))
    latent_frames = 1 + (frames - 1) // 2
    assert want.shape == (2, 16, latent_frames, 8, 8)
    eps = np.array(jax.random.normal(key, (2, latent_frames, 8, 8, 16)))
    with torch.no_grad():
        got = twan.wan_encode(_port_vae(cfg, params), torch.as_tensor(x),
                              eps=torch.as_tensor(eps).permute(0, 4, 1, 2, 3),
                              deterministic=deterministic)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)


# -- SigLIP position interpolation and the video embedding ------------------------

@pytest.mark.parametrize("h,w", [(6, 6), (3, 3), (2, 5)],
                         ids=["up", "down", "h-ne-w"])
def test_interpolate_pos_encoding_vs_jax(h, w):
    pos = np.random.default_rng(4).normal(size=(16, 48)).astype(np.float32)
    want = np.asarray(jsiglip.interpolate_pos_encoding(jnp.asarray(pos), h,
                                                       w))
    got = tsiglip.interpolate_pos_encoding(torch.as_tensor(pos), h, w)
    assert got.shape == want.shape == (1, h * w, 48)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = tiny_showo2_cfgs()
    return jcfg, tcfg, showo2_params(jcfg), _vae_params(VAE_TINY)


@pytest.mark.parametrize("grid", [8, 12], ids=["table-grid", "interpolated"])
def test_embed_images_video_vs_jax(weights, grid):
    """Video latents [B, C, T, H, W] -> [B, T*N, D]: both paths per frame;
    at a 12x12 latent the 6x6 patch grid interpolates the 4x4 table."""
    jcfg, tcfg, params, _ = weights
    z = np.random.default_rng(5).normal(
        size=(2, 16, LATENT_FRAMES, grid, grid)).astype(np.float32)
    want = np.asarray(jshowo2.embed_images(
        jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(z)))
    with torch.no_grad():
        got = tshowo2.embed_images(port_showo2(tcfg, jcfg, params),
                                   torch.as_tensor(z))
    n = (grid // 2) ** 2
    assert got.shape == want.shape == (2, LATENT_FRAMES * n,
                                       tcfg.llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


# -- Qwen2 weight-only int8 ----------------------------------------------------------

def _qwen_pair(weights, fused, dtype="float32"):
    """(JAX Qwen2 params, port Qwen2) on the same weights, both fused or
    not, in ``dtype``."""
    jcfg, tcfg, params, _ = weights
    jp = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, dtype)),
                      params["showo"])
    model = port_showo2(tcfg, jcfg, params).showo.to(getattr(torch, dtype))
    if fused:
        jp = jqwen2.fuse_inference(jp)
        tqwen2.fuse_inference(model)
    return jp, model


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_quantize_int8_bit_exact_vs_jax(weights, fused):
    """Every quantized matmul and the head from the tied embedding: int8
    weights and bf16 scales equal JAX's bit for bit; the biases of q / k /
    v (qkv) kept, none on o, gate / up (gu) and down."""
    jp, model = _qwen_pair(weights, fused)
    jq = jqwen2.quantize_int8(jp)
    tqwen2.quantize_int8(model)
    pairs = [(model.lm_head, jq["lm_head"])]
    for name, path in tqwen2.INT8_LINEARS.items():
        if name in jq["layers"]:
            node = jq["layers"][name]
            for i, layer in enumerate(model.model.layers):
                mod = layer.get_submodule(path)
                assert isinstance(mod, Int8Linear)
                assert (mod.bias is None) == ("bias" not in node), name
                pairs.append((mod, jax.tree.map(lambda a: a[i], node)))
    assert len(pairs) == 1 + 2 * (4 if fused else 7)
    for mod, node in pairs:
        np.testing.assert_array_equal(mod.kernel_i8.numpy(),
                                      np.asarray(node["kernel_i8"]))
        np.testing.assert_array_equal(
            mod.scale.float().numpy(),
            np.asarray(node["scale"].astype(jnp.float32)))
    assert model.lm_head.w_i8.shape[1] % 16 == 0
    assert model.model.embed_tokens.weight.dtype == torch.float32


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_vs_jax(weights, dtype, fused):
    """Qwen2 on JAX's int8 params (loaded with ``load_qwen2_int8_params``)
    against JAX ``qwen2_forward`` on them; limits in the module doc."""
    jp, model = _qwen_pair(weights, fused, dtype)
    jq = jqwen2.quantize_int8(jp)
    load_qwen2_int8_params(tqwen2.quantize_int8(model), jq)
    jcfg = weights[0]
    ids = np.random.default_rng(6).integers(0, jcfg.llm.vocab_size, (2, 16))
    want, _, _ = jqwen2.qwen2_forward(jcfg.llm, jq,
                                      input_ids=jnp.asarray(ids))
    with torch.no_grad():
        got, _ = model(input_ids=torch.as_tensor(ids))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    agree = (want.argmax(-1) == got.argmax(-1)).mean()
    rel = np.abs(want - got).max() / np.abs(want).max()
    assert agree >= INT8_AGREE, agree
    assert rel <= INT8_REL, rel


def test_int8_cached_decode_matches_full_forward(weights):
    """On an int8 Qwen2 the prefill into a cache and one cached step give
    the full forward's last row."""
    _, model = _qwen_pair(weights, True)
    tqwen2.quantize_int8(model)
    ids = torch.as_tensor(np.random.default_rng(7).integers(0, 1000, (1, 9)))
    causal = torch.triu(torch.full((1, 1, 9, 9), -1e9), 1)
    with torch.no_grad():
        full, _ = model(input_ids=ids, attention_bias=causal)
        cache = tqwen2.Qwen2KVCache.zeros(model.cfg, 1, 9)
        model(input_ids=ids[:, :8], attention_bias=causal[:, :, :8],
              cache=cache)
        step, _ = model(input_ids=ids[:, 8:],
                        attention_bias=causal[:, :, 8:], cache=cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-5)


# -- the pipelines against JAX ---------------------------------------------------

@contextlib.contextmanager
def _jax_injected(eps, gumbel):
    """JAX's pipelines with the VAE's normal draw ``eps`` (channels first,
    as the port takes it) and the sampling noise ``gumbel``."""
    eps_last = jnp.asarray(np.moveaxis(eps, 1, -1))

    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps_last.shape, (shape, eps_last.shape)
        return eps_last.astype(dtype)

    ar = functools.partial(jar.ar_generate, injected_gumbel=jnp.asarray(
        gumbel))
    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jmmu_v2, "ar_generate", ar), \
            mock.patch.object(jar, "ar_generate", ar):
        yield


SAMPLING = {"greedy": dict(top_k=1), "top-k-p": dict(top_k=20, top_p=0.8)}


def _pipelines(weights, video, fused, sampling, int8=False):
    jcfg, tcfg, params, vae_params = weights
    kw = dict(max_new_tokens=NEW_TOKENS, fuse_weights=fused,
              quantize_int8=int8, **SAMPLING[sampling])
    jcls, tcls = ((JaxVidPipeline, MMUVidPipeline) if video
                  else (jmmu_v2.MMUV2Pipeline, MMUV2Pipeline))
    jpipe = jcls(cfg=jcfg, params=jax.tree.map(jnp.asarray, params),
                 vae_cfg=VAE_TINY,
                 vae_params=jax.tree.map(jnp.asarray, vae_params),
                 tokenizer=Tok(), token_ids=IDS, **kw)
    tpipe = tcls(model=port_showo2(tcfg, jcfg, params),
                 vae=_port_vae(VAE_TINY, vae_params),
                 tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
                 token_ids=inference_t2i_v2.FAKE_TOKEN_IDS, **kw)
    return jpipe, tpipe


def _noise(seed, latent_frames, vocab):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(1, 16, latent_frames, 8, 8)).astype(np.float32)
    gumbel = rng.gumbel(size=(NEW_TOKENS + 1, 1, vocab)).astype(np.float32)
    return eps, gumbel


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_answer_token_exact_vs_jax(weights, fused, sampling):
    jpipe, tpipe = _pipelines(weights, False, fused, sampling)
    image = np.random.default_rng(8).uniform(
        -1, 1, (PIXELS, PIXELS, 3)).astype(np.float32)
    eps, gumbel = _noise(9, 1, weights[0].llm.vocab_size)
    with _jax_injected(eps, gumbel):
        want = jpipe.answer(image, QUESTION, jax.random.PRNGKey(0))
    got = tpipe.answer(image, QUESTION, injected_gumbel=gumbel,
                       injected_eps=eps)
    assert got == want and len(got) > 0
    text = tpipe.decode(got)
    assert isinstance(text, str) and text


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_answer_video_token_exact_vs_jax(weights, fused, sampling):
    jpipe, tpipe = _pipelines(weights, True, fused, sampling)
    frames = np.random.default_rng(10).uniform(
        -1, 1, (FRAMES, PIXELS, PIXELS, 3)).astype(np.float32)
    eps, gumbel = _noise(11, LATENT_FRAMES, weights[0].llm.vocab_size)
    with _jax_injected(eps, gumbel):
        want = jpipe.answer_video(frames, QUESTION, jax.random.PRNGKey(0))
    got = tpipe.answer_video(frames, QUESTION, injected_gumbel=gumbel,
                             injected_eps=eps)
    assert tpipe.span(LATENT_FRAMES) == LATENT_FRAMES * 16 + 1
    assert got == want and len(got) > 0


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
def test_int8_pipeline_answers(weights, video):
    """``quantize_int8=True``: every Qwen2 matmul and the head are
    Int8Linear; the answer's tokens are in the vocabulary, and on the CPU
    no kernel launches."""
    _, tpipe = _pipelines(weights, video, True, "top-k-p", int8=True)
    qwen = tpipe.model.showo
    assert all(isinstance(getattr(layer.self_attn, n), Int8Linear)
               for layer in qwen.model.layers for n in ("qkv", "o_proj"))
    assert all(isinstance(getattr(layer.mlp, n), Int8Linear)
               for layer in qwen.model.layers for n in ("gu", "down_proj"))
    assert isinstance(qwen.lm_head, Int8Linear)
    before = sum(cuda_build.launches.values())
    gen = torch.Generator().manual_seed(0)
    if video:
        toks = tpipe.answer_video(np.zeros((FRAMES, PIXELS, PIXELS, 3),
                                           np.float32), QUESTION, gen)
    else:
        toks = tpipe.answer(np.zeros((PIXELS, PIXELS, 3), np.float32),
                            QUESTION, gen)
    assert len(toks) <= NEW_TOKENS
    assert all(0 <= t < weights[0].llm.vocab_size for t in toks)
    assert sum(cuda_build.launches.values()) == before


@pytest.mark.cuda
def test_int8_pipeline_on_card(weights):
    """On the card, in bf16 with int8 weights: every product of an answer
    runs kernel 9, the prefill's (4 L + 1) on the prefill kernel and each
    decode forward's on the gemv; the tokens are in the vocabulary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    jcfg, tcfg, params, vae_params = weights
    pipe = MMUV2Pipeline(
        model=port_showo2(tcfg, jcfg, params).to("cuda", torch.bfloat16),
        vae=_port_vae(VAE_TINY, vae_params).to("cuda"),
        tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
        token_ids=inference_t2i_v2.FAKE_TOKEN_IDS,
        max_new_tokens=NEW_TOKENS, quantize_int8=True)
    image = np.random.default_rng(12).uniform(
        -1, 1, (PIXELS, PIXELS, 3)).astype(np.float32)
    names = ("int8_matmul", "int8_matmul_prefill", "int8_matmul_gemv",
             "int8_matmul_mma")
    before = {n: cuda_build.launches[n] for n in names}
    toks = pipe.answer(image, QUESTION,
                       torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    per = 4 * tcfg.llm.num_layers + 1
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        "int8_matmul": per * (1 + NEW_TOKENS), "int8_matmul_prefill": per,
        "int8_matmul_gemv": per * NEW_TOKENS, "int8_matmul_mma": 0}
    assert all(0 <= t < tcfg.llm.vocab_size for t in toks)


# -- the entry points ------------------------------------------------------------

CLI_TINY = TINY_OVERRIDES + ["dataset.preprocessing.resolution=16",
                             "max_new_tokens=4", "top_k=3"]


def test_build_pipeline_needs_the_card_unless_cpu_is_asked():
    """CUDA by default: without a card build_pipeline raises; device="cpu"
    builds the int8 pipeline, fp32, on the CPU, with the CLI's keys."""
    config = load_config(os.path.join(
        REPO, "configs", "showo2_1.5b_demo_432x432.yaml"),
        CLI_TINY + ["int8=1", "top_p=0.9"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            inference_mmu_v2.build_pipeline(config)
    pipe = inference_mmu_v2.build_pipeline(config, device="cpu")
    assert pipe.quantize_int8 and pipe.max_new_tokens == 4
    assert pipe.top_k == 3 and pipe.top_p == 0.9
    assert isinstance(pipe.model.showo.lm_head, Int8Linear)
    assert pipe.model.showo.model.embed_tokens.weight.dtype == torch.float32
    assert next(pipe.vae.parameters()).dtype == torch.float32
    vid = inference_mmu_vid.build_pipeline(
        load_config(os.path.join(REPO, "configs",
                                 "showo2_1.5b_demo_432x432.yaml"),
                    CLI_TINY + ["num_frames=5"]), device="cpu")
    assert isinstance(vid, MMUVidPipeline) and vid.num_frames == 5
    assert not vid.quantize_int8


def _run_cli(module, args):
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}] + {args!r}\n"
        f"runpy.run_module('showo_tpu_torch.{module}', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'showo_tpu', 'fake_tokenizer'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    return [ln for ln in proc.stdout.splitlines() if "User:" in ln]


def test_cli_mmu_v2_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.inference_mmu_v2`` at a tiny size asks
    every question of every image of ``mmu_image_root`` (name order, image
    files only), int8, and imports no jax, no JAX package and not the
    tools' tokenizer."""
    from PIL import Image

    root = tmp_path / "images"
    root.mkdir()
    for name in ("b.png", "a.jpg"):
        Image.new("RGB", (40, 30), (90, 20, 200)).save(root / name)
    (root / "notes.txt").write_text("not an image")
    answers = _run_cli("inference_mmu_v2", [
        "config=configs/showo2_1.5b_demo_432x432.yaml", "device=cpu",
        "int8=1", f"mmu_image_root={root}",
        "question=What is it? *** Is it cute?"] + CLI_TINY)
    assert [a.split("]")[0] for a in answers] == ["[a.jpg"] * 2 + ["[b.png"] * 2


def test_cli_mmu_vid_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.inference_mmu_vid`` answers each
    question about a GIF clip at a tiny size, without jax."""
    from PIL import Image

    gif = tmp_path / "clip.gif"
    frames = [Image.new("RGB", (20, 20), (i * 40, 10, 200 - i * 30))
              for i in range(7)]
    frames[0].save(gif, save_all=True, append_images=frames[1:])
    answers = _run_cli("inference_mmu_vid", [
        "config=configs/showo2_1.5b_demo_432x432.yaml", "device=cpu",
        f"video_path={gif}", "num_frames=5",
        "question=What happens? *** Who moves?"] + CLI_TINY)
    assert [a.split(":")[0] for a in answers] == ["User"] * 2
