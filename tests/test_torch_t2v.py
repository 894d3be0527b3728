"""Show-o2 text/image-to-video of showo_tpu_torch against the JAX package on
the CPU (fp32), at the sizes of tests/test_t2v_pipeline.py (3 latent
frames of 8x8, 5 pixel frames of 16x16 through the tiny VAE).

* ``unpatchify_v`` / ``extract_v`` of video bit-exact with JAX's reshape
  chains; one video velocity with CFG against JAX's
  ``showo2_t2i_velocity(num_frames=)``, with and without
  ``first_frame_as_cond``, atol 2e-5 (tests/test_torch_show_o2.py's
  velocity tolerance).
* ``T2VPipeline`` latents against JAX's ``T2VPipeline`` under the same
  injected z, 3 Euler steps with CFG 5.0, on ``dense``, ``packed`` (JAX
  ``pallas_packed``) and ``streaming`` (JAX ``pallas_streaming``), JAX's
  kernels in interpret mode: atol 1e-4, as the v2 latents are held in
  tests/test_torch_t2i_v2.py; frames of the full-clip and the streaming
  decode within atol 1e-4 / rtol 1e-3 of JAX's.
* i2v with the encoder's normal draw injected: latents against JAX's, the
  first latent frame exactly the encoded frame, its velocity zero.
* The ``auto`` route's choice at 512 video tokens and 2816 rows, and
  ``vae_mode``'s at 9 latent frames.
* ``inference_t2i_v2.build_t2v_pipeline`` on ``device="cpu"`` at the CLI's
  tiny config, and its need of a card otherwise.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import streaming_attention as jsa
from showo_tpu.pipelines.t2v import T2VPipeline as JaxPipeline
from showo_tpu.show_o2 import showo2 as jshowo2
from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu.show_o2.formats import prepare_gen_input
from showo_tpu.show_o2.masks import omni_attn_mask
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.pipelines import t2v as tt2v
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.show_o2.masks import omni_attn_mask as tomni_attn_mask
from test_t2i_v2_pipeline import IDS, VAE_TINY, Tok
from test_torch_mmu_v2 import _port_vae, _vae_params
from test_torch_show_o2 import (_jax_packed_interpreted, port_showo2,
                                showo2_params, tiny_showo2_cfgs)
from test_torch_t2i_v2 import _tiny_config

torch.set_num_threads(1)

PROMPTS = ["a rocket launch", "waves on a beach at dusk"]
FRAMES, STEPS, GUIDANCE = 3, 3, 5.0
JAX_ROUTES = {"dense": "dense", "packed": "pallas_packed",
              "streaming": "pallas_streaming"}


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = tiny_showo2_cfgs()
    return jcfg, tcfg, showo2_params(jcfg), _vae_params(VAE_TINY)


def _jax_streaming_interpreted():
    orig = jsa.omni_attention_streaming

    def interp(*args, **kw):
        kw.update(interpret=True, block_q=16, block_k=16)
        return orig(*args, **kw)

    return mock.patch.object(jsa, "omni_attention_streaming", interp)


def _pipelines(weights, route, frames=FRAMES, **kw):
    jcfg, tcfg, params, vae_params = weights
    kw = dict(num_latent_frames=frames, guidance_scale=GUIDANCE,
              num_steps=STEPS, max_text_len=12, **kw)
    jpipe = JaxPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params), vae_cfg=VAE_TINY,
        vae_params=jax.tree.map(jnp.asarray, vae_params), tokenizer=Tok(),
        token_ids=IDS, attn_impl=JAX_ROUTES[route], **kw)
    tpipe = tt2v.T2VPipeline(
        model=port_showo2(tcfg, jcfg, params),
        vae=_port_vae(VAE_TINY, vae_params),
        tokenizer=inference_t2i_v2.FakeQwenTokenizer(), token_ids=dict(IDS),
        attn_impl=route, **kw)
    return jpipe, tpipe


def _jax_latents(jpipe, z, i2v=False):
    """JAX's ``generate`` up to the latents with z injected: (text rows,
    spans, latents)."""
    ids = jpipe.token_ids
    toks, toks_null, mp, mp_null = prepare_gen_input(
        PROMPTS, jpipe.tokenizer, jpipe.num_video_tokens, ids["bos_id"],
        ids["eos_id"], ids["boi_id"], ids["eoi_id"], ids["pad_id"],
        ids["img_pad_id"], jpipe.max_text_len)
    text = np.concatenate([toks, toks_null], axis=0)
    mp_r = np.concatenate([mp[:, 0], mp_null[:, 0]], axis=0)[:, None]
    L = min(text.shape[1], (int(np.max(mp_r[:, :, 0] + mp_r[:, :, 1]))
                            + 127) // 128 * 128)
    with _jax_packed_interpreted(), _jax_streaming_interpreted():
        out = jpipe._denoise(jpipe.params, jnp.concatenate([z, z], axis=0),
                             jnp.asarray(text[:, :L]), jnp.asarray(mp_r),
                             i2v)[:len(PROMPTS)]
    return text[:, :L], mp_r, np.asarray(out)


def _z(seed, frames=FRAMES):
    return np.random.default_rng(seed).normal(
        size=(len(PROMPTS), 16, frames, 8, 8)).astype(np.float32)


# -- the video velocity -------------------------------------------------------

def test_unpatchify_and_extract_v_video_vs_jax():
    jcfg, tcfg = tiny_showo2_cfgs()
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2, FRAMES * 16, 64)).astype(np.float32)
    got = tshowo2.unpatchify_v(tcfg, torch.as_tensor(v), 4, 4, T=FRAMES)
    want = jshowo2.unpatchify_v(jcfg, jnp.asarray(v), 4, 4, T=FRAMES)
    assert got.shape == (2, 16, FRAMES, 8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    L, n = 80, FRAMES * 16 + 1
    v_seq = rng.normal(size=(2, L, 64)).astype(np.float32)
    mp = np.asarray([[[5, n]], [[2, n]]])
    got = tshowo2.extract_v(tcfg, torch.as_tensor(v_seq), torch.as_tensor(mp),
                            4, 4, num_frames=FRAMES)
    want = jshowo2.extract_v(jcfg, jnp.asarray(v_seq), jnp.asarray(mp), 4, 4,
                             num_frames=FRAMES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i2v", [False, True], ids=["t2v", "i2v"])
def test_video_velocity_vs_jax(weights, i2v):
    jcfg, tcfg, params, _ = weights
    model = tshowo2.fuse_inference(port_showo2(tcfg, jcfg, params))
    rng = np.random.default_rng(2)
    B, L, n = 4, 80, FRAMES * 16 + 1
    text = rng.integers(10, 1000, size=(B, L))
    mp = np.asarray([[[5, n]], [[9, n]], [[2, n]], [[2, n]]])
    z = rng.normal(size=(B, 16, FRAMES, 8, 8)).astype(np.float32)
    t = np.full((B,), 0.37, np.float32)
    want = jshowo2.showo2_t2i_velocity(
        jcfg, jshowo2.fuse_inference(jax.tree.map(jnp.asarray, params)),
        jnp.asarray(text), jnp.asarray(z), jnp.asarray(t),
        omni_attn_mask(jnp.asarray(mp), L), jnp.asarray(mp),
        guidance_scale=GUIDANCE, first_frame_as_cond=i2v,
        num_frames=FRAMES)
    with torch.no_grad():
        got = tshowo2.showo2_t2i_velocity(
            model, torch.as_tensor(text), torch.as_tensor(z),
            torch.as_tensor(t), tomni_attn_mask(torch.as_tensor(mp), L),
            torch.as_tensor(mp), guidance_scale=GUIDANCE,
            first_frame_as_cond=i2v, num_frames=FRAMES)
    assert got.shape == (B, 16, FRAMES, 8, 8)
    assert float(got[:, :, 1:].abs().max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if i2v:
        assert not got[:, :, 0].any()


# -- the pipeline against JAX's -----------------------------------------------

@pytest.mark.parametrize("route", ["dense", "packed", "streaming"])
def test_pipeline_vs_jax(weights, route):
    jpipe, tpipe = _pipelines(weights, route)
    z = _z(7)
    jtext, jmp, jlat = _jax_latents(jpipe, jnp.asarray(z))
    text, mp = tpipe.build_inputs(PROMPTS)
    np.testing.assert_array_equal(text.numpy(), jtext)
    np.testing.assert_array_equal(mp.numpy(), jmp)
    assert tpipe.route(text.shape[1]) == route
    counter = {"packed": "omni_attention_packed",
               "streaming": "omni_attention_streaming"}.get(route)
    spy = (mock.patch.object(tqwen2, counter, wraps=getattr(tqwen2, counter))
           if counter else contextlib.nullcontext())
    with spy as calls:
        lat = tpipe.generate_latents(PROMPTS, noise=z)
    if counter:
        # every layer of both towers, each velocity evaluation
        assert calls.call_count == (STEPS - 1) * (2 + 2)
    assert lat.shape == (2, 16, FRAMES, 8, 8)
    assert float(np.abs(jlat - z).max()) > 1e-2       # the steps move z
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4, rtol=0)
    if route == "dense":
        jvid = np.moveaxis(np.asarray(jwan.wan_decode(
            VAE_TINY, jpipe.vae_params, jnp.asarray(jlat))), 1, -1)
        for mode in ("full", "streaming"):
            tpipe.vae_mode = mode
            vid = tpipe.decode(lat)
            assert vid.shape == (2, 5, 16, 16, 3) and vid.dtype == np.float32
            np.testing.assert_allclose(vid, jvid, atol=1e-4, rtol=1e-3)


def test_i2v_vs_jax(weights):
    """The first frame through the VAE encoder with its normal draw
    injected (JAX's own draw of its key): the latents match JAX's, the
    first latent frame is the encoded frame, bit for bit (its velocity is
    zero at every step), and the frames decode from it."""
    jpipe, tpipe = _pipelines(weights, "dense")
    frame = np.random.default_rng(4).uniform(-1, 1, (16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    pix = jnp.broadcast_to(jnp.transpose(jnp.asarray(frame), (2, 0, 1))[
        None, :, None], (2, 3, 1, 16, 16))
    frame0 = jwan.wan_encode(VAE_TINY, jpipe.vae_params, pix, key)
    eps = np.array(np.moveaxis(np.asarray(
        jax.random.normal(key, (2, 1, 8, 8, 16))), -1, 1))
    z = _z(8)
    _, _, jlat = _jax_latents(jpipe, jnp.asarray(z).at[:, :, :1].set(frame0),
                              i2v=True)
    enc = tpipe.encode_first_frame(frame, 2, eps=eps)
    np.testing.assert_allclose(enc.numpy(), np.asarray(frame0), atol=1e-4,
                               rtol=1e-3)
    lat = tpipe.generate_latents(PROMPTS, first_frame_nhwc=frame, noise=z,
                                 first_frame_eps=eps)
    assert torch.equal(lat[:, :, 0], enc[:, :, 0])
    assert float((lat[:, :, 1:] - torch.as_tensor(z[:, :, 1:])).abs().max()
                 ) > 1e-2
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4, rtol=0)
    videos = tpipe.generate(PROMPTS, torch.Generator().manual_seed(1),
                            first_frame_nhwc=frame)
    assert videos.shape == (2, 5, 16, 16, 3) and np.isfinite(videos).all()


def test_generator_noise_is_seeded(weights):
    _, tpipe = _pipelines(weights, "dense")
    a, b = (tpipe.generate_latents(PROMPTS, torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, 16, FRAMES, 8, 8)
    with pytest.raises(ValueError, match="noise must be"):
        tpipe.generate_latents(PROMPTS, noise=np.zeros((2, 16, 2, 8, 8)))


# -- routes and the VAE mode --------------------------------------------------

def test_auto_route_cut_overs():
    """JAX ``_pick_impl``: dense under 512 video tokens, packed up to 2816
    rows, streaming above; a named route is checked, not moved."""
    route = tt2v.route_video_attention
    assert route("auto", 511, 640) == "dense"
    assert route("auto", 512, 640) == "packed"
    assert route("auto", 1459, 1536) == "packed"
    assert route("auto", 2700, 2816) == "packed"
    assert route("auto", 2700, 2817) == "streaming"
    assert route("auto", 6562, 6656) == "streaming"
    assert route("dense", 6562, 6656) == "dense"
    assert route("packed", 20, 128) == "packed"
    with pytest.raises(ValueError, match="'streaming'"):
        route("pallas_streaming", 6562, 6656)
    # the training route's kernels run forward-only too, as JAX's pipeline
    # passes pallas_trainable through
    assert route("trainable", 6562, 6656) == "trainable"


def test_auto_route_at_the_slice_shapes(weights):
    """At the tiny size ``auto`` is dense (49 video tokens); the
    pipeline's token count is JAX's."""
    jpipe, tpipe = _pipelines(weights, "dense")
    tpipe.attn_impl = "auto"
    assert tpipe.num_video_tokens == jpipe.num_video_tokens == FRAMES * 16 + 1
    assert tpipe.route(128) == jpipe._pick_impl(128) == "dense"


@pytest.mark.parametrize("frames,mode,streams", [
    (8, "auto", False), (9, "auto", True), (3, "streaming", True),
    (9, "full", False)])
def test_vae_mode(weights, frames, mode, streams):
    _, tpipe = _pipelines(weights, "dense", frames=frames, vae_mode=mode)
    assert tpipe.streams_vae == streams
    with pytest.raises(ValueError, match="vae_mode"):
        _pipelines(weights, "dense", vae_mode="chunked")


def test_build_t2v_pipeline_on_the_cpu():
    """``build_t2v_pipeline`` on the t2i CLI's loaders: the tiny config's
    model and VAE, ``auto`` dense at 49 video tokens, frames of the
    requested clip; without a card and without ``device="cpu"`` it
    raises."""
    pipe = inference_t2i_v2.build_t2v_pipeline(
        _tiny_config(), torch.device("cpu"), num_latent_frames=FRAMES,
        guidance_scale=GUIDANCE, num_steps=STEPS)
    assert isinstance(pipe.vae, twan.WanVAE) and pipe.max_text_len == 12
    assert pipe.route(128) == "dense" and not pipe.streams_vae
    videos = pipe.generate(["a cat on a boat"],
                           torch.Generator().manual_seed(0))
    assert videos.shape == (1, 5, 16, 16, 3) and np.isfinite(videos).all()
    assert videos.min() >= -1.0 and videos.max() <= 1.0
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            inference_t2i_v2.build_t2v_pipeline(_tiny_config())


@pytest.mark.cuda
def test_t2v_on_card_routes_vs_dense():
    """At real head dims (Qwen 2 q / 1 kv heads of 128, DiT 4 / 1 of 64, two
    layers each, 432x432 latents, 2 latent frames, no CFG) ``packed`` and
    ``streaming`` launch their kernel once per layer per velocity
    evaluation, ``dense`` none; with the adaLN and final projections drawn
    N(0, 0.02) the routes' latents agree within 5e-2 of their peak (bf16
    attention rounded in two orders, 3 Euler steps), and i2v keeps the
    first latent frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.ops import cuda_build

    config = load_config("configs/showo2_1.5b_demo_432x432.yaml", [
        "model.showo.hidden_size=256", "model.showo.llm_vocab_size=1100",
        "model.showo.llm_intermediate_size=512",
        "model.showo.llm_num_layers=2", "model.showo.llm_num_heads=2",
        "model.showo.llm_num_kv_heads=1", "model.showo.llm_head_dim=128",
        "model.showo.dit={hidden_size: 256, intermediate_size: 512, "
        "num_heads: 4, num_kv_heads: 1, head_dim: 64}",
        "model.showo.siglip={num_layers: 2}",
        "model.showo.num_diffusion_layers=2",
        "model.vae_model.dims={dim: 16}"])
    latents, counter = {}, {"packed": "omni_attention_packed",
                            "streaming": "streaming_attention"}
    for route in ("packed", "streaming", "dense"):
        pipe = inference_t2i_v2.build_t2v_pipeline(
            config, num_latent_frames=2, guidance_scale=0.0,
            num_steps=STEPS, attn_impl=route)
        g = torch.Generator(device="cuda").manual_seed(5)
        with torch.no_grad():
            for name, p in pipe.model.named_parameters():
                if ("adaLN_modulation" in name
                        or "diffusion_head_b.linear" in name):
                    p.copy_(torch.randn(p.shape, generator=g,
                                        device="cuda") * 0.02)
        before = dict(cuda_build.launches)
        latents[route] = pipe.generate_latents(
            ["a rocket launch"], torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        for r, name in counter.items():
            made = cuda_build.launches[name] - before.get(name, 0)
            assert made == ((STEPS - 1) * 4 if r == route else 0), (r, made)
    assert latents["dense"].shape == (1, 16, 2, 54, 54)
    peak = latents["dense"].abs().max()
    for route in ("packed", "streaming"):
        assert (latents[route] - latents["dense"]).abs().max() <= 5e-2 * peak
    frame = np.zeros((432, 432, 3), np.float32)
    lat = pipe.generate_latents(["a rocket launch"],
                                torch.Generator(device="cuda").manual_seed(1),
                                first_frame_nhwc=frame)
    g = torch.Generator(device="cuda").manual_seed(1)
    torch.randn((1, 16, 2, 54, 54), generator=g, device="cuda")   # z
    enc = pipe.encode_first_frame(frame, 1, g)
    assert lat.shape == (1, 16, 2, 54, 54) and torch.isfinite(lat).all()
    assert (lat[:, :, 0] - enc[:, :, 0]).abs().max() <= 1e-5
