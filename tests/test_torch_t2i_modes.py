"""The v1 inpainting and extrapolation modes of showo_tpu_torch against the
JAX package, on the CPU.

* ``bicubic_resize_mask``: the resampling weights are JAX's bit for bit,
  and the binarized mask equals JAX's on the in-tree asset mask at 256 ->
  16 and 512 -> 32, random binary and random grey masks, and masks whose
  edges are half-covered pixels (value 0.5).  A mask edge through the
  middle of an output pixel's footprint makes that output exactly 0.5 in
  exact arithmetic; there the float32 summation order decides, so such
  masks are held to JAX everywhere but at those exact ties.
* ``T2IPipeline.inpaint`` and ``extrapolate`` (every direction, offsets 0
  and 2, and two-direction canvases) give JAX's tokens exactly under the
  same injected Gumbel noise, on the dense route and (inpaint) on the
  packed route with JAX's Pallas kernel in interpret mode; images within
  atol 1e-4 / rtol 1e-3.  JAX has no extrapolation test of its own, so the
  JAX pipeline's method is the reference here.
* Both CLI modes run on ``device=cpu`` in a process that never imports
  jax.
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
from PIL import Image

from showo_tpu.models import magvit as jmv
from showo_tpu.models import phi as jphi
from showo_tpu.models import showo as jshowo
from showo_tpu.pipelines.t2i import T2IPipeline as JaxT2IPipeline
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.utils import image as jimage
from showo_tpu.utils.torch_export import phi_state_dict
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.pipelines.t2i import T2IPipeline
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.utils import image as timage
from showo_tpu_torch.utils.convert import (load_magvit, load_showo,
                                           magvit_state_dict)
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from tests.test_torch_phi import jax_kernels_interpreted, spy_route

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK_ASSET = os.path.join(REPO, "assets", "validation", "inpainting",
                          "mask.png")
SOURCE_ASSET = os.path.join(REPO, "assets", "validation", "inpainting",
                            "source.png")


# -- bicubic_resize_mask ----------------------------------------------------

def _asset_mask(res):
    return jimage.image_transform(Image.open(MASK_ASSET).convert("L"), res,
                                  normalize=False)[:, :, 0]


def _half_edge_rect(res, seed):
    """A random rectangle whose border pixels are half covered (0.5)."""
    rng = np.random.default_rng(seed)
    y0, x0 = rng.integers(0, res // 2, 2)
    y1, x1 = y0 + rng.integers(res // 8, res // 2, 2)
    m = np.zeros((res, res), np.float32)
    m[y0:y1 + 1, x0:x1 + 1] = 0.5
    m[y0 + 1:y1, x0 + 1:x1] = 1.0
    return m


MASKS = {
    "asset-256": lambda: (_asset_mask(256), 16),
    "asset-512": lambda: (_asset_mask(512), 32),
    "binary-256": lambda: ((np.random.default_rng(0).random((256, 256))
                            < 0.5).astype(np.float32), 16),
    "blocks-512": lambda: (np.kron(
        np.random.default_rng(1).random((103, 103)) < 0.5,
        np.ones((5, 5)))[:512, :512].astype(np.float32), 32),
    "grey-256": lambda: (np.random.default_rng(2).random(
        (256, 256)).astype(np.float32), 16),
    "half-edge-256": lambda: (_half_edge_rect(256, 3), 16),
    "half-edge-512": lambda: (_half_edge_rect(512, 4), 32),
    "blob-128": lambda: ((np.hypot(*np.mgrid[-64:64, -64:64] + 0.5) < 37.3)
                         .astype(np.float32), 8),
}


@pytest.mark.parametrize("name", list(MASKS))
def test_bicubic_resize_mask_bit_exact(name):
    mask, size = MASKS[name]()
    got = timage.bicubic_resize_mask(mask, size)
    want = jimage.bicubic_resize_mask(mask, size)
    assert got.dtype == np.int32 and got.shape == (size, size)
    assert 0 < int(want.sum()) < size * size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size_in,size_out", [(256, 16), (512, 32),
                                              (128, 8), (64, 16)])
def test_keys_cubic_weights_bit_exact(size_in, size_out):
    """The antialiased Keys cubic weights are JAX's, bit for bit (not
    torch's bicubic: a = -0.75 and no antialiasing)."""
    from jax._src.image.scale import (_fill_keys_cubic_kernel,
                                      compute_weight_mat)

    want = np.asarray(compute_weight_mat(
        size_in, size_out, size_out / size_in, 0.0, _fill_keys_cubic_kernel,
        True))
    got = timage.keys_cubic_weights(size_in, size_out).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res", [256, 512])
def test_bicubic_resize_mask_ties(res):
    """Masks with edges through the middle of output pixels' footprints:
    the outputs that are exactly 0.5 in exact arithmetic may land on either
    side of the threshold (summation order); every other output equals
    JAX's."""
    size = res // 16
    rng = np.random.default_rng(res)
    blocks = (rng.random((size + 1, size + 1)) < 0.5).astype(np.float32)
    mask = np.kron(blocks, np.ones((16, 16), np.float32))[8:8 + res,
                                                           8:8 + res]
    got = timage.bicubic_resize_mask(mask, size)
    want = jimage.bicubic_resize_mask(mask, size)
    w = timage.keys_cubic_weights(res, size).double()
    exact = (w.T @ torch.as_tensor(mask).double() @ w).numpy()
    ties = np.abs(exact - 0.5) < 1e-9
    assert ties.any()
    np.testing.assert_array_equal(got[~ties], want[~ties])


# -- the pipeline modes against the JAX pipeline -----------------------------

TINY_PHI = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=4, max_position_embeddings=256)
# a 128x128 image, 8x8 tokens: the encoder downsamples 16x, the decoder
# upsamples 2x (8x8 tokens -> 16x16 images)
RES, W = 128, 8
VQ_DIMS = dict(ch=32, enc_ch_mult=(1, 1, 1, 1, 2),
               enc_num_res_blocks=(1, 1, 1, 1, 1), dec_ch_mult=(1, 2),
               dec_num_res_blocks=(1, 1), z_channels=4)
PIPE = dict(vocab_size=1027, llm_vocab_size=1000, num_new_special_tokens=10,
            codebook_size=16, num_vq_tokens=W * W)
STEPS, MAX_SEQ = 3, 8
GUIDANCE = 1.75


@pytest.fixture(scope="module")
def pipelines():
    jcfg = jshowo.ShowoConfig(**PIPE, llm=jphi.PhiConfig(vocab_size=1027,
                                                         **TINY_PHI))
    jparams = jax.tree.map(
        lambda x: np.asarray(x) * 4.0,
        jshowo.init_showo_params(jcfg, jax.random.PRNGKey(0)))
    vq_cfg = jmv.VQConfig(**VQ_DIMS)
    vq_params = jmv.MagvitV2(vq_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, RES, RES, 3)))["params"]
    kw = dict(guidance_scale=GUIDANCE, timesteps=STEPS,
              max_seq_length=MAX_SEQ)
    jpipe = JaxT2IPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, jparams), resolution=RES,
        vq_cfg=vq_cfg, vq_params=vq_params,
        uni_prompting=JaxPrompting(jfake.FakeTokenizer(),
                                   max_text_len=MAX_SEQ), **kw)
    tcfg = tshowo.ShowoConfig(**PIPE, llm=tphi.PhiConfig(vocab_size=1027,
                                                         **TINY_PHI))
    model = load_showo(tshowo.Showo(tcfg),
                       phi_state_dict(jparams["showo"], num_layers=2)).eval()
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, vq_cfg)).eval()
    tpipes = {route: T2IPipeline(
        model=model, vq=vq, attn_impl=route, resolution=RES,
        uni_prompting=UniversalPrompting(FakeTokenizer(),
                                         max_text_len=MAX_SEQ), **kw)
        for route in ("dense", "packed")}
    return jpipe, tpipes


@pytest.fixture(scope="module")
def source():
    img = Image.open(SOURCE_ASSET).convert("RGB")
    return jimage.image_transform(img, RES)


def _noise(seed, batch):
    rng = np.random.default_rng(seed)
    return (rng.gumbel(size=(STEPS, batch, W * W, 16)).astype(np.float32),
            rng.gumbel(size=(STEPS, batch, W * W)).astype(np.float32))


def _jax_generate(jpipe, noises, route):
    """The JAX pipeline's jitted generate replaced by the same cached
    MaskGIT under injected noise, one noise pair per call in turn."""
    it = iter(noises)
    sp = jpipe.uni_prompting.sptids

    def generate(params, ids, uncond_ids, bias, key):
        g_sample, g_conf = next(it)
        return jshowo.showo_t2i_generate_cached(
            jpipe.cfg, params, ids, key, uncond_input_ids=uncond_ids,
            attention_bias=bias, guidance_scale=jpipe.guidance_scale,
            temperature=jpipe.temperature, timesteps=jpipe.timesteps,
            noise_schedule=jpipe._schedule,
            max_seq_length=jpipe.max_seq_length,
            injected_noise=(jnp.asarray(g_sample), jnp.asarray(g_conf)),
            use_pallas_attention=tphi.ATTN_ROUTES[route] or False,
            pad_id=sp["<|pad|>"], soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"])

    return mock.patch.object(jpipe, "_generate", generate)


def _jax_codes(jpipe, seen):
    """Spy on the JAX pipeline's clamped codes: appends each generate's to
    ``seen``."""
    orig = jpipe._run

    def run(*args):
        out = orig(*args)
        seen.append(np.asarray(out))
        return out

    return mock.patch.object(jpipe, "_run", run)


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_inpaint_vs_jax(pipelines, source, route):
    jpipe, tpipes = pipelines
    tpipe = tpipes[route]
    mask = _asset_mask(RES)
    noise = _noise(7, 2)
    calls = []
    with jax_kernels_interpreted(), _jax_generate(jpipe, [noise], route), \
            _jax_codes(jpipe, calls):
        jimages = jpipe.inpaint("a bedroom with a window", source, mask,
                                jax.random.PRNGKey(0), batch_size=2)
    jcodes = calls[0]
    with spy_route(route if route != "dense" else "packed") as spy:
        tcodes = tpipe.inpaint_codes("a bedroom with a window", source, mask,
                                     batch_size=2, injected_noise=noise)
    assert spy.call_count == (STEPS * 2 if route == "packed" else 0)
    known = ~timage.bicubic_resize_mask(mask, W).reshape(-1).astype(bool)
    assert 0 < known.sum() < W * W
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    timages = tpipe.inpaint("a bedroom with a window", source, mask,
                            batch_size=2, injected_noise=noise)
    assert timages.shape == (2, 2 * W, 2 * W, 3)
    np.testing.assert_allclose(timages, np.clip(jimages, -1.0, 1.0),
                               atol=1e-4, rtol=1e-3)


def test_inpaint_keeps_the_unmasked_tokens(pipelines, source):
    """Tokens outside the mask are the image's own codes."""
    _, tpipes = pipelines
    tpipe = tpipes["dense"]
    mask = _asset_mask(RES)
    known = ~timage.bicubic_resize_mask(mask, W).reshape(-1).astype(bool)
    codes = tpipe.inpaint_codes("a room", source, mask,
                                torch.Generator().manual_seed(0))
    own = tpipe.encode(source)[0] - tpipe.cfg.codebook_offset
    np.testing.assert_array_equal(codes[0].numpy()[known], own[known])


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("directions", [["left"], ["right"], ["up"],
                                        ["down"], ["left", "right"],
                                        ["up", "down"]],
                         ids=lambda d: "-".join(d))
def test_extrapolate_vs_jax(pipelines, source, directions, offset):
    jpipe, tpipes = pipelines
    tpipe = tpipes["dense"]
    prompts = ["a wide landscape", "mountains beyond"][:len(directions)]
    noises = [_noise(11 + i, 1) for i in range(len(directions))]
    with _jax_generate(jpipe, noises, "dense"):
        jimages = jpipe.extrapolate(prompts, directions, source,
                                    jax.random.PRNGKey(0), offset=offset)
    grid = tpipe.extrapolate_codes(prompts, directions, source,
                                   offset=offset, injected_noise=noises)
    shift = W // 2 - offset
    grow = len(directions) * (W - shift)
    horizontal = directions[0] in ("left", "right")
    assert grid.shape == ((1, W, W + grow) if horizontal
                          else (1, W + grow, W))
    timages = tpipe.extrapolate(prompts, directions, source, offset=offset,
                                injected_noise=noises)
    assert timages.shape == (1, 2 * grid.shape[1], 2 * grid.shape[2], 3)
    # the JAX images decode the JAX grid: equal images need equal tokens
    with _jax_generate(jpipe, noises, "dense"):
        jgrid = _jax_grid(jpipe, prompts, directions, source, offset)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_allclose(timages, np.clip(jimages, -1.0, 1.0),
                               atol=1e-4, rtol=1e-3)


def _jax_grid(jpipe, prompts, directions, source, offset):
    """The JAX pipeline's stitched code grid: the codes its decode_code
    receives."""
    seen = {}
    orig = jpipe._vq.apply

    def apply(variables, codes, *args, **kw):
        seen["codes"], seen["hw"] = np.asarray(codes), args[0]
        return orig(variables, codes, *args, **kw)

    with mock.patch.object(jpipe._vq, "apply", apply):
        jpipe.extrapolate(prompts, directions, source,
                          jax.random.PRNGKey(0), offset=offset)
    return seen["codes"].reshape(1, *seen["hw"])


def test_extrapolate_draws_from_one_generator(pipelines, source):
    """Without injected noise the generates draw from the generator in
    turn: the same seed gives the same canvas, and the codes lie in the
    codebook."""
    _, tpipes = pipelines
    tpipe = tpipes["dense"]

    def run(seed):
        return tpipe.extrapolate_codes(
            ["a", "b"], ["right", "right"], source,
            torch.Generator().manual_seed(seed), batch_size=2)

    a, b = run(3), run(3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, W, W + 2 * (W // 2)) and a.min() >= 0 \
        and a.max() < 16
    with pytest.raises(ValueError, match="direction"):
        tpipe.extrapolate_codes(["a"], ["sideways"], source)


# -- the CLI ---------------------------------------------------------------

CLI_TINY = [
    "config=configs/showo_demo_512x512.yaml", "batch_size=2", "device=cpu",
    "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
    "dataset.preprocessing.max_seq_length=16", "generation_timesteps=2",
    "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
    "num_layers: 2, num_heads: 4}",
    "model.vq_model.dims={ch: 32, enc_num_res_blocks: [1, 1, 1, 1, 1], "
    "dec_ch_mult: [1, 1, 2], dec_num_res_blocks: [1, 1, 1]}",
]


@pytest.mark.parametrize("mode,extra,names", [
    ("inpainting", ["prompt=a bedroom"],
     ["inpaint_000.png", "inpaint_001.png"]),
    ("extrapolation", ["prompt=a hill *** a lake", "extra_direction=left *** "
                       "right", f"image_path={SOURCE_ASSET}", "offset=0"],
     ["extrapolate_000.png", "extrapolate_001.png"]),
])
def test_cli_modes_run_without_jax(tmp_path, mode, extra, names):
    """Both modes of ``python -m showo_tpu_torch.inference_t2i`` at a tiny
    size write their PNGs (the extrapolated canvas wider than tall); the
    process never imports jax, flax, the JAX package or the tools'
    tokenizer."""
    out = tmp_path / "out"
    args = CLI_TINY + [f"mode={mode}", f"output_dir={out}"] + extra
    code = (
        "import runpy, sys\n"
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
    assert sorted(p.name for p in out.iterdir()) == names
    w, h = Image.open(out / names[0]).size
    assert (w > h) if mode == "extrapolation" else (w == h)
