"""Show-o v1 long-video generation of showo_tpu_torch against the JAX
package on the CPU (fp32), at the sizes of tests/test_lvg_pipeline.py.

* ``omni_mask_lvg`` / ``omni_mask_lvg_v2`` bit-exact against the
  reference-generated golden (tests/golden/masks.npz) and against JAX on
  random multi-span rows, with shared and with distinct text markers (the
  column-0 quirk of lvg_v2 included).
* The frame payload's layout, as tests/test_lvg_payload_layout checks
  JAX's, and equal to JAX's payload.
* ``LVGPipeline`` codes token-exact against JAX's pipeline under the same
  injected Gumbel noise (JAX's ``showo_t2i_generate`` patched to take
  it), from text alone and from a first frame through the MAGVIT-v2
  encoder; frames within atol 1e-4 / rtol 1e-3 (the decoder's tolerance
  against its golden).
* The CLI at a tiny size on ``device=cpu``, without importing jax.
"""

import contextlib
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
from showo_tpu.ops import masks as jmasks
from showo_tpu.pipelines import lvg as jlvg
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.utils.torch_export import phi_state_dict
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.ops import masks as tmasks
from showo_tpu_torch.pipelines.lvg import LVGPipeline
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.utils.convert import (load_magvit, load_showo,
                                           magvit_state_dict)
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD, SOI, EOI, SOT, EOT = 900, 901, 902, 903, 904


# -- the masks ----------------------------------------------------------------

def _rows(seed, n_rows, num_images, num_texts, shared):
    """Random rows of left pads, then ``num_texts`` sot..eot text spans and
    ``num_images`` soi..eoi spans interleaved with free text and pads (the
    markers exactly that many times a row)."""
    rng = np.random.default_rng(seed)
    eot = SOT if shared else EOT
    rows = []
    for _ in range(n_rows):
        row = [PAD] * int(rng.integers(0, 4))
        for k in range(max(num_images, num_texts)):
            if k < num_texts:
                row += [SOT] + list(rng.integers(0, 900, rng.integers(1, 4)))
                row += [eot]
            row += list(rng.integers(0, 900, rng.integers(0, 3)))
            row += [PAD] * int(rng.integers(0, 2))
            if k < num_images:
                span = rng.integers(0, 900, rng.integers(1, 5))
                span[rng.random(len(span)) < 0.3] = PAD
                row += [SOI] + list(span) + [EOI]
        rows.append(row)
    L = max(map(len, rows))
    return np.asarray([[PAD] * (L - len(r)) + r for r in rows], np.int64)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(REPO, "tests", "golden", "masks.npz"))


def test_lvg_masks_match_golden(golden):
    got = tmasks.omni_mask_lvg(torch.as_tensor(golden["lvg_seq"]), PAD, SOI,
                               EOI, num_images=2, return_inverse_mask=False)
    np.testing.assert_array_equal(got.numpy(), golden["lvg"].astype(bool))
    got = tmasks.omni_mask_lvg_v2(
        torch.as_tensor(golden["lvg_v2_seq"]), PAD, SOI, EOI, SOT, SOT,
        num_images=2, num_texts=2, return_inverse_mask=False)
    np.testing.assert_array_equal(got.numpy(), golden["lvg_v2"].astype(bool))


@pytest.mark.parametrize("num_images", [1, 3])
def test_omni_mask_lvg_matches_jax(num_images):
    seq = _rows(num_images, 4, num_images, 0, True)
    want = jmasks.omni_mask_lvg(jnp.asarray(seq), PAD, SOI, EOI, num_images)
    got = tmasks.omni_mask_lvg(torch.as_tensor(seq), PAD, SOI, EOI,
                               num_images)
    assert got.shape == (4, 1, seq.shape[1], seq.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jmasks.omni_mask_lvg(jnp.asarray(seq), PAD, SOI, EOI, num_images,
                                return_inverse_mask=False)
    np.testing.assert_array_equal(
        tmasks.omni_mask_lvg(torch.as_tensor(seq), PAD, SOI, EOI, num_images,
                             return_inverse_mask=False).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "distinct"])
@pytest.mark.parametrize("num_images,num_texts", [(2, 2), (3, 1), (1, 0)])
def test_omni_mask_lvg_v2_matches_jax(shared, num_images, num_texts):
    """Every row sees column 0, the reference's quirk, even where the
    causal mask and the spans would hide it (a pad, or an image token from
    a text row)."""
    seq = _rows(10 + num_images, 4, num_images, num_texts, shared)
    eot = SOT if shared else EOT
    kw = dict(num_images=num_images, num_texts=num_texts,
              return_inverse_mask=False)
    want = np.asarray(jmasks.omni_mask_lvg_v2(jnp.asarray(seq), PAD, SOI,
                                              EOI, SOT, eot, **kw))
    got = tmasks.omni_mask_lvg_v2(torch.as_tensor(seq), PAD, SOI, EOI, SOT,
                                  eot, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 0, :, 0].all()
    bias = tmasks.omni_mask_lvg_v2(torch.as_tensor(seq), PAD, SOI, EOI, SOT,
                                   eot, num_images=num_images,
                                   num_texts=num_texts)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(
        jmasks.omni_mask_lvg_v2(jnp.asarray(seq), PAD, SOI, EOI, SOT, eot,
                                num_images=num_images, num_texts=num_texts)))


def test_span_positions_match_jax():
    seq = _rows(20, 5, 3, 2, False)
    for marker, count in ((SOI, 3), (EOT, 2), (SOT, 2)):
        np.testing.assert_array_equal(
            tmasks._span_positions(torch.as_tensor(seq == marker),
                                   count).numpy(),
            np.asarray(jmasks._span_positions(jnp.asarray(seq == marker),
                                              count)))


# -- the pipeline against JAX's -----------------------------------------------

TEXT_VOCAB = 1010
SHOWO = dict(vocab_size=TEXT_VOCAB + 17, llm_vocab_size=TEXT_VOCAB,
             num_new_special_tokens=0, codebook_size=16, num_vq_tokens=16)
PHI = dict(vocab_size=TEXT_VOCAB + 17, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4)
VQ_DIMS = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
               dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 1), z_channels=4)
PROMPTS = ["a river", "a fire at night"]
STEPS, N = 2, 16


@pytest.fixture(scope="module")
def weights():
    jcfg = jshowo.ShowoConfig(**SHOWO, llm=jphi.PhiConfig(**PHI))
    # scaled up so that the logits, and the sampled tokens, vary
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                          jshowo.init_showo_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    vq_cfg = jmv.VQConfig(**VQ_DIMS)
    vq_params = jmv.MagvitV2(vq_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"]
    return jcfg, params, vq_cfg, vq_params


def _pipelines(weights, guidance, context):
    jcfg, params, vq_cfg, vq_params = weights
    kw = dict(guidance_scale=guidance, timesteps=STEPS,
              context_frames=context)
    jpipe = jlvg.LVGPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params), vq_cfg=vq_cfg,
        vq_params=vq_params,
        uni_prompting=JaxPrompting(jfake.FakeTokenizer(), max_text_len=8,
                                   cond_dropout_prob=0.0), **kw)
    model = load_showo(
        tshowo.Showo(tshowo.ShowoConfig(**SHOWO, llm=tphi.PhiConfig(**PHI))),
        phi_state_dict(params["showo"], num_layers=2)).eval()
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, vq_cfg)).eval()
    tpipe = LVGPipeline(model=model, vq=vq, uni_prompting=UniversalPrompting(
        FakeTokenizer(), max_text_len=8, cond_dropout_prob=0.0), **kw)
    return jpipe, tpipe


def _noise(seed, frames, batch=2):
    rng = np.random.default_rng(seed)
    return [(rng.gumbel(size=(STEPS, batch, N, 16)).astype(np.float32),
             rng.gumbel(size=(STEPS, batch, N)).astype(np.float32))
            for _ in range(frames)]


@contextlib.contextmanager
def _jax_injected(noise):
    """JAX's pipeline with each frame's MaskGIT given the next noise pair,
    run without jit (a jitted generate would keep the first noise of
    every frame of the same length)."""
    noise = list(noise)

    def generate(*args, **kw):
        g_sample, g_conf = noise.pop(0)
        return jshowo.showo_t2i_generate(
            *args, injected_noise=(jnp.asarray(g_sample),
                                   jnp.asarray(g_conf)), **kw)

    with mock.patch.object(jlvg, "showo_t2i_generate", generate), \
            jax.disable_jit():
        yield
    assert not noise


def test_payload_layout(weights):
    """tests/test_lvg_pipeline.py::test_lvg_payload_layout on the port,
    and the payload equal to JAX's."""
    jpipe, tpipe = _pipelines(weights, 1.75, 2)
    cfg, sp = tpipe.cfg, tpipe.uni_prompting.sptids
    ctx = [np.arange(16, dtype=np.int64).reshape(1, 16) % cfg.codebook_size]
    payload = tpipe.frame_payload(ctx, 1)
    assert payload.shape == (1, 2 * N + 2)
    assert payload[0, N] == sp["<|eoi|>"]
    assert payload[0, N + 1] == sp["<|soi|>"]
    assert (payload[0, N + 2:] == cfg.mask_token_id).all()
    np.testing.assert_array_equal(payload, jpipe._frame_payload(ctx, 1))
    ids, _ = tpipe.uni_prompting((["x"], payload), "lvg_gen")
    assert (ids == sp["<|soi|>"]).sum() == 2
    assert (ids == sp["<|eoi|>"]).sum() == 2
    np.testing.assert_array_equal(
        ids, jpipe.uni_prompting((["x"], payload), "lvg_gen")[0])
    np.testing.assert_array_equal(tpipe.frame_payload([], 2),
                                  jpipe._frame_payload([], 2))


@pytest.mark.parametrize("guidance,context", [(1.75, 2), (0.0, 1)])
def test_codes_token_exact_vs_jax(weights, guidance, context):
    """Three frames from text: frame 0 plain t2i, then one and two context
    frames (with ``context`` 1 the window slides); codes equal, frames
    within the decoder's tolerance, and the frames differ."""
    jpipe, tpipe = _pipelines(weights, guidance, context)
    noise = _noise(3, 3)
    jcodes, decode = [], jpipe._decode

    def spy(vq_params, codes):
        jcodes.append(np.asarray(codes))
        return decode(vq_params, codes)

    jpipe._decode = spy
    with _jax_injected(noise):
        want = jpipe.generate(PROMPTS, 3, jax.random.PRNGKey(0))
    frames = tpipe.generate_codes(PROMPTS, 3, injected_noise=noise)
    assert len(frames) == len(jcodes) == 3
    for got, exp in zip(frames, jcodes):
        np.testing.assert_array_equal(got, exp)
    video = tpipe.decode(frames)
    assert video.shape == (2, 3, 8, 8, 3) and video.dtype == np.float32
    np.testing.assert_allclose(video, want, atol=1e-4, rtol=1e-3)
    assert not np.allclose(video[:, 0], video[:, 1])


def test_first_frame_token_exact_vs_jax(weights):
    """A given first frame: frame 0 is its MAGVIT-v2 codes (JAX's exactly),
    so its pixels are decode(encode(first)); the next frame's codes equal
    JAX's."""
    jpipe, tpipe = _pipelines(weights, 0.0, 1)
    first = np.random.RandomState(0).rand(2, 8, 8, 3).astype(
        np.float32) * 2 - 1
    noise = _noise(4, 1)
    with _jax_injected(noise):
        want = jpipe.generate(["pan right"] * 2, 2, jax.random.PRNGKey(1),
                              first_frame_nhwc=first)
    frames = tpipe.generate_codes(["pan right"] * 2, 2,
                                  first_frame_nhwc=first,
                                  injected_noise=noise)
    jcodes0 = np.asarray(jpipe._encode(jpipe.vq_params, jnp.asarray(first)))
    np.testing.assert_array_equal(frames[0], jcodes0)
    video = tpipe.decode(frames)
    np.testing.assert_allclose(video, want, atol=1e-4, rtol=1e-3)
    recon = tpipe.decode([frames[0]])[:, 0]
    np.testing.assert_allclose(video[:, 0], recon, atol=1e-6)


def test_generator_draws_are_seeded(weights):
    _, tpipe = _pipelines(weights, 1.75, 2)
    a, b = (tpipe.generate(PROMPTS, 2, torch.Generator().manual_seed(5))
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 2, 8, 8, 3) and np.isfinite(a).all()


CLI_TINY = [
    "config=configs/showo_demo.yaml", "batch_size=2", "device=cpu",
    "num_frames=3", "context_frames=2", "generation_timesteps=2",
    "model.showo.num_vq_tokens=16", "dataset.params.resolution=64",
    "dataset.preprocessing.max_seq_length=16",
    "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
    "num_layers: 2, num_heads: 4}",
    "model.vq_model.dims={ch: 32, enc_num_res_blocks: [1, 1, 1, 1, 1], "
    "dec_ch_mult: [1, 1, 2], dec_num_res_blocks: [1, 1, 1]}",
]


@pytest.mark.parametrize("with_first", [False, True],
                         ids=["text", "first-frame"])
def test_cli_runs_without_jax(tmp_path, with_first):
    """``python -m showo_tpu_torch.inference_lvg`` at a tiny size: 3
    prompts in batches of 2 (the last filled with its last prompt), a
    frame strip and 3 frame PNGs a video; the process never imports jax,
    flax, the JAX package or the tools' tokenizer."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a river\na fire\na city at night\n")
    out = tmp_path / "out"
    args = CLI_TINY + [f"output_dir={out}",
                       f"validation_prompts_file={prompts}"]
    if with_first:
        args.append("image_path=" + os.path.join(
            REPO, "assets", "validation", "inpainting", "source.png"))
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['inference_lvg'] + {args!r}\n"
        "runpy.run_module('showo_tpu_torch.inference_lvg', "
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
    want = sorted(f"lvg_{v:04d}_{part}.png" for v in range(4)
                  for part in ("strip", "f000", "f001", "f002"))
    assert sorted(p.name for p in out.iterdir()) == want
    from PIL import Image

    w, h = Image.open(out / "lvg_0000_strip.png").size
    assert w == 3 * h
