"""Show-o2 mixed-modality generation of showo_tpu_torch against the JAX
package on the CPU (fp32), at the sizes of tests/test_mixed_modality.py.

* ``lm_generate`` token-exact against JAX's under the same Gumbel noise
  (JAX's ``ar_generate`` patched to take it): top-k 5 over random noise,
  and no top-k with eos or the image-start token planted at a step, where
  both stop.
* ``denoise_last`` (JAX ``_denoise_last``) with one and with two history
  images held at t = 1, z injected (JAX's ``jax.random.normal`` patched):
  latents within atol 1e-4, as the v2 latents are held in
  tests/test_torch_t2i_v2.py.
* A whole ``generate`` of 2 rounds with each round's noise injected: the
  rounds' tokens exact, the images within atol 1e-4 / rtol 1e-3 (the
  decoder's tolerance against its golden).
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

from showo_tpu.pipelines import mixed_modality as jmixed
from showo_tpu.sampling import ar as jar
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.pipelines.mixed_modality import MixedModalityPipeline
from test_t2i_v2_pipeline import IDS, VAE_TINY, Tok
from test_torch_mmu_v2 import _port_vae, _vae_params
from test_torch_show_o2 import port_showo2, showo2_params, tiny_showo2_cfgs
from test_torch_t2i_v2 import TINY_OVERRIDES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOKENS, STEPS, GUIDANCE = 6, 3, 2.0
PROMPT = "tell a story about a lighthouse"
N_IMG = 17      # 8x8 latents in 2x2 patches, and the time token


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = tiny_showo2_cfgs()
    return jcfg, tcfg, showo2_params(jcfg), _vae_params(VAE_TINY)


def _pipelines(weights, top_k=5):
    jcfg, tcfg, params, vae_params = weights
    kw = dict(guidance_scale=GUIDANCE, num_steps=STEPS,
              max_new_tokens=NEW_TOKENS, top_k=top_k)
    jpipe = jmixed.MixedModalityPipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params), vae_cfg=VAE_TINY,
        vae_params=jax.tree.map(jnp.asarray, vae_params), tokenizer=Tok(),
        token_ids=IDS, **kw)
    tpipe = MixedModalityPipeline(
        model=port_showo2(tcfg, jcfg, params),
        vae=_port_vae(VAE_TINY, vae_params),
        tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
        token_ids=dict(IDS), **kw)
    return jpipe, tpipe


@contextlib.contextmanager
def _jax_injected(gumbels=(), zs=()):
    """JAX's pipeline with each ``ar_generate`` call given the next Gumbel
    noise of ``gumbels`` and each ``jax.random.normal`` draw (the new
    image's z, drawn once a trace) the next of ``zs``."""
    gumbels, zs = list(gumbels), list(zs)

    def ar(*args, **kw):
        return jar.ar_generate(*args, injected_gumbel=jnp.asarray(
            gumbels.pop(0)), **kw)

    def normal(key, shape, dtype=jnp.float32):
        z = jnp.asarray(zs.pop(0), dtype)
        assert tuple(shape) == z.shape, (shape, z.shape)
        return z

    with mock.patch.object(jmixed, "ar_generate", ar), \
            mock.patch.object(jax.random, "normal", normal):
        yield
    assert not gumbels and not zs


def _gumbel(seed, plant=None):
    g = np.random.default_rng(seed).gumbel(
        size=(NEW_TOKENS + 1, 1, 1100)).astype(np.float32)
    if plant is not None:
        step, tok = plant
        g[step, 0, tok] = 1e4
    return g


@pytest.mark.parametrize("top_k,plant", [
    (5, None), (None, (2, IDS["eos_id"])), (None, (3, IDS["boi_id"]))],
    ids=["top5", "eos", "boi"])
def test_lm_generate_token_exact(weights, top_k, plant):
    jpipe, tpipe = _pipelines(weights, top_k)
    prompt = [IDS["bos_id"]] + tpipe._tok(PROMPT)
    g = _gumbel(3, plant)
    with _jax_injected([g]):
        want = jpipe.lm_generate(prompt, jax.random.PRNGKey(0))
    got = tpipe.lm_generate(prompt, injected_gumbel=g)
    assert got == want
    if plant is None:
        assert len(got) == NEW_TOKENS
    else:
        assert len(got) == plant[0] + 1 and got[-1] == plant[1]


@pytest.mark.parametrize("history", [1, 2])
def test_denoise_last_vs_jax(weights, history):
    jpipe, tpipe = _pipelines(weights)
    M = history + 1
    rng = np.random.default_rng(history)
    mp = np.asarray([[[4 + m * (N_IMG + 3), N_IMG] for m in range(M)]])
    L = int(mp[0, -1].sum()) + 3
    text = rng.integers(10, 1000, size=(1, L))
    hist = rng.normal(size=(history, 16, 8, 8)).astype(np.float32)
    z = rng.normal(size=(1, 16, 8, 8)).astype(np.float32)
    with _jax_injected(zs=[z]):
        want = jpipe._denoise_last(jnp.asarray(text), jnp.asarray(mp),
                                   jnp.asarray(hist), jax.random.PRNGKey(0))
    got = tpipe.denoise_last(torch.as_tensor(text), torch.as_tensor(mp),
                             torch.as_tensor(hist), noise=z)
    assert got.shape == (1, 16, 8, 8)
    assert float(np.abs(np.asarray(want) - z).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_generate_two_rounds_vs_jax(weights):
    """Round 1 ends at a planted image-start token, round 2 after
    ``max_new_tokens`` tokens (the pipeline then opens the image span
    itself): two images, the second with the first as history."""
    jpipe, tpipe = _pipelines(weights, top_k=None)
    gumbels = [_gumbel(5, (3, IDS["boi_id"])), _gumbel(6)]
    zs = [np.random.default_rng(7 + i).normal(size=(1, 16, 8, 8)).astype(
        np.float32) for i in range(2)]
    with _jax_injected(gumbels, zs):
        jrounds, jimgs = jpipe.generate(PROMPT, jax.random.PRNGKey(0),
                                        num_rounds=2)
    rounds, imgs = tpipe.generate(PROMPT, num_rounds=2,
                                  injected=list(zip(gumbels, zs)))
    assert rounds == jrounds
    assert rounds[0][-1] == IDS["boi_id"] and len(rounds[1]) == NEW_TOKENS
    assert imgs.shape == (2, 16, 16, 3) and imgs.dtype == np.float32
    np.testing.assert_allclose(imgs, np.asarray(jimgs), atol=1e-4, rtol=1e-3)


def test_generate_stops_at_eos(weights):
    _, tpipe = _pipelines(weights, top_k=None)
    rounds, imgs = tpipe.generate(
        PROMPT, num_rounds=3,
        injected=[(_gumbel(9, (1, IDS["eos_id"])), None)])
    assert len(rounds) == 1 and rounds[0][-1] == IDS["eos_id"]
    assert imgs.shape == (0, 1, 1, 3)


def test_generator_draws_are_seeded(weights):
    _, tpipe = _pipelines(weights)
    runs = [tpipe.generate(PROMPT, torch.Generator().manual_seed(2))
            for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_cli_runs_without_jax(tmp_path):
    """``python -m showo_tpu_torch.inference_mixed_modality`` at the tiny
    size prints each round and writes ``mixed_NNN.png`` per image; the
    process never imports jax, flax, the JAX package or the tools'
    tokenizer."""
    out = tmp_path / "out"
    args = (["config=configs/showo2_1.5b_demo_432x432.yaml", "device=cpu",
             "prompt=a story with pictures", "num_rounds=2",
             "max_new_tokens=4", f"output_dir={out}"] + TINY_OVERRIDES)
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['inference_mixed_modality'] + {args!r}\n"
        "runpy.run_module('showo_tpu_torch.inference_mixed_modality', "
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
    rounds = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("round ")]
    names = sorted(p.name for p in out.iterdir())
    assert rounds and rounds[0].startswith("round 0: ")
    assert names and names == [f"mixed_{i:03d}.png"
                               for i in range(len(names))]
    assert len(names) <= len(rounds)
