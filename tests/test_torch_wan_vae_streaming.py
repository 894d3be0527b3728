"""The streaming Wan2.1 VAE of showo_tpu_torch against its full-clip form
and against the JAX package's streaming functions, on the CPU (fp32), at
the sizes of tests/test_wan_vae_streaming.py.

The port runs the reference's ``feat_cache`` as a Python loop over chunks
with a cache of the last two frames per convolution; JAX carries
fixed-shape cache pytrees through ``lax.scan``.  Both must give the
full-clip encode and decode: atol / rtol 1e-4, the JAX test's tolerance
(the chunked convolutions sum in another order).  The single-temporal-
downsample config checks the time paths' first-chunk handling at 2 pixel
frames a latent frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.utils.convert import load_wan_vae, wan_vae_state_dict

torch.set_num_threads(1)

# z_dim stays 16: the facades' latent mean / std have 16 channels
CFG = jwan.WanVAEConfig(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2),
                        num_res_blocks=1)
SINGLE = jwan.WanVAEConfig(dim=16, z_dim=16, dim_mult=(1, 2, 2, 2),
                           num_res_blocks=1,
                           temperal_downsample=(False, False, True))
KEYS = ("dim", "z_dim", "dim_mult", "num_res_blocks", "temperal_downsample")
TOL = dict(atol=1e-4, rtol=1e-4)


def _models(cfg, seed):
    """(JAX params, the port's VAE on them); both attention projections
    drawn (their zero init would hide the attention blocks)."""
    params = jwan.init_wan_vae_params(cfg, jax.random.PRNGKey(seed))
    for i, side in enumerate(("encoder", "decoder")):
        proj = params[side]["mid_attn"]["proj"]
        proj["kernel"] = jax.random.normal(jax.random.PRNGKey(seed + 10 + i),
                                           proj["kernel"].shape) * 0.1
    vae = twan.WanVAE(twan.WanVAEConfig(**{f: getattr(cfg, f)
                                           for f in KEYS}))
    return params, load_wan_vae(vae, wan_vae_state_dict(params, vae.cfg)
                                ).eval()


@pytest.fixture(scope="module")
def models():
    return _models(CFG, 0)


def _last(x):       # [B, C, T, H, W] -> JAX's [B, T, H, W, C]
    return jnp.asarray(np.moveaxis(np.asarray(x), 1, -1))


def _first(x):      # JAX's [B, T, H, W, C] -> [B, C, T, H, W]
    return np.array(np.moveaxis(np.asarray(x), -1, 1))


@pytest.mark.parametrize("T", [1, 5, 9])
def test_encode_streaming_matches_full_clip_and_jax(models, T):
    params, vae = models
    x = np.random.default_rng(T).normal(size=(1, 3, T, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        full = twan.wan_encode_raw(vae, torch.as_tensor(x))
        got = twan.wan_encode_raw_streaming(vae, torch.as_tensor(x))
    want = jwan.wan_encode_raw_streaming(CFG, params, _last(x))
    assert got[0].shape == (1, 16, 1 + (T - 1) // 4, 4, 4)
    for g, f, w in zip(got, full, want):
        np.testing.assert_allclose(g.numpy(), f.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), _first(w), **TOL)


@pytest.mark.parametrize("Tz", [1, 3])
def test_decode_streaming_matches_full_clip_and_jax(models, Tz):
    params, vae = models
    z = np.random.default_rng(10 + Tz).normal(size=(1, 16, Tz, 4, 4)).astype(
        np.float32)
    with torch.no_grad():
        full = twan.wan_decode_raw(vae, torch.as_tensor(z))
        got = twan.wan_decode_raw_streaming(vae, torch.as_tensor(z))
    want = jwan.wan_decode_raw_streaming(CFG, params, _last(z))
    assert got.shape == (1, 3, 4 * (Tz - 1) + 1, 32, 32)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), _first(want), **TOL)


def test_facades_match(models):
    """``wan_encode_streaming`` / ``wan_decode_streaming``: the same
    normalisation and reparameterisation as the full-clip facades and as
    JAX's streaming facades, with JAX's normal draw given as ``eps``."""
    params, vae = models
    vid = np.random.default_rng(3).normal(size=(1, 3, 9, 32, 32)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    eps = _first(jax.random.normal(key, (1, 3, 4, 4, 16)))
    with torch.no_grad():
        z_f = twan.wan_encode(vae, torch.as_tensor(vid), eps=eps)
        z_s = twan.wan_encode_streaming(vae, torch.as_tensor(vid), eps=eps)
        x_f = twan.wan_decode(vae, z_s)
        x_s = twan.wan_decode_streaming(vae, z_s)
    jz = jwan.wan_encode_streaming(CFG, params, jnp.asarray(vid), key)
    np.testing.assert_allclose(z_s.numpy(), z_f.numpy(), **TOL)
    np.testing.assert_allclose(z_s.numpy(), np.asarray(jz), **TOL)
    jx = jwan.wan_decode_streaming(CFG, params, jnp.asarray(z_s.numpy()))
    np.testing.assert_allclose(x_s.numpy(), x_f.numpy(), **TOL)
    np.testing.assert_allclose(x_s.numpy(), np.asarray(jx), **TOL)
    assert float(x_s.abs().max()) <= 1.0
    with torch.no_grad():
        mu_s = twan.wan_encode_streaming(vae, torch.as_tensor(vid),
                                         deterministic=True)
        mu_f = twan.wan_encode(vae, torch.as_tensor(vid), deterministic=True)
    np.testing.assert_allclose(mu_s.numpy(), mu_f.numpy(), **TOL)


def test_streaming_single_temporal_downsample():
    """One time downsample: 2 pixel frames a latent frame; the first
    chunks of the time paths pass through as JAX's ``first`` flags say."""
    params, vae = _models(SINGLE, 5)
    assert twan.temporal_factor(vae.cfg) == 2
    x = np.random.default_rng(6).normal(size=(1, 3, 5, 32, 32)).astype(
        np.float32)
    z = np.random.default_rng(7).normal(size=(1, 16, 3, 4, 4)).astype(
        np.float32)
    with torch.no_grad():
        mu_s, _ = twan.wan_encode_raw_streaming(vae, torch.as_tensor(x))
        mu_f, _ = twan.wan_encode_raw(vae, torch.as_tensor(x))
        dec_s = twan.wan_decode_raw_streaming(vae, torch.as_tensor(z))
        dec_f = twan.wan_decode_raw(vae, torch.as_tensor(z))
    assert mu_s.shape == (1, 16, 3, 4, 4) and dec_s.shape[2] == 5
    np.testing.assert_allclose(mu_s.numpy(), mu_f.numpy(), **TOL)
    np.testing.assert_allclose(
        mu_s.numpy(), _first(jwan.wan_encode_raw_streaming(
            SINGLE, params, _last(x))[0]), **TOL)
    np.testing.assert_allclose(dec_s.numpy(), dec_f.numpy(), **TOL)
    np.testing.assert_allclose(
        dec_s.numpy(), _first(jwan.wan_decode_raw_streaming(
            SINGLE, params, _last(z))), **TOL)


def test_streaming_encode_rejects_ragged_clips(models):
    _, vae = models
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        twan.wan_encode_raw_streaming(vae, torch.zeros(1, 3, 4, 32, 32))
