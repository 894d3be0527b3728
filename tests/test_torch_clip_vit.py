"""The CLIP-ViT tower of showo_tpu_torch (``models/clip_vit.py``), its
exporter (``utils/convert.py::clip_vit_state_dict``) and the CLIP-ViT
path's mask, on the CPU, fp32.

* Features against the reference golden (tests/golden/clip_tiny.npz, HF
  ``CLIPVisionModel``) at tests/test_clip_vit.py's tolerance (atol 3e-5,
  rtol 1e-4), and against JAX ``clip_vit_features`` on random weights
  exported from the JAX tree (atol 2e-5, rtol 1e-4: the same fp32 math in
  another summation order).
* The S2 multiscale features against JAX ``clip_vit_features_s2`` (same
  tolerance), the bicubic matrices equal.
* ``omni_mask_mmu_vit`` bit-exact against JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import clip_vit as jcv
from showo_tpu.ops.masks import omni_mask_mmu_vit as j_mask_vit
from showo_tpu.utils.torch_import import clip_vit_params_from_torch
from showo_tpu_torch.models import clip_vit as tcv
from showo_tpu_torch.ops.masks import omni_mask_mmu_vit
from showo_tpu_torch.utils.convert import clip_vit_state_dict, load_clip_vit

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "clip_tiny.npz")
GOLDEN_CFG = dict(hidden_size=64, intermediate_size=128, num_heads=4,
                  num_layers=3, image_size=32, patch_size=16)
S2_CFG = dict(hidden_size=32, intermediate_size=64, num_heads=4,
              num_layers=3, image_size=16, patch_size=4)
TOL = dict(atol=2e-5, rtol=1e-4)


def _port(cfg_kw, sd):
    return load_clip_vit(tcv.ClipVisionTower(tcv.ClipVitConfig(**cfg_kw)),
                         sd).eval()


def _jax_tower(cfg_kw, seed):
    cfg = jcv.ClipVitConfig(**cfg_kw)
    params = jcv.init_clip_vit_params(cfg, jax.random.PRNGKey(seed))
    # x3 the init scale so that the layers do more than pass the input on
    params = jax.tree.map(lambda x: np.asarray(x) * 3.0, params)
    sd = clip_vit_state_dict(params, cfg.num_layers)
    return cfg, params, _port(cfg_kw, sd)


def test_features_vs_golden():
    golden = np.load(GOLDEN)
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    tower = _port(GOLDEN_CFG, sd)
    x = torch.as_tensor(golden["x"]).permute(0, 2, 3, 1)     # NCHW -> NHWC
    feats = tower(x)
    assert feats.shape == (2, 4, 64)
    np.testing.assert_allclose(feats.numpy(), golden["feats"], atol=3e-5,
                               rtol=1e-4)


def test_features_vs_jax():
    cfg, params, tower = _jax_tower(GOLDEN_CFG, seed=1)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = jcv.clip_vit_features(cfg, jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(x))
    got = tower(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_exporter_inverts_the_importer():
    """clip_vit_state_dict(clip_vit_params_from_torch(sd)) == sd over the
    tower's tensors (the golden's post_layernorm is not read)."""
    golden = np.load(GOLDEN)
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    back = clip_vit_state_dict(clip_vit_params_from_torch(sd, num_layers=3),
                               num_layers=3)
    assert set(back) <= set(sd)
    assert set(back) == set(tcv.ClipVisionTower(
        tcv.ClipVitConfig(**GOLDEN_CFG)).state_dict())
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])


@pytest.mark.parametrize("n_in,n_out", [(16, 32), (16, 48), (40, 16)])
def test_bicubic_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(tcv.bicubic_matrix(n_in, n_out),
                                  np.asarray(jcv._bicubic_matrix(n_in,
                                                                 n_out)))


@pytest.mark.parametrize("scales", [(16, 32), (16, 32, 48)])
def test_s2_features_vs_jax(scales):
    """Every scale's tiles through one tower batch, merged, area-pooled to
    the base grid and concatenated on channels, from a 24 x 24 input (so
    every scale is a bicubic resize)."""
    cfg, params, tower = _jax_tower(S2_CFG, seed=2)
    x = np.random.default_rng(1).normal(size=(2, 24, 24, 3)).astype(
        np.float32)
    want = jcv.clip_vit_features_s2(cfg, jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), scales=scales)
    got = tcv.clip_vit_features_s2(tower, torch.as_tensor(x), scales=scales)
    assert got.shape == (2, 16, 32 * len(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_random_shapes():
    """Random init as JAX's: unit norm scales, zero biases, N(0, 0.02)."""
    tower = tcv.ClipVisionTower(tcv.ClipVitConfig(**S2_CFG)).init_random(
        torch.Generator().manual_seed(0))
    vm = tower.vision_model
    assert torch.equal(vm.pre_layrnorm.weight, torch.ones(32))
    assert torch.equal(vm.encoder.layers[0].mlp.fc1.bias, torch.zeros(64))
    std = vm.encoder.layers[1].self_attn.q_proj.weight.std().item()
    assert 0.015 < std < 0.025
    assert tower(torch.zeros(1, 16, 16, 3)).shape == (1, 16, 32)


@pytest.mark.parametrize("N,L,sys_len,patches", [(1, 30, 4, 9), (2, 20, 0, 5),
                                                 (1, 12, 3, 8)])
def test_omni_mask_mmu_vit_bit_exact(N, L, sys_len, patches):
    want = np.asarray(j_mask_vit(N, L, system_prompt_len=sys_len,
                                 num_patches=patches))
    got = omni_mask_mmu_vit(N, L, system_prompt_len=sys_len,
                            num_patches=patches)
    assert got.shape == (N, 1, L, L)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        omni_mask_mmu_vit(N, L, sys_len, patches,
                          return_inverse_mask=False).numpy(),
        np.asarray(j_mask_vit(N, L, sys_len, patches,
                              return_inverse_mask=False)))
