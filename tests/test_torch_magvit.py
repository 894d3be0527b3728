"""showo_tpu_torch MAGVIT-v2 vs the reference golden
(tests/golden/magvit_tiny.npz) and vs the JAX flax codec, fp32 on the
CPU: the decoder at atol 2e-4 / rtol 1e-3 and the encoder's pre-quant
activations at atol 5e-5 / rtol 1e-4, as tests/test_magvit.py (conv
stacks in two frameworks sum in different orders); LFQ codes exactly,
wherever no channel lies within 1e-4 of the sign boundary.  Plus the
flax -> reference-layout converter as the exact inverse of
``magvit_params_from_torch``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import magvit as jmv
from showo_tpu.utils.torch_import import magvit_params_from_torch
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.utils.convert import load_magvit, magvit_state_dict

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "magvit_tiny.npz")
DIMS = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
            dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 2), z_channels=4)
J_TINY, T_TINY = jmv.VQConfig(**DIMS), tmv.VQConfig(**DIMS)
IMPORT_KW = dict(enc_ch_mult=DIMS["enc_ch_mult"],
                 enc_blocks=DIMS["enc_num_res_blocks"],
                 dec_ch_mult=DIMS["dec_ch_mult"],
                 dec_blocks=DIMS["dec_num_res_blocks"], ch=DIMS["ch"])
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def flax_params():
    """Random flax params of the tiny codec (both halves)."""
    model = jmv.MagvitV2(J_TINY)
    return model.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]


def test_decode_vs_golden(golden):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    vq = load_magvit(tmv.MagvitV2(T_TINY), sd)
    recon = vq.decode_code(torch.as_tensor(golden["codes"]))
    assert recon.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(recon.numpy(),
                               golden["recon"].transpose(0, 2, 3, 1), **TOL)


@pytest.mark.parametrize("hw", [None, (2, 8)])
def test_decode_vs_jax(flax_params, hw):
    codes = np.random.default_rng(0).integers(0, 16, size=(2, 16))
    model = jmv.MagvitV2(J_TINY)
    args = (jnp.asarray(codes),) if hw is None else (jnp.asarray(codes), hw)
    want = model.apply({"params": flax_params}, *args,
                       method=model.decode_code)
    vq = load_magvit(tmv.MagvitV2(T_TINY),
                     magvit_state_dict(flax_params, J_TINY))
    got = vq.decode_code(torch.as_tensor(codes), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict) or hasattr(a[k], "keys"):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def test_converter_inverts_importer(flax_params, golden):
    """magvit_params_from_torch(magvit_state_dict(p)) == p, and the
    converter reproduces the reference state dict it was imported from."""
    back = magvit_params_from_torch(magvit_state_dict(flax_params, J_TINY),
                                    **IMPORT_KW)
    _assert_trees_equal(jax.tree.map(np.asarray, dict(flax_params)), back)

    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    again = magvit_state_dict(magvit_params_from_torch(sd, **IMPORT_KW),
                              J_TINY)
    assert set(again) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k], err_msg=k)


def test_lfq_codebook_entry_vs_jax():
    codes = np.arange(8192).reshape(4, 2048)
    want = jmv.lfq_codebook_entry(jnp.asarray(codes))
    got = tmv.lfq_codebook_entry(torch.as_tensor(codes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_magvit_full_width_structure():
    """The default config builds the full MAGVIT-v2 decoder: the reference
    tensor names and shapes the converter emits for it."""
    vq = tmv.MagvitV2(tmv.VQConfig(), device="meta")
    names = {k for k in vq.state_dict()}
    assert "decoder.up.4.block.2.conv2.weight" in names
    assert "decoder.up.1.upsample.conv.weight" in names
    assert "decoder.up.0.upsample.conv.weight" not in names
    shapes = {k: tuple(v.shape) for k, v in vq.state_dict().items()}
    assert shapes["decoder.conv_in.weight"] == (512, 13, 3, 3)
    assert shapes["decoder.up.3.block.0.nin_shortcut.weight"] == (256, 512, 1, 1)
    assert "decoder.up.0.block.0.nin_shortcut.weight" not in names
    assert shapes["decoder.conv_out.weight"] == (3, 128, 3, 3)


def _stable(z):
    """Positions [N] whose channels all lie clear of the sign boundary
    (z: [..., C] NHWC)."""
    return (np.abs(z.reshape(-1, z.shape[-1])) > 1e-4).all(axis=-1)


def test_encode_vs_golden(golden):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    vq = load_magvit(tmv.MagvitV2(T_TINY), sd)
    x = torch.as_tensor(golden["x"])
    with torch.no_grad():
        z = vq.encoder(x)
    np.testing.assert_allclose(z.numpy(), golden["z"], atol=5e-5, rtol=1e-4)
    codes = vq.get_code(x.permute(0, 2, 3, 1)).numpy().reshape(-1)
    stable = _stable(golden["z"].transpose(0, 2, 3, 1))
    assert stable.mean() > 0.95
    np.testing.assert_array_equal(codes[stable],
                                  golden["codes"].reshape(-1)[stable])


def test_encode_and_get_code_vs_jax(flax_params):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    model = jmv.MagvitV2(J_TINY)
    jz_q, jcodes = model.apply({"params": flax_params}, jnp.asarray(x),
                               method=model.encode)
    jz = jmv.VQGANEncoder(J_TINY).apply(
        {"params": flax_params["encoder"]}, jnp.asarray(x))
    vq = load_magvit(tmv.MagvitV2(T_TINY),
                     magvit_state_dict(flax_params, J_TINY))
    with torch.no_grad():
        z_q, codes = vq.encode(torch.as_tensor(x))
        z = vq.encoder(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(z.permute(0, 2, 3, 1).numpy(), np.asarray(jz),
                               atol=5e-5, rtol=1e-4)
    stable = _stable(np.asarray(jz))
    assert stable.all()
    np.testing.assert_array_equal(z_q.numpy(), np.asarray(jz_q))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(vq.get_code(torch.as_tensor(x)).numpy(),
                                  np.asarray(jcodes))
    assert codes.shape == (2, 16 * 16)


def test_lfq_vs_jax():
    z = np.random.default_rng(4).standard_normal((3, 5, 13)).astype(
        np.float32)
    z[0, 0, :4] = 0.0                     # sign(0) -> -1 in both
    tz = torch.tensor(z, requires_grad=True)
    q = tmv.lfq_quantize(tz)
    np.testing.assert_array_equal(q.detach().numpy(),
                                  np.asarray(jmv.lfq_quantize(jnp.asarray(z))))
    q.sum().backward()                    # straight-through estimator
    assert torch.equal(tz.grad, torch.ones_like(tz))
    np.testing.assert_array_equal(
        tmv.lfq_indices(q.detach()).numpy(),
        np.asarray(jmv.lfq_indices(jnp.asarray(np.sign(z) + (z == 0) * -1))))
    codes = tmv.lfq_indices(tmv.lfq_codebook_entry(torch.arange(8192)))
    assert torch.equal(codes, torch.arange(8192))


def test_init_magvit_full_width_encoder_structure():
    """The default config builds the full MAGVIT-v2 encoder under the
    reference names: 5 levels, a downsample after all but the last."""
    vq = tmv.MagvitV2(tmv.VQConfig(), device="meta")
    shapes = {k: tuple(v.shape) for k, v in vq.state_dict().items()}
    assert shapes["encoder.conv_in.weight"] == (128, 3, 3, 3)
    assert shapes["encoder.down.4.block.3.conv2.weight"] == (512, 512, 3, 3)
    assert shapes["encoder.down.1.block.0.nin_shortcut.weight"] == (
        256, 128, 1, 1)
    assert shapes["encoder.down.3.downsample.conv.weight"] == (
        512, 512, 3, 3)
    assert "encoder.down.4.downsample.conv.weight" not in shapes
    assert shapes["encoder.conv_out.weight"] == (13, 512, 3, 3)
    assert shapes["encoder.quant_conv.weight"] == (13, 13, 1, 1)
    x = torch.zeros((1, 256, 256, 3), device="meta")
    assert tuple(vq.encoder(x.permute(0, 3, 1, 2)).shape) == (1, 13, 16, 16)
