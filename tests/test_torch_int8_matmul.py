"""The int8 and int4 weight-streaming matmuls of showo_tpu_torch
(``ops/int8_matmul.py``, ``ops/int4_matmul.py``) and ``quantize_int8``.

On the CPU the wrappers run their plain versions, held against the JAX
Pallas kernels of the probes (kernel 9: ``tools/probe_int8_decode.py``,
11a / 11b: ``tools/probe_pallas_wsmm.py``, 10:
``tools/probe_int4_decode.py``), imported by file path and run under
``pltpu.force_tpu_interpret_mode()``, and against a numpy formula at
ragged M / K / N.  Tolerance: one bf16 ulp of the output's peak (both
sides sum exact bf16 products in fp32, in different orders, and round the
scaled sum to bf16 once).  ``quantize_int8`` is bit-exact against JAX on
every layout.  The card-only cases hold each CUDA kernel against its plain
version at the slice's shapes within 2e-2 of the output's peak.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from showo_tpu.models import phi as jphi
from showo_tpu.utils.torch_export import phi_state_dict
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models.showo import Showo, ShowoConfig
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import int4_matmul as ti4
from showo_tpu_torch.ops import int8_matmul as ti8
from showo_tpu_torch.utils.convert import load_int8_params, load_showo

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
CARD_TOL = 2e-2     # kernel vs plain on the card, of the output's peak


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    return {n: _probe(n) for n in ("probe_int8_decode", "probe_int4_decode",
                                    "probe_pallas_wsmm")}


def _ulp(peak: float) -> float:
    """One bf16 ulp at ``peak`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(peak)) - 7)


def _inputs(M, K, N, seed, nib=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if nib:
        w = rng.integers(-128, 128, size=(K // 2, N)).astype(np.int8)
    else:
        w = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = rng.random((1, N)).astype(np.float32) * 0.01 + 1e-3
    s = np.asarray(jnp.asarray(s, jnp.bfloat16).astype(jnp.float32))
    return x, w, s


def _torch(x, w, s):
    return (torch.tensor(x).bfloat16(), torch.tensor(w),
            torch.tensor(s).bfloat16())


def _jax(x, w, s):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
            jnp.asarray(s, jnp.bfloat16))


def _close_in_ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = _ulp(np.abs(want).max())
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# -- plain versions against the Pallas kernels (interpret mode) -------------

@pytest.mark.parametrize("kernel", ["9", "11a"])
def test_i8_plain_vs_pallas(probes, kernel):
    """Kernels 9 and 11a (the same function on two grids) at
    [8, 1024] x [1024, 256]."""
    x, w, s = _inputs(8, 1024, 256, seed=9)
    with pltpu.force_tpu_interpret_mode():
        if kernel == "9":
            want = probes["probe_int8_decode"].pallas_i8_matmul(
                *_jax(x, w, s), block_k=512)
        else:
            want = probes["probe_pallas_wsmm"].pallas_i8_matmul(
                *_jax(x, w, s), block_k=512, block_n=128)
    got = ti8.pallas_i8_matmul(*_torch(x, w, s))
    assert got.dtype == torch.bfloat16
    _close_in_ulps(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("kernel", ["10", "11b"])
def test_nib_plain_vs_pallas(probes, kernel):
    """Kernels 10 and 11b at [8, 1024] x packed [512, 256]."""
    x, w, s = _inputs(8, 1024, 256, seed=10, nib=True)
    with pltpu.force_tpu_interpret_mode():
        if kernel == "10":
            want = probes["probe_int4_decode"].pallas_nib_matmul(
                *_jax(x, w, s), block_k=256)
        else:
            want = probes["probe_pallas_wsmm"].pallas_nib_matmul(
                *_jax(x, w, s), block_k=256, block_n=128)
    got = ti4.pallas_nib_matmul(*_torch(x, w, s))
    _close_in_ulps(got.float().numpy(), np.asarray(want, np.float32))


def test_nibble_pack_roundtrip(probes):
    """pack_nibbles / unpack_nibbles invert each other over every int4
    value, give the bytes of the probe's packing, and unpack as the
    probe's ``_unpack_nib`` does."""
    rng = np.random.default_rng(0)
    K, N = 16, 24
    w4 = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    w4[:, 0] = np.arange(-8, 8)
    packed = ti4.pack_nibbles(torch.as_tensor(w4))
    want = ((w4[K // 2:] << 4) | (w4[:K // 2] & 0x0F)).astype(np.int8)
    np.testing.assert_array_equal(packed.numpy(), want)
    lo, hi = ti4.unpack_nibbles(packed)
    np.testing.assert_array_equal(torch.cat([lo, hi]).numpy(), w4)
    j_lo, j_hi = probes["probe_int4_decode"]._unpack_nib(jnp.asarray(want))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi))
    with pytest.raises(ValueError, match=r"\[-8, 7\]"):
        ti4.pack_nibbles(torch.full((2, 2), 8, dtype=torch.int8))


@pytest.mark.parametrize("M,K,N", [(1, 37, 5), (3, 130, 517), (7, 64, 33),
                                   (20, 258, 130)])
def test_plain_ragged_vs_numpy(M, K, N):
    """Any M, K, N (decode M = 1, the 58498-column vocabulary): the plain
    versions against ``bf16(fp32(x @ w) * scale) + bias`` in numpy."""
    x, w, s = _inputs(M, K, N, seed=M * K + N)
    bias = np.random.default_rng(N).normal(size=N).astype(np.float32)
    tb = torch.as_tensor(bias).bfloat16()

    def want(acc):
        y = (acc * s).astype(jnp.bfloat16).astype(np.float32)
        return y + bias.astype(jnp.bfloat16).astype(np.float32)

    got = ti8.pallas_i8_matmul(*_torch(x, w, s), tb)
    _close_in_ulps(got.float().numpy(), want(x @ w.astype(np.float32)))
    if K % 2 == 0:
        xn, wn, sn = _inputs(M, K, N, seed=K, nib=True)
        w4 = torch.cat(ti4.unpack_nibbles(torch.as_tensor(wn))).float()
        got = ti4.pallas_nib_matmul(*_torch(xn, wn, sn), tb)
        y = ((xn @ w4.numpy()) * sn).astype(jnp.bfloat16).astype(np.float32)
        y = y + bias.astype(jnp.bfloat16).astype(np.float32)
        _close_in_ulps(got.float().numpy(), y)


def test_linear_i8_leading_dims_and_strided_columns():
    """linear_i8 takes [..., K] and a column slice of the weights (the
    lm_head slice of a quantized Phi), as one matmul of the rows."""
    x, w, s = _inputs(6, 40, 48, seed=1)
    tx, tw, ts = _torch(x, w, s)
    got = ti8.linear_i8(tx.reshape(2, 3, 40), tw[:, 5:30], ts[:, 5:30])
    want = ti8.i8_matmul_plain(tx, tw[:, 5:30], ts[:, 5:30])
    assert got.shape == (2, 3, 25)
    assert torch.equal(got.reshape(6, 25), want)


def test_wrappers_raise():
    """No silent fallback: a device that is neither CPU nor CUDA raises, as
    does a K that does not match."""
    x = torch.empty((2, 8), device="meta", dtype=torch.bfloat16)
    w = torch.empty((8, 4), device="meta", dtype=torch.int8)
    s = torch.empty((1, 4), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        ti8.pallas_i8_matmul(x, w, s)
    with pytest.raises(ValueError, match="unsupported device"):
        ti4.pallas_nib_matmul(x, w[:4], s)
    with pytest.raises(ValueError, match="differ in K"):
        ti8.pallas_i8_matmul(torch.zeros(2, 7).bfloat16(),
                             torch.zeros(8, 4, dtype=torch.int8),
                             torch.ones(1, 4).bfloat16())


def test_gemv_splits():
    """The decode kernel's K split: ~8 blocks per SM over the 512-column
    tiles, at least 64 weight rows per slice."""
    assert ti8.gemv_splits(10240, 2048, 132) == 160     # wout: 4 tiles
    assert ti8.gemv_splits(2048, 14336, 132) == 32      # win: 28 tiles
    assert ti8.gemv_splits(2048, 58498, 132) == 10      # lm_head: 115
    assert ti8.gemv_splits(37, 5, 132) == 1


# -- quantize_int8 against JAX ---------------------------------------------

TINY = dict(vocab_size=120, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=128)


def _models(fusion):
    """(JAX params, port Phi) with the same fp32 weights, in ``fusion``."""
    jparams = jphi.init_phi_params(jphi.PhiConfig(**TINY),
                                   jax.random.PRNGKey(3))
    sd = phi_state_dict(jparams, num_layers=2)
    model = load_showo(Showo(ShowoConfig(vocab_size=120,
                                         llm=tphi.PhiConfig(**TINY))),
                       sd).showo
    if fusion == "qkv":
        jparams, _ = jphi.fuse_qkv(jparams), tphi.fuse_qkv(model)
    elif fusion == "mlp":
        jparams, _ = jphi.fuse_parallel_mlp(jparams), tphi.fuse_parallel_mlp(
            model)
    return jparams, model


@pytest.mark.parametrize("fusion", ["none", "qkv", "mlp"])
def test_quantize_int8_bit_exact_vs_jax(fusion):
    """Every matmul of the layout and lm_head: kernel_i8 and scale equal
    JAX's bit for bit; biases, norms and the embedding untouched."""
    jparams, model = _models(fusion)
    jq = jphi.quantize_int8(jparams)
    embed = model.model.embed_tokens.weight.clone()
    tphi.quantize_int8(model)
    seen = 0
    for name, path in tphi.INT8_LINEARS.items():
        node = jq["layers"].get(name)
        if node is None:
            continue
        for i, layer in enumerate(model.model.layers):
            mod = layer.get_submodule(path)
            assert isinstance(mod, tphi.Int8Linear)
            np.testing.assert_array_equal(mod.kernel_i8.numpy(),
                                          np.asarray(node["kernel_i8"][i]))
            np.testing.assert_array_equal(
                mod.scale.float().numpy(),
                np.asarray(node["scale"][i], np.float32))
            np.testing.assert_array_equal(mod.bias.numpy(),
                                          np.asarray(node["bias"][i]))
            seen += 1
    assert seen == {"none": 6, "qkv": 4, "mlp": 2}[fusion] * 2
    np.testing.assert_array_equal(model.lm_head.kernel_i8.numpy(),
                                  np.asarray(jq["lm_head"]["kernel_i8"]))
    np.testing.assert_array_equal(
        model.lm_head.scale.float().numpy(),
        np.asarray(jq["lm_head"]["scale"], np.float32))
    assert torch.equal(model.model.embed_tokens.weight, embed)
    assert model.model.layers[0].input_layernorm.weight.dtype == torch.float32
    # a second call leaves the quantized model as it is
    before = model.lm_head.w_i8.clone()
    tphi.quantize_int8(model)
    assert torch.equal(model.lm_head.w_i8, before)


def test_load_int8_params_from_jax():
    """The converter puts JAX's int8 params into the Int8Linear buffers of
    a quantized port Phi of the same layout: the buffers equal the port's
    own quantization of the same weights."""
    jparams, model = _models("mlp")
    tphi.quantize_int8(model)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    for mod in model.modules():
        if isinstance(mod, tphi.Int8Linear):
            mod.w_i8.zero_()
            mod.scale.zero_()
    load_int8_params(model, jphi.quantize_int8(jparams))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- the kernels on the card -------------------------------------------------

def _card(M, K, N, seed, nib=False):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    rows = K // 2 if nib else K
    w = torch.randint(-128 if nib else -127, 128, (rows, N), generator=g,
                      device=dev, dtype=torch.int8)
    s = (torch.rand(1, N, generator=g, device=dev) * 0.01 + 1e-3).bfloat16()
    b = torch.randn(N, generator=g, device=dev).bfloat16()
    return x, w, s, b


def _check_card(got, want):
    assert torch.isfinite(got).all()
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= CARD_TOL * peak


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3, 8, 270])
@pytest.mark.parametrize("K,N", [(2048, 14336), (10240, 2048), (2048, 58498),
                                 (130, 517)])
def test_int8_kernel_vs_plain_on_card(M, K, N):
    """Decode (M <= 4, the gemv kernel) and prefill (the mma kernel) at the
    slice's win / wout / lm_head shapes and a ragged one, with a bias."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, b = _card(M, K, N, seed=M + N)
    before = cuda_build.launches["int8_matmul"]
    got = ti8.pallas_i8_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert cuda_build.launches["int8_matmul"] == before + 1
    _check_card(got, ti8.i8_matmul_plain(x, w, s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 100])
def test_int4_kernel_vs_plain_on_card(M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, _ = _card(M, 2048, 8192, seed=M, nib=True)
    before = cuda_build.launches["int4_matmul"]
    got = ti4.pallas_nib_matmul(x, w, s)
    torch.cuda.synchronize()
    assert cuda_build.launches["int4_matmul"] == before + 1
    _check_card(got, ti4.nib_matmul_plain(x, w, s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 270])
def test_int8_kernel_unaligned_views_on_card(M):
    """A column slice at an odd offset (the lm_head slice of a quantized
    Phi) and an x row stride that is not 16-byte aligned take the kernels'
    byte-load paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, b = _card(M, 2051, 1000, seed=7)
    xv, wv, sv, bv = x[:, 3:], w[3:, 13:917], s[:, 13:917], b[13:917]
    got = ti8.pallas_i8_matmul(xv, wv, sv, bv)
    _check_card(got, ti8.i8_matmul_plain(xv, wv, sv, bv))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, _ = _card(2, 64, 32, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        ti8.pallas_i8_matmul(x.float(), w, s)
    with pytest.raises(TypeError, match="int8"):
        ti8.pallas_i8_matmul(x, w.float(), s)
    with pytest.raises(ValueError, match="contiguous"):
        ti8.pallas_i8_matmul(x, w.t().contiguous().t(), s)
