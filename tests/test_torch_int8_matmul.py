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
every layout, and at the serving engine's rows (M = 8 / 24 / 328) the plain
version is held to JAX's dequantized product within 1e-2 of the peak.  The
card-only cases hold each CUDA kernel against its plain version at the
slices' shapes (Phi's and Qwen2.5-1.5B's, the serving rows among them)
within 2e-2 of the output's peak; above the
decode rows they also check which core ran (``launches["int8_matmul_<core>"]``,
``launches["int4_matmul_<core>"]``) and that split-K gives the same bits
on two calls.  ``prefill_plan`` (the prefill kernel's tiles and split, for
int4 over the packed rows) and ``select_core`` (which kernel a product
goes to, from shapes, strides and alignment) are checked on the CPU.
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


SLICE_PLANS = {
    # (M, K, N): (x rows of a tile, splits, K tiles per split) on 132 SMs
    (267, 2048, 14336): (144, 1, 32),   # win at the discrete prefill
    (267, 10240, 2048): (144, 8, 20),   # wout: 32 tiles, 256 blocks
    (267, 2048, 58498): (144, 1, 32),   # lm_head: 458 N tiles
    (609, 2048, 14336): (208, 1, 32),   # win at the CLIP-ViT prefill
    (8, 2048, 8192): (8, 4, 8),         # the probes: 64 tiles, 256 blocks
    # int4 (chip_smoke.py phase 9): K counts the 1024 packed rows of
    # K = 2048, each K tile 64 packed rows (128 weight rows)
    (267, 1024, 14336): (144, 1, 16),
    (609, 1024, 14336): (208, 1, 16),
    (65, 1024, 58498): (96, 1, 16),     # lm_head, ragged rows
    (8, 1024, 8192): (8, 4, 4),
}


@pytest.mark.parametrize("shape", list(SLICE_PLANS))
def test_prefill_plan_slice_shapes(shape):
    """The prefill kernel's plans at the slice's and the probes' shapes,
    int8 and int4."""
    plan = ti8.prefill_plan(*shape, sms=132)
    assert (plan.bm, plan.splits, plan.k_tiles_per_split) == \
        SLICE_PLANS[shape]


@pytest.mark.parametrize("M", [5, 8, 63, 64, 65, 128, 129, 267, 609, 4096])
@pytest.mark.parametrize("K,N", [(64, 8), (130, 517), (2000, 3000),
                                 (10240, 2048), (2048, 58498)])
@pytest.mark.parametrize("sms", [1, 132])
def test_prefill_plan_invariants(M, K, N, sms):
    """Every block gets at least one K tile; K is split only where the M x
    N tiles are fewer than the SMs; the tiles cover M, N and K; as few row
    tiles as 256-row ones would take, each the narrowest that covers M."""
    p = ti8.prefill_plan(M, K, N, sms)
    assert p.bm in ti8.PF_NT
    assert p.m_tiles == -(-M // 256)
    assert all(nt * p.m_tiles < M for nt in ti8.PF_NT if nt < p.bm)
    assert p.m_tiles * p.bm >= M > (p.m_tiles - 1) * p.bm
    assert p.n_tiles * ti8.PF_BN >= N > (p.n_tiles - 1) * ti8.PF_BN
    assert p.k_tiles * ti8.PF_BK >= K > (p.k_tiles - 1) * ti8.PF_BK
    assert p.splits * p.k_tiles_per_split >= p.k_tiles
    assert (p.splits - 1) * p.k_tiles_per_split < p.k_tiles   # last: >= 1
    assert p.splits == 1 or p.m_tiles * p.n_tiles < sms


# (source, M, K, x_ptr, ldx, w rows 16-byte aligned) -> core
CORES = [
    ("int8_matmul", 1, 2048, 0, 2048, True, "gemv"),
    ("int8_matmul", 4, 2048, 16, 2048, False, "gemv"),
    ("int8_matmul", 5, 2048, 0, 2048, True, "prefill"),
    ("int8_matmul", 267, 2051, 6, 2051, True, "mma"),      # x[:, 3:]
    ("int8_matmul", 267, 2048, 0, 2052, True, "mma"),      # row stride
    ("int8_matmul", 267, 2048, 0, 2048, False, "mma"),     # w rows
    ("int4_matmul", 3, 2048, 0, 2048, True, "gemv"),
    ("int4_matmul", 8, 2048, 0, 2048, True, "prefill"),
    ("int4_matmul", 267, 2048, 4096, 4096, True, "prefill"),
    ("int4_matmul", 267, 2064, 0, 2064, True, "prefill"),  # K/2 = 1032
    ("int4_matmul", 267, 2052, 0, 2056, True, "mma"),      # K/2 = 1026
    ("int4_matmul", 65, 2048, 8, 2048, True, "mma"),       # x base
    ("int4_matmul", 65, 2048, 0, 2048, False, "mma"),      # w rows
]


@pytest.mark.parametrize("source,M,K,x_ptr,ldx,w16,core", CORES)
def test_select_core(source, M, K, x_ptr, ldx, w16, core):
    """The core a product goes to, from M, K, x's base and row stride and
    the w rows' alignment: gemv up to 4 rows, the prefill kernel above
    where every row (int4: and x's second half) is 16-byte aligned, the
    first mma kernel otherwise."""
    assert ti8.select_core(source, M, K, x_ptr, ldx, w16) == core


GEMV_PLANS = {
    # (rows, N): (cw, tiles, splits, rows per split) on 132 SMs
    (2048, 14336): (32, 28, 9, 228),    # win: 252 blocks
    (10240, 2048): (8, 16, 16, 640),    # wout: 128-byte tiles, 256 blocks
    (2048, 58498): (32, 115, 2, 1024),  # lm_head, ragged N: 230 blocks
    (1024, 58498): (32, 115, 2, 512),   # int4 lm_head (K/2 packed rows)
}


@pytest.mark.parametrize("shape", list(GEMV_PLANS))
def test_gemv_plan_slice_shapes(shape):
    """The decode kernel's plans at the slice's win / wout / lm_head and
    int4 lm_head's packed rows."""
    plan = ti8.gemv_plan(*shape, sms=132)
    assert (plan.cw, plan.tiles, plan.splits, plan.rows_per_split) == \
        GEMV_PLANS[shape]


@pytest.mark.parametrize("rows,N", [(2048, 14336), (10240, 2048),
                                    (2048, 58498), (1024, 14336),
                                    (37, 5), (130, 517), (2048, 904),
                                    (100000, 64)])
@pytest.mark.parametrize("sms", [1, 132])
def test_gemv_plan_invariants(rows, N, sms):
    """Every weight row in exactly one K range, each range non-empty and
    within the rows whose x fits shared memory; the column tiles cover N;
    a block for every SM wherever the rows allow it (their ranges at
    least a ring stage), at most two an SM; the ranges in the one order
    the kernel adds them, the same on every call."""
    p = ti8.gemv_plan(rows, N, sms)
    assert p.cw in ti8.GEMV_CW
    ct = 16 * p.cw
    assert p.tiles * ct >= N > (p.tiles - 1) * ct
    per = p.rows_per_split      # range s: rows [s * per, (s + 1) * per)
    ranges = [(s * per, min(rows, s * per + per)) for s in range(p.splits)]
    assert [b for b, _ in ranges] == [0] + [e for _, e in ranges[:-1]]
    assert ranges[-1][1] == rows and all(b < e for b, e in ranges)
    assert max(e - b for b, e in ranges) <= ti8.GEMV_MAX_ROWS
    assert p.splits <= max(ti8.GEMV_MAX_SPLITS,
                           -(-rows // ti8.GEMV_MAX_ROWS))
    blocks, least = p.tiles * p.splits, -(-rows // ti8.GEMV_MAX_ROWS)
    # the most blocks the narrowest tiles could give
    room = -(-N // 128) * min(ti8.GEMV_MAX_SPLITS,
                              -(-rows // (ti8.GEMV_STAGE // 128)))
    if room >= sms:
        assert blocks >= sms
    assert blocks <= 2 * sms or p.splits in (1, least)
    assert ti8.gemv_plan(rows, N, sms) == p


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


def _gemv_call(fmt, M, K, N, seed):
    """(kernel call, plain call, weights, scale) of one decode product:
    int8 or int4 weights with rows padded to 16 bytes (as Int8Linear pads
    them) cut to N columns, and a bias."""
    nib = fmt == "int4"
    x, w, s, b = _card(M, K, -(-N // 16) * 16, seed=seed, nib=nib)
    w, s, b = w[:, :N], s[:, :N], b[:N]
    kern = ti4.pallas_nib_matmul if nib else ti8.pallas_i8_matmul
    plain = ti4.nib_matmul_plain if nib else ti8.i8_matmul_plain
    return (lambda: kern(x, w, s, b)), (lambda s_=s: plain(x, w, s_, b)), w, s


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("K,N", [(2048, 14336), (10240, 2048), (2048, 58498),
                                 (130, 517)])
def test_gemv_kernel_vs_plain_on_card(fmt, M, K, N):
    """The decode kernel at the slice's win / wout / lm_head (N = 58498
    ragged) and a small ragged shape, both formats, M = 1..4, with a bias:
    one launch of the gemv core a product, within 2e-2 of the peak of the
    plain version; a planted fault (each column scaled by its neighbour's
    scale) fails the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kern, plain, _, s = _gemv_call(fmt, M, K, N, seed=M * 13 + N)
    source = "int4_matmul" if fmt == "int4" else "int8_matmul"
    names = (source, f"{source}_gemv", f"{source}_prefill", f"{source}_mma")
    before = {n: cuda_build.launches[n] for n in names}
    got = kern()
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        source: 1, f"{source}_gemv": 1, f"{source}_prefill": 0,
        f"{source}_mma": 0}
    want = plain()
    _check_card(got, want)
    with pytest.raises(AssertionError):
        _check_card(plain(s.roll(1, dims=-1)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("K,N", [(2048, 14336), (10240, 2048), (2048, 58498)])
def test_gemv_split_k_bit_stable_on_card(fmt, K, N):
    """Where the plan splits K, the last block of each column tile adds the
    splits in split order: two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = K // 2 if fmt == "int4" else K
    assert ti8.gemv_plan(rows, N, sms).splits > 1
    kern, plain, _, _ = _gemv_call(fmt, 1, K, N, seed=K + N)
    first, second = kern(), kern()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _check_card(first, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_gemv_one_device_launch_per_product_on_card(fmt):
    """A decode product is one launch on the device (torch.profiler's
    kernel events), also where K is split (wout: 16 ranges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    kern, _, _, _ = _gemv_call(fmt, 1, 10240, 2048, seed=21)
    kern()
    torch.cuda.synchronize()
    calls = 5
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):      # a trace may lose device events: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                kern()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == cuda]
        if len(names) >= calls:
            break
    assert len(names) == calls, names
    assert all("gemv_kernel" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4])
def test_int4_gemv_unaligned_views_on_card(M):
    """int4 at decode on a column slice of the packed rows at an odd
    offset and x's columns at an odd offset: the rows are copied into the
    ring by plain loads; one launch of the gemv core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, b = _card(M, 2051, 1000, seed=17 + M, nib=True)
    xv = x[:, 3:]
    wv, sv, bv = w[:1024, 13:917], s[:, 13:917], b[13:917]
    before = cuda_build.launches["int4_matmul_gemv"]
    got = ti4.pallas_nib_matmul(xv, wv, sv, bv)
    torch.cuda.synchronize()
    assert cuda_build.launches["int4_matmul_gemv"] == before + 1
    _check_card(got, ti4.nib_matmul_plain(xv, wv, sv, bv))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [5, 8, 63, 65, 267, 609])
@pytest.mark.parametrize("K,N", [(2000, 3000), (2048, 58498)])
def test_int8_prefill_kernel_vs_plain_on_card(M, K, N):
    """The prefill kernel (x and w rows 16-byte aligned, as Int8Linear pads
    them) above the decode rows: ragged M, a K that is not a multiple of
    64, the vocabulary's N = 58498, a bias; one product, one launch of the
    prefill core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, b = _card(M, K, -(-N // 16) * 16, seed=M * 7 + K)
    w, s, b = w[:, :N], s[:, :N], b[:N]
    before = {n: cuda_build.launches[n] for n in
              ("int8_matmul", "int8_matmul_prefill", "int8_matmul_mma")}
    got = ti8.pallas_i8_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in before} == {
        "int8_matmul": 1, "int8_matmul_prefill": 1, "int8_matmul_mma": 0}
    _check_card(got, ti8.i8_matmul_plain(x, w, s, b))


# Qwen2.5-1.5B's int8 products (Show-o2 understanding): (K, N, bias) of the
# fused qkv (with its bias), o, gate-up, down and the tied lm_head
QWEN_SHAPES = {"qkv": (1536, 2048, True), "o": (1536, 1536, False),
               "gate-up": (1536, 17920, False), "down": (8960, 1536, False),
               "lm_head": (1536, 151940, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 744, 2202], ids=["decode", "image-prompt",
                                                   "video-prompt"])
@pytest.mark.parametrize("name", list(QWEN_SHAPES))
def test_int8_kernel_vs_plain_qwen_shapes_on_card(name, M):
    """Kernel 9 at each Qwen2 product of the v2 understanding slice, at
    decode (the gemv) and at the image and video prompts' rows (the prefill
    kernel), with weight rows padded to 16 bytes as Int8Linear pads them
    (151940 -> 151952 at the head): the core that ran, one product, within
    2e-2 of the output's peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    K, N, has_bias = QWEN_SHAPES[name]
    x, w, s, b = _card(M, K, -(-N // 16) * 16, seed=M + K + N)
    w, s, b = w[:, :N], s[:, :N], (b[:N] if has_bias else None)
    core = "int8_matmul_gemv" if M == 1 else "int8_matmul_prefill"
    before = {n: cuda_build.launches[n] for n in
              ("int8_matmul", "int8_matmul_gemv", "int8_matmul_prefill",
               "int8_matmul_mma")}
    got = ti8.pallas_i8_matmul(x, w, s, b)
    torch.cuda.synchronize()
    want = {n: 0 for n in before}
    want.update({"int8_matmul": 1, core: 1})
    assert {n: cuda_build.launches[n] - before[n] for n in before} == want
    _check_card(got, ti8.i8_matmul_plain(x, w, s, b))


# the serving engine's rows (serving/): decode at slots x window = 8 x 1
# and 8 x 3 (speculation with 2 drafts), fused admission at slots + the
# smallest bucket, 8 + 320
SERVING_ROWS = (8, 24, 328)
# JAX's int8 serving computes x @ bf16(w_i8 * scale) (``_wk``); the plain
# version scales the fp32 sum: max |difference| / peak (the limit of
# tests/test_torch_mmu.py for the same difference)
DEQUANT_REL = 1e-2
# Phi-1.5's serving products, (K, N): win, wout and lm_head
PHI_SHAPES = {"win": (2048, 14336), "wout": (10240, 2048),
              "lm_head": (2048, 58498)}


@pytest.mark.parametrize("M", SERVING_ROWS)
@pytest.mark.parametrize("K,N", [(2048, 640), (1536, 896)])
def test_plain_at_serving_rows_vs_jax_dequant(M, K, N):
    """The plain version at the serving rows against JAX's dequantized
    product ``x @ (w_i8.astype(bf16) * scale) + bias`` on the CPU."""
    x, w, s = _inputs(M, K, N, seed=M + K)
    bias = np.random.default_rng(N).normal(size=N).astype(np.float32)
    jx, jw, js = _jax(x, w, s)
    want = np.asarray((jx @ (jw.astype(jnp.bfloat16) * js)
                       + jnp.asarray(bias, jnp.bfloat16)), np.float32)
    got = ti8.pallas_i8_matmul(*_torch(x, w, s),
                               torch.as_tensor(bias).bfloat16())
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    peak = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= DEQUANT_REL * peak


@pytest.mark.cuda
@pytest.mark.parametrize("M", SERVING_ROWS)
@pytest.mark.parametrize("name", list(PHI_SHAPES) + [
    f"qwen {n}" for n in QWEN_SHAPES])
def test_int8_kernel_vs_plain_serving_rows_on_card(name, M):
    """Kernel 9 at the serving engine's rows, at Phi's and Qwen2.5's
    products (weight rows padded to 16 bytes, as Int8Linear pads them):
    one launch of the prefill core a product, within 2e-2 of the plain
    version's peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if name.startswith("qwen "):
        K, N, has_bias = QWEN_SHAPES[name[5:]]
    else:
        (K, N), has_bias = PHI_SHAPES[name], True
    x, w, s, b = _card(M, K, -(-N // 16) * 16, seed=M * 3 + K + N)
    w, s, b = w[:, :N], s[:, :N], (b[:N] if has_bias else None)
    before = {n: cuda_build.launches[n] for n in
              ("int8_matmul", "int8_matmul_gemv", "int8_matmul_prefill",
               "int8_matmul_mma")}
    got = ti8.pallas_i8_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in before} == {
        "int8_matmul": 1, "int8_matmul_gemv": 0, "int8_matmul_prefill": 1,
        "int8_matmul_mma": 0}
    _check_card(got, ti8.i8_matmul_plain(x, w, s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(267, 10240, 2048), (8, 2048, 8192),
                                   (63, 2000, 3000)])
def test_int8_prefill_split_k_bit_stable_on_card(M, K, N):
    """Where the plan splits K, the fixed-order finish gives the same bits
    on two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ti8.prefill_plan(M, K, N, sms).splits > 1
    x, w, s, b = _card(M, K, -(-N // 16) * 16, seed=11)
    w, s, b = w[:, :N], s[:, :N], b[:N]
    before = cuda_build.launches["int8_matmul_prefill"]
    first = ti8.pallas_i8_matmul(x, w, s, b)
    second = ti8.pallas_i8_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert cuda_build.launches["int8_matmul_prefill"] == before + 2
    assert torch.equal(first, second)
    _check_card(first, ti8.i8_matmul_plain(x, w, s, b))


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
@pytest.mark.parametrize("M", [8, 65, 267])
@pytest.mark.parametrize("N", [14336, 58498])
def test_int4_prefill_kernel_vs_plain_on_card(M, N):
    """The int4 prefill kernel (the nibble layout of the prefill core) at
    K = 2048 with 16-byte aligned rows: the probes' rows, a ragged M = 65
    and the discrete prefill's 267, at win's N and the vocabulary's ragged
    58498 (rows padded to 16 bytes), with a bias; one launch of the
    prefill core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, s, b = _card(M, 2048, -(-N // 16) * 16, seed=M + 4 * N, nib=True)
    w, s, b = w[:, :N], s[:, :N], b[:N]
    names = ("int4_matmul", "int4_matmul_prefill", "int4_matmul_mma")
    before = {n: cuda_build.launches[n] for n in names}
    got = ti4.pallas_nib_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        "int4_matmul": 1, "int4_matmul_prefill": 1, "int4_matmul_mma": 0}
    _check_card(got, ti4.nib_matmul_plain(x, w, s, b))


@pytest.mark.cuda
def test_int4_prefill_split_k_bit_stable_on_card():
    """The probes' shape splits K over the packed rows; the fixed-order
    finish gives the same bits on two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ti8.prefill_plan(8, 1024, 8192, sms).splits > 1
    x, w, s, b = _card(8, 2048, 8192, seed=12, nib=True)
    before = cuda_build.launches["int4_matmul_prefill"]
    first = ti4.pallas_nib_matmul(x, w, s, b)
    second = ti4.pallas_nib_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert cuda_build.launches["int4_matmul_prefill"] == before + 2
    assert torch.equal(first, second)
    _check_card(first, ti4.nib_matmul_plain(x, w, s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["x columns", "odd half"])
def test_int4_unaligned_rows_take_the_mma_core_on_card(view):
    """Rows the prefill kernel does not take go to the first mma kernel:
    x as a column slice at an odd offset, or K/2 = 1026 with x's rows
    16-byte aligned (row stride 2056) but its second half not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if view == "x columns":
        x, w, s, b = _card(65, 2051, 1008, seed=13, nib=True)
        x = x[:, 3:]
        w = w[:1024]
    else:
        x, w, s, b = _card(65, 2052, 1008, seed=14, nib=True)
        x = torch.nn.functional.pad(x, (0, 4))[:, :2052]
    names = ("int4_matmul_prefill", "int4_matmul_mma")
    before = {n: cuda_build.launches[n] for n in names}
    got = ti4.pallas_nib_matmul(x, w, s, b)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        "int4_matmul_prefill": 0, "int4_matmul_mma": 1}
    _check_card(got, ti4.nib_matmul_plain(x, w, s, b))


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
    core = "int8_matmul_gemv" if M <= ti8.GEMV_MAX_M else "int8_matmul_mma"
    before = {n: cuda_build.launches[n] for n in (core, "int8_matmul_prefill")}
    got = ti8.pallas_i8_matmul(xv, wv, sv, bv)
    torch.cuda.synchronize()
    # unaligned rows never reach the prefill kernel
    assert {n: cuda_build.launches[n] - before[n] for n in before} == {
        core: 1, "int8_matmul_prefill": 0}
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
