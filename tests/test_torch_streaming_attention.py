"""K-blocked omni attention of showo_tpu_torch (kernel 5,
``ops/streaming_attention.py``) against the JAX package's Pallas kernel
``omni_attention_streaming`` in interpret mode with small blocks, on the
cases of tests/test_streaming_attention.py: a t2i mask over many blocks,
an mmu prefix, GQA, the prefix-cached Q != K step, a long ragged S,
block skipping, and rows that see no key emitting 0.

Inputs are made with numpy from a seed; each metadata set is made once
(with the JAX functions) and handed to both packages.  fp32 on the CPU at
atol/rtol 1e-5: both take exact fp32 products and an fp32 softmax and
differ only in summation order (the port's plain version sums each row
at once, the kernel over K blocks).  bf16 inputs at atol 2e-2: both round
the unnormalised probabilities to bf16 before the product with v, at
different running maxima, so an output (a convex combination of ~N(0, 1)
values) moves by up to a few bf16 ulps.  The card-only cases hold the
CUDA kernel against the plain version in bf16 at atol 2e-2, as
chip_smoke.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops.streaming_attention import \
    omni_attention_streaming as j_stream
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.ops import streaming_attention as tsa

torch.set_num_threads(1)

PAD, SOI, EOI = 900, 901, 902
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B, H, Q, S, D, seed, Hkv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Q, D)).astype(np.float32),
            rng.normal(size=(B, Hkv or H, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv or H, S, D)).astype(np.float32))


def _t2i_rows(pads, text, img, seed):
    rng = np.random.default_rng(seed)
    return np.asarray([[PAD] * p + rng.integers(5, 800, size=text - p).tolist()
                       + [SOI] + rng.integers(5, 800, size=img).tolist()
                       + [EOI] for p in pads])


def _compare(q, k, v, meta, *, bq, bk, P=0, tol=TOL, dtype=None):
    """The port's wrapper (plain version on the CPU) against the Pallas
    kernel in interpret mode on the same arrays; ``P`` > 0 takes the last
    rows of q at kv positions P.. (the prefix-cached step)."""
    S = k.shape[2]
    jpos = jnp.arange(P, S) if P else None
    tpos = torch.arange(P, S) if P else None
    jarr = [jnp.asarray(x) for x in (q, k, v)]
    tarr = [torch.as_tensor(x) for x in (q, k, v)]
    if dtype is not None:
        jarr = [x.astype(jnp.bfloat16) for x in jarr]
        tarr = [x.to(dtype) for x in tarr]
    want = j_stream(*jarr, *(jnp.asarray(m) for m in meta), block_q=bq,
                    block_k=bk, interpret=True, q_positions=jpos)
    got = tsa.omni_attention_streaming(
        *tarr, *(torch.as_tensor(np.array(m)) for m in meta),
        q_positions=tpos)
    assert got.shape == q.shape and got.dtype == tarr[0].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    return got


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_t2i_mask_multiblock_vs_jax(dtype):
    """v1 predict-next metadata (left pads, an image span) over 4 K blocks
    of 16; bf16 inputs to the dtype's rounding."""
    seq = _t2i_rows((0, 5), text=20, img=40, seed=0)
    B, S = seq.shape
    meta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    q, k, v = _qkv(B, 2, S, S, 8, seed=1)
    if dtype == "fp32":
        _compare(q, k, v, meta, bq=16, bk=16)
    else:
        _compare(q, k, v, meta, bq=16, bk=16, dtype=torch.bfloat16,
                 tol=dict(atol=2e-2, rtol=0))


@pytest.mark.parametrize("Hkv", [6, 1])
def test_head_dim_128_vs_jax(Hkv):
    """Head dim 128, the width of Qwen2.5's heads (12 q / 2 kv in the
    Show-o2 model): v2 modality-span metadata, prefix-cached rows, 6 q
    heads over 6 or 1 kv heads."""
    L, P = 40, 8
    seg = jfa.seg_from_modality_positions(
        jnp.asarray([[[4, 10], [20, 12]], [[9, 16], [0, 0]]]), L)
    meta = (seg, jnp.zeros((2, L), jnp.int32), jnp.full((2,), -1, jnp.int32),
            jnp.zeros((2,), jnp.int32))
    q, k, v = _qkv(2, 6, L - P, L, 128, seed=10, Hkv=Hkv)
    _compare(q, k, v, meta, bq=8, bk=8, P=P)


def test_mmu_prefix_vs_jax():
    rng = np.random.default_rng(1)
    seq = np.asarray([[905, SOI] + rng.integers(5, 800, size=12).tolist()
                      + [EOI] + rng.integers(5, 800, size=10).tolist()
                      for _ in range(2)])
    B, S = seq.shape
    q, k, v = _qkv(B, 2, S, S, 8, seed=2)
    _compare(q, k, v, jfa.metadata_mmu(jnp.asarray(seq), EOI), bq=8, bk=8)


def test_gqa_v2_spans_vs_jax():
    """v2 modality-span segments with grouped kv heads (H=4, Hkv=2)."""
    L = 24
    seg = jfa.seg_from_modality_positions(
        jnp.asarray([[[3, 5], [12, 5]], [[5, 5], [0, 0]]]), L)
    meta = (seg, jnp.zeros((2, L), jnp.int32), jnp.full((2,), -1, jnp.int32),
            jnp.zeros((2,), jnp.int32))
    q, k, v = _qkv(2, 4, L, L, 8, seed=3, Hkv=2)
    _compare(q, k, v, meta, bq=8, bk=8)


@pytest.mark.parametrize("Hkv", [2, 1])
def test_prefix_cached_q_ne_k_vs_jax(Hkv):
    """Q != K through q_positions (the prefix-cached MaskGIT step), with a
    left-padded prefix; also with one kv head for two q heads."""
    P = 10
    seq = _t2i_rows((2, 0, 6), text=P, img=12, seed=4)
    B, S = seq.shape
    meta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    q, k, v = _qkv(B, 2, S - P, S, 8, seed=5, Hkv=Hkv)
    _compare(q, k, v, meta, bq=8, bk=8, P=P)


def test_long_ragged_sequence_vs_jax():
    """S=1030, ragged against both block sizes: the accumulation over many
    K blocks; plain causal mask."""
    L = 1030
    meta = (jnp.zeros((1, L), jnp.int32), None, None, None)
    q, k, v = _qkv(1, 1, L, L, 8, seed=6)
    want = j_stream(*(jnp.asarray(x) for x in (q, k, v)), *meta,
                    block_q=256, block_k=256, interpret=True)
    got = tsa.omni_attention_streaming(
        *(torch.as_tensor(x) for x in (q, k, v)),
        torch.zeros((1, L), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_block_skip_equivalence_vs_jax():
    """A heavily padded row (many K blocks it cannot see) against the
    Pallas kernel, which skips those blocks."""
    seq = _t2i_rows((30,), text=34, img=28, seed=7)
    B, S = seq.shape
    meta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    q, k, v = _qkv(B, 2, S, S, 8, seed=8)
    _compare(q, k, v, meta, bq=8, bk=8)


def test_zero_visibility_rows_emit_zero():
    """Rows whose every column is a pad they may not see emit exactly 0,
    in the port and in the Pallas kernel alike; the other rows are a
    softmax over the visible suffix."""
    B, H, S, D = 1, 2, 8, 16
    q, k, v = _qkv(B, H, S, S, D, seed=7)
    pad = np.zeros((B, S), np.int32)
    pad[:, :2] = 1
    meta = (np.zeros((B, S), np.int32), pad, np.full((B,), -1, np.int32),
            np.zeros((B,), np.int32))
    got = _compare(q, k, v, meta, bq=8, bk=8)
    assert (got[:, :, :2] == 0).all()
    assert got[:, :, 2:].abs().max() > 0


def test_plain_matches_omni_where_every_row_sees_a_key():
    """Where every row sees a key, kernel 5's function is the omni
    kernel's (kernel 4): the two plain versions agree."""
    P = 9
    seq = torch.as_tensor(_t2i_rows((3, 0), text=12, img=15, seed=2))
    B, S = seq.shape
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, 4, S - P, S, 8, seed=9))
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    pos = torch.arange(P, S)
    np.testing.assert_allclose(
        tsa.omni_attention_streaming(q, k, v, *meta, q_positions=pos).numpy(),
        tfa.omni_attention(q, k, v, *meta, q_positions=pos).numpy(),
        atol=1e-6)


def test_wrapper_raises():
    """No silent fallback: a device neither CPU nor CUDA raises, as do a
    missing q_positions with Q != S and kv heads that do not divide the
    q heads."""
    q = torch.empty((1, 2, 4, 8), device="meta")
    seg = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.omni_attention_streaming(q, q, q, seg)
    q, k = torch.zeros((1, 2, 3, 8)), torch.zeros((1, 2, 5, 8))
    seg = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="q_positions"):
        tsa.omni_attention_streaming(q, k, k, seg)
    with pytest.raises(ValueError, match="kv heads"):
        tsa.omni_attention_streaming(torch.zeros((1, 3, 5, 8)), k, k, seg)


def test_streaming_tile_map_is_kernel_1s_on_the_cpu():
    """Kernel 5 reads the tile map of kernel 1's kind: on the CPU its maker
    gives the plain map of the same metadata (the plain version reads
    none)."""
    P = 9
    seq = torch.as_tensor(_t2i_rows((3, 0), text=12, img=150, seed=2))
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    pos_q, seg_q = tfa.q_rows(meta[0], torch.arange(P, seq.shape[1]),
                              seq.shape[0], seq.shape[1] - P)
    assert torch.equal(tsa.streaming_tile_map(*meta, pos_q, seg_q),
                       tfa.rows_tile_map_plain(*meta, pos_q))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_case(dev, P, Q, H, Hkv, seed=0, D=64):
    """The cached step's layout (B=4, left pads) at P prefix rows and Q
    fresh rows; q/k/v as transposed [B, S, H, D] views (phi's layout)."""
    seq = torch.as_tensor(_t2i_rows((0, 17, 60, 3), text=P, img=Q - 2,
                                    seed=11), device=dev)
    B, S = seq.shape
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=dev).bfloat16()
               .transpose(1, 2) for n, h in ((Q, H), (S, Hkv), (S, Hkv)))
    return q, k, v, meta, torch.arange(P, S, device=dev)


def _plain(q, k, v, meta, pos):
    B, Q = q.shape[0], q.shape[2]
    return tsa.omni_attention_streaming_plain(
        q, k, v, *meta, pos.int().expand(B, Q).contiguous(),
        sm_scale=q.shape[-1] ** -0.5)


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("Q,H,Hkv", [(258, 32, 32), (1026, 32, 32),
                                     (258, 32, 8), (101, 32, 8)])
def test_kernel_vs_plain_on_card(Q, H, Hkv):
    """The cached step's shapes (K = 129 + Q, ragged; Q not a multiple of
    64), GQA: one launch on the wgmma core after one tile map, within 2e-2
    of the plain version, the same bits over two launches on one map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta, pos = _card_case(dev, 129, Q, H, Hkv)
    B = q.shape[0]
    names = (tsa.SOURCE, tsa.TILES_KERNEL)
    before = {n: cuda_build.launches[n] for n in names}
    got = tsa.omni_attention_streaming(q, k, v, *meta, q_positions=pos)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        n: 1 for n in names}
    assert got.shape == (B, H, Q, 64) and torch.isfinite(got).all()
    assert _err(got, _plain(q, k, v, meta, pos)) <= 2e-2
    pos_q, seg_q = tfa.q_rows(meta[0], pos, B, Q)
    tiles = tsa.streaming_tile_map(*meta, pos_q, seg_q)
    assert torch.equal(tiles, tfa.rows_tile_map_plain(*meta, pos_q))
    runs = [tsa.omni_attention_streaming(q, k, v, *meta, q_positions=pos_q,
                                         seg_q=seg_q, tiles=tiles)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs) and torch.equal(runs[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_kernel_rows_without_keys_on_card(D):
    """Rows that see no key emit exactly 0 on the card too (their q tiles'
    flag in the map is not read: the -inf mask skips tiles exactly); the
    other rows within 2e-2 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    B, H, S = 2, 4, 200
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).bfloat16()
               for _ in range(3))
    seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
    pad = torch.zeros_like(seg)
    pad[:, :70] = 1
    last_pad = torch.full((B,), 5, dtype=torch.int32, device=dev)
    got = tsa.omni_attention_streaming(q, k, v, seg, pad, last_pad)
    want = tsa.omni_attention_streaming_plain(
        q, k, v, seg, pad, last_pad, torch.zeros_like(last_pad),
        torch.arange(S, device=dev).int().expand(B, S).contiguous(),
        sm_scale=D ** -0.5)
    assert (got[:, :, 6:70] == 0).all() and (want[:, :, 6:70] == 0).all()
    assert _err(got, want) <= 2e-2


@pytest.mark.cuda
def test_head_dim_128_qwen_shape_on_card():
    """Qwen2.5's 12 q / 2 kv heads of 128 at the Show-o2 slice's B=8,
    S=768 (self-attention over two image spans a row): within 2e-2 of the
    plain version; the same bits over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    B, S, H, Hkv, D = 8, 768, 12, 2, 128
    spans = torch.as_tensor([[[10 + 7 * b, 300], [400, 200 + 9 * b]]
                             for b in range(B)], device=dev)
    seg = tfa.seg_from_modality_positions(spans, S)
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).bfloat16()
               .transpose(1, 2) for h in (H, Hkv, Hkv))
    runs = [tsa.omni_attention_streaming(q, k, v, seg) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)
    want = tsa.omni_attention_streaming_plain(
        q, k, v, seg, torch.zeros_like(seg),
        torch.full((B,), -1, dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.int32, device=dev),
        torch.arange(S, device=dev).int().expand(B, S).contiguous(),
        sm_scale=D ** -0.5)
    assert _err(runs[0], want) <= 2e-2


@pytest.mark.cuda
def test_kernel_5_is_kernel_1_on_the_same_memory_on_card():
    """Where every row sees a key (the t2i layout), kernel 5 on head-major
    views of [B, S, H, D] tensors and kernel 1 on the same memory as
    [B, S, H*D] compute one function on one core: the outputs agree within
    2e-2 (the same bits expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta, pos = _card_case(dev, 129, 1026, 32, 8)
    got = tsa.omni_attention_streaming(q, k, v, *meta, q_positions=pos)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    want = tfa.omni_attention_packed(*packed, *meta, num_heads=32,
                                     num_kv_heads=8, q_positions=pos)
    assert _err(got.transpose(1, 2).flatten(2), want) <= 2e-2


@pytest.mark.cuda
def test_planted_fault_fails_on_card():
    """V read from the neighbouring kv head makes the kernel's result fail
    the 2e-2 check against the plain version: the check sees a wrong
    head."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta, pos = _card_case(dev, 129, 258, 32, 8)
    want = _plain(q, k, v, meta, pos)
    assert _err(tsa.omni_attention_streaming(
        q, k, v, *meta, q_positions=pos), want) <= 2e-2
    wrong = v.roll(1, dims=1)
    got = tsa.omni_attention_streaming(q, k, wrong, *meta, q_positions=pos)
    assert _err(got, want) > 2e-2


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    seg = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        tsa.omni_attention_streaming(q, q, q, seg)
    with pytest.raises(TypeError, match="bf16"):
        tsa.omni_attention_streaming(q.float(), q.float(), q.float(), seg)
    q = torch.zeros((1, 2, 8, 72), dtype=torch.bfloat16,
                    device="cuda")[..., 1:65]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tsa.omni_attention_streaming(q, q, q, seg)
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="tile map"):
        tsa.omni_attention_streaming(q, q, q, seg, tiles=torch.zeros(
            (1, 1, 1), dtype=torch.uint8, device="cuda"))
