"""The cached step's one-kernel attention (``fused_decode_attention``) of
showo_tpu_torch.

On the CPU the wrapper runs its plain version, held against the JAX
Pallas kernel in interpret mode (as tests/test_fused_decode.py runs it),
fp32, atol 2e-5 / rtol 2e-5 (the tolerance of that test: LayerNorm,
RoPE and attention in fp32, differing only in summation order).  Inputs
are laid out as the cached step passes them: ``y`` a column slice of a
wider projection output, ck / cv views of a [layers, B, S_max, H, D]
cache.  The card-only cases hold the CUDA kernel against the plain
version in bf16 at atol 2e-2: the kernel rounds LayerNorm output and
each RoPE product to bf16 as the plain version does, but its rsqrt is
the card's approximate one, so a normalised value may differ by one bf16
ulp (2^-8 relative) and then move every score of its row; outputs are
convex combinations of ~N(0, 1) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models.phi import _rope_tables
from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops import fused_decode as jfd
from showo_tpu_torch.models.phi import rope_tables
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.ops import fused_decode as tfd

torch.set_num_threads(1)

PAD, SOI, EOI = 900, 901, 902
TOL = dict(atol=2e-5, rtol=2e-5)


def _t2i_seq(B, P, img, pads, seed):
    rng = np.random.default_rng(seed)
    rows = [[PAD] * p + rng.integers(5, 800, size=P - 1 - p).tolist() + [SOI]
            + rng.integers(5, 800, size=img).tolist() + [EOI]
            for p in pads[:B]]
    return np.asarray(rows)


def _inputs(B, P, S, H, D, seed, extra=5):
    """y as a column slice of a wider array, ck/cv as cache views, LN
    params, rope tables of the fresh rows (fp32 numpy + torch views)."""
    rng = np.random.default_rng(seed)
    hidden = H * D
    wide = rng.normal(size=(B, S, 4 * hidden + extra)).astype(np.float32)
    cache = rng.normal(size=(2, 2, B, P + S, H, D)).astype(np.float32)
    ln = [rng.normal(size=(D,)).astype(np.float32) for _ in range(4)]
    return wide, cache, ln


def _run_both(seq, P, H, D, seed, softmax_dtype=jnp.float32, meta=None):
    B, L = seq.shape
    S = L - P
    hidden = H * D
    rd = D // 2
    wide, cache, ln = _inputs(B, P, S, H, D, seed)
    if meta is None:
        jmeta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    else:
        jmeta = tuple(jnp.asarray(m) for m in meta)
    tmeta = tuple(torch.as_tensor(np.array(m)) for m in jmeta)
    cos, sin = _rope_tables(P + jnp.arange(S), rd, 10000.0)

    want = jfd.fused_decode_attention(
        jnp.asarray(wide[..., 1:4 * hidden + 1]),
        jnp.asarray(cache[1, 0, :, :P].reshape(B, P, hidden)),
        jnp.asarray(cache[1, 1, :, :P].reshape(B, P, hidden)),
        {"scale": jnp.asarray(ln[0]), "bias": jnp.asarray(ln[1])},
        {"scale": jnp.asarray(ln[2]), "bias": jnp.asarray(ln[3])},
        cos, sin, *jmeta, P + jnp.arange(S), hidden=hidden, num_heads=H,
        rotary_dim=rd, eps=1e-5, softmax_dtype=softmax_dtype,
        interpret=True)

    tw, tc = torch.as_tensor(wide), torch.as_tensor(cache)
    y = tw[..., 1:4 * hidden + 1]                     # a column slice
    ck = tc[1, 0, :, :P].flatten(2)                   # cache views
    cv = tc[1, 1, :, :P].flatten(2)
    assert not (y.is_contiguous() or ck.is_contiguous())
    tcos, tsin = rope_tables(P + torch.arange(S), rd, 10000.0)
    ln_t = [torch.as_tensor(x) for x in ln]
    got = tfd.fused_decode_attention(
        y, ck, cv, ln_t[:2], ln_t[2:], tcos, tsin, *tmeta,
        P + torch.arange(S), hidden=hidden, num_heads=H, rotary_dim=rd,
        eps=1e-5, softmax_dtype=(torch.float32 if softmax_dtype == jnp.float32
                                 else torch.bfloat16))
    assert got.shape == (B, S, hidden)
    return got, want


@pytest.mark.parametrize("H,D", [(4, 8), (2, 16)])
def test_plain_vs_jax_interpret_t2i(H, D):
    """t2i metadata with left pads, Q != K (S fresh rows after a P-row
    prefix), a non-contiguous y slice and cache views."""
    seq = _t2i_seq(3, P=7, img=9, pads=(0, 3, 5), seed=H)
    got, want = _run_both(seq, P=7, H=H, D=D, seed=D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_vs_jax_interpret_irregular_metadata():
    """Random segments, pads, last_pad and prefix over the logical
    sequence (as tests/test_fused_decode.py draws them)."""
    B, P, S = 2, 4, 6
    rng = np.random.default_rng(0)
    L = P + S
    meta = (rng.integers(0, 3, size=(B, L)).astype(np.int32),
            rng.integers(0, 2, size=(B, L)).astype(np.int32),
            np.asarray([3, 100], np.int32), np.asarray([0, 2], np.int32))
    got, want = _run_both(np.zeros((B, L), np.int64), P, H=4, D=8, seed=1,
                          meta=meta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_rows_match_the_jax_gather():
    """pos_k = [0..P-1, q_positions] and seg/pad gathered at it, with
    positions past the logical map reading 0, as the JAX wrapper pads."""
    seg = torch.as_tensor([[0, 0, 1, 1, 1, 2], [0, 3, 3, 0, 0, 0]],
                          dtype=torch.int32)
    pad = torch.as_tensor([[1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 1]],
                          dtype=torch.int32)
    pos_q, seg_q, pos_k, seg_k, pad_k = tfd.fused_rows(
        seg, pad, torch.arange(3, 7), 2, 2)
    assert pos_k.tolist() == [0, 1, 3, 4, 5, 6]
    assert pos_q.tolist() == [[3, 4, 5, 6]] * 2
    assert seg_q.tolist() == [[1, 1, 2, 0], [0, 0, 0, 0]]
    assert seg_k.tolist() == [[0, 0, 1, 1, 2, 0], [0, 3, 0, 0, 0, 0]]
    assert pad_k.tolist() == [[1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 1, 0]]
    for t in (pos_q, seg_q, pos_k, seg_k, pad_k):
        assert t.dtype == torch.int32 and t.is_contiguous()
    with pytest.raises(ValueError, match=r"\[S\]"):
        tfd.fused_rows(seg, pad, torch.arange(8).view(2, 4), 2, 2)


def test_bf16_softmax_plain_vs_jax():
    """softmax_dtype=bf16 (``attn_fp32=False``) exists in the plain
    version only: close to the JAX kernel's bf16 softmax (bf16 scores and
    probabilities, atol 2e-2)."""
    seq = _t2i_seq(2, P=7, img=9, pads=(0, 3), seed=8)
    got, want = _run_both(seq, P=7, H=4, D=8, seed=9,
                          softmax_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_fully_masked_row_averages_v():
    """A fresh row that sees nothing (every key a pad, last_pad before it)
    averages v over the K = P + S keys."""
    B, P, S, H, D = 1, 3, 4, 2, 8
    hidden = H * D
    rng = np.random.default_rng(4)
    y = torch.as_tensor(rng.normal(size=(B, S, 3 * hidden)).astype(np.float32))
    ck, cv = (torch.as_tensor(rng.normal(size=(B, P, hidden)).astype(
        np.float32)) for _ in range(2))
    L = P + S
    cos, sin = rope_tables(P + torch.arange(S), D // 2, 10000.0)
    ln = (torch.ones(D), torch.zeros(D))
    out = tfd.fused_decode_attention(
        y, ck, cv, ln, ln, cos, sin, torch.zeros((B, L), dtype=torch.int32),
        torch.ones((B, L), dtype=torch.int32),
        torch.full((B,), -1, dtype=torch.int32),
        torch.zeros((B,), dtype=torch.int32), P + torch.arange(S),
        hidden=hidden, num_heads=H, rotary_dim=D // 2)
    v = torch.cat([cv, y[..., 2 * hidden:]], dim=1)
    np.testing.assert_allclose(out.numpy(),
                               v.mean(dim=1, keepdim=True).expand_as(
                                   out).numpy(), atol=1e-6)


def test_wrapper_raises():
    """No silent fallback: a device that is neither CPU nor CUDA raises, as
    does a y too narrow for q/k/v."""
    B, P, S, H, D = 1, 2, 3, 2, 8
    hidden = H * D
    meta = dict(device="meta")
    y = torch.empty((B, S, 3 * hidden), **meta)
    ck = torch.empty((B, P, hidden), **meta)
    ln = (torch.empty(D, **meta), torch.empty(D, **meta))
    cs = torch.empty((S, D // 2), **meta)
    m = [torch.zeros((B, P + S), dtype=torch.int32, **meta)] * 2 + [
        torch.zeros((B,), dtype=torch.int32, **meta)] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.fused_decode_attention(y, ck, ck, ln, ln, cs, cs, *m,
                                   torch.arange(P, P + S, **meta),
                                   hidden=hidden, num_heads=H,
                                   rotary_dim=D // 2)
    with pytest.raises(ValueError, match="must hold q/k/v"):
        tfd.fused_decode_attention(torch.zeros((B, S, 2 * hidden)), ck, ck,
                                   ln, ln, cs, cs, *m, None, hidden=hidden,
                                   num_heads=H, rotary_dim=D // 2)


def _card_case(dev, P, S, seed):
    """The cached step's operands at full width: y a [B, S, 14336] win
    output, ck/cv views of a 24-layer cache, bf16 LN params, t2i
    metadata with left pads."""
    B, H, D = 4, 32, 64
    hidden = H * D
    seq = torch.as_tensor(_t2i_seq(B, P, S - 2, (0, 17, 60, 3), seed),
                          device=dev)
    seg, pad, last_pad, prefix = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(B, S, 3 * hidden + 8192, generator=g,
                    device=dev).bfloat16()
    cache = torch.randn(2, B, P + S, H, D, generator=g, device=dev).bfloat16()
    ln = [(1 + 0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (1 + 0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (0.1 * torch.randn(D, generator=g, device=dev)).bfloat16()]
    cos, sin = rope_tables(P + torch.arange(S, device=dev), 32, 10000.0)
    pos = P + torch.arange(S, device=dev)
    rows = tfd.fused_rows(seg, pad, pos, P, B)
    args = (y, cache[0, :, :P].flatten(2), cache[1, :, :P].flatten(2),
            ln[:2], ln[2:], cos, sin, seg, pad, last_pad, prefix, pos)
    kw = dict(hidden=hidden, num_heads=H, rotary_dim=32, eps=1e-5)
    return args, kw, rows


@pytest.mark.cuda
@pytest.mark.parametrize("P,S", [(129, 258), (129, 1026), (64, 40)],
                         ids=["256px", "512px", "aligned_prefix_short"])
def test_kernel_vs_plain_on_card(P, S):
    """The 256^2 and 512^2 cached-step shapes (P = 129: a K tile holds
    both prefix and fresh rows), and a tile-aligned prefix with fewer
    fresh rows than one q tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    args, kw, rows = _card_case(dev, P, S, seed=S)
    before = cuda_build.launches["fused_decode"]
    got = tfd.fused_decode_attention(*args, **kw, rows=rows)
    torch.cuda.synchronize()
    assert cuda_build.launches["fused_decode"] == before + 1
    want = tfd.fused_decode_attention_plain(
        *args[:7], args[9], args[10], rows, **kw, sm_scale=0.125,
        softmax_dtype=torch.float32)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    args, kw, rows = _card_case(dev, 129, 64, seed=0)
    with pytest.raises(ValueError, match="fp32 softmax"):
        tfd.fused_decode_attention(*args, **kw, rows=rows,
                                   softmax_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rotary dim 16"):
        tfd.fused_decode_attention(*args, **dict(kw, rotary_dim=16),
                                   rows=rows)
    with pytest.raises(TypeError, match="bf16"):
        tfd.fused_decode_attention(args[0].float(), *args[1:], **kw,
                                   rows=rows)
