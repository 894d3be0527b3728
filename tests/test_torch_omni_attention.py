"""Omni attention of showo_tpu_torch: the packed [B, S, H*D] and the
head-major [B, H, S, D] entry points.

On the CPU each wrapper runs its plain version, held against its JAX
Pallas kernel in interpret mode (as tests/test_flash_attention.py runs
them), fp32, atol 1e-5: both take exact fp32 products and an fp32
softmax, so they differ only in summation order.  The card-only cases
hold the CUDA kernel against the plain version in bf16 at atol 2e-2:
outputs are convex combinations of ~N(0, 1) values and bf16 carries 8
bits, and the kernel rounds the probabilities to bf16 before normalising
them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu_torch.models.phi import attention as dense_attention
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.ops import masks as tm

torch.set_num_threads(1)

PAD, SOI, EOI = 900, 901, 902


def _layout(B, text, img, pads, seed):
    rng = np.random.default_rng(seed)
    rows = [[PAD] * p + rng.integers(5, 800, size=text - p).tolist() + [SOI]
            + rng.integers(5, 800, size=img).tolist() + [EOI]
            for p in pads[:B]]
    return np.asarray(rows)


def _qkv(B, Q, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Q, H * D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv * D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv * D)).astype(np.float32))


# (name, B, H, Hkv, prefix rows P (0: Q == S), positions "none" | "q" | "bq")
CASES = [
    ("self_q_eq_s", 2, 2, 2, 0, "none"),
    ("cached_q_positions", 2, 4, 4, 9, "q"),
    ("cached_bq_positions", 3, 4, 4, 9, "bq"),
    ("gqa_cached", 2, 4, 1, 9, "q"),
    ("gqa_self", 2, 6, 2, 0, "none"),
]


@pytest.mark.parametrize("name,B,H,Hkv,P,pos", CASES, ids=[c[0] for c in CASES])
def test_plain_vs_jax_interpret(name, B, H, Hkv, P, pos):
    D = 8
    seq = _layout(B, text=12, img=15, pads=(0, 4, 7), seed=B + H)
    S = seq.shape[1]
    Q = S - P
    q, k, v = _qkv(B, Q, S, H, Hkv, D, seed=H * 7 + P)
    jmeta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    tmeta = tfa.metadata_predict_next(torch.as_tensor(seq), PAD, SOI, EOI)
    if pos == "none":
        jpos = tpos = None
    elif pos == "q":
        jpos = jnp.arange(P, S)
        tpos = torch.arange(P, S)
    else:
        # per-row kv positions; row b's window starts b rows earlier
        qp = np.stack([P - b + np.arange(Q) for b in range(B)])
        jpos, tpos = jnp.asarray(qp), torch.as_tensor(qp)
    want = jfa.omni_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *jmeta,
        num_heads=H, num_kv_heads=Hkv, block_q=8, interpret=True,
        q_positions=jpos)
    got = tfa.omni_attention_packed(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), *tmeta,
        num_heads=H, num_kv_heads=Hkv, q_positions=tpos)
    assert got.shape == (B, Q, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_plain_matches_dense_bias_attention():
    """The metadata route equals dense attention under the additive omni
    mask (the dense path phi takes without metadata), fp32, atol 1e-5."""
    B, H, D = 3, 4, 8
    seq = torch.as_tensor(_layout(B, text=10, img=14, pads=(2, 0, 6), seed=5))
    S = seq.shape[1]
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, S, S, H, H, D, seed=6))
    bias = tm.omni_mask_predict_next(seq, PAD, SOI, EOI, rm_pad_in_image=True)
    want = dense_attention(q.view(B, S, H, D), k.view(B, S, H, D),
                           v.view(B, S, H, D), bias).reshape(B, S, H * D)
    got = tfa.omni_attention_packed(
        q, k, v, *tfa.metadata_predict_next(seq, PAD, SOI, EOI), num_heads=H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_fully_masked_row_is_finite():
    """A row with no visible column gets the mean of v over the keys."""
    B, S, H, D = 1, 6, 2, 8
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, S, S, H, H, D, seed=8))
    seg = torch.zeros((B, S), dtype=torch.int32)
    pad = torch.ones((B, S), dtype=torch.int32)        # every column a pad
    last_pad = torch.full((B,), -1, dtype=torch.int32)  # no row may see pads
    out = tfa.omni_attention_packed(q, k, v, seg, pad, last_pad, num_heads=H)
    assert torch.isfinite(out).all()
    mean_v = v.view(B, S, H, D).mean(dim=1).reshape(B, 1, H * D)
    np.testing.assert_allclose(out.numpy(), mean_v.expand(B, S, -1).numpy(),
                               atol=1e-6)


def test_wrapper_refuses_other_devices():
    """No silent fallback: tensors neither on the CPU nor on CUDA raise."""
    q = torch.empty((1, 4, 16), device="meta")
    seg = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.omni_attention_packed(q, q, q, seg, num_heads=2)


def test_q_positions_required_when_q_ne_s():
    q = torch.zeros((1, 3, 16))
    k = torch.zeros((1, 5, 16))
    with pytest.raises(ValueError, match="q_positions"):
        tfa.omni_attention_packed(q, k, k, torch.zeros((1, 5), dtype=torch.int32),
                                  num_heads=2)


def test_precomputed_q_rows_match():
    """The (pos_q, seg_q) pair a forward computes once (q_rows) gives what
    the wrapper computes from [Q] positions; a malformed pair raises."""
    B, H, D, P = 3, 4, 8, 9
    seq = torch.as_tensor(_layout(B, text=12, img=15, pads=(0, 4, 7), seed=3))
    S = seq.shape[1]
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, S - P, S, H, H, D, seed=4))
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    pos = torch.arange(P, S)
    pos_q, seg_q = tfa.q_rows(meta[0], pos, B, S - P)
    assert pos_q.dtype == seg_q.dtype == torch.int32
    assert pos_q.shape == seg_q.shape == (B, S - P)
    assert torch.equal(seg_q[:, 0], torch.zeros(B, dtype=torch.int32))
    assert int(seg_q[0, -1]) == 1                       # eoi closes the span
    want = tfa.omni_attention_packed(q, k, v, *meta, num_heads=H,
                                     q_positions=pos)
    got = tfa.omni_attention_packed(q, k, v, *meta, num_heads=H,
                                    q_positions=pos_q, seg_q=seg_q)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="q_rows"):
        tfa.omni_attention_packed(q, k, v, *meta, num_heads=H,
                                  q_positions=pos, seg_q=seg_q)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(32, 32, 64), (32, 8, 64), (8, 2, 64),
                                     (12, 2, 128)])
def test_kernel_vs_plain_on_card(H, Hkv, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    B, P, Q = 4, 129, 258
    seq = torch.as_tensor(_layout(B, text=P, img=Q - 2, pads=(0, 17, 60, 3),
                                  seed=11), device=dev)
    S = seq.shape[1]
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, Q, H * D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv * D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv * D, generator=g, device=dev).bfloat16()
    qp = torch.arange(P, S, device=dev)
    before = cuda_build.launches["omni_attention_packed"]
    got = tfa.omni_attention_packed(q, k, v, *meta, num_heads=H,
                                    num_kv_heads=Hkv, q_positions=qp)
    torch.cuda.synchronize()
    assert cuda_build.launches["omni_attention_packed"] == before + 1
    want = tfa.omni_attention_packed_plain(
        q, k, v, *meta, qp.int().expand(B, Q), num_heads=H,
        num_kv_heads=Hkv, sm_scale=D ** -0.5)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_kernel_refuses_other_head_dims():
    """The kernel is built for head dims 64 (Phi-1.5, the Show-o2 DiT) and
    128 (Qwen2.5); others raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q = torch.zeros((1, 8, 2 * 96), dtype=torch.bfloat16, device="cuda")
    seg = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.omni_attention_packed(q, q, q, seg, num_heads=2)


# -- head-major omni_attention -----------------------------------------------

def _metadata(kind, seq, S):
    """(JAX, port) metadata of one kind for token rows ``seq``:
    t2i (left pads + an image span), mmu (prefix visible to every row),
    v2 (several image segments from modality positions)."""
    if kind == "t2i":
        j = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    elif kind == "mmu":
        j = jfa.metadata_mmu(jnp.asarray(seq), EOI)
    else:
        B = seq.shape[0]
        spans = jnp.asarray([[[2 + b, 5], [S // 2, 6 + b]] for b in range(B)])
        seg = jfa.seg_from_modality_positions(spans, S)
        j = (seg, jnp.zeros((B, S), jnp.int32), jnp.full((B,), -1, jnp.int32),
             jnp.zeros((B,), jnp.int32))
    return j, tuple(torch.as_tensor(np.array(m)) for m in j)


@pytest.mark.parametrize("kind", ["t2i", "mmu", "v2"])
@pytest.mark.parametrize("P", [0, 9], ids=["q_eq_s", "q_ne_k"])
def test_omni_plain_vs_jax_interpret(kind, P):
    """omni_attention on the CPU against the JAX kernel in interpret mode,
    fp32, atol 1e-5, with q/k/v given as [B, S, H, D].transpose(1, 2)
    views, as phi's omni route passes them."""
    B, H, D = 3, 4, 8
    seq = _layout(B, text=12, img=15, pads=(0, 4, 7), seed=21)
    S = seq.shape[1]
    Q = S - P
    jmeta, tmeta = _metadata(kind, seq, S)
    rng = np.random.default_rng(P + len(kind))
    q = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v = rng.normal(size=(B, S, H, D)).astype(np.float32)
    jpos = None if P == 0 else jnp.arange(P, S)
    tpos = None if P == 0 else torch.arange(P, S)
    want = jfa.omni_attention(
        *(jnp.asarray(x).swapaxes(1, 2) for x in (q, k, v)), *jmeta,
        block_q=8, interpret=True, q_positions=jpos)
    got = tfa.omni_attention(
        *(torch.as_tensor(x).transpose(1, 2) for x in (q, k, v)), *tmeta,
        q_positions=tpos)
    assert got.shape == (B, H, Q, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_omni_matches_packed():
    """The two layouts compute one function: head-major omni_attention
    equals omni_attention_packed on the same values."""
    B, H, D, P = 2, 4, 8, 9
    seq = torch.as_tensor(_layout(B, text=12, img=15, pads=(3, 0), seed=2))
    S = seq.shape[1]
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, S - P, S, H, H, D, seed=9))
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    pos = torch.arange(P, S)
    packed = tfa.omni_attention_packed(q, k, v, *meta, num_heads=H,
                                       q_positions=pos)
    heads = tfa.omni_attention(
        *(t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v)), *meta,
        q_positions=pos)
    np.testing.assert_allclose(
        heads.transpose(1, 2).reshape(B, S - P, H * D).numpy(),
        packed.numpy(), atol=1e-6)


def test_omni_fully_masked_row_averages_v():
    """A row with no visible column gets the mean of v over the S keys
    (the port's convention; the Pallas kernel averages over its
    block-padded keys)."""
    B, S, H, D = 1, 6, 2, 8
    rng = np.random.default_rng(12)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, H, S, D)).astype(
        np.float32)) for _ in range(3))
    out = tfa.omni_attention(q, k, v, torch.zeros((B, S), dtype=torch.int32),
                             torch.ones((B, S), dtype=torch.int32),
                             torch.full((B,), -1, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(),
                               v.mean(dim=2, keepdim=True).expand_as(
                                   out).numpy(), atol=1e-6)


def test_omni_wrapper_raises():
    """No silent fallback: a device that is neither CPU nor CUDA raises,
    and so do a missing q_positions with Q != S and a malformed
    precomputed (pos_q, seg_q) pair."""
    q = torch.empty((1, 2, 4, 8), device="meta")
    seg = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.omni_attention(q, q, q, seg)
    q = torch.zeros((1, 2, 3, 8))
    k = torch.zeros((1, 2, 5, 8))
    seg = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="q_positions"):
        tfa.omni_attention(q, k, k, seg)
    with pytest.raises(ValueError, match="q_rows"):
        tfa.omni_attention(q, k, k, seg, q_positions=torch.arange(2, 5),
                           seg_q=torch.zeros((1, 3), dtype=torch.int64))


def _card_layout(dev, P, Q):
    seq = torch.as_tensor(_layout(4, text=P, img=Q - 2, pads=(0, 17, 60, 3),
                                  seed=11), device=dev)
    return seq, tfa.metadata_predict_next(seq, PAD, SOI, EOI)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [258, 1026])
def test_omni_kernel_vs_plain_on_card(Q):
    """The head-major kernel on transposed [B, S, H, D] views at the
    256^2 and 512^2 cached-step shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    B, P, H, D = 4, 129, 32, 64
    seq, meta = _card_layout(dev, P, Q)
    S = seq.shape[1]
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(B, n, H, D, generator=g, device=dev).bfloat16()
               .transpose(1, 2) for n in (Q, S, S))
    qp = torch.arange(P, S, device=dev)
    before = cuda_build.launches["omni_attention"]
    got = tfa.omni_attention(q, k, v, *meta, q_positions=qp)
    torch.cuda.synchronize()
    assert cuda_build.launches["omni_attention"] == before + 1
    want = tfa.omni_attention_plain(q, k, v, *meta,
                                    qp.int().expand(B, Q).contiguous(),
                                    sm_scale=D ** -0.5)
    assert got.shape == (B, H, Q, D) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_omni_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    seg = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    q = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim 128"):
        tfa.omni_attention(q, q, q, seg)
    with pytest.raises(TypeError, match="bf16"):
        tfa.omni_attention(q.float(), q.float(), q.float(), seg)
