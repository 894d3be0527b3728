"""Omni attention of showo_tpu_torch: the packed [B, S, H*D] (kernel 1)
and the head-major [B, H, S, D] (kernel 4) entry points.

On the CPU each wrapper runs its plain version, held against its JAX
Pallas kernel in interpret mode (as tests/test_flash_attention.py runs
them), fp32, atol 1e-5: both take exact fp32 products and an fp32
softmax, so they differ only in summation order.  The tile map of the
packed kernel (``rows_tile_map``) is held exactly to the
block visibility of the JAX package's mask predicate (``_visible`` of
its streaming kernels, which take q rows at any positions).  The
card-only cases hold the CUDA kernel against the plain version in bf16 at
atol 2e-2: outputs are convex combinations of ~N(0, 1) values and bf16
carries 8 bits, and the kernel rounds the probabilities to bf16 before
normalising them; the tile map kernel to its plain version exactly, and
the wgmma kernel, at head dims 64 and 128, to the same bits over two
launches.  Kernel 4 runs kernel 1's core on head-major views: on the
same memory the two give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops import streaming_attention_grad as jsag
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


def _rows_meta(kind):
    """([seg, pad, last_pad, prefix], pos_q [B, Q]) as numpy int32 for the
    tile map of kernel 1 at head dim 128: ``cached`` (a t2i layout, the
    image rows as q rows, Q != S, ragged), ``per_row`` (the same with each
    batch row's window starting 3 rows earlier), ``no_key`` (ragged S = Q
    = 200, pads 0..9 and last_pad 5 in batch row 0, so its rows 6..9 see
    no key; 20 in row 1), ``v2`` (two image spans, Q == S = 300)."""
    if kind in ("cached", "per_row"):
        seq = _layout(2, text=70, img=150, pads=(0, 13), seed=17)
        meta = [np.array(m, np.int32) for m in
                jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)]
        S, P = seq.shape[1], 60
        shift = 3 if kind == "per_row" else 0
        pos = np.stack([P - shift * b + np.arange(S - P) for b in range(2)])
        return meta, pos.astype(np.int32)
    if kind == "no_key":
        B, S = 2, 200
        seg = np.zeros((B, S), np.int32)
        seg[:, 40:150] = 1
        pad = np.zeros((B, S), np.int32)
        pad[:, :10] = 1
        meta = [seg, pad, np.asarray([5, 20], np.int32),
                np.zeros((B,), np.int32)]
    else:
        B, S = 2, 300
        seg = np.array(jfa.seg_from_modality_positions(
            jnp.asarray([[[3, 120], [150, 140]], [[10, 200], [0, 0]]]), S),
            np.int32)
        meta = [seg, np.zeros((B, S), np.int32), np.full((B,), -1, np.int32),
                np.zeros((B,), np.int32)]
    return meta, np.tile(np.arange(S, dtype=np.int32), (B, 1))


def _rows_map_brute(meta, pos_q):
    """The tile map from JAX's block visibility (``_visible``), pair by
    pair, rows past Q left out; the flag from the rows' full rows."""
    seg, pad, last_pad, prefix = meta
    B, S = seg.shape
    Q = pos_q.shape[1]
    nq, nk = -(-Q // 64), -(-S // 64)
    seg_q = np.where(pos_q < S, np.take_along_axis(
        seg, np.minimum(pos_q, S - 1), axis=1), 0)
    rows_pad = ((0, 0), (0, nq * 64 - Q))
    pq, sq = np.pad(pos_q, rows_pad), np.pad(seg_q, rows_pad)
    segk, padk = (np.pad(m, ((0, 0), (0, nk * 64 - S))) for m in (seg, pad))
    want = np.zeros((B, nq, nk + 1), np.uint8)
    for b in range(B):
        for i in range(nq):
            inq = i * 64 + np.arange(64) < Q
            seen = np.zeros(64, bool)
            for j in range(nk):
                vis = np.asarray(jsag._visible(
                    jnp.asarray(pq[b, i * 64:][:64]),
                    jnp.asarray(sq[b, i * 64:][:64]),
                    jnp.asarray(segk[b, j * 64:][:64]),
                    jnp.asarray(padk[b, j * 64:][:64]), int(last_pad[b]),
                    int(prefix[b]), j, 64, 64, S)) & inq[:, None]
                want[b, i, j] = int(vis.any()) + 2 * int(vis.all())
                seen |= vis.any(axis=1)
            want[b, i, nk] = int((inq & ~seen).any())
    return want


@pytest.mark.parametrize("kind", ["cached", "per_row", "no_key", "v2"])
def test_rows_tile_map_vs_jax_block_visibility(kind):
    """The tile map of kernel 1 at head dim 128: for each pair of 64-row q
    and k tiles whether any / every entry is visible, and per q tile
    whether a row sees no key, against JAX's mask predicate on the same
    metadata, exactly; the no_key case flags batch row 0's first q tile
    and nothing else.  Every class occurs (cached rows are image rows,
    which see the whole image span, so no pair of theirs is skipped)."""
    meta, pos_q = _rows_meta(kind)
    tmeta = [torch.as_tensor(m) for m in meta]
    tpos = torch.as_tensor(pos_q)
    got = tfa.rows_tile_map(*tmeta, tpos, tfa.gather_at(tmeta[0], tpos))
    want = _rows_map_brute(meta, pos_q)
    B, S = meta[0].shape
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (B, -(-pos_q.shape[1] // 64), -(-S // 64) + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    flags = want[:, :, -1]
    if kind == "no_key":
        assert flags[0, 0] == 1 and flags.sum() == 1
    else:
        assert flags.sum() == 0
    assert set(np.unique(want[:, :, :-1]).tolist()) == (
        {1, 3} if kind in ("cached", "per_row") else {0, 1, 3})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cached", "per_row", "no_key", "v2"])
def test_rows_tile_map_kernel_on_card(kind):
    """The tile map kernel of head dim 128 equals its plain version, byte
    for byte, with one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    meta, pos_q = _rows_meta(kind)
    tmeta = [torch.as_tensor(m, device="cuda") for m in meta]
    pos = torch.as_tensor(pos_q, device="cuda")
    before = cuda_build.launches[tfa.TILES_KERNEL]
    got = tfa.rows_tile_map(*tmeta, pos, tfa.gather_at(tmeta[0], pos))
    torch.cuda.synchronize()
    assert cuda_build.launches[tfa.TILES_KERNEL] == before + 1
    assert torch.equal(got, tfa.rows_tile_map_plain(*tmeta, pos))


@pytest.mark.cuda
def test_wgmma_kernel_takes_a_precomputed_tile_map():
    """A tile map made once for many calls (as a forward of many layers
    makes it) gives the bits of the map the wrapper makes, with no map
    launch in the call; a map of other shapes raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    meta, pos_q = _rows_meta("cached")
    tmeta = [torch.as_tensor(m, device=dev) for m in meta]
    pos = torch.as_tensor(pos_q, device=dev)
    B, S = meta[0].shape
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, pos.shape[1], 12 * 128, generator=g,
                    device=dev).bfloat16()
    k, v = (torch.randn(B, S, 2 * 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(num_heads=12, num_kv_heads=2, q_positions=pos)
    tiles = tfa.rows_tile_map(*tmeta, pos, tfa.gather_at(tmeta[0], pos))
    before = cuda_build.launches[tfa.TILES_KERNEL]
    got = tfa.omni_attention_packed(q, k, v, *tmeta, **kw, tiles=tiles)
    torch.cuda.synchronize()
    assert cuda_build.launches[tfa.TILES_KERNEL] == before
    assert torch.equal(got, tfa.omni_attention_packed(q, k, v, *tmeta, **kw))
    with pytest.raises(ValueError, match="rows_tile_map"):
        tfa.omni_attention_packed(q, k, v, *tmeta, **kw, tiles=tiles[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cached", "per_row", "no_key", "v2"])
def test_wgmma_kernel_at_head_dim_128_on_card(kind):
    """Kernel 1 at head dim 128 (Qwen2.5's 12 q / 2 kv heads) on the wgmma
    core, at ragged S, Q != S with shared and per-row positions, and rows
    that see no key: against the plain version at atol 2e-2, those rows
    at the mean of v over the S keys, one launch of the core and of its
    tile map a call, and the same bits over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    H, Hkv, D = 12, 2, 128
    dev = torch.device("cuda")
    meta, pos_q = _rows_meta(kind)
    tmeta = [torch.as_tensor(m, device=dev) for m in meta]
    pos = torch.as_tensor(pos_q, device=dev)
    B, S = meta[0].shape
    Q = pos_q.shape[1]
    g = torch.Generator(device=dev).manual_seed(Q + S)
    q = torch.randn(B, Q, H * D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, S, Hkv * D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    names = (tfa.PACKED_SOURCE, tfa.WGMMA_KERNEL, tfa.TILES_KERNEL)
    before = {n: cuda_build.launches[n] for n in names}
    runs = [tfa.omni_attention_packed(q, k, v, *tmeta, num_heads=H,
                                      num_kv_heads=Hkv, q_positions=pos)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} \
        == {n: 2 for n in names}
    assert torch.equal(runs[0], runs[1])
    got = runs[0]
    want = tfa.omni_attention_packed_plain(
        q, k, v, *tmeta, pos, num_heads=H, num_kv_heads=Hkv,
        sm_scale=D ** -0.5)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    if kind == "no_key":
        mean_v = v[0].float().view(S, Hkv, D).mean(dim=0)
        mean_v = mean_v.repeat_interleave(H // Hkv, dim=0).reshape(H * D)
        assert (got[0, 6:10].float() - mean_v).abs().max().item() <= 2e-2


def _v1_cached_meta():
    """([seg, pad, last_pad, prefix], pos_q) numpy int32 of the v1 512x512
    cached step's shape: B=4 left-padded t2i rows of S = 129 + 1026, the
    1026 image rows (soi..eoi) as q rows after the 129-row prefix."""
    seq = _layout(4, text=129, img=1024, pads=(0, 17, 60, 3), seed=23)
    meta = [np.array(m, np.int32) for m in
            jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)]
    S = seq.shape[1]
    return meta, np.tile(np.arange(129, S, dtype=np.int32), (4, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H,Hkv", [("v1_512", 32, 32), ("per_row", 32, 32),
                                        ("v2", 32, 8), ("no_key", 32, 8)])
def test_wgmma_kernel_at_head_dim_64_on_card(kind, H, Hkv):
    """Kernel 1 at head dim 64 on the wgmma core: the v1 512x512 cached
    step (Q=1026 after a 129-row prefix, K=1155, left pads), per-row
    positions, the Show-o2 DiT's 32 q / 8 kv heads, and a ragged S=200
    whose rows 6..9 see no key: against the plain version at atol 2e-2,
    those rows at the mean of v over the S keys, every launch on the
    core with its tile map, and the same bits over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    D = 64
    dev = torch.device("cuda")
    meta, pos_q = _v1_cached_meta() if kind == "v1_512" else _rows_meta(kind)
    tmeta = [torch.as_tensor(m, device=dev) for m in meta]
    pos = torch.as_tensor(pos_q, device=dev)
    B, S = meta[0].shape
    Q = pos_q.shape[1]
    g = torch.Generator(device=dev).manual_seed(Q + S + Hkv)
    q = torch.randn(B, Q, H * D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, S, Hkv * D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    names = (tfa.PACKED_SOURCE, tfa.WGMMA_KERNEL, tfa.TILES_KERNEL)
    before = {n: cuda_build.launches[n] for n in names}
    runs = [tfa.omni_attention_packed(q, k, v, *tmeta, num_heads=H,
                                      num_kv_heads=Hkv, q_positions=pos)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} \
        == {n: 2 for n in names}
    assert torch.equal(runs[0], runs[1])
    got = runs[0]
    want = tfa.omni_attention_packed_plain(
        q, k, v, *tmeta, pos, num_heads=H, num_kv_heads=Hkv,
        sm_scale=D ** -0.5)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    if kind == "no_key":
        mean_v = v[0].float().view(S, Hkv, D).mean(dim=0)
        mean_v = mean_v.repeat_interleave(H // Hkv, dim=0).reshape(H * D)
        assert (got[0, 6:10].float() - mean_v).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_packed_wrapper_never_reaches_the_first_core_on_card():
    """Every launch of kernel 1, at head dim 64 as at 128, is counted on
    the wgmma core, and none on kernel 4's or kernel 6's sources."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    meta, pos_q = _rows_meta("cached")
    tmeta = [torch.as_tensor(m, device=dev) for m in meta]
    pos = torch.as_tensor(pos_q, device=dev)
    B, S = meta[0].shape
    g = torch.Generator(device=dev).manual_seed(4)
    names = (tfa.PACKED_SOURCE, tfa.WGMMA_KERNEL, "omni_attention",
             "omni_attention_gqa_stacked")
    before = {n: cuda_build.launches[n] for n in names}
    for H, Hkv, D in ((32, 32, 64), (32, 8, 64), (8, 2, 64), (12, 2, 128)):
        q = torch.randn(B, pos.shape[1], H * D, generator=g,
                        device=dev).bfloat16()
        k, v = (torch.randn(B, S, Hkv * D, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        tfa.omni_attention_packed(q, k, v, *tmeta, num_heads=H,
                                  num_kv_heads=Hkv, q_positions=pos)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        tfa.PACKED_SOURCE: 4, tfa.WGMMA_KERNEL: 4, "omni_attention": 0,
        "omni_attention_gqa_stacked": 0}


@pytest.mark.cuda
def test_attn_step_makes_the_packed_tile_map_on_card():
    """On CUDA phi's ``attn_step`` gives each route's step the tile map its
    kernel reads (one map launch a forward, for all layers): ``packed``,
    ``streaming`` and ``omni`` the map of their q rows under each kernel's
    own entry, equal to the plain one; ``fused`` at the static-prefix
    step kernel 2's map of the K = P + S keys at their positions (its
    own entry), and outside it the ``omni`` map; ``decode`` none (its map
    is of the bias, made in the forward)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tile map kernel has no CPU mode")
    from showo_tpu_torch.models.phi import attn_step
    from showo_tpu_torch.ops import fused_decode as tfd

    ids = torch.as_tensor(_layout(2, text=20, img=100, pads=(0, 7), seed=5),
                          device="cuda")
    L = ids.shape[1]
    counters = {"packed": tfa.TILES_KERNEL,
                "streaming": "streaming_attention_tiles",
                "omni": tfa.OMNI_TILES, "fused": tfd.TILES_KERNEL,
                "fused_q_eq_s": tfa.OMNI_TILES}
    for route in ("packed", "omni", "decode", "fused", "streaming",
                  "fused_q_eq_s"):
        name = route.split("_")[0]
        meta = (name,) + tfa.metadata_predict_next(ids, PAD, SOI, EOI)
        before = {n: cuda_build.launches[n] for n in counters.values()}
        step = (attn_step(meta, 0, L) if route == "fused_q_eq_s"
                else attn_step(meta, 21, L - 21, static_prefix_len=21))
        torch.cuda.synchronize()
        made = {n: cuda_build.launches[n] - before[n]
                for n in counters.values()}
        if route == "decode":
            assert step.tiles is None and not any(made.values())
            continue
        assert made == {n: int(n == counters[route]) for n in made}
        if route == "fused":
            want = tfa.rows_tile_map_plain(
                step.fused[3], step.fused[4], step.last_pad, step.prefix,
                step.pos_q, pos_k=step.fused[2], seg_q=step.seg_q)
        else:
            want = tfa.rows_tile_map_plain(step.seg, step.pad, step.last_pad,
                                           step.prefix, step.pos_q)
        assert torch.equal(step.tiles, want)


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


@pytest.mark.parametrize("P", [0, 9], ids=["q_eq_s", "q_ne_k"])
def test_omni_plain_at_head_dim_128_vs_jax_interpret(P):
    """Kernel 4 takes head dim 128 too (Qwen's, as the Pallas kernel takes
    any): its plain version at D=128 on Show-o2's spans against the JAX
    kernel in interpret mode, fp32, atol 1e-5."""
    B, H, D = 2, 3, 128
    seq = _layout(B, text=12, img=15, pads=(0, 4), seed=23)
    S = seq.shape[1]
    Q = S - P
    jmeta, tmeta = _metadata("v2", seq, S)
    rng = np.random.default_rng(40 + P)
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


def _emulate(q, k, v, vis, tiles, sm_scale):
    """Kernel 4 as the core runs it on a tile map, fp32 on the CPU: a q
    tile's block visits the K tiles its row of the map lists (every tile
    where its flag is set), masks (-1e30) only those the map marks
    partial, and gives the tiles it does not visit no weight.  q [B, H, Q,
    D], k / v [B, H, S, D], vis [B, Q, S]."""
    Q, S = q.shape[2], k.shape[2]
    nk = tiles.shape[2] - 1
    cls = tiles[:, :, :nk].repeat_interleave(64, 1).repeat_interleave(
        64, 2)[:, :Q, :S]
    flag = tiles[:, :, nk].repeat_interleave(64, 1)[:, :Q, None] != 0
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = torch.where(((cls == 3) | vis)[:, None], s, tfa.NEG_INF)
    s = torch.where(((cls != 0) | flag)[:, None], s, float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v.float())


@pytest.mark.parametrize("kind", ["cached", "per_row", "no_key", "v2"])
def test_omni_map_skips_are_exact(kind):
    """Kernel 4 reads kernel 1's map: skipping its empty tiles and leaving
    its full tiles unmasked changes nothing.  An emulation of the core on
    the map equals the plain version at fp32's 1e-5, and the no_key case's
    rows 6..9 (which see no key) the mean of v over the S keys."""
    meta, pos_q = _rows_meta(kind)
    tmeta = [torch.as_tensor(m) for m in meta]
    pos = torch.as_tensor(pos_q)
    B, S = meta[0].shape
    Q, H, D = pos_q.shape[1], 2, 8
    rng = np.random.default_rng(Q + S)
    q = torch.as_tensor(rng.normal(size=(B, H, Q, D)).astype(np.float32))
    k, v = (torch.as_tensor(rng.normal(size=(B, H, S, D)).astype(np.float32))
            for _ in range(2))
    tiles = tfa.omni_tile_map(*tmeta, pos, tfa.gather_at(tmeta[0], pos))
    assert torch.equal(tiles, tfa.rows_tile_map_plain(*tmeta, pos))
    got = _emulate(q, k, v, tfa.visible_mask(*tmeta, pos), tiles, D ** -0.5)
    want = tfa.omni_attention(q, k, v, *tmeta, q_positions=pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    if kind == "no_key":
        np.testing.assert_allclose(
            got[0, :, 6:10].numpy(),
            v[0].mean(1, keepdim=True).expand(-1, 4, -1).numpy(), atol=1e-5)


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
    q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.omni_attention(q, q, q, seg)
    q = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        tfa.omni_attention(q.float(), q.float(), q.float(), seg)


def _omni_card(kind, dev, H=32, D=64, seed=0):
    """(q, k, v as transposed [B, S, H, D] views, [seg, pad, last_pad,
    prefix], pos_q) on the card for a metadata kind of ``_rows_meta`` or
    the v1 512x512 cached step (``v1_512``)."""
    meta, pos_q = _v1_cached_meta() if kind == "v1_512" else _rows_meta(kind)
    tmeta = [torch.as_tensor(m, device=dev) for m in meta]
    pos = torch.as_tensor(pos_q, device=dev)
    B, S = meta[0].shape
    g = torch.Generator(device=dev).manual_seed(seed + S)
    q, k, v = (torch.randn(B, n, H, D, generator=g, device=dev).bfloat16()
               .transpose(1, 2) for n in (pos.shape[1], S, S))
    return q, k, v, tmeta, pos


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["per_row", "no_key", "v2"])
def test_omni_kernel_at_head_dim_128_on_card(kind):
    """Kernel 4 at head dim 128 (<128, MASK_MEAN> of the forward core),
    12 heads as Qwen's q heads: within 2e-2 of the plain version, one core
    launch (counted also as a head-dim-128 launch), and bit-identical to
    kernel 1 on the same memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, tmeta, pos = _omni_card(kind, dev, H=12, D=128)
    B, H, Q, D = q.shape
    names = (tfa.OMNI_SOURCE, tfa.OMNI_D128)
    before = {n: cuda_build.launches[n] for n in names}
    got = tfa.omni_attention(q, k, v, *tmeta, q_positions=pos)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        n: 1 for n in names}
    rows = tfa.q_rows(tmeta[0], pos, B, Q)
    want = tfa.omni_attention_plain(q, k, v, *tmeta, rows[0],
                                    sm_scale=D ** -0.5)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    S = k.shape[2]
    packed = tfa.omni_attention_packed(
        q.transpose(1, 2).reshape(B, Q, H * D),
        k.transpose(1, 2).reshape(B, S, H * D),
        v.transpose(1, 2).reshape(B, S, H * D), *tmeta, num_heads=H,
        q_positions=pos)
    assert torch.equal(got.transpose(1, 2).reshape(B, Q, H * D), packed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["v1_512", "per_row", "no_key", "v2"])
def test_omni_kernel_on_its_map_on_card(kind):
    """Kernel 4 on the wgmma core at the v1 512x512 cached step, per-row
    positions, a ragged S=200 whose rows 6..9 see no key, and Show-o2's
    spans: within 2e-2 of the plain version, those rows at the mean of v
    over the S keys; one core launch and one map a call, the map equal to
    its plain version byte for byte; the same bits over two launches; a
    map made beforehand gives the same bits and no map launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, tmeta, pos = _omni_card(kind, dev)
    names = (tfa.OMNI_SOURCE, tfa.OMNI_TILES)
    before = {n: cuda_build.launches[n] for n in names}
    runs = [tfa.omni_attention(q, k, v, *tmeta, q_positions=pos)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        n: 2 for n in names}
    assert torch.equal(runs[0], runs[1])
    got = runs[0]
    want = tfa.omni_attention_plain(q, k, v, *tmeta, pos, sm_scale=0.125)
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    seg_q = tfa.gather_at(tmeta[0], pos)
    tiles = tfa.omni_tile_map(*tmeta, pos, seg_q)
    assert torch.equal(tiles, tfa.rows_tile_map_plain(*tmeta, pos))
    before = cuda_build.launches[tfa.OMNI_TILES]
    again = tfa.omni_attention(q, k, v, *tmeta, q_positions=pos,
                               seg_q=seg_q, tiles=tiles)
    torch.cuda.synchronize()
    assert cuda_build.launches[tfa.OMNI_TILES] == before
    assert torch.equal(again, got)
    if kind == "no_key":
        assert tiles[0, 0, -1] == 1
        mean_v = v[0].float().mean(dim=1)                   # [H, D]
        assert (got[0, :, 6:10].float() - mean_v[:, None]).abs().max() \
            <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["v1_512", "no_key"])
def test_omni_kernel_is_kernel_1_on_the_same_memory_on_card(kind):
    """Kernel 4 on transposed [B, S, H, D] views and kernel 1 on the same
    memory as [B, S, H*D] compute one function through one core: the same
    bits, rows without a key included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, tmeta, pos = _omni_card(kind, dev, seed=7)
    got4 = tfa.omni_attention(q, k, v, *tmeta, q_positions=pos)
    got1 = tfa.omni_attention_packed(
        *(t.transpose(1, 2).flatten(2) for t in (q, k, v)), *tmeta,
        num_heads=q.shape[1], q_positions=pos)
    torch.cuda.synchronize()
    assert torch.equal(got4.transpose(1, 2).flatten(2), got1)


@pytest.mark.cuda
def test_omni_kernel_refuses_misaligned_views_on_card():
    """A view whose rows break the 16-byte alignment of the core's copies
    raises (the wrapper copies nothing), and so does a map of the wrong
    shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, tmeta, pos = _omni_card("per_row", dev)
    B, H, Q, D = q.shape
    wide = torch.zeros((B, Q, H, D + 1), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.omni_attention(wide[..., 1:].transpose(1, 2), k, v, *tmeta,
                           q_positions=pos)
    tiles = tfa.omni_tile_map(*tmeta, pos, tfa.gather_at(tmeta[0], pos))
    with pytest.raises(ValueError, match="rows_tile_map"):
        tfa.omni_attention(q, k, v, *tmeta, q_positions=pos,
                           tiles=tiles[:, 1:])


@pytest.mark.cuda
def test_omni_planted_fault_fails_on_card():
    """The check kernel 4 is held to (2e-2 max abs against its plain
    version) passes the kernel and fails V read from the neighbouring
    head, at the v1 512x512 cached step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, tmeta, pos = _omni_card("v1_512", dev, seed=3)
    want = tfa.omni_attention_plain(q, k, v, *tmeta, pos, sm_scale=0.125)
    got = tfa.omni_attention(q, k, v, *tmeta, q_positions=pos)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    bad = tfa.omni_attention_plain(q, k, v.roll(1, dims=1), *tmeta, pos,
                                   sm_scale=0.125)
    err = (bad.float() - want.float()).abs().max().item()
    assert err > 2e-2, err
