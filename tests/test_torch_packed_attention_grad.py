"""showo_tpu_torch trainable packed omni attention (forward + dq + dk/dv)
vs the JAX package's Pallas kernels in interpret mode and vs autograd of
dense attention; the kernels' tile map against the block reduction of the
JAX kernels' own mask predicate (``_mask``), exactly.

Inputs are made with numpy from a seed: S not a multiple of 128 or 64,
pads, an image segment, a prefix, and rows with no visible key.  fp32 on
the CPU: forward rtol/atol 2e-4 and grads 2e-3, as
tests/test_packed_attention_grad.py; the plain backward against torch
autograd of the dense function at 1e-4 (the same fp32 math in another
order).  The card tests hold the kernels to the plain versions as
chip_smoke.py does (bf16 outputs): out and lse to a max abs error of
2e-2, the gradients to a relative norm error ||kernel - plain|| /
||plain|| of 1e-2; the wgmma kernels to the same bits over two launches
on one tile map, and the tile map kernel to its plain version exactly."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops import packed_attention_grad as jpag
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import packed_attention_grad as tpag

torch.set_num_threads(1)

D = 64


def _setup(B=2, S=200, H=4, Hkv=4, seed=0):
    """Seeded inputs; batch row 1 has rows 3..5 with no visible key (left
    pads that only rows <= last_pad = 2 may see)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H * D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv * D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv * D)).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        a0, a1 = sorted(rng.integers(8, S - 5, size=2))
        seg[b, a0:a1] = 1
    pad = np.zeros((B, S), np.int32)
    pad[:, -3:] = 1
    last_pad = np.full((B,), S - 4, np.int32)
    prefix = rng.integers(0, 8, size=B).astype(np.int32)
    pad[1, :6], last_pad[1], prefix[1] = 1, 2, 0
    return q, k, v, seg, pad, last_pad, prefix


def _torch(arrays, requires_grad=False):
    out = [torch.tensor(a) for a in arrays]
    for t in out[:3]:
        t.requires_grad_(requires_grad)
    return out


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_setup_has_rows_with_no_visible_key():
    args = _torch(_setup())
    vis = tpag.self_visible(*tpag.span_meta(*args[3:], 2, 200, "cpu"))
    assert (~vis.any(-1)).sum().item() == 3


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_forward_and_lse_vs_jax(H, Hkv):
    arrays = _setup(H=H, Hkv=Hkv)
    jq, jk, jv, *jmeta = _jax(arrays)
    want_out, want_lse = jpag._fwd(jq, jk, jv, *jmeta, D ** -0.5, 256, H,
                                   Hkv, True)
    q, k, v, *meta = _torch(arrays)
    meta = tpag.span_meta(*meta, *q.shape[:2], "cpu")
    out, lse = tpag.packed_trainable_fwd(q, k, v, *meta, num_heads=H,
                                         num_kv_heads=Hkv,
                                         sm_scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=2e-4, atol=2e-4)
    S = q.shape[1]
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, :S],
                               rtol=2e-4, atol=2e-4)
    empty = lse[1, :, 3:6]
    assert (empty == tpag.LSE_EMPTY).all()
    assert (out[1, 3:6] == 0).all()


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_grads_vs_jax(H, Hkv):
    arrays = _setup(H=H, Hkv=Hkv, seed=3)
    w = np.random.default_rng(9).standard_normal(
        arrays[0].shape).astype(np.float32)
    jq, jk, jv, *jmeta = _jax(arrays)

    def loss(q, k, v):
        out = jpag.omni_attention_packed_trainable(
            q, k, v, *jmeta, num_heads=H, num_kv_heads=Hkv, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v, *meta = _torch(arrays, requires_grad=True)
    out = tpag.omni_attention_packed_trainable(q, k, v, *meta, num_heads=H,
                                               num_kv_heads=Hkv)
    (out * torch.tensor(w)).sum().backward()
    for got, ref, name in zip((q.grad, k.grad, v.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{name}")


def _dense(q, k, v, seg, pad, last_pad, prefix, H, Hkv):
    """Autograd reference: masked softmax attention over fp32 scores, rows
    with no visible key zeroed (the kernel's semantics)."""
    B, S, HD = q.shape
    qh = q.view(B, S, H, D).transpose(1, 2)
    kh = k.view(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vh = v.view(B, S, Hkv, D).transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vis = tpag.self_visible(*tpag.span_meta(seg, pad, last_pad, prefix, B, S,
                                        "cpu"))[:, None]
    s = qh @ kh.transpose(-1, -2) * D ** -0.5 + torch.where(vis, 0.0, -1e9)
    p = torch.where(vis.any(-1, keepdim=True), torch.softmax(s, -1), 0.0)
    return (p @ vh).transpose(1, 2).reshape(B, S, HD)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_plain_backward_vs_dense_autograd(H, Hkv):
    arrays = _setup(H=H, Hkv=Hkv, seed=5)
    w = torch.tensor(np.random.default_rng(2).standard_normal(
        arrays[0].shape).astype(np.float32))
    grads = []
    for fn in (tpag.omni_attention_packed_trainable, None):
        q, k, v, *meta = _torch(arrays, requires_grad=True)
        if fn is None:
            out = _dense(q, k, v, *meta, H, Hkv)
        else:
            out = fn(q, k, v, *meta, num_heads=H, num_kv_heads=Hkv)
        (out * w).sum().backward()
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    for got, ref, name in zip(*grads, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("S", [27, 100, 200, 256, 387, 500, 512, 600, 1154,
                               2000])
@pytest.mark.parametrize("H,Hkv,block_q", [(32, 32, 256), (32, 8, 256),
                                           (4, 4, 128), (16, 16, 256)])
def test_fits_matches_jax(S, H, Hkv, block_q):
    assert tpag.packed_trainable_fits(S, H, Hkv, D, block_q) \
        == jpag.packed_trainable_fits(S, H, Hkv, D, block_q)


def test_stage1_fits_and_512_training_raises():
    """Stage 1 (S=387, Show-o 1.3B) is inside the budget; 512x512 training
    (S=1154 here, 1408 in the configs) is past it, where the dispatcher
    sends the packed tensors, viewed head-major, through the trainable
    K-blocked kernels (kernel 8) as the JAX dispatcher does: the result
    is the packed plain version's at fp32 (1e-5)."""
    assert tpag.packed_trainable_fits(387, 32, 32, D)
    assert not jpag.packed_trainable_fits(1154, 32, 32, D)
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal((1, 1154, 32 * D)),
                            dtype=torch.float32) for _ in range(3))
    seg = torch.zeros((1, 1154), dtype=torch.int32)
    seg[:, 300:900] = 1
    with mock.patch.object(tpag, "omni_attention_trainable",
                           wraps=tpag.omni_attention_trainable) as spy:
        out = tpag.omni_attention_packed_trainable(q, k, v, seg,
                                                   num_heads=32)
    assert spy.call_count == 1
    assert tuple(spy.call_args.args[0].shape) == (1, 32, 1154, D)
    meta = tpag.span_meta(seg, None, None, None, 1, 1154, "cpu")
    want, _ = tpag.packed_trainable_fwd_plain(
        q, k, v, *meta, num_heads=32, num_kv_heads=32, sm_scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


PAD, SOI, EOI, MMU = 900, 901, 902, 903


def _map_meta(kind):
    """[seg, pad, last_pad, prefix] int32 numpy metadata: ``stage1`` a
    fused batch like the stage-1 trainer's at S = 387 (two t2i rows by
    JAX's predict-next metadata, left pads pruned; two lm rows, pads
    visible; two mmu rows by JAX's mmu metadata, the batch-first eoi's
    prefix visible), ``ragged`` S = 200 with rows 3..5 of batch row 1
    seeing no key (:func:`_setup`'s)."""
    if kind == "ragged":
        return [np.asarray(a, np.int32) for a in _setup()[3:]]
    rng = np.random.default_rng(12)

    def text(n):
        return rng.integers(5, 800, size=n).tolist()

    t2i = np.asarray([[PAD] * p + text(129 - p) + [SOI] + text(256) + [EOI]
                      for p in (0, 37)])
    lm = np.asarray([text(300) + [PAD] * 87, text(387)])
    mmu = np.asarray([[MMU, SOI] + text(256) + [EOI] + text(128)] * 2)
    lm_meta = [np.asarray(jfa.seg_from_soi_eoi(jnp.asarray(lm), SOI, EOI)),
               np.zeros(lm.shape, np.int32), np.full((2,), -1, np.int32),
               np.zeros((2,), np.int32)]
    parts = zip(jfa.metadata_predict_next(jnp.asarray(t2i), PAD, SOI, EOI),
                lm_meta, jfa.metadata_mmu(jnp.asarray(mmu), EOI))
    return [np.concatenate([np.asarray(m, np.int32) for m in p])
            for p in parts]


@pytest.mark.parametrize("kind", ["stage1", "ragged"])
def test_tile_map_vs_jax_mask(kind):
    """The kernels' tile map: for each (q tile, k tile) pair of 64 rows,
    whether any / every entry is visible, against the block reduction of
    the Pallas kernels' own predicate (``_mask``, which also masks keys
    past S) on each 64-row block, with the q rows past S left out."""
    meta = _map_meta(kind)
    seg, pad, last_pad, prefix = meta
    B, S = seg.shape
    nt = -(-S // 64)
    got = tpag.tile_map(*(torch.as_tensor(m) for m in meta))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, nt, nt)
    segp, padp = (np.pad(m, ((0, 0), (0, nt * 64 - S))) for m in (seg, pad))
    want = np.zeros((B, nt, nt), np.uint8)
    for b in range(B):
        for i in range(nt):
            rows = i * 64 + np.arange(64, dtype=np.int32)
            vis = np.asarray(jpag._mask(
                jnp.asarray(rows), jnp.asarray(segp[b, i * 64:][:64]),
                jnp.asarray(segp[b]), jnp.asarray(padp[b]),
                int(last_pad[b]), int(prefix[b]), 64, nt * 64, S))
            blocks = (vis & (rows < S)[:, None]).reshape(64, nt, 64)
            want[b, i] = (blocks.any(axis=(0, 2)).astype(np.uint8)
                          + 2 * blocks.all(axis=(0, 2)).astype(np.uint8))
    np.testing.assert_array_equal(got.numpy(), want)
    # skipped, masked and all-visible pairs all occur
    assert set(np.unique(want).tolist()) == {0, 1, 3}


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 8, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpag.packed_trainable_fwd(q, q, q, None, None, None, None,
                                  num_heads=1, num_kv_heads=1, sm_scale=1.0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_inputs(dev, B, S, H, Hkv, seed=0):
    arrays = _setup(B=B, S=S, H=H, Hkv=Hkv, seed=seed)
    q, k, v = (torch.tensor(a, device=dev).bfloat16() for a in arrays[:3])
    meta = tpag.span_meta(*(torch.tensor(a, device=dev)
                            for a in arrays[3:]), B, S, dev)
    return q, k, v, meta


def _close(got, want, what, grads=False):
    d = got.float() - want.float()
    if grads:
        err, tol = (d.norm() / want.float().norm()).item(), 1e-2
    else:
        err, tol = d.abs().max().item(), 2e-2
    assert torch.isfinite(got).all(), what
    assert err <= tol, f"{what}: error {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(8, 8, 200), (8, 2, 200), (4, 4, 387)])
def test_kernels_vs_plain_on_card(H, Hkv, S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta = _card_inputs(dev, 3, S, H, Hkv)
    kw = dict(num_heads=H, num_kv_heads=Hkv, sm_scale=D ** -0.5)
    g = torch.Generator(device=dev).manual_seed(1)
    dout = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    before = {n: cuda_build.launches[n] for n in tpag.KERNELS}
    out, lse = tpag.packed_trainable_fwd(q, k, v, *meta, **kw)
    delta = tpag.attention_delta(out, dout, H)
    dq = tpag.packed_trainable_dq(q, k, v, dout, lse, delta, *meta, **kw)
    dk, dv = tpag.packed_trainable_dkv(q, k, v, dout, lse, delta, *meta, **kw)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in tpag.KERNELS} \
        == {n: 1 for n in tpag.KERNELS}
    p_out, p_lse = tpag.packed_trainable_fwd_plain(q, k, v, *meta, **kw)
    _close(out, p_out, "out")
    _close(lse, p_lse, "lse")
    assert (out[1, 3:6] == 0).all() and (lse[1, :, 3:6] == 1e9).all()
    args = (q, k, v, dout, lse, delta, *meta)
    _close(dq, tpag.packed_trainable_dq_plain(*args, **kw), "dq", grads=True)
    p_dk, p_dv = tpag.packed_trainable_dkv_plain(*args, **kw)
    _close(dk, p_dk, "dk", grads=True)
    _close(dv, p_dv, "dv", grads=True)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(8, 8, 387), (8, 2, 200), (4, 4, 130)])
def test_wgmma_kernels_on_one_map_on_card(H, Hkv, S):
    """The wgmma forward, dq and dk/dv on one tile map made beforehand (as
    the Function's forward makes it for its backward): no map launch in
    the calls, the same bits over two launches, against the plain
    versions; the rows that see no key (3..5 of batch row 1) at out 0,
    lse 1e9 and dq 0 (P = 0); the map equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta = _card_inputs(dev, 2, S, H, Hkv, seed=S + Hkv)
    kw = dict(num_heads=H, num_kv_heads=Hkv, sm_scale=D ** -0.5)
    g = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    tiles = tpag.tile_map(*meta)
    assert torch.equal(tiles, tpag.tile_map_plain(*meta))
    names = tpag.KERNELS + (tpag.TILES_KERNEL,)
    before = {n: cuda_build.launches[n] for n in names}
    runs = []
    for _ in range(2):
        out, lse = tpag.packed_trainable_fwd(q, k, v, *meta, **kw,
                                             tiles=tiles)
        delta = tpag.attention_delta(out, dout, H)
        args = (q, k, v, dout, lse, delta, *meta)
        runs.append((out, lse,
                     tpag.packed_trainable_dq(*args, **kw, tiles=tiles),
                     *tpag.packed_trainable_dkv(*args, **kw, tiles=tiles)))
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} \
        == {**{n: 2 for n in tpag.KERNELS}, tpag.TILES_KERNEL: 0}
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, lse, dq, dk, dv = runs[0]
    assert (out[1, 3:6] == 0).all() and (lse[1, :, 3:6] == 1e9).all()
    assert (dq[1, 3:6] == 0).all()
    p_out, p_lse = tpag.packed_trainable_fwd_plain(q, k, v, *meta, **kw)
    _close(out, p_out, "out")
    _close(lse, p_lse, "lse")
    _close(dq, tpag.packed_trainable_dq_plain(*args, **kw), "dq", grads=True)
    p_dk, p_dv = tpag.packed_trainable_dkv_plain(*args, **kw)
    _close(dk, p_dk, "dk", grads=True)
    _close(dv, p_dv, "dv", grads=True)


@pytest.mark.cuda
def test_function_makes_one_map_per_forward_on_card():
    """The autograd Function's forward makes one tile map and its backward
    reads it again: one map, one forward, dq and dk/dv launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta = _card_inputs(dev, 2, 387, 4, 4, seed=6)
    names = tpag.KERNELS + (tpag.TILES_KERNEL,)
    before = {n: cuda_build.launches[n] for n in names}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tpag.omni_attention_packed_trainable(*leaves, *meta, num_heads=4)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        n: 1 for n in names}


@pytest.mark.cuda
def test_autograd_on_a_side_stream_on_card():
    """Forward and backward through the Function inside a side stream give
    the default stream's results: the launches follow PyTorch's current
    stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta = _card_inputs(dev, 2, 200, 4, 4, seed=4)
    results = []
    for stream in (None, torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = tpag.omni_attention_packed_trainable(*leaves, *meta,
                                                       num_heads=4)
            out.float().square().sum().backward()
        torch.cuda.synchronize()
        results.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, k, v, meta = _card_inputs(dev, 2, 64, 2, 2)
    kw = dict(num_heads=2, num_kv_heads=2, sm_scale=0.125)
    with pytest.raises(TypeError):
        tpag.packed_trainable_fwd(q.float(), k, v, *meta, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tpag.packed_trainable_fwd(q.transpose(0, 1), k, v, *meta, **kw)
    wide = torch.zeros((2, 64, 256), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tpag.packed_trainable_fwd(wide, wide, wide, *meta, num_heads=2,
                                  num_kv_heads=2, sm_scale=0.1)
