"""Trainable K-blocked omni attention of showo_tpu_torch (kernel 8,
``ops/streaming_attention_grad.py``) against the JAX package's
``omni_attention_trainable`` (Pallas forward, dq and dk/dv kernels in
interpret mode with small blocks), on the cases of
tests/test_streaming_attention_grad.py: a v1 t2i mask over many blocks
(MHA), v2 spans with grouped kv heads (GQA), and a ragged causal S over
many blocks; then rows that see no key, the packed dispatcher past its
budget, and the backward kernels' tile map (``tile_map_plain``) against
the block visibility of the Pallas kernels (``_visible``).

Inputs are made with numpy from a seed.  fp32 on the CPU at atol/rtol
1e-5 (out, lse, dq, dk, dv): both sides take exact fp32 products and
softmax and differ only in summation order.  Rows that see no key are
compared only where the two packages mean the same thing (see
test_rows_without_keys).  The card-only cases hold the kernels to the
plain versions in bf16 as chip_smoke.py does: out and lse to a max abs
error of 2e-2, the gradients to a relative norm error ||kernel - plain|| /
||plain|| of 1e-2; the tile map kernel to its plain version exactly, and
the forward and backward kernels to the same bits over two launches.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops import packed_attention_grad as jpag
from showo_tpu.ops import streaming_attention_grad as jsag
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import packed_attention_grad as tpag
from showo_tpu_torch.ops import streaming_attention_grad as tsag

torch.set_num_threads(1)

PAD, SOI, EOI = 900, 901, 902
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32))


def _case(kind):
    """(q, k, v, [seg, pad, last_pad, prefix], block) as numpy arrays."""
    if kind == "t2i":
        rng = np.random.default_rng(0)
        seq = np.asarray([[PAD] * p + rng.integers(5, 800, size=20 - p)
                          .tolist() + [SOI] + rng.integers(5, 800, size=40)
                          .tolist() + [EOI] for p in (0, 5)])
        meta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
        return (*_qkv(2, 2, 2, seq.shape[1], 8, 1),
                [np.array(m) for m in meta], 16)
    if kind == "gqa":
        L = 24
        seg = jfa.seg_from_modality_positions(
            jnp.asarray([[[3, 6], [14, 6]], [[5, 8], [0, 0]]]), L)
        meta = [np.array(seg), np.zeros((2, L), np.int32),
                np.full((2,), -1, np.int32), np.zeros((2,), np.int32)]
        return (*_qkv(2, 4, 2, L, 8, 3), meta, 8)
    L = 70                                       # ragged causal
    meta = [np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
            np.full((1,), -1, np.int32), np.zeros((1,), np.int32)]
    return (*_qkv(1, 2, 2, L, 8, 6), meta, 16)


def _jax_grads(q, k, v, meta, block, w):
    """(out, (dq, dk, dv)) of sum(out * w) through JAX's custom VJP."""
    def f(q, k, v):
        return jsag.omni_attention_trainable(
            q, k, v, *(jnp.asarray(m) for m in meta), block_q=block,
            block_k=block, interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


CASES = ["t2i", "gqa", "causal"]


@pytest.mark.parametrize("kind", CASES)
def test_forward_and_lse_vs_jax(kind):
    q, k, v, meta, block = _case(kind)
    want_out, want_lse = jsag._fwd(
        *(jnp.asarray(x) for x in (q, k, v)),
        *(jnp.asarray(m) for m in meta), q.shape[-1] ** -0.5, block, block,
        True)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    tmeta = [torch.as_tensor(m) for m in meta]
    out, lse = tsag.trainable_fwd_plain(tq, tk, tv, *tmeta,
                                        sm_scale=q.shape[-1] ** -0.5)
    S = q.shape[2]
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0, :S],
                               **TOL)
    fn_out = tsag.omni_attention_trainable(tq, tk, tv, *tmeta)
    np.testing.assert_allclose(fn_out.numpy(), np.asarray(want_out), **TOL)


@pytest.mark.parametrize("kind", CASES)
def test_grads_vs_jax_vjp(kind):
    """dq, dk, dv of the autograd Function and of the plain backward
    functions (fed the plain forward's lse and delta) against jax.vjp."""
    q, k, v, meta, block = _case(kind)
    w = np.random.default_rng(99).normal(size=q.shape).astype(np.float32)
    want_out, want = _jax_grads(q, k, v, meta, block, w)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tmeta = [torch.as_tensor(m) for m in meta]
    out = tsag.omni_attention_trainable(*leaves, *tmeta)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for got, ref, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), ref, **TOL,
                                   err_msg=f"d{name} (Function)")

    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    kw = dict(sm_scale=q.shape[-1] ** -0.5)
    o, lse = tsag.trainable_fwd_plain(tq, tk, tv, *tmeta, **kw)
    dout = torch.as_tensor(w)
    args = (tq, tk, tv, dout, lse, tsag.attention_delta(o, dout), *tmeta)
    dq = tsag.trainable_dq_plain(*args, **kw)
    dk, dv = tsag.trainable_dkv_plain(*args, **kw)
    for got, ref, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), ref, **TOL,
                                   err_msg=f"d{name} (plain)")


def test_rows_without_keys():
    """Rows 0..3 see no key (their only keys are pads past last_pad) and
    share the Pallas kernel's 8-row tile with rows 4..7, which do.  The
    port gives them out 0 and lse 1e30 (what the JAX kernel's _finish
    intends); the Pallas forward gives the mean of v over the first K tile
    and an lse of about -1e30, a value of its tile width.  Every other
    row, and every gradient under a cotangent that is 0 on those rows (so
    that their P cannot reach dk / dv), agrees with JAX at 1e-5."""
    B, H, S, D = 1, 2, 16, 8
    q, k, v = _qkv(B, H, H, S, D, 5)
    pad = np.zeros((B, S), np.int32)
    pad[:, :4] = 1
    meta = [np.zeros((B, S), np.int32), pad, np.full((B,), -1, np.int32),
            np.zeros((B,), np.int32)]
    jout, jlse = jsag._fwd(*(jnp.asarray(x) for x in (q, k, v)),
                           *(jnp.asarray(m) for m in meta), D ** -0.5, 8, 8,
                           True)
    tmeta = [torch.as_tensor(m) for m in meta]
    out, lse = tsag.trainable_fwd_plain(
        *(torch.as_tensor(x) for x in (q, k, v)), *tmeta, sm_scale=D ** -0.5)
    jout, jlse = np.asarray(jout), np.asarray(jlse)[:, :, 0, :S]
    tile_mean = np.allclose(jout[:, :, :4], v[:, :, None, :8].mean(3),
                            atol=1e-5)
    print(f"rows without keys: port out 0, lse {tsag.LSE_EMPTY:g}; JAX out "
          f"|max| {np.abs(jout[:, :, :4]).max():.4f} (mean of v over the "
          f"first K tile: {tile_mean}), "
          f"lse {jlse[0, 0, 0]:.6g}")
    assert (out[:, :, :4] == 0).all() and (lse[:, :, :4] == 1e30).all()
    np.testing.assert_allclose(out[:, :, 4:].numpy(), jout[:, :, 4:], **TOL)
    np.testing.assert_allclose(lse[:, :, 4:].numpy(), jlse[:, :, 4:], **TOL)

    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    w[:, :, :4] = 0
    _, want = _jax_grads(q, k, v, meta, 8, w)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (tsag.omni_attention_trainable(*leaves, *tmeta)
     * torch.as_tensor(w)).sum().backward()
    for got, ref, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), ref, **TOL,
                                   err_msg=f"d{name}")
    assert (leaves[0].grad[:, :, :4] == 0).all()


@pytest.mark.parametrize("Hkv", [4, 2])
def test_packed_dispatcher_past_the_budget_vs_jax(Hkv):
    """With the packed budget at 0 in both packages, the packed layout
    goes through kernel 8 in each (viewed head-major), and the port's
    output and gradients match JAX's ``omni_attention_packed_trainable``
    (its streaming kernels in interpret mode, 8x8 blocks) at 1e-5."""
    B, S, H, D = 2, 40, 4, 64
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, S, H * D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv * D)).astype(np.float32)
            for _ in range(2))
    seg = np.zeros((B, S), np.int32)
    seg[:, 12:30] = 1
    pad = np.zeros((B, S), np.int32)
    pad[1, :5] = 1
    meta = [seg, pad, np.asarray([-1, 4], np.int32),
            np.asarray([3, 0], np.int32)]
    w = rng.normal(size=q.shape).astype(np.float32)
    orig = jsag.omni_attention_trainable

    def interp(*a, **kw):
        kw.update(interpret=True, block_q=8, block_k=8)
        return orig(*a, **kw)

    def jloss(q, k, v):
        out = jpag.omni_attention_packed_trainable(
            q, k, v, *(jnp.asarray(m) for m in meta), num_heads=H,
            num_kv_heads=Hkv)
        return jnp.sum(out * jnp.asarray(w)), out

    with mock.patch.object(jpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(jsag, "omni_attention_trainable", interp):
        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    with mock.patch.object(tpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(tpag, "omni_attention_trainable",
                              wraps=tpag.omni_attention_trainable) as spy:
        out = tpag.omni_attention_packed_trainable(
            *leaves, *(torch.as_tensor(m) for m in meta), num_heads=H,
            num_kv_heads=Hkv)
    assert spy.call_count == 1
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for got, ref, name in zip(leaves, jgrads, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"d{name}")


def _tile_meta(kind):
    """[seg, pad, last_pad, prefix] int32 numpy metadata over several
    64-row tiles: ``ragged`` (an image span, left pads, rows 6..9 see no
    key), ``t2i`` (JAX's predict-next metadata of two left-padded t2i
    rows), ``prefix`` (a bidirectional prefix of 70 and a second span)."""
    if kind == "ragged":
        B, S = 2, 200
        seg = np.zeros((B, S), np.int32)
        seg[:, 40:150] = 1
        pad = np.zeros((B, S), np.int32)
        pad[:, :10] = 1
        return [seg, pad, np.full((B,), 5, np.int32), np.zeros((B,), np.int32)]
    if kind == "t2i":
        rng = np.random.default_rng(2)
        seq = np.asarray([[PAD] * p + rng.integers(5, 800, size=40 - p)
                          .tolist() + [SOI] + rng.integers(5, 800, size=150)
                          .tolist() + [EOI] for p in (0, 13)])
        meta = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
        return [np.array(m, np.int32) for m in meta]
    B, S = 2, 260
    seg = np.zeros((B, S), np.int32)
    seg[0, 100:230] = 2
    seg[1, 64:128] = 1
    return [seg, np.zeros((B, S), np.int32), np.full((B,), -1, np.int32),
            np.asarray([70, 0], np.int32)]


@pytest.mark.parametrize("kind", ["ragged", "t2i", "prefix"])
def test_tile_map_vs_pallas_block_visibility(kind):
    """The backward kernels' tile map: for each (q tile, k tile) pair of
    64 rows, whether any / every entry is visible, against the Pallas
    kernels' own block predicate (``_visible``, which also masks keys
    past S) with the q rows past S left out."""
    meta = _tile_meta(kind)
    seg, pad, last_pad, prefix = meta
    B, S = seg.shape
    nt = -(-S // 64)
    got = tsag.tile_map(*(torch.as_tensor(m) for m in meta))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, nt, nt)
    padded = [np.pad(m, ((0, 0), (0, nt * 64 - S))) for m in (seg, pad)]
    want = np.zeros((B, nt, nt), np.uint8)
    for b in range(B):
        for i in range(nt):
            rows = i * 64 + np.arange(64, dtype=np.int32)
            for j in range(nt):
                vis = np.asarray(jsag._visible(
                    jnp.asarray(rows), jnp.asarray(padded[0][b, i * 64:][:64]),
                    jnp.asarray(padded[0][b, j * 64:][:64]),
                    jnp.asarray(padded[1][b, j * 64:][:64]),
                    int(last_pad[b]), int(prefix[b]), j, 64, 64, S))
                vis = vis & (rows < S)[:, None]
                want[b, i, j] = int(vis.any()) + 2 * int(vis.all())
    np.testing.assert_array_equal(got.numpy(), want)
    # every class occurs (t2i: each q tile holds image rows, which see the
    # whole image span, so no pair is skipped)
    assert set(np.unique(want).tolist()) == (
        {1, 3} if kind == "t2i" else {0, 1, 3})


def test_self_attention_only_and_other_devices_raise():
    q = torch.zeros((1, 2, 6, 8))
    k = torch.zeros((1, 2, 8, 8))
    with pytest.raises(ValueError, match="self-attention"):
        tsag.omni_attention_trainable(q, k, k,
                                      torch.zeros((1, 8), dtype=torch.int32))
    m = torch.zeros((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsag.streaming_trainable_fwd(m, m, m, None, None, None, None,
                                     sm_scale=1.0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _ragged(dev, B, S):
    """Metadata with an image span, left pads and last_pad = 5, so rows
    6..9 see no key."""
    seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
    seg[:, 40:150] = 1
    pad = torch.zeros_like(seg)
    pad[:, :10] = 1
    last_pad = torch.full((B,), 5, dtype=torch.int32, device=dev)
    return [seg, pad, last_pad, torch.zeros_like(last_pad)]


def _views(dev, B, S, n, g):
    """bf16 [B, n, S, 64] views of [B, S, n, 64] tensors (phi's layout)."""
    return torch.randn(B, S, n, 64, generator=g, device=dev).bfloat16() \
        .transpose(1, 2)


def _close(got, want, what, grads=False):
    d = got.float() - want.float()
    if grads:
        err, tol = (d.norm() / want.float().norm()).item(), 1e-2
    else:
        err, tol = d.abs().max().item(), 2e-2
    assert torch.isfinite(got).all(), what
    assert err <= tol, f"{what}: error {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(8, 8, 200), (8, 2, 200), (4, 4, 1408)])
def test_kernels_vs_plain_on_card(H, Hkv, S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    B = 3
    g = torch.Generator(device=dev).manual_seed(S + Hkv)
    meta = _ragged(dev, B, S)
    q, k, v, dout = (_views(dev, B, S, n, g) for n in (H, Hkv, Hkv, H))
    kw = dict(sm_scale=64 ** -0.5)
    before = {n: cuda_build.launches[n] for n in tsag.KERNELS}
    out, lse = tsag.streaming_trainable_fwd(q, k, v, *meta, **kw)
    delta = tsag.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, *meta)
    dq = tsag.streaming_trainable_dq(*args, **kw)
    dk, dv = tsag.streaming_trainable_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in tsag.KERNELS} \
        == {n: 1 for n in tsag.KERNELS}
    assert out.stride() == q.stride() and dk.stride() == k.stride()
    p_out, p_lse = tsag.trainable_fwd_plain(q, k, v, *meta, **kw)
    _close(out, p_out, "out")
    _close(lse, p_lse, "lse")
    assert (out[:, :, 6:10] == 0).all() and (lse[:, :, 6:10] == 1e30).all()
    _close(dq, tsag.trainable_dq_plain(*args, **kw), "dq", grads=True)
    p_dk, p_dv = tsag.trainable_dkv_plain(*args, **kw)
    _close(dk, p_dk, "dk", grads=True)
    _close(dv, p_dv, "dv", grads=True)


@pytest.mark.cuda
def test_dispatcher_on_card_runs_kernel_7s_arithmetic():
    """Past the (patched) budget the dispatcher's forward and backward go
    through kernel 8 on head-major views of the packed tensors, with
    kernel 8's launches counted (one tile map, made by the forward and
    read again by the backward).  Kernel 8's wgmma kernels compute kernel
    7's function in another order of the sums, so the output is held to
    kernel 7's at the max abs error of 2e-2 and the gradients at the
    relative norm of 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    B, S, H, Hkv = 2, 300, 8, 2
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(B, S, n * 64, generator=g, device=dev).bfloat16()
               for n in (H, Hkv, Hkv))
    meta = _ragged(dev, B, S)
    results = []
    for budget in (tpag.PACKED_TRAINABLE_MAX_BYTES, 0):
        before = dict(cuda_build.launches)
        with mock.patch.object(tpag, "PACKED_TRAINABLE_MAX_BYTES", budget):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = tpag.omni_attention_packed_trainable(
                *leaves, *meta, num_heads=H, num_kv_heads=Hkv)
            out.float().square().sum().backward()
        torch.cuda.synchronize()
        kernels = (tsag.KERNELS + (tsag.TILES_KERNEL,) if budget == 0
                   else tpag.KERNELS)
        assert {n: cuda_build.launches[n] - before.get(n, 0)
                for n in kernels} == {n: 1 for n in kernels}
        results.append([out.detach()] + [t.grad for t in leaves])
    _close(results[1][0], results[0][0], "out")
    for a, b, name in zip(results[0][1:], results[1][1:], "qkv"):
        _close(b, a, f"d{name}", grads=True)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    meta = _ragged(dev, 1, 200)
    q = torch.zeros((1, 2, 200, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        tsag.streaming_trainable_fwd(q.float(), q, q, *meta, sm_scale=0.1)
    with pytest.raises(ValueError, match="contiguous last dim"):
        tsag.streaming_trainable_fwd(q.transpose(2, 3)[..., :64, :], q, q,
                                     *meta, sm_scale=0.1)
    # head dim 256: the kernels are built for 64 and 128
    wide = torch.zeros((1, 2, 200, 256), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tsag.streaming_trainable_fwd(wide, wide, wide, *meta, sm_scale=0.1)


def _backward(q, k, v, dout, meta, kw):
    """(dq, dk, dv) of the kernels on one tile map, and the launches of
    the tile map, forward, dq and dk/dv kernels they made."""
    names = (tsag.TILES_KERNEL,) + tsag.KERNELS
    before = {n: cuda_build.launches[n] for n in names}
    tiles = tsag.tile_map(*meta)
    out, lse = tsag.streaming_trainable_fwd(q, k, v, *meta, **kw,
                                            tiles=tiles)
    delta = tsag.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, *meta)
    dq = tsag.streaming_trainable_dq(*args, **kw, tiles=tiles)
    dk, dv = tsag.streaming_trainable_dkv(*args, **kw, tiles=tiles)
    torch.cuda.synchronize()
    return (dq, dk, dv), args, {n: cuda_build.launches[n] - before[n]
                                for n in names}


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(32, 32, 1408), (32, 8, 1408),
                                     (8, 8, 200)])
def test_backward_kernels_vs_plain_on_card(H, Hkv, S):
    """The wgmma dq and dk/dv kernels at the 512x512 step's S, MHA and GQA
    32/8, and a ragged S: against the plain versions, rows with no
    visible key (6..9) get dq = 0, and two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    B = 2
    g = torch.Generator(device=dev).manual_seed(H + Hkv + S)
    meta = _ragged(dev, B, S)
    q, k, v, dout = (_views(dev, B, S, n, g) for n in (H, Hkv, Hkv, H))
    kw = dict(sm_scale=64 ** -0.5)
    first, args, launches = _backward(q, k, v, dout, meta, kw)
    assert launches == {n: 1 for n in launches}
    second, _, _ = _backward(q, k, v, dout, meta, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    dq, dk, dv = first
    assert dq.stride() == q.stride() and dv.stride() == v.stride()
    assert (dq[:, :, 6:10] == 0).all()
    _close(dq, tsag.trainable_dq_plain(*args, **kw), "dq", grads=True)
    p_dk, p_dv = tsag.trainable_dkv_plain(*args, **kw)
    _close(dk, p_dk, "dk", grads=True)
    _close(dv, p_dv, "dv", grads=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "t2i", "prefix"])
def test_tile_map_kernel_on_card(kind):
    """The tile map kernel equals its plain version, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    meta = [torch.as_tensor(m, device="cuda") for m in _tile_meta(kind)]
    before = cuda_build.launches[tsag.TILES_KERNEL]
    got = tsag.tile_map(*meta)
    torch.cuda.synchronize()
    assert cuda_build.launches[tsag.TILES_KERNEL] == before + 1
    assert torch.equal(got, tsag.tile_map_plain(*meta))


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(32, 32, 1408), (32, 8, 1408),
                                     (8, 2, 200)])
def test_forward_kernel_bit_stable_on_card(H, Hkv, S):
    """The wgmma forward at the 512x512 step's S, MHA and GQA 32/8, and a
    ragged S with GQA: against the plain version (out and lse), rows with
    no visible key (6..9) at out 0 and lse 1e30, one launch of the
    forward on one tile map, and the same bits over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    B = 2
    g = torch.Generator(device=dev).manual_seed(H + Hkv + S + 1)
    meta = _ragged(dev, B, S)
    q, k, v = (_views(dev, B, S, n, g) for n in (H, Hkv, Hkv))
    kw = dict(sm_scale=64 ** -0.5)
    tiles = tsag.tile_map(*meta)
    before = cuda_build.launches[tsag.KERNELS[0]]
    runs = [tsag.streaming_trainable_fwd(q, k, v, *meta, **kw, tiles=tiles)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert cuda_build.launches[tsag.KERNELS[0]] == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, lse = runs[0]
    assert out.stride() == q.stride()
    assert (out[:, :, 6:10] == 0).all() and (lse[:, :, 6:10] == 1e30).all()
    p_out, p_lse = tsag.trainable_fwd_plain(q, k, v, *meta, **kw)
    _close(out, p_out, "out")
    _close(lse, p_lse, "lse")
