"""Kernels 7 and 8 at head dim 128 (Qwen2.5's 12 q / 2 kv heads, scaled to
a few heads here) against the JAX package, and the dispatcher's cut-over
at the Show-o2 shapes.

On the CPU the wrappers run their plain versions, held to JAX's Pallas
kernels in interpret mode on seeded numpy inputs (S not a multiple of 64,
pads, image segments, a prefix, rows with no visible key), GQA groups of
6, 4 and 7 (7 / 1 and Qwen2.5-7B's 28 / 4): the packed forward and lse at
rtol / atol 1e-5, the K-blocked
(kernel 8) forward at 1e-5, and dq / dk / dv through each package's VJP
at 2e-3 (as tests/test_torch_packed_attention_grad.py holds them at head
dim 64).  ``packed_trainable_fits`` is pinned at the Show-o2 lengths:
kernel 7 to S = 1280 for Qwen2.5-1.5B, to S = 512 for the 7B and to S =
1024 for the DiT, kernel 8 past.

On the card (skipped without one: a CUDA kernel has no CPU mode) the
wgmma kernels at head dim 128 are held to their plain versions as
chip_smoke.py holds them: out and lse within 2e-2 max abs, the gradients
within 1e-2 relative norm; two launches give the same bits; widths other
than 64 and 128 raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import packed_attention_grad as jpag
from showo_tpu.ops import streaming_attention_grad as jsag
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import packed_attention_grad as tpag
from showo_tpu_torch.ops import streaming_attention_grad as tsag

torch.set_num_threads(1)

D = 128
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
GROUPS = [(6, 1), (4, 1), (12, 2), (7, 1), (28, 4)]


def _setup(B=2, S=150, H=6, Hkv=1, seed=0):
    """Seeded packed inputs; batch row 1 has rows 3..5 with no visible key
    (left pads only rows <= last_pad = 2 may see)."""
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


def _heads(x, n):
    B, S, _ = x.shape
    return np.ascontiguousarray(x.reshape(B, S, n, D).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("H,Hkv", GROUPS)
def test_packed_forward_and_lse_vs_jax(H, Hkv):
    arrays = _setup(H=H, Hkv=Hkv)
    jq, jk, jv, *jmeta = (jnp.asarray(a) for a in arrays)
    want_out, want_lse = jpag._fwd(jq, jk, jv, *jmeta, D ** -0.5, 256, H,
                                   Hkv, True)
    q, k, v, *meta = (torch.tensor(a) for a in arrays)
    meta = tpag.span_meta(*meta, *q.shape[:2], "cpu")
    out, lse = tpag.packed_trainable_fwd(q, k, v, *meta, num_heads=H,
                                         num_kv_heads=Hkv,
                                         sm_scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    S = q.shape[1]
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, :S],
                               **TOL)
    assert (lse[1, :, 3:6] == tpag.LSE_EMPTY).all()
    assert (out[1, 3:6] == 0).all()


@pytest.mark.parametrize("H,Hkv", GROUPS)
def test_packed_grads_vs_jax(H, Hkv):
    arrays = _setup(H=H, Hkv=Hkv, seed=3)
    w = np.random.default_rng(9).standard_normal(
        arrays[0].shape).astype(np.float32)
    jq, jk, jv, *jmeta = (jnp.asarray(a) for a in arrays)

    def loss(q, k, v):
        out = jpag.omni_attention_packed_trainable(
            q, k, v, *jmeta, num_heads=H, num_kv_heads=Hkv, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
    meta = [torch.tensor(a) for a in arrays[3:]]
    out = tpag.omni_attention_packed_trainable(*leaves, *meta, num_heads=H,
                                               num_kv_heads=Hkv)
    (out * torch.tensor(w)).sum().backward()
    for got, ref, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("H,Hkv", [(6, 1), (4, 2), (7, 1), (28, 4)])
def test_streaming_forward_and_grads_vs_jax(H, Hkv):
    """Kernel 8's plain versions on head-major views at head dim 128
    against JAX's K-blocked kernels (interpret mode, 16-row blocks)."""
    arrays = _setup(B=2, S=70, H=H, Hkv=Hkv, seed=5)
    q, k, v = (_heads(a, n) for a, n in zip(arrays[:3], (H, Hkv, Hkv)))
    meta = arrays[3:]
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def f(q, k, v):
        return jsag.omni_attention_trainable(
            q, k, v, *(jnp.asarray(m) for m in meta), block_q=16,
            block_k=16, interpret=True)

    want_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(w))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tsag.omni_attention_trainable(*leaves,
                                        *(torch.tensor(m) for m in meta))
    # the rows with no visible key differ by design (the port's 0 against
    # the Pallas forward's tile mean): compare the rows that see a key
    vis = tsag.self_visible(*tsag.span_meta(
        *(torch.tensor(m) for m in meta), 2, 70, "cpu")).any(-1)
    np.testing.assert_allclose(
        out.detach().numpy().transpose(0, 2, 1, 3)[vis.numpy()],
        np.asarray(want_out).transpose(0, 2, 1, 3)[vis.numpy()], **TOL)
    (out * torch.tensor(w) * vis[:, None, :, None]).sum().backward()
    wv = jnp.asarray(w * vis.numpy()[:, None, :, None])
    want = vjp(wv)
    for got, ref, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   **GRAD_TOL, err_msg=f"d{name}")


# the JAX dispatcher's cut-over at the Show-o2 shapes (S, heads, kv heads,
# head dim) -> kernel 7 (True) or 8: Qwen 12/2 of 128 to S = 1280, the DiT
# 32/8 of 64 to S = 1024 (exactly 10 MiB there; the test is <=), Qwen2.5-7B
# 28/4 of 128 to S = 512 (Sp * 16 KiB: 8 MiB at 512, 12 MiB at 768), so
# the 7B's stage-2 rows of 1024 take kernel 8 in its Qwen layers and
# kernel 7 in the DiT's
FITS = [(1024, 12, 2, 128, True), (1025, 12, 2, 128, True),
        (1280, 12, 2, 128, True), (1281, 12, 2, 128, False),
        (2048, 12, 2, 128, False), (1024, 32, 8, 64, True),
        (1025, 32, 8, 64, False), (1280, 32, 8, 64, False),
        (2048, 32, 8, 64, False), (100, 12, 2, 128, True),
        (512, 28, 4, 128, True), (513, 28, 4, 128, False),
        (1024, 28, 4, 128, False), (100, 28, 4, 128, True)]


@pytest.mark.parametrize("S,H,Hkv,hd,fits", FITS)
def test_packed_trainable_fits_at_the_show_o2_shapes(S, H, Hkv, hd, fits):
    bq = min(256, ((S + 127) // 128) * 128)
    assert tpag.packed_trainable_fits(S, H, Hkv, hd, bq) is fits
    assert jpag.packed_trainable_fits(S, H, Hkv, hd, bq) is fits
    if (S, H) == (1024, 32):
        Sp = 1024
        assert Sp * (2 * H * hd + 2 * Hkv * hd) * 2 \
            == tpag.PACKED_TRAINABLE_MAX_BYTES


def test_wrappers_refuse_other_head_dims_on_the_cpu_route_too():
    """The plain versions take any head dim; the kernels' check names the
    two they are built for."""
    with pytest.raises(ValueError, match="64 or 128"):
        tpag._shapes(torch.zeros((1, 8, 2 * 96)), 2, 2)
    assert tpag._shapes(torch.zeros((1, 8, 2 * 128)), 2, 1)["k"] \
        == (1, 8, 128)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, what, grads=False):
    d = got.float() - want.float()
    if grads:
        err, tol = (d.norm() / want.float().norm()).item(), 1e-2
    else:
        err, tol = d.abs().max().item(), 2e-2
    assert torch.isfinite(got).all(), what
    assert err <= tol, f"{what}: error {err} > {tol}"


def _card_inputs(dev, B, S, H, Hkv, seed=0):
    arrays = _setup(B=B, S=S, H=H, Hkv=Hkv, seed=seed)
    q, k, v = (torch.tensor(a, device=dev).bfloat16() for a in arrays[:3])
    meta = tpag.span_meta(*(torch.tensor(a, device=dev)
                            for a in arrays[3:]), B, S, dev)
    return q, k, v, meta


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(12, 2, 200), (12, 2, 387), (8, 2, 130),
                                     (4, 1, 64), (28, 4, 200), (7, 1, 130)])
def test_packed_kernels_vs_plain_on_card(H, Hkv, S):
    dev = _card()
    q, k, v, meta = _card_inputs(dev, 3, S, H, Hkv)
    kw = dict(num_heads=H, num_kv_heads=Hkv, sm_scale=D ** -0.5)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).bfloat16()
    before = {n: cuda_build.launches[n] for n in tpag.KERNELS}
    out, lse = tpag.packed_trainable_fwd(q, k, v, *meta, **kw)
    delta = tpag.attention_delta(out, dout, H)
    args = (q, k, v, dout, lse, delta, *meta)
    dq = tpag.packed_trainable_dq(*args, **kw)
    dk, dv = tpag.packed_trainable_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in tpag.KERNELS} \
        == {n: 1 for n in tpag.KERNELS}
    p_out, p_lse = tpag.packed_trainable_fwd_plain(q, k, v, *meta, **kw)
    _close(out, p_out, "out")
    _close(lse, p_lse, "lse")
    assert (out[1, 3:6] == 0).all() and (lse[1, :, 3:6] == 1e9).all()
    _close(dq, tpag.packed_trainable_dq_plain(*args, **kw), "dq", grads=True)
    p_dk, p_dv = tpag.packed_trainable_dkv_plain(*args, **kw)
    _close(dk, p_dk, "dk", grads=True)
    _close(dv, p_dv, "dv", grads=True)
    # the same bits from a second launch
    dq2 = tpag.packed_trainable_dq(*args, **kw)
    dk2, dv2 = tpag.packed_trainable_dkv(*args, **kw)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,S", [(12, 2, 1100), (6, 1, 200),
                                     (28, 4, 1100)])
def test_streaming_kernels_vs_plain_on_card(H, Hkv, S):
    """Kernel 8 at head dim 128 on the head-major views of the packed
    projections (no copy), as the dispatcher gives them past the budget."""
    dev = _card()
    q, k, v, meta = _card_inputs(dev, 2, S, H, Hkv, seed=2)
    qh, kh, vh = (x.view(2, S, n, D).transpose(1, 2)
                  for x, n in ((q, H), (k, Hkv), (v, Hkv)))
    kw = dict(sm_scale=D ** -0.5)
    dout = torch.randn(qh.shape, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev).bfloat16()
    out, lse = tsag.streaming_trainable_fwd(qh, kh, vh, *meta, **kw)
    delta = tsag.attention_delta(out, dout)
    args = (qh, kh, vh, dout, lse, delta, *meta)
    dq = tsag.streaming_trainable_dq(*args, **kw)
    dk, dv = tsag.streaming_trainable_dkv(*args, **kw)
    p_out, p_lse = tsag.trainable_fwd_plain(qh, kh, vh, *meta, **kw)
    _close(out, p_out, "out")
    _close(lse, p_lse, "lse")
    _close(dq, tsag.trainable_dq_plain(*args, **kw), "dq", grads=True)
    p_dk, p_dv = tsag.trainable_dkv_plain(*args, **kw)
    _close(dk, p_dk, "dk", grads=True)
    _close(dv, p_dv, "dv", grads=True)


@pytest.mark.cuda
def test_function_at_d128_past_the_budget_on_card():
    """The packed dispatcher at Qwen's shapes past the budget (S = 1300)
    runs kernel 8 at head dim 128, forward and backward."""
    dev = _card()
    q, k, v, meta = _card_inputs(dev, 2, 1300, 12, 2, seed=4)
    names = tsag.KERNELS + tpag.KERNELS
    before = {n: cuda_build.launches[n] for n in names}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tpag.omni_attention_packed_trainable(*leaves, *meta, num_heads=12,
                                               num_kv_heads=2)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    got = {n: cuda_build.launches[n] - before[n] for n in names}
    assert got == {**{n: 1 for n in tsag.KERNELS},
                   **{n: 0 for n in tpag.KERNELS}}, got
    assert all(torch.isfinite(t.grad).all() for t in leaves)
