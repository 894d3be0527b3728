"""Attention under an explicit additive bias (``decode_attention``) of
showo_tpu_torch.

On the CPU the wrapper runs its plain version, held against the JAX
Pallas kernel in interpret mode (both of its grid variants, as
tests/test_decode_attention.py runs them), fp32, atol 1e-5: both take
exact fp32 products and an fp32 softmax, so they differ only in
summation order.  The card-only cases hold the CUDA kernel against the
plain version in bf16 at atol 2e-2 (outputs are convex combinations of
~N(0, 1) values; bf16 carries 8 bits and the kernel rounds the
probabilities to bf16 before normalising them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops.decode_attention import decode_attention as j_decode
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import decode_attention as tda
from showo_tpu_torch.ops import masks as tm

torch.set_num_threads(1)


def _inputs(B, H, Q, K, D, seed, masked=0.15):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, n, H, D)).astype(np.float32)
               for n in (Q, K, K))
    bias = np.where(rng.random((B, 1, Q, K)) > masked, 0.0,
                    -1e9).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("per_head_grid", [False, True])
@pytest.mark.parametrize("K", [37, 128], ids=["ragged_k", "k128"])
def test_plain_vs_jax_interpret(per_head_grid, K):
    """K = 37 is the ragged edge the Pallas wrapper pads to 128 with a
    -1e30 bias; the port pads nothing."""
    B, H, Q, D = 2, 4, 10, 16
    q, k, v, bias = _inputs(B, H, Q, K, D, seed=K)
    want = j_decode(*(jnp.asarray(x) for x in (q, k, v, bias)),
                    interpret=True, per_head_grid=per_head_grid)
    got = tda.decode_attention(*(torch.as_tensor(x) for x in (q, k, v, bias)))
    assert got.shape == (B, Q, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bias_as_strided_view_vs_jax():
    """The cached step's bias is attention_bias[:, :, P:, :P+S] of the
    full [B, 1, L, L] omni mask: a view whose row stride is L.  The
    wrapper takes it as it is and matches the JAX kernel given the same
    values."""
    PAD, SOI, EOI = 900, 901, 902
    rng = np.random.default_rng(3)
    B, H, D, P, img = 2, 4, 8, 7, 9
    rows = [[PAD] * p + rng.integers(5, 800, size=P - 1 - p).tolist() + [SOI]
            + rng.integers(5, 800, size=img).tolist() + [EOI]
            for p in (0, 3)]
    seq = torch.as_tensor(np.asarray(rows))
    L = seq.shape[1]
    full = tm.omni_mask_predict_next(seq, PAD, SOI, EOI, rm_pad_in_image=True)
    view = full[:, :, P:, :L]
    assert not view.is_contiguous() and view.stride(2) == L
    q, k, v, _ = _inputs(B, H, L - P, L, D, seed=4)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(view.numpy()), interpret=True)
    got = tda.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), view)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_fully_masked_row_averages_v():
    """A row whose every key carries the -1e9 bias averages v over the K
    keys (the fp32 sum rounds q.k away against -1e9), as in the dense
    path; the other rows are unaffected."""
    B, H, Q, K, D = 1, 2, 3, 5, 8
    q, k, v, _ = _inputs(B, H, Q, K, D, seed=5)
    bias = np.zeros((B, 1, Q, K), np.float32)
    bias[:, :, 1, :] = -1e9
    got = tda.decode_attention(*(torch.as_tensor(x) for x in (q, k, v, bias)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[:, 1].numpy(), v.mean(axis=1), atol=1e-6)
    want = j_decode(*(jnp.asarray(x) for x in (q, k, v, bias)),
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_raises():
    """No silent fallback: a device that is neither CPU nor CUDA raises, as
    does a bias of the wrong shape."""
    q = torch.empty((1, 4, 2, 8), device="meta")
    bias = torch.empty((1, 1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tda.decode_attention(q, q, q, bias)
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="bias must be"):
        tda.decode_attention(q, q, q, torch.zeros((1, 2, 4, 4)))


def _card_inputs(dev, Q, K, seed):
    B, H, D, P = 4, 32, 64, K - Q
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, n, H, D, generator=g, device=dev).bfloat16()
               for n in (Q, K, K))
    # a [B, 1, L, L] causal-plus-noise mask, sliced as the cached step does
    full = torch.where(torch.rand(B, 1, K, K, generator=g, device=dev) < 0.2,
                       -1e9, 0.0)
    return q, k, v, full[:, :, P:, :K]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,K", [(258, 387), (1026, 1155)])
def test_kernel_vs_plain_on_card(Q, K):
    """The 256^2 and 512^2 cached-step shapes, bias as a strided view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, bias = _card_inputs(dev, Q, K, seed=Q)
    before = cuda_build.launches["decode_attention"]
    got = tda.decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert cuda_build.launches["decode_attention"] == before + 1
    want = tda.decode_attention_plain(q, k, v, bias)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, bias = _card_inputs(dev, 64, 96, seed=0)
    with pytest.raises(TypeError, match="fp32 bias"):
        tda.decode_attention(q, k, v, bias.bfloat16())
    with pytest.raises(TypeError, match="bf16"):
        tda.decode_attention(q.float(), k, v, bias)
    wide = torch.zeros((4, 64, 2, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim 128"):
        tda.decode_attention(wide, wide, wide,
                             torch.zeros((4, 1, 64, 64), device=dev))
