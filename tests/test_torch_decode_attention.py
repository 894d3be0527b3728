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


# -- kernel 3's tile map ------------------------------------------------------

PAD, SOI, EOI = 900, 901, 902


def _rows(pads, text, img, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.asarray(
        [[PAD] * p + rng.integers(5, 800, size=text - 1 - p).tolist() + [SOI]
         + rng.integers(5, 800, size=img).tolist() + [EOI] for p in pads]))


def _bias(kind):
    """(bias [B, 1, Q, K], P) of one kind, as the cached step passes it: a
    view of the [B, 1, L, L] mask from row P on (P = 0: the whole mask)."""
    if kind in ("predict_next", "masked_rows"):
        P = 130
        seq = _rows((0, 9, 100), text=P, img=131, seed=7)
        full = tm.omni_mask_predict_next(seq, PAD, SOI, EOI,
                                         rm_pad_in_image=True)
        if kind == "masked_rows":
            full = full.clone()
            full[0, 0, P + 3] = -1e9          # rows with no visible key
            full[2, 0, P + 64:P + 70] = -1e9
        return full[:, :, P:, :], P
    if kind == "mmu":
        rng = np.random.default_rng(8)
        seq = torch.as_tensor(np.asarray(
            [[SOI] + rng.integers(5, 800, size=40).tolist() + [EOI]
             + rng.integers(5, 800, size=100).tolist() for _ in range(2)]))
        return tm.omni_mask_mmu(seq, EOI), 0
    rng = np.random.default_rng(9)         # no structure: partial tiles
    x = np.where(rng.random((2, 1, 150, 200)) < 0.3, -1e9,
                 rng.normal(size=(2, 1, 150, 200))).astype(np.float32)
    x[:, :, :, :64] = 0.0
    return torch.as_tensor(x), 0


def _recount(bias):
    """The map's definition, entry by entry in numpy."""
    x = bias[:, 0].numpy()
    B, Q, K = x.shape
    nq, nk = -(-Q // 64), -(-K // 64)
    want = np.zeros((B, nq, nk + 1), np.uint8)
    for b in range(B):
        for qt in range(nq):
            rows = x[b, qt * 64:(qt + 1) * 64]
            for kt in range(nk):
                t = rows[:, kt * 64:(kt + 1) * 64]
                if t.shape[1] == 64 and (t == 0).all():
                    want[b, qt, kt] = 3
                elif not (t <= -1e9).all():
                    want[b, qt, kt] = 1
            want[b, qt, nk] = any(not (r > -1e8).any() for r in rows)
    return want


def _emulate(q, k, v, bias, tiles):
    """decode_attention as the kernel computes it on a tile map, fp32 on
    the CPU: a q tile's block visits the K tiles its row of the map lists
    (every tile where its flag is set), adds no bias on a tile the map
    marks all 0, the bias on the others, and gives the tiles it does not
    visit no weight."""
    B, Q, H, D = q.shape
    K = k.shape[1]
    nk = tiles.shape[2] - 1
    cls = tiles[:, :, :nk].repeat_interleave(64, 1).repeat_interleave(
        64, 2)[:, :Q, :K]
    flag = tiles[:, :, nk].repeat_interleave(64, 1)[:, :Q, None] != 0
    eff = torch.where(cls == 3, 0.0, bias[:, 0].float())
    eff = torch.where((cls != 0) | flag, eff, float("-inf"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / D ** 0.5
    probs = torch.softmax(scores + eff[:, None], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


KINDS = ["predict_next", "mmu", "random", "masked_rows"]


@pytest.mark.parametrize("kind", KINDS)
def test_bias_tile_map_plain_vs_recount(kind):
    """The plain map against the definition counted entry by entry, on the
    t2i predict-next bias (a strided view), the mmu bias (an expanded
    view), a bias without structure and one with fully masked rows; every
    class shows up where the bias has it."""
    bias, _ = _bias(kind)
    got = tda.bias_tile_map_plain(bias)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    want = _recount(bias)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tda.bias_tile_map(bias), got)
    classes = set(want[..., :-1].ravel().tolist())
    if kind != "random":
        assert classes == {0, 1, 3}
    assert want[..., -1].any() == (kind == "masked_rows")


@pytest.mark.parametrize("per_head_grid", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_map_skips_are_exact(kind, per_head_grid):
    """What the kernel leaves out on its map (the empty tiles, and the bias
    of the tiles that are all 0) changes nothing: the emulation equals the
    plain version and the JAX kernel (interpret mode) at fp32's 1e-5,
    fully masked rows (the mean of v over the K keys) included."""
    bias, _ = _bias(kind)
    B, _, Q, K = bias.shape
    q, k, v, _ = _inputs(B, 2, Q, K, 8, seed=Q + K)
    t = [torch.as_tensor(x) for x in (q, k, v)]
    got = _emulate(*t, bias, tda.bias_tile_map_plain(bias))
    np.testing.assert_allclose(
        got.numpy(), tda.decode_attention_plain(*t, bias).numpy(),
        atol=1e-5, rtol=0)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(bias.contiguous().numpy()), interpret=True,
                    per_head_grid=per_head_grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if kind == "masked_rows":
        np.testing.assert_allclose(got[0, 3].numpy(), v[0].mean(axis=0),
                                   atol=1e-5)


# -- on the card --------------------------------------------------------------

def _card_inputs(dev, Q, K, seed):
    B, H, D, P = 4, 32, 64, K - Q
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, n, H, D, generator=g, device=dev).bfloat16()
               for n in (Q, K, K))
    # a [B, 1, L, L] causal-plus-noise mask, sliced as the cached step does
    full = torch.where(torch.rand(B, 1, K, K, generator=g, device=dev) < 0.2,
                       -1e9, 0.0)
    return q, k, v, full[:, :, P:, :K]


def _t2i_card(dev, P, img, seed=0):
    """The cached step's bias view of a left-padded t2i layout (the last
    row's pads fill whole K tiles, which the map skips), rows 5 and
    70..75 of batch row 1 fully masked; q/k/v at 32 heads of 64."""
    seq = _rows((0, 17, 60, min(100, P - 2)), text=P, img=img,
                seed=seed).to(dev)
    full = tm.omni_mask_predict_next(seq, PAD, SOI, EOI,
                                     rm_pad_in_image=True).clone()
    full[1, 0, P + 5] = -1e9
    full[1, 0, P + 70:P + 76] = -1e9
    B, L = seq.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, n, 32, 64, generator=g, device=dev).bfloat16()
               for n in (L - P, L, L))
    return q, k, v, full[:, :, P:, :]


def _close(got, want):
    return (got.float() - want.float()).abs().max().item() <= 2e-2


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
    assert _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("P,img", [(129, 257), (129, 1025), (70, 100)])
def test_kernel_on_its_map_vs_plain_on_card(P, img):
    """The t2i bias view (row stride L, rows starting at 4-byte
    boundaries) on its tile map: the map equal to the plain one byte for
    byte, with skipped, partial and all-0 tiles; the kernel within 2e-2 of
    the plain version (ragged K, Q not a multiple of 64), the fully masked
    rows the mean of v over the K keys, the same bits over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, bias = _t2i_card(dev, P, img)
    assert bias.stride(2) % 4 and not bias.is_contiguous()
    before = cuda_build.launches[tda.TILES_KERNEL]
    tiles = tda.bias_tile_map(bias)
    torch.cuda.synchronize()
    assert cuda_build.launches[tda.TILES_KERNEL] == before + 1
    assert torch.equal(tiles, tda.bias_tile_map_plain(bias))
    assert set(tiles[..., :-1].unique().tolist()) == {0, 1, 3}
    assert tiles[1, :, -1].any()
    got = tda.decode_attention(q, k, v, bias, tiles=tiles)
    again = tda.decode_attention(q, k, v, bias, tiles=tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.isfinite(got).all()
    assert _close(got, tda.decode_attention_plain(q, k, v, bias))
    for row in (5, 70, 75):
        assert _close(got[1, row], v[1].float().mean(dim=0))


@pytest.mark.cuda
def test_planted_fault_fails_on_card():
    """A map that leaves one partial tile's bias out (marks it all 0) makes
    the kernel's result fail the 2e-2 check: the check sees a lost bias
    tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, bias = _t2i_card(dev, 129, 257)
    tiles = tda.bias_tile_map(bias)
    want = tda.decode_attention_plain(q, k, v, bias)
    assert _close(tda.decode_attention(q, k, v, bias, tiles=tiles), want)
    # the partial tile with the most masked entries
    nq, nk = tiles.shape[1], tiles.shape[2] - 1
    masked = torch.zeros((4, nq * 64, nk * 64), device=dev)
    masked[:, :bias.shape[2], :bias.shape[3]] = (bias[:, 0] <= -1e9).float()
    per_tile = masked.view(4, nq, 64, nk, 64).sum(dim=(2, 4))
    per_tile[tiles[..., :-1] != 1] = -1
    b, qt, kt = (int(i) for i in torch.nonzero(
        per_tile == per_tile.max())[0])
    faulty = tiles.clone()
    faulty[b, qt, kt] = 3
    got = tda.decode_attention(q, k, v, bias, tiles=faulty)
    torch.cuda.synchronize()
    assert not _close(got, want)


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
    with pytest.raises(ValueError, match="tile map"):
        tda.decode_attention(q, k, v, bias,
                             tiles=tda.bias_tile_map(bias)[:, 1:])
    wide = torch.zeros((4, 64, 2, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim 128"):
        tda.decode_attention(wide, wide, wide,
                             torch.zeros((4, 1, 64, 64), device=dev))
