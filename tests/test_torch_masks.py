"""showo_tpu_torch masks and kernel metadata vs the JAX package and the
reference-generated golden (tests/golden/masks.npz): the t2i
predict-next mask and the mmu mask with its batch-first-eoi quirk, and
their O(S) metadata.  Tolerance: bit-exact (integer and boolean outputs;
the additive bias holds only 0 and -1e9)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops import masks as jm
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.ops import masks as tm

torch.set_num_threads(1)

PAD, SOI, EOI = 900, 901, 902
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "masks.npz")


def _t2i_layouts(seed=0, pads=(0, 3, 7, 1), text=10, img=12):
    """Left-padded t2i rows: [pad]*p + text + [soi] + img + [eoi]."""
    rng = np.random.default_rng(seed)
    rows = []
    for p in pads:
        rows.append([PAD] * p + rng.integers(5, 800, size=text - p).tolist()
                    + [SOI] + rng.integers(5, 800, size=img).tolist() + [EOI])
    return np.asarray(rows)


@pytest.mark.parametrize("rm", [False, True])
def test_predict_next_golden(rm):
    g = np.load(GOLDEN)
    got = tm.omni_mask_predict_next(
        torch.as_tensor(g["predict_next_seq"]), pad_id=PAD, soi_id=SOI,
        eoi_id=EOI, rm_pad_in_image=rm, return_inverse_mask=False)
    np.testing.assert_array_equal(got.numpy(),
                                  g[f"predict_next_rm{int(rm)}"].astype(bool))


@pytest.mark.parametrize("rm", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_predict_next_vs_jax(rm, inverse):
    seq = _t2i_layouts()
    want = jm.omni_mask_predict_next(
        jnp.asarray(seq), PAD, SOI, EOI, rm_pad_in_image=rm,
        return_inverse_mask=inverse)
    got = tm.omni_mask_predict_next(
        torch.as_tensor(seq), PAD, SOI, EOI, rm_pad_in_image=rm,
        return_inverse_mask=inverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_index_helpers_vs_jax():
    cond = np.array([[0, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]], bool)
    for jf, tf in ((jm._first_index, tm._first_index),
                   (jm._last_index, tm._last_index)):
        for axis in (0, 1):
            np.testing.assert_array_equal(
                tf(torch.as_tensor(cond), dim=axis).numpy(),
                np.asarray(jf(jnp.asarray(cond), axis=axis)))


def test_metadata_vs_jax():
    seq = _t2i_layouts(seed=1)
    want = jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)
    got = tfa.metadata_predict_next(torch.as_tensor(seq), PAD, SOI, EOI)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tfa.seg_from_soi_eoi(torch.as_tensor(seq), SOI, EOI).numpy(),
        np.asarray(jfa.seg_from_soi_eoi(jnp.asarray(seq), SOI, EOI)))


def test_metadata_predicate_reproduces_mask():
    """The kernel's predicate over the metadata equals the dense
    rm_pad_in_image mask, for full rows and for the cached image span."""
    seq = torch.as_tensor(_t2i_layouts(seed=2))
    B, L = seq.shape
    mask = tm.omni_mask_predict_next(seq, PAD, SOI, EOI, rm_pad_in_image=True,
                                     return_inverse_mask=False)[:, 0]
    meta = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    full = tfa.visible_mask(*meta, torch.arange(L).expand(B, L))
    assert torch.equal(full, mask)
    P = 10
    span = tfa.visible_mask(*meta, (P + torch.arange(L - P)).expand(B, -1))
    assert torch.equal(span, mask[:, P:])


def _mmu_layouts(first_eoi_row=0, seed=0, img=5, text=6):
    """[mmu][soi] img [eoi] text rows; the rows before ``first_eoi_row``
    carry no eoi, and the image length differs per row, so the
    batch-first eoi is not every row's own."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(4):
        n = img + b
        eoi = [EOI] if b >= first_eoi_row else [7]
        row = [903, SOI] + rng.integers(5, 800, size=n).tolist() + eoi \
            + rng.integers(5, 800, size=text - b).tolist()
        rows.append(row)
    return np.asarray(rows)


def test_mmu_golden():
    g = np.load(GOLDEN)
    got = tm.omni_mask_mmu(torch.as_tensor(g["mmu_seq"]), eoi_id=EOI,
                           return_inverse_mask=False)
    np.testing.assert_array_equal(got.numpy(), g["mmu"].astype(bool))


@pytest.mark.parametrize("first_eoi_row", [0, 2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_mmu_vs_jax(first_eoi_row, inverse):
    seq = _mmu_layouts(first_eoi_row)
    want = jm.omni_mask_mmu(jnp.asarray(seq), EOI,
                            return_inverse_mask=inverse)
    got = tm.omni_mask_mmu(torch.as_tensor(seq), EOI,
                           return_inverse_mask=inverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("first_eoi_row", [0, 2, 4])
def test_metadata_mmu_vs_jax_and_mask(first_eoi_row):
    """metadata_mmu equals JAX's, and the kernel predicate over it gives
    the dense mmu mask (the prefix is the batch-first eoi + 1)."""
    seq = _mmu_layouts(first_eoi_row, seed=1)
    want = jfa.metadata_mmu(jnp.asarray(seq), EOI)
    got = tfa.metadata_mmu(torch.as_tensor(seq), EOI)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    B, L = seq.shape
    mask = tm.omni_mask_mmu(torch.as_tensor(seq), EOI,
                            return_inverse_mask=False)[:, 0]
    vis = tfa.visible_mask(*got, torch.arange(L).expand(B, L))
    assert torch.equal(vis, mask)
