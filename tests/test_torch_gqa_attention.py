"""The Show-o2 attention shapes of showo_tpu_torch: the v2 span metadata,
the packed omni kernel at head dim 128, and the GQA-stacked kernel.

On the CPU the stacked kernel's plain version is held against the JAX
package's ``omni_attention_packed(gqa_stack=True)`` in interpret mode at
groups 4 and 6, head dims 64 and 128, fp32, atol 1e-5 (exact fp32
products and an fp32 softmax on both sides; only the summation order
differs), and ``seg_from_modality_positions`` bit-exact.  The card-only
cases hold the CUDA kernels against their plain versions in bf16 at atol
2e-2 (the tolerance of tests/test_torch_omni_attention.py) at the Show-o2
432x432 shapes: Qwen2.5 (12 q / 2 kv heads, D=128) and the DiT head (32 / 8,
D=64), B=8 rows of the CFG batch.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu_torch.ops import cuda_build
from showo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _spans(B, S, M, seed):
    """[B, M, 2] (offset, length) spans inside S, with a (0, 0) padding
    entry and an overlap in the last row."""
    rng = np.random.default_rng(seed)
    mp = np.zeros((B, M, 2), np.int64)
    for b in range(B):
        for m in range(M - 1):
            off = int(rng.integers(1, S - 4))
            mp[b, m] = (off, int(rng.integers(1, S - off)))
    mp[-1, -1] = (mp[-1, 0, 0] + 1, 3)
    return mp


@pytest.mark.parametrize("B,M,L", [(1, 1, 20), (3, 2, 37), (4, 3, 64)])
def test_seg_from_modality_positions_bit_exact(B, M, L):
    mp = _spans(B, L, M, seed=B * 10 + M)
    want = np.asarray(jfa.seg_from_modality_positions(jnp.asarray(mp), L))
    got = tfa.seg_from_modality_positions(torch.as_tensor(mp), L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _v2_meta(B, S, n_img, seed):
    """The t2i v2 metadata: one image span per row after a prompt of its
    own length (seg from the spans, no pads, last_pad -1, prefix 0)."""
    rng = np.random.default_rng(seed)
    mp = np.stack([[[int(rng.integers(2, S - n_img)), n_img]]
                   for _ in range(B)])
    seg = np.array(jfa.seg_from_modality_positions(jnp.asarray(mp), S))
    return (seg, np.zeros((B, S), np.int32), np.full((B,), -1, np.int32),
            np.zeros((B,), np.int32))


@pytest.mark.parametrize("H,Hkv", [(8, 2), (12, 2)], ids=["g4", "g6"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("P", [0, 5], ids=["q_eq_s", "q_ne_s"])
def test_stacked_plain_vs_jax_interpret(H, Hkv, D, P):
    B, S = 2, 40
    Q = S - P
    meta = _v2_meta(B, S, 20, seed=H + D + P)
    rng = np.random.default_rng(D + P)
    q = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv * D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv * D)).astype(np.float32)
    jpos = None if P == 0 else jnp.arange(P, S)
    tpos = None if P == 0 else torch.arange(P, S)
    assert tfa.gqa_stack_fits(Q, S, H // Hkv)
    with mock.patch.object(jfa, "_omni_attention_gqa_stacked",
                           wraps=jfa._omni_attention_gqa_stacked) as spy:
        want = jfa.omni_attention_packed(
            *(jnp.asarray(x) for x in (q, k, v)),
            *(jnp.asarray(m) for m in meta), num_heads=H, num_kv_heads=Hkv,
            interpret=True, q_positions=jpos, gqa_stack=True)
    assert spy.call_count == 1
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    tmeta = [torch.as_tensor(m) for m in meta]
    got = tfa.omni_attention_gqa_stacked(tq, tk, tv, *tmeta, num_heads=H,
                                         num_kv_heads=Hkv, q_positions=tpos)
    assert got.shape == (B, Q, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # one function: the stacked arithmetic equals the per-head kernel's
    per_head = tfa.omni_attention_packed(tq, tk, tv, *tmeta, num_heads=H,
                                         num_kv_heads=Hkv, q_positions=tpos)
    np.testing.assert_allclose(got.numpy(), per_head.numpy(), atol=1e-5,
                               rtol=0)


def test_gqa_stack_routes_as_jax():
    """``gqa_stack=True`` takes the stacked kernel under the JAX package's
    condition (group > 1, the [Sp, block_q * group] fp32 block within 8
    MiB), the per-head kernel otherwise; without it, never."""
    assert tfa.gqa_stack_fits(768, 768, 6) and tfa.gqa_stack_fits(896, 896, 4)
    assert not tfa.gqa_stack_fits(768, 768, 1)
    assert not tfa.gqa_stack_fits(4096, 4096, 6)      # 96 MiB of scores
    B, H, Hkv, D = 1, 4, 2, 8
    meta = [torch.as_tensor(m) for m in _v2_meta(B, 24, 10, seed=3)]
    q = torch.zeros((B, 24, H * D))
    k = torch.zeros((B, 24, Hkv * D))
    for stack, heads, calls in ((True, Hkv, 1), (False, Hkv, 0),
                                (True, H, 0)):
        with mock.patch.object(tfa, "omni_attention_gqa_stacked",
                               wraps=tfa.omni_attention_gqa_stacked) as spy:
            tfa.omni_attention_packed(q, k if heads == Hkv else q,
                                      k if heads == Hkv else q, *meta,
                                      num_heads=H, num_kv_heads=heads,
                                      gqa_stack=stack)
        assert spy.call_count == calls, (stack, heads)


# -- on the card ---------------------------------------------------------------

def _card_inputs(H, Hkv, D, seed, B=8, S=768, n_img=730):
    dev = torch.device("cuda")
    meta = [torch.as_tensor(m, device=dev)
            for m in _v2_meta(B, S, n_img, seed=seed)]
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n * D, generator=g, device=dev).bfloat16()
               for n in (H, Hkv, Hkv))
    return q, k, v, meta


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(12, 2, 128), (32, 8, 64)],
                         ids=["qwen", "dit"])
@pytest.mark.parametrize("stacked", [False, True], ids=["packed", "stacked"])
def test_kernels_vs_plain_at_v2_shapes(H, Hkv, D, stacked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, meta = _card_inputs(H, Hkv, D, seed=H + D)
    B, S = meta[0].shape
    name = "omni_attention_gqa_stacked" if stacked else "omni_attention_packed"
    before = cuda_build.launches[name]
    got = tfa.omni_attention_packed(q, k, v, *meta, num_heads=H,
                                    num_kv_heads=Hkv, gqa_stack=stacked)
    torch.cuda.synchronize()
    assert cuda_build.launches[name] == before + 1
    pos = torch.arange(S, device=q.device, dtype=torch.int32).expand(
        B, S).contiguous()
    plain = (tfa.omni_attention_gqa_stacked_plain if stacked
             else tfa.omni_attention_packed_plain)
    want = plain(q, k, v, *meta, pos, num_heads=H, num_kv_heads=Hkv,
                 sm_scale=D ** -0.5)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_stacked_kernel_on_strided_views_and_ragged_q():
    """Kernel 6 reads q/k/v through their strides (views of one fused qkv
    projection, as the models pass them) and masks a ragged Q edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    H, Hkv, D, B, S = 12, 2, 128, 3, 301
    dev = torch.device("cuda")
    meta = [torch.as_tensor(m, device=dev) for m in _v2_meta(B, S, 200, 7)]
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = torch.randn(B, S, (H + 2 * Hkv) * D, generator=g,
                      device=dev).bfloat16()
    q, k, v = qkv.split([H * D, Hkv * D, Hkv * D], dim=-1)
    got = tfa.omni_attention_gqa_stacked(q, k, v, *meta, num_heads=H,
                                         num_kv_heads=Hkv)
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(
        B, S).contiguous()
    want = tfa.omni_attention_gqa_stacked_plain(
        q, k, v, *meta, pos, num_heads=H, num_kv_heads=Hkv,
        sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_stacked_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    seg = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    q = torch.zeros((1, 8, 16 * 64), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 8, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="group 16"):
        tfa.omni_attention_gqa_stacked(q, k, k, seg, num_heads=16,
                                       num_kv_heads=1)
    q = torch.zeros((1, 8, 2 * 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.omni_attention_gqa_stacked(q, q, q, seg, num_heads=2)
