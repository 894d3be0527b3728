"""The cached step's attention (``fused_decode_attention``, kernel 2) of
showo_tpu_torch: the LayerNorm + RoPE pass (``norm_rope``), then the
forward core over [cache | fresh] keys at their positions
(``fused_attend``) on the tile map of those keys (``fused_tile_map``).

On the CPU the wrappers run their plain versions, held against the JAX
Pallas kernel in interpret mode (as tests/test_fused_decode.py runs it),
fp32, atol 2e-5 / rtol 2e-5 (the tolerance of that test: LayerNorm,
RoPE and attention in fp32, differing only in summation order); the
two parts' plain versions in turn equal the one-piece plain version and
JAX, also for fresh rows at positions other than ``P + arange(S)``; the
tile map of the keys equals a numpy recount of its definition, and an
emulation of the core that skips the map's empty tiles equals the plain
version.  Inputs are laid out as the cached step passes them: ``y`` a
column slice of a wider projection output, ck / cv views of a [layers,
B, S_max, H, D] cache.  The card-only cases hold the CUDA kernels
against the plain versions in bf16 at atol 2e-2: the pass rounds
LayerNorm output and each RoPE product to bf16 as the plain version
does, but its rsqrt is the card's approximate one, so a normalised value
may differ by a bf16 ulp (2^-8 relative) and then move every score of
its row; outputs are convex combinations of ~N(0, 1) values.
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


def _run_both(seq, P, H, D, seed, softmax_dtype=jnp.float32, meta=None,
              q_positions=None, parts=False):
    """(port, JAX) outputs of one cached step; ``q_positions`` (numpy [S],
    default P + arange(S)) the fresh rows' positions, their rope tables
    taken at them; with ``parts`` the port's output is that of its two
    parts, :func:`norm_rope` then :func:`fused_attend`."""
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
    if q_positions is None:
        q_positions = P + np.arange(S)
    cos, sin = _rope_tables(jnp.asarray(q_positions), rd, 10000.0)

    want = jfd.fused_decode_attention(
        jnp.asarray(wide[..., 1:4 * hidden + 1]),
        jnp.asarray(cache[1, 0, :, :P].reshape(B, P, hidden)),
        jnp.asarray(cache[1, 1, :, :P].reshape(B, P, hidden)),
        {"scale": jnp.asarray(ln[0]), "bias": jnp.asarray(ln[1])},
        {"scale": jnp.asarray(ln[2]), "bias": jnp.asarray(ln[3])},
        cos, sin, *jmeta, jnp.asarray(q_positions), hidden=hidden,
        num_heads=H, rotary_dim=rd, eps=1e-5, softmax_dtype=softmax_dtype,
        interpret=True)

    tw, tc = torch.as_tensor(wide), torch.as_tensor(cache)
    y = tw[..., 1:4 * hidden + 1]                     # a column slice
    ck = tc[1, 0, :, :P].flatten(2)                   # cache views
    cv = tc[1, 1, :, :P].flatten(2)
    assert not (y.is_contiguous() or ck.is_contiguous())
    tpos = torch.as_tensor(q_positions)
    tcos, tsin = rope_tables(tpos, rd, 10000.0)
    ln_t = [torch.as_tensor(x) for x in ln]
    kw = dict(hidden=hidden, num_heads=H)
    if parts:
        rows = tfd.fused_rows(tmeta[0], tmeta[1], tpos, P, B)
        qn, kn = tfd.norm_rope(y, ln_t[:2], ln_t[2:], tcos, tsin,
                               rotary_dim=rd, eps=1e-5, **kw)
        got = tfd.fused_attend(qn, kn, y, ck, cv, *tmeta[2:], rows, **kw)
    else:
        got = tfd.fused_decode_attention(
            y, ck, cv, ln_t[:2], ln_t[2:], tcos, tsin, *tmeta, tpos,
            rotary_dim=rd, eps=1e-5, **kw,
            softmax_dtype=(torch.float32 if softmax_dtype == jnp.float32
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


def _irregular_meta(B, L, seed=0):
    """Random segments, pads, last_pad and prefix over L logical
    positions (as tests/test_fused_decode.py draws them)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, size=(B, L)).astype(np.int32),
            rng.integers(0, 2, size=(B, L)).astype(np.int32),
            np.asarray([3, 100], np.int32)[:B],
            np.asarray([0, 2], np.int32)[:B])


# (layout, fresh rows' positions): the t2i layout and the irregular
# metadata at P + arange(S), an offset past the logical map's end (its
# maps read 0 there, as JAX pads them) and a permutation of the fresh rows
POSITIONS = [("t2i", "identity"), ("irregular", "identity"),
             ("t2i", "offset"), ("irregular", "permuted")]


def _positions(kind, P, S):
    if kind == "identity":
        return P + np.arange(S)
    if kind == "offset":
        return P + 3 + np.arange(S)
    return P + np.random.default_rng(S).permutation(S)


@pytest.mark.parametrize("layout,positions", POSITIONS,
                         ids=[f"{a}-{b}" for a, b in POSITIONS])
def test_norm_rope_then_attend_vs_plain_and_jax(layout, positions):
    """The kernel's two parts as plain versions (``norm_rope_plain``,
    then the packed plain attention over [ck | kn] with keys at pos_k)
    equal the one-piece plain version and the JAX kernel (interpret mode)
    at the file's TOL, for fresh rows at P + arange(S) and elsewhere."""
    if layout == "t2i":
        seq, P, meta = _t2i_seq(3, P=7, img=9, pads=(0, 3, 5), seed=4), 7, None
    else:
        P, S = 4, 6
        seq, meta = np.zeros((2, P + S), np.int64), _irregular_meta(2, P + S)
    qp = _positions(positions, P, seq.shape[1] - P)
    parts, want = _run_both(seq, P, H=4, D=8, seed=3, meta=meta,
                            q_positions=qp, parts=True)
    whole, _ = _run_both(seq, P, H=4, D=8, seed=3, meta=meta, q_positions=qp)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(parts.numpy(), np.asarray(want), **TOL)


def _key_meta(kind, B=2, P=70, S=150):
    """(seg, pad, last_pad, prefix) numpy int32 over the logical L = P + S
    positions and the fresh rows' positions, several 64-row tiles each:
    ``t2i`` a left-padded t2i layout, ``masked`` the same with every
    position below P + 10 a pad and last_pad 3 (fresh rows 0..9 see no
    key) in batch row 0, ``permuted`` / ``offset`` the t2i layout with the
    fresh rows at a permutation / P + 5 + arange(S)."""
    seq = _t2i_seq(B, P, S - 2, (0, 13), seed=P + S)
    meta = [np.array(m, np.int32) for m in
            jfa.metadata_predict_next(jnp.asarray(seq), PAD, SOI, EOI)]
    qp = P + np.arange(S)
    if kind == "masked":
        meta[1][0, :P + 10] = 1
        meta[2][0] = 3
        meta[0][0] = 0
    elif kind == "permuted":
        qp = _positions("permuted", P, S)
    elif kind == "offset":
        qp = P + 5 + np.arange(S)
    return meta, qp.astype(np.int32)


def _key_map_recount(meta, qp, P):
    """The tile map of the K = P + S keys at positions [0..P-1, qp],
    recounted in numpy from its definition, pair by pair."""
    seg, pad, last_pad, prefix = meta
    B, L = seg.shape
    S = qp.shape[0]
    pk = np.concatenate([np.arange(P), qp])
    K = pk.shape[0]

    def at(m, pos):             # the logical map at pos, 0 past its end
        return np.where(pos < L, m[:, np.clip(pos, 0, L - 1)], 0)

    seg_k, pad_k, seg_q = at(seg, pk), at(pad, pk), at(seg, qp)
    nq, nk = -(-S // 64), -(-K // 64)
    want = np.zeros((B, nq, nk + 1), np.uint8)
    for b in range(B):
        vis = np.zeros((nq * 64, nk * 64), bool)
        for i in range(S):
            for j in range(K):
                same = seg_q[b, i] > 0 and seg_q[b, i] == seg_k[b, j]
                vis[i, j] = (pk[j] <= qp[i] or same
                             or pk[j] < prefix[b]) and (
                    pad_k[b, j] == 0 or qp[i] <= last_pad[b])
        for a in range(nq):
            rows = vis[a * 64:(a + 1) * 64]
            for c in range(nk):
                t = rows[:, c * 64:(c + 1) * 64][:min(64, S - a * 64),
                                                 :min(64, K - c * 64)]
                full = t.shape == (64, 64) and t.all()
                want[b, a, c] = int(t.any()) + 2 * int(full)
            want[b, a, nk] = int(not rows[:min(64, S - a * 64)].any(
                axis=1).all())
    return want


KEY_KINDS = ["t2i", "masked", "permuted", "offset"]


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_fused_tile_map_plain_vs_recount(kind):
    """``rows_tile_map_plain`` with key positions (the map of
    ``fused_tile_map``, made on the CPU by its plain version) equals a
    numpy recount of its definition; only the masked case flags a q
    tile."""
    meta, qp = _key_meta(kind)
    P = 70
    tmeta = [torch.as_tensor(m) for m in meta]
    rows = tfd.fused_rows(tmeta[0], tmeta[1], torch.as_tensor(qp), P, 2)
    got = tfd.fused_tile_map(rows, tmeta[2], tmeta[3])
    want = _key_map_recount(meta, qp, P)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tfa.rows_tile_map_plain(
        rows[3], rows[4], tmeta[2], tmeta[3], rows[0], pos_k=rows[2],
        seg_q=rows[1]))
    assert bool(want[..., -1].any()) == (kind == "masked")
    assert {0, 1, 3} >= set(np.unique(want[..., :-1]).tolist()) >= {1, 3}


def _emulate(qn, k, v, vis, tiles, sm_scale):
    """The core as it runs on a tile map, fp32 on the CPU: a q tile's
    block visits the K tiles its row of the map lists (every tile where
    its flag is set), masks (-1e30) only those the map marks partial, and
    gives the tiles it does not visit no weight.  qn [B, S, H, D], k / v
    [B, K, H, D], vis [B, S, K]."""
    S, K = qn.shape[1], k.shape[1]
    nk = tiles.shape[2] - 1
    cls = tiles[:, :, :nk].repeat_interleave(64, 1).repeat_interleave(
        64, 2)[:, :S, :K]
    flag = tiles[:, :, nk].repeat_interleave(64, 1)[:, :S, None] != 0
    s = torch.einsum("bqhd,bkhd->bhqk", qn.float(), k.float()) * sm_scale
    s = torch.where(((cls == 3) | vis)[:, None], s, tfa.NEG_INF)
    s = torch.where(((cls != 0) | flag)[:, None], s, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_map_skips_are_exact(kind):
    """Skipping the map's empty tiles and leaving its full tiles unmasked
    changes nothing: an emulation of the core on the map equals the plain
    version and the JAX kernel (interpret mode) at the file's TOL, and a
    fresh row that sees no key (the masked case) averages v over the K
    keys."""
    meta, qp = _key_meta(kind)
    P, H, D = 70, 2, 8
    seq = np.zeros((2, P + qp.shape[0]), np.int64)
    got_plain, want = _run_both(seq, P, H, D, seed=7, meta=meta,
                                q_positions=qp)
    B, S, hidden = got_plain.shape
    wide, cache, ln = _inputs(B, P, S, H, D, seed=7)
    y = torch.as_tensor(wide)[..., 1:4 * hidden + 1]
    tc = torch.as_tensor(cache)
    tpos = torch.as_tensor(qp)
    cos, sin = rope_tables(tpos, D // 2, 10000.0)
    ln_t = [torch.as_tensor(x) for x in ln]
    qn, kn = tfd.norm_rope_plain(y, ln_t[:2], ln_t[2:], cos, sin,
                                 hidden=hidden, num_heads=H,
                                 rotary_dim=D // 2, eps=1e-5)
    tmeta = [torch.as_tensor(m) for m in meta]
    rows = tfd.fused_rows(tmeta[0], tmeta[1], tpos, P, B)
    k = torch.cat([tc[1, 0, :, :P].flatten(2), kn], 1)
    v = torch.cat([tc[1, 1, :, :P].flatten(2), y[..., 2 * hidden:3 * hidden]],
                  1)
    vis = tfa.visible_mask(rows[3], rows[4], *tmeta[2:], rows[0],
                           pos_k=rows[2], seg_q=rows[1])
    got = _emulate(*(t.unflatten(-1, (H, D)) for t in (qn, k, v)), vis,
                   tfd.fused_tile_map(rows, *tmeta[2:]), D ** -0.5)
    got = got.reshape(B, S, hidden)
    np.testing.assert_allclose(got.numpy(), got_plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if kind == "masked":
        np.testing.assert_allclose(
            got[0, :10].numpy(), v[0].mean(0, keepdim=True).expand(
                10, -1).numpy(), atol=1e-5)


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


def _card_case(dev, P, S, seed, permuted=False, masked=False):
    """The cached step's operands at full width: y a [B, S, 14336] win
    output, ck/cv views of a 24-layer cache, bf16 LN params, t2i
    metadata with left pads.  ``permuted``: the fresh rows at a
    permutation of P + arange(S); ``masked``: in batch row 1 no segments,
    every position below P + 3 a pad and no row allowed to see pads, so
    the rows at positions P..P+2 see no key."""
    B, H, D = 4, 32, 64
    hidden = H * D
    seq = torch.as_tensor(_t2i_seq(B, P, S - 2, (0, 17, 60, 3), seed),
                          device=dev)
    seg, pad, last_pad, prefix = tfa.metadata_predict_next(seq, PAD, SOI, EOI)
    if masked:
        seg[1], last_pad[1] = 0, -1
        pad[1, :P + 3] = 1
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(B, S, 3 * hidden + 8192, generator=g,
                    device=dev).bfloat16()
    cache = torch.randn(2, B, P + S, H, D, generator=g, device=dev).bfloat16()
    ln = [(1 + 0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (1 + 0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (0.1 * torch.randn(D, generator=g, device=dev)).bfloat16()]
    pos = P + (torch.randperm(S, generator=g, device=dev) if permuted
               else torch.arange(S, device=dev))
    cos, sin = rope_tables(pos, 32, 10000.0)
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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _plain(args, kw, rows):
    return tfd.fused_decode_attention_plain(
        *args[:7], args[9], args[10], rows, **kw, sm_scale=0.125,
        softmax_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("P,S", [(129, 258), (129, 1026), (64, 40)],
                         ids=["256px", "512px", "aligned_prefix_short"])
def test_kernel_on_its_map_vs_plain_on_card(P, S):
    """Kernel 2 with the fresh rows at a permutation of P + arange(S) (keys
    at positions out of order) and the rows of batch row 1 at positions
    P..P+2 seeing no key: within 2e-2 of the plain version, those rows at
    the mean of v over the K = P + S keys; one pass, one core launch and
    one map a call; the map equal to its plain version byte for byte; the
    same bits over two launches."""
    dev = _cuda()
    args, kw, rows = _card_case(dev, P, S, seed=S + 1, permuted=True,
                                masked=True)
    names = (tfd.SOURCE, tfd.NORM_KERNEL, tfd.TILES_KERNEL)
    before = {n: cuda_build.launches[n] for n in names}
    runs = [tfd.fused_decode_attention(*args, **kw, rows=rows)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: cuda_build.launches[n] - before[n] for n in names} == {
        n: 2 for n in names}
    assert torch.equal(runs[0], runs[1])
    got, want = runs[0], _plain(args, kw, rows)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    tiles = tfd.fused_tile_map(rows, args[9], args[10])
    assert torch.equal(tiles, tfa.rows_tile_map_plain(
        rows[3], rows[4], args[9], args[10], rows[0], pos_k=rows[2],
        seg_q=rows[1]))
    assert tiles[1, :, -1].any()
    hidden = kw["hidden"]
    v = torch.cat([args[2][1], args[0][1, :, 2 * hidden:3 * hidden]]).float()
    dark = (rows[0][1] >= P) & (rows[0][1] < P + 3)
    assert int(dark.sum()) == 3
    assert (got[1, dark].float() - v.mean(0)).abs().max().item() <= 2e-2


def _ulp_bound(y, q_ln, k_ln, want, kw):
    """2 bf16 ulps of each value of the pass's plain output, or of the
    larger LayerNorm output it is made of (a roped value is a rounded sum
    of two rounded products of LayerNorm outputs, so a one-ulp difference
    there moves a value that cancels by an ulp of its terms)."""
    hidden, H, rd = kw["hidden"], kw["num_heads"], kw["rotary_dim"]
    bounds = []
    for i, (ln, w) in enumerate(zip((q_ln, k_ln), want)):
        n = tfd._layer_norm(y[..., i * hidden:(i + 1) * hidden].unflatten(
            -1, (H, -1)), *ln, kw["eps"]).float().abs()
        partner = torch.cat([n[..., rd // 2:rd], n[..., :rd // 2],
                             n[..., rd:]], -1)
        scale = torch.maximum(w.float().abs().unflatten(-1, (H, -1)),
                              torch.maximum(n, partner)).flatten(-2)
        bounds.append(2 * torch.exp2(torch.floor(torch.log2(
            scale.clamp_min(2.0 ** -100))) - 7))
    return bounds


@pytest.mark.cuda
def test_norm_rope_vs_plain_on_card():
    """The LN + RoPE pass against its plain twin at the 512^2 step: every
    value within 2 bf16 ulps (of itself, or of the LayerNorm outputs a
    roped value is made of); contiguous outputs; one launch."""
    dev = _cuda()
    args, kw, rows = _card_case(dev, 129, 1026, seed=3, permuted=True)
    y, _, _, q_ln, k_ln, cos, sin = args[:7]
    before = cuda_build.launches[tfd.NORM_KERNEL]
    got = tfd.norm_rope(y, q_ln, k_ln, cos, sin, **kw)
    torch.cuda.synchronize()
    assert cuda_build.launches[tfd.NORM_KERNEL] == before + 1
    want = tfd.norm_rope_plain(y, q_ln, k_ln, cos, sin, **kw)
    for g, w, bound in zip(got, want, _ulp_bound(y, q_ln, k_ln, want, kw)):
        assert g.is_contiguous() and g.shape == w.shape
        assert ((g.float() - w.float()).abs() <= bound).all()


@pytest.mark.cuda
def test_kernel_refuses_misaligned_views_on_card():
    """A y or cache view that breaks the 16-byte alignment of the pass's
    and the core's copies raises; nothing is copied."""
    dev = _cuda()
    args, kw, rows = _card_case(dev, 129, 64, seed=1)
    y, ck = args[0], args[1]
    wide = torch.zeros((*y.shape[:2], y.shape[2] + 1), dtype=y.dtype,
                       device=dev)
    shifted = torch.zeros(ck.numel() + 1, dtype=ck.dtype,
                          device=dev)[1:].view(ck.shape)
    for bad in ((wide[..., 1:],) + args[1:],
                args[:1] + (shifted,) + args[2:]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfd.fused_decode_attention(*bad, **kw, rows=rows)


@pytest.mark.cuda
def test_planted_fault_fails_on_card():
    """The check kernel 2 is held to (2e-2 max abs against its plain
    version) fails a core whose split is off by one row: key and value
    row P read from the cache's row P instead of the fresh rows' row 0."""
    dev = _cuda()
    P, S = 129, 1026
    args, kw, rows = _card_case(dev, P, S, seed=9)
    y, ck, cv, q_ln, k_ln, cos, sin = args[:7]
    qn, kn = tfd.norm_rope_plain(y, q_ln, k_ln, cos, sin, **kw)
    attend = dict(hidden=kw["hidden"], num_heads=kw["num_heads"],
                  sm_scale=0.125)
    want = tfd.fused_attend_plain(qn, kn, y, ck, cv, args[9], args[10], rows,
                                  **attend)
    assert (want.float() - _plain(args, kw, rows).float()).abs().max() <= 2e-2
    # the cache views one row longer: row P of the cache's memory
    ck1, cv1 = (t.as_strided((t.shape[0], P + 1, t.shape[2]), t.stride())
                for t in (ck, cv))
    bad = tfd.fused_attend_plain(qn, kn[:, 1:], y[:, 1:], ck1, cv1,
                                 args[9], args[10], rows, **attend)
    err = (bad.float() - want.float()).abs().max().item()
    assert err > 2e-2, err
