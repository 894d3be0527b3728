"""Ring attention over a gloo group of 8 ranks against dense attention
and against the JAX package's ring.

JAX twin: ``tests/test_ring_attention.py`` (its case: B=2, H=4, Hkv=2,
S=1024, D=16, an image span in each row, left padding, a prefix; atol
2e-5, rtol 1e-4; and the single-device degenerate case).  The 8 ranks
run every case in one group (``tests/_gloo_group.py``, 180 s wall-time
limit) while this process computes the JAX side.
"""

import os

import numpy as np
import pytest
import torch

from showo_tpu_torch.ops.ring_attention import (NEG_INF, ring_omni_attention,
                                                ring_omni_attention_sharded)
from _gloo_group import start_group

WORLD = 8


def _case(kind):
    """q, k, v [B, H|Hkv, S, D] fp32, seg, pad [B, S], last_pad, prefix."""
    B, H, Hkv, S, D = 2, 4, 2, 1024, 16
    rng = np.random.default_rng(0 if kind == "jax" else 5)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    seg[0, 100:400] = 1                # bidirectional image span
    seg[1, 500:900] = 2
    pad = np.zeros((B, S), np.int32)
    pad[0, :16] = 1                    # left padding
    last_pad = np.asarray([15, -1], np.int32)
    prefix = np.asarray([0, 64], np.int32)
    if kind == "masked":
        # rows 0-15 of row 0 see only pad keys: fully masked rows
        last_pad = np.asarray([-1, -1], np.int32)
        prefix = np.asarray([0, 0], np.int32)
    return q, k, v, seg, pad, last_pad, prefix


def _dense(q, k, v, seg, pad, last_pad, prefix):
    """Dense softmax attention under the predicate's additive bias."""
    B, S = seg.shape
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    vis = np.broadcast_to(j <= i, (B, S, S)).copy()
    vis |= (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    vis |= j[None] < prefix[:, None, None]
    keep = (pad[:, None, :] == 0) | (i[None] <= last_pad[:, None, None])
    bias = np.where(vis & keep, 0.0, NEG_INF)[:, None]
    g = q.shape[1] // k.shape[1]
    kq, vq = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  kq) / np.sqrt(q.shape[-1]) + bias
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, vq).astype(np.float32)


def ring_worker(rank, world, workdir):
    """Each rank: the whole-input wrapper over the whole group for every
    case, and the per-rank body on its own rows; rank 0 saves."""
    out = {}
    for kind in ("jax", "masked"):
        args = [torch.as_tensor(a) for a in _case(kind)]
        full = ring_omni_attention_sharded(None, *args)
        n = args[0].shape[2] // world
        rows = slice(rank * n, (rank + 1) * n)
        q, k, v, seg, pad, last_pad, prefix = args
        mine = ring_omni_attention(q[:, :, rows], k[:, :, rows],
                                   v[:, :, rows], seg[:, rows],
                                   pad[:, rows], last_pad, prefix)
        assert torch.equal(mine, full[:, :, rows])
        out[kind] = full.numpy()
    if rank == 0:
        np.savez(os.path.join(workdir, "ring.npz"), **out)


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """Start the 8 ranks, compute JAX's ring meanwhile, wait."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from showo_tpu.ops.ring_attention import \
        ring_omni_attention_sharded as jring

    workdir = str(tmp_path_factory.mktemp("ring"))
    group = start_group("test_torch_ring_attention:ring_worker", WORLD,
                        workdir)
    try:
        want = {}
        with Mesh(np.array(jax.devices()[:WORLD]), ("sp",)) as mesh:
            for kind in ("jax", "masked"):
                args = [jnp.asarray(a) for a in _case(kind)]
                want[kind] = np.asarray(jax.jit(
                    lambda *a: jring(mesh, *a))(*args))
    except BaseException:
        group.kill()
        raise
    group.wait(timeout=180)
    got = np.load(os.path.join(workdir, "ring.npz"))
    return {k: got[k] for k in got.files}, want


def test_ring_8_ranks_vs_dense(ring_run):
    got, _ = ring_run
    np.testing.assert_allclose(got["jax"], _dense(*_case("jax")),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["jax", "masked"])
def test_ring_8_ranks_vs_jax_ring(ring_run, kind):
    """The same numpy inputs through JAX's ``ring_omni_attention_sharded``
    on the 8-device mesh; ``masked`` has rows that see no key (both give
    0 there: ``m_safe``)."""
    got, want = ring_run
    np.testing.assert_allclose(got[kind], want[kind], atol=2e-5, rtol=1e-4)
    if kind == "masked":
        assert np.all(got[kind][0, :, :16] == 0)


def test_ring_single_rank_degenerate():
    """No process group: one rank, no rotation, the dense result."""
    B, H, S, D = 1, 2, 256, 8
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32)
               for _ in range(3))
    seg = np.zeros((B, S), np.int32)
    want = _dense(q, k, v, seg, np.zeros((B, S), np.int32),
                  np.asarray([-1], np.int32), np.asarray([0], np.int32))
    got = ring_omni_attention_sharded(
        None, *(torch.as_tensor(a) for a in (q, k, v, seg)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
