"""The int8 KV cache of showo_tpu_torch's serving engine
(``serving/decode_chunk.py``) against the JAX package's, on the CPU.

* ``kv_quantize`` bit-exact against JAX (int8 data and fp32 scales) and
  exact on rows that are multiples of absmax / 127 (the JAX test's round
  trip); ``kv_cache_write`` and ``scatter_fresh`` give JAX's cache bit for
  bit (pair and dense), the scatter at per-lane offsets.
* The engine with ``kv_int8``: speculation (k = 2) token-exact against
  plain decode on the same int8 cache, and greedy output near the
  full-precision per-request decode (agreement >= 0.75 of the tokens,
  tests/test_kv_int8.py's limit), for v1 and v2; the ``ValueError`` of
  each combination the int8 cache does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.serving import decode_chunk as jdc
from showo_tpu_torch.serving import Showo2MMUServer, ShowoMMUServer
from showo_tpu_torch.serving import decode_chunk as tdc
from test_serving import _prompt, _v2_prompt
from test_torch_serving import (port_reference, port_reference_v2, run_port,
                                v1, v2)  # noqa: F401

torch.set_num_threads(1)

AGREE = 0.75      # int8-cache greedy tokens equal to full precision


def test_kv_quantize_roundtrip_exact():
    base = torch.arange(-127, 127, 2, dtype=torch.float32)[:64].reshape(
        1, 1, 64)
    x = torch.stack([base * 0.01, base * 3.0], dim=2)      # [1, 1, 2, 64]
    q, s = tdc.kv_quantize(x)
    torch.testing.assert_close(q.float() * s[..., None], x, rtol=1e-6,
                               atol=1e-8)
    assert q.dtype == torch.int8 and tuple(s.shape) == tuple(x.shape[:-1])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_kv_quantize_bit_exact_vs_jax(scale):
    x = (np.random.default_rng(1).normal(size=(3, 5, 4, 16)) * scale
         ).astype(np.float32)
    x[0, 0, 1] = 0.0                                 # an all-zero head row
    wq, ws = jdc.kv_quantize(jnp.asarray(x))
    q, s = tdc.kv_quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


@pytest.mark.parametrize("int8", [False, True])
def test_kv_cache_write_and_scatter_vs_jax(int8):
    """A prefill write into lane 1, then a side-buffer scatter at per-lane
    chunk-start lengths: JAX's cache bit for bit."""
    shape = (2, 3, 12, 2, 4)                  # [L, slots, cap, h, Dh]
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(2, 1, 5, 2, 4)).astype(np.float32)
    fk = rng.normal(size=(2, 3, 4, 2, 4)).astype(np.float32)
    fv = rng.normal(size=(2, 3, 4, 2, 4)).astype(np.float32)
    lens0 = np.asarray([5, 0, 8], np.int32)
    jk = jdc.kv_cache_zeros(shape, int8, jnp.float32)
    jv = jdc.kv_cache_zeros(shape, int8, jnp.float32)
    jk = jdc.kv_cache_write(jk, jnp.asarray(rows), (0, 1, 0, 0))
    jk, jv = jdc.scatter_fresh(jk, jv, jnp.asarray(fk), jnp.asarray(fv),
                               jnp.asarray(lens0))
    tk = tdc.kv_cache_zeros(shape, int8, torch.float32)
    tv = tdc.kv_cache_zeros(shape, int8, torch.float32)
    assert isinstance(tk, tuple) == int8
    tdc.kv_cache_write(tk, torch.as_tensor(rows), 1)
    tdc.scatter_fresh(tk, tv, torch.as_tensor(fk), torch.as_tensor(fv),
                      torch.as_tensor(lens0))
    for got, want in ((tk, jk), (tv, jv)):
        got = got if int8 else (got,)
        want = want if int8 else (want,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _agreement(outs, ref):
    total = sum(len(t) for t in ref)
    agree = sum(int(a == b) for ts, rs in zip(outs, ref)
                for a, b in zip(ts, rs))
    return agree / total


def test_v1_kv_int8_near_exact_and_spec_token_exact(v1):  # noqa: F811
    _, model = v1["plain"]
    rng = np.random.default_rng(41)
    reqs = []
    for q_len, b in [(5, 8), (3, 11), (7, 6), (4, 9)]:
        p = _prompt(rng, q_len)
        p[-q_len:] = np.tile(p[-q_len:][:2], q_len // 2 + 1)[:q_len]
        reqs.append((p, b))
    outs = {}
    for spec in (0, 2):
        server, outs[spec] = run_port(
            ShowoMMUServer, model, reqs, seed=43, slots=2, cap=64, chunk=3,
            buckets=(16, 24), temperature=1.0, top_k=1, speculative_k=spec,
            kv_int8=True)
        assert isinstance(server.engine.cache_k, tuple)
        assert [len(t) for t in outs[spec]] == [b for _, b in reqs]
    assert outs[0] == outs[2], "speculation must be exact given the cache"
    ref = [port_reference(model, p, b) for p, b in reqs]
    assert _agreement(outs[0], ref) >= AGREE


def test_v2_kv_int8_near_exact_and_spec_token_exact(v2):  # noqa: F811
    _, model = v2
    rng = np.random.default_rng(47)
    reqs = [(_v2_prompt(rng, t)[0], 3, b, list(rng.integers(2, 190, size=t)))
            for t, b in [(4, 9), (6, 7), (3, 11)]]
    outs = {}
    for spec in (0, 2):
        with torch.no_grad():
            server = Showo2MMUServer(model, slots=2, cap=72, chunk=3,
                                     buckets=(20, 28), temperature=1.0,
                                     top_k=1, speculative_k=spec,
                                     kv_int8=True)
            handles = [server.submit(torch.as_tensor(e), s, b,
                                     **({"lookup_ids": ids} if spec else {}))
                       for e, s, b, ids in reqs]
            server.run(torch.Generator().manual_seed(53))
        assert [len(h.tokens) for h in handles] == [b for _, _, b, _ in reqs]
        outs[spec] = [h.tokens for h in handles]
    assert outs[0] == outs[2]
    ref = [port_reference_v2(model, e, s, b) for e, s, b, _ in reqs]
    assert _agreement(outs[0], ref) >= AGREE


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kw", [dict(fused_admit=True),
                                dict(speculative_k=2,
                                     spec_chunk_local=False)],
                         ids=["fused_admit", "naive_spec"])
def test_kv_int8_refuses_what_it_does_not_take(v1, v2, version,  # noqa: F811
                                               kw):
    model = v1["fused"][1] if version == "v1" else v2[1]
    cls = ShowoMMUServer if version == "v1" else Showo2MMUServer
    with pytest.raises(ValueError, match="kv_int8 requires"):
        cls(model, slots=2, cap=48, chunk=3, buckets=(16, 24), kv_int8=True,
            **kw)
    server = cls(model, slots=2, cap=48, chunk=3, buckets=(16, 24),
                 kv_int8=True)
    assert server.engine._fused_admit_for is None
