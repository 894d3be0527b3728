"""Prompt-lookup speculation of showo_tpu_torch's serving engine
(``serving/speculative.py``) against the JAX package's, on the CPU.

* ``make_verify_sample`` emits draws from exactly the filtered softmax of
  plain sampling: the first-token marginal and the second-token marginal
  given the first draft accepted, at tests/test_spec_sampling.py's draws
  and bounds (30000 / 60000, atol 0.02); a draft outside the top-k filter
  is never accepted; a -1 draft (an unknown id of the ring) is never
  accepted nor emitted; with top_k = 1 it is the greedy verify.
* ``verify_greedy``, the draft lookup (bigram, unigram, position 0) and
  ``spec_buf_update`` against JAX's, exact.
* The chunk-local and the naive speculative engines give the same greedy
  streams (v1 and v2), and the sampled speculative engine (k = 2, top-k 5)
  meets every budget with ids in the vocabulary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.serving import speculative as jspec
from showo_tpu.serving.fused_admit import spec_buf_update as j_buf_update
from showo_tpu_torch.serving import Showo2MMUServer, ShowoMMUServer
from showo_tpu_torch.serving import speculative as tspec
from test_serving import CFG, _prompt, _v2_prompt
from test_spec_sampling import _filtered_probs
from test_torch_serving import run_port, v1, v2  # noqa: F401

torch.set_num_threads(1)

V, K = 8, 2
MARGINAL_TOL = 0.02


def _trials(verify, logits, draft, n, seed):
    """n independent verifies of one [1, K+1, V] logits / [1, K] draft,
    as n lanes of one call."""
    lg = torch.as_tensor(np.asarray(logits)).expand(n, -1, -1)
    d = torch.as_tensor(np.asarray(draft)).expand(n, -1)
    out, m = verify(lg, d, torch.Generator().manual_seed(seed))
    return out.numpy(), m.numpy()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 4, None),
    (1.0, None, 0.85),
])
def test_first_token_marginal(temperature, top_k, top_p):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(1, K + 1, V)) * 2.0
    p = _filtered_probs(jnp.asarray(logits), temperature, top_k, top_p)[0, 0]
    draft = np.asarray([[int(np.argsort(-p)[1]), 0]])
    verify = tspec.make_verify_sample(temperature, top_k, top_p)
    out, _ = _trials(verify, logits.astype(np.float32), draft, 30000, 0)
    emp = np.bincount(out[:, 0], minlength=V) / out.shape[0]
    np.testing.assert_allclose(emp, p, atol=MARGINAL_TOL)


def test_second_token_marginal_given_first_accepted():
    temperature, top_k = 0.8, 5
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(1, K + 1, V)) * 2.0
    p = _filtered_probs(jnp.asarray(logits), temperature, top_k, None)
    draft = np.asarray([[int(np.argmax(p[0, 0])),
                         int(np.argsort(-p[0, 1])[1])]])
    verify = tspec.make_verify_sample(temperature, top_k, None)
    out, m = _trials(verify, logits.astype(np.float32), draft, 60000, 2)
    sel = m >= 1
    assert sel.mean() > 0.2
    emp = np.bincount(out[sel, 1], minlength=V) / sel.sum()
    np.testing.assert_allclose(emp, p[0, 1], atol=MARGINAL_TOL)


def test_filtered_out_and_unknown_drafts_never_accepted():
    """A draft of probability 0 (outside the top-k), and the ring's -1,
    are always rejected; the resample comes from the filtered support."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(1, K + 1, V)) * 2.0).astype(np.float32)
    p = _filtered_probs(jnp.asarray(logits), 1.0, 3, None)[0, 0]
    worst = int(np.argmin(p + (p > 0)))
    assert p[worst] == 0.0
    verify = tspec.make_verify_sample(1.0, 3, None)
    for d0 in (worst, -1):
        out, m = _trials(verify, logits, np.asarray([[d0, -1]]), 2000, 4)
        assert (m == 0).all()
        assert (out[:, 0] != d0).all() and (out[:, 0] >= 0).all()
        assert (p[out[:, 0]] > 0).all()


def test_topk1_reduces_to_greedy_verify():
    rng = np.random.default_rng(5)
    slots, k = 3, 3
    logits = torch.as_tensor(rng.normal(size=(slots, k + 1, V)) * 2.0)
    draft = logits.argmax(-1)[:, :k].clone()
    draft[0, 1] = (draft[0, 1] + 1) % V
    draft[2, 0] = (draft[2, 0] + 1) % V
    out_s, m_s = tspec.make_verify_sample(1.0, 1, None)(
        logits, draft, torch.Generator().manual_seed(6))
    out_g, m_g = tspec.verify_greedy(logits, draft)
    assert torch.equal(m_s, m_g)
    for s in range(slots):
        n = int(m_g[s]) + 1
        assert torch.equal(out_s[s, :n], out_g[s, :n])
    want_out, want_m = jspec.verify_greedy(None, jnp.asarray(logits.numpy()),
                                           jnp.asarray(draft.numpy()))
    np.testing.assert_array_equal(out_g.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(m_g.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("seed", range(4))
def test_draft_lookup_matches_jax(seed):
    """Rings with repeats (bigram and unigram hits), -1 runs and lanes at
    lengths 0 .. cap - 1: the same draft as JAX's ``_make_draft``."""
    cap, K_, slots = 24, 3, 6
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 5, size=(slots, cap))
    buf[0, 3:9] = -1
    lens = np.asarray([0, 1, 5, 12, cap - 2, cap - 1])
    cur = np.asarray([buf[s, ln] for s, ln in enumerate(lens)])
    cur[1] = 4                                   # a token not in the ring
    want = jax.vmap(jspec._make_draft(cap, K_))(
        jnp.asarray(buf, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(cur, jnp.int32))
    got = tspec.make_draft(cap, K_)(torch.as_tensor(buf),
                                    torch.as_tensor(lens),
                                    torch.as_tensor(cur))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_buf_update_matches_jax():
    cap, slots = 16, 3
    rng = np.random.default_rng(7)
    buf = rng.integers(0, 9, size=(slots, cap))
    toks = rng.integers(0, 9, size=slots)
    lengths = np.asarray([4, 0, cap - 1], np.int32)
    row = rng.integers(-1, 9, size=cap)
    want = j_buf_update(jnp.asarray(buf, jnp.int32), jnp.asarray(toks),
                        jnp.asarray(lengths), jnp.asarray(row),
                        jnp.asarray(11, jnp.int32), 1, 6)
    got = torch.as_tensor(buf)
    tspec.spec_buf_update(got, torch.as_tensor(toks),
                          torch.as_tensor(lengths), torch.as_tensor(row),
                          torch.tensor(11), 1, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_v1_chunk_local_matches_naive(v1):  # noqa: F811
    _, model = v1["plain"]
    rng = np.random.default_rng(3)
    reqs = [(_prompt(rng, q), b)
            for q, b in [(3, 5), (7, 9), (2, 4), (10, 7), (5, 11)]]
    streams = [run_port(ShowoMMUServer, model, reqs, slots=2, cap=64,
                        chunk=3, buckets=(16, 24), temperature=1.0, top_k=1,
                        speculative_k=2, spec_chunk_local=local)[1]
               for local in (True, False)]
    assert streams[0] == streams[1]


def test_v2_chunk_local_matches_naive(v2):  # noqa: F811
    _, model = v2
    rng = np.random.default_rng(5)
    reqs = [(_v2_prompt(rng, t)[0], 3, b, list(rng.integers(2, 190, size=t)))
            for t, b in [(3, 6), (5, 9), (2, 5)]]
    streams = []
    for local in (True, False):
        with torch.no_grad():
            server = Showo2MMUServer(model, slots=2, cap=72, chunk=3,
                                     buckets=(20, 28), temperature=1.0,
                                     top_k=1, speculative_k=2,
                                     spec_chunk_local=local)
            handles = [server.submit(torch.as_tensor(e), s, b,
                                     lookup_ids=ids)
                       for e, s, b, ids in reqs]
            server.run(torch.Generator().manual_seed(5))
        streams.append([h.tokens for h in handles])
    assert streams[0] == streams[1]


def test_engine_speculative_sampling_e2e(v1):  # noqa: F811
    """Sampled speculation end to end (no A/B): budgets met, every token a
    vocabulary id (never the ring's -1)."""
    _, model = v1["plain"]
    rng = np.random.default_rng(7)
    reqs = [(_prompt(rng, q), b) for q, b in [(3, 5), (6, 8), (4, 6)]]
    server, got = run_port(ShowoMMUServer, model, reqs, seed=8, slots=2,
                           cap=64, chunk=3, buckets=(24,), temperature=0.9,
                           top_k=5, speculative_k=2, lookahead=2,
                           spec_adaptive=False)
    assert server.engine._alt_decode_chunk is None
    assert [len(t) for t in got] == [b for _, b in reqs]
    assert all(0 <= t < CFG.vocab_size for ts in got for t in ts)
