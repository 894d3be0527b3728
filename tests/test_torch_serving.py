"""Continuous-batching serving of showo_tpu_torch (``serving/``,
``inference_serve.py``) against the JAX package's, on the CPU, fp32.

The tiny configs and seeded prompts of tests/test_serving.py; weights
carried across by ``showo_state_dict`` / ``showo2_state_dict``; the port's
engine on ``device="cpu"``.

* Greedy streams token-exact against the JAX engine (its run without
  fused admission, whose streams equal per-request decode in JAX's own
  tests) and against the port's per-request decode (``showo_mmu_generate``,
  and Qwen2 prefill + ``ar_generate`` for v2), for v1 and v2, with fused
  admission on and off; and the speculative engine (k = 2, 3) chunk-local
  and naive.  The port's fused admission is held to per-request decode,
  not to JAX's fused program (whose own exactness test is unsteady on the
  CPU).
* Slot reuse, ``stat_steps`` equal to the JAX engine's, one host read a
  window; EOT freeing a slot (with and without fused admission); the A/B
  probation under sampling; the window forwards' logits against JAX within
  1e-5 (bf16-layout fp32 and int8 caches); the CLI end to end, v1 and v2.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models.phi import fuse_parallel_mlp as j_fuse_mlp
from showo_tpu.models.showo import init_showo_params
from showo_tpu.serving import Showo2MMUServer as JServer2
from showo_tpu.serving import ShowoMMUServer as JServer
from showo_tpu.serving import decode_chunk as jdc
from showo_tpu.show_o2.showo2 import init_showo2_params
from showo_tpu.utils.torch_export import showo2_state_dict, showo_state_dict
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.ops.masks import omni_mask_mmu
from showo_tpu_torch.sampling.ar import ar_generate
from showo_tpu_torch.serving import Showo2MMUServer, ShowoMMUServer
from showo_tpu_torch.serving import decode_chunk as tdc
from showo_tpu_torch.show_o2 import dit as tdit
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.show_o2.masks import omni_attn_mask
from showo_tpu_torch.show_o2.siglip import SigLipConfig
from showo_tpu_torch.utils.convert import load_showo, load_showo2
from test_serving import CFG, EOI, V2, _prompt, _v2_prompt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW_TOL = 1e-5     # window forward logits, port vs JAX (fp32)


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


TCFG = tshowo.ShowoConfig(
    **_fields(CFG, ("vocab_size", "llm_vocab_size", "num_new_special_tokens",
                    "codebook_size", "num_vq_tokens")),
    llm=tphi.PhiConfig(**_fields(CFG.llm, (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "max_position_embeddings"))))
TCFG2 = tshowo2.Showo2Config(
    llm=tqwen2.Qwen2Config(**_fields(V2.llm, (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim"))),
    siglip=SigLipConfig(**_fields(V2.siglip, (
        "hidden_size", "intermediate_size", "num_heads", "num_layers",
        "num_positions"))),
    dit=tdit.DiffusionHeadConfig(**_fields(V2.dit, (
        "hidden_size", "intermediate_size", "num_heads", "num_kv_heads",
        "head_dim", "num_layers"))),
    **_fields(V2, ("image_latent_dim", "image_latent_height",
                   "image_latent_width", "patch_size", "clip_latent_dim")))


@pytest.fixture(scope="module")
def v1():
    """(JAX params, port model), plain and fuse_parallel_mlp layouts."""
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_showo_params(CFG, k, jnp.float32))(
        jax.random.PRNGKey(0)))
    model = load_showo(tshowo.Showo(TCFG), showo_state_dict(
        params, CFG.llm.num_layers)).eval()
    fused = copy.deepcopy(model)
    tphi.fuse_parallel_mlp(fused.showo)
    fparams = dict(params, showo=j_fuse_mlp(params["showo"]))
    return {"plain": (params, model), "fused": (fparams, fused)}


@pytest.fixture(scope="module")
def v2():
    params = jax.tree.map(np.asarray,
                          init_showo2_params(V2, jax.random.PRNGKey(1)))
    model = load_showo2(tshowo2.Showo2(TCFG2), showo2_state_dict(
        params, V2.llm.num_layers, V2.siglip.num_layers,
        V2.dit.num_layers)).eval()
    return params, model


def port_reference(model, prompt, budget):
    """Per-request greedy decode of the port (``showo_mmu_generate``)."""
    ids = torch.as_tensor(prompt, dtype=torch.long)[None]
    with torch.no_grad():
        toks, _ = tshowo.showo_mmu_generate(
            model, ids, prompt_bias=omni_mask_mmu(ids, eoi_id=EOI),
            max_new_tokens=budget, top_k=1)
    return toks[0].tolist()


def port_reference_v2(model, emb, img_start, budget):
    """Per-request greedy decode of the port's Qwen2 under the v2 omni mask
    (``pipelines/mmu_v2.py::generate``'s loop)."""
    qwen = model.showo
    emb = torch.as_tensor(emb)[None]
    S = emb.shape[1]
    cap = S + budget + 4
    mp = torch.tensor([[[img_start, TCFG2.num_image_tokens]]])

    def prefill(_ids, pb):
        cache = tqwen2.Qwen2KVCache.zeros(TCFG2.llm, 1, cap)
        pb = torch.nn.functional.pad(pb, (0, cap - S), value=-1e9)
        logits, _ = qwen(input_embeds=emb, attention_bias=pb, cache=cache)
        return logits, cache

    def decode(tok, b, cache):
        logits, _ = qwen(input_ids=tok, attention_bias=b, cache=cache)
        return logits, cache

    with torch.no_grad():
        toks, _ = ar_generate(prefill, decode, torch.zeros((1, S),
                                                           dtype=torch.long),
                              max_new_tokens=budget, top_k=1,
                              prompt_bias=omni_attn_mask(mp, S))
    return toks[0].tolist()


def run_port(server_cls, model, reqs, seed=11, **kw):
    with torch.no_grad():
        server = server_cls(model, **kw)
        handles = [server.submit(*r) for r in reqs]
        done = server.run(torch.Generator().manual_seed(seed))
    assert len(done) == len(reqs)
    return server, [h.tokens for h in handles]


def run_jax(server_cls, params, reqs, seed=11, **kw):
    server = server_cls(CFG if server_cls is JServer else V2,
                        jax.tree.map(jnp.asarray, params), **kw)
    handles = [server.submit(*r) for r in reqs]
    server.run(jax.random.PRNGKey(seed))
    return server, [h.tokens for h in handles]


V1_REQS = [(3, 5), (7, 9), (2, 4), (10, 7), (5, 11), (4, 3)]
V1_KW = dict(slots=2, cap=48, chunk=3, buckets=(16, 24), temperature=1.0,
             top_k=1)


@pytest.fixture(scope="module")
def v1_streams(v1):
    """The JAX engine's greedy streams (no fused admission) on the plain
    and fused layouts, and the port's per-request decode."""
    rng = np.random.default_rng(3)
    reqs = [(_prompt(rng, q), b) for q, b in V1_REQS]
    out = {"reqs": reqs}
    for layout, (params, model) in v1.items():
        _, out[f"jax_{layout}"] = run_jax(JServer, params, reqs,
                                          fused_admit=False, **V1_KW)
        out[f"ref_{layout}"] = [port_reference(model, p, b)
                                for p, b in reqs]
    return out


@pytest.mark.parametrize("layout,fused_admit", [
    ("plain", None), ("fused", False), ("fused", True)])
def test_v1_engine_token_exact(v1, v1_streams, layout, fused_admit):
    """Greedy streams equal the JAX engine's and the port's per-request
    decode, each request exactly its budget."""
    _, model = v1[layout]
    reqs = v1_streams["reqs"]
    server, got = run_port(ShowoMMUServer, model, reqs,
                           fused_admit=fused_admit, **V1_KW)
    assert [len(t) for t in got] == [b for _, b in reqs]
    assert got == v1_streams[f"jax_{layout}"]
    assert got == v1_streams[f"ref_{layout}"]
    fused_ran = bool(server.engine._fused_cache)
    assert fused_ran == (layout == "fused" and fused_admit is not False)


@pytest.mark.parametrize("chunk_local", [True, False])
def test_v1_speculative_token_exact(v1, chunk_local):
    """Prompt-lookup speculation (k = 3; repetitive questions so drafts
    are both accepted and rejected) gives the per-request greedy streams,
    chunk-local and naive."""
    _, model = v1["plain"]
    rng = np.random.default_rng(17)
    reqs = []
    for q_len, b in [(6, 9), (3, 12), (8, 5), (4, 14)]:
        p = _prompt(rng, q_len)
        p[-q_len:] = np.tile(p[-q_len:][:2], q_len // 2 + 1)[:q_len]
        reqs.append((p, b))
    server, got = run_port(ShowoMMUServer, model, reqs, seed=29, slots=2,
                           cap=64, chunk=3, buckets=(16, 24),
                           temperature=1.0, top_k=1, speculative_k=3,
                           spec_chunk_local=chunk_local)
    assert got == [port_reference(model, p, b) for p, b in reqs]
    eng = server.engine
    # drafts were accepted (more tokens than lane steps) and rejected
    assert eng.stat_lane_steps < eng.stat_step_tokens < (
        4 * eng.stat_lane_steps)


def test_v1_speculative_with_fused_admission(v1):
    """Speculation with fused admission forced on (the ring records each
    admission step): still the per-request streams."""
    _, model = v1["fused"]
    rng = np.random.default_rng(13)
    reqs = [(_prompt(rng, q), b) for q, b in [(3, 6), (8, 12), (2, 4),
                                              (9, 8), (5, 15)]]
    server, got = run_port(ShowoMMUServer, model, reqs, slots=2, cap=80,
                           chunk=3, buckets=(16, 24), temperature=1.0,
                           top_k=1, speculative_k=2, fused_admit=True)
    assert server.engine._fused_cache
    assert got == [port_reference(model, p, b) for p, b in reqs]


def test_slot_reuse_and_accounting(v1):
    """Five requests through two slots: every budget met, timestamps set,
    the same decode steps as the JAX engine, one host read a window."""
    params, model = v1["plain"]
    rng = np.random.default_rng(5)
    reqs = [(_prompt(rng, 4), 6) for _ in range(5)]
    kw = dict(slots=2, cap=64, chunk=4, buckets=(24,), temperature=1.0,
              top_k=1)
    with torch.no_grad():
        server = ShowoMMUServer(model, **kw)
        handles = [server.submit(p, b) for p, b in reqs]
        done = server.run(torch.Generator().manual_seed(1))
    assert len(done) == 5
    for h in handles:
        assert len(h.tokens) == 6
        assert h.first_token_at is not None and h.finished_at is not None
    jserver, jtoks = run_jax(JServer, params, reqs, seed=1, **kw)
    eng = server.engine
    assert eng.stat_steps == jserver.engine.stat_steps
    assert eng.stat_syncs == eng.stat_windows > 0
    assert [h.tokens for h in handles] == jtoks


@pytest.mark.parametrize("layout", ["plain", "fused"])
def test_eot_frees_slot(v1, layout):
    """A request hitting EOT ends early and its slot serves the queue; on
    the fused layout the later admissions ride decode steps."""
    _, model = v1[layout]
    rng = np.random.default_rng(9)
    prompt = _prompt(rng, 4)
    eot = port_reference(model, prompt, 3)[1]
    slots = 1 if layout == "plain" else 2
    with torch.no_grad():
        server = ShowoMMUServer(model, slots=slots, cap=64, chunk=4,
                                buckets=(24,), temperature=1.0, top_k=1,
                                eot_token=eot)
        h = server.submit(prompt, 10)
        rest = [server.submit(_prompt(rng, 5), 4) for _ in range(3)]
        done = server.run(torch.Generator().manual_seed(2))
    assert len(done) == 4
    assert h.done and h.tokens[-1] == eot and len(h.tokens) <= 4
    assert all(r.done and len(r.tokens) <= 4 for r in rest)
    assert bool(server.engine._fused_cache) == (layout == "fused")


def test_spec_adaptive_ab_commits_and_completes(v1):
    """Under temperature sampling the engine probes the speculative and
    plain programs and commits to one; every request meets its budget
    with ids in the vocabulary.  Greedy speculation builds no A/B."""
    _, model = v1["fused"]
    rng = np.random.default_rng(23)
    reqs = [(_prompt(rng, q), b) for q, b in [(6, 40), (3, 50), (8, 45),
                                              (4, 60)]]
    server, got = run_port(ShowoMMUServer, model, reqs, seed=41, slots=2,
                           cap=160, chunk=3, buckets=(16, 24),
                           temperature=0.9, top_k=None, top_p=0.9,
                           speculative_k=2)
    assert server.engine._alt_decode_chunk is not None
    assert [len(t) for t in got] == [b for _, b in reqs]
    assert all(0 <= t < CFG.vocab_size for ts in got for t in ts)
    assert server.engine.ab_choice in ("primary", "alt")
    greedy = ShowoMMUServer(model, slots=2, cap=64, chunk=3,
                            buckets=(16, 24), top_k=1, speculative_k=2)
    assert greedy.engine._alt_decode_chunk is None
    assert greedy.engine.ab_choice is None


V2_KW = dict(slots=2, cap=64, chunk=3, buckets=(20, 28), temperature=1.0,
             top_k=1)


@pytest.fixture(scope="module")
def v2_streams(v2):
    params, model = v2
    rng = np.random.default_rng(11)
    reqs = [(_v2_prompt(rng, t)[0], 3, b)
            for t, b in [(2, 5), (6, 8), (1, 4), (9, 6), (4, 9)]]
    _, jtoks = run_jax(JServer2, params, reqs, seed=13, fused_admit=False,
                       **V2_KW)
    return {"reqs": reqs, "jax": jtoks,
            "ref": [port_reference_v2(model, e, s, b) for e, s, b in reqs]}


@pytest.mark.parametrize("fused_admit", [False, True])
def test_v2_engine_token_exact(v2, v2_streams, fused_admit):
    _, model = v2
    reqs = [(torch.as_tensor(e), s, b) for e, s, b in v2_streams["reqs"]]
    server, got = run_port(Showo2MMUServer, model, reqs,
                           fused_admit=fused_admit, **V2_KW)
    assert got == v2_streams["jax"] == v2_streams["ref"]
    assert bool(server.engine._fused_cache) == fused_admit


@pytest.mark.parametrize("chunk_local", [True, False])
def test_v2_speculative_token_exact(v2, chunk_local):
    """v2 speculation (embedding prompts, the -1 ring seeded by
    lookup_ids) gives the per-request greedy streams."""
    _, model = v2
    rng = np.random.default_rng(31)
    reqs = [(_v2_prompt(rng, t)[0], 3, b, list(rng.integers(2, 190, size=t)))
            for t, b in [(4, 10), (6, 7), (3, 12)]]
    with torch.no_grad():
        server = Showo2MMUServer(model, slots=2, cap=72, chunk=3,
                                 buckets=(20, 28), temperature=1.0, top_k=1,
                                 speculative_k=3,
                                 spec_chunk_local=chunk_local)
        handles = [server.submit(torch.as_tensor(e), s, b, lookup_ids=ids)
                   for e, s, b, ids in reqs]
        server.run(torch.Generator().manual_seed(37))
    assert [h.tokens for h in handles] == [
        port_reference_v2(model, e, s, b) for e, s, b, _ in reqs]


# -- window forwards against JAX ---------------------------------------------

def _window_case(seed, L, slots, cap, Fcap, H, Dh, W, vocab, int8):
    """Seeded caches, side buffers, lengths and a window (numpy)."""
    rng = np.random.default_rng(seed)
    ck = rng.normal(size=(L, slots, cap, H, Dh)).astype(np.float32)
    cv = rng.normal(size=(L, slots, cap, H, Dh)).astype(np.float32)
    fk = rng.normal(size=(L, slots, Fcap, H, Dh)).astype(np.float32)
    fv = rng.normal(size=(L, slots, Fcap, H, Dh)).astype(np.float32)
    lens0 = np.asarray([5, 0, 17][:slots], np.int32)
    lens = lens0 + np.asarray([2, 0, 4][:slots], np.int32)
    window = rng.integers(0, vocab, size=(slots, W)).astype(np.int32)
    j = lambda c: jdc.kv_quantize(jnp.asarray(c)) if int8 else jnp.asarray(c)
    t = (lambda c: tuple(torch.as_tensor(np.array(x)) for x in
                         jdc.kv_quantize(jnp.asarray(c))) if int8
         else torch.as_tensor(c))
    return ((window, lens0, lens, j(ck), j(cv), fk, fv),
            (window, lens0, lens, t(ck), t(cv), fk, fv))


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_v1_window_forward_vs_jax(v1, W, int8):
    """Logits and side buffers of the v1 window forward (fused layout)
    against JAX within 1e-5, on a bf16-layout (fp32 here) or int8 cache."""
    params, model = v1["fused"]
    slots, cap, Fcap = 3, 24, 8
    jargs, targs = _window_case(W, 2, slots, cap, Fcap, 4, 16, W,
                                CFG.vocab_size, int8)
    jfwd, _ = jdc.make_v1_window_forward(CFG, slots=slots, cap=cap,
                                         Fcap=Fcap, dtype=jnp.float32)
    want, wfk, _ = jfwd(jax.tree.map(jnp.asarray, params["showo"]),
                        *map(jnp.asarray, jargs[:3]), *jargs[3:5],
                        jnp.asarray(jargs[5]), jnp.asarray(jargs[6]))
    tfwd, shape = tdc.make_v1_window_forward(model.showo, slots=slots,
                                             cap=cap, Fcap=Fcap)
    window, lens0, lens, ck, cv, fk, fv = targs
    fk, fv = torch.as_tensor(fk), torch.as_tensor(fv)
    with torch.no_grad():
        got = tfwd(torch.as_tensor(window).long(), torch.as_tensor(lens0),
                   torch.as_tensor(lens), ck, cv, fk, fv)
    assert tuple(fk.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=WINDOW_TOL, rtol=0)
    np.testing.assert_allclose(fk.numpy(), np.asarray(wfk), atol=WINDOW_TOL,
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_v2_window_forward_vs_jax(v2, int8):
    params, model = v2
    slots, cap, Fcap, W = 3, 24, 8, 3
    llm = V2.llm
    jargs, targs = _window_case(7, llm.num_layers, slots, cap, Fcap,
                                llm.num_kv_heads, llm.head_dim, W,
                                llm.vocab_size, int8)
    jfwd, _ = jdc.make_v2_window_forward(llm, slots=slots, cap=cap,
                                         Fcap=Fcap, dtype=jnp.float32)
    want, _, wfv = jfwd(jax.tree.map(jnp.asarray, params["showo"]),
                        *map(jnp.asarray, jargs[:3]), *jargs[3:5],
                        jnp.asarray(jargs[5]), jnp.asarray(jargs[6]))
    tfwd, _ = tdc.make_v2_window_forward(model.showo, slots=slots, cap=cap,
                                         Fcap=Fcap)
    window, lens0, lens, ck, cv, fk, fv = targs
    fk, fv = torch.as_tensor(fk), torch.as_tensor(fv)
    with torch.no_grad():
        got = tfwd(torch.as_tensor(window).long(), torch.as_tensor(lens0),
                   torch.as_tensor(lens), ck, cv, fk, fv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=WINDOW_TOL, rtol=0)
    np.testing.assert_allclose(fv.numpy(), np.asarray(wfv), atol=WINDOW_TOL,
                               rtol=0)


def test_decode_chunk_scatters_once_at_the_chunk_start(v1):
    """One plain chunk: lengths advance by the chunk for every lane, and
    the cache rows lens0 .. lens0 + chunk - 1 hold the K/V that per-step
    writes through the model's per-lane cache path give."""
    _, model = v1["fused"]
    phi = model.showo
    slots, cap, chunk = 2, 32, 3
    shape = (CFG.llm.num_layers, slots, cap, CFG.llm.num_heads,
             CFG.llm.head_dim)
    g = torch.Generator().manual_seed(0)
    ck, cv = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    lengths = torch.tensor([4, 9], dtype=torch.int32)
    tok = torch.tensor([7, 30])
    dec = tdc.build_v1_decode_chunk(phi, cap=cap, chunk=chunk, slots=slots,
                                    sample=lambda lg, _: lg.argmax(-1))
    ck2, cv2 = ck.clone(), cv.clone()
    with torch.no_grad():
        lens, cur, toks, nvalid = dec(ck, cv, lengths, tok, None)
        cache = tphi.KVCache(ck2, cv2, lengths)
        t = tok
        for i in range(chunk):
            kpos = torch.arange(cap)
            bias = torch.where(kpos < cache.length[:, None, None, None] + 1,
                               0.0, -1e9)
            logits, cache = phi(input_ids=t[:, None], attention_bias=bias,
                                cache=cache)
            t = logits[:, -1].argmax(-1)
            assert torch.equal(t, toks[i, :, 0])
    assert lens.tolist() == [4 + chunk, 9 + chunk] and torch.equal(cur, t)
    assert nvalid.tolist() == [[1, 1]] * chunk
    torch.testing.assert_close(ck, ck2, atol=1e-6, rtol=0)
    torch.testing.assert_close(cv, cv2, atol=1e-6, rtol=0)


# -- the CLI -----------------------------------------------------------------

def _requests(tmp_path, n_img=2):
    from PIL import Image

    paths = []
    for i in range(n_img):
        p = tmp_path / f"img{i}.png"
        Image.new("RGB", (24, 20), (i * 90, 40, 10)).save(p)
        paths.append(str(p))
    reqs = tmp_path / "requests.jsonl"
    lines = [{"image": paths[0], "question": "what color"},
             {"image": paths[-1], "question": "describe",
              "max_new_tokens": 3},
             {"image": paths[0], "question": "is it big"}]
    reqs.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return reqs


@pytest.mark.parametrize("v2_cli", [False, True])
def test_serve_cli_end_to_end(tmp_path, monkeypatch, capsys, v2_cli):
    """``inference_serve`` from a requests.jsonl at a tiny size on the CPU:
    config, image encode, prompt assembly, serve, decode, the out jsonl
    with each request's TTFT, in submission order."""
    from showo_tpu_torch import inference_serve
    from test_torch_mmu import TINY_OVERRIDES as V1_TINY
    from test_torch_mmu_v2 import CLI_TINY as V2_TINY

    reqs = _requests(tmp_path)
    out = tmp_path / "answers.jsonl"
    if v2_cli:
        args = ["config=configs/showo2_1.5b_demo_432x432.yaml", "v2=1"]
        args += V2_TINY + ["int8=1"]
    else:
        args = ["config=configs/showo_demo.yaml", "spec=2"] + V1_TINY
    args += [f"requests={reqs}", f"out={out}", "device=cpu", "slots=2",
             "chunk=3", "max_new_tokens=5"]
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["inference_serve"] + args)
    inference_serve.main()
    lines = [json.loads(ln) for ln in open(out)]
    assert [ln["question"] for ln in lines] == ["what color", "describe",
                                                "is it big"]
    for ln in lines:
        assert "answer" in ln and ln["ttft_s"] is not None
        assert len(ln["tokens"]) <= 5
    assert len(lines[1]["tokens"]) <= 3
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if "User:" in ln]
    assert [p.split("]")[0] for p in printed] == ["[img0.png", "[img1.png",
                                                  "[img0.png"]
