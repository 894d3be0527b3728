"""The Show-o2 prefix cache, the samplers and the ``streaming`` route of
showo_tpu_torch against the JAX package, on the CPU, fp32.

* ``Qwen2.forward`` with a ``Qwen2KVCache``: a prefill at offset 0, then
  fresh rows written at per-row offsets (each row's span starts elsewhere)
  attending at per-row positions to every cached key, against JAX's
  ``qwen2_forward``: logits, hidden states and both caches within atol
  1e-4, on ``dense`` and ``packed`` (JAX's Pallas kernel in interpret
  mode).  JAX's streaming kernel takes no per-row q positions, so the
  port's ``streaming`` route is held to the port's dense one.
* ``showo2_t2i_prefill``: the Qwen and DiT K/V against JAX's.
* ``showo2_t2i_velocity_cached`` with CFG and the cond and null rows at
  different offsets: against JAX's (dense, packed) and against the port's
  own uncached ``showo2_t2i_velocity`` (dense, packed, streaming), atol
  1e-4; the text really reaches the cached rows.
* The cached pipeline's latents against JAX's cached pipeline (dense,
  packed), and on ``streaming`` against the port's uncached ``packed``
  pipeline, atol 1e-4; the tile map made once per generate.
* Every ``sampling_method`` of the pipeline (heun, dpm-solver, dopri5)
  against JAX's pipeline on the tiny model's velocity, atol 1e-4 (dopri5:
  1e-3, its rtol: the velocities' fp32 differences move its adaptive
  steps); dopri5 on one velocity (the port's, reached by JAX through a
  host callback) within atol 1e-4, with as many evaluations.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.show_o2 import masks as jmasks
from showo_tpu.show_o2 import qwen2 as jqwen2
from showo_tpu.show_o2 import showo2 as jshowo2
from showo_tpu.show_o2 import transport as jtransport
from showo_tpu.utils.torch_import import qwen2_params_from_torch
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.pipelines import t2i_v2 as tpipeline
from showo_tpu_torch.show_o2 import masks as tmasks
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.show_o2 import transport as ttransport
from showo_tpu_torch.utils.assets import validation_prompts_file
from test_torch_show_o2 import (QWEN_TINY, _golden, _jax_packed_interpreted,
                                _meta, _weights, port_showo2, showo2_params,
                                tiny_showo2_cfgs)
from test_torch_t2i_v2 import (DOPRI5_ATOL, PROMPTS, STEPS,  # noqa: F401
                               _jax_generate, weights)

torch.set_num_threads(1)

ATOL = 1e-4


def _port_meta(route, mp, L, q_positions=None):
    """The port's PackedMeta of ``route`` for spans mp (None on dense)."""
    if route == "dense":
        return None
    _, tmeta = _meta(np.asarray(mp), L)
    return tqwen2.packed_meta((route,) + tmeta[1:], q_positions)


# -- Qwen2 with a cache at per-row offsets ------------------------------------

@pytest.fixture(scope="module")
def qwen():
    g = _golden("qwen2_tiny")
    model = tqwen2.Qwen2(tqwen2.Qwen2Config(**QWEN_TINY))
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in _weights(g).items()})
    params = jax.tree.map(jnp.asarray,
                          qwen2_params_from_torch(_weights(g), num_layers=2))
    return model.eval(), params


N_SPAN = 9
OFFSETS = np.array([5, 2, 7])


def _qwen_inputs(L=24):
    rng = np.random.default_rng(0)
    B = len(OFFSETS)
    ids = rng.integers(0, 160, size=(B, L))
    mp = np.stack([[[o, N_SPAN]] for o in OFFSETS])
    fresh = (rng.normal(size=(B, N_SPAN, 64)) * 0.5).astype(np.float32)
    pos = OFFSETS[:, None] + np.arange(N_SPAN)
    return ids, mp, fresh, pos


def _qwen_port(model, route, ids, mp, fresh, pos):
    B, L = ids.shape
    bias = tmasks.omni_attn_mask(torch.as_tensor(mp), L)
    cache = tqwen2.Qwen2KVCache.zeros(model.cfg, B, L)
    pos_t = torch.as_tensor(pos)
    with torch.no_grad():
        model(torch.as_tensor(ids), attention_bias=bias, cache=cache,
              attn_meta=_port_meta(route, mp, L))
        assert cache.length == L
        rows = tqwen2.cache_rows(torch.as_tensor(OFFSETS), N_SPAN)
        logits, h = model(
            input_embeds=torch.as_tensor(fresh), position_ids=pos_t,
            attention_bias=torch.gather(bias, 2, rows[1][:, None, :, None]
                                        .expand(B, 1, N_SPAN, L)),
            attn_meta=_port_meta(route, mp, L, pos_t), cache=cache,
            cache_offsets=torch.as_tensor(OFFSETS))
    return logits, h, cache


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_qwen2_cache_vs_jax(qwen, route):
    model, params = qwen
    ids, mp, fresh, pos = _qwen_inputs()
    B, L = ids.shape
    jcfg = jqwen2.Qwen2Config(**QWEN_TINY)
    jbias = jmasks.omni_attn_mask(jnp.asarray(mp), L)
    jmeta = _meta(mp, L)[0] if route == "packed" else None
    with _jax_packed_interpreted():
        _, _, jcache = jqwen2.qwen2_forward(
            jcfg, params, input_ids=jnp.asarray(ids),
            attention_bias=jbias if jmeta is None else None,
            cache=jqwen2.Qwen2KVCache.zeros(jcfg, B, L), attn_meta=jmeta)
        jl, jh, jcache = jqwen2.qwen2_forward(
            jcfg, params, input_embeds=jnp.asarray(fresh),
            attention_bias=jnp.take_along_axis(
                jbias, jnp.asarray(pos)[:, None, :, None], axis=2),
            position_ids=jnp.asarray(pos), cache=jcache,
            cache_offsets=jnp.asarray(OFFSETS), attn_meta=jmeta)
    tl, th, tcache = _qwen_port(model, route, ids, mp, fresh, pos)
    assert th.shape == (B, N_SPAN, 64)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=ATOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               atol=ATOL)


def test_qwen2_cache_streaming_vs_dense(qwen):
    """The K-blocked kernel's route with the cache: q rows at per-row
    positions against every cached key, through head-major views."""
    model, _ = qwen
    inputs = _qwen_inputs()
    with mock.patch.object(tqwen2, "omni_attention_streaming",
                           wraps=tqwen2.omni_attention_streaming) as spy:
        sl, sh, sc = _qwen_port(model, "streaming", *inputs)
    assert spy.call_count == 2 * 2          # prefill + fresh, 2 layers
    dl, dh, dc = _qwen_port(model, "dense", *inputs)
    np.testing.assert_allclose(sh.numpy(), dh.numpy(), atol=ATOL)
    np.testing.assert_allclose(sl.numpy(), dl.numpy(), atol=ATOL)
    np.testing.assert_allclose(sc.k.numpy(), dc.k.numpy(), atol=ATOL)


def test_packed_meta_of_fresh_rows():
    """The fresh rows' metadata: q at per-row positions, seg_q the
    segments there, and on a kernel route the tile map that
    ``rows_tile_map_plain`` gives (here the CPU needs none)."""
    ids, mp, _, pos = _qwen_inputs()
    L = ids.shape[1]
    meta = _port_meta("streaming", mp, L, torch.as_tensor(pos))
    assert meta.route == "streaming" and meta.tiles is None
    assert meta.pos_q.dtype == torch.int32 and meta.pos_q.shape == (3, 9)
    np.testing.assert_array_equal(meta.pos_q.numpy(), pos)
    np.testing.assert_array_equal(
        meta.seg_q.numpy(), np.take_along_axis(meta.seg.numpy(), pos, 1))
    assert (meta.seg_q > 0).all()               # every fresh row in a span
    plain = tfa.rows_tile_map_plain(meta.seg, meta.pad, meta.last_pad,
                                    meta.prefix, meta.pos_q)
    assert plain.shape == (3, 1, 2)


# -- prefill and cached velocity ---------------------------------------------

@pytest.fixture(scope="module")
def showo2():
    jcfg, tcfg = tiny_showo2_cfgs()
    params = showo2_params(jcfg)
    model = port_showo2(tcfg, jcfg, params)
    tshowo2.fuse_inference(model)
    jparams = jshowo2.fuse_inference(jax.tree.map(jnp.asarray, params))
    rng = np.random.default_rng(1)
    B, L, n = 4, 32, jcfg.num_image_tokens
    text = rng.integers(10, 1000, size=(B, L))
    # cond rows at their prompts' ends, the null rows' spans at 2
    mp = np.asarray([[[5, n]], [[9, n]], [[2, n]], [[2, n]]])
    z = rng.normal(size=(B, 16, 8, 8)).astype(np.float32)
    t = np.asarray([0.37, 0.61, 0.37, 0.61], np.float32)
    return jcfg, jparams, model, text, mp, z, t


def _jax_cached(jcfg, jparams, text, mp, z, t, route, guidance):
    L = text.shape[1]
    n = jcfg.num_image_tokens
    bias = jmasks.omni_attn_mask(jnp.asarray(mp), L)
    jmeta = _meta(mp, L)[0] if route == "packed" else None
    offs = mp[:, 0, 0]
    idx = jnp.asarray(offs[:, None] + np.arange(n))
    with _jax_packed_interpreted():
        qkv, dkv = jshowo2.showo2_t2i_prefill(
            jcfg, jparams, jnp.asarray(text),
            None if jmeta else bias, jnp.asarray(mp), attn_meta=jmeta)
        v = jshowo2.showo2_t2i_velocity_cached(
            jcfg, jparams, jnp.asarray(z), jnp.asarray(t),
            None if jmeta else jnp.take_along_axis(
                bias, idx[:, None, :, None], axis=2),
            jnp.asarray(mp), qkv, dkv, guidance_scale=guidance,
            attn_meta=jmeta)
    return qkv, dkv, np.asarray(v)


def _port_cached(model, text, mp, z, t, route, guidance, prefill_text=None):
    B, L = text.shape
    n = model.cfg.num_image_tokens
    mp_t = torch.as_tensor(mp)
    bias = tmasks.omni_attn_mask(mp_t, L) if route == "dense" else None
    rows = tqwen2.cache_rows(mp_t[:, 0, 0], n)
    with torch.no_grad():
        qc, dkv = tshowo2.showo2_t2i_prefill(
            model, torch.as_tensor(text if prefill_text is None
                                   else prefill_text),
            bias, mp_t, _port_meta(route, mp, L))
        # the evaluation overwrites the span rows in place: keep the
        # prefill's
        prefill = (qc.k.clone(), qc.v.clone()), tuple(t.clone() for t in dkv)
        v = tshowo2.showo2_t2i_velocity_cached(
            model, torch.as_tensor(z), torch.as_tensor(t),
            None if bias is None else torch.gather(
                bias, 2, rows[1][:, None, :, None].expand(B, 1, n, L)),
            mp_t, qc, dkv, guidance_scale=guidance,
            attn_meta=_port_meta(route, mp, L, rows[1]), rows=rows)
    return (*prefill, v)


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_prefill_vs_jax(showo2, route):
    jcfg, jparams, model, text, mp, z, t = showo2
    jq, jd, _ = _jax_cached(jcfg, jparams, text, mp, z, t, route, 0.0)
    tq, td, _ = _port_cached(model, text, mp, z, t, route, 0.0)
    assert tq[0].shape == (2, 4, 32, 2, 16) and td[0].shape == (2, 4, 32, 2,
                                                                24)
    for got, want in ((tq[0], jq[0]), (tq[1], jq[1]), (td[0], jd[0]),
                      (td[1], jd[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("route", ["dense", "packed", "streaming"])
def test_velocity_cached_vs_jax_and_uncached(showo2, route):
    jcfg, jparams, model, text, mp, z, t = showo2
    guidance = 5.0
    _, _, got = _port_cached(model, text, mp, z, t, route, guidance)
    L = text.shape[1]
    with torch.no_grad():
        full = tshowo2.showo2_t2i_velocity(
            model, torch.as_tensor(text), torch.as_tensor(z),
            torch.as_tensor(t),
            tmasks.omni_attn_mask(torch.as_tensor(mp), L)
            if route == "dense" else None,
            torch.as_tensor(mp), guidance_scale=guidance,
            attn_meta=_port_meta(route, mp, L))
    assert got.shape == (4, 16, 8, 8) and float(full.abs().max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL)
    # JAX's cached velocity (its streaming kernel takes no per-row q
    # positions: the packed route's is the same function)
    jroute = "packed" if route == "streaming" else route
    _, _, want = _jax_cached(jcfg, jparams, text, mp, z, t, jroute, guidance)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_velocity_cached_reads_the_prefill(showo2):
    """The cached rows carry the text: a prefill of other text gives
    another velocity."""
    _, _, model, text, mp, z, t = showo2
    _, _, a = _port_cached(model, text, mp, z, t, "dense", 0.0)
    _, _, b = _port_cached(model, text, mp, z, t, "dense", 0.0,
                           prefill_text=(text + 7) % 1000)
    assert float((a - b).abs().max()) > 1e-3


# -- the pipeline -----------------------------------------------------------

def _pipelines(weights, route, **kw):
    from test_torch_t2i_v2 import _pipelines as both

    return both(weights, route, **kw)


Z = np.random.default_rng(7).normal(size=(2, 16, 8, 8)).astype(np.float32)


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_cached_pipeline_vs_jax(weights, route):  # noqa: F811
    jpipe, tpipe = _pipelines(weights, route, prefix_cache=True)
    assert tpipe.prefix_cache and jpipe.prefix_cache
    _, _, jlat, _ = _jax_generate(jpipe, jnp.asarray(Z))
    lat = tpipe.generate_latents(PROMPTS, noise=Z)
    assert float(np.abs(jlat - Z).max()) > 1e-2
    np.testing.assert_allclose(lat.numpy(), jlat, atol=ATOL, rtol=0)


def test_cached_streaming_pipeline_vs_uncached(weights):  # noqa: F811
    """The streaming route with the prefix cache against the packed route
    without it; every attention goes through the K-blocked kernel's
    wrapper (prefill + 2 cached evaluations, 2 + 2 layers each)."""
    _, cached = _pipelines(weights, "streaming", prefix_cache=True)
    _, plain = _pipelines(weights, "packed")
    with mock.patch.object(tqwen2, "omni_attention_streaming",
                           wraps=tqwen2.omni_attention_streaming) as spy, \
            mock.patch.object(tpipeline, "packed_meta",
                              wraps=tpipeline.packed_meta) as metas:
        lat = cached.generate_latents(PROMPTS, noise=Z)
    assert spy.call_count == STEPS * (2 + 2)
    # the metadata and tile maps: one for the prefill, one for the fresh
    # rows, whatever the number of evaluations
    assert sum(1 for c in metas.call_args_list
               if not isinstance(c.args[0], tqwen2.PackedMeta)) == 2
    want = plain.generate_latents(PROMPTS, noise=Z)
    np.testing.assert_allclose(lat.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("method", ["heun", "dpm-solver", "dopri5"])
def test_pipeline_samplers_vs_jax(weights, method):  # noqa: F811
    jpipe, tpipe = _pipelines(weights, "dense", sampling_method=method)
    _, _, jlat, _ = _jax_generate(jpipe, jnp.asarray(Z))
    lat = tpipe.generate_latents(PROMPTS, noise=Z)
    np.testing.assert_allclose(
        lat.numpy(), jlat, rtol=0,
        atol=DOPRI5_ATOL if method == "dopri5" else ATOL)
    if method == "dopri5":
        assert tpipe.sampler_stats["nfe"] == 2 + 6 * (
            tpipe.sampler_stats["accepted"] + tpipe.sampler_stats["rejected"])


def test_dopri5_on_the_model_velocity_vs_jax(weights):  # noqa: F811
    """dopri5 against JAX's on one drift, the tiny model's velocity with
    CFG (the port's, which JAX's integrator reaches through a host
    callback): as many velocity evaluations, the first step's at the same
    times, and the latents within atol 1e-4.  What is left of DOPRI5_ATOL above is the
    two frameworks' velocities, not the integrator."""
    _, tpipe = _pipelines(weights, "dense", sampling_method="dopri5")
    drift = tpipe.drift(*tpipe.build_inputs(PROMPTS))
    z = np.concatenate([Z, Z])
    times = []

    def host_drift(x, t):
        times.append(float(t[0]))
        with torch.no_grad():
            return drift(torch.as_tensor(np.array(x)),
                         torch.as_tensor(np.array(t))).numpy()

    want = np.asarray(jtransport.sample_ode_dopri5(
        lambda x, t: jax.pure_callback(
            host_drift, jax.ShapeDtypeStruct(x.shape, jnp.float32), x, t),
        jnp.asarray(z)))
    calls, stats = [], {}

    def traced(x, t):
        calls.append(float(t[0]))
        return drift(x, t)

    with torch.no_grad():
        got = ttransport.sample_ode_dopri5(traced, torch.as_tensor(z),
                                           stats=stats)
    assert stats["nfe"] == len(calls) == len(times)
    # the start and the first step at JAX's times; later steps within 5%
    # (the error norm's float32 sum in another order, as on the analytic
    # drifts of tests/test_torch_transport.py)
    np.testing.assert_allclose(calls[:8], times[:8], rtol=1e-6)
    np.testing.assert_allclose(calls, times, rtol=5e-2)
    assert float(np.abs(want - z).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_build_pipeline_takes_prefix_cache_and_streaming():
    from test_torch_t2i_v2 import _tiny_config

    pipe = inference_t2i_v2.build_pipeline(
        _tiny_config("transport.sampling_method=dpm-solver"),
        torch.device("cpu"), attn_impl="streaming", prefix_cache=True)
    assert (pipe.attn_route, pipe.prefix_cache, pipe.sampling_method) == (
        "streaming", True, "dpm-solver")
    images = pipe.generate(["a cat"], torch.Generator().manual_seed(0))
    assert images.shape == (1, 16, 16, 3) and np.isfinite(images).all()


# -- on the card: kernels 1 and 5 at the cached shapes ----------------------

def slice_rows(device):
    """The 432x432 slice's [cond; null] spans of the first four in-tree
    prompts (the stand-in tokenizer), its truncated length L and the
    fresh rows' cache index: (mp [8, 1, 2], L, rows)."""
    from showo_tpu_torch.show_o2.formats import prepare_gen_input

    with open(validation_prompts_file()) as f:
        prompts = [p for p in f.read().splitlines() if p.strip()][:4]
    ids = inference_t2i_v2.FAKE_TOKEN_IDS
    toks, toks_null, mp, mp_null = prepare_gen_input(
        prompts, inference_t2i_v2.FakeQwenTokenizer(), 730, ids["bos_id"],
        ids["eos_id"], ids["boi_id"], ids["eoi_id"], ids["pad_id"],
        ids["img_pad_id"], 256)
    mp = np.concatenate([mp[:, 0], mp_null[:, 0]])[:, None]
    L = min(toks.shape[1], (int((mp[..., 0] + mp[..., 1]).max()) + 127)
            // 128 * 128)
    mp = torch.as_tensor(mp, device=device)
    return mp, L, tqwen2.cache_rows(mp[:, 0, 0], 730)


def _card_case(route, H, Hkv, D, seed):
    dev = torch.device("cuda")
    mp, L, rows = slice_rows(dev)
    B, n = rows[1].shape
    meta = _port_meta_on(route, mp, L, rows[1])
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, n, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, L, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    # the keys past each span (eoi / pads), which no fresh row sees, carry
    # a large V: a q row at a wrong position past its span sees one
    for b, (off, length) in enumerate(mp[:, 0].tolist()):
        v[b, off + length:] = 64.0
    return meta, q, k, v


def _port_meta_on(route, mp, L, q_positions):
    from showo_tpu_torch.ops.flash_attention import \
        seg_from_modality_positions

    B, dev = mp.shape[0], mp.device
    return tqwen2.packed_meta((
        route, seg_from_modality_positions(mp, L),
        torch.zeros((B, L), dtype=torch.int32, device=dev),
        torch.full((B,), -1, dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.int32, device=dev)), q_positions)


def _plain(route, q, k, v, meta, pos_q):
    """The route's plain version, out [B, Q, H*D]."""
    from showo_tpu_torch.ops import streaming_attention as tsa

    B, Q, H, D = q.shape
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix, pos_q)
    if route == "streaming":
        out = tsa.omni_attention_streaming_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), *m,
            sm_scale=D ** -0.5)
        return out.transpose(1, 2).reshape(B, Q, H * D)
    return tfa.omni_attention_packed_plain(
        q.reshape(B, Q, -1), k.reshape(B, k.shape[1], -1),
        v.reshape(B, v.shape[1], -1), *m, num_heads=H,
        num_kv_heads=k.shape[2], sm_scale=D ** -0.5)


CARD_SHAPES = [("qwen", 12, 2, 128), ("dit", 32, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["packed", "streaming"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: s[0])
def test_cached_kernels_on_card(route, shape):
    """Kernel 1 (packed) and kernel 5 (streaming) at the slice's cached
    shapes (B=8, Q=730 fresh rows at per-row positions, K=768 keys), as
    the model calls them (``qwen2.gqa_attention`` on [B, S, H, D] views):
    against the plain version within 2e-2, the tile map byte for byte,
    the same bits over two launches; a fault planted in the plain version
    (one row's offset shifted by one, so that its last q row sees a key
    past its span, whose V is large) fails the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from showo_tpu_torch.ops import cuda_build

    _, H, Hkv, D = shape
    meta, q, k, v = _card_case(route, H, Hkv, D, seed=D)
    assert meta.route == route and meta.pos_q.shape == (8, 730)
    plain_map = tfa.rows_tile_map_plain(meta.seg, meta.pad, meta.last_pad,
                                        meta.prefix, meta.pos_q)
    assert torch.equal(meta.tiles, plain_map)
    counter = ("streaming_attention" if route == "streaming"
               else "omni_attention_packed")
    before = cuda_build.launches[counter]
    runs = [tqwen2.gqa_attention(q, k, v, None, meta) for _ in range(2)]
    torch.cuda.synchronize()
    assert cuda_build.launches[counter] - before == 2
    want = _plain(route, q, k, v, meta, meta.pos_q)
    err = (runs[0].float() - want.float()).abs().max().item()
    assert err <= 2e-2, err
    assert torch.equal(runs[0], runs[1])
    shifted = meta.pos_q.clone()
    shifted[2] += 1                                # one row's offset + 1
    fault = (runs[0].float() - _plain(route, q, k, v, meta, shifted)
             .float()).abs().max().item()
    assert fault > 2e-2, fault
