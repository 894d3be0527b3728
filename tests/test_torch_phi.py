"""showo_tpu_torch Phi vs the reference golden (tests/golden/phi_tiny.npz)
and vs JAX ``phi_forward`` in its three modes (no cache, prefill into a
cache, static prefix), with ``fuse_parallel_mlp`` params on both sides,
on every ported attention route (the JAX Pallas kernels in interpret
mode, the port's plain versions).  fp32 on the CPU; tolerance atol 2e-5,
rtol 1e-4, as tests/test_phi.py (two implementations of the same fp32
math, differing in summation order)."""

import contextlib
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import phi as jphi
from showo_tpu.ops import decode_attention as jda
from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops import fused_decode as jfd
from showo_tpu.ops import streaming_attention as jsa
from showo_tpu.ops.masks import omni_mask_predict_next as j_mask
from showo_tpu.utils.torch_import import phi_params_from_torch
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models.showo import Showo, ShowoConfig
from showo_tpu_torch.ops import flash_attention as tfa
from showo_tpu_torch.ops.masks import to_additive
from showo_tpu_torch.utils.convert import load_showo

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "phi_tiny.npz")
J_TINY = jphi.PhiConfig(vocab_size=120, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, max_position_embeddings=128)
T_TINY = tphi.PhiConfig(vocab_size=120, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, max_position_embeddings=128)
TOL = dict(atol=2e-5, rtol=1e-4)
PAD, SOI, EOI = 99, 101, 102
KERNEL_ROUTES = ["packed", "omni", "decode", "fused", "streaming"]


@contextlib.contextmanager
def jax_kernels_interpreted():
    """The JAX package's Pallas kernels in interpret mode, as its own tests
    run them on the CPU (block_q 8 for the omni kernels, 8 x 8 blocks for
    the streaming one)."""
    def interp(fn, **defaults):
        def run(*args, **kw):
            kw["interpret"] = True
            for k, v in defaults.items():
                kw.setdefault(k, v)
            return fn(*args, **kw)
        return run

    with mock.patch.object(jfa, "omni_attention_packed",
                           interp(jfa.omni_attention_packed, block_q=8)), \
            mock.patch.object(jfa, "omni_attention",
                              interp(jfa.omni_attention, block_q=8)), \
            mock.patch.object(jda, "decode_attention",
                              interp(jda.decode_attention)), \
            mock.patch.object(jfd, "fused_decode_attention",
                              interp(jfd.fused_decode_attention)), \
            mock.patch.object(jsa, "omni_attention_streaming",
                              interp(jsa.omni_attention_streaming,
                                     block_q=8, block_k=8)):
        yield


# the port function each route's layers call (``fused`` outside the static
# prefix cached step: the omni kernel)
ROUTE_FN = {"packed": "omni_attention_packed", "omni": "omni_attention",
            "decode": "decode_attention", "fused": "fused_decode_attention",
            "streaming": "omni_attention_streaming"}


def spy_route(route, static=True):
    """Wraps the port function ``route`` must reach; check ``call_count``."""
    name = ROUTE_FN[route] if static or route != "fused" else "omni_attention"
    return mock.patch.object(tphi, name, wraps=getattr(tphi, name))


def _metas(ids, route):
    """(JAX attn_meta, port attn_meta) of ``route`` for token rows ids."""
    if route == "dense":
        return None, None
    return ((tphi.ATTN_ROUTES[route],)
            + jfa.metadata_predict_next(jnp.asarray(ids), PAD, SOI, EOI),
            (route,) + tfa.metadata_predict_next(torch.as_tensor(ids), PAD,
                                                 SOI, EOI))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _port(golden, fusion="none"):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    m = load_showo(Showo(ShowoConfig(vocab_size=120, llm=T_TINY)), sd).showo
    if fusion == "mlp":
        tphi.fuse_parallel_mlp(m)
    elif fusion == "qkv":
        tphi.fuse_qkv(m)
    return m


def _jax_params(golden, fused=True):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("w::")}
    p = phi_params_from_torch(sd, num_layers=2)
    return jphi.fuse_parallel_mlp(p) if fused else p


@pytest.mark.parametrize("fusion", ["none", "qkv", "mlp"])
def test_logits_vs_golden(golden, fusion):
    model = _port(golden, fusion)
    bias = to_additive(torch.as_tensor(golden["mask"]))
    with torch.no_grad():
        logits, cache = model(input_ids=torch.as_tensor(golden["ids"]),
                              attention_bias=bias)
    assert cache is None
    np.testing.assert_allclose(logits.numpy(), golden["logits"], **TOL)


def _t2i_rows(seed, B=2, P=10, img=9):
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        p = 3 * b
        rows.append([PAD] * p + rng.integers(3, 99, size=P - 1 - p).tolist()
                    + [SOI] + rng.integers(3, 99, size=img).tolist() + [EOI])
    return np.asarray(rows)


def test_no_cache_vs_jax(golden):
    ids = _t2i_rows(0)
    jbias = j_mask(jnp.asarray(ids), PAD, SOI, EOI, rm_pad_in_image=True)
    want, _ = jphi.phi_forward(J_TINY, _jax_params(golden),
                               input_ids=jnp.asarray(ids),
                               attention_bias=jbias)
    with torch.no_grad():
        got, _ = _port(golden, "mlp")(input_ids=torch.as_tensor(ids),
                                      attention_bias=torch.tensor(
                                          np.asarray(jbias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_cache_vs_jax(golden):
    """Prefill S rows into a cache, then decode 3 single rows, both
    packages writing their caches; logits and cache contents agree."""
    rng = np.random.default_rng(1)
    B, S, T, S_max = 2, 8, 3, 12
    ids = rng.integers(0, 120, size=(B, S + T))
    causal = np.tril(np.ones((S_max, S_max), bool))
    jparams = _jax_params(golden)
    port = _port(golden, "mlp")
    jcache = jphi.KVCache.zeros(J_TINY, B, S_max)
    tcache = tphi.KVCache.zeros(T_TINY, B, S_max)
    bias = np.where(causal, 0.0, -1e9).astype(np.float32)[None, None]
    for lo, hi in [(0, S)] + [(S + t, S + t + 1) for t in range(T)]:
        want, jcache = jphi.phi_forward(
            J_TINY, jparams, input_ids=jnp.asarray(ids[:, lo:hi]),
            attention_bias=jnp.asarray(bias[:, :, lo:hi]), cache=jcache)
        with torch.no_grad():
            got, tcache = port(input_ids=torch.as_tensor(ids[:, lo:hi]),
                               attention_bias=torch.as_tensor(
                                   bias[:, :, lo:hi]), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"rows {lo}:{hi}")
    assert tcache.length == int(jcache.length) == S + T
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **TOL)


@pytest.mark.parametrize("route", ["omni", "decode", "fused", "streaming"])
def test_no_cache_routes_vs_jax(golden, route):
    """The uncached forward on each kernel route (``fused`` falls through
    to the omni kernel, as in JAX), against JAX with its Pallas kernels in
    interpret mode."""
    ids = _t2i_rows(4)
    jbias = j_mask(jnp.asarray(ids), PAD, SOI, EOI, rm_pad_in_image=True)
    jmeta, tmeta = _metas(ids, route)
    with jax_kernels_interpreted():
        want, _ = jphi.phi_forward(J_TINY, _jax_params(golden),
                                   input_ids=jnp.asarray(ids),
                                   attention_bias=jbias, attn_meta=jmeta)
    with torch.no_grad(), spy_route(route, static=False) as spy:
        got, _ = _port(golden, "mlp")(
            input_ids=torch.as_tensor(ids),
            attention_bias=torch.tensor(np.asarray(jbias)), attn_meta=tmeta)
    assert spy.call_count == T_TINY.num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("route", ["dense"] + KERNEL_ROUTES)
def test_static_prefix_vs_jax(golden, route):
    """The cached MaskGIT step: prefill the text prefix, then forward the
    image span against it (static_prefix_len) with the sliced lm head.
    The kernel routes run the JAX Pallas kernels in interpret mode and the
    port's plain versions; on ``fused`` both take the one-kernel layer
    (``win`` params)."""
    ids = _t2i_rows(2)
    B, L = ids.shape
    P = 10
    jbias = j_mask(jnp.asarray(ids), PAD, SOI, EOI, rm_pad_in_image=True)
    tbias = torch.tensor(np.asarray(jbias))
    jparams = _jax_params(golden)
    port = _port(golden, "mlp")
    head = (1, L - P - 1, 103, 119)

    jcache = jphi.KVCache.zeros(J_TINY, B, L)
    _, jcache = jphi.phi_forward(J_TINY, jparams,
                                 input_ids=jnp.asarray(ids[:, :P]),
                                 attention_bias=jbias[:, :, :P], cache=jcache)
    jcache = jphi.KVCache(jcache.k, jcache.v, jnp.asarray(P, jnp.int32))
    tcache = tphi.KVCache.zeros(T_TINY, B, L)
    with torch.no_grad():
        port(input_ids=torch.as_tensor(ids[:, :P]),
             attention_bias=tbias[:, :, :P], cache=tcache)

    jmeta, tmeta = _metas(ids, route)
    with jax_kernels_interpreted():
        want, _ = jphi.phi_forward(
            J_TINY, jparams, input_ids=jnp.asarray(ids[:, P:]),
            attention_bias=jbias[:, :, P:], cache=jcache, attn_meta=jmeta,
            lm_head_slice=head, static_prefix_len=P)
    with torch.no_grad(), (spy_route(route) if tmeta else
                           contextlib.nullcontext()) as spy:
        got, _ = port(input_ids=torch.as_tensor(ids[:, P:]),
                      attention_bias=tbias[:, :, P:], cache=tcache,
                      attn_meta=tmeta, lm_head_slice=head,
                      static_prefix_len=P)
    assert spy is None or spy.call_count == T_TINY.num_layers
    assert got.shape == (B, L - P - 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("route", ["streaming", "trainable"])
def test_later_routes_raise(golden, route):
    """The routes whose kernels came in a later slice run and match the
    dense forward under the additive mask: the streaming route, and the
    trainable route past the packed trainable budget (set to 0 here; at
    this width it falls at S > 20480), where the dispatcher takes the
    K-blocked trainable kernels (kernel 8), as in JAX."""
    from showo_tpu_torch.ops import packed_attention_grad as tpag

    port = _port(golden, "mlp")
    ids = torch.as_tensor(_t2i_rows(3))
    bias = to_additive(tfa.visible_mask(
        *tfa.metadata_predict_next(ids, PAD, SOI, EOI),
        torch.arange(ids.shape[1]).expand(ids.shape)))[:, None]
    meta = (route,) + tfa.metadata_predict_next(ids, PAD, SOI, EOI)
    name = ("omni_attention_trainable" if route == "trainable"
            else "omni_attention_streaming")
    owner = tpag if route == "trainable" else tphi
    with torch.no_grad(), \
            mock.patch.object(tpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(owner, name,
                              wraps=getattr(owner, name)) as spy:
        got, _ = port(input_ids=ids, attn_meta=meta)
        want, _ = port(input_ids=ids, attention_bias=bias)
    assert spy.call_count == T_TINY.num_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("route", ["pallas", "pallas_fused", "pallas_decode",
                                   "pallas_packed", "flash", "dense",
                                   "pallas_streaming"])
def test_unknown_route_raises(golden, route):
    """The port takes its own route names only: a JAX impl string, an
    unknown name, or ``dense`` given as metadata raise ValueError."""
    port = _port(golden)
    ids = torch.as_tensor(_t2i_rows(3))
    meta = (route,) + tfa.metadata_predict_next(ids, PAD, SOI, EOI)
    with pytest.raises(ValueError, match=repr(route)
                       if route != "dense" else "attn_meta=None"):
        port(input_ids=ids, attn_meta=meta)


def test_route_table_names_the_jax_routes():
    """One table: every port route maps to the JAX impl string phi's
    ``_attention`` / ``_layer`` branch on, and every one is accepted (each
    has its kernel now)."""
    import inspect

    jax_src = inspect.getsource(jphi._attention) + inspect.getsource(
        jphi._layer)
    for route, jax_name in tphi.ATTN_ROUTES.items():
        if jax_name is not None and jax_name != "pallas":
            assert f'"{jax_name}"' in jax_src, jax_name
        assert tphi.check_route(route) == route


def test_init_random_matches_jax_scheme():
    """Seeded init: N(0, 0.02) matmul/embedding weights, zero biases, unit
    norm scales, as JAX init_phi_params; the same seed gives the same
    weights."""
    cfg = tphi.PhiConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                         num_layers=2, num_heads=2)
    a = tphi.Phi(cfg).init_random(torch.Generator().manual_seed(3))
    b = tphi.Phi(cfg).init_random(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        elif "layernorm" in name:
            assert (p == 1).all(), name
    assert abs(a.model.embed_tokens.weight.std().item() - 0.02) < 2e-3
    logits, _ = a(input_ids=torch.zeros((1, 8), dtype=torch.long))
    assert logits.shape == (1, 8, 64)
