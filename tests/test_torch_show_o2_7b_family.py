"""What the Show-o2 7B family (Qwen2.5-7B: 28 q / 4 kv heads of 128, an
untied ``lm_head``) asks of showo_tpu_torch beyond the 1.5B, on the CPU at
tiny widths against the JAX package on the same weights.

The tiny model is tests/test_t2i_v2_pipeline.py's with Qwen2's head
untied (``tie_word_embeddings=False``) and GQA at group 7: 7 q / 1 kv and
14 / 2 heads of 16.  The untied head travels in the reference layout as
``showo.lm_head.weight`` (the JAX exporter writes it with ``tied=False``,
``showo_tpu/utils/torch_export.py:85-86``); ``load_showo2`` refuses a
state dict without it.  Held, fp32:

* the logits and last hidden state, dense and on the packed route (JAX's
  Pallas kernel in interpret mode), fused and not: atol 3e-5 / rtol 1e-4
  (the 1.5B tests' limits, tests/test_torch_show_o2.py);
* ``showo2_t2i_velocity`` with CFG, dense and packed: atol 2e-5 on
  velocities of size ~0.1; the prefix cache's prefill K/V and the cached
  velocity at per-row offsets: atol 1e-4 (tests/test_torch_t2i_v2_cached
  .py's);
* the MMU pipeline's greedy answer (the image scaffold's prefill, then
  the cached decode), token for token under the same VAE draw;
* int8: the untied head quantized bit for bit as JAX's (int8 rows, bf16
  scales, N padded to 16 bytes), and the logits on JAX's int8 params in
  fp32 and bf16 at tests/test_torch_mmu_v2.py's limits (top-1 agreement >=
  0.95, max |diff| / peak <= 1e-2: JAX rounds ``w_i8 * scale`` to bf16,
  the port scales the fp32 sum).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.pipelines import mmu_v2 as jmmu_v2
from showo_tpu.show_o2 import masks as jmasks
from showo_tpu.show_o2 import qwen2 as jqwen2
from showo_tpu.show_o2 import showo2 as jshowo2
from showo_tpu.utils.torch_export import qwen2_state_dict, showo2_state_dict
from showo_tpu_torch import inference_t2i_v2
from showo_tpu_torch.models.phi import Int8Linear
from showo_tpu_torch.pipelines.mmu_v2 import MMUV2Pipeline
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.utils.convert import load_qwen2_int8_params, load_showo2
from test_t2i_v2_pipeline import IDS, VAE_TINY, Tok
from test_torch_mmu_v2 import (INT8_AGREE, INT8_REL, PIXELS, QUESTION,
                               _jax_injected, _port_vae, _vae_params)
from test_torch_show_o2 import (_jax_packed_interpreted, _meta,
                                showo2_params, tiny_showo2_cfgs)
from test_torch_t2i_v2_cached import _jax_cached, _port_cached

torch.set_num_threads(1)

HEADS = [(7, 1), (14, 2)]
HEAD_IDS = ["7_1", "14_2"]
ATOL_LOGITS = dict(atol=3e-5, rtol=1e-4)
ATOL_VELOCITY, ATOL_CACHED = 2e-5, 1e-4
NEW_TOKENS = 8


def _cfgs(H, Hkv):
    """(JAX, port) tiny Show-o2 configs, Qwen2 untied at H / Hkv heads."""
    jcfg, tcfg = tiny_showo2_cfgs()
    kw = dict(num_heads=H, num_kv_heads=Hkv, tie_word_embeddings=False)
    return (dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm,
                                                              **kw)),
            dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm,
                                                              **kw)))


def _state_dict(jcfg, params):
    """The reference-layout state dict of JAX params, the untied head
    included (``showo2_state_dict`` writes Qwen2's tied layout)."""
    n = jcfg.llm.num_layers
    sd = showo2_state_dict(params, n, jcfg.siglip.num_layers,
                           jcfg.dit.num_layers)
    head = "showo.lm_head.weight"
    sd[head] = qwen2_state_dict(params["showo"], n, "showo.",
                                tied=False)[head]
    return sd


@pytest.fixture(scope="module", params=HEADS, ids=HEAD_IDS)
def family(request):
    """(JAX config, port config, JAX params, port model) at one head
    layout; the model unfused, fp32."""
    jcfg, tcfg = _cfgs(*request.param)
    params = showo2_params(jcfg)
    assert "lm_head" in params["showo"]
    model = load_showo2(tshowo2.Showo2(tcfg), _state_dict(jcfg, params))
    return jcfg, tcfg, params, model.eval()


def test_untied_head_is_its_own_weight(family):
    """The port's untied Qwen2 has an ``lm_head`` of JAX's kernel (not the
    embedding), and a state dict without it does not load."""
    jcfg, tcfg, params, model = family
    head = model.showo.lm_head.weight
    np.testing.assert_array_equal(
        head.detach().numpy(),
        np.asarray(params["showo"]["lm_head"]["kernel"]).T)
    assert not torch.equal(head, model.showo.model.embed_tokens.weight)
    sd = _state_dict(jcfg, params)
    del sd["showo.lm_head.weight"]
    with pytest.raises(KeyError, match="lm_head"):
        load_showo2(tshowo2.Showo2(tcfg), sd)


@pytest.mark.parametrize("route", ["dense", "packed"])
@pytest.mark.parametrize("fused", [False, True], ids=["ref", "fused"])
def test_logits_vs_jax(family, route, fused):
    jcfg, _, params, model = family
    qwen, jp = model.showo, jax.tree.map(jnp.asarray, params["showo"])
    if fused:
        jp = jqwen2.fuse_inference(jp)
        qwen = tqwen2.fuse_inference(copy.deepcopy(qwen))
    rng = np.random.default_rng(3)
    B, L = 2, 24
    ids = rng.integers(0, jcfg.llm.vocab_size, size=(B, L))
    mp = np.asarray([[[3, 9]], [[6, 11]]])
    jbias = jmasks.omni_attn_mask(jnp.asarray(mp), L)
    jmeta, tmeta = _meta(mp, L)
    with _jax_packed_interpreted():
        jl, jh, _ = jqwen2.qwen2_forward(
            jcfg.llm, jp, input_ids=jnp.asarray(ids),
            attention_bias=None if route == "packed" else jbias,
            attn_meta=jmeta if route == "packed" else None)
    with torch.no_grad():
        tl, th = qwen(torch.as_tensor(ids),
                      attention_bias=torch.as_tensor(np.array(jbias)),
                      attn_meta=tmeta if route == "packed" else None)
    assert tl.shape == (B, L, jcfg.llm.vocab_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **ATOL_LOGITS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL_LOGITS)


def _velocity_inputs(jcfg):
    rng = np.random.default_rng(1)
    B, L, n = 4, 32, jcfg.num_image_tokens
    text = rng.integers(10, 1000, size=(B, L))
    # cond rows at their prompts' ends, the null rows' spans at 2
    mp = np.asarray([[[5, n]], [[9, n]], [[2, n]], [[2, n]]])
    z = rng.normal(size=(B, 16, 8, 8)).astype(np.float32)
    t = np.asarray([0.37, 0.61, 0.37, 0.61], np.float32)
    return text, mp, z, t


@pytest.fixture(scope="module")
def fused(family):
    """The family's weights fused for inference (JAX params, port model)."""
    jcfg, _, params, model = family
    return (jshowo2.fuse_inference(jax.tree.map(jnp.asarray, params)),
            tshowo2.fuse_inference(copy.deepcopy(model)))


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_velocity_vs_jax(family, fused, route):
    jcfg = family[0]
    jparams, model = fused
    text, mp, z, t = _velocity_inputs(jcfg)
    L = text.shape[1]
    jbias = jmasks.omni_attn_mask(jnp.asarray(mp), L)
    jmeta, tmeta = _meta(mp, L)
    with _jax_packed_interpreted():
        want = jshowo2.showo2_t2i_velocity(
            jcfg, jparams, jnp.asarray(text), jnp.asarray(z), jnp.asarray(t),
            jbias, jnp.asarray(mp), guidance_scale=5.0,
            attn_meta=jmeta if route == "packed" else None)
    with torch.no_grad():
        got = tshowo2.showo2_t2i_velocity(
            model, torch.as_tensor(text), torch.as_tensor(z),
            torch.as_tensor(t),
            None if route == "packed" else torch.as_tensor(np.array(jbias)),
            torch.as_tensor(mp), guidance_scale=5.0,
            attn_meta=tmeta if route == "packed" else None)
    assert got.shape == (4, 16, 8, 8)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_VELOCITY, rtol=0)


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_prefill_and_cached_velocity_vs_jax(family, fused, route):
    """The prefix cache (prefill of both towers, then the span rows at
    per-row offsets): the prefill's Qwen and DiT K/V [L, B, S, Hkv, Dh]
    and the cached CFG velocity against JAX's."""
    jcfg = family[0]
    jparams, model = fused
    text, mp, z, t = _velocity_inputs(jcfg)
    jq, jd, want = _jax_cached(jcfg, jparams, text, mp, z, t, route, 5.0)
    tq, td, got = _port_cached(model, text, mp, z, t, route, 5.0)
    assert tq[0].shape == (2, 4, 32, jcfg.llm.num_kv_heads, 16)
    for a, b in ((tq[0], jq[0]), (tq[1], jq[1]), (td[0], jd[0]),
                 (td[1], jd[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL_CACHED)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_CACHED)


def test_mmu_greedy_answer_token_exact_vs_jax(family):
    """MMUV2Pipeline.answer (VAE encode, SigLIP, the scaffold's prefill,
    the greedy decode over the cache; fused weights) on the untied group-7
    model: JAX's tokens exactly, under the same VAE draw."""
    jcfg, tcfg, params, model = family
    vae_params = _vae_params(VAE_TINY)
    kw = dict(max_new_tokens=NEW_TOKENS, fuse_weights=True, top_k=1)
    jpipe = jmmu_v2.MMUV2Pipeline(
        cfg=jcfg, params=jax.tree.map(jnp.asarray, params), vae_cfg=VAE_TINY,
        vae_params=jax.tree.map(jnp.asarray, vae_params), tokenizer=Tok(),
        token_ids=IDS, **kw)
    tpipe = MMUV2Pipeline(model=copy.deepcopy(model),
                          vae=_port_vae(VAE_TINY, vae_params),
                          tokenizer=inference_t2i_v2.FakeQwenTokenizer(),
                          token_ids=inference_t2i_v2.FAKE_TOKEN_IDS, **kw)
    rng = np.random.default_rng(8)
    image = rng.uniform(-1, 1, (PIXELS, PIXELS, 3)).astype(np.float32)
    eps = rng.normal(size=(1, 16, 1, 8, 8)).astype(np.float32)
    gumbel = np.zeros((NEW_TOKENS + 1, 1, jcfg.llm.vocab_size), np.float32)
    with _jax_injected(eps, gumbel):
        want = jpipe.answer(image, QUESTION, jax.random.PRNGKey(0))
    got = tpipe.answer(image, QUESTION, injected_gumbel=gumbel,
                       injected_eps=eps)
    assert got == want and len(got) > 0


def _int8_pair(family, dtype):
    """(JAX int8 Qwen2 params, the port's Qwen2 fused, quantized and
    loaded with them) in ``dtype``."""
    jcfg, _, params, model = family
    jp = jqwen2.fuse_inference(jax.tree.map(
        lambda x: jnp.asarray(x, getattr(jnp, dtype)), params["showo"]))
    qwen = tqwen2.fuse_inference(copy.deepcopy(model.showo).to(getattr(torch,
                                                               dtype)))
    jq = jqwen2.quantize_int8(jp)
    return jq, qwen


def test_untied_int8_head_bit_exact_vs_jax(family):
    """``quantize_int8`` turns the untied head itself (not the embedding)
    into an Int8Linear with JAX's int8 rows and bf16 scales bit for bit,
    its N padded to a multiple of 16 bytes; the embedding stays."""
    jq, qwen = _int8_pair(family, "float32")
    embed = qwen.model.embed_tokens.weight.clone()
    tqwen2.quantize_int8(qwen)
    head = qwen.lm_head
    assert isinstance(head, Int8Linear)
    np.testing.assert_array_equal(head.kernel_i8.numpy(),
                                  np.asarray(jq["lm_head"]["kernel_i8"]))
    np.testing.assert_array_equal(
        head.scale.float().numpy(),
        np.asarray(jq["lm_head"]["scale"].astype(jnp.float32)))
    assert head.w_i8.shape[1] % 16 == 0
    assert torch.equal(qwen.model.embed_tokens.weight, embed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_vs_jax(family, dtype):
    """The port's int8 Qwen2 on JAX's int8 params (``load_qwen2_int8_params``
    copies the untied head's) against JAX ``qwen2_forward`` on them."""
    jq, qwen = _int8_pair(family, dtype)
    load_qwen2_int8_params(tqwen2.quantize_int8(qwen), jq)
    jcfg = family[0]
    ids = np.random.default_rng(6).integers(0, jcfg.llm.vocab_size, (2, 16))
    want, _, _ = jqwen2.qwen2_forward(jcfg.llm, jq,
                                      input_ids=jnp.asarray(ids))
    with torch.no_grad():
        got, _ = qwen(input_ids=torch.as_tensor(ids))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    agree = (want.argmax(-1) == got.argmax(-1)).mean()
    rel = np.abs(want - got).max() / np.abs(want).max()
    assert agree >= INT8_AGREE, agree
    assert rel <= INT8_REL, rel
