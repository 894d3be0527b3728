"""The Show-o2 modules of showo_tpu_torch against the JAX package and the
reference goldens, on the CPU, fp32.

* Masks and metadata bit-exact: ``omni_attn_mask`` and
  ``modality_scatter`` against tests/golden/showo2_masks.npz and JAX,
  ``modality_gather`` against JAX.
* Qwen2 logits and last hidden state on the ``dense`` and ``packed``
  routes, against tests/golden/qwen2_tiny.npz (the reference) and the JAX
  forward (its Pallas kernel in interpret mode), atol 3e-5 / rtol 1e-4
  (the JAX test's tolerance against the same golden).
* The DiT stack and FinalLayer on both routes and the TimestepEmbedder
  against tests/golden/dit_tiny.npz (two spans per row), atol 5e-5 / rtol
  1e-4; ``llama3_rope_tables`` against JAX at the released head dim,
  atol 1e-6.
* The Wan2.1 decoder against tests/golden/wanvae_tiny.npz (an image and a
  9-frame clip, the time upsample path), atol 1e-4 / rtol 1e-3 (the JAX
  test's); the weight exporter's round trip through
  ``wan_vae_params_from_torch``, exact.
* ``ode_timegrid`` against tests/golden/transport.npz and JAX; Euler,
  Heun, DPM-Solver++ and dopri5 against JAX on a nonlinear field (more in
  tests/test_torch_transport.py).
* ``showo2_t2i_velocity`` with CFG on both routes against JAX, weights
  carried by ``showo2_state_dict``: atol 2e-5 on velocities of size ~0.1
  (fp32 end to end; the two frameworks sum in other orders).
"""

import copy
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.ops import flash_attention as jfa
from showo_tpu.ops.masks import to_additive as jto_additive
from showo_tpu.show_o2 import dit as jdit
from showo_tpu.show_o2 import masks as jmasks
from showo_tpu.show_o2 import qwen2 as jqwen2
from showo_tpu.show_o2 import showo2 as jshowo2
from showo_tpu.show_o2 import transport as jtransport
from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu.utils.torch_export import showo2_state_dict
from showo_tpu.utils.torch_import import (dit_params_from_torch,
                                          final_layer_params_from_torch,
                                          qwen2_params_from_torch,
                                          wan_vae_params_from_torch)
from showo_tpu_torch.show_o2 import dit as tdit
from showo_tpu_torch.show_o2 import masks as tmasks
from showo_tpu_torch.show_o2 import qwen2 as tqwen2
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.show_o2 import transport as ttransport
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.show_o2.siglip import SigLipConfig
from test_t2i_v2_pipeline import TINY as JTINY
from showo_tpu_torch.utils.convert import (load_showo2, load_wan_vae,
                                           wan_vae_state_dict)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def _weights(golden, prefix=""):
    return {k[3 + len(prefix):]: golden[k] for k in golden.files
            if k.startswith("w::" + prefix)}


def _jax_packed_interpreted():
    """The JAX packed kernel in interpret mode (tests/test_dit.py)."""
    orig = jfa.omni_attention_packed

    def interp(*args, **kw):
        kw["interpret"] = True
        kw.setdefault("block_q", 8)
        return orig(*args, **kw)

    return mock.patch.object(jfa, "omni_attention_packed", interp)


def _meta(mp, L):
    """(JAX, port) attention metadata of the v2 layout for spans mp."""
    B = mp.shape[0]
    seg = jfa.seg_from_modality_positions(jnp.asarray(mp), L)
    j = ("pallas_packed", seg, jnp.zeros((B, L), jnp.int32),
         jnp.full((B,), -1, jnp.int32), jnp.zeros((B,), jnp.int32))
    t = ("packed",) + tuple(torch.as_tensor(np.array(m)) for m in j[1:])
    return j, t


# -- masks ------------------------------------------------------------------

def test_masks_match_golden_and_jax():
    g = _golden("showo2_masks")
    mp = g["modality_positions"]
    got = tmasks.omni_attn_mask(torch.as_tensor(mp), 24, inverted=False)
    np.testing.assert_array_equal(got[:, :].numpy(), g["mask"].astype(bool))
    bias = tmasks.omni_attn_mask(torch.as_tensor(mp), 24)
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(jmasks.omni_attn_mask(jnp.asarray(mp), 24)))
    args = [g[k] for k in ("input_embeds", "image_embeds", "time_embeds")]
    out = tmasks.modality_scatter(*map(torch.as_tensor, args),
                                  torch.as_tensor(mp))
    np.testing.assert_array_equal(out.numpy(), g["scattered"])
    want = jmasks.modality_scatter(*map(jnp.asarray, args), jnp.asarray(mp))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    for n in (5, 9):
        np.testing.assert_array_equal(
            tmasks.modality_gather(out, torch.as_tensor(mp), n).numpy(),
            np.asarray(jmasks.modality_gather(want, jnp.asarray(mp), n)))


# -- Qwen2 ------------------------------------------------------------------

QWEN_TINY = dict(vocab_size=160, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)


@pytest.fixture(scope="module")
def qwen():
    g = _golden("qwen2_tiny")
    model = tqwen2.Qwen2(tqwen2.Qwen2Config(**QWEN_TINY))
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in _weights(g).items()})
    params = jax.tree.map(jnp.asarray,
                          qwen2_params_from_torch(_weights(g), num_layers=2))
    return g, model.eval(), params


def test_qwen2_dense_vs_golden(qwen):
    g, model, _ = qwen
    bias = torch.where(torch.as_tensor(g["mask"]).bool(), 0.0, -1e9)
    with torch.no_grad():
        logits, hidden = model(torch.as_tensor(g["ids"]),
                               attention_bias=bias)
    np.testing.assert_allclose(hidden.numpy(), g["last_hidden"], atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), g["logits"], atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("route", ["dense", "packed"])
@pytest.mark.parametrize("fused", [False, True], ids=["ref", "fused"])
def test_qwen2_routes_vs_jax(qwen, route, fused):
    g, model, params = qwen
    ids = g["ids"]
    B, L = ids.shape
    mp = np.asarray([[[3, 9]], [[6, 11]]])
    jbias = jmasks.omni_attn_mask(jnp.asarray(mp), L)
    jmeta, tmeta = _meta(mp, L)
    if fused:
        params = jqwen2.fuse_inference(params)
        model = tqwen2.fuse_inference(copy.deepcopy(model))
    with _jax_packed_interpreted():
        jl, jh, _ = jqwen2.qwen2_forward(
            jqwen2.Qwen2Config(**QWEN_TINY), params,
            input_ids=jnp.asarray(ids),
            attention_bias=None if route == "packed" else jbias,
            attn_meta=jmeta if route == "packed" else None)
    with torch.no_grad():
        tl, th = model(torch.as_tensor(ids),
                       attention_bias=torch.as_tensor(np.array(jbias)),
                       attn_meta=tmeta if route == "packed" else None)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-5,
                               rtol=1e-4)


# -- DiT head -----------------------------------------------------------------

DIT_TINY = dict(hidden_size=64, intermediate_size=128, num_heads=4,
                num_kv_heads=2, head_dim=16, num_layers=2)


@pytest.fixture(scope="module")
def dit():
    g = _golden("dit_tiny")
    cfg = tdit.DiffusionHeadConfig(**DIT_TINY)
    layers = torch.nn.ModuleList(tdit.ModulatedAttentionBlock(cfg)
                                 for _ in range(2))
    layers.load_state_dict({k: torch.as_tensor(v) for k, v in
                            _weights(g, "blocks.").items()})
    final = tdit.FinalLayer(64, 2, 4)
    final.load_state_dict({k: torch.as_tensor(v) for k, v in
                           _weights(g, "final.").items()})
    temb = tdit.TimestepEmbedder(64)
    temb.load_state_dict({k: torch.as_tensor(v) for k, v in
                          _weights(g, "temb.").items()})
    return g, cfg, layers.eval(), final.eval(), temb.eval()


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_dit_vs_golden_and_jax(dit, route):
    g, cfg, layers, final, temb = dit
    x, ada, mp = (torch.as_tensor(g[k]) for k in
                  ("x", "adaln", "modality_positions"))
    B, L = x.shape[:2]
    bias = torch.where(torch.as_tensor(g["mask"]).bool(), 0.0, -1e9)
    _, tmeta = _meta(g["modality_positions"], L)
    with torch.no_grad():
        np.testing.assert_allclose(
            temb(torch.as_tensor(g["t"])).numpy(), g["adaln"], atol=2e-5,
            rtol=1e-4)
        h = tdit.dit_forward(cfg, layers, x, ada,
                             None if route == "packed" else bias, mp,
                             tqwen2.packed_meta(tmeta)
                             if route == "packed" else None)
        v = final(h, ada, mp)
    np.testing.assert_allclose(h.numpy(), g["h_out"], atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(v.numpy(), g["v_out"], atol=5e-5, rtol=1e-4)
    # the JAX head on the same weights (its kernel interpreted)
    sd = _weights(g)
    jp = jax.tree.map(jnp.asarray, dit_params_from_torch(sd, 2, "blocks."))
    jmeta, _ = _meta(g["modality_positions"], L)
    with _jax_packed_interpreted():
        jh = jdit.dit_forward(
            jdit.DiffusionHeadConfig(**DIT_TINY), jp, jnp.asarray(g["x"]),
            jnp.asarray(g["adaln"]),
            None if route == "packed" else jto_additive(
                jnp.asarray(g["mask"])),
            jnp.asarray(g["modality_positions"]),
            attn_meta=jmeta if route == "packed" else None)
    jv = jdit.final_layer_apply(
        jax.tree.map(jnp.asarray, final_layer_params_from_torch(sd, "final.")),
        jh, jnp.asarray(g["adaln"]), jnp.asarray(g["modality_positions"]))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=5e-5,
                               rtol=1e-4)


def test_dit_fused_and_single_span_paths(dit):
    """The fused layout and the one-span / full-span modulation paths give
    the head's function (the fast paths of JAX span_modulation)."""
    g, cfg, layers, final, _ = dit
    rng = np.random.default_rng(0)
    B, L = 2, 16
    x = torch.as_tensor(rng.normal(size=(B, L, 64)).astype(np.float32))
    ada = torch.as_tensor(rng.normal(size=(B, 64)).astype(np.float32))
    fused = copy.deepcopy(layers)
    tdit.fuse_inference(fused)
    assert hasattr(fused[0].self_attn, "qkv") and hasattr(fused[0].mlp, "gu")
    jp = jax.tree.map(jnp.asarray,
                      dit_params_from_torch(_weights(g), 2, "blocks."))
    jcfg = jdit.DiffusionHeadConfig(**DIT_TINY)
    for mp, full in (([[[3, 9]], [[0, 5]]], False), ([[[0, L]]] * B, True)):
        tmp = torch.as_tensor(mp)
        with torch.no_grad():
            ref = tdit.dit_forward(cfg, layers, x, ada, None, tmp)
            got = tdit.dit_forward(cfg, fused, x, ada, None, tmp,
                                   full_span=full)
        want = jdit.dit_forward(jcfg, jp, jnp.asarray(x.numpy()),
                                jnp.asarray(ada.numpy()), None,
                                jnp.asarray(mp), full_span=full)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4)


def test_llama3_rope_tables_vs_jax():
    pos = np.arange(40)[None]
    cfg = tdit.DiffusionHeadConfig()
    cos, sin = tdit.llama3_rope_tables(torch.as_tensor(pos), cfg)
    jcos, jsin = jdit.llama3_rope_tables(jnp.asarray(pos),
                                         jdit.DiffusionHeadConfig())
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


# -- Wan2.1 VAE decoder --------------------------------------------------------

WAN_TINY = dict(dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                temperal_downsample=(True,))


@pytest.mark.parametrize("clip", ["i", "v"], ids=["image", "video"])
def test_wan_decoder_vs_golden(clip):
    g = _golden("wanvae_tiny")
    vae = load_wan_vae(twan.WanVAE(twan.WanVAEConfig(**WAN_TINY)),
                       _weights(g)).eval()
    with torch.no_grad():
        out = twan.wan_decode_raw(vae, torch.as_tensor(g[f"mu_{clip}"]))
    assert out.shape == g[f"recon_{clip}"].shape
    np.testing.assert_allclose(out.numpy(), g[f"recon_{clip}"], atol=1e-4,
                               rtol=1e-3)


def test_wan_exporter_round_trip_and_decode_vs_jax():
    """wan_vae_state_dict inverts wan_vae_params_from_torch exactly, and
    the port decodes the exported weights as JAX ``wan_decode`` does
    (scale-normalised latents, clamp), atol 1e-4 / rtol 1e-3."""
    cfg = jwan.WanVAEConfig(dim=16, z_dim=16, dim_mult=(1, 2),
                            num_res_blocks=1, temperal_downsample=(True,))
    params = jwan.init_wan_vae_params(cfg, jax.random.PRNGKey(1))
    # the zero-init attention projection would hide the attention block
    params["decoder"]["mid_attn"]["proj"]["kernel"] = jax.random.normal(
        jax.random.PRNGKey(2),
        params["decoder"]["mid_attn"]["proj"]["kernel"].shape) * 0.1
    tcfg = twan.WanVAEConfig(**dict(WAN_TINY, z_dim=16))
    sd = wan_vae_state_dict(params, tcfg)
    back = wan_vae_params_from_torch(sd, cfg)
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(np.asarray(a), b)
    vae = load_wan_vae(twan.WanVAE(tcfg), sd).eval()
    z = np.random.default_rng(3).normal(size=(2, 16, 1, 4, 4)).astype(
        np.float32)
    want = jwan.wan_decode(cfg, params, jnp.asarray(z))
    with torch.no_grad():
        got = twan.wan_decode(vae, torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


# -- transport ------------------------------------------------------------------

def test_timegrid_vs_golden_and_jax():
    g = _golden("transport")
    np.testing.assert_allclose(
        ttransport.ode_timegrid(9, time_shifting_factor=3.0).numpy(),
        g["tgrid_warp3"], atol=1e-6)
    np.testing.assert_allclose(
        ttransport.ode_timegrid(9, do_shift=True, seq_len=729).numpy(),
        g["tgrid_shift729"], atol=1e-5)
    # a few fp32 ulps: XLA may fuse the warp's multiply and subtract
    np.testing.assert_allclose(
        ttransport.ode_timegrid(50, time_shifting_factor=3.0).numpy(),
        np.asarray(jtransport.ode_timegrid(50, time_shifting_factor=3.0)),
        atol=1e-6, rtol=0)


def test_euler_vs_jax():
    x = np.random.default_rng(0).normal(size=(3, 4, 5)).astype(np.float32)
    grid = ttransport.ode_timegrid(11, time_shifting_factor=3.0)
    jgrid = jtransport.ode_timegrid(11, time_shifting_factor=3.0)
    got = ttransport.sample_ode_euler(
        lambda x, t: torch.sin(x) * t[:, None, None] - x, torch.as_tensor(x),
        grid)
    want = jtransport.sample_ode_euler(
        lambda x, t: jnp.sin(x) * t[:, None, None] - x, jnp.asarray(x), jgrid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("method", ["heun", "dpm-solver", "dopri5"])
def test_other_solvers_raise(method):
    """The JAX package's other ODE samplers are ported: each is a
    ``sampling_method`` the pipeline takes and matches JAX on a nonlinear
    field (on JAX's own time grid); an unknown name still raises."""
    assert ttransport.check_sampler(method) == method
    with pytest.raises(ValueError, match="unknown"):
        ttransport.check_sampler("rk4")
    x = np.random.default_rng(1).normal(size=(3, 4, 5)).astype(np.float32)
    jgrid = jtransport.ode_timegrid(11, time_shifting_factor=3.0)
    got = ttransport.sample(
        method, lambda x, t: torch.sin(x) * t[:, None, None] - x,
        torch.as_tensor(x), torch.as_tensor(np.asarray(jgrid)))
    jfn = {"heun": lambda d, x: jtransport.sample_ode_heun(d, x, jgrid),
           "dpm-solver": lambda d, x: jtransport.sample_dpm_solver_pp(
               d, x, jgrid),
           "dopri5": jtransport.sample_ode_dopri5}[method]
    want = jfn(lambda x, t: jnp.sin(x) * t[:, None, None] - x, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- the whole model's velocity -------------------------------------------------

def tiny_showo2_cfgs():
    """(JAX, port) Show-o2 configs at the sizes of
    tests/test_t2i_v2_pipeline.py::TINY."""
    t = tshowo2.Showo2Config(
        llm=tqwen2.Qwen2Config(**{f: getattr(JTINY.llm, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "head_dim")}),
        siglip=SigLipConfig(**{f: getattr(JTINY.siglip, f) for f in (
            "hidden_size", "intermediate_size", "num_heads", "num_layers",
            "num_positions")}),
        dit=tdit.DiffusionHeadConfig(**{f: getattr(JTINY.dit, f) for f in (
            "hidden_size", "intermediate_size", "num_heads", "num_kv_heads",
            "head_dim", "num_layers")}),
        image_latent_dim=16, image_latent_height=8, image_latent_width=8,
        patch_size=2, clip_latent_dim=48)
    return JTINY, t


def showo2_params(jcfg, seed=0):
    """JAX Show-o2 params (fp32) with the zero-init adaLN projections and
    FinalLayer drawn N(0, 0.02), so the velocity depends on the weights."""
    params = jax.tree.map(np.asarray,
                          jshowo2.init_showo2_params(jcfg,
                                                     jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for node in (params["diffusion_head_a"]["layers"]["adaln"],
                 params["diffusion_head_b"]["adaln"],
                 params["diffusion_head_b"]["linear"]):
        node["kernel"] = (rng.normal(size=node["kernel"].shape) * 0.02
                          ).astype(np.float32)
        node["bias"] = (rng.normal(size=node["bias"].shape) * 0.02
                        ).astype(np.float32)
    return params


def port_showo2(tcfg, jcfg, params):
    sd = showo2_state_dict(params, jcfg.llm.num_layers,
                           jcfg.siglip.num_layers, jcfg.dit.num_layers)
    return load_showo2(tshowo2.Showo2(tcfg), sd).eval()


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_velocity_vs_jax(route):
    jcfg, tcfg = tiny_showo2_cfgs()
    params = showo2_params(jcfg)
    model = port_showo2(tcfg, jcfg, params)
    tshowo2.fuse_inference(model)
    rng = np.random.default_rng(1)
    B, L, n = 4, 32, jcfg.num_image_tokens
    text = rng.integers(10, 1000, size=(B, L))
    mp = np.asarray([[[5, n]], [[9, n]], [[2, n]], [[2, n]]])
    z = rng.normal(size=(B, 16, 8, 8)).astype(np.float32)
    t = np.full((B,), 0.37, np.float32)
    jbias = jmasks.omni_attn_mask(jnp.asarray(mp), L)
    jmeta, tmeta = _meta(mp, L)
    with _jax_packed_interpreted():
        want = jshowo2.showo2_t2i_velocity(
            jcfg, jshowo2.fuse_inference(jax.tree.map(jnp.asarray, params)),
            jnp.asarray(text), jnp.asarray(z), jnp.asarray(t), jbias,
            jnp.asarray(mp), guidance_scale=5.0,
            attn_meta=jmeta if route == "packed" else None)
    with torch.no_grad():
        got = tshowo2.showo2_t2i_velocity(
            model, torch.as_tensor(text), torch.as_tensor(z),
            torch.as_tensor(t),
            None if route == "packed" else torch.as_tensor(np.array(jbias)),
            torch.as_tensor(mp), guidance_scale=5.0,
            attn_meta=tmeta if route == "packed" else None)
    assert got.shape == (B, 16, 8, 8)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
