"""Show-o2 training in showo_tpu_torch against the JAX package, fp32 on the
CPU.

* The transport: every ``compute_*`` of ICPlan / VPCPlan / GVPCPlan and
  ``plan`` at rtol 1e-6; ``sample_t`` under uniform, uniform_a_b and
  lognorm, with and without ``max_t0`` / ``do_shift``, on JAX's own draws
  (rtol 1e-6); ``sample`` and ``training_losses``; the SDE samplers and
  the likelihood ODE on an analytic drift with JAX's draws handed in
  (rtol 1e-5).
* ``patchify_labels`` (image and video), ``next_token_prediction_loss``
  and ``velocity_prediction_loss`` against JAX, rtol 1e-5.
* One stage-1 step against JAX's ``make_stage1_step`` on a two-layer model
  whose Qwen heads are 128 wide (so the trainable route meets kernels 7 /
  8 at head dim 128; here their plain versions, JAX's Pallas kernels in
  interpret mode), on ``dense`` and ``trainable``, for an image batch, a
  video batch and a batch of one t2i and one und sample at ``und_max_t0``
  1.0 with the stage-1a frozen substrings: the VAE's posterior noise, t
  and x0 are JAX's draws.  loss / loss_ntp / loss_flow at rtol 2e-4, the
  grad norm at rtol 2e-3 (without frozen parameters; the port's covers
  the trainable ones, JAX's every one), the updated weights at atol 1e-5
  (the v1 precedent, tests/test_torch_training.py); frozen tensors bit for
  bit unchanged.  The same image step under adafactor + remat
  ``qkv_fc1_attn`` and under adamw_bf16 + ``full``, the port's optimizer
  on the JAX package's tensors.
* Stage 2: ``param_groups`` name for name against JAX's labels, and one
  step moving each group by its own learning rate (the weights after the
  step against JAX's at atol 1e-5).
* The checkpoint ring and its weights-only fallback.
* Both CLIs end to end on a tiny jsonl, with ``save_every`` and a second
  run resuming from ``latest`` at the saved step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.show_o2 import showo2 as jshowo2
from showo_tpu.show_o2 import transport as jtr
from showo_tpu.show_o2.formats import (format_sequence_gen_qwen2_5,
                                       format_sequence_und)
from showo_tpu.show_o2.train_stage_one import Stage1Config as JStage1Config
from showo_tpu.show_o2.train_stage_one import (make_stage1_optimizer,
                                               make_stage1_step)
from showo_tpu.show_o2.train_stage_two import Stage2Config as JStage2Config
from showo_tpu.show_o2.train_stage_two import make_stage2_optimizer
from showo_tpu.show_o2.train_stage_two import param_groups as jparam_groups
from showo_tpu.utils.torch_export import showo2_state_dict
from showo_tpu_torch.show_o2 import showo2 as tshowo2
from showo_tpu_torch.show_o2 import transport as ttr
from showo_tpu_torch.show_o2 import train_stage_one as t1
from showo_tpu_torch.show_o2 import train_stage_two as t2
from showo_tpu_torch.show_o2 import wan_vae as twan
from showo_tpu_torch.utils.convert import load_showo2

from test_t2i_v2_pipeline import VAE_TINY
from test_torch_mmu_v2 import _port_vae, _vae_params
from test_torch_show_o2 import showo2_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL6 = dict(rtol=1e-6, atol=1e-7)

# -- the transport -------------------------------------------------------------

PLANS = [("ICPlan", {}), ("VPCPlan", {}), ("GVPCPlan", {})]


@pytest.mark.parametrize("name,kw", PLANS)
def test_plans_vs_jax(name, kw):
    rng = np.random.default_rng(0)
    t = rng.uniform(0.05, 0.95, size=5).astype(np.float32)
    x0, x1, v = (rng.normal(size=(5, 3, 4, 4)).astype(np.float32)
                 for _ in range(3))
    jp, tp = getattr(jtr, name)(**kw), getattr(ttr, name)(**kw)
    jt, tt = jnp.asarray(t), torch.as_tensor(t)
    T = lambda a: torch.as_tensor(a)  # noqa: E731

    def same(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       **RTOL6)

    for fn in ("compute_alpha_t", "compute_sigma_t",
               "compute_d_alpha_alpha_ratio_t"):
        same(getattr(tp, fn)(tt), getattr(jp, fn)(jt))
    same(tp.compute_drift(T(x1), tt), jp.compute_drift(jnp.asarray(x1), jt))
    for form in ("constant", "SBDM", "sigma", "linear", "decreasing",
                 "increasing-decreasing"):
        same(tp.compute_diffusion(T(x1), tt, form, 0.7),
             jp.compute_diffusion(jnp.asarray(x1), jt, form, 0.7))
    for fn in ("get_score_from_velocity", "get_noise_from_velocity"):
        same(getattr(tp, fn)(T(v), T(x1), tt),
             getattr(jp, fn)(jnp.asarray(v), jnp.asarray(x1), jt))
    same(tp.compute_mu_t(tt, T(x0), T(x1)),
         jp.compute_mu_t(jt, jnp.asarray(x0), jnp.asarray(x1)))
    same(tp.plan(tt, T(x0), T(x1)),
         jp.plan(jt, jnp.asarray(x0), jnp.asarray(x1)))


@pytest.mark.parametrize("snr", ["uniform", "uniform_0.2_0.8", "lognorm"])
@pytest.mark.parametrize("max_t0", [None, 0.9])
@pytest.mark.parametrize("do_shift", [False, True])
def test_sample_t_vs_jax(snr, max_t0, do_shift):
    key = jax.random.PRNGKey(3)
    jt = jtr.Transport(snr_type=snr, do_shift=do_shift, seq_len=730)
    want = jt.sample_t(key, 6, max_t0=max_t0)
    draw = (jax.random.normal(key, (6,)) if snr == "lognorm"
            else jax.random.uniform(key, (6,)))
    tt = ttr.create_transport(snr_type=snr, do_shift=do_shift, seq_len=730)
    got = tt.sample_t(6, max_t0=max_t0, draw=np.asarray(draw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL6)
    # from a generator: the range of the draw
    g = tt.sample_t(64, torch.Generator().manual_seed(0), max_t0=max_t0)
    assert g.shape == (64,) and (g >= 0).all() and (g <= 1).all()


def test_sample_and_training_losses_vs_jax():
    key = jax.random.PRNGKey(5)
    x1 = np.random.default_rng(1).normal(size=(3, 4, 2, 2)).astype(np.float32)
    jt = jtr.Transport(snr_type="lognorm", do_shift=True, seq_len=100)
    t, x0, xt, ut = jt.sample(key, jnp.asarray(x1), max_t0=0.5)
    k_t, _ = jax.random.split(key)
    tt = ttr.Transport(snr_type="lognorm", do_shift=True, seq_len=100)
    got = tt.sample(torch.as_tensor(x1), max_t0=0.5,
                    draw=np.asarray(jax.random.normal(k_t, (3,))),
                    x0=torch.as_tensor(np.asarray(x0)))
    for g, w in zip(got, (t, x0, xt, ut)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **RTOL6)
    v = np.random.default_rng(2).normal(size=x1.shape).astype(np.float32)
    np.testing.assert_allclose(
        tt.training_losses(torch.as_tensor(v), got[3]).numpy(),
        np.asarray(jt.training_losses(jnp.asarray(v), ut)), rtol=1e-6)


def _jax_step_draws(key, steps, shape, rademacher=False):
    """The per-step draws of JAX's SDE / likelihood scans from ``key``."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.asarray(
            jax.random.rademacher(k, shape, dtype=jnp.float32) if rademacher
            else jax.random.normal(k, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("sampler", ["sample_sde_euler_maruyama",
                                     "sample_sde_heun"])
def test_sde_samplers_vs_jax(sampler):
    x = np.random.default_rng(4).normal(size=(2, 3, 4)).astype(np.float32)
    grid = np.linspace(0.0, 0.9, 7).astype(np.float32)
    key = jax.random.PRNGKey(8)

    def jdrift(x, t):
        return jnp.sin(x) * t[:, None, None] - 0.5 * x

    def jdiff(x, t):
        return 0.1 * (1 - t)[:, None, None] * jnp.ones_like(x)

    want = getattr(jtr, sampler)(jdrift, jdiff, jnp.asarray(x),
                                 jnp.asarray(grid), key)
    noise = _jax_step_draws(key, len(grid) - 1, x.shape)
    got = getattr(ttr, sampler)(
        lambda x, t: torch.sin(x) * t[:, None, None] - 0.5 * x,
        lambda x, t: 0.1 * (1 - t)[:, None, None] * torch.ones_like(x),
        torch.as_tensor(x), torch.as_tensor(grid), noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_likelihood_vs_jax():
    x = np.random.default_rng(6).normal(size=(2, 3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    W = np.random.default_rng(7).normal(size=(4, 4)).astype(np.float32) * 0.3

    def jdrift(x, t):
        return jnp.tanh(x @ jnp.asarray(W)) * (1 + t[:, None, None])

    logp, z = jtr.sample_ode_likelihood(jdrift, jnp.asarray(x), key,
                                        num_steps=8)
    probes = _jax_step_draws(key, 8, x.shape, rademacher=True)
    got_logp, got_z = ttr.sample_ode_likelihood(
        lambda x, t: torch.tanh(x @ torch.as_tensor(W))
        * (1 + t[:, None, None]), torch.as_tensor(x), num_steps=8,
        probes=probes)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(logp),
                               rtol=1e-5)
    np.testing.assert_allclose(ttr.prior_logp(torch.as_tensor(x)).numpy(),
                               np.asarray(jtr.prior_logp(jnp.asarray(x))),
                               rtol=1e-6)


# -- losses and labels ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (2, 16, 3, 8, 8)])
def test_patchify_labels_vs_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jcfg = jshowo2.Showo2Config()
    got = tshowo2.patchify_labels(tshowo2.Showo2Config(), torch.as_tensor(x))
    want = jshowo2.patchify_labels(jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    h_, w_ = shape[-2] // 2, shape[-1] // 2
    back = tshowo2.unpatchify_v(tshowo2.Showo2Config(), got, h_, w_,
                                T=shape[2] if len(shape) == 5 else 0)
    np.testing.assert_array_equal(back.numpy(), x)


def test_losses_vs_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 9, 30)).astype(np.float32)
    labels = rng.integers(0, 30, size=(2, 9))
    labels[0, :4] = -100
    got = tshowo2.next_token_prediction_loss(torch.as_tensor(logits),
                                             torch.as_tensor(labels))
    want = jshowo2.next_token_prediction_loss(jnp.asarray(logits),
                                              jnp.asarray(labels), 30)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    v, lab = (rng.normal(size=(2, 9, 12)).astype(np.float32)
              for _ in range(2))
    mask = (rng.uniform(size=(2, 9)) > 0.4).astype(np.int32)
    got = tshowo2.velocity_prediction_loss(*map(torch.as_tensor,
                                                (v, lab, mask)))
    want = jshowo2.velocity_prediction_loss(*map(jnp.asarray,
                                                 (v, lab, mask)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    zero = tshowo2.velocity_prediction_loss(torch.as_tensor(v),
                                            torch.as_tensor(lab),
                                            torch.zeros((2, 9)))
    assert zero.item() == 0.0


# -- one stage-1 step ----------------------------------------------------------

IDS = dict(bos_id=1, eos_id=2, boi_id=3, eoi_id=4, pad_id=5, img_pad_id=6)
STAGE1A_FROZEN = ("und_trans", "image_embedder_und", "position_embedding")
JAX_FROZEN = {"position_embedding": "pos_embed"}


def tiny_cfgs():
    """(JAX, port) Show-o2 configs of two layers a tower, Qwen's 4 q / 2 kv
    heads 128 wide, the DiT's 4 / 2 of 24, 8 x 8 latents."""
    from showo_tpu.show_o2.dit import DiffusionHeadConfig as JD
    from showo_tpu.show_o2.qwen2 import Qwen2Config as JQ
    from showo_tpu.show_o2.siglip import SigLipConfig as JS
    from showo_tpu_torch.show_o2.dit import DiffusionHeadConfig as TD
    from showo_tpu_torch.show_o2.qwen2 import Qwen2Config as TQ
    from showo_tpu_torch.show_o2.siglip import SigLipConfig as TS

    llm = dict(vocab_size=200, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128)
    sig = dict(hidden_size=48, intermediate_size=96, num_heads=4,
               num_layers=2, num_positions=16)
    dit = dict(hidden_size=96, intermediate_size=192, num_heads=4,
               num_kv_heads=2, head_dim=24, num_layers=2)
    rest = dict(image_latent_dim=16, image_latent_height=8,
                image_latent_width=8, patch_size=2, clip_latent_dim=48)
    return (jshowo2.Showo2Config(llm=JQ(**llm), siglip=JS(**sig),
                                 dit=JD(**dit), **rest),
            tshowo2.Showo2Config(llm=TQ(**llm), siglip=TS(**sig),
                                 dit=TD(**dit), **rest))


def _batch(kind, seed=0):
    """Host arrays of one batch of two samples: ``image`` (t2i, 16 x 16
    pixels), ``video`` (t2i, 5 frames: 3 latent frames a span) or ``und``
    (a t2i and an und sample)."""
    rng = np.random.default_rng(seed)
    T = 5 if kind == "video" else 1
    n_img = 16 * (3 if kind == "video" else 1) + 1
    L = 40 + n_img
    rows = []
    for i in range(2):
        fmt = (format_sequence_und if kind == "und" and i == 1
               else format_sequence_gen_qwen2_5)
        rows.append(fmt(list(rng.integers(10, 190, size=6)),
                        num_image_tokens=n_img, max_seq_len=L, **IDS))
    tt, tl, mp, tm, im = (np.stack(c) for c in zip(*rows))
    shape = (2, T, 16, 16, 3) if kind == "video" else (2, 16, 16, 3)
    return {"text_tokens": tt, "text_labels": tl, "modality_positions": mp,
            "image_masks": im,
            "images": rng.uniform(-1, 1, size=shape).astype(np.float32),
            "is_und": np.asarray([0, 1 if kind == "und" else 0], np.int32)}


def _port_model(tcfg, jcfg, params):
    sd = showo2_state_dict(params, jcfg.llm.num_layers,
                           jcfg.siglip.num_layers, jcfg.dit.num_layers)
    return load_showo2(tshowo2.Showo2(tcfg), sd).train().requires_grad_(True)


def _port_sd(jcfg, params):
    return showo2_state_dict(jax.tree.map(np.asarray, params),
                             jcfg.llm.num_layers, jcfg.siglip.num_layers,
                             jcfg.dit.num_layers)


def _jax_draws(key, batch, jtransport, jsc, latent_shape):
    """The draws JAX's stage-1 step takes from ``key``, for the port: the
    VAE's posterior noise (channels first), the per-sample t (the und path
    applied) and x0."""
    k_vae, k_t, k_noise = jax.random.split(key, 3)
    B = latent_shape[0]
    video = len(latent_shape) == 5
    tlast = (B,) + ((latent_shape[2],) if video else (1,)) \
        + latent_shape[-2:] + (latent_shape[1],)
    eps = np.asarray(jax.random.normal(k_vae, tlast, jnp.float32))
    eps = eps.transpose(0, 4, 1, 2, 3)
    t = jtransport.sample_t(k_t, B)
    if jsc.und_max_t0 is not None:
        t_und = jtransport.sample_t(k_t, B, max_t0=jsc.und_max_t0)
        t = jnp.where(jnp.asarray(batch["is_und"]) > 0, t_und, t)
    x0 = jax.random.normal(k_noise, latent_shape, jnp.float32)
    return {"vae_eps": torch.as_tensor(eps), "t": torch.as_tensor(
        np.asarray(t)), "x0": torch.as_tensor(np.asarray(x0))}


def _jax_frozen(frozen):
    return tuple(JAX_FROZEN.get(s, s) for s in frozen)


def _step_vs_jax(route, kind, frozen=(), stage=1, optimizer="adamw",
                 remat="full", lr=1e-4):
    jcfg, tcfg = tiny_cfgs()
    params = showo2_params(jcfg)
    vae_params = _vae_params(VAE_TINY)
    batch = _batch(kind)
    und = 1.0 if kind == "und" else 0.9
    common = dict(learning_rate=lr, und_max_t0=und, remat=remat,
                  optimizer=optimizer)
    if stage == 1:
        jsc = JStage1Config(attn_impl="pallas_trainable"
                            if route == "trainable" else "dense", **common)
        sc = t1.Stage1Config(attn_impl=route, **common)
    else:
        lrs = dict(lr_und=1e-4, lr_fusion=3e-4, lr_main=2e-5)
        jsc = JStage2Config(attn_impl="pallas_trainable"
                            if route == "trainable" else "dense",
                            **common, **lrs)
        sc = t2.Stage2Config(attn_impl=route, **common, **lrs)
    jtransport = jtr.Transport(snr_type="lognorm", do_shift=True,
                               seq_len=jcfg.num_image_tokens)
    jparams = jax.tree.map(jnp.asarray, params)
    make = make_stage1_optimizer if stage == 1 else make_stage2_optimizer
    jopt = make(jsc, jparams, _jax_frozen(frozen))
    step = make_stage1_step(jcfg, VAE_TINY, jsc, jtransport, jopt)
    key = jax.random.PRNGKey(7)
    new_params, _, want = step(jparams, jopt.init(jparams),
                               jax.tree.map(jnp.asarray, vae_params),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               key)

    model = _port_model(tcfg, jcfg, params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    vae = _port_vae(VAE_TINY, vae_params).requires_grad_(False)
    transport = ttr.Transport(snr_type="lognorm", do_shift=True,
                              seq_len=jcfg.num_image_tokens)
    opt = (t1.make_stage1_optimizer(sc, model, frozen) if stage == 1
           else t2.make_stage2_optimizer(sc, model, frozen))
    tstep = t1.Stage1Step(model, vae, sc, transport, opt)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        lat_shape = tuple(twan.wan_encode(
            vae, (tbatch["images"].permute(0, 4, 1, 2, 3) if kind == "video"
                  else tbatch["images"].permute(0, 3, 1, 2)[:, :, None]),
            deterministic=True).shape)
    if kind != "video":
        lat_shape = lat_shape[:2] + lat_shape[3:]
    got = tstep(tbatch, noise=_jax_draws(key, batch, jtransport, jsc,
                                         lat_shape))
    for name in ("loss", "loss_ntp", "loss_flow"):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    if not frozen:
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(want["grad_norm"]), rtol=2e-3)
    sd = _port_sd(jcfg, new_params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), sd[name], rtol=0, atol=1e-5,
                                   err_msg=name)
        if any(s in name for s in frozen):
            assert torch.equal(p, before[name]), name
    return model, before, got


@pytest.mark.parametrize("route", ["dense", "trainable"])
@pytest.mark.parametrize("kind", ["image", "video", "und"])
def test_stage1_step_vs_jax(route, kind):
    frozen = STAGE1A_FROZEN if kind == "und" else ()
    _, _, got = _step_vs_jax(route, kind, frozen)
    if kind == "und":
        assert got["loss_ntp"].item() > 0


@pytest.mark.parametrize("optimizer,remat,lr", [
    ("adafactor", "qkv_fc1_attn", 1e-3), ("adamw_bf16", "full", 1e-4)])
def test_stage1_step_throughput_modes_vs_jax(optimizer, remat, lr):
    """One stage-1 step under ``train_v2``'s adafactor + ``qkv_fc1_attn``
    (at learning rate 1e-3, as the v1 adafactor step of
    tests/test_torch_training.py and for its reasons), and under
    adamw_bf16 + ``full``, against JAX's with the same, at the limits
    above; the port's optimizer steps the JAX package's tensors
    (``training/optim.py::jax_tensors``), shape for shape."""
    from showo_tpu_torch.training.optim import jax_tensors

    model, _, _ = _step_vs_jax("dense", "image", optimizer=optimizer,
                               remat=remat, lr=lr)
    jcfg, _ = tiny_cfgs()
    assert (sorted(t.shape for t in jax_tensors(model))
            == sorted(x.shape for x in jax.tree.leaves(showo2_params(jcfg))))


def test_stage1_step_on_trainable_calls_the_trainable_kernels():
    """Each layer of both towers calls the trainable dispatcher, in the
    forward and again in the remat recompute."""
    from unittest import mock

    from showo_tpu_torch.show_o2 import qwen2 as tq

    with mock.patch.object(tq, "omni_attention_packed_trainable",
                           wraps=tq.omni_attention_packed_trainable) as spy:
        _step_vs_jax("trainable", "image")
    assert spy.call_count == 2 * (2 + 2)
    assert {c.kwargs["num_heads"] for c in spy.call_args_list} == {4}
    dims = {c.args[0].shape[-1] // 4 for c in spy.call_args_list}
    assert dims == {128, 24}


def test_stage2_param_groups_vs_jax():
    jcfg, tcfg = tiny_cfgs()
    params = showo2_params(jcfg)
    codes = {"und": 1, "fusion": 2, "main": 3}
    labels = jparam_groups(params)
    coded = jax.tree.map(lambda lab, p: np.full(np.shape(p), codes[lab],
                                                np.float32),
                         labels, params)
    want = showo2_state_dict(coded, jcfg.llm.num_layers,
                             jcfg.siglip.num_layers, jcfg.dit.num_layers)
    got = t2.param_groups(tshowo2.Showo2(tcfg))
    assert set(got) == set(want)
    for name, lab in got.items():
        assert set(np.unique(want[name]).tolist()) == {codes[lab]}, name
    assert set(got.values()) == set(codes)


def test_stage2_step_moves_each_group_by_its_rate():
    model, before, _ = _step_vs_jax("dense", "und", stage=2)
    groups = t2.param_groups(model)
    moves = {}
    for n, p in model.named_parameters():
        d = (p.detach() - before[n]).abs().max().item()
        moves[groups[n]] = max(moves.get(groups[n], 0.0), d)
    # AdamW's first step moves a weight by its rate, and by its rate times
    # the weight decay (0.01) times the weight (norm scales are 1)
    assert 0.5e-4 < moves["und"] <= 1.02e-4
    assert 1.5e-4 < moves["fusion"] <= 3.06e-4
    assert 1e-5 < moves["main"] <= 2.04e-5


def test_stage1_frozen_and_accumulation():
    """Frozen parameters take no gradient and stay bit for bit; with
    gradient accumulation the weights move on every second call only."""
    _, tcfg = tiny_cfgs()
    model = tshowo2.Showo2(tcfg).init_random(torch.Generator().manual_seed(0))
    sc = t1.Stage1Config(grad_accum_steps=2)
    opt = t1.make_stage1_optimizer(sc, model, STAGE1A_FROZEN)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(any(s in n for s in STAGE1A_FROZEN)
                          for n in frozen)
    assert len(opt.params) == sum(p.requires_grad
                                  for p in model.parameters())
    before = [p.detach().clone() for p in opt.params]
    grads = [torch.ones_like(p) for p in opt.params]
    assert not opt.update([g.clone() for g in grads])
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    assert opt.update([g.clone() for g in grads])
    assert not torch.equal(before[0], opt.params[0])


def test_trainer_refuses_inference_routes_and_the_cpu_fallback(monkeypatch):
    _, tcfg = tiny_cfgs()
    model = tshowo2.Showo2(tcfg)
    sc = t1.Stage1Config(attn_impl="packed")
    with pytest.raises(ValueError, match="no backward"):
        t1.Stage1Step(model, None, sc, ttr.Transport(),
                      t1.make_stage1_optimizer(sc, model))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from showo_tpu_torch.config import load_config

    config = load_config(os.path.join(REPO, "configs",
                                      "showo2_1.5b_stage_1_a.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t1.build_trainer(config)


def _jsonl(tmp_path, n=6, size=20):
    from PIL import Image

    imdir = tmp_path / "imgs"
    imdir.mkdir(exist_ok=True)
    path = tmp_path / "data.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            p = imdir / f"{i}.png"
            Image.new("RGB", (size + 4 * i, size), (i * 40 % 255, 90,
                                                    200 - 10 * i)).save(p)
            key = "prompt" if i % 2 else "caption"
            f.write(json.dumps({"path": str(p), key: f"a sample {i}"}) + "\n")
    return str(path)


# -- checkpoints ---------------------------------------------------------------

def test_checkpoint_ring_and_params_only_fallback(tmp_path):
    from showo_tpu_torch.utils import checkpoint as ck

    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    for step in (2, 4, 6):
        ck.save_checkpoint(str(tmp_path), step, model, opt,
                           checkpoints_total_limit=2)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-4", "checkpoint-6"]
    fresh = torch.nn.Linear(3, 2)
    opt2 = torch.optim.AdamW(fresh.parameters())
    assert ck.resume_latest(str(tmp_path), fresh, opt2) == 6
    assert torch.equal(fresh.weight, model.weight)
    assert opt2.state_dict()["state"][0]["step"] == 1
    # an optimizer of another shape: weights only, with the fallback
    other = torch.optim.AdamW([{"params": [fresh.weight]},
                               {"params": [fresh.bias]}])
    with pytest.raises(ValueError):
        ck.resume_latest(str(tmp_path), fresh, other)
    assert ck.resume_latest(str(tmp_path), fresh, other,
                            params_only_fallback=True) == 6
    assert other.state_dict()["state"] == {}
    assert ck.resume_latest(str(tmp_path / "none"), fresh) == 0


# -- the CLIs --------------------------------------------------------------------

CLI_TINY = [
    "device=cpu", "model.showo.hidden_size=64",
    "model.showo.llm_vocab_size=1100", "model.showo.llm_intermediate_size=128",
    "model.showo.llm_num_layers=2", "model.showo.llm_num_heads=4",
    "model.showo.llm_num_kv_heads=2", "model.showo.llm_head_dim=128",
    "model.showo.clip_latent_dim=48",
    "model.showo.siglip={hidden_size: 48, intermediate_size: 96, "
    "num_heads: 4, num_layers: 2, num_positions: 16}",
    "model.showo.dit={hidden_size: 96, intermediate_size: 192, "
    "num_heads: 4, num_kv_heads: 2, head_dim: 24}",
    "model.showo.num_diffusion_layers=2",
    "model.showo.image_latent_height=8", "model.showo.image_latent_width=8",
    "model.vae_model.dims={dim: 16, dim_mult: [1, 2], num_res_blocks: 1, "
    "temperal_downsample: [true]}",
    "dataset.preprocessing.resolution=16",
    "dataset.preprocessing.max_seq_length=40",
    "dataset.preprocessing.num_t2i_image_tokens=16",
    "dataset.preprocessing.max_text_len=8",
    "training.batch_size_t2i=1", "training.batch_size_mmu=1",
    "experiment.log_every=1", "experiment.save_every=2",
    "experiment.generate_every=2",
]


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_trains_saves_and_resumes(tmp_path, stage):
    """Two steps and a checkpoint (with the loader state, validation
    images and reconstruction panels at step 2), then a second run that
    resumes from ``latest`` at step 2 and trains to step 3, its step-3
    metrics those of an unbroken three-step run."""
    mod = t1 if stage == 1 else t2
    cfg = os.path.join(REPO, "configs", f"showo2_1.5b_stage_{stage}_a.yaml")
    data = _jsonl(tmp_path, size=16)
    out = tmp_path / "out"
    args = [f"config={cfg}", *CLI_TINY, f"dataset.params.t2i_jsonl={data}",
            f"dataset.params.mmu_jsonl={data}", "dataset.params."
            "annotation_path=null", f"experiment.output_dir={out}",
            "validation_prompts=[a red cat]"]
    first = mod.main(args + ["training.max_train_steps=2"])
    assert first.global_step == 2
    assert sorted(os.listdir(out / "checkpoint-2")) == [
        "loader_state.json", "metadata.json", "state.pt"]
    assert (out / "config.yaml").exists()
    assert len(os.listdir(out / "samples")) > 0
    assert len(os.listdir(out / "recon")) == 2
    resumed = mod.main(args + ["training.max_train_steps=3"])
    assert resumed.global_step == 3
    assert resumed.optimizer.steps == 3
    unbroken = mod.main([a.replace(str(out), str(tmp_path / "u"))
                         for a in args] + ["training.max_train_steps=3",
                                           "experiment.save_every=null",
                                           "experiment.generate_every=null"])
    for (n, a), b in zip(resumed.model.state_dict().items(),
                         unbroken.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)


def test_t2i_velocity_on_the_trainable_route_vs_jax():
    """The inference forward on ``trainable`` (what JAX's T2I pipeline
    runs under ``pallas_trainable``): the velocity with CFG against JAX's
    on the same route (its kernels in interpret mode), atol 2e-5 as the
    packed route's test in tests/test_torch_show_o2.py."""
    from showo_tpu.ops import flash_attention as jfa
    from showo_tpu.show_o2 import masks as jmasks
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs

    jcfg, tcfg = tiny_cfgs()
    params = showo2_params(jcfg)
    model = _port_model(tcfg, jcfg, params).eval()
    rng = np.random.default_rng(1)
    B, L, n = 4, 32, jcfg.num_image_tokens
    text = rng.integers(10, 190, size=(B, L))
    mp = np.asarray([[[5, n]], [[9, n]], [[2, n]], [[2, n]]])
    z = rng.normal(size=(B, 16, 8, 8)).astype(np.float32)
    t = np.full((B,), 0.37, np.float32)
    seg = jfa.seg_from_modality_positions(jnp.asarray(mp), L)
    jmeta = ("pallas_trainable", seg, jnp.zeros((B, L), jnp.int32),
             jnp.full((B,), -1, jnp.int32), jnp.zeros((B,), jnp.int32))
    want = jshowo2.showo2_t2i_velocity(
        jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(text),
        jnp.asarray(z), jnp.asarray(t),
        jmasks.omni_attn_mask(jnp.asarray(mp), L), jnp.asarray(mp),
        guidance_scale=5.0, attn_meta=jmeta)
    bias, meta = attention_inputs("trainable", torch.as_tensor(text),
                                  torch.as_tensor(mp))
    assert bias is None and meta.route == "trainable"
    with torch.no_grad():
        got = tshowo2.showo2_t2i_velocity(
            model, torch.as_tensor(text), torch.as_tensor(z),
            torch.as_tensor(t), None, torch.as_tensor(mp),
            guidance_scale=5.0, attn_meta=meta)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="self-attention"):
        attention_inputs("trainable", torch.as_tensor(text),
                         torch.as_tensor(mp),
                         q_positions=torch.arange(4)[None].expand(B, 4))
