"""Show-o2 mixed-modality training in showo_tpu_torch against the JAX
package, fp32 on the CPU.

* One mixed-modality step against JAX's ``make_mixed_modal_step`` on the
  two-layer model of tests/test_torch_show_o2_train.py (the TINY of
  tests/test_train_stage_one.py with Qwen heads 128 wide), B = 2, M = 2,
  one sample with a (0, 0) span: JAX's ``k_vae`` / ``k_t`` / ``k_noise``
  draws are handed to the port.  Under the configuration's phase-1 frozen
  set: loss / loss_ntp / loss_flow at rtol 2e-4 and the weights after one
  AdamW step at atol 1e-5 (the stage-1 step's limits), frozen tensors bit
  for bit unchanged.  With nothing frozen, the grad norm at rtol 2e-3
  against JAX's gradient (JAX's step under ``optax.sgd(1.0)``: the
  gradient is the weights' change).
* The ``trainable`` route (kernel 8's plain version, past a patched packed
  budget) against ``dense``: losses and grad norm at rtol 2e-4, weights at
  atol 1e-6; every layer of both towers calls the trainable dispatcher.
* ``VISTDataset`` arrays equal to JAX's.
* ``semantic_layer_features`` (on and off the position table's grid) at
  atol 1e-5, ``distillation_loss`` at rtol 1e-6, and three distillation
  steps (torch Adam against optax.adam): losses at rtol 1e-5, weights at
  atol 1e-5 (the k projection's bias has a gradient of rounding noise
  alone, softmax being blind to it, which Adam scales up to ~1e-6).
* The repaired resume: a stage-1 save, then a resume with a changed
  frozen set, under ``adamw``, ``adamw_bf16`` and ``adafactor``: the bare
  ``load_state_dict`` raises ValueError and leaves the state as it was,
  ``resume_latest`` warns and restores the weights alone with a fresh
  optimizer state.
* The CLI's two-phase recipe on the CPU.
"""

import json
import logging
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from showo_tpu.show_o2 import transport as jtr
from showo_tpu.show_o2.formats import format_interleaved_sequence
from showo_tpu.show_o2.train_mixed_modality import make_mixed_modal_step
from showo_tpu.show_o2.train_stage_one import Stage1Config as JStage1Config
from showo_tpu.show_o2.train_stage_one import make_stage1_optimizer
from showo_tpu_torch.show_o2 import train_mixed_modality as tmm
from showo_tpu_torch.show_o2 import train_stage_one as t1
from showo_tpu_torch.show_o2 import transport as ttr
from showo_tpu_torch.utils import checkpoint as ck

from test_t2i_v2_pipeline import VAE_TINY
from test_torch_mmu_v2 import _port_vae, _vae_params
from test_torch_show_o2 import showo2_params
from test_torch_show_o2_train import (CLI_TINY, IDS, _jax_frozen,
                                      _port_model, _port_sd, tiny_cfgs)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = os.path.join(REPO, "configs",
                     "showo2_1.5b_downstream_mixed_modality_simple.yaml")
PHASE1_FROZEN = ("image_embedder_und", "und_trans", "showo",
                 "position_embedding")
L, M = 64, 2


def _batch():
    """Two samples of [B, M] = [2, 2] images: two spans, then one span and
    a (0, 0) one."""
    rng = np.random.default_rng(0)
    n_img = tiny_cfgs()[0].num_image_tokens
    rows = [format_interleaved_sequence(
        ["img"] * k, [list(rng.integers(10, 190, size=3)) for _ in range(k)],
        num_image_tokens=n_img, max_seq_len=L, max_num_images=M, **IDS)
        for k in (2, 1)]
    tt, tl, mp, tm, im = (np.stack(c) for c in zip(*rows))
    assert tuple(mp[1, 1]) == (0, 0)
    return {"text_tokens": tt, "text_labels": tl, "modality_positions": mp,
            "image_masks": im,
            "images": rng.uniform(-1, 1, (2, M, 16, 16, 3)).astype(
                np.float32)}


def _jax_draws(key, jtransport, latent_shape):
    """What JAX's mixed-modality step draws from ``key``: the VAE's
    posterior noise (channels first), t [B*M] before the (0, 0) spans are
    set to 1, and x0."""
    k_vae, k_t, k_noise = jax.random.split(key, 3)
    n, c, h, w = latent_shape
    eps = np.asarray(jax.random.normal(k_vae, (n, 1, h, w, c), jnp.float32))
    return {"vae_eps": torch.as_tensor(eps.transpose(0, 4, 1, 2, 3).copy()),
            "t": torch.as_tensor(np.asarray(jtransport.sample_t(k_t, n))),
            "x0": torch.as_tensor(np.asarray(
                jax.random.normal(k_noise, latent_shape, jnp.float32)))}


def _transports(jcfg):
    kw = dict(snr_type="lognorm", do_shift=True,
              seq_len=jcfg.num_image_tokens)
    return jtr.Transport(**kw), ttr.Transport(**kw)


def _port_step(route="dense", frozen=(), seed_params=0):
    jcfg, tcfg = tiny_cfgs()
    params = showo2_params(jcfg, seed_params)
    vae_params = _vae_params(VAE_TINY)
    model = _port_model(tcfg, jcfg, params)
    vae = _port_vae(VAE_TINY, vae_params).requires_grad_(False)
    sc = t1.Stage1Config(attn_impl=route, und_max_t0=None, ntp_coeff=1.0)
    opt = t1.make_stage1_optimizer(sc, model, frozen)
    _, transport = _transports(jcfg)
    return (jcfg, params, vae_params, model,
            tmm.MixedModalStep(model, vae, sc, transport, opt))


def _latent_shape(step, batch):
    B, Mi = batch["images"].shape[:2]
    with torch.no_grad():
        lat = step.encode(torch.as_tensor(batch["images"]).reshape(
            B * Mi, 16, 16, 3), eps=None)
    return tuple(lat.shape)


@pytest.mark.parametrize("case", ["phase1_frozen", "grad_norm"])
def test_mixed_modal_step_vs_jax(case):
    frozen = PHASE1_FROZEN if case == "phase1_frozen" else ()
    jcfg, params, vae_params, model, step = _port_step(frozen=frozen)
    batch = _batch()
    jtransport, _ = _transports(jcfg)
    jsc = JStage1Config(und_max_t0=None, ntp_coeff=1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = (make_stage1_optimizer(jsc, jparams, _jax_frozen(frozen))
            if frozen else optax.sgd(1.0))
    jstep = make_mixed_modal_step(jcfg, VAE_TINY, jsc, jtransport, jopt)
    key = jax.random.PRNGKey(11)
    new_params, _, want = jstep(jax.tree.map(jnp.copy, jparams),
                                jopt.init(jparams),
                                jax.tree.map(jnp.asarray, vae_params),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                key)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    noise = _jax_draws(key, jtransport, _latent_shape(step, batch))
    prepared = step.prepare(tbatch, noise=noise)
    # the (0, 0) span is clean, the others keep their draws
    assert prepared.t[3].item() == 1.0
    assert prepared.t[:3].tolist() == noise["t"][:3].tolist()
    got = step(tbatch, noise=noise)
    for name in ("loss", "loss_ntp", "loss_flow"):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    if frozen:
        sd = _port_sd(jcfg, new_params)
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[name], rtol=0,
                                       atol=1e-5, err_msg=name)
            if any(s in name for s in frozen):
                assert torch.equal(p, before[name]), name
        assert any(not torch.equal(p, before[n])
                   for n, p in model.named_parameters())
    else:
        grads = jax.tree.map(lambda a, b: np.asarray(a, np.float64)
                             - np.asarray(b, np.float64), params, new_params)
        norm = np.sqrt(sum(float(np.sum(g * g))
                           for g in jax.tree.leaves(grads)))
        np.testing.assert_allclose(got["grad_norm"].item(), norm, rtol=2e-3)


def test_mixed_modal_trainable_vs_dense():
    """The trainable route runs kernel 8 (plain here) in every layer of both
    towers, forward and remat recompute, and gives the dense step."""
    from showo_tpu.ops import packed_attention_grad as jpag
    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.show_o2 import qwen2 as tq

    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    *_, dmodel, dense = _port_step("dense")
    want = dense(batch, generator=gen())
    *_, kmodel, trainable = _port_step("trainable")
    with mock.patch.object(tpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(jpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(tpag, "omni_attention_trainable",
                              wraps=tpag.omni_attention_trainable) as k8, \
            mock.patch.object(tq, "omni_attention_packed_trainable",
                              wraps=tq.omni_attention_packed_trainable) as d:
        got = trainable(batch, generator=gen())
    assert d.call_count == 2 * (2 + 2) and k8.call_count == d.call_count
    for name in ("loss", "loss_ntp", "loss_flow", "grad_norm"):
        np.testing.assert_allclose(got[name].item(), want[name].item(),
                                   rtol=2e-4, err_msg=name)
    for (n, a), b in zip(kmodel.state_dict().items(),
                         dmodel.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)


def _vist(tmp_path, n_records=2):
    from PIL import Image

    for i in range(3):
        Image.new("RGB", (20 + 4 * i, 20), (i * 100, 50, 200 - 40 * i)).save(
            tmp_path / f"i{i}.png")
    recs = [{"images": ["i0.png", "i1.png", "i2.png"][: 3 - r % 2],
             "sentences": ["first scene", "the second scene here",
                           "and a third"][: 3 - r % 2]}
            for r in range(n_records)]
    path = tmp_path / "vist.json"
    path.write_text(json.dumps(recs))
    return str(path)


def test_vist_dataset_vs_jax(tmp_path):
    from showo_tpu.data.vist_dataset import VISTDataset as JVIST
    from showo_tpu_torch.data.vist_dataset import VISTDataset as TVIST
    from showo_tpu_torch.inference_t2i_v2 import FakeQwenTokenizer

    path = _vist(tmp_path)
    kw = dict(resolution=16, num_image_tokens=5, max_seq_len=64,
              max_num_images=4)
    ids = dict(IDS)
    jd = JVIST(path, str(tmp_path), FakeQwenTokenizer(), ids, **kw)
    td = TVIST(path, str(tmp_path), FakeQwenTokenizer(), ids, **kw)
    assert len(td) == len(jd) == 2
    for g, w in zip(td, jd):
        assert set(g) == set(w)
        for k in g:
            if k == "data_type":
                assert g[k] == w[k] == "interleaved"
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert tuple(g["modality_positions"][-1]) == (0, 0)
        assert g["images"].shape == (4, 16, 16, 3)
        assert not g["images"][-1].any()


@pytest.mark.parametrize("side", [2, 3])
def test_semantic_layers_vs_jax(side):
    """Features on the table's grid (4 x 4 patches) and off it (6 x 6),
    the loss, and three distillation steps."""
    from showo_tpu.show_o2 import semantic_layers as jsem
    from showo_tpu_torch.show_o2 import semantic_layers as tsem

    jcfg, tcfg = tiny_cfgs()
    params = showo2_params(jcfg)
    model = _port_model(tcfg, jcfg, params)
    rng = np.random.default_rng(2)
    hw = 4 * side
    latents = rng.normal(size=(2, 16, hw, hw)).astype(np.float32)
    n = (hw // 2) ** 2
    target = rng.normal(size=(2, n, jcfg.clip_latent_dim)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    want = jsem.semantic_layer_features(jcfg, jp, jnp.asarray(latents))
    with torch.no_grad():
        got = tsem.semantic_layer_features(model, torch.as_tensor(latents))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        tsem.distillation_loss(got, torch.as_tensor(target)).item(),
        float(jsem.distillation_loss(want, jnp.asarray(target))), rtol=1e-6)
    # the loss clips the similarity at eps: opposite vectors give -log(eps)
    v = torch.ones(1, 1, 4)
    np.testing.assert_allclose(tsem.distillation_loss(v, -v).item(),
                               -np.log(1e-8), rtol=1e-6)

    jopt = optax.adam(1e-3)
    jstate = jopt.init(jp)
    jstep = jsem.make_distill_step(jcfg, jopt)
    opt = torch.optim.Adam(tsem.distillation_parameters(model), lr=1e-3)
    tstep = tsem.DistillStep(model, opt)
    jl, tl = [], []
    for _ in range(3):
        jp, jstate, loss = jstep(jp, jstate, jnp.asarray(latents),
                                 jnp.asarray(target))
        jl.append(float(loss))
        tl.append(tstep(torch.as_tensor(latents),
                        torch.as_tensor(target)).item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    sd = _port_sd(jcfg, jp)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), sd[name], rtol=0, atol=1e-5,
                                   err_msg=name)


# -- the repaired resume ------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adamw_bf16", "adafactor"])
def test_resume_after_a_changed_frozen_set(tmp_path, caplog, optimizer):
    """A stage-1 step under the phase-1 freeze, saved; then a model that
    trains everything resumes: the saved optimizer state does not fit, so
    the bare load raises ValueError and changes nothing, and
    ``resume_latest`` warns and restores the weights alone with a fresh
    optimizer state."""
    _, tcfg = tiny_cfgs()
    sc = t1.Stage1Config(optimizer=optimizer, learning_rate=1e-3)

    def trainer(frozen):
        model = t1.Showo2(tcfg).init_random(torch.Generator().manual_seed(0))
        model.train()
        return model, t1.make_stage1_optimizer(sc, model, frozen)

    model, opt = trainer(PHASE1_FROZEN)
    grads = [torch.full_like(p, 0.5) for p in opt.params]
    opt.update(grads)
    ck.save_checkpoint(str(tmp_path), 1, model, opt)

    model2, opt2 = trainer(())
    assert len(opt2.params) > len(opt.params)
    fresh = {k: v for k, v in opt2.state_dict().items()}
    saved = torch.load(tmp_path / "checkpoint-1" / "state.pt",
                       weights_only=False)["optimizer"]
    with pytest.raises(ValueError):
        opt2.load_state_dict(saved)
    if optimizer != "adamw":
        with pytest.raises(ValueError):
            opt2.inner.load_state_dict(saved[optimizer])
    with caplog.at_level(logging.WARNING, logger=ck.__name__):
        step = ck.resume_latest(str(tmp_path), model2, opt2,
                                params_only_fallback=True)
    assert step == 1
    assert "WEIGHTS ONLY" in caplog.text
    for (n, a), b in zip(model2.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), n
    state = opt2.state_dict()
    assert state["steps"] == 0 and opt2.steps == 0
    inner = state[optimizer]
    if optimizer == "adamw":
        assert inner["state"] == {}
    else:
        assert inner["count"] == 0
        moments = (inner["mu"] + inner["nu"] if optimizer == "adamw_bf16"
                   else [m for v in inner["v"].values() for m in v])
        assert all(not m.any() for m in moments)
    assert set(fresh) == set(state)
    # and without the fallback the mismatch raises
    with pytest.raises(ValueError):
        ck.resume_latest(str(tmp_path), model2, opt2)


# -- the CLI -------------------------------------------------------------------

def test_cli_two_phase_recipe(tmp_path, caplog):
    """Phase 1 (the config's frozen set) trains two steps and saves; phase
    2 (``frozen_params=[]``) resumes from ``latest`` with the weights-only
    fallback and a fresh optimizer, trains to step 3 and moves the
    parameters phase 1 froze."""
    path = _vist(tmp_path, n_records=3)
    out = tmp_path / "out"
    args = [f"config={MIXED}", *CLI_TINY,
            f"dataset.params.mixed_modal_json={path}",
            f"dataset.params.mixed_modal_image_root={tmp_path}",
            "dataset.preprocessing.max_mixed_modal_seq_length=96",
            "dataset.preprocessing.max_num_images=3",
            "training.batch_size_mixed_modal=2", "training.warmup_steps=0",
            "training.attn_impl=dense", f"experiment.output_dir={out}"]
    first = tmm.main(args + ["training.max_train_steps=2"])
    assert first.global_step == 2 and first.optimizer.steps == 2
    assert first.sc.ntp_coeff == 1.0
    assert sorted(os.listdir(out / "checkpoint-2")) == [
        "loader_state.json", "metadata.json", "state.pt"]
    frozen = {n for n, p in first.model.named_parameters()
              if not p.requires_grad}
    assert frozen and all(any(s in n for s in PHASE1_FROZEN) for n in frozen)
    phase1 = {n: p.detach().clone()
              for n, p in first.model.named_parameters()}
    with caplog.at_level(logging.WARNING, logger=ck.__name__):
        second = tmm.main(args + ["model.frozen_params=[]",
                                  "training.max_train_steps=3"])
    assert "WEIGHTS ONLY" in caplog.text
    assert second.global_step == 3 and second.optimizer.steps == 1
    assert all(p.requires_grad for p in second.model.parameters())
    moved = [n for n, p in second.model.named_parameters()
             if n in frozen and not torch.equal(p, phase1[n])]
    assert moved
    # the config's JAX route string reads as the port's route
    from showo_tpu_torch.config import load_config

    config = load_config(MIXED, [])
    assert t1.stage1_config(config).attn_impl == "trainable"
