"""The rest of the v1 trainer in showo_tpu_torch against the JAX package,
fp32 on the CPU.

* ``ema_decay`` under both schedules (fp32, rtol 1e-6) and five
  ``EMA.update`` steps of random weights against JAX's ``ema_update``
  (rtol 1e-6, atol 1e-7);
* ``mask_contiguous_region_prob``: tokens and labels equal to JAX's under
  JAX's own draws handed in (the rectangle's corners and the batch's
  select), for probabilities that take the rectangle and that do not;
* ``visualize_predictions``: the step's corruption re-run from JAX's
  draws, the argmax over the codebook slice, both code sets decoded: the
  reconstruction and prediction panels equal to JAX's within 1e-5, the
  mask ratios in the file names equal;
* the CLI over tiny data (an ImageNet class folder, a caption tar shard,
  a parquet file) at tiny widths, with ``save_every`` 1,
  ``checkpoints_total_limit`` 2, ``generate_every`` 2 and the EMA on:
  the checkpoint ring, the EMA and loader states in each checkpoint, the
  validation and prediction PNGs; then a second run that resumes from
  ``latest`` (the EMA and the loaders' positions restored) and whose
  weights and EMA after step 4 are an unbroken 4-step run's (atol 1e-6).
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import magvit as jmv
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.sampling.schedules import cosine_schedule as j_cosine
from showo_tpu.training import corruption as jcorr
from showo_tpu.training import ema as jema
from showo_tpu.training.train_showo import ShowoTrainer as JShowoTrainer
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.prompting import UniversalPrompting
from showo_tpu_torch.sampling.schedules import cosine_schedule
from showo_tpu_torch.training import corruption as tcorr
from showo_tpu_torch.training import ema as tema
from showo_tpu_torch.training import train_showo as ttrain
from showo_tpu_torch.utils.convert import load_magvit, magvit_state_dict
from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer

from test_torch_data_loaders import write_imagenet, write_parquet, write_shard
from test_torch_training import (MAX_SEQ, SHOWO_DIMS, STAGE1, TEXTS_T2I,
                                 TINY, VQ_DIMS, _configs, _jax_draws, _models,
                                 _stage1_config)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

EMA_CASES = [dict(), dict(decay=0.95, min_decay=0.5, update_after_step=2),
             dict(use_ema_warmup=True, inv_gamma=2.0, power=0.75)]


@pytest.mark.parametrize("kw", EMA_CASES)
def test_ema_vs_jax(kw):
    jc, tc = jema.EMAConfig(**kw), tema.EMAConfig(**kw)
    for step in range(12):
        np.testing.assert_allclose(tema.ema_decay(tc, step),
                                   float(jema.ema_decay(jc, step)),
                                   rtol=1e-6, atol=0)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    ema = tema.EMA(tc, [(k, torch.tensor(v)) for k, v in params.items()])
    state = jema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    for i in range(5):
        new = {k: rng.normal(size=s).astype(np.float32)
               for k, s in shapes.items()}
        state = jema.ema_update(jc, state, {k: jnp.asarray(v)
                                            for k, v in new.items()})
        ema.update([torch.tensor(v) for v in new.values()])
        for k, e in zip(ema.names, ema.params):
            np.testing.assert_allclose(e.numpy(), np.asarray(state.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert ema.step == int(state.step) == 5
    # the state round trip
    other = tema.EMA(tc, [(k, torch.zeros(s)) for k, s in shapes.items()])
    other.load_state_dict(ema.state_dict())
    assert other.step == 5 and all(torch.equal(a, b) for a, b in
                                   zip(other.params, ema.params))
    with pytest.raises(ValueError):
        tema.EMA(tc, [("a", torch.zeros(3, 4))]).load_state_dict(
            ema.state_dict())


def _region_draws(key, B, side):
    """The rectangle draws JAX's corruption takes from ``key``."""
    _, _, k_contig, _, _ = jax.random.split(key, 5)
    _, k_r, k_c, k_sel = jax.random.split(k_contig, 4)
    return {"region_rows": jax.random.randint(k_r, (B,), 0, side),
            "region_cols": jax.random.randint(k_c, (B,), 0, side),
            "region_select": jax.random.uniform(k_sel, ())}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("prob", [0.5, 1.0])
@pytest.mark.parametrize("noise_type", ["mask", "random_replace"])
def test_contiguous_region_vs_jax(seed, prob, noise_type):
    B, S, cb = 3, 64, 32
    tokens = np.random.default_rng(seed).integers(0, cb, size=(B, S))
    key = jax.random.PRNGKey(seed)
    kw = dict(noise_type=noise_type, codebook_size=cb,
              mask_contiguous_region_prob=prob, min_masking_rate=0.1)
    want = jcorr.mask_or_random_replace_tokens(key, jnp.asarray(tokens), 99,
                                               j_cosine, **kw)
    draws = {**_jax_draws(key, B, S, cb), **_region_draws(key, B, 8)}
    got = tcorr.mask_or_random_replace_tokens(
        torch.as_tensor(tokens), 99, cosine_schedule,
        **{k: torch.tensor(np.asarray(v)) for k, v in draws.items()}, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if prob == 1.0:    # every row masks one rectangle of the 8 x 8 grid
        for row in (got[1] != -100).reshape(B, 8, 8):
            r = row.any(1).nonzero().flatten()
            c = row.any(0).nonzero().flatten()
            assert row.sum() == len(r) * len(c)


def _vq():
    jvq_cfg = jmv.VQConfig(**VQ_DIMS)
    vq_params = jmv.MagvitV2(jvq_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"]
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, jvq_cfg)).eval()
    return jvq_cfg, vq_params, vq.requires_grad_(False)


def test_visualize_predictions_vs_jax(tmp_path):
    jcfg, _ = _configs()
    params, model = _models(seed=3)
    jvq_cfg, vq_params, vq = _vq()
    config = _stage1_config("training.cond_dropout_prob=0.0")
    trainer = ttrain.ShowoTrainer(
        config=config, model=model, vq=vq,
        uni_prompting=UniversalPrompting(FakeTokenizer(),
                                         max_text_len=MAX_SEQ,
                                         cond_dropout_prob=0.0))
    batch = {"image": np.random.default_rng(4).uniform(
        -1, 1, (2, 8, 8, 3)).astype(np.float32), "text": TEXTS_T2I}

    ns = types.SimpleNamespace(
        cfg=jcfg, vq_cfg=jvq_cfg, tc=None, config=config, global_step=0,
        uni_prompting=JaxPrompting(jfake.FakeTokenizer(),
                                   max_text_len=MAX_SEQ,
                                   cond_dropout_prob=0.0),
        state=types.SimpleNamespace(params=params), vq_params=vq_params,
        tracker=types.SimpleNamespace(log=lambda *a, **k: None))
    ns._save_viz = lambda *a: JShowoTrainer._save_viz(ns, *a)
    key = jax.random.PRNGKey(9)
    want = JShowoTrainer.visualize_predictions(ns, batch, key,
                                               str(tmp_path / "jax"))
    k_corrupt, = jax.random.split(key, 1)
    draws = _jax_draws(k_corrupt, 2, SHOWO_DIMS["num_vq_tokens"], 16)
    noise = {k: torch.tensor(np.asarray(draws[k]))
             for k in ("timesteps", "uniforms")}
    tokens, predicted, ratio = trainer.predict_tokens(batch, noise=noise)
    assert (tokens != predicted).any()
    got = trainer.visualize_predictions(batch, None, str(tmp_path / "port"),
                                        noise=noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert sorted(os.listdir(tmp_path / "port" / "predictions")) == \
        sorted(os.listdir(tmp_path / "jax" / "predictions"))


def _cli_args(tmp_path, out):
    data = tmp_path / "data"
    if not data.exists():
        write_imagenet(str(data / "imagenet"))
        write_shard(data / "cap-00000.tar", 0, 6)
        write_parquet(str(data / "lm.parquet"))
    return [f"config={STAGE1}", *TINY, "device=cpu",
            "training.cond_dropout_prob=0.0",
            f"dataset.params.train_t2i_shards_path_or_url={data}/imagenet",
            "dataset.params.train_mmu_shards_path_or_url="
            f"{data}/cap-{{00000..00000}}.tar",
            f"dataset.params.train_lm_shards_path_or_url={data}/lm.parquet",
            "dataset.params.resolution=8",
            "dataset.params.shuffle_buffer_size=3",
            "dataset.params.validation_prompts_file=null",
            "validation_prompts=[a red cat, a house]",
            "training.generation_timesteps=3",
            "training.ema={enabled: true, decay: 0.9}",
            # the cosine schedule spans max_train_steps, which the runs vary
            "lr_scheduler.scheduler=constant",
            "experiment.log_every=1", f"experiment.output_dir={out}"]


def test_cli_fit_checkpoints_ema_validation_and_resume(tmp_path):
    out = tmp_path / "out"
    args = _cli_args(tmp_path, out)
    ring = ["experiment.save_every=1", "experiment.generate_every=2",
            "experiment.checkpoints_total_limit=2"]
    first = ttrain.main(args + ring + ["training.max_train_steps=3"])
    assert first.global_step == 3 and first.ema.step == 3
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint")) \
        == ["checkpoint-2", "checkpoint-3"]
    assert sorted(os.listdir(out / "checkpoint-3")) == [
        "ema_state.pt", "lm_state.json", "metadata.json", "mmu_state.json",
        "state.pt", "t2i_state.json"]
    assert sorted(os.listdir(out / "samples")) == [
        "step0000002_00.png", "step0000002_01.png"]
    preds = sorted(os.listdir(out / "predictions"))
    assert len(preds) == 2 and preds[0].startswith("step0000002_00_mask")
    assert (out / "config.yaml").exists()

    resumed = ttrain.main(args + ["training.max_train_steps=4"])
    assert resumed.global_step == 4 and resumed.optimizer.steps == 4
    assert resumed.ema.step == 4
    unbroken = ttrain.main(_cli_args(tmp_path, tmp_path / "u")
                           + ["training.max_train_steps=4"])
    for (n, a), b in zip(resumed.model.state_dict().items(),
                         unbroken.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)
    for n, a, b in zip(resumed.ema.names, resumed.ema.params,
                       unbroken.ema.params):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)
    # the EMA moved away from the weights
    assert any(not torch.equal(e, p.float()) for e, p in
               zip(resumed.ema.params, resumed.model.parameters()))
