"""Show-o2 stage 2 on LLaVA-OneVision conversations in showo_tpu_torch
against the JAX package, fp32 on the CPU, on tests/test_torch_show_o2_train
.py's two-layer model (Qwen heads 128 wide) with a vocabulary that holds
the stand-in tokenizer's ids.

* ``_concat_batches`` (``data/mixed.py``): a jsonl t2i batch (which has
  ``texts``) and an ``MMUDataset`` batch (which has not): JAX's raises
  KeyError, the port's keeps the keys both have, those of the step.
  Where the batches have the same keys the two agree, key for key; where
  the collate or the concatenation raises in JAX (a text-only record after
  an image record, records with two images beside records with one), the
  port raises the same error type.
* One stage-2 step (the three-group optimizer, the stage-2a freeze and
  every weight trained) on such a concatenated batch against JAX's
  stage-2 step on the same keys, on ``dense`` and ``trainable``, with
  JAX's draws: the limits of tests/test_torch_show_o2_train.py.
* The stage-2 CLI with ``annotation_path``: two steps and a checkpoint
  (the loaders' state with it), then a resume from ``latest`` to step 3
  whose weights are those of an unbroken three-step run.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.data import loader as jloader
from showo_tpu.data import mixed as jmixed
from showo_tpu.show_o2 import transport as jtr
from showo_tpu.show_o2.train_stage_one import make_stage1_step
from showo_tpu.show_o2.train_stage_two import Stage2Config as JStage2Config
from showo_tpu.show_o2.train_stage_two import make_stage2_optimizer
from showo_tpu_torch.data import loader as tloader
from showo_tpu_torch.data import mixed as tmixed
from showo_tpu_torch.data.image_text import ImageTextDataset
from showo_tpu_torch.data.mmu_dataset import MMUDataset
from showo_tpu_torch.inference_t2i_v2 import FAKE_TOKEN_IDS, FakeQwenTokenizer
from showo_tpu_torch.show_o2 import train_stage_one as t1
from showo_tpu_torch.show_o2 import train_stage_two as t2
from showo_tpu_torch.show_o2 import transport as ttr
from showo_tpu_torch.show_o2 import wan_vae as twan

from test_t2i_v2_pipeline import VAE_TINY
from test_torch_mmu_v2 import _port_vae, _vae_params
from test_torch_show_o2 import showo2_params
from test_torch_show_o2_train import (CLI_TINY, JAX_FROZEN, REPO, _jax_draws,
                                      _port_model, _port_sd, tiny_cfgs)

torch.set_num_threads(1)

N_IMG = 17          # 8 x 8 latents in 2 x 2 patches, and the time token
SEQ = 64
STAGE2A_FROZEN = ("image_embedder_und", "und_trans", "position_embedding")


def _cfgs():
    """tiny_cfgs() with a vocabulary of 1100 (the stand-in's word ids run to
    1000)."""
    return tuple(dataclasses.replace(c, llm=dataclasses.replace(
        c.llm, vocab_size=1100)) for c in tiny_cfgs())


def _data(tmp_path):
    """A jsonl of two t2i records and a conversation json of records over
    one 24 x 20 image: one with the image mid-turn and two rounds, one
    with it in the second round, one text-only, one with two images."""
    from PIL import Image

    Image.new("RGB", (24, 20), (200, 40, 90)).save(tmp_path / "a.png")
    with open(tmp_path / "t2i.jsonl", "w") as f:
        for i, p in enumerate(("a red cat", "a blue car on a road")):
            f.write(json.dumps({"path": str(tmp_path / "a.png"),
                                "prompt": p}) + "\n")
    convs = [
        [{"from": "human", "value": "Look at <image> now. What is it?"},
         {"from": "gpt", "value": "A pink square."},
         {"from": "human", "value": "Bright?"},
         {"from": "gpt", "value": "Yes, bright."}],
        [{"from": "human", "value": "Hello."}, {"from": "gpt", "value": "Hi."},
         {"from": "human", "value": "See <image> here?"},
         {"from": "gpt", "value": "A square."}],
        [{"from": "human", "value": "Say hi."},
         {"from": "gpt", "value": "Hi."}],
        [{"from": "human", "value": "One <image> ok?"},
         {"from": "gpt", "value": "A square."},
         {"from": "human", "value": "Two <image> ok?"},
         {"from": "gpt", "value": "Another."}]]
    recs = [{"image": "a.png", "conversations": c} for c in convs]
    del recs[2]["image"]
    with open(tmp_path / "mmu.json", "w") as f:
        json.dump(recs, f)
    return str(tmp_path / "t2i.jsonl"), str(tmp_path / "mmu.json")


def _datasets(tmp_path):
    t2i, mmu = _data(tmp_path)
    tok = FakeQwenTokenizer()
    kw = dict(resolution=16, num_image_tokens=N_IMG, max_seq_len=SEQ)
    return (ImageTextDataset(t2i, tok, FAKE_TOKEN_IDS, max_text_len=8,
                             cond_dropout_prob=0.0, **kw),
            MMUDataset(mmu, str(tmp_path), tok, FAKE_TOKEN_IDS, **kw))


def test_concat_batches_vs_jax(tmp_path):
    t2i_ds, mmu_ds = _datasets(tmp_path)
    t2i = tloader.default_collate([t2i_ds[0], t2i_ds[1]])
    mmu = tloader.default_collate([mmu_ds[0], mmu_ds[1]])
    with pytest.raises(KeyError, match="texts"):
        jmixed._concat_batches([t2i, mmu])
    got = tmixed._concat_batches([t2i, mmu])
    assert set(got) == set(t2i) - {"texts"} >= set(t1.BATCH_KEYS) - {"is_und"}
    assert got["data_type"].tolist() == ["t2i", "t2i", "mmu", "mmu"]
    # the same keys: JAX's output, key for key
    for batches in ([mmu, mmu], [t2i, t2i]):
        want = jmixed._concat_batches(batches)
        got = tmixed._concat_batches(batches)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    # a text-only record first: its keys (no images) in both collates
    for collate in (tloader.default_collate, jloader.default_collate):
        assert "images" not in collate([mmu_ds[2], mmu_ds[0]])
    # where JAX raises, the port raises the same error type
    for samples, err in (([mmu_ds[0], mmu_ds[2]], KeyError),
                         ([mmu_ds[0], mmu_ds[3]], ValueError)):
        for collate in (tloader.default_collate, jloader.default_collate):
            with pytest.raises(err):
                collate(samples)
    two = tloader.default_collate([mmu_ds[3], mmu_ds[3]])
    assert two["modality_positions"].shape == (2, 2, 2)
    for concat in (tmixed._concat_batches, jmixed._concat_batches):
        with pytest.raises(ValueError):
            concat([t2i, two])


def _stage2_step_vs_jax(tmp_path, route, frozen):
    jcfg, tcfg = _cfgs()
    params = showo2_params(jcfg)
    vae_params = _vae_params(VAE_TINY)
    t2i_ds, mmu_ds = _datasets(tmp_path)
    batch = tmixed._concat_batches([
        tloader.default_collate([t2i_ds[0], t2i_ds[1]]),
        tloader.default_collate([mmu_ds[0], mmu_ds[1]])])
    model = _port_model(tcfg, jcfg, params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    vae = _port_vae(VAE_TINY, vae_params).requires_grad_(False)
    transport = ttr.Transport(snr_type="lognorm", do_shift=True,
                              seq_len=N_IMG)
    lrs = dict(lr_und=1e-4, lr_fusion=3e-4, lr_main=2e-5)
    sc = t2.Stage2Config(attn_impl=route, **lrs)
    trainer = t2.Stage2Trainer(model=model, vae=vae, sc=sc,
                               transport=transport, frozen_substrings=frozen)
    tbatch = trainer.device_batch(batch)
    assert tbatch["is_und"].tolist() == [0, 0, 1, 1]

    jsc = JStage2Config(attn_impl="pallas_trainable" if route == "trainable"
                        else "dense", **lrs)
    jtransport = jtr.Transport(snr_type="lognorm", do_shift=True,
                               seq_len=N_IMG)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = make_stage2_optimizer(jsc, jparams, tuple(JAX_FROZEN.get(s, s)
                                                     for s in frozen))
    step = make_stage1_step(jcfg, VAE_TINY, jsc, jtransport, jopt)
    key = jax.random.PRNGKey(7)
    jbatch = {k: np.asarray(v.numpy()) for k, v in tbatch.items()}
    new_params, _, want = step(jparams, jopt.init(jparams),
                               jax.tree.map(jnp.asarray, vae_params),
                               {k: jnp.asarray(v) for k, v in jbatch.items()},
                               key)
    with torch.no_grad():
        lat = twan.wan_encode(vae, tbatch["images"].permute(0, 3, 1, 2)[
            :, :, None], deterministic=True).shape
    got = trainer.train_step(batch, noise=_jax_draws(
        key, jbatch, jtransport, jsc, lat[:2] + lat[3:]))
    for name in ("loss", "loss_ntp", "loss_flow"):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    assert got["loss_ntp"].item() > 0
    if not frozen:
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(want["grad_norm"]), rtol=2e-3)
    sd = _port_sd(jcfg, new_params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), sd[name], rtol=0, atol=1e-5,
                                   err_msg=name)
        if any(s in name for s in frozen):
            assert torch.equal(p, before[name]), name


@pytest.mark.parametrize("route", ["dense", "trainable"])
@pytest.mark.parametrize("frozen", [STAGE2A_FROZEN, ()],
                         ids=["stage2a_freeze", "every_weight"])
def test_stage2_step_on_conversations_vs_jax(tmp_path, route, frozen):
    _stage2_step_vs_jax(tmp_path, route, frozen)


def test_cli_annotation_path_trains_saves_and_resumes(tmp_path):
    t2i, mmu = _data(tmp_path)
    # the first two records: one image each
    with open(mmu) as f:
        recs = json.load(f)[:2]
    with open(mmu, "w") as f:
        json.dump(recs, f)
    cfg = os.path.join(REPO, "configs", "showo2_1.5b_stage_2_a.yaml")
    out = tmp_path / "out"
    args = [f"config={cfg}", *CLI_TINY,
            f"dataset.preprocessing.max_seq_length={SEQ}",
            f"dataset.params.t2i_jsonl={t2i}",
            f"dataset.params.annotation_path={mmu}",
            f"dataset.params.mmu_image_root={tmp_path}",
            "dataset.params.mmu_jsonl=null",
            f"experiment.output_dir={out}", "experiment.generate_every=null",
            "model.frozen_params=[]"]
    first = t2.main(args + ["training.max_train_steps=2"])
    assert first.global_step == 2
    assert sorted(os.listdir(out / "checkpoint-2")) == [
        "loader_state.json", "metadata.json", "state.pt"]
    with open(out / "checkpoint-2" / "loader_state.json") as f:
        state = json.load(f)
    assert [s["batches_yielded"] for s in state["loaders"]] == [2, 2]
    resumed = t2.main(args + ["training.max_train_steps=3"])
    assert resumed.global_step == 3 and resumed.optimizer.steps == 3
    unbroken = t2.main([a.replace(str(out), str(tmp_path / "u"))
                        for a in args] + ["training.max_train_steps=3",
                                          "experiment.save_every=null"])
    for (n, a), b in zip(resumed.model.state_dict().items(),
                         unbroken.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)
