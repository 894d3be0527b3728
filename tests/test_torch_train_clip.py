"""The v1 CLIP-ViT trainer of showo_tpu_torch against the JAX package, fp32
on the CPU, at tests/test_train_clip.py's tiny shapes (Phi 2 x 64, MAGVIT
16 codes, a CLIP-ViT of 2 layers x 32 with 4 patches, 4 system tokens).

* One ``FusedClipTrainStep`` against ``make_fused_clip_train_step``, the
  weights carried across by the exporters (``utils/torch_export.py``,
  ``utils/convert.py``) and JAX's corruption draws handed in: the losses
  and the masking rate at rtol 2e-4, every weight after the step at atol
  1e-5 (``mm_projector`` at twice the base rate, each group clipped by its
  own norm).
* ``max_grad_norm: null`` (the four CLIP configs' setting): the port does
  not clip, and its step equals JAX's at a norm no gradient reaches;
  JAX's own optimizer raises TypeError at null.
* The route: anything but ``dense`` raises ValueError.
* The CLI on the fixture of tests/test_trainer_clis.py (tar shards, a
  parquet file, LLaVA conversations): two steps and a checkpoint, then a
  resume from ``latest`` to step 4; then ``llava_pretrain`` (no system
  prompt) from scratch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import clip_vit as jcv
from showo_tpu.models import magvit as jmv
from showo_tpu.models import showo as jshowo
from showo_tpu.models.phi import PhiConfig as JPhiConfig
from showo_tpu.sampling.schedules import cosine_schedule as j_cosine
from showo_tpu.training.train_showo_clip import (
    make_fused_clip_train_step as j_step,
    make_projector_lr_optimizer as j_opt,
)
from showo_tpu.training.train_step import TrainConfig as JTrainConfig
from showo_tpu.training.train_step import TrainState
from showo_tpu.utils.torch_export import showo_state_dict
from showo_tpu_torch.models import clip_vit as tcv
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.models.phi import PhiConfig
from showo_tpu_torch.sampling.schedules import cosine_schedule
from showo_tpu_torch.training import train_showo_clip as tclip
from showo_tpu_torch.training.train_step import TrainConfig
from showo_tpu_torch.utils.convert import (clip_vit_state_dict, load_clip_vit,
                                           load_magvit, load_showo,
                                           magvit_state_dict)

from test_trainer_clis import clip_cfg  # noqa: F401  (the CLI fixture)
from test_torch_training import _jax_draws

torch.set_num_threads(1)

VQ_DIMS = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
               dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 1), z_channels=4)
CLIP_DIMS = dict(hidden_size=32, intermediate_size=64, num_heads=4,
                 num_layers=2, image_size=32, patch_size=16)
PHI_DIMS = dict(vocab_size=1027, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4)
SHOWO_DIMS = dict(vocab_size=1027, llm_vocab_size=1010,
                  num_new_special_tokens=0, codebook_size=16,
                  num_vq_tokens=16, w_clip_vit=True)
SP = {"<|pad|>": 1002, "<|soi|>": 1003, "<|eoi|>": 1004, "<|mmu|>": 1005}
SYSTEM = 4
MAX_SEQ = 8


def _inputs(seed=0):
    """tests/test_train_clip.py's batch: 2 t2i rows of 9 text ids, 2 lm
    rows of 27, 2 mmu rows [mmu][system x 4][soi][eoi] + 6 ids."""
    rng = np.random.default_rng(seed)
    t2i_pixels = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t2i_text = rng.integers(2, 900, size=(2, 9))
    lm_ids = rng.integers(2, 900, size=(2, 27))
    lm_labels = np.where(lm_ids > 100, lm_ids, -100)
    clip_pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    mmu_ids = np.concatenate([
        np.full((2, 1), SP["<|mmu|>"]), rng.integers(2, 900, size=(2, 4)),
        np.full((2, 1), SP["<|soi|>"]), np.full((2, 1), SP["<|eoi|>"]),
        rng.integers(2, 900, size=(2, 6))], axis=1)
    mmu_labels = np.where(mmu_ids > 100, mmu_ids, -100)
    return (t2i_pixels, t2i_text, lm_ids, lm_labels, clip_pixels, mmu_ids,
            mmu_labels)


def _models():
    """(JAX params, VQ params, CLIP params; the port's Show-o, MAGVIT and
    CLIP tower with the same weights)."""
    jcfg = jshowo.ShowoConfig(**SHOWO_DIMS, llm=JPhiConfig(**PHI_DIMS))
    params = jshowo.init_showo_params(jcfg, jax.random.PRNGKey(0))
    params["mm_projector"] = {
        "fc1": {"kernel": jax.random.normal(jax.random.PRNGKey(1), (32, 64))
                * 0.02, "bias": jnp.zeros((64,))},
        "fc2": {"kernel": jax.random.normal(jax.random.PRNGKey(2), (64, 64))
                * 0.02, "bias": jnp.zeros((64,))}}
    jvq = jmv.VQConfig(**VQ_DIMS)
    vq_params = jmv.MagvitV2(jvq).init(jax.random.PRNGKey(1),
                                       jnp.zeros((1, 8, 8, 3)))["params"]
    clip_params = jcv.init_clip_vit_params(jcv.ClipVitConfig(**CLIP_DIMS),
                                           jax.random.PRNGKey(3))
    tcfg = tshowo.ShowoConfig(**SHOWO_DIMS, clip_feat_dim=32,
                              llm=PhiConfig(**PHI_DIMS))
    model = load_showo(tshowo.Showo(tcfg), showo_state_dict(
        params, PHI_DIMS["num_layers"])).train().requires_grad_(True)
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, jvq)).eval()
    clip = load_clip_vit(tcv.ClipVisionTower(tcv.ClipVitConfig(**CLIP_DIMS)),
                         clip_vit_state_dict(clip_params, 2))
    return (jcfg, params, vq_params, clip_params, model,
            vq.requires_grad_(False), clip.eval().requires_grad_(False))


def _step_vs_jax(jax_norm, port_norm, eps=1e-8):
    """One step of each; JAX's optimizer clips at ``jax_norm``, the port's
    at ``port_norm``, both with AdamW's ``eps``.  Returns the port's
    metrics."""
    jcfg, params, vq_params, clip_params, model, vq, clip = _models()
    arrays = _inputs()
    jtc = JTrainConfig(max_seq_length=MAX_SEQ, max_grad_norm=jax_norm,
                       adam_eps=eps)
    jopt = j_opt(jtc, params)
    step = j_step(jcfg, jmv.VQConfig(**VQ_DIMS),
                  jcv.ClipVitConfig(**CLIP_DIMS), jtc, jopt, SP, 2, 2, 2,
                  j_cosine, system_prompt_len=SYSTEM)
    state = TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(0)
    state, want = step(state, vq_params, clip_params,
                       *map(jnp.asarray, arrays), key)

    tc = TrainConfig(max_seq_length=MAX_SEQ, max_grad_norm=port_norm,
                     adam_eps=eps)
    opt = tclip.make_projector_lr_optimizer(tc, model)
    tstep = tclip.FusedClipTrainStep(model, vq, clip, tc, opt, SP, 2, 2, 2,
                                     cosine_schedule,
                                     system_prompt_len=SYSTEM)
    k_corrupt, = jax.random.split(key, 1)
    noise = {k: torch.tensor(np.asarray(v)) for k, v in _jax_draws(
        k_corrupt, 2, SHOWO_DIMS["num_vq_tokens"], 16).items()}
    got = tstep(*[torch.as_tensor(a) for a in arrays], noise=noise)
    for name in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "masking_rate"):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, err_msg=name)
    sd = showo_state_dict(state.params, PHI_DIMS["num_layers"])
    assert set(sd) == set(model.state_dict())
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), sd[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    return got


def test_clip_step_vs_jax():
    got = _step_vs_jax(1.0, 1.0)
    assert got["grad_norm"].item() > 0


def test_max_grad_norm_null_is_no_clipping():
    """JAX's own optimizer cannot take the configs' ``max_grad_norm:
    null``; the port's takes it as no clipping, which is JAX's step at a
    norm that no gradient reaches.  Unclipped, the gradient of the key
    LayerNorm's bias (0 in exact arithmetic: softmax does not see a shift
    of every key) is rounding of ~1e-9, which AdamW's first step at eps
    1e-8 turns into a move of up to the learning rate in either
    direction, in each package its own; at eps 1e-6 (both packages) such
    a move is ~1e-7, while the real gradients still move their weights by
    about the learning rate."""
    jcfg, params, *_ = _models()
    jopt = j_opt(JTrainConfig(max_seq_length=MAX_SEQ, max_grad_norm=None),
                 params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    with pytest.raises(TypeError):
        jopt.update(zeros, jopt.init(params), params)
    got = _step_vs_jax(1e9, None, eps=1e-6)
    assert got["grad_norm"].item() < 1e9


def test_only_the_dense_route_trains():
    *_, model, vq, clip = _models()
    tc = TrainConfig(max_seq_length=MAX_SEQ, attn_impl="trainable")
    with pytest.raises(ValueError, match="dense route only"):
        tclip.FusedClipTrainStep(
            model, vq, clip, tc, tclip.make_projector_lr_optimizer(tc, model),
            SP, 2, 2, 2, cosine_schedule, system_prompt_len=SYSTEM)


def test_mmu_clip_block_vs_jax():
    """The LLaVA batch's [mmu][system][soi][eoi] text blocks, row for row,
    with rows and system prompts longer and shorter than their widths."""
    from types import SimpleNamespace

    from showo_tpu.training.train_showo_clip import ClipShowoTrainer as J

    rng = np.random.default_rng(3)
    batch = {"input_ids": [rng.integers(5, 900, size=n) for n in (3, 20)],
             "labels": [rng.integers(-100, 900, size=n) for n in (3, 20)],
             "input_ids_system": [rng.integers(5, 900, size=n)
                                  for n in (2, 9)]}
    host = SimpleNamespace(uni_prompting=SimpleNamespace(sptids=dict(
        SP, **{"<|mmu|>": 1005})), system_prompt_len=6, mmu_text_len=11)
    for got, want in zip(tclip.ClipShowoTrainer.mmu_clip_block(host, batch),
                         J.mmu_clip_block(host, batch)):
        np.testing.assert_array_equal(got, want)


CLI_TINY = [
    "device=cpu",
    "model.showo.phi={hidden_size: 64, intermediate_size: 128, "
    "num_layers: 2, num_heads: 4}",
    "model.vq_model.dims={ch: 32, enc_ch_mult: [1, 2], "
    "enc_num_res_blocks: [1, 1], dec_ch_mult: [1, 2], "
    "dec_num_res_blocks: [1, 1], z_channels: 4}",
    "model.showo.clip_vit={hidden_size: 32, intermediate_size: 64, "
    "num_heads: 4, num_layers: 2, image_size: 32, patch_size: 16}",
]


def test_clip_cli_train_and_resume(clip_cfg):  # noqa: F811
    """Two steps and checkpoint-2 (the loaders' states and the config
    snapshot beside it), then a resume from ``latest`` to step 4; then
    ``llava_pretrain`` in a new directory: no system prompt, the caption
    rows' labels on the caption."""
    from showo_tpu_torch.data.llava import SYSTEM_PROMPT

    cfg, tmp_path = clip_cfg
    out = tmp_path / "out_clip"
    first = tclip.main([f"config={cfg}", *CLI_TINY])
    # the word-hash stand-in tokenizer: one id a word
    assert first.global_step == 2
    assert first.system_prompt_len == len(SYSTEM_PROMPT.split())
    assert first.step_fn.autocast_dtype is None
    assert {"t2i_state.json", "lm_state.json", "mmu_state.json",
            "state.pt"} <= set(os.listdir(out / "checkpoint-2"))
    assert (out / "config.yaml").exists()
    resumed = tclip.main([f"config={cfg}", *CLI_TINY,
                          "training.max_train_steps=4"])
    assert resumed.global_step == 4 and resumed.optimizer.steps == 4
    assert "checkpoint-4" in os.listdir(out)
    pre = tclip.main([f"config={cfg}", *CLI_TINY,
                      "dataset.und_type=llava_pretrain",
                      f"experiment.output_dir={tmp_path / 'out_pre'}"])
    assert pre.global_step == 2 and pre.system_prompt_len == 0
    assert all(torch.isfinite(p).all() for p in pre.model.parameters())
