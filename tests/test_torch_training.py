"""showo_tpu_torch stage-1 training vs the JAX package, fp32 on the CPU.

* corruption with JAX's own draws handed to the port: tokens and labels
  exact;
* the LR schedules against the reference golden (atol 1e-7, rtol 1e-5,
  as tests/test_lr_schedules.py) and the JAX functions;
* ``cross_entropy_ignore`` / ``showo_losses`` against JAX (rtol 1e-5);
* the slice as a whole: one fused step of a 2-layer model (hidden 128,
  2 heads of 64) with the tiny MAGVIT of tests/test_train_showo.py, on
  the dense and the trainable route, against JAX ``make_fused_train_step``
  fed the same weights, pixels, text and corruption draws: loss parts at
  rtol 2e-4, grad norm at rtol 2e-3 (as tests/test_train_showo.py holds
  its routes to each other), the parameters after the AdamW update at
  atol 1e-5; the same under ``train_v1_fast``'s adafactor, remat
  ``qkv_attn`` and bf16 softmax;
* the trainer built from the stage-1 config at tiny widths: three steps
  on one batch lower the loss, gradient accumulation steps the optimizer
  every k calls, and the entry points refuse to fall back to the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from showo_tpu.models import magvit as jmv
from showo_tpu.models import showo as jshowo
from showo_tpu.models.phi import PhiConfig as JPhiConfig
from showo_tpu.prompting import UniversalPrompting as JaxPrompting
from showo_tpu.sampling.schedules import cosine_schedule as j_cosine
from showo_tpu.training import corruption as jcorr
from showo_tpu.training.lr_schedules import get_lr_schedule as j_lr
from showo_tpu.training.train_showo import make_fused_train_step as j_step
from showo_tpu.training.train_step import TrainConfig as JTrainConfig
from showo_tpu.training.train_step import TrainState, make_optimizer
from showo_tpu.utils.torch_export import showo_state_dict
from showo_tpu_torch.config import load_config
from showo_tpu_torch.models import magvit as tmv
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.models.phi import PhiConfig
from showo_tpu_torch.sampling.schedules import cosine_schedule
from showo_tpu_torch.training import corruption as tcorr
from showo_tpu_torch.training import train_showo as ttrain
from showo_tpu_torch.training.lr_schedules import get_lr_schedule
from showo_tpu_torch.training.optim import jax_tensors
from showo_tpu_torch.training.train_step import Optimizer, TrainConfig
from showo_tpu_torch.utils.convert import (load_magvit, load_showo,
                                           magvit_state_dict)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fake_tokenizer as jfake  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQ_DIMS = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
               dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 1), z_channels=4)
PHI_DIMS = dict(vocab_size=1027, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=2)
SHOWO_DIMS = dict(vocab_size=1027, llm_vocab_size=1010,
                  num_new_special_tokens=0, codebook_size=16,
                  num_vq_tokens=16)
MAX_SEQ = 8


# ---------------------------------------------------------------------------
# corruption
# ---------------------------------------------------------------------------

def _jax_draws(key, B, S, codebook_size):
    """The draws JAX's mask_or_random_replace_tokens takes from ``key``."""
    k_t, k_perm, _, _, k_replace = jax.random.split(key, 5)
    return {"timesteps": jax.random.uniform(k_t, (B,)),
            "uniforms": jax.random.uniform(k_perm, (B, S)),
            "replace_tokens": jax.random.randint(k_replace, (B, S), 0,
                                                 codebook_size)}


@pytest.mark.parametrize("noise_type,predict_all,min_rate", [
    ("mask", False, 0.0), ("mask", True, 0.3), ("random_replace", False, 0.0),
    ("random_replace", True, 0.5)])
def test_corruption_vs_jax(noise_type, predict_all, min_rate):
    B, S, mask_id, cb = 4, 64, 99, 32
    tokens = np.random.default_rng(0).integers(0, cb, size=(B, S))
    key = jax.random.PRNGKey(3)
    kw = dict(min_masking_rate=min_rate, noise_type=noise_type,
              predict_all_tokens=predict_all, codebook_size=cb)
    want = jcorr.mask_or_random_replace_tokens(key, jnp.asarray(tokens),
                                               mask_id, j_cosine, **kw)
    draws = {k: torch.tensor(np.asarray(v))
             for k, v in _jax_draws(key, B, S, cb).items()}
    got = tcorr.mask_or_random_replace_tokens(
        torch.as_tensor(tokens), mask_id, cosine_schedule, **draws, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6)
    if predict_all:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6)
    else:
        assert got[2] is None and want[2] is None


def test_corruption_draws_from_the_generator():
    tokens = torch.arange(32).reshape(2, 16)
    outs = [tcorr.mask_or_random_replace_tokens(
        tokens, 99, cosine_schedule,
        generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    # contiguous regions (ported since): at probability 1 every row masks
    # one rectangle of its 4 x 4 grid, drawn from the generator too
    rect = [tcorr.mask_or_random_replace_tokens(
        tokens, 99, cosine_schedule, mask_contiguous_region_prob=1.0,
        generator=torch.Generator().manual_seed(s))[0] for s in (1, 1)]
    assert torch.equal(rect[0], rect[1])
    for row in (rect[0] == 99).reshape(2, 4, 4):
        r, c = row.any(1).nonzero().flatten(), row.any(0).nonzero().flatten()
        assert row.sum() == len(r) * len(c)
        assert row[r.min():r.max() + 1, c.min():c.max() + 1].all()


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

LR_CASES = [
    ("constant", {}),
    ("constant_with_warmup", dict(num_warmup_steps=10)),
    ("linear", dict(num_warmup_steps=10, num_training_steps=100)),
    ("cosine", dict(num_warmup_steps=10, num_training_steps=100)),
    ("cosine_with_restarts", dict(num_warmup_steps=10,
                                  num_training_steps=100, num_cycles=3)),
    ("polynomial", dict(num_warmup_steps=10, num_training_steps=100,
                        power=2.0)),
]


@pytest.mark.parametrize("name,kw", LR_CASES)
def test_lr_schedule_golden_and_jax(name, kw):
    golden = np.load(os.path.join(REPO, "tests", "golden",
                                  "lr_schedules.npz"))
    fn, jfn = get_lr_schedule(name, 0.1, **kw), j_lr(name, 0.1, **kw)
    steps = [int(s) for s in golden["steps"]] + [0, 5, 99, 100, 150]
    got = np.asarray([fn(s) for s in steps])
    np.testing.assert_allclose(got[:len(golden["steps"])], golden[name],
                               atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(got, [float(jfn(s)) for s in steps],
                               atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_cross_entropy_ignore_vs_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 7))
    labels[rng.random((3, 7)) < 0.4] = -100
    want = jshowo.cross_entropy_ignore(jnp.asarray(logits),
                                       jnp.asarray(labels))
    got = tshowo.cross_entropy_ignore(torch.tensor(logits),
                                      torch.tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    none = torch.full((3, 7), -100)
    assert tshowo.cross_entropy_ignore(torch.tensor(logits), none) == 0


def _configs(attn_fp32=True):
    jcfg = jshowo.ShowoConfig(**SHOWO_DIMS, llm=JPhiConfig(
        **PHI_DIMS, attn_fp32=attn_fp32))
    tcfg = tshowo.ShowoConfig(**SHOWO_DIMS, llm=PhiConfig(
        **PHI_DIMS, attn_fp32=attn_fp32))
    return jcfg, tcfg


def _models(seed=0, attn_fp32=True):
    """(JAX params, port Show-o with the same weights, fp32, trainable)."""
    jcfg, tcfg = _configs(attn_fp32)
    params = jshowo.init_showo_params(jcfg, jax.random.PRNGKey(seed))
    model = load_showo(tshowo.Showo(tcfg), showo_state_dict(
        params, jcfg.llm.num_layers))
    return params, model.train().requires_grad_(True)


def test_showo_losses_vs_jax():
    jcfg, _ = _configs()
    params, model = _models(seed=2)
    rng = np.random.default_rng(2)
    B, L = 6, 2 * MAX_SEQ + 3
    ids = rng.integers(0, 1010, size=(B, L))
    labels = np.where(rng.random((B, L)) < 0.3, -100, ids)
    bias = np.where(np.tril(np.ones((L, L), bool)), 0.0, -1e9).astype(
        np.float32)[None, None].repeat(B, 0)
    want = jshowo.showo_losses(jcfg, params, jnp.asarray(ids),
                               jnp.asarray(labels), jnp.asarray(bias), 2, 2,
                               2, max_seq_length=MAX_SEQ)
    with torch.no_grad():
        got = tshowo.showo_losses(model, torch.as_tensor(ids),
                                  torch.as_tensor(labels), torch.tensor(bias),
                                  2, 2, 2, max_seq_length=MAX_SEQ)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


# ---------------------------------------------------------------------------
# one fused step, port vs JAX
# ---------------------------------------------------------------------------

TEXTS_T2I = ["a cat", "a red dog on a hill"]
TEXTS_MMU = ["describe it", "what is it in the picture"]
TEXTS_LM = ["language modeling text", "another document"]


def _host_batch(seed=0):
    """Host arrays of one stage-1 batch (2 + 2 + 2 rows), made with the
    JAX package's prompting (held to the port's by test_torch_host)."""
    uni = JaxPrompting(jfake.FakeTokenizer(), max_text_len=MAX_SEQ,
                       cond_dropout_prob=0.0)
    rng = np.random.default_rng(seed)
    t2i_text = uni.t2i_text_block(TEXTS_T2I)
    L = t2i_text.shape[1] + SHOWO_DIMS["num_vq_tokens"] + 2
    lm_ids, _, lm_labels = uni.lm_prompt(
        uni.text_tokenizer(TEXTS_LM)["input_ids"], L)
    mmu_text, mmu_labels = uni.mmu_text_block(TEXTS_MMU)
    pixels = [rng.uniform(-1, 1, size=(2, 8, 8, 3)).astype(np.float32)
              for _ in range(2)]
    return (pixels[0], t2i_text, lm_ids, lm_labels, pixels[1], mmu_text,
            mmu_labels), uni.sptids


@pytest.mark.parametrize("route", ["dense", "trainable"])
def test_fused_step_vs_jax(route):
    _fused_step_vs_jax(route)


def test_fused_step_past_the_packed_budget_vs_jax():
    """The trainable route past the packed trainable budget (set to 0 in
    both packages, as the 512x512 rows are at full width): every layer's
    attention goes through the K-blocked trainable kernels (kernel 8) in
    both, JAX's in interpret mode with 8 x 8 blocks.  Same tolerances as
    test_fused_step_vs_jax; a spy shows that the port's step called
    ``omni_attention_trainable`` for each layer in the forward and in the
    remat recompute."""
    from unittest import mock

    from showo_tpu.ops import packed_attention_grad as jpag
    from showo_tpu.ops import streaming_attention_grad as jsag
    from showo_tpu_torch.ops import packed_attention_grad as tpag

    orig = jsag.omni_attention_trainable

    def interp(*a, **kw):
        kw.update(interpret=True, block_q=8, block_k=8)
        return orig(*a, **kw)

    with mock.patch.object(jpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(jsag, "omni_attention_trainable", interp), \
            mock.patch.object(tpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(tpag, "omni_attention_trainable",
                              wraps=tpag.omni_attention_trainable) as spy:
        _fused_step_vs_jax("trainable")
    assert spy.call_count == 2 * PHI_DIMS["num_layers"]


def test_fused_step_adafactor_qkv_attn_bf16_softmax_vs_jax():
    """``train_v1_fast``'s modes: one fused step under adafactor, remat
    ``qkv_attn`` and the bf16 softmax (``attn_fp32=False``) against JAX's
    with the same, at the limits above, at learning rate 1e-3 so that the
    learning-rate part of adafactor's update (~2e-5 on weights of RMS
    0.02) stands above the weights' limit beside the decay, while a
    zero-initialised tensor whose gradient is 0 but for rounding (a key
    bias: softmax is blind to it), which adafactor normalises to +-1 with
    either sign, moves by lr * 1e-3 = 1e-6, within it; the port steps the
    JAX package's tensors (``jax_tensors``), shape for shape."""
    _, (port, want) = _fused_step_vs_jax("dense", "adafactor", "qkv_attn",
                                         attn_fp32=False, lr=1e-3)
    assert port == want


def _fused_step_vs_jax(route, optimizer="adamw", remat="full",
                       attn_fp32=True, lr=1e-4):
    """One fused step of the port against JAX's on ``route`` under
    ``optimizer`` and ``remat`` (the port's optimizer on the JAX package's
    tensors, ``training/optim.py::jax_tensors``): loss parts, grad norm,
    masking rate and the weights after the update.  Returns the port's
    model and its tensors' shapes beside JAX's parameter shapes."""
    jcfg, _ = _configs(attn_fp32)
    jvq_cfg = jmv.VQConfig(**VQ_DIMS)
    arrays, sp = _host_batch()
    params, model = _models(attn_fp32=attn_fp32)
    vq_params = jmv.MagvitV2(jvq_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"]
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**VQ_DIMS)),
                     magvit_state_dict(vq_params, jvq_cfg)).eval()
    vq.requires_grad_(False)

    jtc = JTrainConfig(max_seq_length=MAX_SEQ, learning_rate=lr,
                       attn_impl="pallas_trainable" if route == "trainable"
                       else "dense", remat=remat, optimizer=optimizer)
    jopt = make_optimizer(jtc)
    step = j_step(jcfg, jvq_cfg, jtc, jopt, sp, 2, 2, 2, j_cosine)
    state = TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(7)
    state, want = step(state, vq_params, *map(jnp.asarray, arrays), key)

    tc = TrainConfig(max_seq_length=MAX_SEQ, learning_rate=lr,
                     attn_impl=route, remat=remat, optimizer=optimizer)
    opt = Optimizer(model.parameters(), tc, tensors=jax_tensors(model))
    tstep = ttrain.FusedTrainStep(model, vq, tc, opt, sp, 2, 2, 2,
                                  cosine_schedule)
    k_corrupt, = jax.random.split(key, 1)
    noise = {k: torch.tensor(np.asarray(v)) for k, v in _jax_draws(
        k_corrupt, 2, SHOWO_DIMS["num_vq_tokens"], 16).items()}
    inputs = [torch.as_tensor(a) for a in arrays]
    # the codes the port's MAGVIT gives must be JAX's for the rest to agree
    jcodes = jmv.MagvitV2(jvq_cfg).apply({"params": vq_params},
                                         jnp.asarray(arrays[0]),
                                         method="get_code")
    np.testing.assert_array_equal(vq.get_code(inputs[0]).numpy(),
                                  np.asarray(jcodes))
    got = tstep(*inputs, noise=noise)

    for name in ("loss", "loss_t2i", "loss_lm", "loss_mmu"):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(got["grad_norm"].item(),
                               float(want["grad_norm"]), rtol=2e-3)
    np.testing.assert_allclose(got["masking_rate"].item(),
                               float(want["masking_rate"]), rtol=1e-6)
    sd = showo_state_dict(state.params, jcfg.llm.num_layers)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), sd[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    return model, (sorted(t.shape for t in jax_tensors(model)),
                   sorted(x.shape for x in jax.tree.leaves(params)))


def test_trainable_batch_metadata_reproduces_dense_masks():
    """The trainable route's three metadata sets (t2i rm-pad, lm
    pads-visible, mmu batch-first-eoi prefix) give exactly the dense
    route's biases."""
    from showo_tpu_torch.ops.flash_attention import visible_mask

    arrays, sp = _host_batch()
    _, model = _models()
    vq = tmv.init_magvit(tmv.VQConfig(**VQ_DIMS), torch.Generator()
                         .manual_seed(0))
    inputs = [torch.as_tensor(a) for a in arrays]
    noise = {"timesteps": torch.full((2,), 0.5),
             "uniforms": torch.rand(2, 16, generator=torch.Generator()
                                    .manual_seed(1))}
    batches = {}
    for route in ("dense", "trainable"):
        tc = TrainConfig(max_seq_length=MAX_SEQ, attn_impl=route)
        step = ttrain.FusedTrainStep(
            model, vq, tc, Optimizer(model.parameters(), tc), sp, 2, 2, 2,
            cosine_schedule)
        batches[route] = step.prepare(*inputs, noise=noise)
    dense, meta = batches["dense"], batches["trainable"].attn_meta
    assert torch.equal(dense.input_ids, batches["trainable"].input_ids)
    B, L = dense.input_ids.shape
    vis = visible_mask(*meta[1:], torch.arange(L).expand(B, L))
    assert torch.equal(vis, dense.bias[:, 0] == 0)


# ---------------------------------------------------------------------------
# the trainer from the stage-1 config
# ---------------------------------------------------------------------------

STAGE1 = os.path.join(REPO, "configs", "showo_pretraining_stage1.yaml")
TINY = [
    "model.showo.num_vq_tokens=16", "model.showo.codebook_size=16",
    "dataset.preprocessing.max_seq_length=8",
    "model.showo.phi={hidden_size: 128, intermediate_size: 256, "
    "num_layers: 2, num_heads: 2}",
    "model.vq_model.dims={ch: 32, enc_ch_mult: [1, 2], "
    "enc_num_res_blocks: [1, 1], dec_ch_mult: [1, 2], "
    "dec_num_res_blocks: [1, 1], z_channels: 4}",
    "training.batch_size_t2i=2", "training.batch_size_lm=2",
    "training.batch_size_mmu=2", "lr_scheduler.params.warmup_steps=0",
    "optimizer.params.learning_rate=1e-3"]


def _stage1_config(*extra):
    return load_config(STAGE1, TINY + list(extra))


def _raw_batches(seed=0):
    rng = np.random.default_rng(seed)
    return ({"image": rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32),
             "text": TEXTS_T2I}, TEXTS_LM,
            {"image": rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32),
             "text": TEXTS_MMU})


FIXED_NOISE = {"timesteps": torch.tensor([0.3, 0.6]),
               "uniforms": torch.linspace(0, 1, 32).reshape(2, 16)}


@pytest.mark.parametrize("route", ["dense", "trainable"])
def test_three_steps_lower_the_loss(route):
    trainer = ttrain.build_trainer(_stage1_config(), device="cpu",
                                   attn_impl=route)
    assert trainer.tc.attn_impl == route and trainer.tc.remat == "full"
    batch = _raw_batches()
    losses = [trainer.train_step(*batch, noise=FIXED_NOISE)["loss"].item()
              for _ in range(3)]
    assert all(np.isfinite(losses)) and trainer.global_step == 3
    assert losses[2] < losses[1] < losses[0], losses


def test_grad_accumulation_steps_every_k_calls():
    """k=2: the first call leaves the weights, the second steps once; two
    calls on one batch give the weights of one k=1 step on it."""
    batch = _raw_batches(1)
    same = "training.cond_dropout_prob=0.0"    # the same text every call
    one = ttrain.build_trainer(_stage1_config(same), device="cpu")
    two = ttrain.build_trainer(_stage1_config(
        same, "training.gradient_accumulation_steps=2"), device="cpu")
    before = {k: v.clone() for k, v in two.model.state_dict().items()}
    one.train_step(*batch, noise=FIXED_NOISE)
    two.train_step(*batch, noise=FIXED_NOISE)
    assert two.optimizer.steps == 0
    for k, v in two.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    two.train_step(*batch, noise=FIXED_NOISE)
    assert two.optimizer.steps == 1 and one.optimizer.steps == 1
    want = one.model.state_dict()
    for k, v in two.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-6)


def test_trainer_refuses_inference_routes():
    with pytest.raises(ValueError, match="no backward"):
        ttrain.build_trainer(_stage1_config(), device="cpu",
                             attn_impl="packed")


def test_entry_points_run_on_the_card_unless_asked():
    """With no device, build_trainer and build_pipeline take CUDA and raise
    without a card; with ``device=cpu`` the CLI gets as far as the data
    loaders, which raise on the config's absent dataset folder.  The same
    for the CLIP-ViT trainer (its CLI stops at the LLaVA json) and the
    Show-o2 stage-2 CLI with ``annotation_path`` (read by MMUDataset)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from showo_tpu_torch import inference_t2i
    from showo_tpu_torch.show_o2 import train_stage_two
    from showo_tpu_torch.training import train_showo_clip

    config = _stage1_config()
    for build in (ttrain.build_trainer, inference_t2i.build_pipeline):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(config)
    argv = sys.argv
    sys.argv = ["train_showo", f"config={STAGE1}", *TINY, "device=cpu"]
    try:
        with pytest.raises(FileNotFoundError, match="/data/imagenet"):
            ttrain.main()
    finally:
        sys.argv = argv

    clip_args = [f"config={CLIP_CONFIG}", *TINY, "model.showo.clip_vit="
                 "{hidden_size: 32, intermediate_size: 64, num_heads: 4, "
                 "num_layers: 2, image_size: 32, patch_size: 16}"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_showo_clip.build_trainer(load_config(CLIP_CONFIG, clip_args[1:]))
    with pytest.raises(FileNotFoundError, match="llava_v1_5_mix665k"):
        train_showo_clip.main(clip_args + ["device=cpu"])

    from test_torch_show_o2_train import CLI_TINY

    stage2 = os.path.join(REPO, "configs", "showo2_1.5b_stage_2_a.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage_two.build_trainer(load_config(stage2, CLI_TINY[1:]))
    with pytest.raises(FileNotFoundError, match="blip_laion_cc_sbu_558k"):
        train_stage_two.main([f"config={stage2}", *CLI_TINY,
                              "dataset.params.t2i_jsonl=null"])


CLIP_CONFIG = os.path.join(REPO, "configs",
                           "showo_instruction_tuning_2_w_clip_vit.yaml")


def test_tuning512_trainer_takes_its_config():
    """``build_trainer`` takes the 512x512 instruction-tuning config as it
    is (``max_grad_norm: null``: no clipping; ``und_type:
    llava_pretrain``, read only by the data loaders) at tiny widths, with
    its 5 + 2 + 5 rows and the profiler's seeded batch; two steps on the
    trainable route past the (patched) packed budget run kernel 8's plain
    versions and lower the loss."""
    from unittest import mock

    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.profile_train import train_batch, tuning512_config

    config = tuning512_config(*[o for o in TINY if "batch_size" not in o],
                              "dataset.params.resolution=8")
    trainer = ttrain.build_trainer(config, device="cpu",
                                   attn_impl="trainable")
    assert trainer.tc.max_grad_norm is None
    assert trainer.step_fn.sizes == (5, 2, 5)
    batch, noise = train_batch(trainer)
    with mock.patch.object(tpag, "PACKED_TRAINABLE_MAX_BYTES", 0), \
            mock.patch.object(tpag, "omni_attention_trainable",
                              wraps=tpag.omni_attention_trainable) as spy:
        losses = [trainer.train_step(*batch, noise=noise)["loss"].item()
                  for _ in range(2)]
    assert spy.call_count == 2 * 2 * 2          # steps x layers x remat
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses
    rows = trainer.step_fn.prepare(*trainer.host_batch(*batch), noise=noise)
    assert tuple(rows.input_ids.shape) == (12, 8 + 3 + 16)


def test_max_size_cycle_zip_restarts_short_loaders():
    got = list(ttrain.max_size_cycle_zip([1, 2, 3], "ab", [9]))
    assert got == [(1, "a", 9), (2, "b", 9), (3, "a", 9)]


# ---------------------------------------------------------------------------
# the training diagnostics (training/metrics.py) and lfq_losses
# ---------------------------------------------------------------------------

def _metric_inputs(seed=4):
    rng = np.random.default_rng(seed)
    B, S, V = 6, 12, 17
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    labels = np.where(rng.random((B, S)) < 0.3, -100,
                      rng.integers(0, V, size=(B, S)))
    mask_id = V - 1
    ids = np.where(rng.random((B, S)) < np.linspace(0, 1, B)[:, None],
                   mask_id, rng.integers(0, V - 1, size=(B, S)))
    soft = rng.random((B, S - 1, V - 2)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    return logits, labels, ids, mask_id, soft, rng.random(B).astype(
        np.float32)


def test_metrics_vs_jax():
    """Every function of ``training/metrics.py`` against JAX's on the same
    inputs (masking rates from 0 to 1 over the rows, so that the buckets
    and an empty bucket show), rtol 1e-5."""
    from showo_tpu.training import metrics as jm
    from showo_tpu_torch.training import metrics as tm

    logits, labels, ids, mask_id, soft, rate = _metric_inputs()
    t = {k: torch.as_tensor(v) for k, v in dict(
        logits=logits, labels=labels, ids=ids, soft=soft, rate=rate).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    masked = ids == mask_id
    cases = [
        ("soft_target_cross_entropy", (t["logits"], t["labels"], t["soft"]),
         (j["logits"], j["labels"], j["soft"])),
        ("masked_bucket_cross_entropy", (t["logits"], t["labels"], t["rate"]),
         (j["logits"], j["labels"], j["rate"])),
        ("token_entropy", (t["logits"],), (j["logits"],)),
        ("token_entropy", (t["logits"], torch.as_tensor(masked)),
         (j["logits"], jnp.asarray(masked))),
        ("input_ids_to_masked_buckets", (t["ids"], mask_id),
         (j["ids"], mask_id)),
        ("average_by_buckets", (t["rate"], torch.tensor([0, 0, 3, 9, 3, 0])),
         (j["rate"], jnp.asarray([0, 0, 3, 9, 3, 0]))),
        ("pixel_entropy_per_percent_masked_bucket",
         (t["logits"], t["ids"], mask_id), (j["logits"], j["ids"], mask_id)),
        ("image_entropy_per_percent_masked_bucket",
         (t["logits"], t["ids"], mask_id), (j["logits"], j["ids"], mask_id)),
    ]
    for name, targs, jargs in cases:
        got, want = getattr(tm, name)(*targs), getattr(jm, name)(*jargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    buckets = tm.input_ids_to_masked_buckets(t["ids"], mask_id)
    assert len(set(buckets.tolist())) > 3
    grads = {"a": torch.as_tensor(soft[0]), "b/c": torch.as_tensor(rate)}
    got = tm.per_param_grad_norms(grads)
    want = jm.per_param_grad_norms({"a": jnp.asarray(soft[0]),
                                    "b/c": jnp.asarray(rate)})
    assert sorted(got) == sorted(want) == ["grad_norm/a", "grad_norm/b/c"]
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)


def test_lfq_losses_vs_jax():
    """``models/magvit.py::lfq_losses`` against JAX's: both losses (rtol
    1e-5) and their gradients with respect to z (the stop-gradients on
    each side of the commitment loss), rtol 1e-4."""
    rng = np.random.default_rng(6)
    z = (rng.normal(size=(40, 13)) * 1.5).astype(np.float32)
    want = jmv.lfq_losses(jnp.asarray(z))
    jgrad = jax.grad(lambda x: sum(jmv.lfq_losses(x).values()))(
        jnp.asarray(z))
    tz = torch.tensor(z, requires_grad=True)
    got = tmv.lfq_losses(tz)
    for k in ("entropy_loss", "commit_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    (got["entropy_loss"] + got["commit_loss"]).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-7)
