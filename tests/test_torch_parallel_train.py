"""Training steps sharded over ("dp", "fsdp", "tp") meshes of 8 gloo ranks.

JAX twins: ``tests/test_parallel_train.py::test_train_step_dp_fsdp_mesh``
/ ``test_fsdp_actually_shards`` (the v1 fused step at dp=2, fsdp=4),
``tests/test_parallel_train_v2.py`` and ``tests/test_parallel_showo2.py``
(Show-o2 stage 1, stage 2 with its three groups and a frozen tower, and
the mixed-modality step at (2, 2, 2)), the CLIP-ViT step (JAX's
``train_showo_clip.py::main`` shards its params; here at (2, 2, 2), the
step of ``tests/test_torch_train_clip.py``), and ``tests/test_multiprocess.py``
with ``tools/mp_worker.py`` (ranks agree, each rank builds only its rows,
rank 0 alone writes the checkpoint, whose ``embed`` is the single-process
step's).

Each step runs sharded on every rank (this rank's rows of a global batch,
the weights split by the rules of ``parallel/mesh.py``) and unsharded on
rank 0 over the whole batch, from the same weights and the same injected
draws; the sharded step is held to the unsharded one at fp32 round-off
(losses and grad norm rtol 1e-5; weights after AdamW atol 1e-5, the
step's normalisation of rounding-level gradients) and to JAX's step on
the same weights at the tolerances of the unsharded parity tests
(``tests/test_torch_training.py``, ``tests/test_torch_show_o2_train.py``:
losses rtol 2e-4, grad norm rtol 2e-3, weights atol 1e-5).  All cases run
in one group (``tests/_gloo_group.py``, 180 s wall-time limit) while this
process computes JAX's steps.  ``adamw_bf16`` and ``adafactor`` (their
state spans whole tensors) are held to their unsharded steps on both
meshes, and a sharded save and resume to an uninterrupted run.
"""

import copy
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from showo_tpu_torch.parallel import mesh as tmesh
from _gloo_group import start_group

WORLD = 8
B = 8                 # global rows of each task / sample kind
V1_MESHES = [(2, 4, 1), (2, 2, 2)]
V2_CASES = ["stage1", "stage2", "mixed"]
V1_KEYS = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm",
           "masking_rate")
V2_KEYS = ("loss", "loss_ntp", "loss_flow", "grad_norm")
# the optimizers whose state spans whole tensors, stepped on a tiny v1
# model sharded at the fsdp and the tp mesh: name -> (learning rate, atol
# of the weights against the unsharded steps).  Two steps move the weights
# by ~lr (adafactor: lr x the parameter RMS, ~0.02), well past the atol:
# fp32 round-off of the clip's and adafactor's sums over the mesh in other
# orders, and for adamw_bf16 a first moment rounding to the other bf16
# neighbour, which moves a weight by ~lr * 2^-8 at the second step
SHARDED_OPTS = {"adamw_bf16": (1e-3, 1e-5), "adafactor": (1e-2, 1e-6)}
OPT_PHI = dict(vocab_size=1027, hidden_size=128, intermediate_size=256,
               num_layers=2, num_heads=2)
OPT_STEPS = 2


def _v1_local(inp, info):
    """This rank's rows of the v1 global batch (each task's rows split
    over the data ranks) and of the corruption draws."""
    arrays = [torch.as_tensor(a) for a in inp["arrays"]]
    local = tmesh.shard_batch(arrays, info)
    noise = tmesh.shard_batch(inp["noise"], info)
    return local, noise


def _v1_step(inp, mesh=None):
    """(metrics, whole weights, the model) of one fused step."""
    from showo_tpu_torch.sampling.schedules import cosine_schedule
    from showo_tpu_torch.training.train_showo import FusedTrainStep
    from showo_tpu_torch.training.train_step import Optimizer, TrainConfig

    model = torch.load(inp["model"], weights_only=False)
    vq = torch.load(inp["vq"], weights_only=False)
    tc = TrainConfig(max_seq_length=inp["max_seq"], learning_rate=1e-4,
                     remat="none")
    arrays, noise, n = inp["arrays"], inp["noise"], B
    if mesh is not None:
        tmesh.shard_params(model, mesh)
        info = tmesh.mesh_of(model)
        arrays, noise = _v1_local(inp, info)
        n = B // info.data_world
    else:
        arrays = [torch.as_tensor(a) for a in arrays]
    opt = Optimizer(model.parameters(), tc)
    step = FusedTrainStep(model, vq, tc, opt, inp["sp"], n, n, n,
                          cosine_schedule)
    got = step(*arrays, noise=noise)
    return ({k: got[k].item() for k in V1_KEYS},
            tmesh.full_state_dict(model), model)


def _saved_bytes(inp, mesh):
    """The bytes autograd keeps for the backward of one v1 forward on
    ``mesh`` (each storage once; this rank's rows): {"reshard": as a step
    keeps them (a gathered weight kept as its shard), "held": every
    gathered weight kept whole, "linear": the bytes of the model's
    ``nn.Linear`` weights, whole}."""
    from unittest import mock

    from showo_tpu_torch.sampling.schedules import cosine_schedule
    from showo_tpu_torch.training.train_showo import FusedTrainStep
    from showo_tpu_torch.training.train_step import Optimizer, TrainConfig

    model = torch.load(inp["model"], weights_only=False)
    vq = torch.load(inp["vq"], weights_only=False)
    tc = TrainConfig(max_seq_length=inp["max_seq"], remat="none")
    tmesh.shard_params(model, mesh)
    info = tmesh.mesh_of(model)
    arrays, noise = _v1_local(inp, info)
    n = B // info.data_world
    step = FusedTrainStep(model, vq, tc, Optimizer(model.parameters(), tc),
                          inp["sp"], n, n, n, cosine_schedule)
    out = {"linear": sum(m.weight.numel() * m.weight.element_size()
                         for m in model.modules()
                         if isinstance(m, torch.nn.Linear))}
    for name, pack in (("reshard", tmesh._pack), ("held", lambda t: t)):
        seen = {}

        def counting(t, pack=pack):
            kept = pack(t)
            if torch.is_tensor(kept):
                st = kept.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            return kept

        with mock.patch.object(tmesh, "_pack", counting), \
                tmesh.use_mesh(info):
            step.loss_and_grads(step.prepare(*arrays, noise=noise))
        out[name] = sum(seen.values())
    return out


def _v2_step(inp, case, mesh=None):
    from showo_tpu_torch.show_o2 import train_stage_one as t1
    from showo_tpu_torch.show_o2 import train_stage_two as t2
    from showo_tpu_torch.show_o2.train_mixed_modality import MixedModalStep

    c = inp[case]
    model = torch.load(inp["v2_model"], weights_only=False)
    vae = torch.load(inp["vae"], weights_only=False).requires_grad_(False)
    if mesh is not None:
        tmesh.shard_params(model, mesh)
    sc = c["sc"]
    opt = (t2.make_stage2_optimizer(sc, model, c["frozen"])
           if case == "stage2"
           else t1.make_stage1_optimizer(sc, model, c["frozen"]))
    cls = MixedModalStep if case == "mixed" else t1.Stage1Step
    step = cls(model, vae, sc, inp["transport"], opt)
    batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
    noise = c["noise"]
    if mesh is not None:
        batch = tmesh.shard_batch(batch, mesh)
        noise = tmesh.shard_batch(noise, mesh)
    got = step(batch, noise=noise)
    return ({k: got[k].item() for k in V2_KEYS},
            tmesh.full_state_dict(model))


def _clip_step(inp, mesh=None):
    """(metrics, whole weights) of one CLIP-ViT fused step."""
    from showo_tpu_torch.sampling.schedules import cosine_schedule
    from showo_tpu_torch.training import train_showo_clip as tclip
    from showo_tpu_torch.training.train_step import TrainConfig

    c = inp["clip"]
    model = torch.load(c["model"], weights_only=False)
    vq = torch.load(c["vq"], weights_only=False)
    tower = torch.load(c["tower"], weights_only=False)
    arrays = [torch.as_tensor(a) for a in c["arrays"]]
    noise, n = c["noise"], B
    if mesh is not None:
        tmesh.shard_params(model, mesh)
        info = tmesh.mesh_of(model)
        arrays = tmesh.shard_batch(arrays, info)
        noise = tmesh.shard_batch(noise, info)
        n = B // info.data_world
    tc = TrainConfig(max_seq_length=c["max_seq"], remat="none")
    step = tclip.FusedClipTrainStep(
        model, vq, tower, tc, tclip.make_projector_lr_optimizer(tc, model),
        c["sp"], n, n, n, cosine_schedule, system_prompt_len=c["system"])
    got = step(*arrays, noise=noise)
    return ({k: got[k].item() for k in V1_KEYS},
            tmesh.full_state_dict(model))


def _loader_rows(loaders, batches=2):
    """The rows of the first ``batches`` batches of the t2i, lm and mmu
    loaders: (caption, pixel sum) of an image row, the text of an lm
    row."""
    rows = []
    for ld in loaders:
        it, got = iter(ld), []
        for _ in range(batches):
            b = next(it)
            if "image" in b:
                got += [(t, round(float(np.sum(im)), 3))
                        for t, im in zip(b["text"], b["image"])]
            else:
                got += list(b["input_ids"])
        rows.append(got)
    return rows


def _trainer_contract(inp, rank, workdir, out, mesh):
    """The mp_worker contract at (2, 2, 2) through the v1 trainer built
    on the Python route (``build_trainer(mesh=...)``): this data rank's
    rows only, also through the CLI's loaders over an ImageNet folder,
    parquet and tar shards; ranks agree; rank 0 alone writes the
    checkpoint; after another step a resume restores the saved weights,
    optimizer state and EMA; the checkpoint's weights are the
    single-process step's over the whole batch; tp ranks given different
    rows raise."""
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.data.loader import data_shard, shard_for_process
    from showo_tpu_torch.training import train_showo as ttrain

    config = load_config(inp["stage1_config"], inp["trainer_overrides"])
    trainer = ttrain.build_trainer(config, device="cpu", mesh=mesh)
    info = tmesh.mesh_of(trainer.model)
    out["data_shard"] = data_shard(trainer.model)
    out["rows"] = shard_for_process(list(range(B)), *out["data_shard"])
    out["loader_rows"] = _loader_rows(ttrain._build_loaders(
        load_config(inp["stage1_config"],
                    inp["trainer_overrides"] + inp["loader_overrides"]),
        shard=data_shard(trainer.model)))
    t2i, lm, mmu, noise = tmesh.shard_batch(inp["raw"], info)
    out["local_rows"] = len(t2i["image"])
    metrics = trainer.train_step(t2i, lm, mmu, noise=noise)
    out["trainer_loss"] = metrics["loss"].item()
    out["trainer_grad_norm"] = metrics["grad_norm"].item()
    mine = os.path.join(workdir, f"ckpt_rank{rank}")
    trainer.save(mine, {})
    out["wrote"] = sorted(os.listdir(mine)) if os.path.isdir(mine) else []
    saved = tmesh.full_state_dict(trainer.model)
    # copies: the live state (the optimizer's step counts) moves on
    opt_state = copy.deepcopy(tmesh.to_full(trainer.optimizer.state_dict()))
    ema = tmesh.to_full(trainer.ema.state_dict())
    trainer.train_step(t2i, lm, mmu, noise=noise)
    out["resumed_step"] = trainer.resume(os.path.join(workdir, "ckpt_rank0"),
                                         {})
    back = tmesh.full_state_dict(trainer.model)
    out["resume_equal"] = all(torch.equal(back[k], v)
                              for k, v in saved.items())
    o2 = tmesh.to_full(trainer.optimizer.state_dict())["adamw"]["state"]
    out["opt_equal"] = all(
        torch.equal(o2[i][k], st[k])
        for i, st in opt_state["adamw"]["state"].items() for k in st)
    e2 = tmesh.to_full(trainer.ema.state_dict())["params"]
    out["ema_equal"] = all(torch.equal(e2[k], v)
                           for k, v in ema["params"].items())
    out["trainer_embed"] = saved["showo.model.embed_tokens.weight"]
    if info.coord["tp"]:
        t2i = dict(t2i, image=-t2i["image"])
    try:
        trainer.train_step(t2i, lm, mmu, noise=noise)
        out["tp_rows_error"] = None
    except ValueError as e:
        out["tp_rows_error"] = str(e)


def _single_trainer(inp, out):
    """The same trainer in one process over the whole batch."""
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.training import train_showo as ttrain

    single = ttrain.build_trainer(
        load_config(inp["stage1_config"], inp["single_overrides"]),
        device="cpu")
    t2i, lm, mmu, noise = inp["raw"]
    out["single_loss"] = single.train_step(t2i, lm, mmu,
                                           noise=noise)["loss"].item()
    out["single_embed"] = single.model.showo.model.embed_tokens.weight \
        .detach().clone()


def _load(workdir, name):
    """The parent's input file ``name``, once it is there."""
    path = os.path.join(workdir, name)
    while not os.path.exists(path):
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def train_worker(rank, world, workdir):
    """Every case sharded on every rank; the unsharded references spread
    over ranks 0-4 (no collective), each saved by the rank that ran it."""
    out = {}
    meshes = {s: tmesh.make_mesh(*s) for s in V1_MESHES + [(8, 1, 1)]}
    # DTensor's first use imports much of torch; done while inputs come
    tmesh.shard_params(torch.nn.Linear(8, 8), meshes[(2, 2, 2)])
    inp = _load(workdir, "inputs_v1.pt")
    for shape in V1_MESHES:
        out[("v1", shape)], sd, model = _v1_step(inp, meshes[shape])
        fc1 = model.showo.model.layers[0].mlp.fc1.parametrizations.weight
        out[("fc1_local", shape)] = tuple(fc1.original.to_local().shape)
        if rank == 0:
            out[("v1_sd", shape)] = sd
    for shape in ((8, 1, 1), (2, 4, 1)):
        out[("saved", shape)] = _saved_bytes(inp, meshes[shape])
    inp.update(_load(workdir, "inputs_v2.pt"))
    for case in V2_CASES:
        out[("v2", case)], sd = _v2_step(inp, case, meshes[(2, 2, 2)])
        if rank == 0:
            out[("v2_sd", case)] = sd
    inp.update(_load(workdir, "inputs_clip.pt"))
    out["clip"], sd = _clip_step(inp, meshes[(2, 2, 2)])
    if rank == 0:
        out["clip_sd"] = sd
    inp.update(_load(workdir, "inputs_trainer.pt"))
    _trainer_contract(inp, rank, workdir, out, meshes[(2, 2, 2)])
    if rank == 0:
        out["v1_ref"], out["v1_ref_sd"], _ = _v1_step(inp)
    elif rank <= len(V2_CASES):
        case = V2_CASES[rank - 1]
        out[("v2_ref", case)], out[("v2_ref_sd", case)] = _v2_step(inp,
                                                                   case)
    elif rank == len(V2_CASES) + 1:
        _single_trainer(inp, out)
    elif rank == len(V2_CASES) + 2:
        out["clip_ref"], out["clip_ref_sd"] = _clip_step(inp)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def _opt_model():
    """The tiny v1 Show-o of the optimizer cases, the same on every rank
    (torch's seeded CPU init)."""
    from showo_tpu_torch.models.phi import PhiConfig
    from showo_tpu_torch.models.showo import Showo, ShowoConfig

    torch.manual_seed(0)
    return Showo(ShowoConfig(vocab_size=1027, llm_vocab_size=1010,
                             num_new_special_tokens=0, codebook_size=16,
                             num_vq_tokens=16, llm=PhiConfig(**OPT_PHI)))


def _opt_grads(model, step):
    """Step ``step``'s gradients, whole, by the unsharded model's names:
    N(0, 1e-2), so the clip at 1.0 scales them (the norm ~1.4)."""
    g = torch.Generator().manual_seed(100 + step)
    return {n: torch.randn(p.shape, generator=g) * 1e-2
            for n, p in sorted(tmesh.named_parameters(model))}


def _opt_steps(name, mesh=None, ckpt=None):
    """OPT_STEPS optimizer steps of ``name`` (on the JAX package's
    tensors, ``jax_tensors``, the clip at 1.0) on ``_opt_model`` with
    ``_opt_grads``: (the weights whole after each step, the local shapes
    of the optimizer's state tensors: (local shape, whole shape, whether
    it keeps an axis that the mesh splits)).  With ``ckpt``, the whole state is
    saved after the first step, and a fresh model and optimizer on the
    same mesh resume from it and step again: their weights come last in
    the list."""
    from showo_tpu_torch.training.optim import factored_dims, jax_tensors
    from showo_tpu_torch.training.train_step import Optimizer, TrainConfig
    from showo_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)

    def build():
        model = _opt_model()
        if mesh is not None:
            tmesh.shard_params(model, mesh)
        tc = TrainConfig(learning_rate=SHARDED_OPTS[name][0], optimizer=name)
        return model, Optimizer(model.parameters(), tc,
                                tensors=jax_tensors(model))

    def step(model, opt, k):
        whole = _opt_grads(model, k)
        opt.update([tmesh.shard_like(whole[tmesh.clean_name(n)], p)
                    for n, p in model.named_parameters()])

    def whole(model):        # copies: an unsharded state dict is live
        return {k: v.clone() for k, v in tmesh.full_state_dict(model)
                .items()}

    model, opt = build()
    weights = []
    for k in range(OPT_STEPS):
        step(model, opt, k)
        weights.append(whole(model))
        if k == 0 and ckpt is not None:
            save_checkpoint(ckpt, 1, model, opt)
    inner = opt.inner
    if name == "adafactor":
        # a statistic kept split: its tensor is split on an axis it keeps
        # (a row or column mean over the split axis is whole)
        kept = []
        for t, v in zip(inner.tensors, inner.v):
            dims = factored_dims(t.shape) or (None, None)
            kept += [(x, bool(set(t.split.values()) - {d}))
                     for x, d in zip(v, dims[::-1])]
    else:
        kept = [(x, bool(tmesh.shard_dims(p)))
                for p, x in zip(inner.params * 2, inner.mu + inner.nu)]
    state = [(tuple(tmesh.local(x).shape), tuple(x.shape), split)
             for x, split in kept]
    if ckpt is not None:
        model, opt = build()
        restore_checkpoint(os.path.join(ckpt, "checkpoint-1"), model, opt)
        step(model, opt, 1)
        weights.append(whole(model))
    return weights, state


def opt_worker(rank, world, workdir):
    """adamw_bf16 and adafactor at the fsdp and the tp mesh; a save and
    resume on the fsdp mesh."""
    out = {}
    for shape in V1_MESHES:
        mesh = tmesh.make_mesh(*shape)
        for name in SHARDED_OPTS:
            ckpt = (os.path.join(workdir, f"ckpt_{name}")
                    if shape == V1_MESHES[0] else None)
            weights, state = _opt_steps(name, mesh, ckpt)
            out[(name, shape)] = (weights if rank == 0 else None, state)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


# ---------------------------------------------------------------------------
# this process: the inputs, JAX's steps


def _jit_init(module, name):
    """``module.<name>(cfg, key, ...)`` compiled once (the eager init
    dispatches hundreds of small programs)."""
    import jax
    from unittest import mock

    return mock.patch.object(module, name,
                             jax.jit(getattr(module, name),
                                     static_argnums=(0,)))


def _v1_inputs(workdir):
    """The port models, the global batch (B rows a task), the draws, and
    JAX's step on them."""
    import jax
    import jax.numpy as jnp
    from showo_tpu.models import magvit as jmv
    from showo_tpu.prompting import UniversalPrompting as JaxPrompting
    from showo_tpu.sampling.schedules import cosine_schedule as j_cosine
    from showo_tpu.training.train_showo import make_fused_train_step
    from showo_tpu.training.train_step import TrainConfig as JTC
    from showo_tpu.training.train_step import TrainState, make_optimizer
    from showo_tpu.utils.torch_export import showo_state_dict
    from showo_tpu_torch.models import magvit as tmv
    from showo_tpu_torch.utils.convert import load_magvit, magvit_state_dict
    import test_torch_training as tt

    uni = JaxPrompting(tt.jfake.FakeTokenizer(), max_text_len=tt.MAX_SEQ,
                       cond_dropout_prob=0.0)
    rng = np.random.default_rng(0)
    words = ["a", "cat", "red", "dog", "on", "hill", "blue", "sky"]
    texts = [[" ".join(rng.choice(words, size=1 + i % 5)) for i in range(B)]
             for _ in range(3)]
    t2i_text = uni.t2i_text_block(texts[0])
    L = t2i_text.shape[1] + tt.SHOWO_DIMS["num_vq_tokens"] + 2
    lm_ids, _, lm_labels = uni.lm_prompt(
        uni.text_tokenizer(texts[1])["input_ids"], L)
    mmu_text, mmu_labels = uni.mmu_text_block(texts[2])
    pix = [rng.uniform(-1, 1, size=(B, 8, 8, 3)).astype(np.float32)
           for _ in range(2)]
    arrays = (pix[0], t2i_text, lm_ids, lm_labels, pix[1], mmu_text,
              mmu_labels)
    with _jit_init(tt.jshowo, "init_showo_params"):
        params, model = tt._models()
    jcfg, _ = tt._configs()
    jvq_cfg = jmv.VQConfig(**tt.VQ_DIMS)
    vq_params = jax.jit(lambda k: jmv.MagvitV2(jvq_cfg).init(
        k, jnp.zeros((1, 8, 8, 3)))["params"])(jax.random.PRNGKey(1))
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**tt.VQ_DIMS)),
                     magvit_state_dict(vq_params, jvq_cfg)).eval()
    torch.save(model, os.path.join(workdir, "v1_model.pt"))
    torch.save(vq.requires_grad_(False), os.path.join(workdir, "vq.pt"))
    key = jax.random.PRNGKey(7)
    k_corrupt, = jax.random.split(key, 1)
    noise = {k: torch.tensor(np.asarray(v)) for k, v in tt._jax_draws(
        k_corrupt, B, tt.SHOWO_DIMS["num_vq_tokens"], 16).items()}
    inputs = {"model": os.path.join(workdir, "v1_model.pt"),
              "vq": os.path.join(workdir, "vq.pt"), "arrays": arrays,
              "noise": noise, "sp": uni.sptids, "max_seq": tt.MAX_SEQ}

    def jax_side():
        jtc = JTC(max_seq_length=tt.MAX_SEQ, learning_rate=1e-4)
        jopt = make_optimizer(jtc)
        step = make_fused_train_step(jcfg, jvq_cfg, jtc, jopt, uni.sptids,
                                     B, B, B, j_cosine)
        state = TrainState(params, jopt.init(params),
                           jnp.zeros((), jnp.int32))
        state, want = step(state, vq_params, *map(jnp.asarray, arrays), key)
        return ({k: float(want[k]) for k in V1_KEYS},
                showo_state_dict(state.params, jcfg.llm.num_layers))

    return inputs, jax_side


def _clip_inputs(workdir):
    """The CLIP-ViT step's port models (``tests/test_torch_train_clip.py``'s
    widths and weights), B rows a task, the draws, and JAX's step."""
    import jax
    import jax.numpy as jnp
    from showo_tpu.models import clip_vit as jcv
    from showo_tpu.models import magvit as jmv
    from showo_tpu.models import showo as jshowo
    from showo_tpu.models.phi import PhiConfig as JPhiConfig
    from showo_tpu.sampling.schedules import cosine_schedule as j_cosine
    from showo_tpu.training.train_showo_clip import \
        make_fused_clip_train_step as j_step
    from showo_tpu.training.train_showo_clip import \
        make_projector_lr_optimizer as j_opt
    from showo_tpu.training.train_step import TrainConfig as JTC
    from showo_tpu.training.train_step import TrainState
    from showo_tpu.utils.torch_export import showo_state_dict
    from showo_tpu_torch.models import clip_vit as tcv
    from showo_tpu_torch.models import magvit as tmv
    from showo_tpu_torch.models import showo as tshowo
    from showo_tpu_torch.models.phi import PhiConfig
    from showo_tpu_torch.utils.convert import (clip_vit_state_dict,
                                               load_clip_vit, load_magvit,
                                               load_showo, magvit_state_dict)
    import test_torch_train_clip as tc
    import test_torch_training as tt

    jcfg = jshowo.ShowoConfig(**tc.SHOWO_DIMS,
                              llm=JPhiConfig(**tc.PHI_DIMS))
    params = jax.jit(lambda k: jshowo.init_showo_params(jcfg, k))(
        jax.random.PRNGKey(0))
    params["mm_projector"] = {
        "fc1": {"kernel": jax.random.normal(jax.random.PRNGKey(1), (32, 64))
                * 0.02, "bias": jnp.zeros((64,))},
        "fc2": {"kernel": jax.random.normal(jax.random.PRNGKey(2), (64, 64))
                * 0.02, "bias": jnp.zeros((64,))}}
    jvq = jmv.VQConfig(**tc.VQ_DIMS)
    vq_params = jax.jit(lambda k: jmv.MagvitV2(jvq).init(
        k, jnp.zeros((1, 8, 8, 3)))["params"])(jax.random.PRNGKey(1))
    jclip = jcv.ClipVitConfig(**tc.CLIP_DIMS)
    clip_params = jax.jit(lambda k: jcv.init_clip_vit_params(jclip, k))(
        jax.random.PRNGKey(3))
    tcfg = tshowo.ShowoConfig(**tc.SHOWO_DIMS, clip_feat_dim=32,
                              llm=PhiConfig(**tc.PHI_DIMS))
    model = load_showo(tshowo.Showo(tcfg), showo_state_dict(
        params, tc.PHI_DIMS["num_layers"])).train().requires_grad_(True)
    vq = load_magvit(tmv.MagvitV2(tmv.VQConfig(**tc.VQ_DIMS)),
                     magvit_state_dict(vq_params, jvq)).eval()
    tower = load_clip_vit(tcv.ClipVisionTower(tcv.ClipVitConfig(
        **tc.CLIP_DIMS)), clip_vit_state_dict(clip_params, 2))
    paths = {k: os.path.join(workdir, f"clip_{k}.pt")
             for k in ("model", "vq", "tower")}
    for k, m in (("model", model), ("vq", vq.requires_grad_(False)),
                 ("tower", tower.eval().requires_grad_(False))):
        torch.save(m, paths[k])
    # tc._inputs' rows, B of each
    rng = np.random.default_rng(4)
    mmu_ids = np.concatenate([
        np.full((B, 1), tc.SP["<|mmu|>"]), rng.integers(2, 900, (B, 4)),
        np.full((B, 1), tc.SP["<|soi|>"]), np.full((B, 1), tc.SP["<|eoi|>"]),
        rng.integers(2, 900, (B, 6))], axis=1)
    lm_ids = rng.integers(2, 900, size=(B, 27))
    arrays = (rng.normal(size=(B, 8, 8, 3)).astype(np.float32),
              rng.integers(2, 900, size=(B, 9)), lm_ids,
              np.where(lm_ids > 100, lm_ids, -100),
              rng.normal(size=(B, 32, 32, 3)).astype(np.float32), mmu_ids,
              np.where(mmu_ids > 100, mmu_ids, -100))
    key = jax.random.PRNGKey(0)
    k_corrupt, = jax.random.split(key, 1)
    noise = {k: torch.tensor(np.asarray(v)) for k, v in tt._jax_draws(
        k_corrupt, B, tc.SHOWO_DIMS["num_vq_tokens"], 16).items()}
    inputs = {"clip": dict(paths, arrays=arrays, noise=noise, sp=tc.SP,
                           system=tc.SYSTEM, max_seq=tc.MAX_SEQ)}

    def jax_side():
        jtc = JTC(max_seq_length=tc.MAX_SEQ)
        jopt = j_opt(jtc, params)
        step = j_step(jcfg, jvq, jclip, jtc, jopt, tc.SP, B, B, B,
                      j_cosine, system_prompt_len=tc.SYSTEM)
        state = TrainState(params, jopt.init(params),
                           jnp.zeros((), jnp.int32))
        state, want = step(state, vq_params, clip_params,
                           *map(jnp.asarray, arrays), key)
        return ({k: float(want[k]) for k in V1_KEYS if k in want},
                showo_state_dict(state.params, tc.PHI_DIMS["num_layers"]))

    return inputs, jax_side


def _v2_batch(case):
    """B samples: ``stage1`` t2i images, ``stage2`` t2i and und rows in
    turn, ``mixed`` two images a sample (one with a single image)."""
    from showo_tpu.show_o2.formats import (format_interleaved_sequence,
                                           format_sequence_gen_qwen2_5,
                                           format_sequence_und)
    from test_torch_show_o2_train import IDS, tiny_cfgs

    rng = np.random.default_rng(3)
    n_img = tiny_cfgs()[0].num_image_tokens
    if case == "mixed":
        rows = [format_interleaved_sequence(
            ["img"] * k, [list(rng.integers(10, 190, size=3))
                          for _ in range(k)],
            num_image_tokens=n_img, max_seq_len=64, max_num_images=2, **IDS)
            for k in (2, 1) * (B // 2)]
        tt_, tl, mp, _, im = (np.stack(c) for c in zip(*rows))
        return {"text_tokens": tt_, "text_labels": tl,
                "modality_positions": mp, "image_masks": im,
                "images": rng.uniform(-1, 1, (B, 2, 16, 16, 3)).astype(
                    np.float32)}
    rows = []
    for i in range(B):
        fmt = (format_sequence_und if case == "stage2" and i % 2
               else format_sequence_gen_qwen2_5)
        rows.append(fmt(list(rng.integers(10, 190, size=6)),
                        num_image_tokens=n_img, max_seq_len=40 + n_img,
                        **IDS))
    tt_, tl, mp, _, im = (np.stack(c) for c in zip(*rows))
    is_und = np.asarray([i % 2 if case == "stage2" else 0
                         for i in range(B)], np.int32)
    return {"text_tokens": tt_, "text_labels": tl, "modality_positions": mp,
            "image_masks": im,
            "images": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
            "is_und": is_und}


def _v2_inputs(workdir):
    import jax
    import jax.numpy as jnp
    from showo_tpu.show_o2 import transport as jtr
    from showo_tpu.show_o2.train_mixed_modality import make_mixed_modal_step
    from showo_tpu.show_o2.train_stage_one import Stage1Config as JS1
    from showo_tpu.show_o2.train_stage_one import (make_stage1_optimizer,
                                                   make_stage1_step)
    from showo_tpu.show_o2.train_stage_two import Stage2Config as JS2
    from showo_tpu.show_o2.train_stage_two import make_stage2_optimizer
    from showo_tpu_torch.show_o2 import train_stage_one as t1
    from showo_tpu_torch.show_o2 import train_stage_two as t2
    from showo_tpu_torch.show_o2 import transport as ttr
    from showo_tpu_torch.show_o2 import wan_vae as twan
    from test_t2i_v2_pipeline import VAE_TINY
    from test_torch_mmu_v2 import _port_vae, _vae_params
    from test_torch_show_o2 import showo2_params
    import test_torch_mixed_modal_train as tmm
    import test_torch_show_o2_train as ts

    import test_torch_mmu_v2
    import test_torch_show_o2

    jcfg, tcfg = ts.tiny_cfgs()
    with _jit_init(test_torch_show_o2.jshowo2, "init_showo2_params"), \
            _jit_init(test_torch_mmu_v2.jwan, "init_wan_vae_params"):
        params = showo2_params(jcfg)
        vae_params = _vae_params(VAE_TINY)
    model = ts._port_model(tcfg, jcfg, params)
    vae = _port_vae(VAE_TINY, vae_params)
    torch.save(model, os.path.join(workdir, "v2_model.pt"))
    torch.save(vae, os.path.join(workdir, "vae.pt"))
    kw = dict(snr_type="lognorm", do_shift=True,
              seq_len=jcfg.num_image_tokens)
    jtransport = jtr.Transport(**kw)
    inputs = {"v2_model": os.path.join(workdir, "v2_model.pt"),
              "vae": os.path.join(workdir, "vae.pt"),
              "transport": ttr.Transport(**kw)}
    lrs = dict(lr_und=1e-4, lr_fusion=3e-4, lr_main=2e-5)
    jobs = {}
    for case in V2_CASES:
        batch = _v2_batch(case)
        frozen = ("und_trans", "position_embedding") if case == "stage2" \
            else ()
        # the port without remat (the same numbers, half the gathers)
        if case == "stage2":
            jsc, sc = JS2(und_max_t0=1.0, **lrs), t2.Stage2Config(
                und_max_t0=1.0, remat="none", **lrs)
        elif case == "mixed":
            jsc = JS1(und_max_t0=None, ntp_coeff=1.0)
            sc = t1.Stage1Config(und_max_t0=None, ntp_coeff=1.0,
                                 remat="none")
        else:
            jsc = JS1(und_max_t0=0.9)
            sc = t1.Stage1Config(und_max_t0=0.9, remat="none")
        key = jax.random.PRNGKey(7)
        with torch.no_grad():
            imgs = torch.as_tensor(batch["images"])
            if case == "mixed":
                imgs = imgs.reshape(-1, 16, 16, 3)
            lat = twan.wan_encode(vae, imgs.permute(0, 3, 1, 2)[:, :, None],
                                  deterministic=True)
        lat_shape = tuple(lat.shape[:2]) + tuple(lat.shape[3:])
        noise = (tmm._jax_draws(key, jtransport, lat_shape)
                 if case == "mixed"
                 else ts._jax_draws(key, batch, jtransport, jsc, lat_shape))
        inputs[case] = {"batch": batch, "noise": noise, "sc": sc,
                        "frozen": frozen}
        jobs[case] = (jsc, ts._jax_frozen(frozen), batch, key)

    def jax_side(case):
        jsc, frozen, batch, key = jobs[case]
        jparams = jax.tree.map(jnp.asarray, params)   # a step donates
        make = (make_stage2_optimizer if case == "stage2"
                else make_stage1_optimizer)
        jopt = make(jsc, jparams, frozen)
        make_step = (make_mixed_modal_step if case == "mixed"
                     else make_stage1_step)
        step = make_step(jcfg, VAE_TINY, jsc, jtransport, jopt)
        new, _, want = step(jparams, jopt.init(jparams),
                            jax.tree.map(jnp.asarray, vae_params),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            key)
        return ({k: float(want[k]) for k in V2_KEYS if k in want},
                ts._port_sd(jcfg, new))

    return inputs, jax_side


def _trainer_inputs(workdir):
    """The tiny stage-1 trainer config (per-rank batches of 2 a task,
    EMA on) and its single-process twin (the whole batch of 8 a task),
    the raw host batches with fixed corruption draws, and the loaders'
    data: an ImageNet folder of 16 images, 16 parquet rows (one empty)
    and 4 caption tar shards of 4 samples."""
    import test_torch_training as tt
    from test_torch_data_loaders import (write_imagenet, write_parquet,
                                         write_shard)

    data = os.path.join(workdir, "data")
    write_imagenet(os.path.join(data, "imagenet"), per=8)
    write_parquet(os.path.join(data, "lm.parquet"), n=17)
    for i in range(4):
        write_shard(os.path.join(data, f"cap-{i:05d}.tar"), 4 * i, 4)

    common = [o for o in tt.TINY if "batch_size" not in o] + [
        "training.cond_dropout_prob=0.0", "training.remat=none",
        "training.ema={enabled: true, decay: 0.9}"]
    n = B // 4
    rng = np.random.default_rng(9)
    texts = [f"text {i} of a batch" for i in range(B)]
    raw = ({"image": rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32),
            "text": texts}, texts,
           {"image": rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32),
            "text": texts[::-1]},
           {"timesteps": torch.linspace(0.2, 0.8, B),
            "uniforms": torch.as_tensor(rng.uniform(size=(B, 16)),
                                        dtype=torch.float32)})
    per = [f"training.batch_size_{t}={{}}" for t in ("t2i", "lm", "mmu")]
    return {"stage1_config": tt.STAGE1, "raw": raw,
            "trainer_overrides": common + [p.format(n) for p in per],
            "single_overrides": common + [p.format(B) for p in per],
            "loader_overrides": [
                "dataset.gen_type=imagenet1k",
                f"dataset.params.train_t2i_shards_path_or_url={data}/imagenet",
                f"dataset.params.train_lm_shards_path_or_url={data}/lm.parquet",
                "dataset.params.train_mmu_shards_path_or_url="
                f"{data}/cap-{{00000..00003}}.tar",
                "dataset.params.resolution=8",
                "dataset.params.shuffle_buffer_size=3"]}


def _save(workdir, name, obj):
    tmp = os.path.join(workdir, name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, os.path.join(workdir, name))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks start at once and take each input file as it comes; this
    process then runs JAX's four steps (in threads) while they work."""
    workdir = str(tmp_path_factory.mktemp("train"))
    group = start_group("test_torch_parallel_train:train_worker", WORLD,
                        workdir)
    try:
        v1, v1_jax = _v1_inputs(workdir)
        _save(workdir, "inputs_v1.pt", v1)
        v2, v2_jax = _v2_inputs(workdir)
        _save(workdir, "inputs_v2.pt", v2)
        clip, clip_jax = _clip_inputs(workdir)
        _save(workdir, "inputs_clip.pt", clip)
        _save(workdir, "inputs_trainer.pt", _trainer_inputs(workdir))
        with ThreadPoolExecutor(len(V2_CASES) + 2) as pool:
            j1, jc = pool.submit(v1_jax), pool.submit(clip_jax)
            j2 = {c: pool.submit(v2_jax, c) for c in V2_CASES}
            want = {"v1": j1.result(), "clip": jc.result(),
                    "v2": {c: f.result() for c, f in j2.items()}}
    except BaseException:
        group.kill()
        raise
    group.wait(timeout=180)
    outs = [torch.load(os.path.join(workdir, f"out{r}.pt"),
                       weights_only=False) for r in range(WORLD)]
    merged = {}
    for o in outs:
        merged.update({k: v for k, v in o.items()
                       if "ref" in str(k) or k in ("single_loss",
                                                   "single_embed")})
    return outs, merged, want


@pytest.fixture(scope="module")
def opt_run(tmp_path_factory):
    """The sharded optimizer cases on 8 gloo ranks while this process
    steps the unsharded model."""
    workdir = str(tmp_path_factory.mktemp("opt"))
    group = start_group("test_torch_parallel_train:opt_worker", WORLD,
                        workdir)
    try:
        want = {name: _opt_steps(name) for name in SHARDED_OPTS}
    except BaseException:
        group.kill()
        raise
    group.wait(timeout=180)
    outs = [torch.load(os.path.join(workdir, f"out{r}.pt"),
                       weights_only=False) for r in range(WORLD)]
    return outs, want


def _close(got, want, keys, rtol, what):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=f"{what} {k}")


def _weights(got, want, what, atol=1e-5):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("shape", V1_MESHES)
def test_v1_step_on_mesh_vs_unsharded_and_jax(run, shape):
    outs, ref, want = run
    got = outs[0][("v1", shape)]
    for r in range(1, WORLD):
        assert outs[r][("v1", shape)] == got, r        # ranks agree
    _close(got, ref["v1_ref"], V1_KEYS, 1e-5, "vs unsharded")
    _weights(outs[0][("v1_sd", shape)], ref["v1_ref_sd"], "unsharded")
    jm, jsd = want["v1"]
    _close(got, jm, ("loss", "loss_t2i", "loss_lm", "loss_mmu"), 2e-4,
           "vs JAX")
    _close(got, jm, ("grad_norm",), 2e-3, "vs JAX")
    _close(got, jm, ("masking_rate",), 1e-6, "vs JAX")
    _weights(outs[0][("v1_sd", shape)], jsd, "JAX")


def test_clip_step_on_mesh_vs_unsharded_and_jax(run):
    """The CLIP-ViT fused step (``mm_projector`` sharded with Show-o, the
    tower whole) at (2, 2, 2)."""
    outs, ref, want = run
    got = outs[0]["clip"]
    for r in range(1, WORLD):
        assert outs[r]["clip"] == got, r
    _close(got, ref["clip_ref"], V1_KEYS, 1e-5, "vs unsharded")
    _weights(outs[0]["clip_sd"], ref["clip_ref_sd"], "unsharded")
    jm, jsd = want["clip"]
    _close(got, jm, ("loss", "loss_t2i", "loss_lm", "loss_mmu"), 2e-4,
           "vs JAX")
    _close(got, jm, ("masking_rate",), 1e-6, "vs JAX")
    _weights(outs[0]["clip_sd"], jsd, "JAX")


def test_fsdp_step_keeps_shards_for_the_backward(run):
    """What autograd keeps for the backward of one v1 forward, per rank at
    the same rows: at fsdp=4 the gathered weights are kept as their
    shards, so a rank keeps less than at fsdp=1 by the whole weights' share
    that the other fsdp ranks hold."""
    for o in run[0]:
        one, four = o[("saved", (8, 1, 1))], o[("saved", (2, 4, 1))]
        assert one["reshard"] == one["held"] == four["held"]
        # none of the whole Linear weights is kept (the saved activations
        # are the same: the same rows a rank)
        assert four["held"] - four["reshard"] == four["linear"] > 0


def test_fsdp_actually_shards(run):
    """JAX: fc1 [L=2, D, F=256] over fsdp=4 on F -> [2, D, 64] a device;
    here fc1.weight [F, D] -> [64, D] a rank (with tp=2: [32, D])."""
    outs = run[0]
    for r in range(WORLD):
        assert outs[r][("fc1_local", (2, 4, 1))] == (64, 128)
        assert outs[r][("fc1_local", (2, 2, 2))] == (64, 128)


@pytest.mark.parametrize("case", V2_CASES)
def test_show_o2_step_on_mesh_vs_unsharded_and_jax(run, case):
    outs, ref, want = run
    got = outs[0][("v2", case)]
    for r in range(1, WORLD):
        assert outs[r][("v2", case)] == got, r
    _close(got, ref[("v2_ref", case)], V2_KEYS, 1e-5, "vs unsharded")
    _weights(outs[0][("v2_sd", case)], ref[("v2_ref_sd", case)],
             "unsharded")
    jm, jsd = want["v2"][case]
    _close(got, jm, ("loss", "loss_ntp", "loss_flow"), 2e-4, "vs JAX")
    if case != "stage2":        # JAX's norm there counts the frozen tower
        _close(got, jm, [k for k in ("grad_norm",) if k in jm], 2e-3,
               "vs JAX")
    _weights(outs[0][("v2_sd", case)], jsd, "JAX")
    assert got["loss_flow"] > 0 and np.isfinite(got["loss"])


@pytest.mark.parametrize("shape", V1_MESHES, ids=["fsdp", "tp"])
@pytest.mark.parametrize("name", list(SHARDED_OPTS))
def test_sharded_optimizer_vs_unsharded(opt_run, name, shape):
    """``adamw_bf16`` and ``adafactor`` on a v1 model sharded at (2, 4, 1)
    (fsdp) and (2, 2, 2) (fsdp and tp), the same gradients, clipped:
    each step's weights are the unsharded optimizer's within the atol of
    SHARDED_OPTS, the steps moving them by far more; every state tensor
    of 256 entries or more that keeps an axis the mesh splits is split
    (the moments like their parameters; adafactor's statistics along the
    axes they keep: a row or column mean over the split axis is whole)."""
    outs, want = opt_run
    weights, state = outs[0][(name, shape)]
    ref, ref_state = want[name]
    for k, (got, w) in enumerate(zip(weights, ref)):
        _weights(got, w, f"{name} step {k + 1}", atol=SHARDED_OPTS[name][1])
    moved = max((ref[1][n] - ref[0][n]).abs().max().item() for n in ref[0])
    assert moved > 1e-4, moved
    assert [w for _, w, _ in state] == [w for w, _, _ in ref_state]
    big = [(s, w) for s, w, split in state if split and math.prod(w) >= 256]
    assert big and all(math.prod(s) < math.prod(w) for s, w in big), big
    for o in outs[1:]:
        assert o[(name, shape)][1] == state


@pytest.mark.parametrize("name", list(SHARDED_OPTS))
def test_sharded_optimizer_resumes_as_uninterrupted(opt_run, name):
    """The whole state saved on the fsdp mesh after one step
    (``utils/checkpoint.py``: the moments, or the factored statistics,
    gathered) and restored into a fresh sharded model and optimizer
    gives the uninterrupted second step, bit for bit."""
    weights, _ = opt_run[0][0][(name, V1_MESHES[0])]
    assert len(weights) == OPT_STEPS + 1
    for k, v in weights[1].items():
        assert torch.equal(weights[-1][k], v), k


def test_loaders_read_the_data_ranks_rows(run):
    """The CLI's t2i (ImageNet folder), lm (parquet) and mmu (tar shards)
    loaders, built with the data shard of a model sharded on the Python
    route at (2, 2, 2): the tp ranks of a (dp, fsdp) coordinate read the
    same rows, the data ranks disjoint ones; one epoch of ImageNet's 16
    images over the 4 data ranks is each image once."""
    rows = [o["loader_rows"] for o in run[0]]
    for r in range(0, WORLD, 2):
        assert rows[r] == rows[r + 1], r
    for task in range(3):
        sets = [set(rows[r][task]) for r in range(0, WORLD, 2)]
        assert all(sets), task
        for i in range(len(sets)):
            for j in range(i):
                assert not sets[i] & sets[j], (task, i, j)
    t2i = [row for r in range(0, WORLD, 2) for row in rows[r][0]]
    assert len(set(t2i)) == len(t2i) == 16


def test_trainer_contract_on_mesh(run):
    """``tools/mp_worker.py``'s contract on (2, 2, 2)."""
    outs, ref, _ = run
    for r, o in enumerate(outs):
        data_rank = r // 2                 # (dp, fsdp) = divmod(r // 2, 2)
        assert o["data_shard"] == (data_rank, 4)
        assert o["rows"] == list(range(B))[data_rank::4]
        assert "different rows" in o["tp_rows_error"]
        assert o["local_rows"] == B // 4
        assert o["trainer_loss"] == outs[0]["trainer_loss"]
        assert o["wrote"] == ([] if r else ["checkpoint-1"])
        assert o["resumed_step"] == 1
        assert o["resume_equal"] and o["opt_equal"] and o["ema_equal"]
    np.testing.assert_allclose(outs[0]["trainer_loss"], ref["single_loss"],
                               rtol=1e-5)
    for o in outs:
        assert torch.equal(o["trainer_embed"], outs[0]["trainer_embed"])
    np.testing.assert_allclose(outs[0]["trainer_embed"].numpy(),
                               ref["single_embed"].numpy(), rtol=0,
                               atol=1e-5)
