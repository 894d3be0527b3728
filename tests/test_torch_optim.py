"""The throughput optimizers of showo_tpu_torch (``training/optim.py``
behind ``training/train_step.py::Optimizer``): ``adafactor`` and
``adamw_bf16`` against optax as the JAX package builds them (adafactor
through ``show_o2/train_stage_one.py::make_stage1_optimizer``: clip by
global norm, the optimizer, a linear warmup from 0, gradient
accumulation, frozen parameters under ``set_to_zero``; adamw_bf16
through ``training/train_step.py::make_optimizer``, which takes the
betas, with the same warmup and accumulation).  The adamw_bf16 case
runs at betas 0.875 / 0.984375, whose powers XLA's ``pow`` gives
exactly: at optax's 0.999 the bias correction 1 - 0.999^t (~3e-3 at
t = 3) turns one ulp of XLA's pow into 2e-5 of the update.

Five optimizer steps over a factored [256, 384], a 3-D [8, 130, 200] (a
layer stack: factored over its last two dims), an unfactored [64, 32]
and a 1-D [384] tensor, from the same gradients (drawn with numpy, some
large enough that the clip acts): fp32 parameters within rtol 1e-6 of
optax's (atol 2e-8, ~5 ulps of the parameters' scale, near 0), optax's
update compiled as the JAX package's step compiles it; ``adamw_bf16``'s
stored first moment equal to optax's bf16 moment bit for bit; a frozen parameter bit-unchanged; under adafactor
the first step, at learning rate 0, decays every weight by
``weight_decay`` (optax adds ``wd * p`` after the learning rate); a
resume from ``state_dict`` after three steps continues bit for bit.
The trainers' steps under these optimizers against JAX's are in
tests/test_torch_training.py (v1) and tests/test_torch_show_o2_train.py
(stage 1), beside the helpers they share with the AdamW steps.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from showo_tpu.show_o2 import train_stage_one as j1
from showo_tpu.training import train_step as jts
from showo_tpu_torch.show_o2 import train_stage_one as t1
from showo_tpu_torch.training import optim
from showo_tpu_torch.training.train_step import Optimizer, TrainConfig

torch.set_num_threads(1)

SHAPES = {"a": (256, 384), "b": (8, 130, 200), "c": (64, 32), "d": (384,),
          "frozen": (16,)}
STEPS, WARMUP, LR, WD = 5, 3, 1e-2, 0.01
BETAS = dict(adam_beta1=0.875, adam_beta2=0.984375)
# rtol 1e-6; elements near 0 get a few fp32 ulps of the parameters'
# scale (0.05: an ulp is 3.7e-9) instead, as p * (1 - wd) - lr * u rounds
# at that scale
TOL = dict(rtol=1e-6, atol=2e-8)


def _draws(accum, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.05
              for k, s in SHAPES.items()}
    # integers in [-2, 2] times a power of two, one power a step: every
    # sum of squares (also of the accumulated mean) is exact in fp32 in
    # any order, so the clip divides by the same norm as optax's and the
    # bf16 moment can be held bit for bit; the scales take the global norm
    # (~1.2e3 * 2^-s) across the clip's 1.0 both ways
    scales = 2.0 ** -rng.integers(8, 13, size=STEPS)
    grads = [{k: (rng.integers(-2, 3, size=s) * scales[i // accum]
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for i in range(STEPS * accum)]
    return params, grads


def _jax_run(name, accum, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    if name == "adafactor":
        sc = j1.Stage1Config(learning_rate=LR, weight_decay=WD,
                             warmup_steps=WARMUP, grad_accum_steps=accum,
                             optimizer=name)
        opt = j1.make_stage1_optimizer(sc, p, frozen_substrings=("frozen",))
    else:
        del p["frozen"]
        tc = jts.TrainConfig(learning_rate=LR, weight_decay=WD,
                             grad_accum_steps=accum, optimizer=name, **BETAS)
        opt = jts.make_optimizer(tc, optax.linear_schedule(0.0, LR, WARMUP))
    state = opt.init(p)
    update = jax.jit(opt.update)     # as the JAX package's step runs it
    out = []
    for g in grads:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()
                                 if k in p}, state, p)
        p = jax.tree.map(lambda a, u: a + u, p, upd)
        out.append({k: np.asarray(v) for k, v in p.items()})
    mu = [np.asarray(x.astype(jnp.float32)) for x in jax.tree.leaves(state)
          if getattr(x, "dtype", None) == jnp.bfloat16]
    return out, mu


def _port(name, accum, params):
    ps = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
          for k, v in params.items()}
    ps["frozen"].requires_grad_(False)
    if name == "adafactor":
        sc = t1.Stage1Config(learning_rate=LR, weight_decay=WD,
                             warmup_steps=WARMUP, grad_accum_steps=accum,
                             optimizer=name)
        return ps, Optimizer([(ps.values(), LR)], sc, t1.warmup(sc))
    tc = TrainConfig(learning_rate=LR, weight_decay=WD,
                     grad_accum_steps=accum, optimizer=name, **BETAS)
    return ps, Optimizer(ps.values(), tc,
                         lambda step: LR * min(step, WARMUP) / WARMUP)


def _feed(opt, g):
    opt.update([torch.as_tensor(g[k].copy()) for k in sorted(SHAPES)
                if k != "frozen"])


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
@pytest.mark.parametrize("name", ["adafactor", "adamw_bf16"])
def test_optimizer_vs_optax(name, accum):
    params, grads = _draws(accum, seed=accum)
    want, want_mu = _jax_run(name, accum, params, grads)
    ps, opt = _port(name, accum, params)
    for i, g in enumerate(grads):
        _feed(opt, g)
        for k in want[i]:
            np.testing.assert_allclose(ps[k].detach().numpy(), want[i][k],
                                       **TOL, err_msg=f"{k} {i}")
    assert opt.steps == STEPS
    assert np.array_equal(ps["frozen"].detach().numpy(), params["frozen"])
    if name == "adamw_bf16":
        got_mu = [m.float().numpy() for m in opt.inner.mu]
        assert [m.shape for m in got_mu] == [m.shape for m in want_mu]
        for g_, w_ in zip(got_mu, want_mu):
            assert np.array_equal(g_, w_)
        assert all(m.dtype == torch.bfloat16 for m in opt.inner.mu)


def test_adafactor_decays_at_lr_zero():
    """The warmup's first step has learning rate 0, yet every trained
    weight decays by weight_decay (optax's add_decayed_weights follows
    the learning rate); the frozen one does not move."""
    params, grads = _draws(1, seed=5)
    ps, opt = _port("adafactor", 1, params)
    assert opt.schedule(0) == 0.0
    _feed(opt, grads[0])
    for k, v in ps.items():
        want = params[k] * (1 - WD) if k != "frozen" else params[k]
        np.testing.assert_allclose(v.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["adafactor", "adamw_bf16", "adamw"])
def test_state_dict_resume_is_bit_exact(name):
    """Three steps (gradient accumulation 2), state_dict, a new optimizer
    on copies of the parameters loads it, two more steps: the same bits
    as an unbroken run."""
    params, grads = _draws(2, seed=7)
    ps, opt = _port(name, 2, params)
    for g in grads[:7]:        # 3 steps and one accumulated call
        _feed(opt, g)
    sd = copy.deepcopy(opt.state_dict())
    snap = {k: v.detach().clone().numpy() for k, v in ps.items()}
    for g in grads[7:]:
        _feed(opt, g)
    ps2, opt2 = _port(name, 2, snap)
    opt2.load_state_dict(sd)
    for g in grads[7:]:
        _feed(opt2, g)
    for k in ps:
        assert torch.equal(ps[k], ps2[k]), k
    with pytest.raises(ValueError, match="optimizer state"):
        _port("adafactor" if name != "adafactor" else "adamw", 2,
              snap)[1].load_state_dict(sd)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        _port("lion", 1, _draws(1)[0])


def test_factored_dims_as_optax():
    from optax._src import factorized

    for shape in [(256, 384), (8, 130, 200), (64, 32), (384,), (128, 128),
                  (24, 2048, 2048), (151940, 1536), (28, 1536),
                  (2, 2, 16, 1152)]:
        assert optim.factored_dims(shape) == factorized._factored_dims(
            shape, True, 128), shape


def test_tensor_partition_changes_the_update():
    """Adafactor factors and scales per tensor: one fused [D, 3D] qkv
    kernel and its three [D, D] projections get other updates from the
    same gradients, so the port must step the JAX package's tensors
    (``jax_tensors``), which the trainer tests hold."""
    rng = np.random.default_rng(3)
    w = [rng.normal(size=(160, 160)).astype(np.float32) * s
         for s in (0.02, 0.05, 0.1)]
    g = [rng.normal(size=(160, 160)).astype(np.float32) * s
         for s in (1e-3, 1e-2, 1e-1)]
    sc = t1.Stage1Config(learning_rate=LR, weight_decay=0.0,
                         optimizer="adafactor", max_grad_norm=1e9)
    three = [torch.nn.Parameter(torch.as_tensor(x.copy())) for x in w]
    fused = torch.nn.Parameter(torch.as_tensor(np.concatenate(w, 1)))
    Optimizer(three, sc).update([torch.as_tensor(x) for x in g])
    Optimizer([fused], sc).update([torch.as_tensor(np.concatenate(g, 1))])
    diff = (torch.cat([p.detach() for p in three], 1) - fused.detach())
    assert diff.abs().max().item() > 1e-4


def test_jax_tensors_stack_and_transpose():
    """A ModuleList of one layer class becomes one stacked tensor a
    parameter name, Linear weights [in, out], a conv weight HWIO."""
    class Layer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(3, 5)
            self.norm = torch.nn.LayerNorm(5)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList(Layer() for _ in range(4))
            self.conv = torch.nn.Conv2d(2, 6, 3)
            self.embed = torch.nn.Embedding(7, 5)

    shapes = {t.key: (t.shape, t.stacked)
              for t in optim.jax_tensors(Model())}
    assert shapes == {
        "layers.*.proj.weight": ((4, 3, 5), True),
        "layers.*.proj.bias": ((4, 5), True),
        "layers.*.norm.weight": ((4, 5), True),
        "layers.*.norm.bias": ((4, 5), True),
        "conv.weight": ((3, 3, 2, 6), False),
        "conv.bias": ((6,), False),
        "embed.weight": ((7, 5), False)}



# -- lion (training/lion.py) --------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_lion_vs_jax(wd):
    """Five steps of ``Lion`` against JAX ``training/lion.py``'s transform
    (applied by ``optax.apply_updates``, compiled) on the same gradients,
    with and without weight decay, at the limits above; then the schedule
    JAX refuses, refused too; and a resume from ``state_dict`` continues
    bit for bit."""
    from showo_tpu.training.lion import lion as jlion
    from showo_tpu_torch.training.lion import Lion

    rng = np.random.default_rng(5)
    shapes = [(64, 32), (384,), (3, 5, 7)]
    params = [rng.normal(size=s).astype(np.float32) * 0.05 for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** -k
              for s in shapes] for k in range(STEPS)]
    tx = jlion(LR, weight_decay=wd)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)

    @jax.jit
    def jstep(p, s, g):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    opt = Lion(tp, LR, weight_decay=wd)
    for k, g in enumerate(grads):
        jp, state = jstep(jp, state, [jnp.asarray(x) for x in g])
        opt.step([torch.tensor(x) for x in g])
        if k == 2:
            saved = copy.deepcopy(opt.state_dict())
            snap = [p.detach().clone() for p in tp]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for a, b in zip(opt.momentum, state.momentum):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    again = [torch.nn.Parameter(p) for p in snap]
    opt2 = Lion(again, LR, weight_decay=wd)
    opt2.load_state_dict(saved)
    for g in grads[3:]:
        opt2.step([torch.tensor(x) for x in g])
    for a, b in zip(again, tp):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="schedule"):
        jlion(lambda step: LR).update([jnp.zeros(3)], jlion(lambda s: LR)
                                      .init([jnp.zeros(3)]))
    with pytest.raises(ValueError, match="schedule"):
        Lion([torch.nn.Parameter(torch.zeros(3))], lambda step: LR).step(
            [torch.ones(3)])
    with pytest.raises(ValueError):
        opt2.load_state_dict({"momentum": saved["momentum"][:2]})
