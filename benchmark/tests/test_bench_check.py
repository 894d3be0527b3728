"""The check that decides ``correct``, at the tiny sizes on the CPU: the
program agrees with the plain reference, the control (the reference one
precision below the configuration's) fails, and a run whose timed path is
broken underneath comes out not correct."""

import os
import sys
import types
from unittest import mock

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT]

from benchmark import harness  # noqa: E402
from benchmark.tests.readings import overcommit, readings  # noqa: E402
from benchmark.tests.tiny import tiny  # noqa: E402

CELLS = ("t2i_v1_512", "t2i_v2_432", "t2i_v2_512", "train_v2_432")


def _run(cell, patch=None, seed=11):
    return harness.run(cell, seed, 0.5, False, device="cpu",
                       overrides=tiny(cell), patch=patch)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert c["value"] <= 1e-4, (name, c)


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" not in c])
def test_control_fails(cell):
    r = readings(cell, 5, 0.5, True, device="cpu", overrides=tiny(cell))
    limits = harness.cell(cell)["check"]["limits"]
    over = [k for k, v in r["readings"].items()
            if k.endswith(".control") and v > limits[k.split(".")[0]]]
    assert over, r["readings"]


def test_train_control_and_half_batch_stand_apart():
    # at these widths and depths the fp8 control's gaps are a third of
    # the published sizes' (where it fails, PERF.md); here each control
    # number stands far above the program's, and the half batch fails
    cell = "train_v2_432"
    r = readings(cell, 5, 0.5, True, device="cpu",
                 overrides=tiny(cell))["readings"]
    limits = harness.cell(cell)["check"]["limits"]
    for k, v in r.items():
        if k.endswith(".control"):
            assert v >= 100 * max(r[k.split(".")[0]], 1e-6), (k, r)
    assert any(v > limits[k.split(".")[0]] for k, v in r.items()
               if k.endswith(".half_batch")), r


def _alter_codes(drv):
    gen = drv.pipe.generate_codes

    def altered(*a, **k):
        codes = gen(*a, **k).clone()
        codes[:, 0] = (codes[:, 0] + 1) % drv.cfg.codebook_size
        return codes

    drv.pipe.generate_codes = altered


def _alter_latents(drv):
    gen = drv.pipe.generate_latents

    def altered(*a, **k):
        lat = gen(*a, **k).clone()
        lat[0] = -lat[0]
        return lat

    drv.pipe.generate_latents = altered


def test_v1_token_altered_where_produced_fails():
    assert not _run("t2i_v1_512", _alter_codes)["correct"]


def test_v1_step_that_keeps_its_state_fails():
    from showo_tpu_torch.sampling import maskgit

    # every unknown token re-masked: the step returns its state unchanged
    keep = lambda selected, temp, noise, mask_len: \
        selected < torch.finfo(selected.dtype).max
    with mock.patch.object(maskgit, "_remask", keep):
        assert not _run("t2i_v1_512")["correct"]


def test_v1_step_that_commits_too_many_fails():
    # a tenth more tokens committed a step than the schedule's count
    with overcommit():
        line = _run("t2i_v1_512")
    c = line["checks"]["overcommit"]
    assert c["value"] > c["limit"] and not line["correct"]


def test_v2_answer_altered_where_produced_fails():
    assert not _run("t2i_v2_432", _alter_latents)["correct"]


def test_v2_step_that_keeps_its_state_fails():
    def zero_step(drv):
        drift = drv.pipe.drift

        def broken(text, mp):
            f = drift(text, mp)
            calls = []

            def g(x, t):
                calls.append(1)
                v = f(x, t)
                return torch.zeros_like(v) if len(calls) == 2 else v

            return g

        drv.pipe.drift = broken

    assert not _run("t2i_v2_432", zero_step)["correct"]


def test_train_step_that_keeps_its_state_fails():
    from showo_tpu_torch.training.train_step import Optimizer

    with mock.patch.object(Optimizer, "update", lambda self, grads: False):
        assert not _run("train_v2_432")["correct"]


def test_train_step_after_the_checked_ones_that_keeps_its_state_fails():
    from showo_tpu_torch.training.train_step import Optimizer

    update = Optimizer.update

    # sound for the three checked steps, then the state left unchanged
    def late_noop(self, grads):
        return update(self, grads) if self.steps < 3 else False

    with mock.patch.object(Optimizer, "update", late_noop):
        line = _run("train_v2_432")
    assert line["checks"]["loss_rel"]["value"] <= 1e-4
    assert line["checks"]["late_change_gap"]["value"] > \
        line["checks"]["late_change_gap"]["limit"]
    assert not line["correct"]


def test_jax_loaded_after_the_window_gives_no_result():
    assert "jax" not in sys.modules

    def loads_jax(drv):
        check = drv.check

        def checked(*a, **k):
            sys.modules["jax"] = types.ModuleType("jax")
            return check(*a, **k)

        drv.check = checked

    try:
        with pytest.raises(SystemExit):
            _run("t2i_v1_512", loads_jax)
    finally:
        sys.modules.pop("jax", None)


def test_train_half_the_batch_left_out_fails():
    from showo_tpu_torch.show_o2.train_stage_one import Stage1Trainer

    whole = Stage1Trainer.train_step

    def half(self, batch, generator=None, noise=None):
        n = len(batch["text_tokens"]) // 2
        return whole(self, {k: v[:n] for k, v in batch.items()}, generator,
                     {k: v[:n] for k, v in noise.items()})

    with mock.patch.object(Stage1Trainer, "train_step", half):
        assert not _run("train_v2_432")["correct"]
