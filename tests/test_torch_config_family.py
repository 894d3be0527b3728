"""The port's config dataclasses against the JAX package's, field for
field, on every YAML of ``configs/`` (the Show-o v1 and Show-o2 1.5B / 7B
families): each side builds its dataclasses from the same file through its
own code.

* v1: ``ShowoConfig`` with its ``PhiConfig`` (``build_showo_config``), the
  codec's ``VQConfig`` (``load_vq``, caught before any weight is made),
  ``ClipVitConfig`` (the CLIP-ViT tower's, caught in ``build_clip`` and the
  CLIP trainer's ``build_clip_tower``) and the trainer's ``TrainConfig``
  (JAX's caught where ``ShowoTrainer`` / the CLIP trainer hands it to the
  optimizer; the port's ``ShowoTrainer.train_config``, and the CLIP
  trainer's as its ``__post_init__`` hands it on).
* Show-o2: ``Showo2Config`` with its ``Qwen2Config``, ``SigLipConfig`` and
  ``DiffusionHeadConfig`` (``build_showo2_config``), and the VAE's
  ``WanVAEConfig`` (JAX ``load_models`` takes the default).

Fields only JAX has are XLA's scan unrolling (``scan_unroll``), which the
port has no use for.  The port casts a YAML string such as ``1e-4`` to a
float where JAX keeps the string (the trainer's learning rate): equal when
the float of JAX's string is the port's value.
"""

import dataclasses
import os
import types
from unittest import mock

import pytest

from showo_tpu import config as jconfig
from showo_tpu import inference_t2i as jinf
from showo_tpu import inference_t2i_v2 as jinf2
from showo_tpu.models import clip_vit as jclip
from showo_tpu.models import magvit as jmagvit
from showo_tpu.show_o2 import wan_vae as jwan
from showo_tpu.training import train_showo as jtrain
from showo_tpu.training import train_showo_clip as jtrain_clip
from showo_tpu_torch import config as tconfig
from showo_tpu_torch import inference_mmu as tmmu
from showo_tpu_torch import inference_t2i as tinf
from showo_tpu_torch import inference_t2i_v2 as tinf2
from showo_tpu_torch.training import train_showo as ttrain
from showo_tpu_torch.training import train_showo_clip as ttrain_clip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".yaml"))
JAX_ONLY = {"scan_unroll"}


class _Caught(Exception):
    """Raised by a stand-in once it has the dataclass it was handed."""


def _catch(store, index=0):
    def stand_in(*args, **kw):
        store.append(args[index])
        raise _Caught
    return stand_in


def _same(got, want, path="config"):
    """Field for field: the same dataclass fields (but ``JAX_ONLY``) and
    equal values, nested dataclasses compared the same way."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), path
        names = {f.name for f in dataclasses.fields(want)} - JAX_ONLY
        assert {f.name for f in dataclasses.fields(got)} == names, path
        for name in sorted(names):
            _same(getattr(got, name), getattr(want, name), f"{path}.{name}")
    elif isinstance(want, str) and isinstance(got, float):
        assert float(want) == got, path
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _vq_configs(jc, tc):
    jcaught, tcaught = [], []
    with mock.patch.object(jmagvit, "MagvitV2", _catch(jcaught)), \
            pytest.raises(_Caught):
        jinf.load_vq(jc)
    with mock.patch.object(tinf, "init_magvit", _catch(tcaught)), \
            pytest.raises(_Caught):
        tinf.load_vq(tc, "cpu")
    return tcaught[0], jcaught[0]


def _train_configs(name, jc, tc):
    """(port, JAX) TrainConfig of the trainer that reads ``name``: the
    CLIP-ViT trainer for the w_clip_vit configs, else ShowoTrainer."""
    jcaught = []
    stub = dict(uni_prompting=None)
    if "w_clip_vit" in name:
        with mock.patch.object(jtrain_clip, "make_projector_lr_optimizer",
                               _catch(jcaught)), pytest.raises(_Caught):
            jtrain_clip.ClipShowoTrainer(config=jc, cfg=None, vq_cfg=None,
                                         params=None, vq_params=None, **stub)
        tcaught = []
        with mock.patch.object(ttrain_clip, "make_projector_lr_optimizer",
                               _catch(tcaught)), pytest.raises(_Caught):
            ttrain_clip.ClipShowoTrainer(
                config=tc, model=types.SimpleNamespace(cfg=None), vq=None,
                **stub)
        return tcaught[0], jcaught[0]
    with mock.patch.object(jtrain, "make_optimizer", _catch(jcaught)), \
            pytest.raises(_Caught):
        jtrain.ShowoTrainer(config=jc, cfg=None, vq_cfg=None, params=None,
                            vq_params=None, **stub)
    got = ttrain.ShowoTrainer.train_config(
        types.SimpleNamespace(config=tc, attn_impl=None))
    return got, jcaught[0]


def _clip_config(tc):
    caught = []
    with mock.patch.object(tmmu, "ClipVisionTower", _catch(caught)), \
            pytest.raises(_Caught):
        tmmu.build_clip(tc, "cpu")
    trainer = []
    with mock.patch.object(ttrain_clip, "ClipVisionTower", _catch(trainer)), \
            pytest.raises(_Caught):
        ttrain_clip.build_clip_tower(tc, "cpu")
    assert trainer[0] == caught[0]
    return caught[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_dataclasses_match_jax(name):
    path = os.path.join(REPO, "configs", name)
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    if name.startswith("showo2_"):
        _same(tinf2.build_showo2_config(tc), jinf2.build_showo2_config(jc))
        _same(tinf2.vae_config(tc), jwan.WanVAEConfig())
        return
    _same(tinf.build_showo_config(tc), jinf.build_showo_config(jc))
    _same(*_vq_configs(jc, tc))
    # JAX's CLIP-ViT tower: the config's clip_vit dims over CLIP-L/14-336
    _same(_clip_config(tc), jclip.ClipVitConfig(**{
        k: int(v) for k, v in dict(jc.model.showo.get("clip_vit",
                                                       {})).items()}))
    if "training" in jc:
        _same(*_train_configs(name, jc, tc))


def test_the_family_is_whole():
    """Every YAML of ``configs/`` is a case: 15 v1 and 18 Show-o2 (1.5B and
    7B)."""
    assert len(CONFIGS) == 33
    assert sum(n.startswith("showo2_") for n in CONFIGS) == 18
    assert sum(n.startswith("showo2_7b") for n in CONFIGS) == 7
