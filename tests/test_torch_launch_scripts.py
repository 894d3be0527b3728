"""The port's twins of the launch scripts (``showo_tpu_torch/scripts/``)
against the JAX package's (``scripts/``), on the CPU.

* Each twin read as a list of stages: the same runs in the same order
  (each module the original's with ``showo_tpu_torch`` for ``showo_tpu``,
  each config and override the same), the same promotions (the latest
  ``checkpoint-N`` of one output directory copied to the next one's
  ``checkpoint-0``, by the same shell code), the same environment
  overrides and defaults; every run passes the script's further
  ``key=value`` arguments on (the one difference), every module is the
  port's and has a ``main``, and no twin names ``showo_tpu.``.
* The Show-o2 1.5B stage-1 twin run at tiny dims on the CPU: ``CFG_A`` /
  ``CFG_B`` at tiny YAMLs, one step each, ``device=cpu`` given to the
  script.  Stage 1b's ``checkpoint-0`` is stage 1a's last checkpoint byte
  for byte, stage 1b resumes from it (its own first checkpoint is step
  2), and its weights are those of a stage-1b run resumed in process from
  a copy of that checkpoint (within atol 1e-6, the resume tolerance of
  tests/test_torch_show_o2_train.py: the subprocess sums on more
  threads), and not those of a stage-1b run from scratch.
"""

import filecmp
import importlib
import json
import os
import re
import shlex
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from showo_tpu_torch.config import load_config
from showo_tpu_torch.show_o2 import train_stage_one as t1
from test_torch_show_o2_train import CLI_TINY, _jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIGINALS = os.path.join(REPO, "scripts")
TWINS = os.path.join(REPO, "showo_tpu_torch", "scripts")
NAMES = sorted(n for n in os.listdir(ORIGINALS) if n.endswith(".sh"))
# the twins' pass-through of further key=value arguments
EXTRAS = ("$@", "${@:2}")
_VAR = re.compile(r"\$\{(\w+)(?::-([^}]*))?\}|\$(\w+)")


def _lines(path):
    """The script's logical lines: continuations joined, comments and
    blank lines dropped."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words:
            out.append((line.strip(), words))
    return out


def _expand(word, env):
    """``word`` with ``${X:-default}``, ``${X}`` and ``$X`` expanded as bash
    would with no environment overrides and no positional arguments."""
    def sub(m):
        name = m.group(1) or m.group(3)
        if name in env:
            return env[name]
        if m.group(2) is not None:
            return m.group(2)
        raise AssertionError(f"unset variable {name} in {word!r}")
    return _VAR.sub(sub, word)


def parse(path):
    """(stages, env defaults, shell functions) of a launch script: stages
    ("run", module, args, passes extras) and ("promote", src, dst)."""
    stages, env, funcs, latest = [], {}, {}, None
    lines = iter(_lines(path))
    for raw, words in lines:
        if words[:2] == ["set", "-euo"] or words[0] in ("mkdir", "local"):
            continue
        if re.match(r"^\w+\(\)", raw):                  # a function
            body = []
            for raw_b, _ in lines:
                if raw_b == "}":
                    break
                body.append(raw_b)
            funcs[raw.split("(")[0]] = body
        elif words[0] == "python":
            assert words[1] == "-m", raw
            args = words[3:]
            extras = bool(args) and args[-1] in EXTRAS
            if extras:
                args = args[:-1]
            assert not any("$@" in a or "${@" in a for a in args), raw
            stages.append(("run", words[2],
                           tuple(_expand(a, env) for a in args), extras))
        elif words[0] == "promote":
            stages.append(("promote", _expand(words[1], env),
                           _expand(words[2], env)))
        elif words[0] == "cp":
            assert words[1:3] == ["-r", "$LATEST"] and latest, raw
            dst = _expand(words[3], env)
            assert dst.endswith("/checkpoint-0"), raw
            stages.append(("promote", latest, dst[:-len("/checkpoint-0")]))
        elif raw.startswith("LATEST="):
            m = re.match(r'^LATEST=\$\(ls -d "\$(\w+)"/checkpoint-\* \| '
                         r'sort -t- -k2 -n \| tail -1\)$', raw)
            assert m, raw
            latest = env[m.group(1)]
        elif re.match(r"^\w+=", words[0]) and len(words) == 1:
            name, value = words[0].split("=", 1)
            env[name] = _expand(value, env)
        else:
            raise AssertionError(f"{path}: unread line {raw!r}")
    return stages, env, funcs


def test_every_original_has_a_twin():
    assert NAMES and NAMES == sorted(n for n in os.listdir(TWINS)
                                     if n.endswith(".sh"))
    for name in NAMES:
        assert os.access(os.path.join(TWINS, name), os.X_OK), name


@pytest.mark.parametrize("name", NAMES)
def test_twin_has_the_originals_stages(name):
    stages, env, funcs = parse(os.path.join(ORIGINALS, name))
    twin_stages, twin_env, twin_funcs = parse(os.path.join(TWINS, name))
    assert env == twin_env and funcs == twin_funcs
    assert len(stages) == len(twin_stages) > 0
    runs = 0
    for a, b in zip(stages, twin_stages):
        assert a[0] == b[0], (a, b)
        if a[0] == "promote":
            assert a == b
            continue
        runs += 1
        _, module, args, extras = a
        _, twin_module, twin_args, twin_extras = b
        assert module.startswith("showo_tpu.") and not extras
        assert twin_module == "showo_tpu_torch." + module[len("showo_tpu."):]
        assert twin_args == args and twin_extras
        mod = importlib.import_module(twin_module)
        assert callable(mod.main)
        assert os.path.abspath(mod.__file__).startswith(
            os.path.join(REPO, "showo_tpu_torch") + os.sep)
        # every config the stage names is in the repository
        for arg in args:
            if arg.startswith("config="):
                assert os.path.isfile(os.path.join(REPO, arg[7:])), arg
    assert runs >= 1
    with open(os.path.join(TWINS, name)) as f:
        assert not re.search(r"showo_tpu\.", f.read())


def _tiny_yaml(tmp_path, stage, data, steps):
    """The stage's config at CLI_TINY's dims, ``steps`` steps, a checkpoint
    each step, written as a YAML file; the output directory the
    config's own (relative, as the scripts use it)."""
    config = load_config(
        os.path.join(REPO, "configs", f"showo2_1.5b_stage_1_{stage}.yaml"),
        [o for o in CLI_TINY if o != "device=cpu"] + [
            f"dataset.params.t2i_jsonl={data}",
            f"dataset.params.mmu_jsonl={data}",
            "dataset.params.annotation_path=null",
            f"training.max_train_steps={steps}", "experiment.save_every=1",
            "experiment.generate_every=null", "validation_prompts=[a cat]"])
    path = tmp_path / f"stage_1_{stage}.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    return str(path)


def _env(**extra):
    """The environment of a twin's run: this interpreter first on PATH (the
    scripts call ``python``), the repository on PYTHONPATH."""
    path = os.pathsep.join([os.path.dirname(sys.executable),
                            os.environ.get("PATH", "")])
    pythonpath = os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return dict(os.environ, PATH=path, PYTHONPATH=pythonpath, **extra)


def _weights(path):
    return torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=False)["model"]


def test_stage1_chain_promotes_and_resumes(tmp_path):
    data = _jsonl(tmp_path, size=16)
    cfg_a = _tiny_yaml(tmp_path, "a", data, 1)
    cfg_b = _tiny_yaml(tmp_path, "b", data, 2)
    run = tmp_path / "run"
    run.mkdir()
    proc = subprocess.run(
        ["bash", os.path.join(TWINS, "train_showo2_1.5b_stage1.sh"),
         "device=cpu"], cwd=run, env=_env(CFG_A=cfg_a, CFG_B=cfg_b),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out_a, out_b = run / "show-o2-1.5b-stage1a", run / "show-o2-1.5b-stage1b"
    assert sorted(p.name for p in out_a.glob("checkpoint-*")) == [
        "checkpoint-1"]
    # promoted byte for byte; stage 1b resumed at step 1 and saved step 2
    promoted = out_b / "checkpoint-0"
    files = sorted(os.listdir(out_a / "checkpoint-1"))
    assert files == sorted(os.listdir(promoted)) and "state.pt" in files
    match, mismatch, errors = filecmp.cmpfiles(out_a / "checkpoint-1",
                                               promoted, files, shallow=False)
    assert match == files and not mismatch and not errors
    assert sorted(p.name for p in out_b.glob("checkpoint-*")) == [
        "checkpoint-0", "checkpoint-2"]
    assert "resumed from step 1" in proc.stderr
    chained = _weights(out_b / "checkpoint-2")
    # the same stage resumed in process from a copy of the promoted
    # checkpoint: bit for bit; from scratch: not
    resumed, scratch = tmp_path / "resumed", tmp_path / "scratch"
    shutil.copytree(promoted, resumed / "checkpoint-0")
    for out in (resumed, scratch):
        t1.main([f"config={cfg_b}", "device=cpu",
                 f"experiment.output_dir={out}"])
    same = _weights(resumed / "checkpoint-2")
    fresh = _weights(scratch / "checkpoint-2")
    assert chained.keys() == same.keys() == fresh.keys()
    for k in chained:       # the subprocess sums on more threads: fp32 order
        torch.testing.assert_close(chained[k], same[k], rtol=0, atol=1e-6,
                                   msg=k)
    assert max((chained[k] - fresh[k]).abs().max().item()
               for k in chained) > 1e-5


def test_stage1_twin_refuses_a_missing_stage(tmp_path):
    """``set -euo pipefail`` as in the original: a stage that fails stops
    the chain before any promotion (here stage 1a on a config that does
    not exist)."""
    proc = subprocess.run(
        ["bash", os.path.join(TWINS, "train_showo2_1.5b_stage1.sh"),
         "device=cpu"], cwd=tmp_path,
        env=_env(CFG_A=str(tmp_path / "missing.yaml")), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert not (tmp_path / "show-o2-1.5b-stage1b").exists()
