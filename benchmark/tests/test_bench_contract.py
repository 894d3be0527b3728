"""The benchmark's files against its contract: names, units, the metrics'
layers and cells, the FLOP and byte counts, the no-JAX check, and a cell,
a configuration and a metric added as new files only."""

import json
import math
import os
import re
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT]

from benchmark import harness  # noqa: E402
from benchmark.roofline import attention_launch  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        cell = harness.cell(w["traffic"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]


def test_metrics_layers_and_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: harness.cell(w["traffic"])
             for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["layer"] and m["moves"] in e2e and m["workloads"]
        mod = harness.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.BETTER) == (
            m["layer"], m["unit"], m["moves"], m["better"])
        for c in m["workloads"]:
            assert m["moves"] in cells[c]["end_to_end"]
            assert m["name"] in cells[c]["per_layer"]
    for name, cell in cells.items():
        assert "setup_s" in cell["end_to_end"] and len(
            cell["end_to_end"]) >= 2
        listed = [m["name"] for m in bench["per_layer"]
                  if name in m["workloads"]]
        assert sorted(listed) == sorted(cell["per_layer"])
        for m in cell["end_to_end"]:
            if "workloads" in e2e[m]:
                assert name in e2e[m]["workloads"]


def test_kernel1_counts_by_hand():
    # the v1 cached step: 8 rows (CFG), 1026 q rows, 1155 keys, 32 heads
    # of 64; q, k, v and the output once in bf16
    vis = 8 * 1026 * 1100
    k = attention_launch(8, 1026, 1155, 32, 32, 64, vis)
    assert k.flops == 4 * 64 * 32 * vis
    assert k.bytes == 2 * (2 * 8 * 1026 * 2048 + 2 * 8 * 1155 * 2048)
    assert math.isclose(k.least_s, max(k.flops / 989e12, k.bytes / 3.35e12))
    # Qwen's GQA: k and v at the kv heads only
    q = attention_launch(8, 768, 768, 12, 2, 128, 100)
    assert q.bytes == 2 * (2 * 8 * 768 * 1536 + 2 * 8 * 768 * 256)


def _driver(cell):
    wl = harness.cell(cell)
    return harness.driver(wl["entry"]).Driver(wl, 1, "cpu",
                                                             {})


def test_v1_model_flops_by_hand():
    drv = _driver("t2i_v1_512")
    prompts = ["a b c"] * 4
    vis_step, vis_prefix = drv.layout_counts(prompts)
    # every image-span row sees every key but the pads
    pads = 129 - 6      # [t2i][bos] a b c [eos]
    null_pads = 129 - 3  # [t2i][bos][eos]
    assert vis_step == 4 * 1026 * (1155 - pads) + 4 * 1026 * (1155 - null_pads)
    per_tok = 24 * 2 * (4 * 2048 ** 2 + 2 * 2048 * 8192)
    step = (8 * 1026 * per_tok + 24 * 4 * 2048 * vis_step
            + 2 * 8 * 1024 * 2048 * 8192)
    prefill = 8 * 129 * per_tok + 24 * 4 * 2048 * vis_prefix
    got = drv.unit_flops(prompts)
    dec = got - 50 * step - prefill
    # the MAGVIT decoder: 4 images from 32 x 32 codes, a few TFLOP
    assert 1e12 < dec < 2e13


def test_v2_model_flops_by_hand():
    drv = _driver("t2i_v2_432")
    prompts = ["w"] * 4
    text, offs = drv.layout(prompts)
    assert tuple(text.shape) == (8, 768)
    tok = 8 * 768
    qwen = 28 * 2 * (1536 * (1536 + 2 * 256) + 1536 * 1536
                     + 3 * 1536 * 8960)
    dit = 10 * 2 * (2048 * (2048 + 2 * 512) + 2048 * 2048
                    + 3 * 2048 * 8192)
    sig = 26 * 2 * (4 * 1152 ** 2 + 2 * 1152 * 4304)
    per_eval = tok * (qwen + dit) + 8 * 729 * sig
    evals = drv.unit_flops(prompts) - drv.decode_flops(4)
    # the rest: attention scores, the embeddings, the fusion, the
    # projections between the towers: a few percent
    assert 1.0 < evals / (49 * per_eval) < 1.15


def test_no_jax_check_compares_whole_names():
    ok = ["torch", "showo_tpu_torch", "showo_tpu_torch.x", "jaxtyping",
          "flaxen", "benchmark.harness"]
    assert harness.forbidden_loaded(ok) == []
    bad = ok + ["showo_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_loaded(bad) == ["flax", "jax", "jaxlib",
                                             "showo_tpu"]


def test_traffic_sends_the_prompt_list_in_an_order_of_each_seed():
    from benchmark import traffic

    tr = harness.cell("t2i_v1_512")["traffic"]
    pool = traffic.prompt_list(tr["prompts"])
    assert len(pool) == 40
    n = len(pool)
    for seed in (1, 2 ** 31 + 5):
        sent = traffic.prompts(seed, tr, 2 * n)
        assert sorted(sent[:n]) == sorted(pool) == sorted(sent[n:])
        assert traffic.prompts(seed, tr, 2 * n) == sent
    assert traffic.prompts(1, tr, n) != traffic.prompts(2, tr, n)
    b = traffic.batches(3, tr, 5)
    assert [len(x) for x in b] == [tr["batch"]] * 5
    assert sum(b, []) == traffic.prompts(3, tr, 5 * tr["batch"])


def test_run_refuses_without_cuda():
    from benchmark import run

    if harness.cell("t2i_v1_512") and not __import__("torch").cuda \
            .is_available():
        assert run.main(["--workload", "t2i_v1_512", "--seed", "1",
                         "--seconds", "1"]) != 0


def test_added_files_are_found_without_edits(tmp_path):
    """A new cell, configuration and metric as files of their own, in a
    copy of the benchmark: the harness lists and loads them."""
    copy = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.load(open(copy / "configs" / "showo_1.3b.json"))
    cfg["name"] = "new_config"
    json.dump(cfg, open(copy / "configs" / "new_config.json", "w"))
    wl = json.load(open(copy / "workloads" / "t2i_v1_512.json"))
    wl.update(config="new_config", per_layer=["new_metric"])
    json.dump(wl, open(copy / "workloads" / "new_cell.json", "w"))
    (copy / "metrics" / "new_metric.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nBETTER = "lower"\n'
        'MOVES = "images_per_min"\n\n\ndef read(ctx):\n'
        '    return 42.0 if ctx.trace is not None else None\n')
    mod = harness._load(str(copy / "harness.py"), "copied_harness")
    assert "new_cell" in mod.names("workloads", ".json")
    assert "new_config" in mod.names("configs", ".json")
    assert "new_metric" in mod.names("metrics", ".py")
    cell = mod.cell("new_cell")
    assert cell["config_file"]["name"] == "new_config"
    m = mod.metric("new_metric")
    assert m.read(type("C", (), {"trace": object()})) == 42.0
    assert mod.driver(cell["entry"]).Driver
