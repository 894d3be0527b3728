"""The benchmark's general part: it finds a cell's files by name, runs the
cell's driver through set-up, the measured window and the check, and forms
the result line.

A cell is ``workloads/<cell>.json``: its configuration, the module
``drivers/<entry>.py`` that builds the program through its entry points,
the program settings it runs (``program``: a key of the configuration's
``programs``, the published YAML as it is run), chips, traffic, the
metrics it reports, its check and the limits of the numbers compared.  The
configuration is ``configs/<config>.json``.
A per-layer metric is ``metrics/<name>.py``, with ``LAYER``, ``UNIT``,
``BETTER``, ``MOVES`` and ``read(ctx)``, which returns None where it finds
nothing to read.  Adding a cell, a configuration or a metric adds files and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# compared by whole top-level names: showo_tpu_torch is not showo_tpu
FORBIDDEN = ("jax", "jaxlib", "flax", "showo_tpu")

E2E_UNITS = {"images_per_min": "images/min", "train_samples_per_s":
             "samples/s", "peak_mem_gib": "GiB", "setup_s": "s"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def names(kind: str, suffix: str) -> List[str]:
    d = os.path.join(BENCH, kind)
    return sorted(f[:-len(suffix)] for f in os.listdir(d)
                  if f.endswith(suffix) and not f.startswith("_"))


def cell(name: str) -> dict:
    """The workload file of ``name`` with its configuration under
    ``config_file``."""
    path = os.path.join(BENCH, "workloads", name + ".json")
    if not os.path.isfile(path):
        raise SystemExit(f"no cell {name!r}; cells: "
                         f"{', '.join(names('workloads', '.json'))}")
    wl = load_json(path)
    wl["name"] = name
    wl["config_file"] = load_json(os.path.join(BENCH, "configs",
                                               wl["config"] + ".json"))
    return wl


def _load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    return _load(os.path.join(BENCH, "metrics", name + ".py"),
                 "benchmark_metric_" + name.replace(".", "_"))


def driver(entry: str):
    return _load(os.path.join(BENCH, "drivers", entry + ".py"),
                 "benchmark_driver_" + entry)


def forbidden_loaded(modules=None) -> List[str]:
    """The top-level names of ``modules`` (``sys.modules``) that are JAX's
    or the JAX package's."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def _check_imports(where: str) -> None:
    found = forbidden_loaded()
    if found:
        print(f"benchmark: {', '.join(found)} loaded {where}",
              file=sys.stderr)
        raise SystemExit(3)


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: Optional[dict] = None,
        t_start: Optional[float] = None, patch=None) -> dict:
    """One run of cell ``name``: set-up, the window, the check.  Returns
    the result line as a dict (``checks`` last).  ``overrides`` (the
    tests' tiny sizes) and ``patch`` (a callable given the cell's Driver after
    set-up, which the tests use to break the timed path) never come from
    the command line."""
    import torch

    from benchmark.trace import Spans, read_profiler, start_profiler

    t_start = time.perf_counter() if t_start is None else t_start
    seed = int(seed) % (1 << 64)
    wl = cell(name)
    cuda = device == "cuda"
    drv = driver(wl["entry"]).Driver(wl, seed, device, overrides or {})
    spans = Spans()
    drv.setup(spans)
    if patch is not None:
        patch(drv)
    traced = int(wl.get("trace_requests", 1)) if trace and cuda else 0
    if traced:
        # the profiler's first session pays its own start-up on the
        # device's timeline: spend it in set-up
        warm = start_profiler()
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
        warm.__exit__(None, None, None)
    if cuda:
        torch.cuda.synchronize()
    _check_imports("after set-up")
    setup_s = time.perf_counter() - t_start
    spans.items.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # a traced run profiles the window's first ``trace_requests``
    # requests (a trace of ~10^5 launches a request loses events past a
    # few), then runs on untraced to the window's end
    prof = tr = None
    units = attempted = traced_units = 0
    t0 = time.perf_counter()
    while True:
        if attempted == 0 and traced:
            spans.profile = True
            prof = start_profiler()
            tp0 = time.perf_counter()
        units += drv.step(attempted, spans)
        attempted += 1
        if prof is not None and attempted == traced:
            drv.finish()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - tp0
            prof.__exit__(None, None, None)
            spans.profile = False
            tr = read_profiler(prof, traced_s)
            prof, traced_units = None, units
        if time.perf_counter() - t0 >= seconds:
            break
    drv.finish()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _check_imports("after the window")

    ctx = SimpleNamespace(cell=wl, driver=drv, spans=spans, trace=tr,
                          units=traced_units,
                          records=drv.records[:traced],
                          window_s=window_s)
    metrics: Dict[str, dict] = {}
    if not trace:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
                  drv.RATE: units / window_s * drv.RATE_SCALE}
        for m in wl["end_to_end"]:
            metrics[m] = {"value": values[m], "unit": E2E_UNITS[m]}
    else:
        for m in wl["per_layer"]:
            mod = metric(m)
            v = mod.read(ctx)
            if v is not None:
                metrics[m] = {"value": v, "unit": mod.UNIT}
    checks = drv.check()
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": attempted, "failed": 0,
            "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    # the metrics' readers and the reference ran after the window
    _check_imports("after the check")
    return line
