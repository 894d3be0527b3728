"""Device-time breakdown of one warm text-to-image generate call.

    python -m showo_tpu_torch.profile_t2i --route fused
    python -m showo_tpu_torch.profile_t2i --slice v2 --route packed

Builds the pipeline of ``configs/showo_demo_512x512.yaml`` (Show-o 1.3B,
random weights from a fixed seed, bf16, 16 steps, CFG 1.75, batch 2), or
with ``--slice v2`` that of ``configs/showo2_1.5b_demo_432x432.yaml``
(Show-o2 1.5B, 50-point Euler, CFG 7.5, batch 4), on one attention route,
warms it up, and profiles one ``generate`` call with
``torch.profiler`` (CPU and CUDA activities).  Prints the wall time, the
device's busy time within its kernel span (and so its idle share), the
number of kernel launches, and the 15 largest rows of device time by
operator (or by kernel, for the port's own kernels, which no operator
launches), each with its share of the busy time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import time

import torch

from showo_tpu_torch import inference_t2i, inference_t2i_v2
from showo_tpu_torch.config import load_config

# the port's kernels (csrc/), listed by their __global__ names
_OURS = ("fused::", "agrad90::", "wsmm::")
# a profiler row of the CUDA runtime (launches that waited for room in the
# command queue), not an operator: the device time under it is counted
# again in the rows of the operators and kernels it held up
_NOT_OPERATORS = ("Command Buffer Full",)
# the profiler's own device rows when its activity buffers fill (a call of
# ~200,000 launches): not work of the program
_PROFILER_ROWS = ("Activity Buffer Request", "Buffer Flush")


def _busy_ms(events) -> tuple:
    """(busy ms, span ms, kernel count) of the device events: the union
    of their intervals, and first start to last end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3, len(spans)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", default="auto")
    ap.add_argument("--slice", default="v1", choices=("v1", "v2"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_t2i needs a CUDA card")
    if args.slice == "v2":
        config = load_config("configs/showo2_1.5b_demo_432x432.yaml")
        pipe = inference_t2i_v2.build_pipeline(config, torch.device("cuda"),
                                               attn_impl=args.route)
        prompts = inference_t2i_v2.load_prompts(config)[:4]
    else:
        config = load_config("configs/showo_demo_512x512.yaml",
                             ["guidance_scale=1.75",
                              "generation_timesteps=16"])
        pipe = inference_t2i.build_pipeline(config, torch.device("cuda"),
                                            attn_impl=args.route)
        prompts = inference_t2i.load_prompts(config)[:2]
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                                # warm-up
    torch.cuda.synchronize()

    profile(lambda: pipe.generate(prompts, gen),
            f"route {pipe.attn_route}: generate")


def profile(fn, label: str, rows_shown: int = 15) -> dict:
    """Profile one call of ``fn`` (CPU and CUDA activities) and print its
    wall time, the device's busy time within its kernel span (and so its
    idle share), the kernel launches, and the largest rows of device time
    by operator, or by kernel for the port's own kernels.  Returns the
    wall s, busy and span ms, idle share, launches, and the launches and
    device ms of each kernel by its name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in _PROFILER_ROWS]
    if not kernels:
        raise SystemExit("the profiler recorded no device events")
    busy, span, count = _busy_ms(kernels)
    print(f"{label} {wall:.4f} s wall; device busy {busy:.2f} ms of a "
          f"{span:.2f} ms kernel span (idle share {1 - busy / span:.4f}); "
          f"{count} kernel launches")
    # device time of the operators that launched kernels, and of the
    # port's own kernels, which no operator launches (ctypes calls)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rows = [a for a in prof.key_averages()
            if a.self_device_time_total > 0 and (
                (a.device_type == cpu and not a.key.startswith("cuda")
                 and a.key not in _NOT_OPERATORS + _PROFILER_ROWS)
                or (a.device_type == cuda and any(k in a.key for k in _OURS)))]
    rows.sort(key=lambda a: -a.self_device_time_total)
    print(f"{'operator or kernel':<48} {'calls':>7} {'device ms':>10} "
          f"{'share':>7}")
    for a in rows[:rows_shown]:
        ms = a.self_device_time_total / 1e3
        print(f"{a.key[:48]:<48} {a.count:>7} {ms:>10.2f} "
              f"{ms / busy:>7.1%}")
    listed = sum(a.self_device_time_total for a in rows) / 1e3
    print(f"all rows: {listed:.2f} ms of the {busy:.2f} ms busy")
    return {"wall_s": wall, "busy_ms": busy, "span_ms": span,
            "idle_share": 1 - busy / span, "launches": count,
            "by_kernel": _by_kernel(kernels)}


def _by_kernel(events) -> dict:
    """{kernel name: [launches, device ms]} of the device events."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        row = out[e.name]
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(out)


if __name__ == "__main__":
    main()
