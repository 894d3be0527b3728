"""Device-time breakdown of one warm text-to-image generate call.

    python -m showo_tpu_torch.profile_t2i --route fused
    python -m showo_tpu_torch.profile_t2i --slice v2 --route packed
    python -m showo_tpu_torch.profile_t2i --slice mmu_v2
    python -m showo_tpu_torch.profile_t2i --slice t2v | t2v_long

Builds the pipeline of ``configs/showo_demo_512x512.yaml`` (Show-o 1.3B,
random weights from a fixed seed, bf16, 16 steps, CFG 1.75, batch 2), or
with ``--slice v2`` that of ``configs/showo2_1.5b_demo_432x432.yaml``
(Show-o2 1.5B, 50-point Euler, CFG 7.5, batch 4), on one attention route,
warms it up, and profiles one ``generate`` call (with ``--slice mmu_v2``
one Show-o2 understanding answer instead: the in-tree image at 432x432,
100 greedy tokens, int8 weights, the ``mmu_v2_int8`` bench row; with
``--slice t2v`` one Show-o2 text-to-video generate of the ``t2v`` bench
row, 1 prompt, 2 latent frames, 20-point Euler, CFG 5.0, and with
``t2v_long`` of 9 latent frames, each on ``--route``, whose ``auto`` is
packed at 2 and streaming at 9 latent frames) with
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


def _device_events(prof) -> list:
    """(start us, end us, name) of the trace's device events, read from
    the profiler's raw results: ``prof.events()`` first builds the event
    tree of the whole trace, which takes far longer for a call of ~150,000
    launches.  The same events as its device rows: hidden events and the
    profiler's own rows left out."""
    cuda = torch.autograd.DeviceType.CUDA
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()          # as the tree counts: from here
    return [((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.name())
            for e in results.events()
            if e.device_type() == cuda and e.name() not in _PROFILER_ROWS
            and not getattr(e, "is_hidden_event", lambda: False)()]


def _busy_ms(events) -> tuple:
    """(busy ms, span ms, kernel count) of the device events: the union
    of their intervals, and first start to last end."""
    spans = sorted((start, end) for start, end, _ in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3, len(spans)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", default="auto")
    ap.add_argument("--slice", default="v1",
                    choices=("v1", "v2", "mmu_v2", "t2v", "t2v_long"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_t2i needs a CUDA card")
    if args.slice == "mmu_v2":
        from PIL import Image

        from showo_tpu_torch import inference_mmu_v2
        from showo_tpu_torch.utils.image import image_transform

        config = load_config("configs/showo2_1.5b_demo_432x432.yaml",
                             ["int8=1", "max_new_tokens=100", "top_k=1"])
        pipe = inference_mmu_v2.build_pipeline(config, torch.device("cuda"))
        image = image_transform(Image.open(
            "assets/validation/test_image.png").convert("RGB"),
            pipe.resolution)
        gen = torch.Generator(device="cuda").manual_seed(0)
        question = "What is in this image?"
        pipe.answer(image, question, gen)                      # warm-up
        torch.cuda.synchronize()
        profile(lambda: pipe.answer(image, question, gen),
                "Show-o2 understanding, int8: one answer")
        return
    if args.slice in ("t2v", "t2v_long"):
        config = load_config("configs/showo2_1.5b_demo_432x432.yaml")
        pipe = inference_t2i_v2.build_t2v_pipeline(
            config, torch.device("cuda"), attn_impl=args.route,
            num_latent_frames=2 if args.slice == "t2v" else 9,
            guidance_scale=5.0, num_steps=20)
        prompts = inference_t2i_v2.load_prompts(config)[:1]
        route = pipe.route(pipe.build_inputs(prompts)[0].shape[1])
    elif args.slice == "v2":
        config = load_config("configs/showo2_1.5b_demo_432x432.yaml")
        pipe = inference_t2i_v2.build_pipeline(config, torch.device("cuda"),
                                               attn_impl=args.route)
        prompts = inference_t2i_v2.load_prompts(config)[:4]
        route = pipe.attn_route
    else:
        config = load_config("configs/showo_demo_512x512.yaml",
                             ["guidance_scale=1.75",
                              "generation_timesteps=16"])
        pipe = inference_t2i.build_pipeline(config, torch.device("cuda"),
                                            attn_impl=args.route)
        prompts = inference_t2i.load_prompts(config)[:2]
        route = pipe.attn_route
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                                # warm-up
    torch.cuda.synchronize()

    profile(lambda: pipe.generate(prompts, gen),
            f"route {route}: generate")


def profile(fn, label: str, rows_shown: int = 15,
            by_operator: bool = True) -> dict:
    """Profile one call of ``fn`` (CPU and CUDA activities) and print its
    wall time, the device's busy time within its kernel span (and so its
    idle share), the kernel launches, and the largest rows of device time
    by operator, or by kernel for the port's own kernels.  Returns the
    wall s, busy and span ms, idle share, launches, the seconds it took
    to read the device events back, and the launches and device ms of
    each kernel by its name.  ``by_operator=False`` traces
    the CUDA activity alone and prints no rows (a call of ~150,000
    launches, an understanding answer, then reads back in seconds rather
    than minutes)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if by_operator:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = _device_events(prof)
    read = time.perf_counter() - t0
    if not kernels:
        raise SystemExit("the profiler recorded no device events")
    busy, span, count = _busy_ms(kernels)
    print(f"{label} {wall:.4f} s wall; device busy {busy:.2f} ms of a "
          f"{span:.2f} ms kernel span (idle share {1 - busy / span:.4f}); "
          f"{count} kernel launches (trace read in {read:.2f} s)")
    result = {"wall_s": wall, "busy_ms": busy, "span_ms": span,
              "idle_share": 1 - busy / span, "launches": count,
              "read_s": read, "by_kernel": _by_kernel(kernels)}
    if not by_operator:
        return result
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
    return result


def _by_kernel(events) -> dict:
    """{kernel name: [launches, device ms]} of the device events."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for start, end, name in events:
        row = out[name]
        row[0] += 1
        row[1] += (end - start) / 1e3
    return dict(out)


if __name__ == "__main__":
    main()
