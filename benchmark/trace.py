"""Spans around calls into the program's layers, and the reduction of a
``torch.profiler`` trace of the measured window to device busy time, kernel
classes and idle gaps.

The device events are read from the profiler's raw results (building the
event tree of a trace of ~10^5 launches takes minutes).  Busy time is the
union of the kernels' intervals; the idle share is taken over the whole
traced window, from its first host instant to its last, so that host time
before the first kernel and after the last counts as idle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

# the profiler's own device rows, and runtime rows that are no kernel
NOT_KERNELS = ("Activity Buffer Request", "Buffer Flush",
               "Command Buffer Full")
MEMORY_OPS = ("Memcpy", "Memset")

# name fragments of matrix-multiply and convolution kernels (cuBLAS,
# cuBLASLt, CUTLASS, cuDNN); attention kernels: the port's forward cores
# (namespace agrad90) and PyTorch's own attention
GEMM_WORDS = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "cudnn",
              "implicit_convolve", "conv2d", "conv3d", "convolve", "dgrad",
              "wgrad", "fprop", "splitk", "wsmm", "matmul")
ATTENTION_WORDS = ("agrad90", "agrad::", "fused::", "flash", "fmha",
                   "attention")


def kernel_class(name: str) -> str:
    """"attention", "gemm" or "glue" (elementwise, reductions, norms,
    softmax, copies, the rest)."""
    low = name.lower()
    if any(w in low for w in ATTENTION_WORDS):
        return "attention"
    if any(w in low for w in GEMM_WORDS):
        return "gemm"
    return "glue"


class Spans:
    """Host-clock spans (name, start, end) in seconds of ``perf_counter``;
    with ``profile`` each is also a profiler range, so that the trace can
    tell which kernels a span launched."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self.profile = False

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        rf = (torch.profiler.record_function("bench/" + name)
              if self.profile else contextlib.nullcontext())
        with rf:
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.items.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.items if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.items if n == name)


@dataclasses.dataclass
class Trace:
    """Device kernels (start us, end us, name, correlation id) and the
    benchmark's ranges (start us, end us, name) of the traced window, on
    the profiler's clock; ``launch_us``: correlation id -> host time of the
    launch."""

    kernels: List[Tuple[float, float, str, int]]
    ranges: List[Tuple[float, float, str]]
    launch_us: Dict[int, float]
    window_s: float

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for s, e, _, _ in sorted(self.kernels):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def launches(self) -> int:
        return sum(1 for _, _, n, _ in self.kernels
                   if not n.startswith(MEMORY_OPS))

    def seconds_by(self, key) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for s, e, n, _ in self.kernels:
            out[key(n)] += (e - s) / 1e6
        return out

    def seconds_in(self, span: str) -> float:
        """Device seconds of the kernels launched inside the benchmark's
        ranges named ``span``."""
        spans = sorted((s, e) for s, e, n in self.ranges
                       if n == "bench/" + span)
        if not spans:
            return 0.0
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, _, corr in self.kernels:
            t = self.launch_us.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += (e - s) / 1e6
        return total

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time summed by the innermost benchmark range that
        holds each gap's midpoint ("outside" when none does), largest
        first."""
        ivs = sorted((s, e) for s, e, _, _ in self.kernels)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by: Dict[str, float] = collections.Counter()
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(e - s, n) for s, e, n in self.ranges if s <= mid <= e]
            name = min(inner)[1][len("bench/"):] if inner else "outside"
            by[name] += (b - a) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])
                ][:top]

    def top_ops(self, top: int = 10) -> List[list]:
        by = self.seconds_by(lambda n: n[:120])
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])
                ][:top]


def start_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def read_profiler(prof, window_s: float) -> Optional[Trace]:
    """The window's kernels, ranges and launch times from a stopped
    profiler; None when it recorded no device event."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    # host ranges (the benchmark's, the optimizer's) are mirrored on the
    # device's timeline under their names: no kernel has a host op's name
    host = {e.name() for e in events if e.device_type() != cuda}
    kernels, ranges, launch = [], [], {}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if (name in NOT_KERNELS or name in host
                    or getattr(e, "is_hidden_event", lambda: False)()):
                continue
            kernels.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name,
                            e.correlation_id()))
        elif name.startswith("bench/"):
            ranges.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name))
        elif "Launch" in name or name.startswith(("cudaMemcpy",
                                                  "cudaMemset")):
            launch[e.correlation_id()] = e.start_ns() / 1e3
    if not kernels:
        return None
    return Trace(kernels, ranges, launch, window_s)
