"""Readings of a cell's numbers compared, for setting their limits: the
program on many seeds, and on some of them the control (the reference in
the next precision below the configuration's, at the same states), each
after a short window of the cell's own traffic at its own size.

    python3 benchmark/tests/readings.py --workload t2i_v1_512 \
        --first-seed 5000 --seeds 12 --control 3 --seconds 12 \
        [--fault overcommit]

Prints one JSON line a seed, and with ``--out FILE`` appends them there
as well.  ``--fault`` runs every seed with that fault of ``FAULTS``
planted in the program, for the readings a fault gives.  Needs the card;
the CPU test ``test_bench_check.py`` runs the same at the tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def overcommit():
    """The MaskGIT sampler commits a tenth more tokens a step than its
    schedule: of the positions it would keep masked, the first tenth
    (rounded up) is committed too."""
    import torch

    from showo_tpu_torch.sampling import maskgit

    remask = maskgit._remask

    def more(selected, temp, noise, mask_len):
        masking = remask(selected, temp, noise, mask_len)
        extra = torch.ceil(masking.sum(-1, keepdim=True) * 0.1)
        return masking & (torch.cumsum(masking.long(), -1) > extra)

    return mock.patch.object(maskgit, "_remask", more)


FAULTS = {"overcommit": overcommit}


def readings(name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", overrides=None) -> dict:
    import torch

    from benchmark import harness
    from benchmark.trace import Spans

    wl = harness.cell(name)
    drv = harness.driver(wl["entry"]).Driver(
        wl, seed, device, overrides or {})
    spans = Spans()
    t0 = time.perf_counter()
    drv.setup(spans)
    setup_s = time.perf_counter() - t0
    need = int(wl["check"].get("requests", 0))
    n = units = 0
    t0 = time.perf_counter()
    while n < need or time.perf_counter() - t0 < seconds:
        units += drv.step(n, spans)
        n += 1
    if device == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = drv.check(control=control)
    return {"seed": seed, "control": control, "requests": n,
            "rate": units / window * drv.RATE_SCALE, "setup_s": setup_s,
            "check_s": time.perf_counter() - t0,
            "readings": {k: v for k, (v, _) in checks.items()}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args()
    sys.path[:0] = [ROOT]
    for i in range(args.seeds):
        if args.fault:
            with FAULTS[args.fault]():
                r = readings(args.workload, args.first_seed + i,
                             args.seconds, i < args.control)
            r["fault"] = args.fault
        else:
            r = readings(args.workload, args.first_seed + i, args.seconds,
                         i < args.control)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
