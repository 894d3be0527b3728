"""Local gloo process groups on the CPU for the mesh tests.

    group = start_group("test_module:function", world=8, workdir=DIR)
    group.wait(timeout=180)          # from the start; raises with each
                                     # rank's stderr

Each rank is ``python tests/_gloo_group.py TARGET RANK WORLD WORKDIR``
(the repository and ``tests/`` on its path): one thread of intra-op work, a gloo group that meets in
a ``FileStore`` under ``WORKDIR`` (no TCP port to race for), then
``function(rank, world, workdir)``.  A group that outlives its wall-time
limit is killed, every rank, and the error carries each rank's stderr.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from typing import List


class Group:
    """The ranks of one :func:`start_group`."""

    def __init__(self, procs: List[subprocess.Popen], logs: List[str]):
        self.procs, self.logs = procs, logs
        self.start = time.monotonic()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _report(self, why: str) -> str:
        parts = [why]
        for r, (p, log) in enumerate(zip(self.procs, self.logs)):
            with open(log, errors="replace") as f:
                tail = f.read()[-3000:]
            parts.append(f"--- rank {r} (exit {p.returncode}) ---\n{tail}")
        return "\n".join(parts)

    def wait(self, timeout: float = 180.0) -> None:
        """Wait for every rank; past ``timeout`` seconds from the group's
        start kill them all.  Raises RuntimeError with each rank's stderr
        when a rank failed or the time ran out."""
        deadline = self.start + timeout
        while any(p.poll() is None for p in self.procs):
            if any(p.returncode not in (None, 0) for p in self.procs):
                time.sleep(2.0)      # let the others report, then stop them
                self.kill()
                break
            if time.monotonic() > deadline:
                self.kill()
                raise RuntimeError(self._report(
                    f"process group killed after {timeout:.0f} s"))
            time.sleep(0.05)
        if any(p.returncode != 0 for p in self.procs):
            raise RuntimeError(self._report("a rank failed"))


def start_group(target: str, world: int, workdir: str) -> Group:
    """Start ``world`` gloo ranks running ``target`` ("module:function");
    returns at once."""
    os.makedirs(workdir, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root, here] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    procs, logs = [], []
    for r in range(world):
        log = os.path.join(workdir, f"rank{r}.log")
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), target, str(r),
                 str(world), workdir],
                cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
    return Group(procs, logs)


def _main(argv: List[str]) -> None:
    import torch
    import torch.distributed as dist

    target, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        argv[3]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    module, fn = target.split(":")
    try:
        getattr(importlib.import_module(module), fn)(rank, world, workdir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
