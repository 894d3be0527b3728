"""Pieces the drivers share: the configuration as the program's loader
gives it, per-request seeds, and the draw of the checked sample."""

from __future__ import annotations

import copy
import gc
from typing import List

import numpy as np
import torch


def program_config(wl: dict, overrides: dict):
    """The cell's program settings (``programs[program]`` of its
    configuration file) as the port's ``Config`` (the nested dict its entry
    points read), with dotted-key ``overrides``."""
    from showo_tpu_torch.config import Config

    def wrap(x):
        if isinstance(x, dict):
            return Config({k: wrap(v) for k, v in x.items()})
        if isinstance(x, list):
            return [wrap(v) for v in x]
        return x

    conf = wrap(copy.deepcopy(wl["config_file"]["programs"][wl["program"]]))
    for key, val in overrides.items():
        conf.set_path(key, val)
    return conf


def seed_of(*keys: int) -> int:
    """63 bits drawn from the whole numbers ``keys`` (a run's seed, a
    stream, an index)."""
    return int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def request_seed(seed: int, k: int, stream: int = 3) -> int:
    """The seed of request ``k``'s generator (``k`` = -1: the warm-up)."""
    return seed_of(seed, stream, k + 1)


def sample(seed: int, records: List[dict], count: int) -> List[dict]:
    """``count`` of the window's finished requests, drawn from the seed,
    the one with the longest prompts among them."""
    lens = [sum(len(p.split()) for p in r["prompts"]) for r in records]
    longest = int(np.argmax(lens))
    rng = np.random.default_rng([int(seed), 4])
    rest = [i for i in rng.permutation(len(records)) if i != longest]
    return [records[i] for i in sorted([longest] + rest[:max(0, count - 1)])]


def checked_steps(seed: int, n: int, count: int) -> List[int]:
    """``count`` of ``n`` steps drawn from the seed, the first and the
    last always among them."""
    rng = np.random.default_rng([int(seed), 5])
    mid = [int(x) for x in rng.permutation(np.arange(1, n - 1))]
    return sorted({0, n - 1, *mid[:max(0, count - 2)]})


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return float((a.float() - b).norm() / b.norm().clamp(min=1e-12))


def release(device: torch.device) -> None:
    """Return the memory of the program's state, dropped by the caller,
    before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class NoTF32:
    """fp32 products in fp32 (TF32 off) for the reference's block."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
