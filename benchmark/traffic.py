"""The one generator of the benchmark's traffic.

A traffic mix is the ``traffic`` block of ``workloads/<cell>.json``:
``prompts``, the name of a prompt list ``prompts/<name>.txt`` (one prompt
a line), and the cell's own sizes (``batch``: prompts a request; ``pool``:
host batches a training cell cycles through).  Each seed walks the whole
list in an order of its own, one permutation after another, so every seed
sends the same prompts, and the lengths that come with them, in another
order.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

PROMPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "prompts")


def prompt_list(name: str) -> List[str]:
    with open(os.path.join(PROMPTS, name + ".txt")) as f:
        return [line.strip() for line in f if line.strip()]


def prompts(seed: int, traffic: dict, count: int) -> List[str]:
    """The first ``count`` prompts seed ``seed`` sends: permutations of the
    list, drawn from the seed, one after another."""
    pool = prompt_list(traffic["prompts"])
    rng = np.random.default_rng([int(seed), 1])
    out: List[str] = []
    while len(out) < count:
        out += [pool[i] for i in rng.permutation(len(pool))]
    return out[:count]


def batches(seed: int, traffic: dict, count: int) -> List[List[str]]:
    """``count`` requests of ``traffic["batch"]`` prompts: the closed
    loop's requests in the order they are sent."""
    b = int(traffic["batch"])
    flat = prompts(seed, traffic, count * b)
    return [flat[i * b:(i + 1) * b] for i in range(count)]
