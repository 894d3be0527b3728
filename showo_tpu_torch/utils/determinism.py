"""Run seeding and deterministic kernels (models/training_utils.py:27-58).

Counterpart of ``showo_tpu/utils/determinism.py``: ``set_seed`` seeds
Python's ``random``, numpy and torch and returns a ``torch.Generator``
where JAX returns a PRNG key; ``enable_full_determinism`` asks torch for
deterministic algorithms and sets cuBLAS's workspace so that its
reductions are reproducible, where JAX sets XLA's deterministic-ops
flag.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed random, numpy and torch (every device); a CPU generator of
    ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def enable_full_determinism(seed: int) -> torch.Generator:
    """:func:`set_seed`, deterministic algorithms (an op without one
    raises; cuDNN's deterministic kernels, no autotuning) and cuBLAS's
    fixed workspace (set before the first cuBLAS call to take effect)."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return set_seed(seed)
