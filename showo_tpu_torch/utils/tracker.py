"""Console logging, training meters and the trainers' metric tracker.

Counterpart of ``showo_tpu/utils/logging.py``: ``get_logger`` (stdlib
logging at ``SHOWO_TPU_VERBOSITY``), ``AverageMeter`` and ``Stopwatch``
(training/utils.py:160-176, train.py:637-650), ``resolve_wandb_run_id``
(the reference's run-id resume logic, train.py:129-151) and ``Tracker`` as
far as the port's trainers use it: with ``wandb_enabled: false`` (the
configs' default) it keeps the logged metrics in ``history``; wandb
itself is not ported (``enabled=True`` raises NotImplementedError).
"""

from __future__ import annotations

import logging
import os
import random
import string
import sys
import time
from typing import Any, Dict, Optional, Tuple

_DEFAULT_LEVEL = os.environ.get("SHOWO_TPU_VERBOSITY", "info").upper()


def get_logger(name: str = "showo_tpu_torch") -> logging.Logger:
    """A logger writing to stderr at ``SHOWO_TPU_VERBOSITY`` (default
    info), its handler added once and not propagated."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(getattr(logging, _DEFAULT_LEVEL, logging.INFO))
        logger.propagate = False
    return logger


class AverageMeter:
    """The running value, sum, count and mean of a metric."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Stopwatch:
    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        """Seconds since the last lap (or the start)."""
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        return dt


def resolve_wandb_run_id(config, output_dir: str,
                         enabled: bool = True) -> Tuple[Optional[str], Any]:
    """(run id, resume flag): ``config.wandb.run_id`` when set; else, when
    enabled, the id a previous run of ``output_dir`` saved in
    ``wandb_run_id.txt``, else a fresh 8-character id, saved there.  With
    ``enabled=False`` nothing is read or written (building a trainer must
    not create ``output_dir``)."""
    wandb_cfg = config.get("wandb", {}) or {}
    run_id = wandb_cfg.get("run_id")
    resume = wandb_cfg.get("resume", "auto")
    if run_id:
        return run_id, resume
    if not enabled:
        return None, False
    path = os.path.join(output_dir, "wandb_run_id.txt")
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip(), resume
    rng = random.SystemRandom()
    run_id = "".join(rng.choice(string.ascii_lowercase + string.digits)
                     for _ in range(8))
    os.makedirs(output_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(run_id)
    return run_id, False


class Tracker:
    def __init__(self, project: Optional[str] = None,
                 name: Optional[str] = None, enabled: bool = False, **_):
        if enabled:
            raise NotImplementedError(
                "wandb logging is not ported; set wandb_enabled: false")
        self.project, self.name = project, name
        self.history: list = []

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        self.history.append((step, dict(metrics)))

    def finish(self):
        pass
