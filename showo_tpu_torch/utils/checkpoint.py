"""Training checkpoints: a ring buffer of ``torch.save`` files and the
``resume_from_checkpoint: 'latest'`` scan.

Counterpart of ``showo_tpu/utils/checkpoint.py``'s train-state half (an
orbax ring buffer there), in the reference's layout:
``<output_dir>/checkpoint-<step>/`` holding ``state.pt`` (the model's
state dict, the optimizer's, the step) and ``metadata.json``
(``global_step``); at most ``checkpoints_total_limit`` directories are
kept, the oldest removed first.  The optimizer state is saved with the
weights, so a resumed run goes on where the first one stopped.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def _ckpt_dirs(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    dirs = [d for d in os.listdir(output_dir)
            if re.match(r"checkpoint-\d+$", d)]
    return sorted(dirs, key=lambda d: int(d.split("-")[1]))


def save_checkpoint(output_dir: str, global_step: int, model, optimizer=None,
                    checkpoints_total_limit: Optional[int] = None) -> str:
    """Save ``model`` (and ``optimizer``, anything with ``state_dict``)
    under ``checkpoint-<global_step>/``, after removing the oldest
    directories past ``checkpoints_total_limit``; returns the directory."""
    if checkpoints_total_limit is not None:
        dirs = _ckpt_dirs(output_dir)
        while len(dirs) >= checkpoints_total_limit:
            shutil.rmtree(os.path.join(output_dir, dirs.pop(0)))
    path = os.path.abspath(os.path.join(output_dir,
                                        f"checkpoint-{global_step}"))
    os.makedirs(path, exist_ok=True)
    torch.save({"model": model.state_dict(),
                "optimizer": (None if optimizer is None
                              else optimizer.state_dict()),
                "global_step": global_step},
               os.path.join(path, "state.pt"))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"global_step": global_step}, f)
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(output_dir)
    return os.path.join(output_dir, dirs[-1]) if dirs else None


def restore_checkpoint(path: str, model, optimizer=None) -> int:
    """Load a ``checkpoint-<N>`` directory into ``model`` (and
    ``optimizer``); returns its step."""
    state = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=False)
    model.load_state_dict(state["model"])
    if optimizer is not None and state["optimizer"] is not None:
        optimizer.load_state_dict(state["optimizer"])
    with open(os.path.join(path, "metadata.json")) as f:
        return int(json.load(f)["global_step"])


def resume_latest(output_dir: str, model, optimizer=None,
                  params_only_fallback: bool = False) -> int:
    """``resume_from_checkpoint: 'latest'``: restore the newest checkpoint
    of ``output_dir``; returns its step, or 0 when there is none.

    params_only_fallback: when the saved optimizer state does not fit the
    current optimizer (the frozen parameters changed between runs, as the
    two-phase recipes do), restore the weights alone and keep the fresh
    optimizer state (the reference's weights-only resume), with a
    warning; weights that do not load still raise."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return 0
    if optimizer is None:
        return restore_checkpoint(path, model)
    backup = optimizer.state_dict()
    try:
        return restore_checkpoint(path, model, optimizer)
    except (ValueError, KeyError, RuntimeError) as e:
        if not params_only_fallback:
            raise
        logger.warning("full-state restore from %s failed (%s: %s); "
                       "resuming the WEIGHTS ONLY, with a fresh optimizer "
                       "state", path, type(e).__name__, e)
        optimizer.load_state_dict(backup)
        return restore_checkpoint(path, model)
