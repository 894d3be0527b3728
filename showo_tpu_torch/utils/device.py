"""The device of the port's entry points, and the process grid of its
sweeps."""

from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """``device`` as a torch.device; CUDA when None.  Raises when CUDA is
    asked for and no card is present: an entry point runs on the CPU only
    when the caller names it (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; the port's entry points run on the "
            "card unless the caller asks for the CPU (device='cpu', or the "
            "config key device=cpu on the command line)")
    return device


def process_grid() -> tuple:
    """(rank, world size) of the initialised ``torch.distributed`` process
    group, (0, 1) without one: the shard of a sweep that the JAX package
    takes from ``jax.process_index()`` / ``jax.process_count()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
