"""The device of the port's entry points."""

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
