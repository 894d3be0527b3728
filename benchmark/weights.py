"""Weights made from the run's seed, shared by the program and the
reference.

Every tensor of a weight list (name, shape) is drawn from one stream of
normal numbers on the device, in chunks of at most ``CHUNK`` numbers, in the
order of the list: a tensor whose last axes give a fan-in gets N(0, 1 /
fan-in); a norm's scale 1 + N(0, 0.1^2); every other vector N(0, 0.02^2).
The values are rounded to the dtype they are served in, so the reference,
which upcasts them, computes with the very numbers the program holds.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

CHUNK = 1 << 28

NORM_WORDS = ("norm", "ln_", "layernorm")


def _scale(name: str, shape: Tuple[int, ...]):
    """(std, mean) of one tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return 0.1, 1.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if any(w in name.lower() for w in NORM_WORDS) and leaf in (
            "weight", "scale"):
        return 0.1, 1.0
    return 0.02, 0.0


def make_weights(specs: Iterable[Tuple[str, tuple]], seed: int,
                 device, dtype=torch.bfloat16,
                 dtypes: Dict[str, torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``specs``, (name, shape) or (name, shape, (std,
    mean)) where the name alone does not say; ``dtypes`` maps a name prefix to the
    dtype its tensors are served in (``dtype`` otherwise)."""
    specs = list(specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    pending: List[Tuple[str, tuple]] = []
    count = 0

    def flush():
        nonlocal pending, count
        if not pending:
            return
        flat = torch.randn(count, generator=gen, device=device)
        off = 0
        for name, shape, *given in pending:
            n = math.prod(shape)
            std, mean = given[0] if given else _scale(name, shape)
            want = dtype
            for prefix, dt in (dtypes or {}).items():
                if name.startswith(prefix):
                    want = dt
            out[name] = (flat[off:off + n].view(shape) * std + mean).to(want)
            off += n
        pending, count = [], 0

    for spec in specs:
        n = math.prod(spec[1])
        if count and count + n > CHUNK:
            flush()
        pending.append(spec)
        count += n
    flush()
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor],
              prefix: str = "") -> None:
    """Copy ``weights`` into the module's parameters of the same names;
    every name must exist with the same shape."""
    params = dict(module.named_parameters())
    for name, w in weights.items():
        if not name.startswith(prefix):
            continue
        key = name[len(prefix):]
        if key not in params:
            raise KeyError(f"the program has no parameter {key!r}")
        p = params[key]
        if tuple(p.shape) != tuple(w.shape):
            raise ValueError(f"{key}: program {tuple(p.shape)}, "
                             f"benchmark {tuple(w.shape)}")
        p.copy_(w)
