"""EMA of the model's parameters (models/training_utils.py:61-296
``EMAModel``).

Counterpart of ``showo_tpu/training/ema.py``: the reference's decay
warmup schedule, and an update of fp32 copies of the parameters in place,
``e -= (1 - d) * (e - p)``, one ``torch._foreach_`` call a stage.  The
decay is computed in fp32, as JAX computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.9999
    min_decay: float = 0.0
    update_after_step: int = 0
    use_ema_warmup: bool = False
    inv_gamma: float = 1.0
    power: float = 2 / 3


def ema_decay(cfg: EMAConfig, optimization_step: int) -> float:
    """training_utils.py:139-157 ``get_decay``, in fp32."""
    f32 = torch.float32
    step = torch.clamp(torch.tensor(optimization_step - cfg.update_after_step
                                    - 1, dtype=torch.int32), min=0)
    if cfg.use_ema_warmup:
        decay = 1.0 - (1.0 + step.to(f32) / torch.tensor(
            cfg.inv_gamma, dtype=f32)) ** torch.tensor(-cfg.power, dtype=f32)
    else:
        decay = (1.0 + step.to(f32)) / (10.0 + step.to(f32))
    decay = torch.clamp(decay, max=torch.tensor(cfg.decay, dtype=f32))
    decay = torch.clamp(decay, min=torch.tensor(cfg.min_decay, dtype=f32))
    return 0.0 if int(step) <= 0 else float(decay)


class EMA:
    """fp32 copies of ``params`` (taken now) and the number of updates;
    :meth:`update` moves them towards the live parameters."""

    def __init__(self, cfg: EMAConfig, named_params: Iterable):
        self.cfg = cfg
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [
            p.detach().to(torch.float32, copy=True) for _, p in named]
        self.step = 0

    @torch.no_grad()
    def update(self, live: Iterable[torch.Tensor]) -> float:
        """One EMA step towards ``live`` (in the order of the names);
        returns the decay it used."""
        self.step += 1
        d = ema_decay(self.cfg, self.step)
        live = [p.detach().float() for p in live]
        diff = torch._foreach_sub(self.params, live)
        torch._foreach_mul_(diff, 1.0 - d)
        torch._foreach_sub_(self.params, diff)
        return d

    def state_dict(self) -> Dict:
        return {"params": dict(zip(self.names, self.params)),
                "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        saved = sd["params"]
        if set(saved) != set(self.names):
            raise ValueError("the saved EMA holds other parameters")
        for n, e in zip(self.names, self.params):
            e.copy_(saved[n])
        self.step = int(sd["step"])
