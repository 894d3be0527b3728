"""The Lion optimizer (training/optimizer.py:1-81).

Counterpart of ``showo_tpu/training/lion.py`` (an optax transform there),
as a class on the port's tensors in the manner of ``training/optim.py``:
a step takes the gradients in parameter order and does

    u = sign(b1 * m + (1 - b1) * g) + wd * p
    p = p - lr * u
    m = b2 * m + (1 - b2) * g

in fp32 (the momentum is fp32).  The learning rate is a float: a schedule
(a callable) raises ``ValueError`` at the step, as JAX's does, which asks
for ``optax.scale_by_schedule`` around it.  No trainer selects it (JAX
has no config option for it either).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from showo_tpu_torch.parallel.mesh import local
from showo_tpu_torch.training.optim import check_state_shapes


class Lion:
    def __init__(self, params: Sequence[nn.Parameter], learning_rate,
                 b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.wd = weight_decay
        self.momentum = [torch.zeros_like(p, dtype=torch.float32)
                         for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if callable(self.lr):
            raise ValueError("wrap lion() with optax.scale_by_schedule for "
                             "schedules; pass a float here")
        for p, g, m in zip(self.params, grads, self.momentum):
            # elementwise: a DTensor parameter steps its local shard
            p, g, m = local(p), local(g).float(), local(m)
            u = torch.sign(self.b1 * m + (1 - self.b1) * g)
            if self.wd:
                u = u + self.wd * p.float()
            m.copy_(self.b2 * m + (1 - self.b2) * g)
            p.copy_(p + (-self.lr * u).to(p.dtype))

    def state_dict(self) -> dict:
        return {"momentum": list(self.momentum)}

    def load_state_dict(self, sd: dict) -> None:
        """Raises ``ValueError``, before it copies anything, unless the saved
        momentum is one tensor a parameter of this optimizer's shapes."""
        check_state_shapes("lion momentum", self.momentum,
                           list(sd["momentum"]))
        for dst, src in zip(self.momentum, sd["momentum"]):
            dst.copy_(src)
