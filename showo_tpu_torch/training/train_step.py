"""Training configuration and the optimizer of the fused step.

Counterpart of ``showo_tpu/training/train_step.py``: ``TrainConfig`` with
the same fields and defaults, and ``Optimizer`` (the counterpart of
``make_optimizer``): clip by global norm
(``max_grad_norm``; None or 0 disables it), then ``torch.optim.AdamW``
(decoupled weight decay on every parameter, as optax.adamw), at the
learning rate of the schedule evaluated at the number of optimizer steps
taken so far; with ``grad_accum_steps`` k > 1 the gradients of k calls
are averaged and the clip and update run on every k-th call (what
``optax.MultiSteps`` does in the JAX package).  The parameters may come
in groups (the Show-o2 stage trainers': JAX's ``multi_transform`` of one
clip + AdamW chain a group), each clipped by its own global norm at its
own factor of the schedule's rate.  The ``adamw_bf16`` and ``adafactor``
optimizers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: Optional[float] = 1.0
    t2i_coeff: float = 1.0
    lm_coeff: float = 0.1
    mmu_coeff: float = 1.0
    max_seq_length: int = 128
    grad_accum_steps: int = 1
    # attention route of the training forward: "dense" (additive biases)
    # or "trainable" (the packed trainable kernels, O(S) metadata)
    attn_impl: str = "dense"
    # layer remat policy (utils/remat.py): "full" or "none"
    remat: str = "full"
    optimizer: str = "adamw"


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, fp32 (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class Optimizer:
    """Clip-by-global-norm + AdamW + LR schedule + gradient accumulation
    over ``params`` (an iterable of parameters, or a list of (parameters,
    learning-rate factor) groups; parameters without a gradient are left
    out); :meth:`update` takes one call's gradients.  ``tc``: a
    TrainConfig, or any config with its optimizer fields (AdamW's betas
    and eps default to optax's)."""

    def __init__(self, params, tc, lr_schedule: Optional[Callable[[int],
                                                                  float]]
                 = None):
        if tc.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {tc.optimizer!r} is not ported yet; the port "
                f"has 'adamw'")
        params = list(params)
        groups = (params if params and isinstance(params[0], tuple)
                  else [(params, 1.0)])
        self.groups = [g for g in ((tuple(p for p in ps if p.requires_grad),
                                    f) for ps, f in groups) if g[0]]
        self.params = [p for ps, _ in self.groups for p in ps]
        self.tc = tc
        self.schedule = lr_schedule or (lambda step: tc.learning_rate)
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr": f * self.schedule(0)}
             for ps, f in self.groups],
            betas=(getattr(tc, "adam_beta1", 0.9),
                   getattr(tc, "adam_beta2", 0.999)),
            eps=getattr(tc, "adam_eps", 1e-8), weight_decay=tc.weight_decay)
        self.steps = 0        # optimizer steps taken
        self.micro = 0        # calls accumulated towards the next step
        self._acc = None

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Add one call's gradients (in ``params`` order); on every
        ``grad_accum_steps``-th call clip their mean and step AdamW.
        Returns whether the parameters changed.  The gradients are scaled
        in place (the caller hands them over)."""
        k = max(1, self.tc.grad_accum_steps)
        if k > 1:
            if self._acc is None:
                self._acc = [g / k for g in grads]
            else:
                for a, g in zip(self._acc, grads):
                    a.add_(g, alpha=1.0 / k)
            self.micro += 1
            if self.micro < k:
                return False
            grads, self._acc, self.micro = self._acc, None, 0
        lr, i = self.schedule(self.steps), 0
        for (ps, f), group in zip(self.groups, self.adamw.param_groups):
            gs, i = grads[i:i + len(ps)], i + len(ps)
            if self.tc.max_grad_norm:
                norm = global_norm(gs)
                coef = torch.where(norm < self.tc.max_grad_norm, 1.0,
                                   self.tc.max_grad_norm / norm)
                for g in gs:
                    g.mul_(coef)
            for p, g in zip(ps, gs):
                p.grad = g
            group["lr"] = f * lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.steps += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "steps": self.steps,
                "micro": self.micro, "acc": self._acc}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.steps, self.micro, self._acc = sd["steps"], sd["micro"], sd["acc"]
