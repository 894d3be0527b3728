"""Training configuration and the optimizer of the fused step.

Counterpart of ``showo_tpu/training/train_step.py``: ``TrainConfig`` with
the same fields and defaults, and ``Optimizer`` (the counterpart of
``make_optimizer``): clip by global norm
(``max_grad_norm``; None or 0 disables it), then the optimizer
``optimizer`` names: ``adamw`` (``torch.optim.AdamW``: decoupled weight
decay on every parameter, as optax.adamw), ``adamw_bf16`` or
``adafactor`` (``training/optim.py``), at the learning rate of the
schedule evaluated at the number of optimizer steps taken so far; with
``grad_accum_steps`` k > 1 the gradients of k calls are averaged and the
clip and update run on every k-th call (what ``optax.MultiSteps`` does in
the JAX package).  The parameters may come in groups (the Show-o2 stage
trainers': JAX's ``multi_transform`` of one clip + optimizer chain a
group), each clipped by its own global norm at its own factor of the
schedule's rate.  Parameters without a gradient are left out and stay
as they are (JAX's ``set_to_zero`` for frozen parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from showo_tpu_torch.training.optim import (AdamWBf16, Adafactor,
                                            check_optimizer, own_tensors)


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
    # layer remat policy (utils/remat.py): "none", "full", "dots", "qkv",
    # "qkv_fc1", "qkv_attn" or "qkv_fc1_attn"
    remat: str = "full"
    # "adamw", "adamw_bf16" or "adafactor" (training/optim.py)
    optimizer: str = "adamw"


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, fp32 (optax.global_norm:
    the tensors' sums of squares added in order)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


class Optimizer:
    """Clip-by-global-norm + the optimizer ``tc.optimizer`` + LR schedule
    + gradient accumulation over ``params`` (an iterable of parameters,
    or a list of (parameters, learning-rate factor) groups; parameters
    without a gradient are left out); :meth:`update` takes one call's
    gradients.  ``tc``: a TrainConfig, or any config with its optimizer
    fields (AdamW's betas and eps default to optax's).  ``tensors``:
    ``training/optim.py::jax_tensors`` of the model, the JAX package's
    tensors that ``adafactor`` factors and scales (by default each
    parameter is one).  An unknown optimizer raises ``ValueError``."""

    def __init__(self, params, tc, lr_schedule: Optional[Callable[[int],
                                                                  float]]
                 = None, tensors=None):
        self.name = check_optimizer(tc.optimizer)
        params = list(params)
        groups = (params if params and isinstance(params[0], tuple)
                  else [(params, 1.0)])
        self.groups = [g for g in ((tuple(p for p in ps if p.requires_grad),
                                    f) for ps, f in groups) if g[0]]
        self.params = [p for ps, _ in self.groups for p in ps]
        self.tc = tc
        self.schedule = lr_schedule or (lambda step: tc.learning_rate)
        betas = (getattr(tc, "adam_beta1", 0.9),
                 getattr(tc, "adam_beta2", 0.999))
        eps = getattr(tc, "adam_eps", 1e-8)
        self.adamw = self.inner = None
        if self.name == "adamw":
            self.adamw = torch.optim.AdamW(
                [{"params": ps, "lr": f * self.schedule(0)}
                 for ps, f in self.groups],
                betas=betas, eps=eps, weight_decay=tc.weight_decay)
        elif self.name == "adamw_bf16":
            self.inner = AdamWBf16(self.params, *betas, eps, tc.weight_decay)
        else:
            self.inner = Adafactor(self._trained(tensors), tc.weight_decay)
        self.steps = 0        # optimizer steps taken
        self.micro = 0        # calls accumulated towards the next step
        self._acc = None

    def _trained(self, tensors):
        """The tensors of ``tensors`` (default: one a parameter) whose
        parameters are trained; each is trained whole or not at all."""
        if tensors is None:
            return own_tensors(self.params)
        ids = {id(p) for p in self.params}
        out = []
        for t in tensors:
            n = sum(id(p) in ids for p in t.params)
            if n and n != len(t.params):
                raise ValueError(f"tensor {t.key} is trained in part")
            if n:
                out.append(t)
        if sum(len(t.params) for t in out) != len(ids):
            raise ValueError("the tensors do not cover every trained "
                             "parameter")
        return out

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Add one call's gradients (in ``params`` order); on every
        ``grad_accum_steps``-th call clip their mean and step the
        optimizer.
        Returns whether the parameters changed.  The gradients are scaled
        in place (the caller hands them over)."""
        k = max(1, self.tc.grad_accum_steps)
        if k > 1:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            if self._acc is None:
                self._acc = list(grads)
            else:
                for a, g in zip(self._acc, grads):
                    a.add_((g - a) / (self.micro + 1))
            self.micro += 1
            if self.micro < k:
                return False
            grads, self._acc, self.micro = self._acc, None, 0
        lr, i = self.schedule(self.steps), 0
        lrs = []
        for ps, f in self.groups:
            gs, i = grads[i:i + len(ps)], i + len(ps)
            if self.tc.max_grad_norm:
                # optax.clip_by_global_norm: (g / norm) * max_norm
                norm = global_norm(gs)
                if norm >= self.tc.max_grad_norm:
                    for g in gs:
                        g.div_(norm).mul_(self.tc.max_grad_norm)
            lrs += [f * lr] * len(ps)
        if self.adamw is not None:
            for p, g in zip(self.params, grads):
                p.grad = g
            for (_, f), group in zip(self.groups, self.adamw.param_groups):
                group["lr"] = f * lr
            self.adamw.step()
            self.adamw.zero_grad(set_to_none=True)
        elif self.name == "adamw_bf16":
            self.inner.step(grads, lrs)
        else:
            self.inner.step({id(p): g for p, g in zip(self.params, grads)},
                            {id(p): r for p, r in zip(self.params, lrs)})
        self.steps += 1
        return True

    def state_dict(self) -> dict:
        inner = (self.adamw or self.inner).state_dict()
        return {self.name: inner, "steps": self.steps, "micro": self.micro,
                "acc": self._acc}

    def load_state_dict(self, sd: dict) -> None:
        if self.name not in sd:
            raise ValueError(f"the state holds no {self.name!r} optimizer "
                             f"state (it has {sorted(sd)})")
        (self.adamw or self.inner).load_state_dict(sd[self.name])
        self.steps, self.micro, self._acc = sd["steps"], sd["micro"], sd["acc"]
