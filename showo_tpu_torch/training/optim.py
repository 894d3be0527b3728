"""The optimizers of the fused steps beside AdamW: ``adamw_bf16`` and
``adafactor``, as the JAX package builds them with optax 0.2.6.

``adamw_bf16`` is ``optax.adamw(lr, b1, b2, eps, weight_decay,
mu_dtype=bfloat16)`` (``scale_by_adam``, ``add_decayed_weights``,
``scale_by_learning_rate``): the first moment is stored in bf16 and only
stored there.  A step forms ``(1 - b1) * g + b1 * mu`` in fp32 from the
stored bf16 moment, bias-corrects it in fp32 (by ``1 - b1^t``), and casts
it to bf16 for storage; the second moment is fp32.  ``b1 * mu`` is what
the JAX package's compiled step computes: optax multiplies the bf16 array
by the weakly typed Python float, so ``b1`` becomes a bf16 constant
(0.8984375 for 0.9), and XLA forms the product in fp32 inside the fused
update without rounding it to bf16.  Then
``u = mu_hat / (sqrt(nu_hat) + eps) + wd * p`` and ``p -= lr * u``.
``torch.optim.AdamW`` keeps its first moment in the parameter's dtype,
so this has its own step.

``adafactor`` is ``optax.adafactor(lr, weight_decay_rate=wd,
clipping_threshold=1.0)`` with every other argument at optax's default
(``factorized.scale_by_factored_rms``, then ``clip_by_block_rms(1.0)``,
``scale_by_learning_rate``, ``scale_by_param_block_rms(1e-3)``,
``add_decayed_weights(wd)``, ``scale(-1)``).  At step t (from 1) the
second-moment decay is ``1 - t^-0.8``; 1e-30 is added to g^2 before the
means; a tensor whose second-largest dim is at least 128 keeps the means
of g^2 over its largest dim (rows) and over its second-largest (columns),
any other a full second moment.  The update is clipped to block RMS 1,
scaled by the learning rate and by the tensor's RMS (at least 1e-3), and
``wd * p`` is added after that, NOT scaled by the learning rate: every
weight decays by ``wd`` a step, even at learning rate 0 during a warmup.
That is optax's, and the JAX package trains with it; it is kept here.

Adafactor's factoring, block RMS and parameter scale are per tensor, so
the tensors must be the JAX package's: its layer stacks are scanned, one
[L, ...] tensor per kind of weight, and its dense kernels are [in, out].
:func:`jax_tensors` maps a module's parameters onto those tensors (every
``nn.ModuleList`` of one layer class stacked, ``nn.Linear`` weights
transposed, convolution weights in HWIO / DHWIO order); an optimizer
built without it takes each parameter as a tensor of its own.  AdamW and
``adamw_bf16`` are elementwise and need no map.

Parameters sharded over a mesh (``parallel/mesh.py``: DTensors, split
like the JAX package's tensors under GSPMD) step shard by shard, their
state sharded like them: ``adamw_bf16`` keeps each moment a DTensor of
its parameter's placements; ``adafactor`` reads a tensor's global shape
for its factored dims and sums over the mesh dims that split the tensor
what spans it whole (the row and column means of g^2, the mean of the
row statistics, the update's and the parameter's RMS), and keeps its
statistics as DTensors split like the axes they keep.  So a sharded step
gives the unsharded one's update, up to the order of the sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from showo_tpu_torch.parallel.mesh import (is_dtensor, like_shards, local,
                                           owners, shard_dims, stored,
                                           sum_over)

OPTIMIZERS = ("adamw", "adamw_bf16", "adafactor")

# optax.adafactor's defaults
DECAY_RATE = 0.8
EPS = 1e-30
MIN_DIM_SIZE_TO_FACTOR = 128
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3


def check_optimizer(name: str) -> str:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; the port has "
                         f"{OPTIMIZERS}")
    return name


@dataclasses.dataclass(frozen=True)
class JaxTensor:
    """One tensor of the JAX package's parameter tree as the port holds
    it: ``params`` (the layers of a stack in order, or one parameter)
    each seen in JAX's axis order through ``perm``; the tensor is their
    stack along a new axis 0 when ``stacked``.  Sharded parameters
    (DTensors, all split alike) give this rank's piece of the tensor."""

    key: str
    params: Tuple[nn.Parameter, ...]
    perm: Tuple[int, ...]
    stacked: bool

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape (a DTensor's ``shape`` is its whole one)."""
        piece = tuple(self.params[0].shape[i] for i in self.perm)
        return (len(self.params),) + piece if self.stacked else piece

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape of this rank's piece."""
        p = local(self.params[0])
        piece = tuple(p.shape[i] for i in self.perm)
        return (len(self.params),) + piece if self.stacked else piece

    @property
    def mesh(self):
        """The device mesh of sharded parameters, else None."""
        p = self.params[0]
        return p.device_mesh if is_dtensor(p) else None

    @property
    def split(self) -> Dict[int, int]:
        """{mesh dim: axis of this tensor} of the mesh dims that split it."""
        return {i: self.perm.index(d) + int(self.stacked)
                for i, d in shard_dims(self.params[0]).items()}

    def gather(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        views = [local(t).permute(self.perm) for t in pieces]
        return torch.stack(views) if self.stacked else views[0]

    def scatter_add_(self, update: torch.Tensor) -> None:
        """params += update (this rank's piece of a tensor of
        :attr:`shape`)."""
        parts = update.unbind(0) if self.stacked else (update,)
        inv = tuple(int(i) for i in np.argsort(self.perm))
        for p, u in zip(self.params, parts):
            local(p).add_(u.permute(inv))

    def mean(self, x: torch.Tensor, axis: int,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over ``axis`` of this rank's piece ``x`` (this
        tensor's axes), over the whole tensor's extent: summed over the
        mesh dims that split ``axis``."""
        dims = [i for i, a in self.split.items() if a == axis]
        if not dims:
            return x.mean(axis, keepdim=keepdim)
        return sum_over(x.sum(axis, keepdim=keepdim), self.mesh,
                        dims) / self.shape[axis]

    def rms(self, x: torch.Tensor) -> torch.Tensor:
        """The RMS of the whole tensor whose piece is ``x``."""
        if not self.split:
            return _rms(x)
        s = sum_over(torch.sum(torch.square(x)), self.mesh, self.split)
        return torch.sqrt(s / math.prod(self.shape))

    def state(self, piece: torch.Tensor, dropped: Optional[int] = None):
        """A state tensor of this rank (``piece``, this tensor's axes but
        ``dropped``) as a DTensor split like the axes it keeps (a
        sharded tensor), else as it is."""
        split = {i: a - int(dropped is not None and a > dropped)
                 for i, a in self.split.items() if a != dropped}
        return like_shards(piece, self.mesh, split)


def _perm(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """The axis order of the JAX package's copy of ``module.<name>``."""
    if name == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if name == "weight" and isinstance(module, (nn.Conv2d, nn.Conv3d)):
        return tuple(range(2, p.dim())) + (1, 0)
    return tuple(range(p.dim()))


def jax_tensors(model: nn.Module) -> List[JaxTensor]:
    """Every parameter of ``model`` (trainable or not) in the JAX
    package's tensors: the entries of an ``nn.ModuleList`` whose layers
    are all of one class are stacked (JAX scans them), one tensor per
    parameter name within the layer.  A sharded model's parameters are
    its DTensors, named as the unsharded model's."""
    stacks = {}
    for mname, mod in model.named_modules():
        if (isinstance(mod, nn.ModuleList)
                and not isinstance(mod, parametrize.ParametrizationList)
                and len(mod) and len({type(m) for m in mod}) == 1):
            for i, layer in enumerate(mod):
                stacks[f"{mname}.{i}." if mname else f"{i}."] = (mname, i)
    out: Dict[str, list] = {}
    seen = set()
    for name, (_, mod, pname) in owners(model).items():
        p = stored(mod, pname)
        if id(p) in seen:              # a parameter shared by two modules
            continue
        seen.add(id(p))
        perm = _perm(mod, pname, p)
        key, stacked = name, False
        for prefix, (sname, i) in stacks.items():
            if name.startswith(prefix):
                key = f"{sname}.*.{name[len(prefix):]}"
                stacked = True
                break
        out.setdefault(key, [stacked, perm, []])[2].append(p)
    tensors = []
    for key, (stacked, perm, ps) in out.items():
        if stacked and len({tuple(p.shape) for p in ps}) != 1:
            raise ValueError(f"layer stack {key} holds tensors of several "
                             f"shapes")
        tensors.append(JaxTensor(key, tuple(ps), perm, stacked))
    return tensors


def own_tensors(params: Sequence[nn.Parameter]) -> List[JaxTensor]:
    """Each parameter a tensor of its own."""
    return [JaxTensor(str(i), (p,), tuple(range(p.dim())), False)
            for i, p in enumerate(params)]


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second-largest, largest) axes when
    the second-largest is at least 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _zeros_like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype``; for a DTensor, a DTensor of
    its placements (this rank's shard zeroed)."""
    if not is_dtensor(p):
        return torch.zeros_like(p, dtype=dtype)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.zeros_like(local(p), dtype=dtype),
                              p.device_mesh, p.placements, run_check=False)


def check_state_shapes(what: str, mine: Sequence[torch.Tensor],
                   saved: Sequence[torch.Tensor]) -> None:
    """ValueError unless ``saved`` holds as many tensors as ``mine``, each
    of the same shape (``copy_`` would broadcast a mismatch silently)."""
    if len(saved) != len(mine):
        raise ValueError(f"{what}: the saved state holds {len(saved)} "
                         f"tensors, this optimizer {len(mine)}")
    for i, (a, b) in enumerate(zip(mine, saved)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"{what}: tensor {i} was saved as "
                             f"{tuple(b.shape)}, this optimizer holds "
                             f"{tuple(a.shape)}")


class AdamWBf16:
    """``optax.adamw(..., mu_dtype=bfloat16)`` over parameter groups; see
    the module docstring.  State: the step count, the bf16 first moments
    and the fp32 second moments, in parameter order."""

    def __init__(self, params: Sequence[nn.Parameter], b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.params = list(params)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = [_zeros_like(p, torch.bfloat16) for p in self.params]
        self.nu = [_zeros_like(p, torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             lrs: Sequence[float]) -> None:
        self.count += 1
        f32 = torch.float32
        b1, b2 = torch.tensor(self.b1, dtype=f32), torch.tensor(self.b2,
                                                                 dtype=f32)
        bc1 = float(1 - b1 ** self.count)
        bc2 = float(1 - b2 ** self.count)
        # b1 as the bf16 constant optax's weak typing makes of it
        b1_mu = float(torch.tensor(self.b1, dtype=torch.bfloat16))
        for p, g, mu, nu, lr in zip(self.params, grads, self.mu, self.nu,
                                    lrs):
            # elementwise: a sharded parameter steps its shard
            p, g, mu, nu = local(p), local(g).float(), local(mu), local(nu)
            # optax's order of operations, each rounded on its own
            m = (1 - self.b1) * g + b1_mu * mu.float()
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (m / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.wd:
                u = u + self.wd * p
            p.copy_(p + (-lr) * u)
            mu.copy_(m)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, sd: dict) -> None:
        """Raises ``ValueError``, before it copies anything, when the saved
        moments are not one a parameter of this optimizer's shapes (the
        trained set changed), as ``torch.optim.AdamW`` does."""
        for key, mine in (("mu", self.mu), ("nu", self.nu)):
            check_state_shapes(f"adamw_bf16 {key}", mine, list(sd[key]))
        self.count = int(sd["count"])
        for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
            local(dst).copy_(local(src))


class Adafactor:
    """``optax.adafactor(lr, weight_decay_rate=wd, clipping_threshold=1.0)``
    over ``tensors`` (:func:`jax_tensors`, or one tensor a parameter); see
    the module docstring.  State: the step count and each tensor's row /
    column means (factored) or full second moment, in fp32 and the JAX
    tensor's axis order."""

    def __init__(self, tensors: Sequence[JaxTensor], weight_decay: float):
        self.tensors = list(tensors)
        self.wd = weight_decay
        self.count = 0
        self.v: List[Tuple[torch.Tensor, ...]] = []
        for t in self.tensors:
            # this rank's piece; the factored dims are the global shape's
            piece, device = t.local_shape, t.params[0].device
            dims = factored_dims(t.shape)

            def zeros(d=None):
                return t.state(torch.zeros(
                    [n for i, n in enumerate(piece) if i != d],
                    dtype=torch.float32, device=device), d)

            if dims is None:
                self.v.append((zeros(),))
            else:
                d1, d0 = dims
                self.v.append((zeros(d0), zeros(d1)))

    @torch.no_grad()
    def step(self, grads: Dict[int, torch.Tensor], lrs: Dict[int, float]
             ) -> None:
        """``grads`` / ``lrs``: by ``id`` of each parameter."""
        t_step = torch.tensor(self.count + 1, dtype=torch.float32)
        decay = float(1.0 - t_step ** -DECAY_RATE)
        self.count += 1
        for t, v in zip(self.tensors, self.v):
            g = t.gather([grads[id(p)] for p in t.params]).float()
            p = t.gather(t.params).float()
            lr = lrs[id(t.params[0])]
            g2 = torch.square(g) + EPS
            dims = factored_dims(t.shape)
            if dims is None:
                vf = local(v[0])
                vf.copy_(decay * vf + (1.0 - decay) * g2)
                u = g * torch.rsqrt(vf)
            else:
                d1, d0 = dims
                vr, vc = (local(x) for x in v)
                vr.copy_(decay * vr + (1.0 - decay) * t.mean(g2, d0))
                vc.copy_(decay * vc + (1.0 - decay) * t.mean(g2, d1))
                # vr's mean over the tensor's axis d1 (vr lacks axis d0)
                if d1 in t.split.values():
                    vr_mean = t.mean(vr.unsqueeze(d0), d1,
                                     keepdim=True).squeeze(d0)
                else:
                    vr_mean = vr.mean(d1 - 1 if d1 > d0 else d1,
                                      keepdim=True)
                row = torch.rsqrt(vr / vr_mean)
                u = g * row.unsqueeze(d0) * torch.rsqrt(vc).unsqueeze(d1)
            u = u / torch.clamp(t.rms(u) / CLIPPING_THRESHOLD, min=1.0)
            u = u * lr
            rms_p = t.rms(p)
            u = u * torch.where(rms_p <= MIN_SCALE, MIN_SCALE, rms_p)
            if self.wd:
                u = u + self.wd * p
            t.scatter_add_((-u).to(t.params[0].dtype))

    def state_dict(self) -> dict:
        return {"count": self.count,
                "v": {t.key: list(v) for t, v in zip(self.tensors, self.v)}}

    def load_state_dict(self, sd: dict) -> None:
        """Raises ``ValueError``, before it copies anything, when the saved
        state is not of these tensors (the trained set changed)."""
        saved = sd["v"]
        if set(saved) != {t.key for t in self.tensors}:
            raise ValueError(
                f"adafactor: the saved state holds tensors {sorted(saved)}, "
                f"this optimizer {sorted(t.key for t in self.tensors)}")
        for t, v in zip(self.tensors, self.v):
            check_state_shapes(f"adafactor {t.key}", list(v), list(saved[t.key]))
        self.count = int(sd["count"])
        for t, v in zip(self.tensors, self.v):
            for dst, src in zip(v, saved[t.key]):
                local(dst).copy_(local(src))
