"""Rematerialisation of a layer stack (counterpart of
``showo_tpu/utils/remat.py::wrap_remat``).

  False / None / "none"  no remat
  True / "full"          each layer under ``torch.utils.checkpoint``
                         (non-reentrant): only its inputs are kept, the
                         layer is recomputed in the backward
  "dots"                 as "full", and the output of every projection
                         (JAX's ``dots_with_no_batch_dims_saveable``:
                         products without batch dims) is kept
  "qkv"                  as "full", and the outputs tagged ``qkv_out``
  "qkv_fc1"              ... ``qkv_out`` and ``fc1_out``
  "qkv_attn"             ... ``qkv_out`` and ``attn_out``
  "qkv_fc1_attn"         ... ``qkv_out``, ``fc1_out`` and ``attn_out``

What a policy must give is JAX's set of forward products recomputed in
the backward: a kept projection is not recomputed, every other one whose
output the backward reads is, and one whose output the backward never
reads (XLA drops it: Phi's ``dense`` and ``fc2``, Qwen's ``down``,
SigLIP's ``fc2``, whose outputs only join the residual sum) is not.

How: the layer runs under one non-reentrant checkpoint, and its
projections go through :func:`project` (its tags through :func:`keep`).
Inside a checkpointed layer a projection is a custom autograd Function
that saves its input and weight as ``nn.Linear``'s product does and
whose backward is that product's.  The first call of the layer (the
forward) stashes the outputs the policy keeps; the recompute that
``torch.utils.checkpoint`` runs in the backward calls the layer again,
and there a kept projection returns its stashed output and a projection
marked ``tail`` (output read by nothing but the residual sum) returns an
empty tensor, each without its product, while every saved input is
produced again as the checkpoint expects.  A ``keep`` tag on a tensor
that is not a projection's output (``attn_out``, the attention's output)
stashes it and hands the stash to the recompute; the attention is run
again all the same, since its own backward reads its internals (the
dense route's probabilities, kernel 7 / 8's log-sum-exp, which JAX's
kernel recomputes too).  The kernels are ctypes launches that no
``TorchDispatchMode`` sees, and a selective-checkpoint policy keyed on
aten ops would replay the matmul that feeds a tag and every output
projection: hence regions and Functions, with the public checkpoint API
only.  Outside a checkpointed layer :func:`project` is the module's own
forward, so inference runs what it ran before.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from showo_tpu_torch.parallel.mesh import is_tensor_parallel

TAGGED_POLICIES = ("dots", "qkv", "qkv_fc1", "qkv_attn", "qkv_fc1_attn")
POLICIES = ("none", "full") + TAGGED_POLICIES
_KEPT = {"full": (), "dots": (), "qkv": ("qkv_out",),
         "qkv_fc1": ("qkv_out", "fc1_out"),
         "qkv_attn": ("qkv_out", "attn_out"),
         "qkv_fc1_attn": ("qkv_out", "fc1_out", "attn_out")}

# the region of the layer running on this thread: the context that
# ``project`` and ``keep``, called deep inside a layer's forward, read (as
# autocast's state is read), set and reset by ``_Region.__call__``
_state = threading.local()


def check_policy(remat) -> str:
    """The policy's name ("none" for False / None, "full" for True);
    unknown names raise ``ValueError``."""
    if remat in (False, None, "none"):
        return "none"
    if remat is True or remat == "full":
        return "full"
    if remat in TAGGED_POLICIES:
        return remat
    raise ValueError(f"unknown remat policy {remat!r}; the port has "
                     f"{POLICIES}")


class _Region:
    """One checkpointed call of a layer: the policy's kept tags, the
    stash of kept outputs (in the order the forward made them) and
    whether this call is the recompute."""

    def __init__(self, policy: str):
        self.dots = policy == "dots"
        self.kept = _KEPT[policy]
        self.stash: list = []
        self.calls = 0
        self.at = 0

    def keeps(self, tag: Optional[str], projection: bool) -> bool:
        return (self.dots and projection) or (tag is not None
                                              and tag in self.kept)

    def __call__(self, fn, *args):
        self.calls += 1
        self.at = 0
        prev = getattr(_state, "region", None)
        _state.region = self
        try:
            return fn(*args)
        finally:
            _state.region = prev

    @property
    def recomputing(self) -> bool:
        return self.calls > 1

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """Forward: stash ``t`` (detached) and return it.  Recompute: the
        stashed tensor of this place (``t`` may be None there).  The stash
        holds values only: a stashed tensor with its graph would close a
        cycle through the checkpoint's saved-tensor hooks (graph -> hook
        -> recompute function -> this region -> graph) that Python's
        collector cannot see, and a forward that fails before its
        backward would then never be freed."""
        if not self.recomputing:
            self.stash.append(t.detach())
            return t
        out = self.stash[self.at]
        self.at += 1
        return out


def _region() -> Optional[_Region]:
    return getattr(_state, "region", None)


class _Projection(torch.autograd.Function):
    """``F.linear(x, weight, bias)``, or ``out`` in its place (the
    recompute's stashed output or empty tensor); saves x and weight and
    differentiates as aten's addmm / mm do."""

    @staticmethod
    def forward(ctx, x, weight, bias, out):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if out is not None:
            return out.detach()
        return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = g2.mm(w).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = g2.t().mm(x.reshape(-1, x.shape[-1]))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dw, db, None


def project(linear: nn.Module, x: torch.Tensor, tag: Optional[str] = None,
            tail: bool = False) -> torch.Tensor:
    """``linear(x)`` for a projection of a layer: ``tag`` names it for the
    tagged policies (``qkv_out`` / ``fc1_out``); ``tail`` marks one whose
    output the backward never reads (it joins only the residual sum)."""
    r = _region()
    if r is None or is_tensor_parallel(linear):
        # a tensor-parallel linear computes its share and gathers it
        # (``parallel/mesh.py``); it is recomputed whole, kept or not
        return linear(x)
    w, b = linear.weight, linear.bias
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        dt = torch.get_autocast_dtype(dev)
        x, w = x.to(dt), w.to(dt)
        b = None if b is None else b.to(dt)
    keep = r.keeps(tag, projection=True)
    out = None
    if r.recomputing:
        if keep:
            out = r.take(None)
        elif tail:
            out = x.new_empty((*x.shape[:-1], w.shape[0]))
    y = _Projection.apply(x, w, b, out)
    if keep and not r.recomputing:
        r.take(y)
    return y


def keep(tag: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` under the tag ``tag`` (``attn_out``): kept where the policy
    keeps the tag (the recompute then reads the kept tensor)."""
    r = _region()
    if r is None or not r.keeps(tag, projection=False):
        return t
    kept = r.take(t)
    return t if kept is t else kept.detach()


def wrap_remat(fn, remat):
    """``fn`` (a layer's forward) under the remat policy ``remat``."""
    policy = check_policy(remat)
    if policy == "none":
        return fn

    def run(*args):
        region = _Region(policy)
        return checkpoint(region, fn, *args, use_reentrant=False)

    return run
