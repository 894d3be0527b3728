"""Semantic-layer distillation (show-o2/models/modeling_semantic_layers.py).

Counterpart of ``showo_tpu/show_o2/semantic_layers.py``: before stage 1,
``image_embedder_und`` + ``und_trans`` are trained so that the patch
embedded VAE latents give SigLIP's pixel features, under the loss
``-log((cos + 1) / 2)`` (:86-99).  The step is plain autograd and any
``torch.optim`` optimizer over the two modules.
"""

from __future__ import annotations

from typing import Iterable

import torch

from showo_tpu_torch.show_o2.showo2 import Showo2, semantic_features


def semantic_layer_features(model: Showo2,
                            latents_nchw: torch.Tensor) -> torch.Tensor:
    """VAE latents [B, C, H, W] -> und features [B, N, D_clip]: the patch
    embedding, the SigLIP position table (interpolated off its grid) and
    the SigLIP layers (``showo2.py::semantic_features``, the und path of
    the model's forward)."""
    return semantic_features(
        model, latents_nchw.to(model.image_embedder_und.proj.weight.dtype))


def distillation_loss(pred: torch.Tensor, target: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """-log((cos + 1) / 2) of each token's pair, clipped at ``eps``, averaged
    over the tokens (modeling_semantic_layers.py:86-99)."""
    pn = pred / torch.clamp(torch.linalg.vector_norm(
        pred, dim=-1, keepdim=True), min=eps)
    tn = target / torch.clamp(torch.linalg.vector_norm(
        target, dim=-1, keepdim=True), min=eps)
    sim = torch.sum(pn * tn, dim=-1)
    return -torch.log(torch.clamp((sim + 1.0) / 2.0, min=eps)).mean()


def distillation_parameters(model: Showo2) -> Iterable[torch.nn.Parameter]:
    """What the distillation trains: ``image_embedder_und``, the position
    table and ``und_trans``."""
    yield from model.image_embedder_und.parameters()
    yield from model.position_embedding.parameters()
    yield from model.und_trans.parameters()


class DistillStep:
    """One distillation step (JAX ``make_distill_step``): the loss of
    :func:`semantic_layer_features` against the target features, its
    gradient and ``optimizer.step()``; returns the loss."""

    def __init__(self, model: Showo2, optimizer: torch.optim.Optimizer):
        self.model, self.optimizer = model, optimizer

    def __call__(self, latents: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = distillation_loss(semantic_layer_features(self.model, latents),
                                 target)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
