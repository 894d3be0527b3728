"""Training diagnostics (models/training_utils.py, training/utils.py).

Counterpart of ``showo_tpu/training/metrics.py``, as plain functions on
tensors: the soft-target cross entropy (training/utils.py:55-71), the
per-masking-rate-bucket cross entropy and entropies
(training_utils.py:299-431), per-parameter gradient norms (train.py
:892-897) and the mean predictive entropy.  No trainer logs them, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F


def soft_target_cross_entropy(logits, targets, soft_targets):
    """CE against soft targets, the first position dropped, the positions
    whose target is -100 left out (mean over the rest)."""
    logits = logits[:, 1:]
    targets = targets[:, 1:]
    logits = logits[..., :soft_targets.shape[-1]]
    log_probs = torch.log_softmax(logits, dim=-1)
    padding_mask = targets == -100
    loss = torch.sum(-soft_targets * log_probs, dim=-1)
    loss = torch.where(padding_mask, 0.0, loss)
    num_active = padding_mask.numel() - padding_mask.sum()
    return loss.sum() / num_active.clamp(min=1)


def _log_softmax(logits):
    return torch.log_softmax(logits.float(), dim=-1)


def masked_bucket_cross_entropy(logits, labels, mask_prob,
                                num_buckets: int = 10, ignore_id: int = -100
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE of each masking-rate bucket [num_buckets], samples in each
    bucket [num_buckets]): a sample's CE is its mean over the labelled
    positions, its bucket ``int(mask_prob * num_buckets)``."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(_log_softmax(logits), -1, safe[..., None])[..., 0]
    per_sample = (torch.where(valid, nll, 0.0).sum(-1)
                  / valid.sum(-1).clamp(min=1))
    bucket = torch.clamp((mask_prob * num_buckets).int(), 0,
                         num_buckets - 1)
    one_hot = F.one_hot(bucket.long(), num_buckets).float()
    counts = one_hot.sum(0)
    sums = (one_hot * per_sample[:, None]).sum(0)
    return sums / counts.clamp(min=1), counts


def per_param_grad_norms(grads: Mapping[str, torch.Tensor],
                         prefix: str = "grad_norm/"
                         ) -> Dict[str, torch.Tensor]:
    """{prefix + name: the L2 norm of that parameter's gradient}."""
    return {prefix + name: torch.linalg.vector_norm(g.reshape(-1))
            for name, g in grads.items()}


def token_entropy(logits, mask: Optional[torch.Tensor] = None):
    """Mean predictive entropy over the positions (those of ``mask``)."""
    logp = _log_softmax(logits)
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    if mask is not None:
        ent = torch.where(mask, ent, 0.0)
        return ent.sum() / mask.sum().clamp(min=1)
    return ent.mean()


def input_ids_to_masked_buckets(input_ids, mask_id: int,
                                total_buckets: int = 10):
    """Each sample's masking-rate decile: ``int(share of mask_id *
    total_buckets)``."""
    frac = (input_ids == mask_id).sum(-1).float() / input_ids.shape[-1]
    return torch.clamp((frac * total_buckets).int(), 0, total_buckets - 1)


def average_by_buckets(values, buckets, total_buckets: int = 10):
    """The mean of ``values`` in each bucket; an empty bucket reports 0."""
    one_hot = F.one_hot(buckets.long(), total_buckets).float()
    counts = one_hot.sum(0)
    sums = (one_hot * values[:, None]).sum(0)
    return sums / counts.clamp(min=1)


def pixel_entropy_per_percent_masked_bucket(logits, input_ids, mask_id: int,
                                            total_buckets: int = 10):
    """The mean per-token predictive entropy over each sample's masked
    positions, averaged by masking-rate bucket."""
    masked = input_ids == mask_id
    logp = _log_softmax(logits)
    ent = torch.where(masked, -torch.sum(torch.exp(logp) * logp, dim=-1),
                      0.0)
    per_image = ent.sum(-1) / masked.sum(-1).clamp(min=1)
    return average_by_buckets(
        per_image, input_ids_to_masked_buckets(input_ids, mask_id,
                                               total_buckets), total_buckets)


def image_entropy_per_percent_masked_bucket(logits, input_ids, mask_id: int,
                                            total_buckets: int = 10):
    """The entropy of each sample's distribution averaged over its masked
    positions, averaged by masking-rate bucket."""
    masked = input_ids == mask_id
    probs = torch.softmax(logits.float(), dim=-1)
    probs = torch.where(masked[..., None], probs, 0.0)
    image_probs = probs.sum(-2) / masked.sum(-1)[..., None].clamp(min=1)
    ent = -torch.sum(image_probs * torch.log(image_probs.clamp(min=1e-20)),
                     dim=-1)
    return average_by_buckets(
        ent, input_ids_to_masked_buckets(input_ids, mask_id, total_buckets),
        total_buckets)
