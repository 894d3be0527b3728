"""Plain PyTorch reference of the Show-o2 stage-1 training step: the frozen
Wan2.1 VAE encoder on one frame and its posterior sample, the linear flow
plan, the next-token and velocity losses of the Show-o2 forward
(``showo2_v2.forward``), their gradient, the clip by global norm and
AdamW, all in fp32.

The step runs over blocks of ``BLOCK`` rows, each block's losses in their
sum form over the whole batch's counts, so that the accumulated gradient
is the whole batch's.  Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.showo2_v2 import (FP32, MEAN, STD, Dims, Precision,
                                           _cconv, _conv3, _res3, _vres, _vrms,
                                           forward, patchify)

# rows a block of the reference's forward and backward: one, so that the
# fp32 activations of a 1024-token row fit beside the fp32 optimizer state
BLOCK = 1


def _encoder_plan(d: Dims):
    dims = [d.vae_dim * u for u in (1,) + tuple(d.vae_mult)]
    plan = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        c = a
        for _ in range(d.vae_res):
            plan.append(("res", c, b))
            c = b
        if i != len(d.vae_mult) - 1:
            plan.append(("down3d" if d.vae_tdown[i] else "down2d", b, b))
    return plan


def encoder_specs(d: Dims, prefix: str = "vae.") -> List[tuple]:
    """The encoding half of the Wan2.1 VAE (``encoder`` and ``conv1``)."""
    top = d.vae_dim * d.vae_mult[-1]
    p = prefix + "encoder."
    out = _conv3(p + "conv1", 3, d.vae_dim, 3)
    for i, (kind, a, b) in enumerate(_encoder_plan(d)):
        q = f"{p}downsamples.{i}"
        if kind == "res":
            out += _res3(q, a, b)
        else:
            out += [(q + ".resample.1.weight", (a, a, 3, 3)),
                    (q + ".resample.1.bias", (a,))]
            if kind == "down3d":
                out += [(q + ".time_conv.weight", (a, a, 3, 1, 1)),
                        (q + ".time_conv.bias", (a,))]
    out += (_res3(p + "middle.0", top, top)
            + [(p + "middle.1.norm.gamma", (top, 1, 1)),
               (p + "middle.1.to_qkv.weight", (3 * top, top, 1, 1)),
               (p + "middle.1.to_qkv.bias", (3 * top,)),
               (p + "middle.1.proj.weight", (top, top, 1, 1)),
               (p + "middle.1.proj.bias", (top,))]
            + _res3(p + "middle.2", top, top)
            + [(p + "head.0.gamma", (top, 1, 1, 1))]
            + _conv3(p + "head.2", top, 2 * d.latent, 3))
    return out + _conv3(prefix + "conv1", 2 * d.latent, 2 * d.latent, 1)


@torch.no_grad()
def encode(W, d: Dims, pixels: torch.Tensor, eps: torch.Tensor,
           prefix: str = "vae.") -> torch.Tensor:
    """Pixels [B, H, W, 3] in [-1, 1] -> the posterior sample of the
    scale-normalised latents [B, C, h, w] with the normal draw ``eps``."""
    W = {k[len(prefix):]: v for k, v in W.items() if k.startswith(prefix)}
    p = "encoder."
    h = _cconv(pixels.permute(0, 3, 1, 2).float(), W, p + "conv1", 3)
    for i, (kind, _, _) in enumerate(_encoder_plan(d)):
        q = f"{p}downsamples.{i}"
        if kind == "res":
            h = _vres(h, W, q)
        else:
            h = F.conv2d(F.pad(h, (0, 1, 0, 1)), W[q + ".resample.1.weight"],
                         W[q + ".resample.1.bias"], stride=2)
    h = _vres(h, W, p + "middle.0")
    B, C, H, Wd = h.shape
    a = _vrms(h, W[p + "middle.1.norm.gamma"])
    qkv = F.conv2d(a, W[p + "middle.1.to_qkv.weight"],
                   W[p + "middle.1.to_qkv.bias"])
    q, k, v = qkv.flatten(2).transpose(1, 2).chunk(3, -1)
    att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), -1) @ v
    h = h + F.conv2d(att.transpose(1, 2).reshape(B, C, H, Wd),
                     W[p + "middle.1.proj.weight"],
                     W[p + "middle.1.proj.bias"])
    h = _vres(h, W, p + "middle.2")
    h = _cconv(F.silu(_vrms(h, W[p + "head.0.gamma"])), W, p + "head.2", 3)
    mu, log_var = _cconv(h, W, "conv1", 1).chunk(2, dim=1)
    kw = dict(dtype=mu.dtype, device=mu.device)
    mu = (mu - torch.tensor(MEAN, **kw).view(1, -1, 1, 1)) / torch.tensor(
        STD, **kw).view(1, -1, 1, 1)
    return mu + torch.exp(0.5 * log_var.clamp(-30.0, 20.0)) * eps


def losses(W, d: Dims, batch: Dict[str, torch.Tensor], rows: slice,
           counts, prec: Precision = FP32):
    """(ntp sum / its count, flow sum / its count) of the batch's rows
    ``rows``, the counts those of the whole batch."""
    text = batch["text_tokens"][rows]
    offs = batch["modality_positions"][rows, 0, 0]
    v_seq, logits = forward(W, d, text, offs, batch["xt"][rows],
                            batch["t"][rows], prec, logits=True)
    labels = batch["text_labels"][rows]
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        -100)], 1)
    valid = shifted != -100
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, shifted.clamp(min=0)[..., None])[..., 0]
    ntp = torch.where(valid, nll, 0.0).sum() / counts[0]
    n = d.n_image
    target = torch.zeros_like(v_seq)
    lab = patchify(d, batch["ut"][rows])
    mask = batch["image_masks"][rows].clone().bool()
    for r in range(text.shape[0]):
        o = int(offs[r])
        target[r, o + 1:o + n] = lab[r]
        mask[r, o] = False
    se = (v_seq - target).square().sum(-1)
    flow = torch.where(mask, se, 0.0).sum() / counts[1]
    return ntp, flow


def counts(d: Dims, batch) -> tuple:
    labels = batch["text_labels"]
    n_ntp = (labels[:, 1:] != -100).sum()
    mask = batch["image_masks"].bool().clone()
    for r in range(mask.shape[0]):
        mask[r, int(batch["modality_positions"][r, 0, 0])] = False
    n_flow = mask.sum() * d.patch * d.patch * d.latent
    return n_ntp.clamp(min=1).float(), n_flow.clamp(min=1).float()


def train_steps(W, d: Dims, batches, trained: List[str], lrs, coeffs,
                max_norm: float, weight_decay: float,
                prec: Precision = FP32, rows_kept: int = 0, state=None,
                first_step: int = 0) -> dict:
    """The steps of ``batches`` (each with ``xt``, ``t``, ``ut`` made)
    from weights W (updated in place: the ``trained`` names are leaves
    with gradients).  Returns each step's (total, ntp, flow) and the first
    step's clipped gradient norms by name.  ``state``: AdamW's moments
    (exp_avg, exp_avg_sq) of each trained leaf (None: none yet) after
    ``first_step`` steps, to go on from.  ``rows_kept`` > 0 keeps only the
    first rows of each batch: the half-batch fault."""
    params = [W[k] for k in trained]
    opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    for p, mo in zip(params, state or []):
        if mo is not None:
            opt.state[p] = {"step": torch.tensor(float(first_step)),
                            "exp_avg": mo[0], "exp_avg_sq": mo[1]}
    out = {"losses": [], "grad_norms": None}
    for step, batch in enumerate(batches):
        if rows_kept:
            batch = {k: v[:rows_kept] for k, v in batch.items()}
        c = counts(d, batch)
        B = batch["text_tokens"].shape[0]
        tot = [0.0, 0.0]
        for r0 in range(0, B, BLOCK):
            ntp, flow = losses(W, d, batch, slice(r0, r0 + BLOCK), c, prec)
            (coeffs[0] * ntp + coeffs[1] * flow).backward()
            tot[0] += float(ntp.detach())
            tot[1] += float(flow.detach())
        grads = [p.grad for p in params]
        norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
        if norm >= max_norm:
            for g in grads:
                g.div_(norm).mul_(max_norm)
        if step == 0:
            out["grad_norms"] = {k: float(p.grad.norm())
                                 for k, p in zip(trained, params)}
        for group in opt.param_groups:
            group["lr"] = lrs[step]
        opt.step()
        opt.zero_grad(set_to_none=True)
        out["losses"].append((coeffs[0] * tot[0] + coeffs[1] * tot[1],
                              tot[0], tot[1]))
    return out
