#!/usr/bin/env python3
"""Smoke run of the PyTorch port (showo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives two paths of Show-o 1.3B at full width (Phi-1.5: 24 layers,
hidden 2048, 32 heads; random weights from fixed seeds):

* the v1 512x512 text-to-image path (the ``t2i_512`` bench row) with the
  full MAGVIT-v2 decoder, bf16, 16-step prefix-cached MaskGIT with CFG
  1.75, batch 2, through the CLI's ``build_pipeline``, once on each
  attention route with an inference kernel: ``packed`` (the default at
  512x512), ``omni``, ``decode`` and ``fused``;
* the v1 stage-1 trainer (``configs/showo_pretraining_stage1.yaml``,
  warmup 0) through ``build_trainer`` on the ``trainable`` route: the
  frozen full MAGVIT-v2 encoder, 15 t2i + 4 lm + 10 mmu rows of 387
  tokens at 256x256, AdamW, clip 1.0, remat "full", bf16 autocast over
  fp32 master weights, a seeded in-memory batch.

Phases, one or more lines each:

  1. device: card name and power limit, torch / CUDA versions; TF32 off
  2. build: nvcc builds the five kernel sources of csrc/, in parallel
  3. kernel vs plain: each inference kernel at the cached step's shapes
     (B=4, P=129, H=32, D=64, bf16, metadata of a left-padded t2i
     layout): the packed kernel at 512x512 and one GQA case; omni, decode
     and fused at 512x512 (Q=1026, K=1155) and 256x256 (Q=258, K=387);
     max abs error, median times (CUDA events) of kernel, plain version
     and one library call of the same function, and the bound
  4. the t2i slice, per route: over one generate call the route's kernel
     launches 24 layers x 16 steps times and every other kernel none;
     codes in the codebook; images finite, NHWC, in [-1, 1]; warm
     seconds per batch and images/min
  5. step parity, per route: one full-width cached step with the route's
     kernel and with dense attention under the additive mask, max abs
     logit difference
  6. trainable kernels vs plain: forward (out, lse), dq and dk/dv at the
     stage-1 shape (B=29, S=387, H=32, D=64, bf16, metadata of the
     trainer's fused batch), a GQA case and a ragged S=200 with rows that
     see no key; errors, median times of kernel, plain version and
     ``scaled_dot_product_attention`` with the boolean mask (forward,
     backward, forward + backward), and the bounds; then the same checks
     on two faults planted in the plain versions (V of the wrong kv head,
     one K tile dropped), each of which must fail them
  7. the training slice: the first step, then TRAIN_STEPS steps on the
     same batch with every launch count set to 0 before them: per step
     48 forward launches (24 layers + 24 recomputed by remat), 24 dq and
     24 dk/dv, none of the inference kernels; losses finite and falling;
     median step time, samples/s, peak device memory
  8. training step parity: one full-width step's losses and grad norm on
     ``trainable`` against ``dense``, same weights, batch and draws

Then a JSON line of kernel results, the nvidia-smi name/power line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero with no result line; without CUDA it exits 2.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time

CARD_TOL = 2e-2      # kernel vs plain, max abs error of bf16 attention
#                      outputs (averages of ~N(0, 1) values) and of lse
GRAD_TOL = 1e-2      # kernel vs plain, gradients: ||kernel - plain|| /
#                      ||plain|| (their size varies by rows; no peak scale)
STEP_TOL = 1e-1      # max |logit| difference, kernel vs dense, full step
# trainable vs dense, one full-width training step under bf16 autocast:
# the routes round P to bf16 at different points (the kernels before
# normalising, the dense path after), so the 24 layers differ by bf16
# noise; relative difference of each loss part (read on an H100: 2e-6 to
# 8.1e-5 over two builds of the kernels), and of the grad norm (read:
# 5.9e-5 to 2.1e-4), 6-10x above the largest readings
TRAIN_LOSS_TOL, GRAD_NORM_TOL = 5e-4, 2e-3
NUM_LAYERS, TIMESTEPS, BATCH = 24, 16, 2
P, H, D = 129, 32, 64            # text prefix rows, heads, head dim
TRAIN_STEPS = 4
# H100 SXM peaks (NVIDIA data sheet): device memory rate, dense bf16 rate
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12

# route -> (kernel source name, the TPU kernel it replaces)
KERNELS = {
    "packed": ("omni_attention_packed",
               "showo_tpu/ops/flash_attention.py:232"),
    "omni": ("omni_attention", "showo_tpu/ops/flash_attention.py:87"),
    "decode": ("decode_attention", "showo_tpu/ops/decode_attention.py:69"),
    "fused": ("fused_decode", "showo_tpu/ops/fused_decode.py:114"),
}
# the trainable route's three kernels (one source): counter name, the
# Pallas kernel it replaces, launches per training step (remat "full"
# runs each layer's forward twice)
TRAIN_SOURCE = "packed_attention_grad"
TRAIN_KERNELS = {
    "packed_attention_grad_fwd": (
        "showo_tpu/ops/packed_attention_grad.py:56", 2 * NUM_LAYERS),
    "packed_attention_grad_dq": (
        "showo_tpu/ops/packed_attention_grad.py:97", NUM_LAYERS),
    "packed_attention_grad_dkv": (
        "showo_tpu/ops/packed_attention_grad.py:138", NUM_LAYERS),
}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(bytes_moved: float, flops: float) -> dict:
    """The least time of the work on an H100: the larger of its bytes over
    the memory rate and its operations over the bf16 tensor-core rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _t2i_layout(uni, prompts, num_vq_tokens: int, mask_id: int, device):
    """[cond | uncond] token rows of the t2i layout for the prompts."""
    import numpy as np
    import torch

    img = np.full((BATCH, num_vq_tokens), mask_id, np.int64)
    ids, _ = uni((prompts, img), "t2i_gen")
    unc, _ = uni(([""] * len(prompts), img), "t2i_gen")
    return torch.as_tensor(np.concatenate([ids, unc]), device=device)


def _errors(got, want):
    """(max abs error, relative norm error ||got - want|| / ||want||) of
    two tuples of tensors, each the larger over the tuple."""
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        d = g.float() - w.float()
        abs_err = max(abs_err, d.abs().max().item())
        rel_err = max(rel_err, (d.norm() / w.float().norm()).item())
    return abs_err, rel_err


def _check(got, want, grads):
    """(error, tolerance) of the check a kernel's result is held to: the
    max abs error against CARD_TOL, or for gradients the relative norm
    error against GRAD_TOL."""
    abs_err, rel_err = _errors(got, want)
    return (rel_err, GRAD_TOL) if grads else (abs_err, CARD_TOL)


def _compare(torch, label, kern, plain, bound, library=None, phase=3,
             grads=False):
    """Kernel vs plain on the same inputs (one tensor or a tuple of them),
    checked by :func:`_check`, then median times of kernel, plain version
    and the library call, and the bound."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel output not finite")
    abs_err, rel_err = _errors(got, want)
    err, tol = _check(got, want, grads)
    what = "relative norm error" if grads else "max abs error"
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs plain {what} {err} > {tol}")
    ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
    lib_ms = _time_ms(torch, library) if library is not None else None
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
    print(f"[{phase}] {label} bf16: max_abs_err {abs_err:.3e}, relative norm "
          f"err {rel_err:.3e} (tol {tol:.0e} on the {what}), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} (median of "
          f"20); bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return {"max_abs_err": abs_err, "rel_norm_err": rel_err, "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": lib_ms}


def phase_kernels(torch, uni, prompts, cfg, device):
    """Each kernel against its plain version at the main path's shapes;
    returns {route: {"512": result, "256": result}}."""
    import torch.nn.functional as F

    from showo_tpu_torch.models.phi import rope_tables
    from showo_tpu_torch.ops import decode_attention as tda
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import fused_decode as tfd
    from showo_tpu_torch.ops.masks import omni_mask_predict_next

    sp = uni.sptids
    ids = (sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"])
    hidden = H * D
    out = {route: {} for route in KERNELS}
    for res, vq_tokens in (("512", 1024), ("256", 256)):
        full = _t2i_layout(uni, prompts, vq_tokens, cfg.mask_token_id, device)
        B, L = full.shape
        Q = L - P
        meta = tfa.metadata_predict_next(full, *ids)
        if not int(meta[1].sum()) > 0:
            raise AssertionError("the t2i layout must be left-padded")
        pos = torch.arange(P, L, device=device)
        # the metadata each forward computes once (models/phi.py attn_step)
        pos_q, seg_q = tfa.q_rows(meta[0], pos, B, Q)
        rows = tfd.fused_rows(meta[0], meta[1], pos, P, B)
        shape = f"B={B} Q={Q} K={L} H={H} D={D}"
        g = torch.Generator(device=device).manual_seed(vq_tokens)
        # the work the mask leaves: 4*D operations per visible (row, key)
        # pair and head (q.k and p.v); metadata bytes beside the tensors
        vis = tfa.visible_mask(*meta, pos_q)
        flops = 4 * D * H * int(vis.sum())
        meta_bytes = 4 * (2 * B * L + 2 * B + 2 * B * Q)
        mask = vis[:, None]

        def randn(*s):
            return torch.randn(*s, generator=g, device=device).bfloat16()

        def sdpa(q4, k4, v4, m=mask, **kw):
            return lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m, **kw)

        if res == "512":
            for hkv in (H, H // 4):
                q, k, v = randn(B, Q, H * D), randn(B, L, hkv * D), randn(
                    B, L, hkv * D)
                heads = (t.unflatten(-1, (-1, D)).transpose(1, 2)
                         for t in (q, k, v))
                r = _compare(
                    torch, f"omni_attention_packed {shape} Hkv={hkv}",
                    lambda: tfa.omni_attention_packed(
                        q, k, v, *meta, num_heads=H, num_kv_heads=hkv,
                        q_positions=pos_q, seg_q=seg_q),
                    lambda: tfa.omni_attention_packed_plain(
                        q, k, v, *meta, pos_q, num_heads=H,
                        num_kv_heads=hkv, sm_scale=D ** -0.5),
                    _bound(2 * (2 * B * Q * H + 2 * B * L * hkv) * D
                           + meta_bytes, flops),
                    sdpa(*heads, enable_gqa=hkv != H))
                out["packed"].setdefault(res, r)

        # omni: transposed [B, S, H, D] views, as phi's omni route passes
        q, k, v = (randn(B, n, H, D).transpose(1, 2) for n in (Q, L, L))
        qkv_bytes = 2 * (2 * B * Q * H + 2 * B * L * H) * D
        out["omni"][res] = _compare(
            torch, f"omni_attention {shape}",
            lambda: tfa.omni_attention(q, k, v, *meta, q_positions=pos_q,
                                       seg_q=seg_q),
            lambda: tfa.omni_attention_plain(q, k, v, *meta, pos_q,
                                             sm_scale=D ** -0.5),
            _bound(qkv_bytes + meta_bytes, flops), sdpa(q, k, v))

        # decode: the bias as the cached step's strided view of the mask;
        # the library call takes it cast to bf16 (the query's type)
        bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
        bias = bias[:, :, P:, :]
        q, k, v = (randn(B, n, H, D) for n in (Q, L, L))
        out["decode"][res] = _compare(
            torch, f"decode_attention {shape} (bias view, row stride {L})",
            lambda: tda.decode_attention(q, k, v, bias),
            lambda: tda.decode_attention_plain(q, k, v, bias),
            _bound(qkv_bytes + 4 * B * Q * L,
                   4 * D * H * int((bias == 0).sum())),
            sdpa(*(t.transpose(1, 2) for t in (q, k, v)),
                 m=bias.to(torch.bfloat16)))

        # fused: y a full-width win output, ck/cv views of a cache
        y = randn(B, Q, 3 * hidden + cfg.llm.intermediate_size)
        cache = randn(2, B, L, H, D)
        ln = [(1 + 0.1 * torch.randn(D, generator=g, device=device))
              .bfloat16(), (0.1 * torch.randn(D, generator=g, device=device))
              .bfloat16()]
        cos, sin = rope_tables(pos, 32, cfg.llm.rope_theta)
        args = (y, cache[0, :, :P].flatten(2), cache[1, :, :P].flatten(2),
                ln, ln, cos, sin)
        kw = dict(hidden=hidden, num_heads=H, rotary_dim=32, eps=1e-5)
        # bytes: y's q/k/v columns, the prefix K/V, out, cos/sin, norms;
        # operations: the attention products (LayerNorm and RoPE add ~1%);
        # no single library call does LN + RoPE + attention
        out["fused"][res] = _compare(
            torch, f"fused_decode_attention {shape} (y row stride "
            f"{y.shape[-1]})",
            lambda: tfd.fused_decode_attention(*args, *meta, pos, rows=rows,
                                               **kw),
            lambda: tfd.fused_decode_attention_plain(
                *args, meta[2], meta[3], rows, sm_scale=D ** -0.5,
                softmax_dtype=torch.float32, **kw),
            _bound(2 * (4 * B * Q + 2 * B * P) * hidden + 2 * Q * 32 * 4
                   + 4 * D * 2 + meta_bytes, flops))
    return out


def _ragged_meta(torch, device, B=4, S=200):
    """Metadata with an image span, left pads and last_pad = 5, so rows
    6..9 see no key (all their columns are pads they may not see)."""
    seg = torch.zeros((B, S), dtype=torch.int32, device=device)
    seg[:, 40:150] = 1
    pad = torch.zeros_like(seg)
    pad[:, :10] = 1
    last_pad = torch.full((B,), 5, dtype=torch.int32, device=device)
    return seg, pad, last_pad, torch.zeros_like(last_pad)


def _planted_faults(torch, tpag, shape, q, k, v, dout, lse, delta, m, kw):
    """Phase 6's checks on two faults planted in the plain versions, as a
    kernel would make them: V read from the neighbouring kv head, and keys
    64..127 (the second K tile) dropped for every row past last_pad (they
    are marked as pads).  Each faulty result is held to the correct plain
    result by :func:`_check`; each must fail it, or the check could not
    tell such a kernel from a right one."""
    B, S, KVD = v.shape
    hkv = kw["num_kv_heads"]
    wrong_v = v.view(B, S, hkv, D).roll(1, dims=2).reshape(B, S, KVD)
    pad = m[1].clone()
    pad[:, 64:128] = 1
    faults = {"V of the wrong kv head": (wrong_v, m),
              "K tile 64..127 dropped": (v, (m[0], pad, *m[2:]))}
    kernels = {
        "forward": (lambda v_, m_: tpag.packed_trainable_fwd_plain(
            q, k, v_, *m_, **kw)[0], False),
        "dq": (lambda v_, m_: tpag.packed_trainable_dq_plain(
            q, k, v_, dout, lse, delta, *m_, **kw), True),
        "dk/dv": (lambda v_, m_: tpag.packed_trainable_dkv_plain(
            q, k, v_, dout, lse, delta, *m_, **kw), True),
    }
    readings = []
    for fault, (v_f, m_f) in faults.items():
        for name, (fn, grads) in kernels.items():
            want, got = fn(v, m), fn(v_f, m_f)
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            err, tol = _check(got, want, grads)
            readings.append(f"{fault}, {name} {err:.3e} (tol {tol:.0e})")
            if not err > tol:
                raise AssertionError(f"{shape}: planted fault '{fault}' in "
                                     f"{name} passes the check: {err} <= "
                                     f"{tol}")
            del want, got
    print(f"[6] {shape}: planted faults, each failing the check: "
          + "; ".join(readings))


def phase_train_kernels(torch, meta):
    """The trainable route's kernels against their plain versions at the
    stage-1 shape (metadata of the trainer's fused batch), a GQA case and
    a ragged S with rows that see no key.  Returns {counter name: result}
    of the stage-1 case."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops.flash_attention import visible_mask

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(6)
    cases = [("stage-1", meta, H), ("stage-1 GQA", meta, H // 4),
             ("ragged, rows with no visible key",
              _ragged_meta(torch, device), H)]
    results = {}
    for label, m, hkv in cases:
        B, S = m[0].shape
        vis = visible_mask(*m, torch.arange(S, device=device).expand(B, S))
        empty = int((~vis.any(-1)).sum())
        shape = f"{label}: B={B} S={S} H={H} Hkv={hkv} D={D}"
        q, k, v, dout = (torch.randn(B, S, n * D, generator=g,
                                     device=device).bfloat16()
                         for n in (H, hkv, hkv, H))
        kw = dict(num_heads=H, num_kv_heads=hkv, sm_scale=D ** -0.5)
        out, lse = tpag.packed_trainable_fwd(q, k, v, *m, **kw)
        p_lse = tpag.packed_trainable_fwd_plain(q, k, v, *m, **kw)[1]
        lse_err = (lse - p_lse).abs().max().item()
        if not lse_err <= CARD_TOL or (
                (lse == tpag.LSE_EMPTY).sum() != empty * H):
            raise AssertionError(f"{shape}: lse err {lse_err} or rows with "
                                 f"no visible key not marked")
        delta = tpag.attention_delta(out, dout, H)
        args = (q, k, v, dout, lse, delta, *m)
        # bytes: each input read once and each output written once;
        # operations: 2*D per visible pair, head and product (forward 2
        # products, dq 3, dk/dv 4)
        n_vis = int(vis.sum())
        tensor = 2 * B * S * D
        meta_bytes = 4 * (2 * B * S + 2 * B)
        rows_bytes = 4 * B * H * S
        lib = {}
        if label == "stage-1" and not empty:
            heads = [t.unflatten(-1, (-1, D)).transpose(1, 2).detach()
                     .requires_grad_(True) for t in (q, k, v)]
            dout4 = dout.unflatten(-1, (-1, D)).transpose(1, 2)
            mask = vis[:, None]
            o4 = F.scaled_dot_product_attention(*heads, attn_mask=mask)
            lib = {
                "fwd": lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=mask),
                "bwd": lambda: torch.autograd.grad(o4, heads, dout4,
                                                   retain_graph=True),
            }
            fb = _time_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*heads, attn_mask=mask),
                heads, dout4))
            print(f"[6] {shape}: scaled_dot_product_attention with the "
                  f"boolean mask, forward + backward {fb:.4f} ms (median "
                  f"of 20)")
        r = {
            "packed_attention_grad_fwd": _compare(
                torch, f"trainable forward {shape}",
                lambda: tpag.packed_trainable_fwd(q, k, v, *m, **kw)[0],
                lambda: tpag.packed_trainable_fwd_plain(q, k, v, *m,
                                                        **kw)[0],
                _bound((2 * H + 2 * hkv) * tensor + rows_bytes + meta_bytes,
                       4 * D * H * n_vis), lib.get("fwd"), phase=6),
            "packed_attention_grad_dq": _compare(
                torch, f"trainable dq {shape}",
                lambda: tpag.packed_trainable_dq(*args, **kw),
                lambda: tpag.packed_trainable_dq_plain(*args, **kw),
                _bound((3 * H + 2 * hkv) * tensor + 2 * rows_bytes
                       + meta_bytes, 6 * D * H * n_vis), lib.get("bwd"),
                phase=6, grads=True),
            "packed_attention_grad_dkv": _compare(
                torch, f"trainable dk/dv {shape}",
                lambda: tpag.packed_trainable_dkv(*args, **kw),
                lambda: tpag.packed_trainable_dkv_plain(*args, **kw),
                _bound((2 * H + 4 * hkv) * tensor + 2 * rows_bytes
                       + meta_bytes, 8 * D * H * n_vis), lib.get("bwd"),
                phase=6, grads=True),
        }
        print(f"[6] {shape}: lse max_abs_err {lse_err:.3e}; {empty} rows "
              f"with no visible key (out 0, lse 1e9 in every head); library "
              f"call of dq and dk/dv: one backward of "
              f"scaled_dot_product_attention (dq, dk, dv together)")
        _planted_faults(torch, tpag, shape, q, k, v, dout, lse, delta, m, kw)
        results.setdefault("stage-1", r)
    return results["stage-1"]


def phase_train(torch, cuda_build, trainer, batch, noise, smi):
    """The training slice: one step, then TRAIN_STEPS steps on the same
    batch and draws with the launch counts set to 0 before them."""
    m = trainer.train_step(*batch, noise=noise)
    losses = [float(m["loss"])]
    want = {name: 0 for name, _ in KERNELS.values()}
    want.update({name: n * TRAIN_STEPS
                 for name, (_, n) in TRAIN_KERNELS.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    walls, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = trainer.train_step(*batch, noise=noise)
        losses.append(float(m["loss"]))            # waits for the step
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"training launches over {TRAIN_STEPS} steps "
                             f"{counts}, want {want}")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = statistics.median(walls)
    rows = sum(trainer.step_fn.sizes)
    last = metrics[-1]
    tokens = trainer.tc.max_seq_length + 3 + trainer.cfg.num_vq_tokens
    print(f"[7] training slice stage-1, route trainable, {rows} rows x "
          f"{tokens} tokens, bf16 autocast, remat "
          f"{trainer.tc.remat}: launches per step "
          f"{ {n: c // TRAIN_STEPS for n, c in counts.items() if c} }, 0 of "
          f"the inference kernels; losses {[round(x, 4) for x in losses]}; "
          f"last step t2i {last['loss_t2i']:.4f} lm {last['loss_lm']:.4f} "
          f"mmu {last['loss_mmu']:.4f} grad_norm {last['grad_norm']:.4f}; "
          f"step {wall:.4f} s (median of {TRAIN_STEPS}: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{rows / wall:.2f} samples/s, peak memory allocated "
          f"{peak:.2f} GiB on {smi}")
    return {name: counts[name] for name in TRAIN_KERNELS}


def phase_train_parity(torch, trainer, batch, noise):
    """One full-width step's losses and grad norm on ``trainable`` and on
    ``dense``: the same weights, host batch and corruption draws."""
    from showo_tpu_torch.training.train_step import global_norm

    inputs = trainer.host_batch(*batch)
    dense = copy.copy(trainer.step_fn)
    dense.tc = dataclasses.replace(trainer.tc, attn_impl="dense")
    got, ids = {}, {}
    for route, step in (("trainable", trainer.step_fn), ("dense", dense)):
        prepared = step.prepare(*inputs, noise=noise)
        total, parts, grads = step.loss_and_grads(prepared)
        got[route] = [float(x) for x in (total, *parts, global_norm(grads))]
        ids[route] = prepared.input_ids
        del grads, prepared
    if not torch.equal(ids["trainable"], ids["dense"]):
        raise AssertionError("the two routes assembled different batches")
    names = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")
    rel = {n: abs(a - b) / abs(b) for n, a, b in
           zip(names, got["trainable"], got["dense"])}
    print(f"[8] training step parity, trainable vs dense (24 layers, "
          f"{tuple(ids['dense'].shape)}, bf16 autocast): "
          + ", ".join(f"{n} {a:.5f} vs {b:.5f} (rel {rel[n]:.2e})"
                      for n, a, b in zip(names, got["trainable"],
                                         got["dense"]))
          + f"; tol {TRAIN_LOSS_TOL} (losses), {GRAD_NORM_TOL} (grad norm)")
    bad = [n for n in names
           if rel[n] > (GRAD_NORM_TOL if n == "grad_norm" else TRAIN_LOSS_TOL)]
    if bad:
        raise AssertionError(f"trainable vs dense differ in {bad}: {rel}")


def phase_slice(torch, np, inference_t2i, cuda_build, config, prompts,
                route, smi):
    """The 512x512 pipeline on ``route``: launch counts over one generate
    call, output checks, warm wall time.  Returns (pipeline, launches)."""
    t0 = time.perf_counter()
    pipe = inference_t2i.build_pipeline(config, device=torch.device("cuda"),
                                        attn_impl=route)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = pipe.cfg
    if not (pipe.attn_route == route and cfg.llm.num_layers == NUM_LAYERS
            and cfg.llm.hidden_size == 2048 and cfg.num_vq_tokens == 1024):
        raise AssertionError(f"not the full-width 512x512 path on {route}: "
                             f"{pipe.attn_route}, {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                       # warm-up
    want = {name: 0 for name, _ in KERNELS.values()}
    want.update({name: 0 for name in TRAIN_KERNELS})
    want[KERNELS[route][0]] = NUM_LAYERS * TIMESTEPS

    cuda_build.launches.clear()
    images = pipe.generate(prompts, gen)
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{route}: kernel launches in one generate "
                             f"call {counts}, want {want}")
    if images.shape != (BATCH, 512, 512, 3) or not np.isfinite(images).all():
        raise AssertionError(f"{route}: images {images.shape} or non-finite")
    if images.min() < -1.0 or images.max() > 1.0:
        raise AssertionError(f"{route}: images outside [-1, 1]")

    walls = []
    for _ in range(3):
        before = dict(cuda_build.launches)
        t0 = time.perf_counter()
        pipe.generate(prompts, gen)
        walls.append(time.perf_counter() - t0)
        if {n: cuda_build.launches[n] - before.get(n, 0)
                for n in want} != want:
            raise AssertionError(f"{route}: launch counts changed")
    codes = pipe.generate_codes(prompts, gen)
    if not (int(codes.min()) >= 0 and int(codes.max()) < cfg.codebook_size
            and tuple(codes.shape) == (BATCH, 1024)):
        raise AssertionError(f"{route}: codes out of range "
                             f"{tuple(codes.shape)}")
    wall = statistics.median(walls)
    print(f"[4] slice t2i 512x512 route {route}, {TIMESTEPS} steps, CFG "
          f"1.75, batch {BATCH}, bf16, random weights (setup {setup_s:.1f} "
          f"s): launches per generate {counts[KERNELS[route][0]]} = "
          f"{NUM_LAYERS} x {TIMESTEPS} of {KERNELS[route][0]}, 0 of the "
          f"others; images {images.shape} finite in [-1, 1]; warm wall "
          f"{wall:.4f} s/batch (median of 3: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{BATCH * 60.0 / wall:.2f} images/min on {smi}")
    return pipe, counts[KERNELS[route][0]]


def phase_step_parity(torch, pipe, prompts, device):
    """One full-width cached step per kernel route against dense masked
    attention, on the same weights and inputs (half the image tokens
    known)."""
    from showo_tpu_torch.models.phi import KVCache
    from showo_tpu_torch.ops.flash_attention import metadata_predict_next
    from showo_tpu_torch.ops.masks import omni_mask_predict_next

    cfg, sp = pipe.cfg, pipe.uni_prompting.sptids
    full = _t2i_layout(pipe.uni_prompting, prompts, cfg.num_vq_tokens,
                       cfg.mask_token_id, device)
    B, L = full.shape
    g = torch.Generator(device=device).manual_seed(5)
    known = torch.rand(B, cfg.num_vq_tokens, generator=g, device=device) < 0.5
    codes = torch.randint(0, cfg.codebook_size, (B, cfg.num_vq_tokens),
                          generator=g, device=device) + cfg.codebook_offset
    full[:, P + 1:L - 1] = torch.where(known, codes, full[:, P + 1:L - 1])
    ids = (sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"])
    bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
    meta = metadata_predict_next(full, *ids)
    phi = pipe.model.showo
    emb = phi.model.embed_tokens.weight
    cache = KVCache.zeros(cfg.llm, B, L, dtype=emb.dtype, device=device)
    head = (1, 1 + cfg.num_vq_tokens, cfg.codebook_offset,
            cfg.codebook_offset + cfg.codebook_size)
    step = dict(input_ids=full[:, P:], attention_bias=bias[:, :, P:],
                cache=cache, lm_head_slice=head, static_prefix_len=P)
    with torch.no_grad():
        phi(input_ids=full[:, :P], attention_bias=bias[:, :, :P], cache=cache)
        dense, _ = phi(attn_meta=None, **step)
        for route in KERNELS:
            kern, _ = phi(attn_meta=(route,) + meta, **step)
            diff = (kern.float() - dense.float()).abs().max().item()
            scale = dense.float().abs().max().item()
            agree = (kern.argmax(-1) == dense.argmax(-1)).float().mean().item()
            print(f"[5] step parity route {route} (24 layers, B={B}, "
                  f"Q={L - P}, bf16): max abs logit diff vs dense "
                  f"{diff:.4e} (tol {STEP_TOL}; max |logit| {scale:.3f}; "
                  f"argmax agreement {agree:.4f})")
            if not diff <= STEP_TOL:
                raise AssertionError(f"{route}: step logits differ by {diff}"
                                     f" > {STEP_TOL}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from showo_tpu_torch import inference_t2i
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.profile_train import stage1_batch, stage1_config
    from showo_tpu_torch.training.train_showo import build_trainer

    device = torch.device("cuda")

    # [1] device
    smi = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] device: {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | TF32 off (matmul and cuDNN) for the "
          f"parity phases")

    # [2] build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = [name for name, _ in KERNELS.values()] + [TRAIN_SOURCE]
    cuda_build.load_libraries(names)
    print(f"[2] build: {len(names)} sources with nvcc (sm_90a) in parallel, "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        info = cuda_build.build_info[name]
        regs = [ln.split(":", 1)[-1].strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln] or [info["log"]]
        print(f"[2]   csrc/{name}.cu {info['seconds']:.2f} s; ptxas: "
              f"{' | '.join(regs)}")

    # [3] kernel vs plain
    config = load_config("configs/showo_demo_512x512.yaml",
                         ["guidance_scale=1.75",
                          f"generation_timesteps={TIMESTEPS}"])
    prompts = inference_t2i.load_prompts(config)[:BATCH]
    results = phase_kernels(torch, inference_t2i.build_prompting(config),
                            prompts, inference_t2i.build_showo_config(config),
                            device)

    # [4] the slice through the CLI's build_pipeline, once per route
    launches, pipe = {}, None
    for route in KERNELS:
        pipe = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe, launches[route] = phase_slice(
            torch, np, inference_t2i, cuda_build, config, prompts, route, smi)

    # [5] step parity, every route, on the last pipeline's weights
    phase_step_parity(torch, pipe, prompts, device)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()

    # the training phases: cuDNN convolutions (the frozen MAGVIT encoder)
    # back on PyTorch's default TF32; matmuls stay full fp32 (the dense
    # route's fp32 scores, the plain versions)
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    trainer = build_trainer(stage1_config(), device, attn_impl="trainable")
    batch, noise = stage1_batch(trainer)
    prepared = trainer.step_fn.prepare(*trainer.host_batch(*batch),
                                       noise=noise)
    torch.cuda.synchronize()
    lc = trainer.cfg.llm
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and lc.num_heads == H and tuple(prepared.input_ids.shape)
            == (29, 387) and trainer.tc.remat == "full"):
        raise AssertionError(f"not the full-width stage-1 trainer: {lc}, "
                             f"{tuple(prepared.input_ids.shape)}")
    print(f"[6] trainer built from configs/showo_pretraining_stage1.yaml "
          f"(warmup 0) in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in trainer.model.parameters())} trainable "
          f"parameters, fused batch {tuple(prepared.input_ids.shape)}")

    # [6] the trainable kernels vs plain, on the fused batch's metadata
    train_results = phase_train_kernels(torch, prepared.attn_meta[1:])
    prepared = None

    # [7] the training slice through build_trainer / train_step
    train_launches = phase_train(torch, cuda_build, trainer, batch, noise,
                                 smi)

    # [8] trainable vs dense, one full-width step
    phase_train_parity(torch, trainer, batch, noise)

    kernels = []
    for route, (name, replaces) in KERNELS.items():
        r512, r256 = results[route]["512"], results[route].get("256")
        entry = {"name": name, "route": "cuda",
                 "source": f"showo_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces, "launches": launches[route], **r512}
        if r256 is not None:
            entry.update({f"{key}_256": val for key, val in r256.items()})
        kernels.append(entry)
    for name, (replaces, _) in TRAIN_KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{TRAIN_SOURCE}.cu",
                        "replaces": replaces,
                        "launches": train_launches[name],
                        **train_results[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
