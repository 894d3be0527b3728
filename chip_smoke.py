#!/usr/bin/env python3
"""Smoke run of the PyTorch port (showo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives five paths of Show-o 1.3B at full width (Phi-1.5: 24 layers,
hidden 2048, 32 heads; random weights from fixed seeds):

* the v1 512x512 text-to-image path (the ``t2i_512`` bench row) with the
  full MAGVIT-v2 decoder, bf16, 16-step prefix-cached MaskGIT with CFG
  1.75, batch 2, through the CLI's ``build_pipeline``, once on each
  attention route with an inference kernel: ``packed`` (the default at
  512x512), ``omni``, ``decode``, ``fused`` and ``streaming``;
* the v1 stage-1 trainer (``configs/showo_pretraining_stage1.yaml``,
  warmup 0) through ``build_trainer`` on the ``trainable`` route: the
  frozen full MAGVIT-v2 encoder, 15 t2i + 4 lm + 10 mmu rows of 387
  tokens at 256x256, AdamW, clip 1.0, remat "full", bf16 autocast over
  fp32 master weights, a seeded in-memory batch;
* the v1 512x512 trainer (``configs/showo_instruction_tuning_1_512x512
  .yaml``, warmup 0) the same way: 5 t2i + 2 lm + 5 mmu rows of 1408
  tokens at 512x512, no clipping; past the packed trainable budget, so
  every layer takes the K-blocked trainable kernels (kernel 8);
* v1 multimodal understanding (``configs/showo_demo.yaml``, 256x256, the
  full MAGVIT-v2 encoder, bf16) through ``inference_mmu.build_pipeline``:
  one image, one question, 100 greedy tokens over the KV cache, with bf16
  weights and with weight-only int8 (``int8=1``: every matmul of Phi on
  the int8 kernel);
* the CLIP-ViT understanding path (``configs/showo_demo_w_clip_vit.yaml``:
  CLIP-L/14-336 features projected into the prompt), int8;
* Show-o2 1.5B text-to-image at 432x432 (``configs/showo2_1.5b_demo_432x432
  .yaml``: Qwen2.5-1.5B, 28 layers, 12 q / 2 kv heads of 128; the SigLIP
  tower, 26 layers; the DiT head, 10 layers, 32 q / 8 kv heads of 64; the
  Wan2.1 VAE decoder in fp32) through ``inference_t2i_v2.build_pipeline``:
  50-point Euler, CFG 7.5, batch 4 (8 rows with the null prompts), bf16,
  the packed route (kernel 1 at head dims 128 and 64).

Phases, one or more lines each:

  1. device: card name and power limit, torch / CUDA versions; TF32 off
  2. build: nvcc builds the ten kernel sources of csrc/, in parallel, and
     ptxas' registers and spills of each entry function with its template
     arguments (the forward core <head dim, mask, split> at <64, 0> and
     <128, 0> (the -inf mask: kernels 5, 7, 8), <64, 1> and <128, 1> (the
     -1e30 mask: kernels 1 and 4), <64, 1, true> (kernel 2: K / V from
     two sources, keys at positions), <64, 2> (the bias: kernel 3), and
     kernel 6's <64, 1, false, W> for W = 1..4 and <128, 1, false, W> for
     W = 1, 2 (W warpgroups, one q head each); kernel 2's norm_rope_kernel;
     the decode gemv <nibbles, aligned, rows>), and "wgmma serialized"
     where ptxas warned C7515
  3. kernel vs plain: each inference kernel at the cached step's shapes
     (B=4, P=129, H=32, D=64, bf16, metadata of a left-padded t2i
     layout), all on the wgmma forward core, each on the tile map its
     forward makes once, which must equal its plain version byte for
     byte: the packed kernel (kernel 1) at 512x512 and one GQA case;
     omni, decode, fused and streaming at 512x512 (Q=1026, K=1155) and
     256x256 (Q=258, K=387), streaming also with GQA; omni (kernel 4) and
     streaming (kernel 5) beside kernel 1 on the same memory, their
     outputs' max difference (omni: 0, the same function through the same
     core); fused (kernel 2) as a whole and as its two launches, the
     LayerNorm + RoPE pass (within 2 bf16 ulps of each head row's peak)
     and the core over [cache | fresh] keys at their positions, with
     ``scaled_dot_product_attention`` on the normed q / k under the same
     mask as the core's yardstick; decode (kernel 3, under the bias) on
     the bias's tile map; max abs error, median times (CUDA events) of
     kernel, plain version and one library call of the same function,
     and the bound
  4. the t2i slice, per route: over one generate call the route's kernel
     launches 24 layers x 16 steps times, all on the wgmma core, reading
     16 tile maps (one a forward: of the metadata on ``packed``,
     ``omni``, ``streaming``, of kernel 2's keys on ``fused``, of the
     bias on ``decode``), on ``fused`` each launch after its LayerNorm +
     RoPE pass (384), and every other kernel none; codes in the
     codebook; images finite, NHWC, in [-1, 1]; warm seconds per batch
     and images/min
  5. step parity, per route: one full-width cached step with the route's
     kernel and with dense attention under the additive mask, max abs
     logit difference
  6. trainable kernels (kernel 7) vs plain: forward (out, lse), dq and
     dk/dv at the stage-1 shape (B=29, S=387, H=32, D=64, bf16, metadata
     of the trainer's fused batch), a GQA case and a ragged S=200 with
     rows that see no key; kernel 7 runs the wgmma cores (the forward on
     csrc/attention_fwd_sm90.cuh, dq and dk/dv on
     csrc/attention_grad_sm90.cuh) after its tile map, which must equal its
     plain version byte for byte, each giving the same bits over two
     launches; errors, median times of kernel, plain version and
     ``scaled_dot_product_attention`` with the boolean mask (forward,
     backward, forward + backward), and the bounds; then the same checks
     on two faults planted in the plain versions (V of the wrong kv head,
     one K tile dropped), each of which must fail them
  7. the stage-1 training slice: the first step, then TRAIN_STEPS steps
     on the same batch with every launch count set to 0 before them: per
     step 48 forward launches (24 layers + 24 recomputed by remat), 24 dq,
     24 dk/dv and 48 tile maps (each forward makes one, its backward reads
     it again), none of the other kernels; losses finite and falling;
     median step time, samples/s, peak device memory
  8. stage-1 training step parity: one full-width step's losses and grad
     norm on ``trainable`` against ``dense``, same weights, batch and
     draws
  6b. kernel 8 vs plain as phase 6, on head-major views of [B, S, H, D]
     tensors (phi's layout) at the 512x512 fused batch (B=12, S=1408),
     a GQA case and the ragged case, with the same planted faults; the
     count of the batch's rows that see no key; kernel 8 runs the same
     wgmma cores as kernel 7 after its tile map, checked as there; then at
     the same shape (past kernel 7's budget), on the same memory, kernel
     7's cores beside kernel 8, times of the two sets
  7b. the 512x512 training slice as phase 7: 48 / 24 / 24 / 48 launches of
     kernel 8's forward, dq, dk/dv and tile map per step (the forward makes
     the map, the backward reads it again), none of kernel 7 or of the
     inference kernels; the step beside the last recorded one
  8b. the 512x512 training step parity as phase 8
  9. the weight-streaming matmuls (kernels 9-11) vs plain: int8 at the
     understanding slice's win / wout / lm_head shapes at decode (M=1) and
     at the prefill's rows (267), win at the CLIP-ViT prefill's 609 rows,
     a ragged M=65 at lm_head's N=58498, int8 and int4 at the probes' [8,
     2048] x [2048, 8192], and int4 at win's M=267 and M=609, the ragged
     lm_head M=65 and win / wout / lm_head at M=1; error within 2e-2 of
     the output's peak and a
     planted fault (each column scaled by its neighbour's scale) that must
     fail it; median CUDA-event times of kernel, plain version,
     torch.matmul on dequantized bf16 weights (the library) and the eager
     dequantize + matmul, the same without the host (profiler device
     time), the bound; the core that ran (the decode gemv at M=1, the
     source's prefill kernel above M=4), the same bits on two calls, the
     device launches a product (one for the gemv); above M=4 the first mma
     kernel checked and timed beside the prefill kernel on the same inputs
  10. the discrete understanding slice, bf16 then int8 weights: per answer
     the int8 kernel launches 49 x 101 times with int8 (24 win + 24 wout +
     lm_head, prefill and 100 decode forwards: 49 on the prefill kernel,
     4900 on the gemv) and never with bf16, every
     other kernel none; tokens in the vocabulary; prompt, prefill and
     decode times, tokens/s against the weight-streaming bound, peak
     memory, device idle share over one answer (profiler), device busy per
     token and the gemv's device launches and time per token; then the two
     pipelines' answers in turns
  11. prefill logits with int8, bf16 and fp32 weights on the same seeded
     model: int8 vs fp32 within the JAX package's int8 limits (top-1
     agreement >= 0.95, max abs difference / peak < 0.05), the other
     pairs read beside it
  10b. the CLIP-ViT path with int8 weights as phase 10, after the CLIP
     tower's features (576 x 1024, timed)
  3c. kernels 1 and 6 at the Show-o2 432x432 slice's shapes: B=8 rows, S
     the slice's truncated sequence, its span metadata; Qwen2.5 (12 q / 2
     kv heads, D=128) and the DiT (32 / 8, D=64), kernel 1 on the wgmma
     core of csrc/attention_fwd_sm90.cuh at both (every launch counted
     there), after its tile map, which must equal its plain version byte
     for byte; kernel 6 (the same core, its q heads of a kv head sharing
     each K / V tile, every launch counted there) beside kernel 1 on the
     same inputs and map, their outputs' max difference (0: each head's
     arithmetic is kernel 1's); the fault of V read from the neighbouring
     kv head planted in each plain version must fail the check; median
     times of kernel, plain version and scaled_dot_product_attention with
     the boolean mask, the device time a launch of each (profiler), and
     the bound; then kernel 1 at both head dims on a ragged S=200 whose
     rows 6..9 see no key (they must average v over the S keys), the same
     bits over two launches
  12. the Show-o2 slice: over one generate call kernel 1 launches 38 x 49
     times (28 Qwen + 10 DiT layers, 49 velocity evaluations), all on the
     wgmma core, all reading one tile map made with the generate's
     metadata; every other kernel (kernel 6 among them) none;
     images finite, NHWC, in [-1, 1]; warm seconds per batch, images/min,
     peak device memory
  13. one full-width velocity evaluation on the packed route against
     dense attention under the additive mask: the same weights (the
     zero-initialised adaLN and final projections drawn N(0, 0.02) so that
     the velocity depends on the towers), latents and t; max |dv| over the
     dense velocity's peak

Then a JSON line of kernel results, the nvidia-smi name/power line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero with no result line; without CUDA it exits 2.
"""

from __future__ import annotations

import contextlib
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
# the same at 512x512 (phase 8b, S=1408): after phase 7b's five steps on
# one batch the mmu loss is down to ~0.8, so the same absolute bf16 noise
# (1.5e-3, against 2.6e-4 at stage 1) is a larger share of it; read on an
# H100 at 700 W: losses 7.8e-6 to 1.9e-3 (loss_mmu), grad norm 1.2e-3
TRAIN512_LOSS_TOL, TRAIN512_GRAD_NORM_TOL = 1e-2, 1e-2
NUM_LAYERS, TIMESTEPS, BATCH = 24, 16, 2
P, H, D = 129, 32, 64            # text prefix rows, heads, head dim
TRAIN_STEPS = 4
# H100 SXM peaks (NVIDIA data sheet): device memory rate, dense bf16 rate,
# fp32 outside the tensor cores
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12
FP32_OPS_PER_S = 67e12

# route -> (kernel source name, the TPU kernel it replaces)
KERNELS = {
    "packed": ("omni_attention_packed",
               "showo_tpu/ops/flash_attention.py:232"),
    "omni": ("omni_attention", "showo_tpu/ops/flash_attention.py:87"),
    "decode": ("decode_attention", "showo_tpu/ops/decode_attention.py:69"),
    "fused": ("fused_decode", "showo_tpu/ops/fused_decode.py:114"),
    "streaming": ("streaming_attention",
                  "showo_tpu/ops/streaming_attention.py:116"),
}
# the trainable route's kernels, three and a tile map per source: counter
# name -> (the Pallas kernel it replaces, launches per training step; remat
# "full" runs each layer's forward twice, and each forward makes its map).
# Kernel 7 takes the stage-1 rows (S=387), kernel 8 the 512x512 rows
# (S=1408, past the packed budget); both run the wgmma cores.
TRAIN_SOURCE = "packed_attention_grad"
TRAIN_KERNELS = {
    "packed_attention_grad_fwd": (
        "showo_tpu/ops/packed_attention_grad.py:56", 2 * NUM_LAYERS),
    "packed_attention_grad_dq": (
        "showo_tpu/ops/packed_attention_grad.py:97", NUM_LAYERS),
    "packed_attention_grad_dkv": (
        "showo_tpu/ops/packed_attention_grad.py:138", NUM_LAYERS),
    # the Pallas kernels' mask (_mask, computed per block in each of them)
    "packed_attention_grad_tiles": (
        "showo_tpu/ops/packed_attention_grad.py:43", 2 * NUM_LAYERS),
}
STREAM_TRAIN_SOURCE = "streaming_attention_grad"
STREAM_TRAIN_KERNELS = {
    "streaming_attention_grad_fwd": (
        "showo_tpu/ops/streaming_attention_grad.py:56", 2 * NUM_LAYERS),
    "streaming_attention_grad_dq": (
        "showo_tpu/ops/streaming_attention_grad.py:104", NUM_LAYERS),
    "streaming_attention_grad_dkv": (
        "showo_tpu/ops/streaming_attention_grad.py:142", NUM_LAYERS),
    # the tile map, made by each forward and read again by its backward:
    # the Pallas kernels' block skip (_visible and jnp.any in _fwd_kernel,
    # _dq_kernel and _dkv_kernel, called from _fwd and _bwd)
    "streaming_attention_grad_tiles": (
        "showo_tpu/ops/streaming_attention_grad.py:282", 2 * NUM_LAYERS),
}
# the 512x512 step with the first forward kernel of kernel 8 (PERF.md §5,
# H100 80GB HBM3 at 700 W), printed beside phase 7b's
STEP512_BEFORE = "0.94-0.95 s"
# the weight-streaming matmuls (kernels 9-11), one source each: counter
# name -> the Pallas kernels it replaces
WSMM_KERNELS = {
    "int8_matmul": "tools/probe_int8_decode.py:64 (kernel 9); "
                   "tools/probe_pallas_wsmm.py:66 (kernel 11a)",
    "int4_matmul": "tools/probe_int4_decode.py:79 (kernel 10); "
                   "tools/probe_pallas_wsmm.py:123 (kernel 11b)",
}
# each source's prefill kernel (M > 4, aligned rows:
# csrc/weight_stream_prefill.cuh), which replaced its first mma kernel there
PREFILL_KERNEL = "int8_matmul_prefill"
INT4_PREFILL_KERNEL = "int4_matmul_prefill"
# the per-core counters of the weight-streaming sources
WSMM_CORES = ["int8_matmul_gemv", "int8_matmul_mma", PREFILL_KERNEL,
              "int4_matmul_gemv", "int4_matmul_mma", INT4_PREFILL_KERNEL]
# kernel 6, the GQA-stacked packed attention: on no model path (the JAX
# package reaches it only through omni_attention_packed(gqa_stack=True))
GQA_SOURCE, GQA_REPLACES = ("omni_attention_gqa_stacked",
                            "showo_tpu/ops/flash_attention.py:338")
# its launches on the wgmma forward core (all of them), and the tile maps it
# makes when not given one
GQA_WGMMA, GQA_TILES = f"{GQA_SOURCE}_wgmma", f"{GQA_SOURCE}_tiles"
# kernel 1's launches on the wgmma forward core (all of them, at head dims
# 64 and 128), also counted under omni_attention_packed, and its tile map
# (the Pallas kernel's mask, computed per block from the metadata)
PACKED_WGMMA = "omni_attention_packed_wgmma"
PACKED_TILES = "omni_attention_packed_tiles"
# the tile maps of kernels 4 and 5 (kernel 1's kind, of the metadata), 2
# (of its keys at their positions) and 3 (of the bias), one a forward:
# route -> counter
ROUTE_TILES = {"packed": PACKED_TILES, "omni": "omni_attention_tiles",
               "fused": "fused_decode_tiles",
               "streaming": "streaming_attention_tiles",
               "decode": "decode_attention_tiles"}
# kernel 2's LayerNorm + RoPE pass, one before each launch of its core
FUSED_NORM = "fused_decode_norm_rope"
# every launch counter of the port's kernels
COUNTERS = ([name for name, _ in KERNELS.values()] + list(TRAIN_KERNELS)
            + list(STREAM_TRAIN_KERNELS) + list(WSMM_KERNELS) + WSMM_CORES
            + [GQA_SOURCE, GQA_WGMMA, GQA_TILES, PACKED_WGMMA, FUSED_NORM,
               *ROUTE_TILES.values()])
# the understanding slice: greedy answers of MMU_NEW_TOKENS tokens, one
# prefill and MMU_NEW_TOKENS decode forwards, each with 24 win + 24 wout +
# the lm_head matmul
MMU_NEW_TOKENS = 100
MMU_MATMULS = 2 * NUM_LAYERS + 1
# the CLIP-ViT path's prompt rows (phase 10b), a phase 9 case
CLIP_PREFILL_ROWS = 609
MMU_QUESTION = "What is in this image?"
MMU_IMAGE = "assets/validation/test_image.png"
WSMM_TOL = 2e-2      # kernel vs plain, max abs error over the output's peak
L2_BYTES = 50e6      # H100 L2: timed weights rotate through twice this
# int8 prefill logits at full width against the unquantized fp32 model: the
# limits of the JAX package's tests/test_int8_decode.py (whose reference is
# the fp32 model too)
INT8_AGREE, INT8_REL = 0.95, 0.05
# the Show-o2 slice: 28 Qwen2.5 + 10 DiT layers, each one kernel 1 launch
# per velocity evaluation, 49 evaluations (50-point Euler)
V2_CONFIG = "configs/showo2_1.5b_demo_432x432.yaml"
V2_QWEN_LAYERS, V2_LAYERS, V2_EVALS, V2_BATCH = 28, 28 + 10, 49, 4
# (label, q heads, kv heads, head dim) of kernels 1 and 6 on the slice
V2_SHAPES = (("Qwen2.5 12/2 D=128", 12, 2, 128), ("DiT 32/8 D=64", 32, 8, 64))
# packed vs dense, one full-width v2 velocity evaluation: max |dv| over the
# dense velocity's peak (phase 13).  The routes round P to bf16 at
# different points through 38 layers; read on an H100 at 700 W: 2.47e-2
# unguided (1.92e-1 with CFG 7.5, which multiplies the difference of the
# two halves by 7.5), 4x above the reading
V2_STEP_TOL = 1e-1


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ptxas(log: str) -> list:
    """ptxas' registers and spills of each entry function of an nvcc log,
    as 'kernel<template args>: N registers, S bytes spill stores, L bytes
    spill loads', and where ptxas serialized its wgmma instructions
    (warning C7515) 'wgmma serialized'."""
    import re

    serialized = set(re.findall(r"C7515\).*in the function '([^']+)'", log))
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # mangled template arguments: Li64E an int, Lb1E a bool
            k = re.search(r"([a-z_]*kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            args = [v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           k.group(2) or "")] if k else []
            name = m.group(1) if k is None else k.group(1) + (
                f"<{', '.join(args)}>" if args else "")
            out.append([name] + (["wgmma serialized (ptxas C7515)"]
                                 if m.group(1) in serialized else []))
        elif name is not None and ("spill" in line or "registers" in line):
            out[-1].append(line.split(":", 1)[-1].strip().split(",")[0]
                           if "registers" in line else
                           line.strip().split(", ", 1)[-1])
    return [f"{o[0]}: " + "; ".join(o[1:]) for o in out]


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


def _device_ms(torch, fn, iters: int = 20, attempts: int = 3, counts=None):
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler: without the host's wrapper and launch time, which the
    CUDA-event times of :func:`_time_ms` include.  Every call launches at
    least one kernel, so a trace with fewer device events than calls lost
    some of them (seen on an H100 in runs that had traced a training step
    before): it is taken again, up to ``attempts`` times, and said so;
    then None (not measured).  ``counts``, a list, gets the device launches
    per call of the trace that was kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == cuda]
        if len(kernels) >= iters:
            us = sum(e.time_range.end - e.time_range.start for e in kernels)
            if counts is not None:
                counts.append(len(kernels) / iters)
            return us / 1e3 / iters
        print(f"[profiler] {len(kernels)} device events for {iters} calls: "
              f"some were lost; profiling again")
    print(f"[profiler] device events lost in {attempts} traces: not measured")
    return None


def _ms(x) -> str:
    """A time for the log: 'not measured' for None."""
    return "not measured" if x is None else f"{x:.4f} ms"


def _ratio(a, b) -> str:
    return "not measured" if a is None or b is None else f"{a / b:.2f}x"


def _rate(nbytes, ms) -> str:
    return "not measured" if ms is None else f"{nbytes / ms / 1e6:.0f} GB/s"


def _bound(bytes_moved: float, flops: float,
           rate: float = BF16_FLOPS_PER_S) -> dict:
    """The least time of the work on an H100: the larger of its bytes over
    the memory rate and its operations over their peak ``rate`` (the bf16
    tensor-core rate unless given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
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
    from showo_tpu_torch.ops import streaming_attention as tsa
    from showo_tpu_torch.ops.masks import omni_mask_predict_next

    sp = uni.sptids
    ids = (sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"])
    hidden = H * D
    out = {route: {} for route in (*KERNELS, "fused_norm")}
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
            # kernel 1 on the wgmma core, on the tile map its forward makes
            # once (models/phi.py attn_step)
            nt = (-(-Q // 64), -(-L // 64))
            tiles, out["tiles"] = _map_check(
                torch, f"kernel 1's tile map {shape} [{B}, {nt[0]}, "
                f"{nt[1] + 1}]", lambda: tfa.rows_tile_map(*meta, pos_q,
                                                           seg_q),
                lambda: tfa.rows_tile_map_plain(*meta, pos_q),
                meta_bytes + B * nt[0] * (nt[1] + 1),
                B * nt[0] * nt[1] * 64 ** 2, 3, flag=True)
            for hkv in (H, H // 4):
                q, k, v = randn(B, Q, H * D), randn(B, L, hkv * D), randn(
                    B, L, hkv * D)
                heads = [t.unflatten(-1, (-1, D)).transpose(1, 2)
                         for t in (q, k, v)]
                kernel1 = (lambda: tfa.omni_attention_packed(
                    q, k, v, *meta, num_heads=H, num_kv_heads=hkv,
                    q_positions=pos_q, seg_q=seg_q, tiles=tiles))
                r = _compare(
                    torch, f"omni_attention_packed {shape} Hkv={hkv}",
                    kernel1,
                    lambda: tfa.omni_attention_packed_plain(
                        q, k, v, *meta, pos_q, num_heads=H,
                        num_kv_heads=hkv, sm_scale=D ** -0.5),
                    _bound(2 * (2 * B * Q * H + 2 * B * L * hkv) * D
                           + meta_bytes, flops),
                    sdpa(*heads, enable_gqa=hkv != H))
                out["packed"].setdefault(res, r)

        # omni (kernel 4, the wgmma core): transposed [B, S, H, D] views,
        # as phi's omni route passes them, on the tile map of kernel 1's
        # kind its forward makes once (models/phi.py attn_step)
        nt = (-(-Q // 64), -(-L // 64))
        map_bytes = B * nt[0] * (nt[1] + 1)
        tiles4, r_map = _map_check(
            torch, f"kernel 4's tile map {shape} [{B}, {nt[0]}, "
            f"{nt[1] + 1}]", lambda: tfa.omni_tile_map(*meta, pos_q, seg_q),
            lambda: tfa.rows_tile_map_plain(*meta, pos_q),
            meta_bytes + map_bytes, B * nt[0] * nt[1] * 64 ** 2, 3,
            flag=True)
        out.setdefault("omni_tiles", r_map)
        q, k, v = (randn(B, n, H, D).transpose(1, 2) for n in (Q, L, L))
        qkv_bytes = 2 * (2 * B * Q * H + 2 * B * L * H) * D
        kernel4 = (lambda: tfa.omni_attention(
            q, k, v, *meta, q_positions=pos_q, seg_q=seg_q, tiles=tiles4))
        r = out["omni"][res] = _compare(
            torch, f"omni_attention {shape}", kernel4,
            lambda: tfa.omni_attention_plain(q, k, v, *meta, pos_q,
                                             sm_scale=D ** -0.5),
            _bound(qkv_bytes + meta_bytes, flops), sdpa(q, k, v))
        if res == "512":
            # kernel 1 on the same memory: [B, S, H, D] is [B, S, H*D]
            packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
            kernel1 = (lambda: tfa.omni_attention_packed(
                *packed, *meta, num_heads=H, q_positions=pos_q,
                seg_q=seg_q, tiles=tiles))
            diff = (kernel4().transpose(1, 2).flatten(2).float()
                    - kernel1().float()).abs().max().item()
            r["kernel1_ms"], r["kernel1_diff"] = _time_ms(torch, kernel1), diff
            print(f"[3] {shape}: kernel 4 {r['ms']:.4f} ms beside kernel 1 "
                  f"on the same memory {r['kernel1_ms']:.4f} ms (median of "
                  f"20); outputs max |difference| {diff:.3e} (0 expected: "
                  f"one function through one core; tol {CARD_TOL:.0e})")
            if not diff <= CARD_TOL:
                raise AssertionError(f"kernel 4 and kernel 1 differ by "
                                     f"{diff}")

        # streaming (kernel 5, the wgmma core): the same views, on the tile
        # map of kernel 1's kind its forward makes once (models/phi.py
        # attn_step); every fresh row of the t2i layout sees its own key,
        # so the library call has no empty row
        tiles5, r_map = _map_check(
            torch, f"kernel 5's tile map {shape} [{B}, {nt[0]}, "
            f"{nt[1] + 1}]", lambda: tsa.streaming_tile_map(*meta, pos_q,
                                                            seg_q),
            lambda: tfa.rows_tile_map_plain(*meta, pos_q),
            meta_bytes + map_bytes, B * nt[0] * nt[1] * 64 ** 2, 3,
            flag=True)
        out.setdefault("streaming_tiles", r_map)
        for hkv in (H, H // 4) if res == "512" else (H,):
            q, k, v = (randn(B, n, h, D).transpose(1, 2)
                       for n, h in ((Q, H), (L, hkv), (L, hkv)))
            kernel5 = (lambda: tsa.omni_attention_streaming(
                q, k, v, *meta, q_positions=pos_q, seg_q=seg_q,
                tiles=tiles5))
            r = _compare(
                torch, f"omni_attention_streaming {shape} Hkv={hkv}",
                kernel5,
                lambda: tsa.omni_attention_streaming_plain(
                    q, k, v, *meta, pos_q, sm_scale=D ** -0.5),
                _bound(2 * (2 * B * Q * H + 2 * B * L * hkv) * D
                       + meta_bytes, flops),
                sdpa(q, k, v, enable_gqa=hkv != H))
            if res == "512":
                # kernel 1 on the same memory: [B, S, H, D] is [B, S, H*D]
                packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
                kernel1 = (lambda: tfa.omni_attention_packed(
                    *packed, *meta, num_heads=H, num_kv_heads=hkv,
                    q_positions=pos_q, seg_q=seg_q, tiles=tiles))
                diff = (kernel5().transpose(1, 2).flatten(2).float()
                        - kernel1().float()).abs().max().item()
                r["kernel1_ms"], r["kernel1_diff"] = (
                    _time_ms(torch, kernel1), diff)
                print(f"[3] {shape} Hkv={hkv}: kernel 5 {r['ms']:.4f} ms "
                      f"beside kernel 1 on the same memory "
                      f"{r['kernel1_ms']:.4f} ms (median of 20); outputs "
                      f"max |difference| {diff:.3e} (tol {CARD_TOL:.0e})")
                if not diff <= CARD_TOL:
                    raise AssertionError(f"kernel 5 and kernel 1 differ by "
                                         f"{diff}")
            out["streaming"].setdefault(res, r)

        # decode (kernel 3, the wgmma core under the bias): the bias as the
        # cached step's strided view of the mask, on its tile map, made
        # once per forward (models/phi.py); the library call takes the bias
        # cast to bf16 (the query's type)
        bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
        bias = bias[:, :, P:, :]
        tiles3, r_map = _map_check(
            torch, f"kernel 3's bias tile map {shape} (row stride {L}) "
            f"[{B}, {nt[0]}, {nt[1] + 1}]", lambda: tda.bias_tile_map(bias),
            lambda: tda.bias_tile_map_plain(bias), 4 * B * Q * L + map_bytes,
            B * Q * L, 3, flag=True)
        out.setdefault("decode_tiles", r_map)
        q, k, v = (randn(B, n, H, D) for n in (Q, L, L))
        out["decode"][res] = _compare(
            torch, f"decode_attention {shape} (bias view, row stride {L})",
            lambda: tda.decode_attention(q, k, v, bias, tiles=tiles3),
            lambda: tda.decode_attention_plain(q, k, v, bias),
            _bound(qkv_bytes + 4 * B * Q * L,
                   4 * D * H * int((bias == 0).sum())),
            sdpa(*(t.transpose(1, 2) for t in (q, k, v)),
                 m=bias.to(torch.bfloat16)))

        # fused (kernel 2): y a full-width win output, ck/cv views of a
        # cache; the LayerNorm + RoPE pass, then the core over [cache |
        # fresh] keys at pos_k on the map of those keys its forward makes
        # once (models/phi.py attn_step)
        y = randn(B, Q, 3 * hidden + cfg.llm.intermediate_size)
        cache = randn(2, B, L, H, D)
        ln = [(1 + 0.1 * torch.randn(D, generator=g, device=device))
              .bfloat16(), (0.1 * torch.randn(D, generator=g, device=device))
              .bfloat16()]
        cos, sin = rope_tables(pos, 32, cfg.llm.rope_theta)
        ck, cv = cache[0, :, :P].flatten(2), cache[1, :, :P].flatten(2)
        args = (y, ck, cv, ln, ln, cos, sin)
        kw = dict(hidden=hidden, num_heads=H, rotary_dim=32, eps=1e-5)
        tiles2, r_map = _map_check(
            torch, f"kernel 2's tile map {shape} (keys at pos_k) [{B}, "
            f"{nt[0]}, {nt[1] + 1}]",
            lambda: tfd.fused_tile_map(rows, meta[2], meta[3]),
            lambda: tfa.rows_tile_map_plain(
                rows[3], rows[4], meta[2], meta[3], rows[0], pos_k=rows[2],
                seg_q=rows[1]),
            meta_bytes + 4 * L + map_bytes, B * nt[0] * nt[1] * 64 ** 2, 3,
            flag=True)
        out.setdefault("fused_tiles", r_map)
        # bytes of the function: y's q/k/v columns, the prefix K/V, out,
        # cos/sin, norms; of the pass: y's q/k columns read, qn / kn
        # written; of the core: qn / kn, y's v columns, the prefix K/V,
        # out; operations: the attention products (LayerNorm and RoPE add
        # ~1%)
        io = 2 * B * Q * hidden
        small = 2 * Q * 32 * 4 + 4 * D * 2
        whole = _compare(
            torch, f"fused_decode_attention {shape} (y row stride "
            f"{y.shape[-1]}), both launches",
            lambda: tfd.fused_decode_attention(*args, *meta, pos, rows=rows,
                                               tiles=tiles2, **kw),
            lambda: tfd.fused_decode_attention_plain(
                *args, meta[2], meta[3], rows, sm_scale=D ** -0.5,
                softmax_dtype=torch.float32, **kw),
            _bound(4 * io + 2 * 2 * B * P * hidden + small + meta_bytes,
                   flops))
        qn, kn = tfd.norm_rope(y, ln, ln, cos, sin, **kw)
        norm = out["fused_norm"][res] = _norm_rope_check(
            torch, shape, lambda: tfd.norm_rope(y, ln, ln, cos, sin, **kw),
            lambda: tfd.norm_rope_plain(y, ln, ln, cos, sin, **kw),
            _bound(4 * io + small, 0))
        part = dict(hidden=hidden, num_heads=H)
        keys = [torch.cat([ck, kn], 1),
                torch.cat([cv, y[..., 2 * hidden:3 * hidden]], 1)]
        vis2 = tfa.visible_mask(rows[3], rows[4], meta[2], meta[3], rows[0],
                                pos_k=rows[2], seg_q=rows[1])
        r = out["fused"][res] = _compare(
            torch, f"fused_decode core {shape} (keys at pos_k, split at "
            f"P={P})",
            lambda: tfd.fused_attend(qn, kn, y, ck, cv, meta[2], meta[3],
                                     rows, tiles2, **part),
            lambda: tfd.fused_attend_plain(qn, kn, y, ck, cv, meta[2],
                                           meta[3], rows, sm_scale=D ** -0.5,
                                           **part),
            _bound(3 * io + 2 * 2 * B * P * hidden + meta_bytes + 4 * L,
                   flops),
            sdpa(*(t.unflatten(-1, (H, D)).transpose(1, 2)
                   for t in [qn] + keys), m=vis2[:, None]))
        r["whole"] = whole
        print(f"[3] {shape}: kernel 2 {whole['ms']:.4f} ms (both launches) "
              f"= the pass {norm['ms']:.4f} ms + the core {r['ms']:.4f} ms "
              f"(library on the core's part {_ms(r['library_ms'])}); bound "
              f"{whole['bound_ms']:.4f} ms ({whole['bound_by']}), of the "
              f"two launches {norm['bound_ms'] + r['bound_ms']:.4f} ms")
    return out


def _norm_rope_check(torch, shape, kern, plain, bound):
    """Kernel 2's LayerNorm + RoPE pass against its plain twin: every value
    within 2 bf16 ulps of its head row's peak (a normed value is rounded
    to bf16 and the kernel's rsqrt is the card's approximate one, so a
    value may move by an ulp, and a roped value that cancels by an ulp of
    its terms), timed as :func:`_compare` times; no library call does
    LayerNorm + RoPE."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ulps = abs_err = 0.0
    for g, w in zip(got, want):
        if not (torch.isfinite(g).all() and g.is_contiguous()):
            raise AssertionError(f"{shape}: the LN + RoPE pass's output is "
                                 f"not finite or not contiguous")
        peak = w.float().unflatten(-1, (-1, D)).abs().amax(-1, keepdim=True)
        ulp = torch.exp2(torch.floor(torch.log2(peak.clamp_min(2.0 ** -100)))
                         - 7)
        d = (g.float() - w.float()).unflatten(-1, (-1, D)).abs()
        ulps = max(ulps, (d / ulp).max().item())
        abs_err = max(abs_err, d.max().item())
    if not ulps <= 2:
        raise AssertionError(f"{shape}: the LN + RoPE pass differs from its "
                             f"plain twin by {ulps} ulps of a head row's peak")
    ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
    print(f"[3] {shape}: kernel 2's LN + RoPE pass: max {ulps:.2f} bf16 ulps "
          f"of a head row's peak (max abs {abs_err:.3e}; limit 2 ulps), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20); "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
          f"{_rate(bound['bound_ms'] * HBM_BYTES_PER_S / 1e3, ms)}")
    return {"max_abs_err": abs_err, "max_ulps": ulps, "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": None}


def _ragged_meta(torch, device, B=4, S=200):
    """Metadata with an image span, left pads and last_pad = 5, so rows
    6..9 see no key (all their columns are pads they may not see)."""
    seg = torch.zeros((B, S), dtype=torch.int32, device=device)
    seg[:, 40:150] = 1
    pad = torch.zeros_like(seg)
    pad[:, :10] = 1
    last_pad = torch.full((B,), 5, dtype=torch.int32, device=device)
    return seg, pad, last_pad, torch.zeros_like(last_pad)


def _planted_faults(shape, plain, v, wrong_v, m, phase):
    """The trainable kernels' checks on two faults planted in their plain
    versions, as a kernel would make them: V read from the neighbouring kv
    head (``wrong_v``), and keys 64..127 (the second K tile) dropped for
    every row past last_pad (they are marked as pads).  ``plain`` maps
    forward, dq and dk/dv to (fn(v, metadata), grads).  Each faulty result
    is held to the correct plain result by :func:`_check`; each must fail
    it, or the check could not tell such a kernel from a right one."""
    pad = m[1].clone()
    pad[:, 64:128] = 1
    faults = {"V of the wrong kv head": (wrong_v, m),
              "K tile 64..127 dropped": (v, (m[0], pad, *m[2:]))}
    readings = []
    for fault, (v_f, m_f) in faults.items():
        for name, (fn, grads) in plain.items():
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
    print(f"[{phase}] {shape}: planted faults, each failing the check: "
          + "; ".join(readings))


def _kernel_set(torch, kernel, hkv):
    """The wrappers, plain versions, tile map (counter, kernel, plain) and
    layout of one trainable kernel set with ``hkv`` kv heads: kernel 7 on
    the packed [B, S, n*D] layout, or kernel 8 on head-major views of
    [B, S, n, D] tensors (phi's layout)."""
    import functools

    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    if kernel == 7:
        kw = dict(num_heads=H, num_kv_heads=hkv, sm_scale=D ** -0.5)
        fns = (tpag.packed_trainable_fwd, tpag.packed_trainable_dq,
               tpag.packed_trainable_dkv, tpag.packed_trainable_fwd_plain,
               tpag.packed_trainable_dq_plain, tpag.packed_trainable_dkv_plain)
        ks = dict(
            counters=list(TRAIN_KERNELS)[:3], lse_empty=tpag.LSE_EMPTY,
            tiles=(tpag.TILES_KERNEL, tpag.tile_map, tpag.tile_map_plain),
            tensor=lambda g, B, S, n: torch.randn(
                B, S, n * D, generator=g, device="cuda").bfloat16(),
            heads=lambda t: t.unflatten(-1, (-1, D)).transpose(1, 2),
            delta=lambda out, dout: tpag.attention_delta(out, dout, H),
            wrong_v=lambda v: v.view(*v.shape[:2], hkv, D).roll(
                1, dims=2).reshape(v.shape))
    else:
        kw = dict(sm_scale=D ** -0.5)
        fns = (tsag.streaming_trainable_fwd, tsag.streaming_trainable_dq,
               tsag.streaming_trainable_dkv, tsag.trainable_fwd_plain,
               tsag.trainable_dq_plain, tsag.trainable_dkv_plain)
        ks = dict(
            counters=list(STREAM_TRAIN_KERNELS)[:3], lse_empty=tsag.LSE_EMPTY,
            tiles=(tsag.TILES_KERNEL, tsag.tile_map, tsag.tile_map_plain),
            tensor=lambda g, B, S, n: torch.randn(
                B, S, n, D, generator=g, device="cuda").bfloat16()
            .transpose(1, 2),
            heads=lambda t: t, delta=tsag.attention_delta,
            wrong_v=lambda v: v.roll(1, dims=1))
    ks.update({name: functools.partial(fn, **kw) for name, fn in zip(
        ("fwd", "dq", "dkv", "fwd_plain", "dq_plain", "dkv_plain"), fns)})
    return ks


def phase_train_kernels(torch, meta, kernel, label, phase):
    """A trainable kernel set (kernel 7 or 8) against its plain versions at
    a training step's shape (``meta``, the metadata of the trainer's fused
    batch), a GQA case and a ragged S with rows that see no key: its tile
    map against the plain one, the forward, dq and dk/dv on that map and
    bit-stable over two launches; then the planted faults.  At the step's
    shape kernel 8 is timed beside kernel 7's cores on the same memory
    (past kernel 7's budget).  Returns {counter name: result} of the first
    case."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(6 if kernel == 7 else 8)
    cases = [(label, meta, H), (f"{label} GQA", meta, H // 4),
             ("ragged, rows with no visible key",
              _ragged_meta(torch, device), H)]
    results = {}
    for case, m, hkv in cases:
        ks = _kernel_set(torch, kernel, hkv)
        B, S = m[0].shape
        vis = tsag.self_visible(*m)
        empty = int((~vis.any(-1)).sum())
        n_vis = int(vis.sum())
        shape = f"{case}: B={B} S={S} H={H} Hkv={hkv} D={D}"
        if case == label:
            print(f"[{phase}] the {label} fused batch {(B, S)}: {empty} rows "
                  f"that see no key; {n_vis} visible (row, key) pairs of "
                  f"{B * S * S} ({n_vis / (B * S * S):.4f})")
        q, k, v, dout = (ks["tensor"](g, B, S, n) for n in (H, hkv, hkv, H))
        # the kernels read a tile map, made once per forward
        tiles, tiles_result = _tile_map_check(torch, ks, m, shape, phase)
        bwd = {"tiles": tiles}
        out, lse = ks["fwd"](q, k, v, *m, **bwd)
        lse_err = (lse - ks["fwd_plain"](q, k, v, *m)[1]).abs().max().item()
        if not lse_err <= CARD_TOL or (
                (lse == ks["lse_empty"]).sum() != empty * H):
            raise AssertionError(f"{shape}: lse err {lse_err} or rows with "
                                 f"no visible key not marked")
        delta = ks["delta"](out, dout)
        args = (q, k, v, dout, lse, delta, *m)
        _bit_stable(torch, ks, args, tiles, shape, phase)
        # bytes: each input read once and each output written once;
        # operations: 2*D per visible pair, head and product (forward 2
        # products, dq 3, dk/dv 4)
        tensor = 2 * B * S * D
        meta_bytes = 4 * (2 * B * S + 2 * B)
        rows_bytes = 4 * B * H * S
        lib = {}
        if case == label and not empty:
            heads = [ks["heads"](t).detach().requires_grad_(True)
                     for t in (q, k, v)]
            dout4 = ks["heads"](dout)
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
            print(f"[{phase}] {shape}: scaled_dot_product_attention with the "
                  f"boolean mask, forward + backward {fb:.4f} ms (median "
                  f"of 20)")
        bounds = {
            "fwd": _bound((2 * H + 2 * hkv) * tensor + rows_bytes
                          + meta_bytes, 4 * D * H * n_vis),
            "dq": _bound((3 * H + 2 * hkv) * tensor + 2 * rows_bytes
                         + meta_bytes, 6 * D * H * n_vis),
            "dkv": _bound((2 * H + 4 * hkv) * tensor + 2 * rows_bytes
                          + meta_bytes, 8 * D * H * n_vis)}

        def compare(part):
            what = {"fwd": "forward", "dq": "dq", "dkv": "dk/dv"}[part]
            call = ((lambda: ks["fwd"](q, k, v, *m, **bwd)[0])
                    if part == "fwd" else (lambda: ks[part](*args, **bwd)))
            plain = ((lambda: ks["fwd_plain"](q, k, v, *m)[0])
                     if part == "fwd" else (lambda: ks[f"{part}_plain"](
                         *args)))
            return _compare(
                torch, f"trainable {what} {shape}", call, plain,
                bounds[part], lib.get("fwd" if part == "fwd" else "bwd"),
                phase=phase, grads=part != "fwd")

        r = {name: compare(part)
             for name, part in zip(ks["counters"], ("fwd", "dq", "dkv"))}
        r[ks["tiles"][0]] = tiles_result
        lib = heads = o4 = None
        print(f"[{phase}] {shape}: lse max_abs_err {lse_err:.3e}; {empty} "
              f"rows with no visible key (out 0, lse {ks['lse_empty']:g} in "
              f"every head); library call of dq and dk/dv: one backward of "
              f"scaled_dot_product_attention (dq, dk, dv together)")
        _planted_faults(shape, {
            "forward": (lambda v_, m_: ks["fwd_plain"](q, k, v_, *m_)[0],
                        False),
            "dq": (lambda v_, m_: ks["dq_plain"](q, k, v_, *args[3:6], *m_),
                   True),
            "dk/dv": (lambda v_, m_: ks["dkv_plain"](q, k, v_, *args[3:6],
                                                     *m_), True),
        }, v, ks["wrong_v"](v), m, phase)
        if kernel == 8 and case == label:
            _kernel7_beside_kernel8(torch, q, k, v, dout, m, hkv, phase)
        results.setdefault(case, r)
    return results[label]


def _tile_map_check(torch, ks, m, shape, phase):
    """A kernel set's tile map of metadata ``m`` against its plain version;
    returns (the map, its result)."""
    B, S = m[0].shape
    nt = -(-S // 64)
    _, make, plain = ks["tiles"]
    return _map_check(
        torch, f"{shape}: tile map [{B}, {nt}, {nt}]", lambda: make(*m),
        lambda: plain(*m), 4 * (2 * B * S + 2 * B) + B * nt * nt,
        B * (nt * 64) ** 2, phase)


def _map_check(torch, label, make, plain, nbytes, pairs, phase,
               flag=False):
    """A tile map kernel (``make``) against its plain version, byte for
    byte, timed; ``flag``: the map's last column flags q tiles with a row
    that sees no key.  Bound: ``nbytes`` (the metadata read once, the map
    written once) or the predicate's ~8 integer operations per (row, key)
    pair of the padded tiles (``pairs``) at the rate of the CUDA cores (no
    tensor-core type applies).  Returns (the map, its result)."""
    tiles, want = make(), plain()
    torch.cuda.synchronize()
    if not torch.equal(tiles, want):
        raise AssertionError(f"{label}: differs from its plain version in "
                             f"{int((tiles != want).sum())} entries")
    cls = tiles[..., :-1] if flag else tiles
    classes = [int((cls == c).sum()) for c in (0, 1, 3)]
    bound = _bound(nbytes, 8 * pairs, FP32_OPS_PER_S)
    ms, plain_ms = _time_ms(torch, make), _time_ms(torch, plain)
    flags = (f", q tiles with a row that sees no key "
             f"{int(tiles[..., -1].sum())}" if flag else "")
    print(f"[{phase}] {label} equal to its plain version; pairs of 64-row "
          f"tiles skipped / masked / all visible {classes[0]} / {classes[1]}"
          f" / {classes[2]}{flags}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 20); bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']})")
    return tiles, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   **bound, "library_ms": None, "tile_classes": classes}


def _bit_stable(torch, ks, args, tiles, shape, phase):
    """A kernel set's forward, dq and dk/dv give the same bits over two
    launches on one tile map (no atomics, a fixed order of the sums)."""
    q, k, v, m = *args[:3], args[6:]
    runs = [(*ks["fwd"](q, k, v, *m, tiles=tiles),
             ks["dq"](*args, tiles=tiles), *ks["dkv"](*args, tiles=tiles))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{shape}: out / lse / dq / dk / dv differ "
                             f"over two launches")
    print(f"[{phase}] {shape}: out, lse, dq, dk and dv bit-identical over "
          f"two launches on one tile map")


def _kernel7_beside_kernel8(torch, q, k, v, dout, m, hkv, phase):
    """Kernel 7 (the packed trainable kernels, past their TPU budget here)
    on the same memory as kernel 8's head-major views: its wgmma cores
    beside kernel 8's (the same cores on other strides).  Each kernel timed
    (CUDA events; on a tile map made once), and each autograd Function
    (forward + backward, which makes its own map); their forward outputs
    must agree within CARD_TOL."""
    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    k7, k8 = _kernel_set(torch, 7, hkv), _kernel_set(torch, 8, hkv)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v, dout)]
    times, outs = {}, []
    for name, ks, (q_, k_, v_, d_), fn, kw in (
            ("kernel 7", k7, packed, lambda *t: tpag.PackedTrainableAttention
             .apply(*t, *m, H, hkv, D ** -0.5), {"tiles": tpag.tile_map(*m)}),
            ("kernel 8", k8, (q, k, v, dout), lambda *t: tsag
             .StreamingTrainableAttention.apply(*t, *m, D ** -0.5),
             {"tiles": tsag.tile_map(*m)})):
        out, lse = ks["fwd"](q_, k_, v_, *m, **kw)
        outs.append(out if ks is k7 else out.transpose(1, 2).flatten(2))
        a = (q_, k_, v_, d_, lse, ks["delta"](out, d_), *m)
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        times[name] = [
            _time_ms(torch, lambda: ks["fwd"](q_, k_, v_, *m, **kw)),
            _time_ms(torch, lambda: ks["dq"](*a, **kw)),
            _time_ms(torch, lambda: ks["dkv"](*a, **kw)),
            _time_ms(torch, lambda: torch.autograd.grad(fn(*leaves), leaves,
                                                        d_))]
    diff = (outs[0].float() - outs[1].float()).abs().max().item()
    print(f"[{phase}] the same shape and memory (kernel 7 is past its TPU "
          f"budget here; nothing routes by this): "
          + "; ".join(f"{name} forward {t[0]:.4f}, dq {t[1]:.4f}, dk/dv "
                      f"{t[2]:.4f}, autograd Function forward + backward "
                      f"{t[3]:.4f} ms" for name, t in times.items())
          + f" (medians of 20); forward outputs max |difference| {diff:.3e}")
    if not diff <= CARD_TOL:
        raise AssertionError(f"kernel 7's and kernel 8's forwards differ by "
                             f"{diff} > {CARD_TOL}")


def phase_train(torch, cuda_build, trainer, batch, noise, smi, label,
                kernels, phase):
    """A training slice: one step, then TRAIN_STEPS steps on the same
    batch and draws with the launch counts set to 0 before them; the
    trainable route's ``kernels`` launch their counts per step, every other
    kernel none."""
    m = trainer.train_step(*batch, noise=noise)
    losses = [float(m["loss"])]
    want = {name: 0 for name in COUNTERS}
    want.update({name: n * TRAIN_STEPS for name, (_, n) in kernels.items()})
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
    before = (f" (last recorded before this backward: {STEP512_BEFORE})"
              if label == "512x512" else "")
    print(f"[{phase}] training slice {label}, route trainable, {rows} rows "
          f"x {tokens} tokens, bf16 autocast, remat "
          f"{trainer.tc.remat}, clip {trainer.tc.max_grad_norm}: launches "
          f"per step {_per_step(counts)}, 0 of the other kernels; losses "
          f"{[round(x, 4) for x in losses]}; "
          f"last step t2i {last['loss_t2i']:.4f} lm {last['loss_lm']:.4f} "
          f"mmu {last['loss_mmu']:.4f} grad_norm {last['grad_norm']:.4f}; "
          f"step {wall:.4f} s{before} (median of {TRAIN_STEPS}: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{rows / wall:.2f} samples/s, peak memory allocated "
          f"{peak:.2f} GiB on {smi}")
    return {name: counts[name] for name in kernels}


def _per_step(counts) -> dict:
    return {n: c // TRAIN_STEPS for n, c in counts.items() if c}


def phase_train_parity(torch, trainer, batch, noise, phase, loss_tol,
                       norm_tol):
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
    print(f"[{phase}] training step parity, trainable vs dense (24 layers, "
          f"{tuple(ids['dense'].shape)}, bf16 autocast): "
          + ", ".join(f"{n} {a:.5f} vs {b:.5f} (rel {rel[n]:.2e})"
                      for n, a, b in zip(names, got["trainable"],
                                         got["dense"]))
          + f"; tol {loss_tol} (losses), {norm_tol} (grad norm)")
    bad = [n for n in names
           if rel[n] > (norm_tol if n == "grad_norm" else loss_tol)]
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
    want = {name: 0 for name in COUNTERS}
    want[KERNELS[route][0]] = NUM_LAYERS * TIMESTEPS
    if route == "packed":
        # every launch on the wgmma core
        want[PACKED_WGMMA] = NUM_LAYERS * TIMESTEPS
    if route in ROUTE_TILES:
        want[ROUTE_TILES[route]] = TIMESTEPS        # one tile map a forward
    if route == "fused":
        want[FUSED_NORM] = NUM_LAYERS * TIMESTEPS   # a pass before each core

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
    core = (f" (all on the wgmma core, reading "
            f"{counts[ROUTE_TILES[route]]} tile maps, one a forward"
            + (f", each after its LN + RoPE pass ({counts[FUSED_NORM]})"
               if route == "fused" else "") + ")")
    print(f"[4] slice t2i 512x512 route {route}, {TIMESTEPS} steps, CFG "
          f"1.75, batch {BATCH}, bf16, random weights (setup {setup_s:.1f} "
          f"s): launches per generate {counts[KERNELS[route][0]]} = "
          f"{NUM_LAYERS} x {TIMESTEPS} of {KERNELS[route][0]}{core}, 0 of "
          f"the others; images {images.shape} finite in [-1, 1]; warm wall "
          f"{wall:.4f} s/batch (median of 3: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{BATCH * 60.0 / wall:.2f} images/min on {smi}")
    return pipe, {n: c for n, c in counts.items() if c}


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


def _trainer(torch, build_trainer, train_batch, config, path, rows, phase):
    """A full-width trainer on the ``trainable`` route, its seeded batch
    and draws, and the attention metadata of its fused batch (checked to
    be ``rows`` = (rows, tokens))."""
    t0 = time.perf_counter()
    trainer = build_trainer(config, torch.device("cuda"),
                            attn_impl="trainable")
    batch, noise = train_batch(trainer)
    prepared = trainer.step_fn.prepare(*trainer.host_batch(*batch),
                                       noise=noise)
    torch.cuda.synchronize()
    lc = trainer.cfg.llm
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and lc.num_heads == H and tuple(prepared.input_ids.shape) == rows
            and trainer.tc.remat == "full"):
        raise AssertionError(f"not the full-width trainer of {path}: {lc}, "
                             f"{tuple(prepared.input_ids.shape)}")
    print(f"[{phase}] trainer built from {path} (warmup 0) in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in trainer.model.parameters())} trainable "
          f"parameters, fused batch {tuple(prepared.input_ids.shape)}, "
          f"clip {trainer.tc.max_grad_norm}")
    return trainer, batch, noise, prepared.attn_meta[1:]


def _rotation(copies):
    """A callable that returns the next of ``copies`` in turn."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return nxt


@contextlib.contextmanager
def _first_mma_kernel():
    """The int8 / int4 wrapper with the first mma kernel in the prefill
    kernel's place (its core choice patched), for measurements beside it
    on the same inputs."""
    from showo_tpu_torch.ops import int8_matmul as ti8

    choose = ti8.WeightStream.core
    ti8.WeightStream.core = lambda self, x: (
        "mma" if choose(self, x) == "prefill" else choose(self, x))
    try:
        yield
    finally:
        ti8.WeightStream.core = choose


def _wsmm_case(torch, cuda_build, label, M, K, N, int4, seed):
    """One weight-streaming product against its plain version: the error
    (max abs over the plain output's peak), a planted fault (each column
    scaled by its neighbour's scale) that must fail the same check, median
    times of kernel, plain version, ``torch.matmul`` on dequantized bf16
    weights (the library) and the eager dequantize-then-matmul, and the
    bound.  The weights rotate through copies that exceed the L2 twice, as
    the layers of a decode step do (each reads other weights).  The core
    of :func:`select_core` must be the one that ran (the gemv at decode
    rows, the source's prefill kernel above), two calls must give the same
    bits (split-K), and the device launches a product are read from the
    trace.  Above the decode rows the first mma kernel
    (:func:`_first_mma_kernel`) is checked and timed beside the prefill
    kernel on the same inputs."""
    from showo_tpu_torch.ops import int4_matmul as ti4
    from showo_tpu_torch.ops import int8_matmul as ti8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = K // 2 if int4 else K
    padded = -(-N // 16) * 16            # Int8Linear's 16-byte row padding
    n_copies = max(1, -(-int(2 * L2_BYTES) // (rows * N)))
    ws = [torch.randint(-128 if int4 else -127, 128, (rows, padded),
                        generator=g, device=dev, dtype=torch.int8)[:, :N]
          for _ in range(n_copies)]
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    s = (torch.rand(1, N, generator=g, device=dev) * 0.01 + 1e-3).bfloat16()
    if int4:
        kern, plain = ti4.pallas_nib_matmul, ti4.nib_matmul_plain
        widen = lambda w: torch.cat(ti4.unpack_nibbles(w)).to(torch.bfloat16)
    else:
        kern, plain = ti8.pallas_i8_matmul, ti8.i8_matmul_plain
        widen = lambda w: w.to(torch.bfloat16)
    prefill = M > ti8.GEMV_MAX_M
    source = "int4_matmul" if int4 else "int8_matmul"
    want_runs = {f"{source}_prefill": int(prefill),
                 f"{source}_gemv": int(not prefill)}
    before = {n: cuda_build.launches[n] for n in want_runs}
    got, want = kern(x, ws[0], s), plain(x, ws[0], s)
    again = kern(x, ws[0], s)
    torch.cuda.synchronize()
    runs = {n: (cuda_build.launches[n] - before[n]) // 2 for n in want_runs}
    if runs != want_runs:
        raise AssertionError(f"{label}: cores that ran a call {runs}, want "
                             f"{want_runs}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel output not finite")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = (ti8.prefill_plan(M, rows, N, sms) if prefill
            else ti8.gemv_plan(rows, N, sms))
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls of the "
                             f"{'prefill' if prefill else 'gemv'} kernel "
                             f"(splits {plan.splits}) differ")
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    extra = {"plan": dict(plan._asdict()), "bit_stable": True}
    del again
    if prefill:
        with _first_mma_kernel():
            old = kern(x, ws[0], s)
        torch.cuda.synchronize()
        extra["old_max_abs_err"] = (old.float() - want.float()).abs().max(
            ).item()
        del old
    fault = (plain(x, ws[0], s.roll(1, dims=-1)).float()
             - want.float()).abs().max().item()
    tol = WSMM_TOL * peak
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs plain max abs error {err} "
                             f"> {tol} ({WSMM_TOL} of the peak {peak})")
    if not fault > tol:
        raise AssertionError(f"{label}: planted fault (the neighbouring "
                             f"column's scale) passes the check: {fault} <= "
                             f"{tol}")
    del got, want
    wn = _rotation(ws)
    deq = [widen(w) * s for w in ws[:max(1, -(-n_copies // 2))]]
    dn = _rotation(deq)
    calls = {"kernel": lambda: kern(x, wn(), s),
             "plain": lambda: plain(x, wn(), s),
             "library": lambda: torch.matmul(x, dn()),
             "eager": lambda: x @ (widen(wn()) * s)}
    if prefill:
        def old():
            with _first_mma_kernel():
                return kern(x, wn(), s)
        calls["old"] = old
    t = {k: _time_ms(torch, fn) for k, fn in calls.items()}
    per_call = []
    dev_t = {k: _device_ms(torch, calls[k],
                           counts=per_call if k == "kernel" else None)
             for k in calls if k != "plain"}
    extra["device_launches"] = per_call[0] if per_call else None
    ms, plain_ms, lib_ms, eager_ms = (t[k] for k in list(calls)[:4])
    if prefill:
        extra.update({"old_ms": t["old"], "old_device_ms": dev_t["old"]})
        old_line = (f"; the first mma kernel on the same inputs: max_abs_err "
                    f"{extra['old_max_abs_err']:.3e}, {t['old']:.4f} ms, "
                    f"device {_ms(dev_t['old'])} ("
                    f"{_ratio(dev_t['old'], dev_t['kernel'])} the prefill "
                    f"kernel's); plan: {plan.m_tiles} x {plan.n_tiles} "
                    f"tiles of {plan.bm} x {ti8.PF_BN}, {plan.splits} K "
                    f"splits of "
                    f"{plan.k_tiles_per_split} tiles (bit-stable over two "
                    f"calls)")
    else:
        old_line = (f"; the gemv's plan: {plan.tiles} column tiles of "
                    f"{16 * plan.cw} bytes x {plan.splits} K ranges of "
                    f"{plan.rows_per_split} rows (bit-stable over two "
                    f"calls)")
    del deq
    weight_bytes = rows * N
    bound = _bound(weight_bytes + 2 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
    print(f"[9] {label} {'int4' if int4 else 'int8'} x [{M}, {K}] @ w "
          f"[{rows}, {N}]: max_abs_err {err:.3e} (tol {WSMM_TOL} of the "
          f"peak {peak:.3f}); planted fault (neighbouring column's scale) "
          f"{fault:.3e} fails it; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library torch.matmul on dequantized bf16 "
          f"{lib_ms:.4f} ms, eager dequantize + matmul {eager_ms:.4f} ms "
          f"(CUDA-event medians of 20, wrapper included; {n_copies} weight "
          f"copies in turn); device time alone (profiler, mean of 20): "
          f"kernel {_ms(dev_t['kernel'])} ("
          f"{_rate(weight_bytes, dev_t['kernel'])} of weights), library "
          f"{_ms(dev_t['library'])}, eager {_ms(dev_t['eager'])}; bound "
          f"{bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), {_ratio(bound['bound_ms'], dev_t['kernel'])}"
          f" of it; device launches a product "
          f"{extra['device_launches']}{old_line}")
    return {"max_abs_err": err, "peak": peak, "ms": ms, "plain_ms": plain_ms,
            **bound, "library_ms": lib_ms, "eager_dequant_ms": eager_ms,
            "device_ms": dev_t["kernel"],
            "library_device_ms": dev_t["library"],
            "eager_dequant_device_ms": dev_t["eager"], **extra}


def phase_wsmm(torch, cuda_build, prefill_rows):
    """Kernels 9-11 at the understanding slice's shapes: int8 ``win``,
    ``wout`` and ``lm_head`` at decode (M=1) and at the prefill's rows,
    ``win`` at the CLIP-ViT prefill's rows, a ragged M=65 at ``lm_head``'s
    N, and both kernels at the probes' [8, 2048] x [2048, 8192]; int4 also
    at ``win``'s prefill and CLIP-ViT rows, the ragged ``lm_head`` M=65,
    and ``win``, ``wout`` and ``lm_head`` at decode (M=1).  Returns
    {counter: {case: result}}; the cases above M=4 also under their
    source's prefill counter."""
    shapes = {"win": (2048, 14336), "wout": (10240, 2048),
              "lm_head": (2048, 58498)}
    cases = [(name, M, K, N) for name, (K, N) in shapes.items()
             for M in (1, prefill_rows)]
    cases += [("win", CLIP_PREFILL_ROWS, *shapes["win"]),
              ("lm_head", 65, *shapes["lm_head"]), ("probe", 8, 2048, 8192)]
    int4_cases = [("probe", 8, 2048, 8192),
                  ("win", prefill_rows, *shapes["win"]),
                  ("win", CLIP_PREFILL_ROWS, *shapes["win"]),
                  ("lm_head", 65, *shapes["lm_head"])]
    int4_cases += [(name, 1, K, N) for name, (K, N) in shapes.items()]
    out = {"int8_matmul": {}, "int4_matmul": {}, PREFILL_KERNEL: {},
           INT4_PREFILL_KERNEL: {}}
    for int4, source, prefill, seed0, todo in (
            (False, "int8_matmul", PREFILL_KERNEL, 91, cases),
            (True, "int4_matmul", INT4_PREFILL_KERNEL, 99, int4_cases)):
        for seed, (name, M, K, N) in enumerate(todo, start=seed0):
            label = f"{name} M={M}"
            out[source][label] = _wsmm_case(
                torch, cuda_build, label, M, K, N, int4, seed)
            if M > 4:
                out[prefill][label] = out[source][label]
    return out


def _mmu_image(size):
    from PIL import Image

    from showo_tpu_torch.utils.image import image_transform

    return image_transform(Image.open(MMU_IMAGE).convert("RGB"), size)


def _prefill(torch, phi, prompt):
    """One prefill forward of ``prompt`` ((ids or embeddings, bias)) by
    Phi ``phi`` into a fresh cache of an answer's capacity (prompt +
    MMU_NEW_TOKENS), as showo_mmu_generate runs it; returns the logits."""
    import torch.nn.functional as F

    from showo_tpu_torch.models.phi import KVCache

    first, bias = prompt
    S = first.shape[1]
    cap = S + MMU_NEW_TOKENS
    emb = phi.model.embed_tokens.weight
    cache = KVCache.zeros(phi.cfg, 1, cap, dtype=emb.dtype,
                          device=emb.device)
    bias = F.pad(bias, (0, cap - S), value=-1e9)
    key = "input_ids" if first.dtype == torch.int64 else "input_embeds"
    with torch.no_grad():
        return phi(attention_bias=bias, cache=cache, **{key: first})[0]


def _wall_ms(torch, fn, n=5):
    """Median host ms of ``fn`` over n calls, each ending in a sync."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def phase_mmu(torch, cuda_build, profile, pipe, label, answer, prompt,
              int8, smi, phase):
    """One understanding pipeline at full width: launches over one greedy
    answer (int8: 49 x 101 of the int8 kernel, every other kernel none;
    bf16: none at all), tokens in the vocabulary, prompt / prefill / answer
    times, decode ms per token against the weight-streaming bound, peak
    memory, and the device's idle share over one answer."""
    from torch import nn

    from showo_tpu_torch.models.phi import Int8Linear

    phi = pipe.model.showo
    lc = phi.cfg
    linear = Int8Linear if int8 else nn.Linear
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and lc.vocab_size == 58498 and pipe.max_new_tokens ==
            MMU_NEW_TOKENS and pipe.top_k == 1
            and all(isinstance(m, linear) for layer in phi.model.layers
                    for m in (layer.win, layer.wout))
            and isinstance(phi.lm_head, linear)):
        raise AssertionError(f"{label}: not the full-width fused Phi with "
                             f"{linear.__name__} matmuls: {lc}")
    answer()                                             # warm-up
    want = {name: 0 for name in COUNTERS}
    if int8:
        # every matmul of the prefill on the prefill kernel, of the decode
        # forwards on the gemv
        want["int8_matmul"] = MMU_MATMULS * (1 + MMU_NEW_TOKENS)
        want[PREFILL_KERNEL] = MMU_MATMULS
        want["int8_matmul_gemv"] = MMU_MATMULS * MMU_NEW_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    toks = answer()
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{label}: launches in one answer {counts}, "
                             f"want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(0 <= t < lc.vocab_size for t in toks):
        raise AssertionError(f"{label}: tokens outside the vocabulary")
    prompt_ms = _wall_ms(torch, prompt)
    rows = prompt()[0].shape[1]
    prefill_ms = _wall_ms(torch, lambda: _prefill(torch, phi, prompt()))
    answer_ms = _wall_ms(torch, answer, n=3)
    decode_ms = (answer_ms - prompt_ms - prefill_ms) / MMU_NEW_TOKENS
    weight_bytes = sum(m.kernel_i8.numel() if int8 else 2 * m.weight.numel()
                       for m in [phi.lm_head] + [
                           w for layer in phi.model.layers
                           for w in (layer.win, layer.wout)])
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prof = profile(answer, f"[{phase}] {label}: one answer,")
    kernel_prefill = _prefill_kernels(torch, phi, prompt()) if int8 else {}
    # the decode gemv's device launches and time per token, from the trace
    gemv = [row for name, row in prof["by_kernel"].items()
            if "gemv_kernel" in name]
    gemv_launches = sum(n for n, _ in gemv) / MMU_NEW_TOKENS
    gemv_ms = sum(ms for _, ms in gemv) / MMU_NEW_TOKENS
    print(f"[{phase}] {label}: {rows} prompt rows, greedy, {MMU_NEW_TOKENS} "
          f"new tokens ({len(toks)} before the first eot), launches per "
          f"answer {counts.get('int8_matmul', 0)} of int8_matmul = "
          f"{MMU_MATMULS} x {1 + MMU_NEW_TOKENS} ({counts[PREFILL_KERNEL]} on "
          f"the prefill kernel, {counts['int8_matmul_gemv']} on the gemv), 0 "
          f"of the others; prompt "
          f"{prompt_ms:.2f} ms, prefill {prefill_ms:.2f} ms, answer "
          f"{answer_ms:.2f} ms (first {first_wall * 1e3:.2f}; medians of "
          f"5 / 5 / 3), decode {decode_ms:.4f} ms per token = "
          f"{1e3 / decode_ms:.2f} tokens/s against a bound of "
          f"{bound_ms:.4f} ms ({weight_bytes / 1e9:.3f} GB of matmul weights"
          f" per token over 3.35 TB/s); device idle share over one answer "
          f"{prof['idle_share']:.4f} ({prof['launches']} kernel launches), "
          f"device busy {prof['busy_ms'] / MMU_NEW_TOKENS:.4f} ms per "
          f"token, of which the decode gemv {gemv_launches:.2f} device "
          f"launches and {gemv_ms:.4f} ms per token; peak memory "
          f"allocated {peak:.2f} GiB on {smi}")
    if int8:
        k = kernel_prefill
        print(f"[{phase}] {label}: the prefill forward alone ({rows} rows, "
              f"prompt made once): device {_ms(k['device_ms'])} with the "
              f"prefill kernel, {_ms(k['old_device_ms'])} with the first "
              f"mma kernel in its place (profiler, mean of 5); wall "
              f"{k['wall_ms']:.2f} vs {k['old_wall_ms']:.2f} ms (medians of "
              f"5)")
    return {"rows": rows, "prompt_ms": prompt_ms, "prefill_ms": prefill_ms,
            **{f"prefill_{key}": val for key, val in kernel_prefill.items()},
            "answer_ms": answer_ms, "decode_ms_per_token": decode_ms,
            "tokens_per_s": 1e3 / decode_ms, "bound_ms_per_token": bound_ms,
            "idle_share": prof["idle_share"], "peak_gib": peak,
            "busy_ms_per_token": prof["busy_ms"] / MMU_NEW_TOKENS,
            "gemv_device_launches_per_token": gemv_launches,
            "gemv_device_ms_per_token": gemv_ms,
            "launches": counts.get("int8_matmul", 0),
            "prefill_launches": counts[PREFILL_KERNEL]}


def _prefill_kernels(torch, phi, prompt):
    """Device and wall ms of one int8 prefill forward of ``prompt`` with
    the prefill kernel, then with the first mma kernel in its place."""
    def run():
        _prefill(torch, phi, prompt)

    out = {"device_ms": _device_ms(torch, run, iters=5),
           "wall_ms": _wall_ms(torch, run)}
    with _first_mma_kernel():
        out.update(old_device_ms=_device_ms(torch, run, iters=5),
                   old_wall_ms=_wall_ms(torch, run))
    return out


def _jax_order_int8(torch, phi_bf, phi_i8):
    """A copy of the bf16 Phi whose matmul weights are the JAX package's
    int8 serving weights, ``bf16(w_i8 * scale)`` (``phi.py::_wk``), taken
    from the int8 Phi and run through cuBLAS: int8 in JAX's order."""
    phi = copy.deepcopy(phi_bf)
    pairs = [(phi.lm_head, phi_i8.lm_head)] + [
        (getattr(a, n), getattr(b, n))
        for a, b in zip(phi.model.layers, phi_i8.model.layers)
        for n in ("win", "wout")]
    with torch.no_grad():
        for lin, q in pairs:
            lin.weight.copy_((q.kernel_i8.to(torch.bfloat16) * q.scale).t())
    return phi


def phase_mmu_turns(torch, pipes, image, mmu, device, pairs=3):
    """int8 against bf16 answers in turns (bf16, int8, int8, bf16, ...),
    since the host's clock drifts within a run more than the two differ:
    median answer times and the decode tokens/s they give (answer minus
    prompt and prefill), and the pairs int8 won."""
    walls = {0: [], 1: []}
    for order in ((0, 1), (1, 0)) * pairs:
        for int8 in order:
            gen = torch.Generator(device=device).manual_seed(0)
            t0 = time.perf_counter()
            pipes[int8].answer(image, MMU_QUESTION, gen)
            torch.cuda.synchronize()
            walls[int8].append((time.perf_counter() - t0) * 1e3)
    wins = sum(a < b for a, b in zip(walls[1], walls[0]))
    med = {k: statistics.median(v) for k, v in walls.items()}
    tps = {k: 1e3 * MMU_NEW_TOKENS / (med[k] - mmu[k]["prompt_ms"]
                                      - mmu[k]["prefill_ms"]) for k in med}
    print(f"[10] int8 against bf16 in turns ({2 * pairs} answers each): "
          f"answer {med[1]:.2f} vs {med[0]:.2f} ms (medians; int8 "
          f"{', '.join(f'{w:.1f}' for w in walls[1])}; bf16 "
          f"{', '.join(f'{w:.1f}' for w in walls[0])}), decode "
          f"{tps[1]:.2f} vs {tps[0]:.2f} tokens/s, int8 faster in {wins} "
          f"of {2 * pairs} pairs; prefill {mmu[1]['prefill_ms']:.2f} vs "
          f"{mmu[0]['prefill_ms']:.2f} ms, idle share "
          f"{mmu[1]['idle_share']:.4f} vs {mmu[0]['idle_share']:.4f}")


def phase_int8_parity(torch, pipe_bf, pipe_i8, phi32, image):
    """Prefill logits of one prompt with int8, bf16 and fp32 weights (the
    same seeded weights; fp32 with fp32 activations and full-fp32 matmuls,
    the unquantized reference of the JAX package's
    tests/test_int8_decode.py): int8 against fp32 is held to that test's
    limits (top-1 agreement, max abs difference over the reference's
    peak); int8 in JAX's order, int8 against bf16 and bf16 against fp32
    are read beside it."""
    ids, bias = pipe_bf.prompt(image, MMU_QUESTION)
    ids8, _ = pipe_i8.prompt(image, MMU_QUESTION)
    if not torch.equal(ids, ids8):
        raise AssertionError("bf16 and int8 pipelines built different "
                             "prompts")
    jax_order = _jax_order_int8(torch, pipe_bf.model.showo,
                                pipe_i8.model.showo)
    logits = {name: _prefill(torch, phi, (ids, bias)).float()[0]
              for name, phi in (("int8", pipe_i8.model.showo),
                                ("int8 in JAX's order", jax_order),
                                ("bf16", pipe_bf.model.showo),
                                ("fp32", phi32))}
    del jax_order

    def compare(a, b):
        got, ref = logits[a], logits[b]
        agree = (ref.argmax(-1) == got.argmax(-1)).float().mean().item()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        return agree, rel

    readings = {pair: compare(*pair) for pair in (
        ("int8", "fp32"), ("int8 in JAX's order", "fp32"), ("bf16", "fp32"),
        ("int8", "bf16"), ("int8", "int8 in JAX's order"))}
    ref = logits["fp32"]
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).median().item()
    print(f"[11] prefill logits ({pipe_bf.cfg.llm.num_layers} layers, "
          f"{ids.shape[1]} rows, vocab {ref.shape[-1]}; fp32 peak |logit| "
          f"{ref.abs().max().item():.3f}, median top-1 margin {margin:.4f}): "
          + "; ".join(f"{a} vs {b} top-1 agreement {g:.4f}, max abs "
                      f"difference / peak {r:.4e}"
                      for (a, b), (g, r) in readings.items())
          + f"; held: int8 vs fp32 >= {INT8_AGREE} and < {INT8_REL}")
    agree, rel = readings[("int8", "fp32")]
    if not (agree >= INT8_AGREE and rel < INT8_REL):
        raise AssertionError(f"int8 vs fp32 logits: agreement {agree}, "
                             f"relative difference {rel}")
    return readings


def phase_v2_kernels(torch, pipe, prompts):
    """Kernels 1 and 6 against their plain versions at the Show-o2 slice's
    shapes and metadata (the truncated [cond; null] rows of ``prompts``),
    Qwen2.5 and DiT heads; kernel 6 beside kernel 1; the planted fault.
    Returns {"packed": {label: result}, "stacked": {label: result}}."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.ops import flash_attention as tfa

    text, mp = pipe.build_inputs(prompts)
    meta = pipe.attention_inputs(text, mp)[1]
    B, L = text.shape
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
    vis = tfa.visible_mask(*m, meta.pos_q)
    n_vis = int(vis.sum())
    # seg, pad, pos_q, seg_q [B, L] and last_pad, prefix [B], int32
    meta_bytes = 4 * (4 * B * L + 2 * B)
    print(f"[3c] the slice's rows: B={B} S={L} (spans {mp[:, 0].tolist()}); "
          f"{n_vis} visible (row, key) pairs of {B * L * L} "
          f"({n_vis / (B * L * L):.4f})")
    g = torch.Generator(device="cuda").manual_seed(31)
    out = {"packed": {}, "stacked": {}}
    for label, H, Hkv, D in V2_SHAPES:
        if not tfa.gqa_stack_fits(L, L, H // Hkv):
            raise AssertionError(f"{label}: the JAX package would not stack")
        q, k, v = (torch.randn(B, L, n * D, generator=g, device="cuda")
                   .bfloat16() for n in (H, Hkv, Hkv))
        kw = dict(num_heads=H, num_kv_heads=Hkv)
        # the model path's call: its tile map made once with the metadata
        rows = dict(q_positions=meta.pos_q, seg_q=meta.seg_q,
                    tiles=meta.tiles)
        heads = [t.unflatten(-1, (-1, D)).transpose(1, 2) for t in (q, k, v)]
        shape = f"{label}: B={B} S={L} H={H} Hkv={Hkv} D={D}"
        bound = _bound(2 * (2 * B * L * H + 2 * B * L * Hkv) * D + meta_bytes,
                       4 * D * H * n_vis)

        def sdpa():
            return F.scaled_dot_product_attention(
                *heads, attn_mask=vis[:, None], enable_gqa=Hkv != H)

        plains = {
            "packed": lambda v_: tfa.omni_attention_packed_plain(
                q, k, v_, *m, meta.pos_q, sm_scale=D ** -0.5, **kw),
            "stacked": lambda v_: tfa.omni_attention_gqa_stacked_plain(
                q, k, v_, *m, meta.pos_q, sm_scale=D ** -0.5, **kw)}
        kernels = {
            "packed": lambda: tfa.omni_attention_packed(q, k, v, *m, **rows,
                                                        **kw),
            "stacked": lambda: tfa.omni_attention_packed(
                q, k, v, *m, gqa_stack=True, **rows, **kw)}
        before = {n: cuda_build.launches[n]
                  for n in ("omni_attention_packed", PACKED_WGMMA,
                            GQA_SOURCE, GQA_WGMMA, GQA_TILES)}
        for which, num in (("packed", 1), ("stacked", 6)):
            out[which][label] = _compare(
                torch, f"kernel {num} {shape}", kernels[which],
                lambda: plains[which](v), bound, sdpa, phase="3c")
        made = {n: cuda_build.launches[n] - c for n, c in before.items()}
        if not (made["omni_attention_packed"] == made[PACKED_WGMMA] > 0
                and made[GQA_SOURCE] == made[GQA_WGMMA] > 0
                and made[GQA_TILES] == 0):
            raise AssertionError(f"{shape}: launches {made}: kernels 1 and 6 "
                                 f"not all on the wgmma core, or kernel 6 "
                                 f"made a map of its own")
        # kernel 6 beside kernel 1 on the same memory and map: each one's
        # device time a launch, and the library's
        dev_ms = {"packed": _device_ms(torch, kernels["packed"]),
                  "stacked": _device_ms(torch, kernels["stacked"]),
                  "library": _device_ms(torch, sdpa)}
        for which in ("packed", "stacked"):
            out[which][label].update({
                "device_ms": dev_ms[which],
                "library_device_ms": dev_ms["library"],
                "width": tfa.stack_width(H // Hkv)})
        beside = (kernels["packed"]().float()
                  - kernels["stacked"]().float()).abs().max().item()
        out["stacked"][label]["kernel1_diff"] = beside
        if not beside <= CARD_TOL:
            raise AssertionError(f"{shape}: kernel 6 and kernel 1 differ by "
                                 f"{beside}")
        wrong = v.view(B, L, Hkv, D).roll(1, dims=2).reshape(v.shape)
        faults = {}
        for which, plain in plains.items():
            faults[which] = (plain(wrong).float()
                             - plain(v).float()).abs().max().item()
            if not faults[which] > CARD_TOL:
                raise AssertionError(f"{shape}: the planted fault passes the "
                                     f"{which} check: {faults[which]}")
        print(f"[3c] {shape}: kernel 6 ({tfa.stack_width(H // Hkv)} q "
              f"heads a block, {made[GQA_WGMMA]} launches, all on the wgmma "
              f"core, on the slice's tile map) beside kernel 1 on the same "
              f"inputs and map, max |difference| {beside:.3e} (0 expected: "
              f"each head's arithmetic is kernel 1's; tol {CARD_TOL:.0e}); "
              f"device time a launch (profiler, mean of 20): kernel 6 "
              f"{_ms(dev_ms['stacked'])}, kernel 1 {_ms(dev_ms['packed'])}, "
              f"library {_ms(dev_ms['library'])}; planted fault (V of the "
              f"neighbouring kv head) in the plain versions: "
              f"{faults['packed']:.3e} (kernel 1), {faults['stacked']:.3e} "
              f"(kernel 6), each failing the check (tol {CARD_TOL:.0e})")
        out["packed"][label]["old_ms"] = out["stacked"][label]["ms"]
        del q, k, v, heads, wrong
    out["tiles"] = _v2_tile_map_check(torch, tfa, meta)
    for _, H_, Hkv_, D_ in V2_SHAPES:
        _v2_ragged(torch, tfa, H_, Hkv_, D_)
    return out


def _v2_tile_map_check(torch, tfa, meta):
    """Kernel 1's tile map at D=128 of the slice's metadata against its
    plain version; returns its result."""
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
    B, L = meta.seg.shape
    nt = -(-L // 64)
    return _map_check(
        torch, f"kernel 1's tile map at D=128 [{B}, {nt}, {nt + 1}]",
        lambda: tfa.rows_tile_map(*m, meta.pos_q, meta.seg_q),
        lambda: tfa.rows_tile_map_plain(*m, meta.pos_q),
        4 * (4 * B * L + 2 * B) + B * nt * (nt + 1), B * (nt * 64) ** 2,
        "3c", flag=True)[1]


def _v2_ragged(torch, tfa, H, Hkv, D):
    """Kernel 1 on the wgmma core at head dim ``D`` (``H`` q / ``Hkv`` kv
    heads) on a ragged S=200 whose rows 6..9 see no key: against its plain
    version, those rows against the mean of v over the S keys, the same
    bits over two launches."""
    dev = torch.device("cuda")
    m = _ragged_meta(torch, dev)
    B, S = m[0].shape
    g = torch.Generator(device=dev).manual_seed(32 + D)
    q, k, v = (torch.randn(B, S, n * D, generator=g, device=dev).bfloat16()
               for n in (H, Hkv, Hkv))
    kw = dict(num_heads=H, num_kv_heads=Hkv)
    runs = [tfa.omni_attention_packed(q, k, v, *m, **kw) for _ in range(2)]
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    want = tfa.omni_attention_packed_plain(q, k, v, *m, pos,
                                           sm_scale=D ** -0.5, **kw)
    torch.cuda.synchronize()
    err = (runs[0].float() - want.float()).abs().max().item()
    mean_v = v.float().view(B, S, Hkv, D).mean(dim=1).repeat_interleave(
        H // Hkv, dim=1).reshape(B, 1, H * D)
    empty_err = (runs[0][:, 6:10].float() - mean_v).abs().max().item()
    same = torch.equal(runs[0], runs[1])
    print(f"[3c] kernel 1 at D={D}, ragged B={B} S={S} H={H} Hkv={Hkv}, "
          f"rows 6..9 see no key: max_abs_err {err:.3e} against the plain "
          f"version, those rows {empty_err:.3e} from the mean of v (tol "
          f"{CARD_TOL:.0e}); two launches bit-identical: {same}")
    if not (err <= CARD_TOL and empty_err <= CARD_TOL and same):
        raise AssertionError(f"kernel 1 at D={D}, ragged: error {err}, rows "
                             f"without keys {empty_err}, bit-identical "
                             f"{same}")


def phase_v2_slice(torch, np, cuda_build, pipe, prompts, smi):
    """The Show-o2 432x432 pipeline: launch counts over one generate call,
    output checks, warm wall time and peak memory.  Returns (kernel 1
    launches of one generate, the slice's readings).  The time by
    operator of one generate is ``profile_t2i.py --slice v2``'s (its
    ~200,000 launches take the profiler minutes)."""
    cfg = pipe.cfg
    lc, dc, sc = cfg.llm, cfg.dit, cfg.siglip
    if not (pipe.attn_route == "packed" and lc.num_layers == 28
            and lc.hidden_size == 1536 and (lc.num_heads, lc.num_kv_heads,
                                            lc.head_dim) == (12, 2, 128)
            and lc.vocab_size == 151940 and dc.num_layers == 10
            and dc.hidden_size == 2048 and (dc.num_heads, dc.num_kv_heads,
                                            dc.head_dim) == (32, 8, 64)
            and sc.num_layers == 26 and sc.hidden_size == 1152
            and cfg.num_image_tokens == 730 and pipe.num_steps == 50
            and pipe.guidance_scale == 7.5 and pipe.vae.cfg.dim == 96):
        raise AssertionError(f"not the full-width Show-o2 432x432 path: "
                             f"{pipe.attn_route}, {cfg}, {pipe.vae.cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                       # warm-up
    want = {name: 0 for name in COUNTERS}
    want["omni_attention_packed"] = V2_LAYERS * V2_EVALS
    want[PACKED_WGMMA] = V2_LAYERS * V2_EVALS   # every one on the core
    want[PACKED_TILES] = 1      # made once with the generate's metadata
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    images = pipe.generate(prompts, gen)
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"v2: kernel launches in one generate call "
                             f"{counts}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if images.shape != (V2_BATCH, 432, 432, 3) or not np.isfinite(
            images).all():
        raise AssertionError(f"v2: images {images.shape} or non-finite")
    if images.min() < -1.0 or images.max() > 1.0:
        raise AssertionError("v2: images outside [-1, 1]")
    walls = []
    for _ in range(2):
        before = dict(cuda_build.launches)
        t0 = time.perf_counter()
        pipe.generate(prompts, gen)
        walls.append(time.perf_counter() - t0)
        if {n: cuda_build.launches[n] - before.get(n, 0)
                for n in want} != want:
            raise AssertionError("v2: launch counts changed")
    wall = statistics.median(walls)
    text, _ = pipe.build_inputs(prompts)
    print(f"[12] slice Show-o2 1.5B t2i 432x432 route packed, 50-point "
          f"Euler ({V2_EVALS} velocity evaluations), CFG 7.5, batch "
          f"{V2_BATCH} ({tuple(text.shape)} rows x tokens), bf16, VAE fp32, "
          f"random weights: launches per generate "
          f"{counts['omni_attention_packed']} = {V2_LAYERS} x {V2_EVALS} of "
          f"omni_attention_packed ({V2_QWEN_LAYERS} x {V2_EVALS} at "
          f"D=128, {V2_LAYERS - V2_QWEN_LAYERS} x {V2_EVALS} at D=64; "
          f"{counts[PACKED_WGMMA]} on the wgmma core, all reading "
          f"{counts[PACKED_TILES]} tile map), 0 of the others "
          f"({GQA_SOURCE} among them); images {images.shape} finite in [-1, 1]; warm wall "
          f"{wall:.4f} s/batch (median of 2: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{V2_BATCH * 60.0 / wall:.2f} images/min; peak memory allocated "
          f"{peak:.2f} GiB on {smi}")
    return counts, {"wall_s": wall, "images_per_min": V2_BATCH * 60.0 / wall,
                    "peak_gib": peak}


def phase_v2_parity(torch, pipe, prompts):
    """One full-width velocity evaluation on the packed route against dense
    attention under the additive omni mask: the same weights, latents and
    t.  The reference's zero init of the DiT's adaLN projections and of the
    FinalLayer makes the velocity 0 whatever the towers compute, so they
    are drawn N(0, 0.02) first (this phase is the model's last use)."""
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.show_o2.showo2 import showo2_t2i_velocity

    model, cfg = pipe.model, pipe.cfg
    g = torch.Generator(device="cuda").manual_seed(13)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN_modulation" in name or "diffusion_head_b.linear" in name:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.02)
    text, mp = pipe.build_inputs(prompts)
    B, L = text.shape
    z = torch.randn(B // 2, cfg.image_latent_dim, cfg.image_latent_height,
                    cfg.image_latent_width, generator=g, device="cuda")
    x = torch.cat([z, z])
    t = torch.full((B,), 0.5, device="cuda")
    inputs = {"packed": (None, pipe.attention_inputs(text, mp)[1]),
              "dense": (omni_attn_mask(mp, L), None)}
    v = {}
    with torch.no_grad():
        for route, (bias, meta) in inputs.items():
            for cfg_scale in (0.0, pipe.guidance_scale):
                v[route, cfg_scale] = showo2_t2i_velocity(
                    model, text, x, t, bias, mp, guidance_scale=cfg_scale,
                    attn_meta=meta).float()
    rel = {s: ((v["packed", s] - v["dense", s]).abs().max()
               / v["dense", s].abs().max()).item()
           for s in (0.0, pipe.guidance_scale)}
    peak = v["dense", 0.0].abs().max().item()
    print(f"[13] velocity parity packed vs dense (28 + 10 layers, "
          f"{tuple(text.shape)}, bf16, t 0.5): max |dv| / peak "
          f"{rel[0.0]:.4e} unguided (peak |v| {peak:.4f}; tol "
          f"{V2_STEP_TOL}), {rel[pipe.guidance_scale]:.4e} with CFG "
          f"{pipe.guidance_scale}")
    if not rel[0.0] <= V2_STEP_TOL:
        raise AssertionError(f"v2 velocity packed vs dense differs by "
                             f"{rel[0.0]} of the peak > {V2_STEP_TOL}")
    return rel


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
    from showo_tpu_torch.profile_train import (stage1_config, train_batch,
                                               tuning512_config)
    from showo_tpu_torch.training.train_showo import build_trainer

    device = torch.device("cuda")
    t_start = time.perf_counter()
    parts = []      # (part of the run, its end time): the [end] line's split

    # [1] device
    smi = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] device: {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | TF32 off (matmul and cuDNN) for the "
          f"parity phases")

    # [2] build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = [name for name, _ in KERNELS.values()] + [
        TRAIN_SOURCE, STREAM_TRAIN_SOURCE, *WSMM_KERNELS, GQA_SOURCE]
    cuda_build.load_libraries(names)
    print(f"[2] build: {len(names)} sources with nvcc (sm_90a) in parallel, "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        info = cuda_build.build_info[name]
        regs = _ptxas(info["log"]) or [info["log"]]
        print(f"[2]   csrc/{name}.cu {info['seconds']:.2f} s; ptxas: "
              f"{' | '.join(regs)}")
    parts.append(("device + build [1-2]", time.perf_counter()))

    # [3] kernel vs plain
    config = load_config("configs/showo_demo_512x512.yaml",
                         ["guidance_scale=1.75",
                          f"generation_timesteps={TIMESTEPS}"])
    prompts = inference_t2i.load_prompts(config)[:BATCH]
    results = phase_kernels(torch, inference_t2i.build_prompting(config),
                            prompts, inference_t2i.build_showo_config(config),
                            device)

    # [4] the slice through the CLI's build_pipeline, once per route
    route_launches, pipe = {}, None
    for route in KERNELS:
        pipe = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe, route_launches[route] = phase_slice(
            torch, np, inference_t2i, cuda_build, config, prompts, route, smi)

    # [5] step parity, every route, on the last pipeline's weights
    phase_step_parity(torch, pipe, prompts, device)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("t2i 512x512 [3-5]", time.perf_counter()))

    # the training phases: cuDNN convolutions (the frozen MAGVIT encoder)
    # back on PyTorch's default TF32; matmuls stay full fp32 (the dense
    # route's fp32 scores, the plain versions)
    torch.backends.cudnn.allow_tf32 = True
    trainer, batch, noise, meta = _trainer(
        torch, build_trainer, train_batch, stage1_config(),
        "configs/showo_pretraining_stage1.yaml", (29, 387), 6)

    # [6] kernel 7 vs plain, on the fused batch's metadata
    train_results = phase_train_kernels(torch, meta, 7, "stage-1", 6)

    # [7] the stage-1 training slice through build_trainer / train_step
    train_launches = phase_train(torch, cuda_build, trainer, batch, noise,
                                 smi, "stage-1", TRAIN_KERNELS, 7)

    # [8] trainable vs dense, one full-width step
    phase_train_parity(torch, trainer, batch, noise, 8, TRAIN_LOSS_TOL,
                       GRAD_NORM_TOL)
    trainer = batch = noise = meta = None      # frees the stage-1 trainer
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("stage-1 trainer [6-8]", time.perf_counter()))

    trainer, batch, noise, meta = _trainer(
        torch, build_trainer, train_batch, tuning512_config(),
        "configs/showo_instruction_tuning_1_512x512.yaml", (12, 1408), "6b")

    # [6b] kernel 8 vs plain, on the 512x512 fused batch's metadata
    stream_results = phase_train_kernels(torch, meta, 8, "512x512", "6b")
    meta = None

    # [7b] the 512x512 training slice
    stream_launches = phase_train(torch, cuda_build, trainer, batch, noise,
                                  smi, "512x512", STREAM_TRAIN_KERNELS, "7b")

    # [8b] trainable vs dense, one full-width 512x512 step
    phase_train_parity(torch, trainer, batch, noise, "8b",
                       TRAIN512_LOSS_TOL, TRAIN512_GRAD_NORM_TOL)
    trainer = batch = noise = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("512x512 trainer [6b-8b]", time.perf_counter()))

    # the understanding slice (configs/showo_demo.yaml: 256x256, the full
    # MAGVIT-v2 encoder), bf16 and int8 pipelines on the same seeded weights
    from PIL import Image

    from showo_tpu_torch import inference_mmu
    from showo_tpu_torch.models.clip_vit import ClipVisionTower, ClipVitConfig
    from showo_tpu_torch.profile_t2i import profile
    from showo_tpu_torch.utils.image import clip_image_transform

    from showo_tpu_torch.models.phi import fuse_parallel_mlp

    mmu_args = [f"max_new_tokens={MMU_NEW_TOKENS}", "top_k=1"]
    mmu_config = load_config("configs/showo_demo.yaml", mmu_args)
    pipes = {int8: inference_mmu.build_pipeline(load_config(
        "configs/showo_demo.yaml", mmu_args + [f"int8={int8}"]), device)
        for int8 in (0, 1)}
    image = _mmu_image(256)
    prefill_rows = pipes[0].prompt(image, MMU_QUESTION)[0].shape[1]

    # [9] kernels 9-11 vs plain at the slice's shapes
    wsmm = phase_wsmm(torch, cuda_build, prefill_rows)

    # [10] the discrete mmu slice, bf16 then int8 weights
    mmu = {}
    for int8, pipe in pipes.items():
        gen = torch.Generator(device=device).manual_seed(0)
        mmu[int8] = phase_mmu(
            torch, cuda_build, profile, pipe,
            f"mmu discrete path, {'int8' if int8 else 'bf16'} weights",
            lambda: pipe.answer(image, MMU_QUESTION, gen),
            lambda: pipe.prompt(image, MMU_QUESTION), int8, smi, 10)
    phase_mmu_turns(torch, pipes, image, mmu, device)

    # [11] int8, bf16 and fp32 prefill logits, same prompt and seeded
    # weights (the fp32 model as build_pipeline initialises it)
    cfg = inference_t2i.build_showo_config(mmu_config)
    model32 = inference_t2i.load_model(mmu_config, cfg, device, torch.float32)
    fuse_parallel_mlp(model32.showo)
    phase_int8_parity(torch, pipes[0], pipes[1], model32.showo, image)
    pipes = pipe = model32 = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("understanding [9-11]", time.perf_counter()))

    # [10b] the CLIP-ViT path (configs/showo_demo_w_clip_vit.yaml), int8
    clip_config = load_config("configs/showo_demo_w_clip_vit.yaml",
                              mmu_args + ["int8=1"])
    pipe = inference_mmu.build_pipeline(clip_config, device)
    tower, size = inference_mmu.build_clip(clip_config, device)
    if not (isinstance(tower, ClipVisionTower) and tower.cfg == ClipVitConfig()
            and pipe.cfg.w_clip_vit and pipe.cfg.clip_feat_dim == 1024):
        raise AssertionError("not the CLIP-L/14-336 path at full width")
    px = torch.as_tensor(clip_image_transform(
        Image.open(MMU_IMAGE).convert("RGB"), size), device=device)[None]
    feats = tower(px)[0]
    if tuple(feats.shape) != (576, 1024) or not torch.isfinite(feats).all():
        raise AssertionError(f"CLIP features {tuple(feats.shape)} or not "
                             f"finite")
    clip_ms = _wall_ms(torch, lambda: tower(px))
    print(f"[10b] CLIP-L/14-336 tower (23 of 24 layers, bf16): features "
          f"{tuple(feats.shape)} of a {size}x{size} image in {clip_ms:.2f} "
          f"ms (median of 5)")
    sys_ids = inference_mmu.system_prompt_ids(pipe)
    gen = torch.Generator(device=device).manual_seed(0)
    clip = phase_mmu(
        torch, cuda_build, profile, pipe, "mmu CLIP-ViT path, int8 weights",
        lambda: pipe.answer_with_clip(feats, MMU_QUESTION, sys_ids, gen),
        lambda: pipe.clip_prompt(feats, MMU_QUESTION, sys_ids), 1, smi, "10b")
    if clip["rows"] != CLIP_PREFILL_ROWS:
        raise AssertionError(f"CLIP-ViT prompt rows {clip['rows']}, phase 9 "
                             f"timed {CLIP_PREFILL_ROWS}")
    pipe = tower = feats = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("CLIP-ViT [10b]", time.perf_counter()))

    # the Show-o2 432x432 slice through the CLI's build_pipeline
    from showo_tpu_torch import inference_t2i_v2

    v2_config = load_config(V2_CONFIG)
    t0 = time.perf_counter()
    pipe = inference_t2i_v2.build_pipeline(v2_config, device)
    torch.cuda.synchronize()
    print(f"[12] Show-o2 pipeline built in {time.perf_counter() - t0:.1f} s "
          f"(random weights from seeds): "
          f"{sum(p.numel() for p in pipe.model.parameters())} parameters, "
          f"VAE {sum(p.numel() for p in pipe.vae.parameters())}")
    v2_prompts = inference_t2i_v2.load_prompts(v2_config)[:V2_BATCH]

    # [3c] kernels 1 and 6 at the slice's shapes
    v2_results = phase_v2_kernels(torch, pipe, v2_prompts)

    # [12] the slice, [13] packed vs dense velocity
    v2_launches, v2_slice = phase_v2_slice(torch, np, cuda_build, pipe,
                                           v2_prompts, smi)
    phase_v2_parity(torch, pipe, v2_prompts)
    pipe = None
    parts.append(("Show-o2 [3c, 12, 13]", time.perf_counter()))

    kernels = []
    for route, (name, replaces) in KERNELS.items():
        r512, r256 = results[route]["512"], results[route].get("256")
        entry = {"name": name, "route": "cuda",
                 "source": f"showo_tpu_torch/csrc/{name}.cu" + (
                     " (+ attention_fwd_sm90.cuh)" if route in ROUTE_TILES
                     else ""),
                 "replaces": replaces,
                 "launches": route_launches[route][name],
                 **r512}
        if route == "packed":
            entry["launches_wgmma"] = route_launches[route][PACKED_WGMMA]
        if route == "fused":
            entry["part"] = ("the core's launch; 'whole': both launches, "
                             "the pass (fused_decode_norm_rope) and the core")
        if r256 is not None:
            entry.update({f"{key}_256": val for key, val in r256.items()})
        kernels.append(entry)
    for source, table, counts, res in (
            (TRAIN_SOURCE, TRAIN_KERNELS, train_launches, train_results),
            (STREAM_TRAIN_SOURCE, STREAM_TRAIN_KERNELS, stream_launches,
             stream_results)):
        for name, (replaces, _) in table.items():
            kernels.append({"name": name, "route": "cuda",
                            "source": f"showo_tpu_torch/csrc/{source}.cu",
                            "replaces": replaces, "launches": counts[name],
                            **res[name]})
    for name, replaces in WSMM_KERNELS.items():
        cases = wsmm[name]
        case = "win M=1"
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces,
                        "launches": mmu[1]["launches"]
                        if name == "int8_matmul" else 0,
                        **cases[case], "case": case, "cases": cases})
    case = f"win M={prefill_rows}"
    for name, source, launches in (
            (PREFILL_KERNEL, "int8_matmul", mmu[1]["prefill_launches"]),
            (INT4_PREFILL_KERNEL, "int4_matmul", 0)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{source}.cu (+ "
                                  f"weight_stream_prefill.cuh)",
                        "replaces": WSMM_KERNELS[source],
                        "launches": launches, **wsmm[name][case],
                        "case": case, "cases": wsmm[name]})
    qwen = V2_SHAPES[0][0]
    for name, source, replaces, which, launches in (
            ("omni_attention_packed_v2", "omni_attention_packed.cu (+ "
             "attention_fwd_sm90.cuh)", KERNELS["packed"][1],
             "packed", v2_launches["omni_attention_packed"]),
            (GQA_SOURCE, f"{GQA_SOURCE}.cu (+ attention_fwd_sm90.cuh)",
             GQA_REPLACES, "stacked", 0)):
        cases = v2_results[which]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches,
                        **cases[qwen], "case": qwen, "cases": cases,
                        **({"slice": v2_slice, "launches_wgmma":
                            v2_launches[PACKED_WGMMA]} if launches else {})})
    for route, what in (("omni", "the mask of _attn_kernel, per block"),
                        ("fused", "the mask of _kernel, per block"),
                        ("streaming", "the mask of _stream_kernel, per "
                                      "block"),
                        ("decode", "the bias of _kernel / "
                                   "_kernel_headloop, per block")):
        name = ROUTE_TILES[route]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{KERNELS[route][0]}"
                                  f".cu (+ attention_fwd_sm90.cuh)",
                        "replaces": f"{KERNELS[route][1]} ({what})",
                        "launches": route_launches[route][name],
                        **results[f"{route}_tiles"], "case": "512"})
    kernels.append({"name": FUSED_NORM, "route": "cuda",
                    "source": "showo_tpu_torch/csrc/fused_decode.cu",
                    "replaces": KERNELS["fused"][1] + " (the LayerNorm and "
                                "RoPE of _kernel)",
                    "launches": route_launches["fused"][FUSED_NORM],
                    **results["fused_norm"]["512"],
                    **{f"{key}_256": val for key, val in
                       results["fused_norm"]["256"].items()}})
    kernels.append({"name": PACKED_TILES, "route": "cuda",
                    "source": "showo_tpu_torch/csrc/omni_attention_packed.cu "
                              "(+ attention_fwd_sm90.cuh)",
                    "replaces": KERNELS["packed"][1] + " (the mask of "
                                "_attn_kernel_packed, per block)",
                    "launches": route_launches["packed"][PACKED_TILES],
                    **results["tiles"], "case": "512",
                    "launches_v2": v2_launches[PACKED_TILES],
                    "cases": {"512": results["tiles"],
                              "v2": v2_results["tiles"]}})
    starts = [t_start] + [t for _, t in parts[:-1]]
    split = ", ".join(f"{part} {end - begin:.1f}"
                      for (part, end), begin in zip(parts, starts))
    print(f"[end] every phase passed in {time.perf_counter() - t_start:.1f} "
          f"s (build included): {split} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
