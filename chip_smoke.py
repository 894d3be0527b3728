#!/usr/bin/env python3
"""Smoke run of the PyTorch port (showo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the v1 512x512 text-to-image path (the ``t2i_512`` bench row) at
the full width of Show-o 1.3B (Phi-1.5: 24 layers, hidden 2048, 32 heads)
with the full MAGVIT-v2 decoder, random weights from a fixed seed, bf16,
16-step prefix-cached MaskGIT with CFG 1.75, batch 2, through the CLI's
``build_pipeline``.  Phases, one line each:

  1. device: card name and power limit, torch / CUDA versions; TF32 off
  2. build: nvcc builds the packed omni-attention kernel from csrc/
  3. kernel vs plain at the main path's shape (B=4, Q=1026, S=1155,
     H=32, D=64, bf16, metadata of a left-padded t2i layout) and one GQA
     case, with max abs error and median times (CUDA events)
  4. the slice: the kernel's launch count over one generate call must be
     24 layers x 16 steps; codes in the codebook; images finite, NHWC,
     in [-1, 1]; warm seconds per batch and images/min
  5. step parity: one full-width cached step with the kernel and with
     dense attention under the additive mask, max abs logit difference

Then a JSON line of kernel results, the nvidia-smi name/power line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero with no result line; without CUDA it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

CARD_TOL = 2e-2      # kernel vs plain, bf16 outputs of ~N(0, 1) averages
STEP_TOL = 1e-1      # max |logit| difference, kernel vs dense, full step
NUM_LAYERS, TIMESTEPS, BATCH = 24, 16, 2


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


def _t2i_layout(uni, prompts, num_vq_tokens: int, mask_id: int, device):
    """[cond | uncond] token rows of the t2i layout for the prompts."""
    import numpy as np
    import torch

    img = np.full((BATCH, num_vq_tokens), mask_id, np.int64)
    ids, _ = uni((prompts, img), "t2i_gen")
    unc, _ = uni(([""] * len(prompts), img), "t2i_gen")
    return torch.as_tensor(np.concatenate([ids, unc]), device=device)


def phase_kernel(torch, tfa, uni, prompts, cfg, device):
    """Kernel vs plain at the main path's shape, and a GQA case."""
    sp = uni.sptids
    full = _t2i_layout(uni, prompts, cfg.num_vq_tokens, cfg.mask_token_id,
                       device)
    B, S = full.shape
    P, Q, H, D = 129, S - 129, 32, 64
    meta = tfa.metadata_predict_next(full, sp["<|pad|>"], sp["<|soi|>"],
                                     sp["<|eoi|>"])
    if not int(meta[1].sum()) > 0:
        raise AssertionError("the t2i layout must be left-padded")
    # the q rows' positions and segments, computed once per forward as the
    # main path does (models/phi.py packed_step_meta)
    pos_q, seg_q = tfa.q_rows(meta[0], torch.arange(P, S, device=device), B, Q)
    results = []
    for hkv in (H, H // 4):
        g = torch.Generator(device=device).manual_seed(hkv)
        q = torch.randn(B, Q, H * D, generator=g, device=device).bfloat16()
        k = torch.randn(B, S, hkv * D, generator=g, device=device).bfloat16()
        v = torch.randn(B, S, hkv * D, generator=g, device=device).bfloat16()

        def kern():
            return tfa.omni_attention_packed(
                q, k, v, *meta, num_heads=H, num_kv_heads=hkv,
                q_positions=pos_q, seg_q=seg_q)

        def plain():
            return tfa.omni_attention_packed_plain(
                q, k, v, *meta, pos_q, num_heads=H, num_kv_heads=hkv,
                sm_scale=D ** -0.5)

        got = kern()
        torch.cuda.synchronize()
        err = (got.float() - plain().float()).abs().max().item()
        if not (torch.isfinite(got).all() and err <= CARD_TOL):
            raise AssertionError(f"kernel vs plain (Hkv={hkv}): max abs err "
                                 f"{err} > {CARD_TOL} or non-finite")
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        print(f"[3] kernel vs plain B={B} Q={Q} S={S} H={H} Hkv={hkv} D={D} "
              f"bf16: max_abs_err {err:.3e} (tol {CARD_TOL}), kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
        results.append((err, ms, plain_ms))
    return results[0]


def phase_step_parity(torch, pipe, prompts, device):
    """One full-width cached step, packed kernel vs dense masked attention,
    on the same weights and inputs (half the image tokens known)."""
    from showo_tpu_torch.models.phi import KVCache
    from showo_tpu_torch.ops.flash_attention import metadata_predict_next
    from showo_tpu_torch.ops.masks import omni_mask_predict_next

    cfg, sp = pipe.cfg, pipe.uni_prompting.sptids
    full = _t2i_layout(pipe.uni_prompting, prompts, cfg.num_vq_tokens,
                       cfg.mask_token_id, device)
    B, L = full.shape
    P = pipe.max_seq_length + 1
    g = torch.Generator(device=device).manual_seed(5)
    known = torch.rand(B, cfg.num_vq_tokens, generator=g, device=device) < 0.5
    codes = torch.randint(0, cfg.codebook_size, (B, cfg.num_vq_tokens),
                          generator=g, device=device) + cfg.codebook_offset
    full[:, P + 1:L - 1] = torch.where(known, codes, full[:, P + 1:L - 1])
    pad, soi, eoi = sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"]
    bias = omni_mask_predict_next(full, pad, soi, eoi, rm_pad_in_image=True)
    meta = ("packed",) + metadata_predict_next(full, pad, soi, eoi)
    phi = pipe.model.showo
    emb = phi.model.embed_tokens.weight
    cache = KVCache.zeros(cfg.llm, B, L, dtype=emb.dtype, device=device)
    with torch.no_grad():
        phi(input_ids=full[:, :P], attention_bias=bias[:, :, :P], cache=cache)
        head = (1, 1 + cfg.num_vq_tokens, cfg.codebook_offset,
                cfg.codebook_offset + cfg.codebook_size)
        step = dict(input_ids=full[:, P:], attention_bias=bias[:, :, P:],
                    cache=cache, lm_head_slice=head, static_prefix_len=P)
        kern, _ = phi(attn_meta=meta, **step)
        dense, _ = phi(attn_meta=None, **step)
    diff = (kern.float() - dense.float()).abs().max().item()
    scale = dense.float().abs().max().item()
    agree = (kern.argmax(-1) == dense.argmax(-1)).float().mean().item()
    print(f"[5] step parity (24 layers, B={B}, Q={L - P}, bf16): max abs "
          f"logit diff kernel vs dense {diff:.4e} (tol {STEP_TOL}; max "
          f"|logit| {scale:.3f}; argmax agreement {agree:.4f})")
    if not diff <= STEP_TOL:
        raise AssertionError(f"step logits differ by {diff} > {STEP_TOL}")


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
    from showo_tpu_torch.ops import flash_attention as tfa

    device = torch.device("cuda")

    # [1] device
    smi = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] device: {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | TF32 off (matmul and cuDNN) for the "
          f"parity phases")

    # [2] build
    t0 = time.perf_counter()
    tfa._kernel()
    info = cuda_build.build_info["omni_attention_packed"]
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln] or [info["log"]]
    print(f"[2] build: omni_attention_packed.cu with nvcc (sm_90a) in "
          f"{info['seconds']:.2f} s (load {time.perf_counter() - t0:.2f} s); "
          f"ptxas: {' | '.join(regs)}")

    # [3] kernel vs plain
    config = load_config("configs/showo_demo_512x512.yaml",
                         ["guidance_scale=1.75",
                          f"generation_timesteps={TIMESTEPS}"])
    prompts = inference_t2i.load_prompts(config)[:BATCH]
    err, ms, plain_ms = phase_kernel(
        torch, tfa, inference_t2i.build_prompting(config), prompts,
        inference_t2i.build_showo_config(config), device)

    # [4] the slice through the CLI's build_pipeline
    t0 = time.perf_counter()
    pipe = inference_t2i.build_pipeline(config, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = pipe.cfg
    if not (pipe.attn_route == "packed" and cfg.llm.num_layers == NUM_LAYERS
            and cfg.llm.hidden_size == 2048):
        raise AssertionError(f"not the full-width 512x512 packed path: "
                             f"{pipe.attn_route}, {cfg.llm}")
    gen = torch.Generator(device=device).manual_seed(0)
    pipe.generate(prompts, gen)                       # warm-up

    tfa.launches = 0
    images = pipe.generate(prompts, gen)
    launches = tfa.launches
    if launches != NUM_LAYERS * TIMESTEPS:
        raise AssertionError(f"kernel launched {launches} times in one "
                             f"generate call, want {NUM_LAYERS * TIMESTEPS}")
    if images.shape != (BATCH, 512, 512, 3) or not np.isfinite(images).all():
        raise AssertionError(f"images {images.shape} or non-finite")
    if images.min() < -1.0 or images.max() > 1.0:
        raise AssertionError("images outside [-1, 1]")

    walls = []
    for _ in range(3):
        before = tfa.launches
        t0 = time.perf_counter()
        pipe.generate(prompts, gen)
        walls.append(time.perf_counter() - t0)
        if tfa.launches - before != NUM_LAYERS * TIMESTEPS:
            raise AssertionError("launch count per generate call changed")
    codes = pipe.generate_codes(prompts, gen)
    if not (int(codes.min()) >= 0 and int(codes.max()) < cfg.codebook_size
            and tuple(codes.shape) == (BATCH, 1024)):
        raise AssertionError(f"codes out of range {tuple(codes.shape)}")
    wall = statistics.median(walls)
    print(f"[4] slice t2i 512x512, {TIMESTEPS} steps, CFG 1.75, batch "
          f"{BATCH}, bf16, random weights (setup {setup_s:.1f} s): kernel "
          f"launches per generate {launches} = {NUM_LAYERS} x {TIMESTEPS}; "
          f"images {images.shape} finite in [-1, 1]; warm wall "
          f"{wall:.4f} s/batch (median of 3: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{BATCH * 60.0 / wall:.2f} images/min on {smi}")

    # [5] step parity
    phase_step_parity(torch, pipe, prompts, device)

    print(json.dumps({"kernels": [{
        "name": "omni_attention_packed", "route": "cuda",
        "source": "showo_tpu_torch/csrc/omni_attention_packed.cu",
        "replaces": "showo_tpu/ops/flash_attention.py:232",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
