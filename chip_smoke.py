#!/usr/bin/env python3
"""Smoke run of the PyTorch port (showo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the v1 512x512 text-to-image path (the ``t2i_512`` bench row) at
the full width of Show-o 1.3B (Phi-1.5: 24 layers, hidden 2048, 32 heads)
with the full MAGVIT-v2 decoder, random weights from a fixed seed, bf16,
16-step prefix-cached MaskGIT with CFG 1.75, batch 2, through the CLI's
``build_pipeline``, once on each attention route with a kernel: ``packed``
(the default at 512x512), ``omni``, ``decode`` and ``fused``.  Phases,
one or more lines each:

  1. device: card name and power limit, torch / CUDA versions; TF32 off
  2. build: nvcc builds the four kernel sources of csrc/, in parallel
  3. kernel vs plain: each kernel at the cached step's shapes (B=4, P=129,
     H=32, D=64, bf16, metadata of a left-padded t2i layout): the packed
     kernel at 512x512 and one GQA case; omni, decode and fused at
     512x512 (Q=1026, K=1155) and 256x256 (Q=258, K=387); max abs error
     and median times (CUDA events)
  4. the slice, per route: over one generate call the route's kernel
     launches 24 layers x 16 steps times and every other kernel none;
     codes in the codebook; images finite, NHWC, in [-1, 1]; warm
     seconds per batch and images/min
  5. step parity, per route: one full-width cached step with the route's
     kernel and with dense attention under the additive mask, max abs
     logit difference

Then a JSON line of kernel results, the nvidia-smi name/power line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero with no result line; without CUDA it exits 2.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

CARD_TOL = 2e-2      # kernel vs plain, bf16 outputs of ~N(0, 1) averages
STEP_TOL = 1e-1      # max |logit| difference, kernel vs dense, full step
NUM_LAYERS, TIMESTEPS, BATCH = 24, 16, 2
P, H, D = 129, 32, 64            # text prefix rows, heads, head dim

# route -> (kernel source name, the TPU kernel it replaces)
KERNELS = {
    "packed": ("omni_attention_packed",
               "showo_tpu/ops/flash_attention.py:232"),
    "omni": ("omni_attention", "showo_tpu/ops/flash_attention.py:87"),
    "decode": ("decode_attention", "showo_tpu/ops/decode_attention.py:69"),
    "fused": ("fused_decode", "showo_tpu/ops/fused_decode.py:114"),
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


def _t2i_layout(uni, prompts, num_vq_tokens: int, mask_id: int, device):
    """[cond | uncond] token rows of the t2i layout for the prompts."""
    import numpy as np
    import torch

    img = np.full((BATCH, num_vq_tokens), mask_id, np.int64)
    ids, _ = uni((prompts, img), "t2i_gen")
    unc, _ = uni(([""] * len(prompts), img), "t2i_gen")
    return torch.as_tensor(np.concatenate([ids, unc]), device=device)


def _compare(torch, label, kern, plain):
    """Kernel vs plain on the same inputs: max abs error (checked against
    CARD_TOL), then median times of both."""
    got = kern()
    torch.cuda.synchronize()
    err = (got.float() - plain().float()).abs().max().item()
    if not (torch.isfinite(got).all() and err <= CARD_TOL):
        raise AssertionError(f"{label}: kernel vs plain max abs err {err} > "
                             f"{CARD_TOL} or non-finite")
    ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
    print(f"[3] {label} bf16: max_abs_err {err:.3e} (tol {CARD_TOL}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(torch, uni, prompts, cfg, device):
    """Each kernel against its plain version at the main path's shapes;
    returns {route: {"512": result, "256": result}}."""
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

        def randn(*s):
            return torch.randn(*s, generator=g, device=device).bfloat16()

        if res == "512":
            for hkv in (H, H // 4):
                q, k, v = randn(B, Q, H * D), randn(B, L, hkv * D), randn(
                    B, L, hkv * D)
                r = _compare(
                    torch, f"omni_attention_packed {shape} Hkv={hkv}",
                    lambda: tfa.omni_attention_packed(
                        q, k, v, *meta, num_heads=H, num_kv_heads=hkv,
                        q_positions=pos_q, seg_q=seg_q),
                    lambda: tfa.omni_attention_packed_plain(
                        q, k, v, *meta, pos_q, num_heads=H,
                        num_kv_heads=hkv, sm_scale=D ** -0.5))
                out["packed"].setdefault(res, r)

        # omni: transposed [B, S, H, D] views, as phi's omni route passes
        q, k, v = (randn(B, n, H, D).transpose(1, 2) for n in (Q, L, L))
        out["omni"][res] = _compare(
            torch, f"omni_attention {shape}",
            lambda: tfa.omni_attention(q, k, v, *meta, q_positions=pos_q,
                                       seg_q=seg_q),
            lambda: tfa.omni_attention_plain(q, k, v, *meta, pos_q,
                                             sm_scale=D ** -0.5))

        # decode: the bias as the cached step's strided view of the mask
        bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
        bias = bias[:, :, P:, :]
        q, k, v = (randn(B, n, H, D) for n in (Q, L, L))
        out["decode"][res] = _compare(
            torch, f"decode_attention {shape} (bias view, row stride {L})",
            lambda: tda.decode_attention(q, k, v, bias),
            lambda: tda.decode_attention_plain(q, k, v, bias))

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
        out["fused"][res] = _compare(
            torch, f"fused_decode_attention {shape} (y row stride "
            f"{y.shape[-1]})",
            lambda: tfd.fused_decode_attention(*args, *meta, pos, rows=rows,
                                               **kw),
            lambda: tfd.fused_decode_attention_plain(
                *args, meta[2], meta[3], rows, sm_scale=D ** -0.5,
                softmax_dtype=torch.float32, **kw))
    return out


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
    names = [name for name, _ in KERNELS.values()]
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

    kernels = []
    for route, (name, replaces) in KERNELS.items():
        r512, r256 = results[route]["512"], results[route].get("256")
        entry = {"name": name, "route": "cuda",
                 "source": f"showo_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces, "launches": launches[route], **r512}
        if r256 is not None:
            entry.update({f"{key}_256": val for key, val in r256.items()})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
