"""Times of the trainable attention kernels at a training configuration's
fused batch on one card, for holding two trees side by side in one call.

    python3 showo_tpu_torch/time_trainable.py --config stage1|tuning512 \
        [--slice v1|v2] [--seq S] [--root DIR] [--tag NAME] \
        [--optimizer adamw|adamw_bf16|adafactor] [--remat POLICY] \
        [--softmax fp32|bf16]

``--root`` names the checkout whose ``showo_tpu_torch`` is imported (by
default this file's own), so that one call on one card can time a parent
tree beside its change in turns (parent, change, change, parent), each
building its own kernels into its own ``_build``.  The configuration
(``profile_train``: ``stage1`` routes to kernel 7, ``tuning512`` past the
packed budget to kernel 8) gives the attention metadata of its seeded
fused batch (the full-width trainer is built for it, then freed); q, k,
v and dO are seeded bf16 tensors of its shape (H = 32, D = 64) in the
layout of the kernel set.  Timed, CUDA-event medians of 20 with the
wrapper: the forward, dq and dk/dv (on one tile map made beforehand where
the wrapper takes one) and ``scaled_dot_product_attention`` with the
boolean mask, forward and backward.  Prints the card and one JSON line.

``--slice v2``: the Show-o2 stage-1 step instead (``profile_train
.v2_batch``: 2 rows of ``--seq`` tokens, default 1024; no trainer is
built, the metadata comes from the rows' modality positions), at both
towers' shapes: Qwen2.5's 12 q / 2 kv heads of 128 and the DiT's 32 / 8
of 64, each on the kernel set the dispatcher picks (kernel 7 to S = 1280
for Qwen, 1024 for the DiT, kernel 8 past).

``--optimizer``, ``--remat`` or ``--softmax`` (``profile_train
.mode_overrides``; the others at their defaults) also time whole steps
of the full-width trainer on ``trainable`` in that mode (v1: the
configuration's batch; v2: 2 rows of ``--seq``): a warm step, then the
median of 3, the peak memory and the kernel launches a step (the
forward's count says whether the remat policy recomputes it), under
``"step"`` in the JSON line; a tree without these modes cannot take
them.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

H, D = 32, 64


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def _v2_metadata(torch, seq: int):
    """The trainable metadata of the Show-o2 stage-1 seeded batch."""
    from showo_tpu_torch.ops.flash_attention import (
        seg_from_modality_positions, span_meta)
    from showo_tpu_torch.profile_train import v2_batch
    from showo_tpu_torch.show_o2.showo2 import Showo2Config

    batch = v2_batch(Showo2Config().num_image_tokens, 2, seq)
    mp = torch.as_tensor(batch["modality_positions"], device="cuda")
    seg = seg_from_modality_positions(mp, seq)
    return list(span_meta(seg, None, None, None, 2, seq, seg.device))


def _metadata(torch, config_name: str):
    """The attention metadata of the configuration's seeded fused batch."""
    from showo_tpu_torch.profile_train import CONFIGS, train_batch
    from showo_tpu_torch.training.train_showo import build_trainer

    trainer = build_trainer(CONFIGS[config_name](), torch.device("cuda"),
                            attn_impl="trainable")
    batch, noise = train_batch(trainer)
    prepared = trainer.step_fn.prepare(*trainer.host_batch(*batch),
                                       noise=noise)
    meta = [m.clone() for m in prepared.attn_meta[1:]]
    del trainer, batch, noise, prepared
    gc.collect()
    torch.cuda.empty_cache()
    return meta


def _time_set(torch, F, tpag, tsag, m, H, Hkv, D) -> dict:
    """The kernel set the dispatcher picks for (H, Hkv, D) at the
    metadata's S, timed: {"kernel", "H", "Hkv", "D", "ms": {...}}."""
    B, S = m[0].shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    if tpag.packed_trainable_fits(S, H, Hkv, D,
                                  min(256, -(-S // 128) * 128)):
        kernel = 7
        kw = dict(num_heads=H, num_kv_heads=Hkv, sm_scale=D ** -0.5)
        fwd, dq, dkv = (tpag.packed_trainable_fwd, tpag.packed_trainable_dq,
                        tpag.packed_trainable_dkv)
        q, k, v, dout = (torch.randn(B, S, n * D, generator=g, device=dev)
                         .bfloat16() for n in (H, Hkv, Hkv, H))
        # kernel 7 reads a tile map since its wgmma cores
        make_tiles = getattr(tpag, "tile_map", None)

        def heads(t):
            return t.unflatten(-1, (-1, D)).transpose(1, 2)

        def delta(o, d):
            return tpag.attention_delta(o, d, H)
    else:
        kernel = 8
        kw = dict(sm_scale=D ** -0.5)
        fwd, dq, dkv = (tsag.streaming_trainable_fwd,
                        tsag.streaming_trainable_dq,
                        tsag.streaming_trainable_dkv)
        q, k, v, dout = (torch.randn(B, S, n, D, generator=g, device=dev)
                         .bfloat16().transpose(1, 2)
                         for n in (H, Hkv, Hkv, H))
        make_tiles = tsag.tile_map
        delta = tsag.attention_delta

        def heads(t):
            return t
    if make_tiles is not None:      # a tree whose kernels read a tile map
        kw["tiles"] = make_tiles(*m)
    out, lse = fwd(q, k, v, *m, **kw)
    a = (q, k, v, dout, lse, delta(out, dout), *m)
    leaves = [heads(t).detach().requires_grad_(True) for t in (q, k, v)]
    mask = tsag.self_visible(*m)[:, None]
    o4 = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                        enable_gqa=Hkv != H)
    ms = {
        "fwd": _time_ms(torch, lambda: fwd(q, k, v, *m, **kw)),
        "dq": _time_ms(torch, lambda: dq(*a, **kw)),
        "dkv": _time_ms(torch, lambda: dkv(*a, **kw)),
        "library_fwd": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, enable_gqa=Hkv != H)),
        "library_bwd": _time_ms(torch, lambda: torch.autograd.grad(
            o4, leaves, heads(dout), retain_graph=True)),
    }
    return {"kernel": kernel, "H": H, "Hkv": Hkv, "D": D, "ms": ms}


def _time_steps(torch, args) -> dict:
    """Three warm steps of the full-width trainer in the mode of
    ``args`` (see the module docstring)."""
    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.profile_train import (CONFIGS, mode_overrides,
                                               train_batch, v2_batch,
                                               v2_trainer)
    from showo_tpu_torch.training.train_showo import build_trainer

    mode = dict(optimizer=args.optimizer or "adamw",
                remat=args.remat or "full", softmax=args.softmax or "fp32")
    overrides = mode_overrides(**mode)
    if args.slice == "v2":
        trainer = v2_trainer("trainable", *overrides)
        batch = v2_batch(trainer.model.cfg.num_image_tokens, 2, args.seq)

        def step():
            return trainer.train_step(batch)
    else:
        trainer = build_trainer(CONFIGS[args.config](*overrides),
                                torch.device("cuda"), attn_impl="trainable")
        batch, noise = train_batch(trainer)

        def step():
            return trainer.train_step(*batch, noise=noise)
    float(step()["loss"])                                    # warm step
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(step()["loss"])
        walls.append(time.perf_counter() - t0)
    out = {**mode, "s": statistics.median(walls), "walls": walls,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_step": {n: c / 3 for n, c in
                                 cuda_build.launches.items() if c}}
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=("stage1", "tuning512"),
                   default="stage1")
    p.add_argument("--slice", choices=("v1", "v2"), default="v1")
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--tag", default="")
    # checked by the trainer the step timing builds
    p.add_argument("--optimizer")
    p.add_argument("--remat")
    p.add_argument("--softmax", choices=("fp32", "bf16"))
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)          # the configs are read relative to the checkout
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_trainable: needs a CUDA card", file=sys.stderr)
        return 2
    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    dev = torch.device("cuda")
    if args.slice == "v2":
        m = _v2_metadata(torch, args.seq)
        shapes = (("qwen", 12, 2, 128), ("dit", 32, 8, 64))
    else:
        m = _metadata(torch, args.config)
        shapes = (("phi", H, H, D),)
    rows = {name: _time_set(torch, F, tpag, tsag, m, h, hkv, d)
            for name, h, hkv, d in shapes}
    B, S = m[0].shape
    steps = (_time_steps(torch, args)
             if args.optimizer or args.remat or args.softmax else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tag": args.tag, "root": root,
                      "config": args.config if args.slice == "v1" else
                      "v2 stage 1", "B": B, "S": S, "shapes": rows,
                      **({"step": steps} if steps else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
