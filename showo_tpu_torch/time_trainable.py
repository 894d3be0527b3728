"""Times of the trainable attention kernels at a training configuration's
fused batch on one card, for holding two trees side by side in one call.

    python3 showo_tpu_torch/time_trainable.py --config stage1|tuning512 \
        [--root DIR] [--tag NAME]

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
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=("stage1", "tuning512"),
                   default="stage1")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--tag", default="")
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
    m = _metadata(torch, args.config)
    B, S = m[0].shape
    g = torch.Generator(device=dev).manual_seed(7)
    if tpag.packed_trainable_fits(S, H, H, D, min(256, -(-S // 128) * 128)):
        kernel = 7
        kw = dict(num_heads=H, num_kv_heads=H, sm_scale=D ** -0.5)
        fwd, dq, dkv = (tpag.packed_trainable_fwd, tpag.packed_trainable_dq,
                        tpag.packed_trainable_dkv)
        q, k, v, dout = (torch.randn(B, S, H * D, generator=g, device=dev)
                         .bfloat16() for _ in range(4))
        # kernel 7 reads a tile map since its wgmma cores
        make_tiles = getattr(tpag, "tile_map", None)

        def heads(t):
            return t.unflatten(-1, (H, D)).transpose(1, 2)

        def delta(o, d):
            return tpag.attention_delta(o, d, H)
    else:
        kernel = 8
        kw = dict(sm_scale=D ** -0.5)
        fwd, dq, dkv = (tsag.streaming_trainable_fwd,
                        tsag.streaming_trainable_dq,
                        tsag.streaming_trainable_dkv)
        q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=dev)
                         .bfloat16().transpose(1, 2) for _ in range(4))
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
    o4 = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    ms = {
        "fwd": _time_ms(torch, lambda: fwd(q, k, v, *m, **kw)),
        "dq": _time_ms(torch, lambda: dq(*a, **kw)),
        "dkv": _time_ms(torch, lambda: dkv(*a, **kw)),
        "library_fwd": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask)),
        "library_bwd": _time_ms(torch, lambda: torch.autograd.grad(
            o4, leaves, heads(dout), retain_graph=True)),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tag": args.tag, "root": root, "config": args.config,
                      "kernel": kernel, "B": B, "S": S, "H": H, "D": D,
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
