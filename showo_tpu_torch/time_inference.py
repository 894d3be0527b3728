"""Times of the inference attention kernels 5 (``streaming``), 3
(``decode``), 1 (``packed``), 4 (``omni``) and 2 (``fused``) at the v1
512x512 cached step, of kernels 1 and 6 at the Show-o2 432x432 rows, and
of the decode gemv of kernels 9-11 at M=1, on one card, for holding two
trees side by side in one call.

    python3 showo_tpu_torch/time_inference.py [--root DIR] [--tag NAME]

``--root`` names the checkout whose ``showo_tpu_torch`` is imported (by
default this file's own), so that one call on one card can time a parent
tree beside its change in turns (parent, change, change, parent), each
building its own kernels into its own ``_build``.  The shapes and
metadata are those of ``chip_smoke.py`` phase 3: the t2i layout of the
512x512 config's first two prompts with CFG (B=4, P=129 prefix rows,
Q=1026 fresh rows, K=1155), H=32, D=64, seeded bf16 q/k/v as transposed
[B, S, H, D] views (kernels 5 and 4), [B, S, H, D] tensors (kernel 3,
whose bias is the cached step's [B, 1, Q, K] view of the omni mask),
[B, S, H*D] (kernel 1), and for kernel 2 a full-width ``win`` output y
[B, Q, 14336] with the prefix K / V as views of a cache.  Timed,
CUDA-event medians of 20 with the wrapper: each kernel on a tile map
made beforehand where the tree's wrapper takes one (as a forward of 24
layers makes it once), the map itself, kernel 2's two launches apart
where the tree has them (``fused_norm_rope``, ``fused_core``), and
``scaled_dot_product_attention`` with the same mask (for kernel 2's core
on the normed q / k).  Then, as ``chip_smoke.py`` phase 3c, kernel 1 and
kernel 6 (``omni_attention_packed(gqa_stack=True)``) on one tile map at
the Show-o2 slice's rows (B=8, S=768, the config's first four prompts
with CFG) for Qwen2.5 (12 q / 2 kv heads of 128) and the DiT (32 / 8 of
64), with the wrapper and as device time a launch (profiler, mean of
20); and as phase 9, the int8 and int4 gemv at M=1 at win / wout /
lm_head, device time a product with the weights rotating through copies
that exceed the L2 twice.  Prints the card and one JSON line.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys

P, H, D, BATCH = 129, 32, 64, 2
V2_CONFIG, V2_BATCH = "configs/showo2_1.5b_demo_432x432.yaml", 4
V2_SHAPES = (("qwen", 12, 2, 128), ("dit", 32, 8, 64))
GEMV_SHAPES = {"win": (2048, 14336), "wout": (10240, 2048),
               "lm_head": (2048, 58498)}
L2_BYTES = 50e6


def _device_ms(torch, fn, iters: int = 20):
    """Mean device time a call of the kernels ``fn`` launches
    (torch.profiler); None where the trace lost device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == cuda]
    if len(kernels) < iters:
        return None
    return sum(e.time_range.end - e.time_range.start
               for e in kernels) / 1e3 / iters


def _v2_times(torch, dev, time_ms):
    """Kernels 1 and 6 at the Show-o2 slice's rows: {name: ms}."""
    import types

    import torch.nn.functional as F

    from showo_tpu_torch import inference_t2i_v2
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.pipelines.t2i_v2 import T2IV2Pipeline

    config = load_config(V2_CONFIG)
    tokenizer, ids = inference_t2i_v2.load_tokenizer_and_ids(config)
    layout = types.SimpleNamespace(
        token_ids=ids, tokenizer=tokenizer, guidance_scale=7.5,
        cfg=inference_t2i_v2.build_showo2_config(config), device=dev,
        max_text_len=int(config.dataset.preprocessing.get("max_text_len",
                                                          256)))
    text, mp = T2IV2Pipeline.build_inputs(
        layout, inference_t2i_v2.load_prompts(config)[:V2_BATCH])
    B, L = text.shape
    meta = tfa.span_meta(tfa.seg_from_modality_positions(mp, L), None, None,
                         None, B, L, dev)
    pos_q, seg_q = tfa.q_rows(meta[0], torch.arange(L, device=dev), B, L)
    tiles = tfa.rows_tile_map(*meta, pos_q, seg_q)
    vis = tfa.visible_mask(*meta, pos_q)[:, None]
    g = torch.Generator(device=dev).manual_seed(31)
    ms = {"v2_rows": [B, L]}
    for name, h, hkv, d in V2_SHAPES:
        q, k, v = (torch.randn(B, L, n * d, generator=g, device=dev)
                   .bfloat16() for n in (h, hkv, hkv))
        kw = dict(num_heads=h, num_kv_heads=hkv, q_positions=pos_q,
                  seg_q=seg_q, tiles=tiles)
        heads = [t.unflatten(-1, (-1, d)).transpose(1, 2) for t in (q, k, v)]
        calls = {
            "packed": lambda: tfa.omni_attention_packed(q, k, v, *meta, **kw),
            "stacked": lambda: tfa.omni_attention_packed(
                q, k, v, *meta, gqa_stack=True, **kw),
            "library": lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=vis, enable_gqa=True)}
        for which, fn in calls.items():
            ms[f"v2_{name}_{which}"] = time_ms(torch, fn)
            ms[f"v2_{name}_{which}_device"] = _device_ms(torch, fn)
        ms[f"v2_{name}_stacked_diff"] = (
            calls["stacked"]().float() - calls["packed"]().float()
        ).abs().max().item()
    return ms


def _gemv_times(torch, dev):
    """The decode gemv at M=1, int8 and int4: {name: device ms}."""
    from showo_tpu_torch.ops import int4_matmul as ti4
    from showo_tpu_torch.ops import int8_matmul as ti8

    g = torch.Generator(device=dev).manual_seed(91)
    ms = {}
    for fmt, kern in (("int8", ti8.pallas_i8_matmul),
                      ("int4", ti4.pallas_nib_matmul)):
        for name, (K, N) in GEMV_SHAPES.items():
            rows = K // 2 if fmt == "int4" else K
            padded = -(-N // 16) * 16
            copies = max(1, -(-int(2 * L2_BYTES) // (rows * N)))
            ws = [torch.randint(-127, 128, (rows, padded), generator=g,
                                device=dev, dtype=torch.int8)[:, :N]
                  for _ in range(copies)]
            x = torch.randn(1, K, generator=g, device=dev).bfloat16()
            s = (torch.rand(1, N, generator=g, device=dev) * 0.01
                 + 1e-3).bfloat16()
            turn = iter(range(10 ** 9))
            ms[f"gemv_{fmt}_{name}_device"] = _device_ms(
                torch, lambda: kern(x, ws[next(turn) % copies], s))
            del ws
    return ms


def _layout(torch, np, dev):
    """[cond | uncond] token rows of the 512x512 t2i layout and the
    special token ids (pad, soi, eoi)."""
    from showo_tpu_torch import inference_t2i
    from showo_tpu_torch.config import load_config

    config = load_config("configs/showo_demo_512x512.yaml",
                         ["guidance_scale=1.75", "generation_timesteps=16"])
    prompts = inference_t2i.load_prompts(config)[:BATCH]
    uni = inference_t2i.build_prompting(config)
    cfg = inference_t2i.build_showo_config(config)
    img = np.full((BATCH, cfg.num_vq_tokens), cfg.mask_token_id, np.int64)
    ids, _ = uni((prompts, img), "t2i_gen")
    unc, _ = uni(([""] * BATCH, img), "t2i_gen")
    sp = uni.sptids
    return (torch.as_tensor(np.concatenate([ids, unc]), device=dev),
            (sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--tag", default="")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)          # the configs are read relative to the checkout
    sys.path.insert(0, root)

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_inference: needs a CUDA card", file=sys.stderr)
        return 2
    from showo_tpu_torch.models.phi import rope_tables
    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.ops import decode_attention as tda
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import fused_decode as tfd
    from showo_tpu_torch.ops import streaming_attention as tsa
    from showo_tpu_torch.ops.masks import omni_mask_predict_next
    from showo_tpu_torch.time_trainable import _time_ms

    dev = torch.device("cuda")
    # every kernel source this script reaches, built at once
    cuda_build.load_libraries([
        "streaming_attention", "decode_attention", "omni_attention_packed",
        "omni_attention", "fused_decode", "omni_attention_gqa_stacked",
        "int8_matmul", "int4_matmul"])
    full, ids = _layout(torch, np, dev)
    B, L = full.shape
    Q = L - P
    meta = tfa.metadata_predict_next(full, *ids)
    pos_q, seg_q = tfa.q_rows(meta[0], torch.arange(P, L, device=dev), B, Q)
    mask = tfa.visible_mask(*meta, pos_q)[:, None]
    bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
    bias = bias[:, :, P:, :]
    bias16 = bias.to(torch.bfloat16)       # the library's mask, cast once
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(B, n, H, D, generator=g, device=dev).bfloat16()
               for n in (Q, L, L))
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    packed = [t.flatten(2) for t in (q, k, v)]

    def takes_tiles(fn):
        return "tiles" in inspect.signature(fn).parameters

    # kernels 5 and 3, each on its map where the tree's wrapper takes one
    kw5, kw3 = dict(q_positions=pos_q, seg_q=seg_q), {}
    make5 = make3 = None
    if takes_tiles(tsa.omni_attention_streaming):
        make5 = functools.partial(tsa.streaming_tile_map, *meta, pos_q, seg_q)
        kw5["tiles"] = make5()
    if takes_tiles(tda.decode_attention):
        make3 = functools.partial(tda.bias_tile_map, bias)
        kw3["tiles"] = make3()
    tiles1 = tfa.rows_tile_map(*meta, pos_q, seg_q)
    kw4, make4 = dict(q_positions=pos_q, seg_q=seg_q), None
    if takes_tiles(tfa.omni_attention):
        make4 = functools.partial(tfa.omni_tile_map, *meta, pos_q, seg_q)
        kw4["tiles"] = make4()
    # kernel 2: y a full-width win output, ck / cv views of a cache
    hidden = H * D
    y = torch.randn(B, Q, 3 * hidden + 8192, generator=g,
                    device=dev).bfloat16()
    cache = torch.randn(2, B, L, H, D, generator=g, device=dev).bfloat16()
    ck, cv = cache[0, :, :P].flatten(2), cache[1, :, :P].flatten(2)
    ln = [(1 + 0.1 * torch.randn(D, generator=g, device=dev)).bfloat16(),
          (0.1 * torch.randn(D, generator=g, device=dev)).bfloat16()]
    pos = torch.arange(P, L, device=dev)
    cos, sin = rope_tables(pos, 32, 10000.0)
    rows = tfd.fused_rows(meta[0], meta[1], pos, P, B)
    kw2 = dict(hidden=hidden, num_heads=H, rotary_dim=32, rows=rows)
    make2 = None
    if takes_tiles(tfd.fused_decode_attention):
        make2 = functools.partial(tfd.fused_tile_map, rows, meta[2], meta[3])
        kw2["tiles"] = make2()
    ms = {
        "streaming": _time_ms(torch, lambda: tsa.omni_attention_streaming(
            *heads, *meta, **kw5)),
        "streaming_map": _time_ms(torch, make5) if make5 else None,
        "decode": _time_ms(torch, lambda: tda.decode_attention(
            q, k, v, bias, **kw3)),
        "decode_map": _time_ms(torch, make3) if make3 else None,
        "packed": _time_ms(torch, lambda: tfa.omni_attention_packed(
            *packed, *meta, num_heads=H, q_positions=pos_q, seg_q=seg_q,
            tiles=tiles1)),
        "omni": _time_ms(torch, lambda: tfa.omni_attention(
            *heads, *meta, **kw4)),
        "omni_map": _time_ms(torch, make4) if make4 else None,
        "fused": _time_ms(torch, lambda: tfd.fused_decode_attention(
            y, ck, cv, ln, ln, cos, sin, *meta, pos, **kw2)),
        "fused_map": _time_ms(torch, make2) if make2 else None,
        "library_mask": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            *heads, attn_mask=mask)),
        "library_bias": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            *heads, attn_mask=bias16)),
    }
    if hasattr(tfd, "norm_rope"):
        # kernel 2's two launches apart, and the library on the core's part
        part = dict(hidden=hidden, num_heads=H)
        qn, kn = tfd.norm_rope(y, ln, ln, cos, sin, **part)
        fresh = [t.unflatten(-1, (H, D)).transpose(1, 2) for t in (
            qn, torch.cat([ck, kn], 1),
            torch.cat([cv, y[..., 2 * hidden:3 * hidden]], 1))]
        vis2 = tfa.visible_mask(rows[3], rows[4], meta[2], meta[3], rows[0],
                                pos_k=rows[2], seg_q=rows[1])[:, None]
        ms.update({
            "fused_norm_rope": _time_ms(torch, lambda: tfd.norm_rope(
                y, ln, ln, cos, sin, **part)),
            "fused_core": _time_ms(torch, lambda: tfd.fused_attend(
                qn, kn, y, ck, cv, meta[2], meta[3], rows, kw2["tiles"],
                **part)),
            "library_fused_core": _time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *fresh, attn_mask=vis2)),
        })
    ms.update(_v2_times(torch, dev, _time_ms))
    ms.update(_gemv_times(torch, dev))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tag": args.tag, "root": root, "B": B, "Q": Q, "K": L,
                      "H": H, "D": D, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
