"""Times of the inference attention kernels 5 (``streaming``), 3
(``decode``), 1 (``packed``), 4 (``omni``) and 2 (``fused``) at the v1
512x512 cached step on one card, for holding two trees side by side in
one call.

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
on the normed q / k).  Prints the card and one JSON line.  Needs a CUDA
card.
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
    from showo_tpu_torch.ops import decode_attention as tda
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import fused_decode as tfd
    from showo_tpu_torch.ops import streaming_attention as tsa
    from showo_tpu_torch.ops.masks import omni_mask_predict_next
    from showo_tpu_torch.time_trainable import _time_ms

    dev = torch.device("cuda")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tag": args.tag, "root": root, "B": B, "Q": Q, "K": L,
                      "H": H, "D": D, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
