"""Where one Show-o2 stage-2a step's ``trainable`` route departs from
``dense``: the same prepared batch through each attention route, every
result held to the dense step in fp32 (autocast off).

    python3 -m showo_tpu_torch.probe_stage2_parity [--family 1.5b 7b] \
        [--rows 4] [--steps 0 4] [--out FILE.json]

Run from the repository's root (it reads ``chip_smoke.py``'s stage-2 data
and model families).  For each family the full-width stage-2a trainer
(``configs/showo2_<size>_stage_2_a.yaml``, the 2a freeze) is built on
random weights from its seeds, one batch of the CLI's loader is prepared
(``rows`` t2i and ``rows`` conversation rows of 1024 at 432x432, noise
from seed 33), and one step's losses and gradients of the trained
parameters are taken on these routes of the attention, on the weights as
built and after each count of ``--steps`` optimizer steps on the same
batch (``chip_smoke.py``'s phases 32 and 37d read theirs after 4: a warm
step with noise from seed 32, then three from seed 24):

- ``kernel``: the trainable route as dispatched (kernel 7 within
  ``packed_trainable_fits``, kernel 8 past it);
- ``kernel7`` / ``kernel8``: every trainable attention on kernel 7 (the
  budget lifted) or on kernel 8 (the budget 0);
- ``plain``: the trainable algorithm through the kernels' plain versions
  on the card (kernel 8's wrappers as for CPU tensors): what the kernels
  are held to, rounding included;
- ``planted``: kernel 8 with a fault planted in its dk / dv: the last q
  head of every GQA group left out of the group's sum (at group 7 the
  single-head last slice of kernel 6's plan);
- ``dense`` in bf16 and ``fp32`` (autocast off) through the einsum
  attention under the additive mask.

Printed (and written to ``--out`` as JSON when given): each route's
losses and grad norm, the relative difference of each from ``dense`` and
from ``fp32``, and the relative distance of the gradient vectors ||g -
g_ref|| / ||g_ref||.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

NAMES = ("loss", "loss_ntp", "loss_flow", "grad_norm")
CONFIGS = {"1.5b": "configs/showo2_1.5b_stage_2_a.yaml",
           "7b": "configs/showo2_7b_stage_2_a.yaml"}


@contextlib.contextmanager
def _route(route):
    """Patch the trainable attention's dispatch for ``route``."""
    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops import streaming_attention_grad as sag

    saved = (tpag.PACKED_TRAINABLE_MAX_BYTES, sag._device,
             sag.streaming_trainable_dkv)
    if route == "kernel7":
        tpag.PACKED_TRAINABLE_MAX_BYTES = 1 << 40
    elif route in ("kernel8", "plain", "planted"):
        tpag.PACKED_TRAINABLE_MAX_BYTES = 0
    if route == "plain":
        sag._device = lambda q: "cpu"
    if route == "planted":
        dkv = saved[2]

        def planted(q, k, v, dout, *args, **kw):
            G = q.shape[1] // k.shape[1]
            keep = [h % G != G - 1 for h in range(q.shape[1])]
            keep = q.new_tensor(keep).view(1, -1, 1, 1)
            return dkv((q * keep).contiguous(), k, v,
                       (dout * keep).contiguous(), *args, **kw)
        sag.streaming_trainable_dkv = planted
    try:
        yield
    finally:
        (tpag.PACKED_TRAINABLE_MAX_BYTES, sag._device,
         sag.streaming_trainable_dkv) = saved


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a - b)


def probe(torch, family, rows, steps=(0,)):
    import chip_smoke as cs
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.inference_t2i_v2 import load_tokenizer_and_ids
    from showo_tpu_torch.show_o2 import train_stage_two as t2
    from showo_tpu_torch.show_o2.masks import omni_attn_mask

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = load_config(CONFIGS[family], cs._stage2_data(tmp) + [
            f"training.batch_size_t2i={rows}",
            f"training.batch_size_mmu={rows}"])
        trainer = t2.build_trainer(config, torch.device("cuda"),
                                   attn_impl="trainable")
        tok, ids = load_tokenizer_and_ids(config)
        batch = next(iter(t2.build_stage2_loader(config, tok, ids,
                                                 trainer.model)))
    step = trainer.step_fn
    c = trainer.model.cfg.llm
    print(f"[{family}] stage-2a trainer, Qwen {c.num_heads}/"
          f"{c.num_kv_heads} heads of {c.head_dim}, width {c.hidden_size}; "
          f"{2 * rows} rows; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out, taken = {}, 0
    for n in sorted(steps):
        for i in range(taken, n):
            trainer.train_step(batch, torch.Generator(device="cuda")
                               .manual_seed(32 if i == 0 else 24))
        taken = n
        prepared = step.prepare(trainer.device_batch(batch), torch.Generator(
            device="cuda").manual_seed(33))
        dense = dataclasses.replace(
            prepared, attn_meta=None, bias=omni_attn_mask(
                prepared.modality_positions, prepared.text_tokens.shape[1]))
        out[f"after_{n}_steps"] = _routes(torch, step, prepared, dense,
                                          f"{family}, {n} steps")
    trainer = step = prepared = dense = None
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _routes(torch, step, prepared, dense, tag):
    """One step's losses and gradients on every route of the probe."""
    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.training.train_step import global_norm

    routes = ["fp32", "dense", "kernel", "kernel7", "kernel8", "plain",
              "planted"]
    got, grads = {}, {}
    for route in routes:
        b = dense if route in ("fp32", "dense") else prepared
        cast = step.autocast_dtype
        if route == "fp32":
            step.autocast_dtype = None
        cuda_build.launches.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        try:
            with _route(route):
                total, parts, g = step.loss_and_grads(b)
            torch.cuda.synchronize()
        finally:
            step.autocast_dtype = cast
        flat = torch.cat([x.float().reshape(-1) for x in g])
        got[route] = {"values": [float(x) for x in (total, *parts,
                                                    global_norm(g))],
                      "s": time.perf_counter() - t1,
                      "launches": {n: k for n, k in
                                   cuda_build.launches.items() if k}}
        grads[route] = flat
        del g
        gc.collect()
    out = {}
    for route, r in got.items():
        r = dict(r)
        for ref in ("fp32", "dense"):
            if route != ref:
                r[f"rel_vs_{ref}"] = {n: _rel(a, b) for n, a, b in zip(
                    NAMES, r["values"], got[ref]["values"])}
                r[f"grad_vs_{ref}"] = float(
                    (grads[route] - grads[ref]).norm() / grads[ref].norm())
        out[route] = r
        print(f"[{tag}] {route:8s} " + ", ".join(
            f"{n} {x:.6f}" for n, x in zip(NAMES, r["values"]))
            + "".join(f"; vs {ref}: " + ", ".join(
                f"{n} {v:.2e}" for n, v in r[f"rel_vs_{ref}"].items())
                + f", grad vector {r[f'grad_vs_{ref}']:.2e}"
                for ref in ("fp32", "dense") if f"rel_vs_{ref}" in r)
            + f"; {r['s']:.2f} s; launches {r['launches']}", flush=True)
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", nargs="+", default=["1.5b", "7b"],
                   choices=sorted(CONFIGS))
    p.add_argument("--rows", type=int, default=4)
    p.add_argument("--steps", type=int, nargs="+", default=[0])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_stage2_parity: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = {"device": smi, "rows": args.rows}
    for family in args.family:
        result[family] = probe(torch, family, args.rows, args.steps)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({f: {n: {r: {k: v[k] for k in v if k != "launches"}
                              for r, v in res.items()}
                          for n, res in result[f].items()}
                      for f in args.family}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
