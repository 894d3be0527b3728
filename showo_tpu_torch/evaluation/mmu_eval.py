"""MMU question-answering sweep + scoring on the port's pipelines.

    python -m showo_tpu_torch.evaluation.mmu_eval \\
        config=configs/showo2_1.5b_demo_432x432.yaml v2=1 \\
        eval_jsonl=questions.jsonl image_root=./images outdir=out \\
        [benchmark=mme|pope|gqa|mmmu] [max_items=N] [int8=1] [device=cpu]

Counterpart of ``showo_tpu/evaluation/mmu_eval.py``: run a jsonl of
{image, question, answer} items through an MMU pipeline, write
``predictions_<id>.jsonl`` and ``metrics_<id>.json``, and score them with
exact-match / substring accuracy or, with ``benchmark``, that benchmark's
published protocol (``lmms_benchmarks.py``).  Items are split into
contiguous shards by ``torch.distributed``'s rank and world size when a
process group is initialised (the JAX package's process index and count),
else one shard; explicit ``device_id`` / ``num_devices`` keep their
meaning.  One ``torch.Generator`` seeded ``seed + device_id`` draws for
every item in turn, where JAX splits a key per item.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional

import numpy as np
import torch

from showo_tpu_torch.utils.device import process_grid

logger = logging.getLogger(__name__)


def normalize_answer(text: str) -> str:
    """Lower, strip articles/punctuation/whitespace (VQA-style matching)."""
    text = text.lower().strip()
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    text = re.sub(r"[^a-z0-9 ]", "", text)
    return re.sub(r"\s+", " ", text).strip()


def score_predictions(items) -> dict:
    """items: iterable of {prediction, answer}; returns accuracy dict."""
    n = exact = substr = 0
    for it in items:
        pred = normalize_answer(str(it["prediction"]))
        ans = normalize_answer(str(it["answer"]))
        n += 1
        exact += int(pred == ans)
        substr += int(bool(ans) and ans in pred)
    return {"num": n, "exact_match": exact / max(n, 1),
            "contains": substr / max(n, 1)}


def run_mmu_eval(pipeline, eval_jsonl: str, image_root: str, outdir: str,
                 seed: int = 0, device_id: Optional[int] = None,
                 num_devices: Optional[int] = None,
                 max_items: Optional[int] = None,
                 benchmark: Optional[str] = None) -> dict:
    """pipeline: object with .answer(image_nhwc, question, generator) ->
    token ids and .decode(tokens) -> str (MMUPipeline / MMUV2Pipeline
    shape); images are read at its ``resolution`` (256 without one).
    Writes predictions_<id>.jsonl + metrics_<id>.json under ``outdir``.

    benchmark: None (generic exact/substring scoring) or one of
    "mme" | "pope" | "gqa" | "mmmu" -- scores with that benchmark's
    published protocol (evaluation/lmms_benchmarks.py); items then carry
    the benchmark's extra fields (category/options/...) through."""
    from PIL import Image

    from showo_tpu_torch.utils.image import image_transform

    if device_id is None:
        device_id, num_devices = process_grid()

    with open(eval_jsonl) as f:
        items = [json.loads(l) for l in f if l.strip()]
    if max_items:
        items = items[:max_items]
    items = [items[i] for i in
             np.array_split(np.arange(len(items)), num_devices)[device_id]]

    os.makedirs(outdir, exist_ok=True)
    generator = torch.Generator(
        device=getattr(pipeline, "device", "cpu")).manual_seed(
        seed + device_id)
    preds = []
    for it in items:
        img = image_transform(
            Image.open(os.path.join(image_root, it["image"])).convert("RGB"),
            resolution=getattr(pipeline, "resolution", 256))
        toks = pipeline.answer(img, it["question"], generator)
        text = (pipeline.decode(toks) if hasattr(pipeline, "decode")
                else str(toks))
        preds.append(dict(it, prediction=text,
                          answer=it.get("answer", "")))

    with open(os.path.join(outdir, f"predictions_{device_id}.jsonl"),
              "w") as f:
        for p in preds:
            f.write(json.dumps(p) + "\n")
    scored = [p for p in preds if p["answer"]]
    if benchmark:
        from showo_tpu_torch.evaluation.lmms_benchmarks import score_benchmark

        metrics = score_benchmark(benchmark, scored)
    else:
        metrics = score_predictions(scored)
    with open(os.path.join(outdir, f"metrics_{device_id}.json"), "w") as f:
        json.dump(metrics, f)
    logger.info("mmu eval shard %d: %s", device_id, metrics)
    return metrics


def build_pipeline(config, device=None):
    """The CLI's pipeline: with ``v2=1`` an ``MMUV2Pipeline`` of the Show-o2
    config (``max_new_tokens`` default 100, ``top_k`` default 1, bf16, no
    int8, as the JAX CLI builds it), else v1's
    ``inference_mmu.build_pipeline`` (``int8=1`` honoured).  CUDA unless
    ``device`` names the CPU."""
    if bool(int(config.get("v2", 0))):
        from showo_tpu_torch.inference_t2i_v2 import (load_models,
                                                      load_tokenizer_and_ids)
        from showo_tpu_torch.pipelines.mmu_v2 import MMUV2Pipeline
        from showo_tpu_torch.utils.device import entry_device

        device = entry_device(device)
        tokenizer, token_ids = load_tokenizer_and_ids(config)
        model, vae = load_models(config, device)
        return MMUV2Pipeline(
            model=model, vae=vae, tokenizer=tokenizer, token_ids=token_ids,
            max_new_tokens=int(config.get("max_new_tokens", 100)),
            top_k=int(config.get("top_k", 1)))
    from showo_tpu_torch.inference_mmu import build_pipeline as build_v1

    return build_v1(config, device)


def main(argv=None) -> None:
    """CLI: sweep an eval jsonl through the MMU pipeline and score it
    (module doc); ``argv`` the ``key=value`` arguments, the command line's
    when None; prints the metrics as one JSON line."""
    from showo_tpu_torch.config import get_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    pipe = build_pipeline(config, config.get("device"))
    metrics = run_mmu_eval(
        pipe, str(config["eval_jsonl"]), str(config["image_root"]),
        str(config.get("outdir", "mmu_eval_out")),
        seed=int(config.get("seed", 0)),
        max_items=(int(config["max_items"]) if "max_items" in config
                   else None),
        benchmark=config.get("benchmark"))
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
