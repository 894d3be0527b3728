"""CLI entry: continuous-batching multimodal-understanding serving on
PyTorch.

    # v1 (Show-o / Phi):
    python -m showo_tpu_torch.inference_serve config=configs/showo_demo.yaml \\
        requests=requests.jsonl [out=answers.jsonl] [slots=8] [chunk=16] \\
        [lookahead=4] [int8=1] [kv_int8=1] [spec=2] [max_new_tokens=100]
    # v2 (Show-o2 / Qwen2):
    python -m showo_tpu_torch.inference_serve v2=1 \\
        config=configs/showo2_1.5b_demo_432x432.yaml requests=requests.jsonl

Counterpart of ``showo_tpu/inference_serve.py``: a whole request file
through the slot engine (``serving/``): per-lane KV offsets, one decode
program, lanes refilled the moment a request ends.  ``requests.jsonl``
lines: ``{"image": path, "question": str, "max_new_tokens": int}`` (the
budget optional, the config's ``max_new_tokens`` by default).  Without
``requests=`` it falls back to the understanding CLIs' interface
(``mmu_image_root`` and ``'question=a *** b'``), one request per image
and question.  Answers print in submission order, and go to ``out`` as
jsonl with each request's time to first token.  ``spec=k``: prompt-lookup
speculative decoding (v1 only, as in JAX); ``temperature`` / ``top_k``
(default 1: greedy) / ``top_p``; ``seed``; ``device=cpu``.  The model,
MAGVIT / VAE and tokenizer come from ``inference_mmu.build_pipeline`` /
``inference_mmu_v2.build_pipeline`` (``int8=1``: weight-only int8 on the
int8 kernel).  Runs on CUDA unless ``device=cpu`` asks for the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import List

import torch

from showo_tpu_torch.config import get_config

logger = logging.getLogger(__name__)
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def gather_requests(config) -> List[dict]:
    """The requests of ``config.requests`` (jsonl), else one per image of
    ``mmu_image_root`` (name order) and question of ``question`` split on
    ``' *** '``."""
    if "requests" in config:
        with open(config.requests) as f:
            return [json.loads(line) for line in f if line.strip()]
    root = config.mmu_image_root
    questions = str(config.question).split(" *** ")
    reqs = []
    for fname in sorted(os.listdir(root)):
        if fname.lower().endswith(_IMAGE_EXTS):
            for q in questions:
                reqs.append({"image": os.path.join(root, fname),
                             "question": q})
    return reqs


def _decode_and_emit(config, reqs, handles, eot, decode, dt) -> None:
    total = sum(len(h.tokens) for h in handles)
    logger.info("served %d requests, %d tokens in %.2fs (%.1f tok/s)",
                len(handles), total, dt, total / max(dt, 1e-9))
    out_path = config.get("out", None)
    out_f = open(out_path, "w") if out_path else None
    for r, h in zip(reqs, handles):
        toks = [t for t in h.tokens if t != eot]
        text = decode(toks)
        print(f"[{os.path.basename(r['image'])}] User: {r['question']}\n"
              f" Answer: {text}")
        if out_f:
            out_f.write(json.dumps({
                **{k: r[k] for k in ("image", "question")},
                "answer": text, "tokens": toks,
                "ttft_s": (h.first_token_at - h.submitted_at
                           if h.first_token_at else None)}) + "\n")
    if out_f:
        out_f.close()


def _sampling(config) -> dict:
    return dict(temperature=float(config.get("temperature", 1.0)),
                top_k=(int(config["top_k"]) if "top_k" in config else 1),
                top_p=(float(config["top_p"]) if "top_p" in config else None))


@torch.no_grad()
def main_v2(config) -> None:
    """Show-o2 serving: each request's prompt embeddings assembled as
    ``pipelines/mmu_v2.py`` lays them out, through Showo2MMUServer."""
    from PIL import Image

    from showo_tpu_torch import inference_mmu_v2
    from showo_tpu_torch.pipelines.mmu_v2 import SYSTEM_PROMPT
    from showo_tpu_torch.serving import Showo2MMUServer
    from showo_tpu_torch.show_o2.showo2 import embed_images
    from showo_tpu_torch.utils.image import image_transform

    pipe = inference_mmu_v2.build_pipeline(config, device=config.get("device"))
    dev = pipe.device
    generator = torch.Generator(device=dev).manual_seed(
        int(config.get("seed", 0)))
    default_budget = int(config.get("max_new_tokens", 300))
    res = config.dataset.preprocessing.resolution
    n_img = pipe.cfg.num_image_tokens
    reqs = gather_requests(config)
    if not reqs:
        logger.warning("no requests found")
        return
    # the span starts after [bos] system \nuser\n [boi] and the time row
    img_start = (1 + len(pipe._tok(SYSTEM_PROMPT)) + len(pipe._tok("\nuser\n"))
                 + 2)
    emb_cache: dict = {}
    prompts, budgets = [], []
    for r in reqs:
        path = r["image"]
        if path not in emb_cache:
            img = image_transform(Image.open(path).convert("RGB"), res)
            px = torch.as_tensor(img, device=dev).permute(2, 0, 1)
            latents = pipe.encode(px[None, :, None], generator)[:, :, 0]
            emb_cache[path] = embed_images(pipe.model, latents)
        embeds, _ = pipe.prompt(emb_cache[path], n_img, r["question"])
        prompts.append(embeds[0])
        budgets.append(int(r.get("max_new_tokens", default_budget)))

    slots = int(config.get("slots", 4))
    chunk = int(config.get("chunk", 16))
    lookahead = int(config.get("lookahead", 4))
    lens = sorted(p.shape[0] for p in prompts)
    buckets = sorted({_round_up(lens[len(lens) // 2], 32),
                      _round_up(lens[-1], 32)})
    cap = _round_up(max(p.shape[0] + b for p, b in zip(prompts, budgets))
                    + chunk * lookahead + slots, 64)
    eos = int(pipe.token_ids["eos_id"])
    server = Showo2MMUServer(
        pipe.model, slots=slots, cap=cap, chunk=chunk, buckets=buckets,
        eos_token=eos, lookahead=lookahead,
        kv_int8=bool(int(config.get("kv_int8", 0))), **_sampling(config))
    handles = [server.submit(p, img_start, b)
               for p, b in zip(prompts, budgets)]
    t0 = time.perf_counter()
    server.run(generator)
    _decode_and_emit(config, reqs, handles, eos, pipe.decode,
                     time.perf_counter() - t0)


@torch.no_grad()
def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    from PIL import Image

    from showo_tpu_torch import inference_mmu
    from showo_tpu_torch.serving import ShowoMMUServer
    from showo_tpu_torch.utils.image import image_transform

    config = get_config()
    if bool(int(config.get("v2", 0))):
        return main_v2(config)
    pipe = inference_mmu.build_pipeline(config, device=config.get("device"))
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    default_budget = int(config.get("max_new_tokens", 100))
    res = config.dataset.params.resolution
    reqs = gather_requests(config)
    if not reqs:
        logger.warning("no requests found")
        return

    # [mmu][soi] image codes [eoi][sot] USER: \n<question> ASSISTANT:
    images: dict = {}
    prompts, budgets = [], []
    for r in reqs:
        path = r["image"]
        if path not in images:
            images[path] = image_transform(Image.open(path).convert("RGB"),
                                           res)
        prompts.append(pipe.prompt(images[path], r["question"])[0][0])
        budgets.append(int(r.get("max_new_tokens", default_budget)))

    slots = int(config.get("slots", 8))
    chunk = int(config.get("chunk", 16))
    lookahead = int(config.get("lookahead", 4))
    spec = int(config.get("spec", 0))   # prompt-lookup draft length
    lens = sorted(len(p) for p in prompts)
    buckets = sorted({_round_up(lens[len(lens) // 2], 32),
                      _round_up(lens[(3 * len(lens)) // 4], 32),
                      _round_up(lens[-1], 32)})
    # + slots: fused admissions advance decode between windows (the
    # engine's margin, serving/engine.py::_fill_slots)
    cap = _round_up(max(len(p) + b for p, b in zip(prompts, budgets))
                    + chunk * lookahead * (spec + 1) + slots, 64)
    eot = int(pipe.uni_prompting.sptids["<|eot|>"])
    server = ShowoMMUServer(
        pipe.model, slots=slots, cap=cap, chunk=chunk, buckets=buckets,
        eot_token=eot, lookahead=lookahead, speculative_k=spec,
        kv_int8=bool(int(config.get("kv_int8", 0))), **_sampling(config))
    handles = [server.submit(p, b) for p, b in zip(prompts, budgets)]
    t0 = time.perf_counter()
    server.run(generator)
    _decode_and_emit(config, reqs, handles, eot, pipe.decode,
                     time.perf_counter() - t0)


if __name__ == "__main__":
    main()
