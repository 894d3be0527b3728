"""DPG-Bench VQA scoring harness on the port
(show-o2/evaluation/compute_dpg_bench.py:1-256 equivalent).

Copy of ``showo_tpu/evaluation/dpg_bench.py``, quirks included: the csv's
first data row is skipped (the reference's ``iterrows`` i == 0 check), and
``MMUPipelineScorer`` maps the first word of an answer to "yes" or keeps
it.  The sweep half (image generation over the DPG prompt set) is
``geneval.py:run_dpg_sweep``; this module scores the generated grids:
parse the dpg_bench.csv question table, ask a VQA model every proposition
question on each crop of the generated 2x2 grid, zero out answers whose
parent propositions failed (dependency chains), and report per-category
(L1/L2) and overall scores.

The VQA scorer is pluggable: any callable ``scorer(pil_image, question)
-> str`` works.  ``MPLUGScorer`` wraps the reference's modelscope mPLUG
checkpoint when available; ``MMUPipelineScorer`` self-evaluates with the
port's own MMU pipeline, drawing from one ``torch.Generator`` where JAX
splits a key per question.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from showo_tpu_torch.utils.device import process_grid

logger = logging.getLogger(__name__)


def prepare_dpg_data(csv_path: str) -> Dict[str, dict]:
    """Parse dpg_bench.csv into {item_id: {qid2tuple, qid2dependency,
    qid2question}} (compute_dpg_bench.py:64-100).  The reference skips the
    csv's first data row (an artifact of its iterrows i==0 check) — kept
    for score parity."""
    question_dict: Dict[str, dict] = {}
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    for i, line in enumerate(rows):
        if i == 0:
            continue
        item_id = line["item_id"]
        qid = int(line["proposition_id"])
        deps = [int(d.strip()) for d in line["dependency"].split(",")]
        entry = question_dict.setdefault(
            item_id, {"qid2tuple": {}, "qid2dependency": {},
                      "qid2question": {}})
        entry["qid2tuple"][qid] = line["tuple"]
        entry["qid2dependency"][qid] = deps
        entry["qid2question"][qid] = line["question_natural_language"]
    return question_dict


def _grid_crops(resolution: int, pic_num: int):
    crops = [
        (0, 0, resolution, resolution),
        (resolution, 0, resolution * 2, resolution),
        (0, resolution, resolution, resolution * 2),
        (resolution, resolution, resolution * 2, resolution * 2),
    ]
    return crops[:pic_num]


def compute_dpg_one_sample(question_dict: Dict[str, dict], image_path: str,
                           scorer: Callable, resolution: int,
                           pic_num: int = 1, detail_log=None):
    """Score one generated grid (compute_dpg_bench.py:107-162): per crop,
    VQA every question ('yes' == 1), then zero scores whose dependency
    parents scored 0."""
    from PIL import Image

    image = Image.open(image_path)
    key = os.path.basename(image_path).split(".")[0]
    value = question_dict[key]
    qid2question = value["qid2question"]
    qid2dependency = value["qid2dependency"]

    scores = []
    qid2scores_orig: Dict[int, float] = {}
    for crop in _grid_crops(resolution, pic_num):
        cropped = image.crop(crop)
        qid2scores: Dict[int, float] = {}
        for qid, question in qid2question.items():
            answer = scorer(cropped, question)
            qid2scores[qid] = float(answer == "yes")
            if detail_log is not None:
                detail_log.write(f"{image_path}, {crop}, {question}, "
                                 f"{answer}\n")
        qid2scores_orig = qid2scores.copy()
        for qid, parents in qid2dependency.items():
            if any(p != 0 and qid2scores[p] == 0 for p in parents):
                qid2scores[qid] = 0.0
        scores.append(sum(qid2scores.values()) / len(qid2scores))
    return sum(scores) / len(scores), value["qid2tuple"], qid2scores_orig


def run_dpg_scoring(image_root: str, csv_path: str, scorer: Callable,
                    resolution: int, pic_num: int = 1,
                    res_path: Optional[str] = None,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> dict:
    """Score every image under image_root; returns {score, l1, l2, n}.

    Sharding mirrors the reference's contiguous rank split
    (compute_dpg_bench.py:190-193): pass process_index/count (defaults to
    torch.distributed's rank and world size, or 0 / 1 without a process
    group) and reduce the per-process result dicts offline.
    """
    if process_index is None:
        process_index, process_count = process_grid()

    question_dict = prepare_dpg_data(csv_path)
    files = sorted(os.listdir(image_root))
    per = len(files) / max(process_count, 1)
    files = files[round(process_index * per):
                  round((process_index + 1) * per)]

    if res_path is None:
        res_path = os.path.join(image_root, "dpg_results.txt")
    detail = open(res_path.replace(".txt", "_detail.txt"), "a")

    scores: List[float] = []
    cat2scores = defaultdict(list)
    with open(res_path, "a") as res:
        for fn in files:
            path = os.path.join(image_root, fn)
            try:
                score, qid2tuple, qid2scores = compute_dpg_one_sample(
                    question_dict, path, scorer, resolution, pic_num,
                    detail_log=detail)
            except Exception as e:  # failed sample: skip (ref :214-216)
                logger.warning("DPG failed on %s: %s", fn, e)
                continue
            scores.append(score)
            res.write(f"{path}, {score}\n")
            for qid, tup in qid2tuple.items():
                cat2scores[tup.split("(")[0].strip()].append(
                    qid2scores[qid])
    detail.close()

    l2 = {c: float(np.mean(v)) * 100 for c, v in cat2scores.items()}
    l1_acc = defaultdict(list)
    for c, v in cat2scores.items():
        l1_acc[c.split("-")[0].strip()].extend(v)
    l1 = {c: float(np.mean(v)) * 100 for c, v in l1_acc.items()}
    out = {"score": float(np.mean(scores)) * 100 if scores else 0.0,
           "l1": l1, "l2": l2, "n": len(scores)}
    with open(res_path, "a") as res:
        res.write(f"DPG-Bench score: {out['score']}\n")
    logger.info("DPG-Bench score %.2f over %d images", out["score"],
                out["n"])
    return out


class MPLUGScorer:
    """The reference's mPLUG VQA scorer (compute_dpg_bench.py:52-63);
    requires the external modelscope package + checkpoint."""

    def __init__(self, ckpt="damo/mplug_visual-question-answering_coco_large_en",
                 device="cpu"):
        from modelscope.pipelines import pipeline
        from modelscope.utils.constant import Tasks

        self._pipe = pipeline(Tasks.visual_question_answering, model=ckpt,
                              device=device)

    def __call__(self, image, question: str) -> str:
        return self._pipe({"image": image, "question": question})["text"]


class MMUPipelineScorer:
    """Self-evaluation scorer: answer DPG questions with the port's own MMU
    pipeline (``answer(pixels, question, generator)``); free-form answers
    are normalized to yes/no by first word (DPG questions are yes/no
    propositions).  One ``torch.Generator`` (seed 0 on the pipeline's
    device unless given) draws for every question in turn."""

    def __init__(self, mmu_pipeline, tokenizer, resolution: int = 256,
                 generator=None):
        import torch

        self.pipe = mmu_pipeline
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.generator = generator if generator is not None else (
            torch.Generator(device=mmu_pipeline.device).manual_seed(0))

    def __call__(self, image, question: str) -> str:
        from showo_tpu_torch.utils.image import image_transform

        pixels = image_transform(image.convert("RGB"), self.resolution)
        ids = self.pipe.answer(pixels, question, self.generator)
        text = self.tokenizer.decode(ids).strip().lower()
        first = text.split()[0].strip(".,!") if text.split() else ""
        return "yes" if first == "yes" else first or "no"
