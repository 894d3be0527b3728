"""Benchmark-faithful MMU scorers: MME, POPE, GQA, MMMU.

Copy of ``showo_tpu/evaluation/lmms_benchmarks.py`` (the port never
imports the JAX package), quirks included, so that scores stay comparable
with the reference's: ``parse_yes_no`` takes the first standalone yes / no
anywhere in the reply, and MME's acc+ groups by ``question_id`` before
``image``.  Each benchmark's published scoring protocol, as lmms-eval
computes it:

  * MME  -- per-question accuracy AND per-image "accuracy+" (both of the
    image's two questions correct); subtask score = (acc + acc+) * 100,
    the total the sum over the subtasks;
  * POPE -- yes/no accuracy, precision, recall, F1 (positive class
    "yes") and the yes-ratio diagnostic;
  * GQA  -- exact match on the normalized short answer;
  * MMMU -- multiple-choice letter accuracy with lmms-eval's fallback
    parsing (explicit letter, else unique option-text containment, else
    wrong).

Items are plain dicts (an adapter away from any storage format):
  MME:  {question_id|image, question, answer: yes|no, prediction,
         category}
  POPE: {answer: yes|no, prediction}
  GQA:  {answer, prediction}
  MMMU: {answer: letter, options: [str], prediction}
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence


def parse_yes_no(text: str) -> str:
    """lmms-eval MME/POPE answer parsing: first standalone yes/no wins;
    anything else is 'other' (counted wrong)."""
    t = str(text).lower().strip()
    # common listy/punctuated forms first
    m = re.search(r"\b(yes|no)\b", t)
    return m.group(1) if m else "other"


def score_mme(items: Iterable[dict]) -> Dict[str, dict]:
    """Returns per-category {acc, acc_plus, score} plus 'total' (sum of
    category scores).  acc+ requires BOTH questions of an image right —
    items are grouped by question_id/image."""
    by_cat: Dict[str, List[dict]] = defaultdict(list)
    for it in items:
        by_cat[str(it.get("category", "default"))].append(it)
    out: Dict[str, dict] = {}
    total = 0.0
    for cat, its in by_cat.items():
        per_image: Dict[str, List[bool]] = defaultdict(list)
        correct = 0
        for it in its:
            ok = parse_yes_no(it["prediction"]) == str(it["answer"]).lower()
            correct += int(ok)
            img = str(it.get("question_id", it.get("image", "")))
            per_image[img].append(ok)
        acc = correct / max(len(its), 1)
        plus = sum(all(v) for v in per_image.values()) / max(len(per_image), 1)
        score = (acc + plus) * 100.0
        out[cat] = {"acc": acc, "acc_plus": plus, "score": score,
                    "num": len(its)}
        total += score
    out["total"] = {"score": total}
    return out


def score_pope(items: Iterable[dict]) -> dict:
    """Accuracy / precision / recall / F1 with 'yes' as the positive
    class + yes-ratio (POPE paper table protocol)."""
    tp = fp = tn = fn = yes = n = 0
    for it in items:
        pred = parse_yes_no(it["prediction"])
        gold = str(it["answer"]).lower().strip()
        n += 1
        yes += int(pred == "yes")
        if gold == "yes":
            tp += int(pred == "yes")
            fn += int(pred != "yes")
        else:
            fp += int(pred == "yes")
            tn += int(pred != "yes")
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"accuracy": (tp + tn) / max(n, 1), "precision": prec,
            "recall": rec, "f1": f1, "yes_ratio": yes / max(n, 1), "num": n}


def _gqa_normalize(text: str) -> str:
    t = str(text).lower().strip().rstrip(".")
    t = re.sub(r"^(the|a|an)\s+", "", t)
    return t.strip()


def score_gqa(items: Iterable[dict]) -> dict:
    """GQA official: exact match of the normalized short answer."""
    n = ok = 0
    for it in items:
        n += 1
        ok += int(_gqa_normalize(it["prediction"])
                  == _gqa_normalize(it["answer"]))
    return {"accuracy": ok / max(n, 1), "num": n}


_LETTER = re.compile(r"\b([A-J])\b")


def parse_multi_choice(prediction: str, options: Sequence[str]) -> str:
    """lmms-eval MMMU-style option parsing: (1) an explicit standalone
    letter (first match, checking '(A)'-style first); (2) else, if
    exactly ONE option's text appears in the prediction, that option;
    (3) else '' (wrong)."""
    letters = [chr(ord("A") + i) for i in range(len(options))]
    t = str(prediction).strip()
    m = re.search(r"\(([A-J])\)", t)
    if m and m.group(1) in letters:
        return m.group(1)
    m = _LETTER.search(t)
    if m and m.group(1) in letters:
        return m.group(1)
    low = t.lower()
    hits = [letters[i] for i, op in enumerate(options)
            if str(op).lower() in low and str(op).strip()]
    return hits[0] if len(hits) == 1 else ""


def score_mmmu(items: Iterable[dict]) -> dict:
    n = ok = 0
    for it in items:
        n += 1
        pred = parse_multi_choice(it["prediction"], it.get("options", ()))
        ok += int(pred == str(it["answer"]).strip().upper())
    return {"accuracy": ok / max(n, 1), "num": n}


SCORERS = {"mme": score_mme, "pope": score_pope, "gqa": score_gqa,
           "mmmu": score_mmmu}


def score_benchmark(name: str, items: Iterable[dict]) -> dict:
    """Dispatch by benchmark name (see SCORERS)."""
    try:
        fn = SCORERS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown benchmark {name!r}; "
                         f"one of {sorted(SCORERS)}") from None
    return fn(list(items))
