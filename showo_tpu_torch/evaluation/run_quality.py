"""One-command quality-eval chain on the port's pipelines.

Counterpart of ``showo_tpu/evaluation/run_quality.py``.  Chains, from a
single config + checkpoint set: GenEval image sweep -> DPG-Bench sweep +
in-repo scoring -> FID on the validation prompt list, so landing the
released checkpoints gives the quality numbers (GenEval / DPG / "FID
parity at bf16") with no new code.  Reference counterparts:
show-o2/evaluation/inference_geneval.py, inference_dpg.py +
compute_dpg_bench.py, and the external pytorch-fid step.

    python -m showo_tpu_torch.evaluation.run_quality \
        config=configs/showo_demo.yaml pipeline=v1 steps=geneval,dpg,fid \
        output_dir=quality_out geneval_metadata=<geneval .jsonl> \
        dpg_prompts_dir=<dpg txt dir> dpg_csv=<dpg_bench.csv> \
        fid_ref_dir=<real-image dir> [fid_extractor=inception|smoke] \
        [validation_prompts_file=<txt>] [device=cpu]

Steps whose inputs are absent are skipped with a reason (recorded in
``quality_summary.json``), so the same command works without the data
(everything skips but the plumbing runs) up to a host with weights and
data (everything scores).  The pipeline runs on CUDA unless
``device=cpu``; ``pipeline.generate(chunk, generator)`` draws from one
``torch.Generator`` per step where JAX splits a key per chunk.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def run_chain(pipeline, outdir: str, steps: Sequence[str],
              geneval_metadata: Optional[str] = None,
              dpg_prompts_dir: Optional[str] = None,
              dpg_csv: Optional[str] = None,
              dpg_scorer: Optional[Callable] = None,
              fid_prompts: Optional[Sequence[str]] = None,
              fid_ref_dir: Optional[str] = None,
              fid_extractor: Optional[Callable] = None,
              batch_size: int = 4, seed: int = 0,
              dpg_resolution: int = 1024) -> dict:
    """Run the requested steps; returns (and writes) the summary dict.

    Each step degrades to {"skipped": reason} when its inputs are
    missing instead of failing the chain."""
    os.makedirs(outdir, exist_ok=True)
    summary: dict = {"steps": list(steps)}

    if "geneval" in steps:
        if geneval_metadata and os.path.exists(geneval_metadata):
            from showo_tpu_torch.evaluation.geneval import run_geneval_sweep

            gdir = os.path.join(outdir, "geneval")
            run_geneval_sweep(pipeline, geneval_metadata, gdir,
                              batch_size=batch_size, seed=seed)
            n = len([d for d in os.listdir(gdir)
                     if os.path.isdir(os.path.join(gdir, d))])
            summary["geneval"] = {"outdir": gdir, "prompts": n,
                                  "note": "score with the external GenEval "
                                          "harness (as the reference does)"}
        else:
            summary["geneval"] = {"skipped":
                                  f"metadata not found: {geneval_metadata}"}

    if "dpg" in steps:
        if dpg_prompts_dir and os.path.isdir(dpg_prompts_dir):
            from showo_tpu_torch.evaluation.geneval import run_dpg_sweep

            ddir = os.path.join(outdir, "dpg")
            run_dpg_sweep(pipeline, dpg_prompts_dir, ddir,
                          batch_size=batch_size, seed=seed)
            entry = {"outdir": ddir}
            if dpg_csv and os.path.exists(dpg_csv) and dpg_scorer is not None:
                from showo_tpu_torch.evaluation.dpg_bench import \
                    run_dpg_scoring

                entry["result"] = run_dpg_scoring(
                    ddir, dpg_csv, dpg_scorer, resolution=dpg_resolution,
                    pic_num=min(batch_size, 4))
            else:
                entry["scoring_skipped"] = (
                    f"csv={dpg_csv} scorer={'set' if dpg_scorer else 'none'}")
            summary["dpg"] = entry
        else:
            summary["dpg"] = {"skipped":
                              f"prompts dir not found: {dpg_prompts_dir}"}

    if "fid" in steps:
        if fid_prompts and fid_ref_dir and os.path.isdir(fid_ref_dir) \
                and fid_extractor is not None:
            from showo_tpu_torch.evaluation.fid import (
                activation_statistics, extract_features, frechet_distance)
            from showo_tpu_torch.utils.image import to_pil_images

            fdir = os.path.join(outdir, "fid_gen")
            os.makedirs(fdir, exist_ok=True)
            generator = torch.Generator(device=getattr(
                pipeline, "device", "cpu")).manual_seed(seed)
            gen_feats = []
            idx = 0
            for s in range(0, len(fid_prompts), batch_size):
                chunk = list(fid_prompts[s:s + batch_size])
                images = np.asarray(pipeline.generate(chunk, generator))
                u8 = ((np.clip(images, -1, 1) + 1) * 127.5).round(
                    ).astype(np.uint8)
                gen_feats.append(extract_features(u8, fid_extractor))
                for im in to_pil_images(images):
                    im.save(os.path.join(fdir, f"{idx:05d}.png"))
                    idx += 1
            from PIL import Image

            ref_paths = sorted(
                os.path.join(fid_ref_dir, f)
                for f in os.listdir(fid_ref_dir)
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
            res = u8.shape[1]
            refs = np.stack([
                np.asarray(Image.open(p).convert("RGB")
                           .resize((res, res), Image.BICUBIC))
                for p in ref_paths])
            ref_feats = extract_features(refs, fid_extractor)
            fid = frechet_distance(
                *activation_statistics(np.concatenate(gen_feats)),
                *activation_statistics(ref_feats))
            summary["fid"] = {"value": fid, "n_gen": idx,
                              "n_ref": len(ref_paths), "outdir": fdir}
        else:
            summary["fid"] = {"skipped":
                              f"prompts={bool(fid_prompts)} "
                              f"ref_dir={fid_ref_dir} "
                              f"extractor={'set' if fid_extractor else 'none'}"}

    path = os.path.join(outdir, "quality_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2, default=float)
    logger.info("quality summary -> %s", path)
    return summary


def _build_scorer(config, generation: str, pipe):
    """MMU self-scorer from the same config / weights (v1 only, as in JAX:
    the v2 MMU pipeline needs the SigLIP tower; use dpg_scorer=none there
    and score externally, as the reference does with mPLUG): an
    ``MMUPipeline`` on the t2i pipeline's model and MAGVIT, 16 new tokens,
    no second weight fusion."""
    if generation != "v1":
        return None
    from showo_tpu_torch.evaluation.dpg_bench import MMUPipelineScorer
    from showo_tpu_torch.pipelines.mmu import MMUPipeline

    mmu = MMUPipeline(model=pipe.model, vq=pipe.vq,
                      uni_prompting=pipe.uni_prompting, max_new_tokens=16,
                      param_fusion="none")
    return MMUPipelineScorer(mmu, pipe.uni_prompting.text_tokenizer,
                             resolution=pipe.resolution)


def main(argv=None) -> None:
    """The CLI (module doc): ``argv`` the ``key=value`` arguments, the
    command line's when None; prints the summary as one JSON line."""
    from showo_tpu_torch.config import get_config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config(argv)
    generation = str(config.get("pipeline", "v1"))
    if generation == "v2":
        from showo_tpu_torch.inference_t2i_v2 import build_pipeline
    else:
        from showo_tpu_torch.inference_t2i import build_pipeline
    pipe = build_pipeline(config, config.get("device"))

    steps = str(config.get("steps", "geneval,dpg,fid")).split(",")
    outdir = str(config.get("output_dir", "quality_out"))

    scorer = None
    if "dpg" in steps and str(config.get("dpg_scorer", "mmu")) == "mmu":
        scorer = _build_scorer(config, generation, pipe)

    extractor = None
    if "fid" in steps:
        name = str(config.get("fid_extractor", "inception"))
        if name == "smoke":
            from showo_tpu_torch.evaluation.fid import \
                RandomProjectionExtractor

            extractor = RandomProjectionExtractor()
        else:
            try:
                from showo_tpu_torch.evaluation.fid import \
                    TorchInceptionExtractor

                extractor = TorchInceptionExtractor(device=pipe.device)
            except ImportError as e:
                logger.warning("FID extractor unavailable (%s)", e)

    fid_prompts = None
    if "fid" in steps:
        from showo_tpu_torch.utils.assets import validation_prompts_file

        vp = validation_prompts_file(config.get("validation_prompts_file"))
        if vp:
            with open(vp) as f:
                fid_prompts = [ln.strip() for ln in f if ln.strip()]

    summary = run_chain(
        pipe, outdir, steps,
        geneval_metadata=config.get("geneval_metadata"),
        dpg_prompts_dir=config.get("dpg_prompts_dir"),
        dpg_csv=config.get("dpg_csv"),
        dpg_scorer=scorer,
        fid_prompts=fid_prompts,
        fid_ref_dir=config.get("fid_ref_dir"),
        fid_extractor=extractor,
        batch_size=int(config.get("batch_size", 4)),
        seed=int(config.get("seed", 0)),
        dpg_resolution=int(config.get("dpg_resolution", 1024)))
    print(json.dumps(summary, default=float))


if __name__ == "__main__":
    main()
