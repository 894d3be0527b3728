"""Quality evaluation: the MMU eval sweep and its benchmark scorers, the
GenEval and DPG-Bench sweeps with DPG scoring, FID, the one-command chain
and the VQ round-trip PSNR gate."""
