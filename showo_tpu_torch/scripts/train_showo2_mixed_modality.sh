#!/usr/bin/env bash
# Downstream mixed-modality two-phase recipe (show-o2/README.md:293-309):
# phase 1 trains with the und path + LLM frozen; phase 2 resumes with
# everything trainable and a larger step budget.
#
# Twin of scripts/train_showo2_mixed_modality.sh on the PyTorch + CUDA
# port: the same phases, config and overrides, each phase run by the
# port's module.  One difference: any key=value arguments given to this
# script are passed on to both phases (device=cpu, tiny dims), as the
# port's entry points raise without a card unless asked for the CPU.
set -euo pipefail

CFG=${CFG:-configs/showo2_1.5b_downstream_mixed_modality_simple.yaml}
PHASE2_STEPS=${PHASE2_STEPS:-50000}

# phase 1: warm-up with frozen und/LLM (frozen_params from the config)
python -m showo_tpu_torch.show_o2.train_mixed_modality config="$CFG" "$@"

# phase 2: unfreeze everything, resume from the phase-1 checkpoint
python -m showo_tpu_torch.show_o2.train_mixed_modality config="$CFG" \
    model.frozen_params=[] training.max_train_steps="$PHASE2_STEPS" "$@"
