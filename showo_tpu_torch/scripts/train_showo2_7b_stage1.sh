#!/usr/bin/env bash
# Stage-1 chaining (parity with show-o2/train_showo2_7b_stage1.sh):
# stage-1a -> promote latest checkpoint to checkpoint-0 -> stage-1b (HQ data).
#
# Twin of scripts/train_showo2_7b_stage1.sh on the PyTorch + CUDA port:
# the same stages, configs, output directories and promotion, each stage
# run by the port's module.  One difference: any key=value arguments given
# to this script are passed on to every stage (device=cpu, tiny dims), as
# the port's entry points raise without a card unless asked for the CPU.
set -euo pipefail

CFG_A=${CFG_A:-configs/showo2_7b_stage_1_a.yaml}
CFG_B=${CFG_B:-configs/showo2_7b_stage_1_b.yaml}
OUT_A=show-o2-7b-stage1a
OUT_B=show-o2-7b-stage1b

python -m showo_tpu_torch.show_o2.train_stage_one config="$CFG_A" "$@"

# promote: copy the final checkpoint as the next stage's checkpoint-0
LATEST=$(ls -d "$OUT_A"/checkpoint-* | sort -t- -k2 -n | tail -1)
mkdir -p "$OUT_B"
cp -r "$LATEST" "$OUT_B/checkpoint-0"

python -m showo_tpu_torch.show_o2.train_stage_one config="$CFG_B" \
    experiment.output_dir="$OUT_B" "$@"
