#!/usr/bin/env bash
# Stage-2 chaining (parity with show-o2/train_showo2_7b_stage2.sh):
# promote stage-1b -> stage-2a -> 2b -> 2c, each sub-stage with different
# instruction-tuning data and LR groups (LLaVA-OneVision schedule).
#
# Twin of scripts/train_showo2_7b_stage2.sh on the PyTorch + CUDA port:
# the same stages, configs, output directories and promotions, each stage
# run by the port's module.  One difference: any key=value arguments given
# to this script are passed on to every stage (device=cpu, tiny dims), as
# the port's entry points raise without a card unless asked for the CPU.
set -euo pipefail

promote() {  # promote <src_out_dir> <dst_out_dir>
  local latest
  latest=$(ls -d "$1"/checkpoint-* | sort -t- -k2 -n | tail -1)
  mkdir -p "$2"
  cp -r "$latest" "$2/checkpoint-0"
}

OUT_1B=show-o2-7b-stage1b
OUT_2A=show-o2-7b-stage2a
OUT_2B=show-o2-7b-stage2b
OUT_2C=show-o2-7b-stage2c

promote "$OUT_1B" "$OUT_2A"
python -m showo_tpu_torch.show_o2.train_stage_two config=configs/showo2_7b_stage_2_a.yaml "$@"

promote "$OUT_2A" "$OUT_2B"
python -m showo_tpu_torch.show_o2.train_stage_two config=configs/showo2_7b_stage_2_b.yaml "$@"

promote "$OUT_2B" "$OUT_2C"
python -m showo_tpu_torch.show_o2.train_stage_two config=configs/showo2_7b_stage_2_c.yaml "$@"
