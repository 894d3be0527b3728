#!/usr/bin/env bash
# v1 CLIP-ViT tuning chaining (train_w_clip_vit.py recipes): tuning
# stage 1 (llava_pretrain, projector warm-up) then stage 2 (llava_tuning).
#
# Twin of scripts/train_showo_clip_tuning.sh on the PyTorch + CUDA port:
# the same stages, configs, output directories and promotion, each stage
# run by the port's module.  One difference: any key=value arguments given
# to this script are passed on to every stage (device=cpu, tiny dims), as
# the port's entry points raise without a card unless asked for the CPU.
set -euo pipefail

promote() {
  local latest
  latest=$(ls -d "$1"/checkpoint-* | sort -t- -k2 -n | tail -1)
  mkdir -p "$2"
  cp -r "$latest" "$2/checkpoint-0"
}

python -m showo_tpu_torch.training.train_showo_clip config=configs/showo_instruction_tuning_1_w_clip_vit.yaml "$@"
promote show-o-tuning-stage1-w-clip-vit show-o-tuning-stage2-w-clip-vit
python -m showo_tpu_torch.training.train_showo_clip config=configs/showo_instruction_tuning_2_w_clip_vit.yaml "$@"
