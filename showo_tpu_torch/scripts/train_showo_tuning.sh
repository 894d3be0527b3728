#!/usr/bin/env bash
# v1 instruction-tuning chaining (reference README.md:219-230): pretraining
# stages 1->2->3 then tuning 1->2, each promoting the previous stage's
# latest checkpoint to checkpoint-0.
#
# Twin of scripts/train_showo_tuning.sh on the PyTorch + CUDA port: the
# same stages, configs, output directories and promotions, each stage run
# by the port's module.  One difference: any key=value arguments given to
# this script are passed on to every stage (device=cpu, tiny dims), as the
# port's entry points raise without a card unless asked for the CPU.
set -euo pipefail

promote() {
  local latest
  latest=$(ls -d "$1"/checkpoint-* | sort -t- -k2 -n | tail -1)
  mkdir -p "$2"
  cp -r "$latest" "$2/checkpoint-0"
}

python -m showo_tpu_torch.training.train_showo config=configs/showo_pretraining_stage1.yaml "$@"
promote show-o-training-stage1 show-o-training-stage2
python -m showo_tpu_torch.training.train_showo config=configs/showo_pretraining_stage2.yaml "$@"
promote show-o-training-stage2 show-o-training-stage3
python -m showo_tpu_torch.training.train_showo config=configs/showo_pretraining_stage3.yaml "$@"
promote show-o-training-stage3 show-o-tuning-stage1
python -m showo_tpu_torch.training.train_showo config=configs/showo_instruction_tuning_1.yaml "$@"
promote show-o-tuning-stage1 show-o-tuning-stage2
python -m showo_tpu_torch.training.train_showo config=configs/showo_instruction_tuning_2.yaml "$@"
