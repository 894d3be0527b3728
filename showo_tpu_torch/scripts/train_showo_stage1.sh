#!/usr/bin/env bash
# Show-o v1 stage-1 pretraining launch.  No accelerate/DeepSpeed configs:
# the mesh axes come from the `parallel:` section of the config (one
# process a card under torchrun).
#
# Twin of scripts/train_showo_stage1.sh on the PyTorch + CUDA port: the
# same config, taken from $1 as there, run by the port's module.  One
# difference: any key=value arguments after $1 are passed on (device=cpu,
# tiny dims), as the port's entry points raise without a card unless
# asked for the CPU; an empty $1 keeps the default config.
set -euo pipefail

python -m showo_tpu_torch.training.train_showo \
    config=${1:-configs/showo_pretraining_stage1.yaml} "${@:2}"
