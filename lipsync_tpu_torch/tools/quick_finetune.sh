#!/usr/bin/env bash
# Quick finetune smoke run (analog of the reference's quick_finetune.sh):
# few epochs, small batch, early feedback on a data sample; run_finetune.sh
# with smaller defaults.
set -euo pipefail
cd "$(dirname "$0")/../.."

EPOCHS="${EPOCHS:-3}" FROZEN_EPOCHS="${FROZEN_EPOCHS:-1}" BATCH_SIZE="${BATCH_SIZE:-4}" \
OUTPUT_DIR="${OUTPUT_DIR:-weights_finetune_quick}" \
exec bash lipsync_tpu_torch/tools/run_finetune.sh "$@"
