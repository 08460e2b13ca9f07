#!/usr/bin/env bash
# Finetuning wrapper (analog of the reference's scripts/run_finetune.sh), on
# the port's trainer (cuda:0). Env-overridable knobs, Jenkins-compatible (see
# run_finetune_jenkins.sh). Run it from anywhere:
#   bash lipsync_tpu_torch/tools/run_finetune.sh
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
cd "$REPO_ROOT"

DATA_DIR="${DATA_DIR:-data/train}"
PREPROCESSED_DIR="${PREPROCESSED_DIR:-}"
CHECKPOINT="${CHECKPOINT:-weights/best_model_accuracy}"
OUTPUT_DIR="${OUTPUT_DIR:-weights_finetune}"
EPOCHS="${EPOCHS:-30}"
FROZEN_EPOCHS="${FROZEN_EPOCHS:-10}"
BATCH_SIZE="${BATCH_SIZE:-8}"

ARGS=(
  --checkpoint "$CHECKPOINT"
  --output-dir "$OUTPUT_DIR"
  --epochs "$EPOCHS"
  --frozen-epochs "$FROZEN_EPOCHS"
  --batch-size "$BATCH_SIZE"
)
if [[ -n "$PREPROCESSED_DIR" ]]; then
  ARGS+=(--preprocessed-dir "$PREPROCESSED_DIR")
else
  ARGS+=(--data-dir "$DATA_DIR")
fi

echo "[run_finetune] python -m lipsync_tpu_torch.training.finetune ${ARGS[*]}"
exec python -m lipsync_tpu_torch.training.finetune "${ARGS[@]}"
