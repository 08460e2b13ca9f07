#!/usr/bin/env bash
# CI finetune entrypoint (analog of the reference's run_finetune_jenkins.sh:
# env-var driven, non-interactive, artifacts under $WORKSPACE), on the port's
# tools and trainer (cuda:0).
set -euo pipefail

: "${WORKSPACE:?WORKSPACE must be set by CI}"
export OUTPUT_DIR="${OUTPUT_DIR:-$WORKSPACE/weights_finetune}"
export EPOCHS="${EPOCHS:-10}"
export BATCH_SIZE="${BATCH_SIZE:-8}"

# Preflight before burning card time.
python -m lipsync_tpu_torch.tools.check_setup ${DATA_DIR:+--data-dir "$DATA_DIR"}

bash "$(dirname "$0")/run_finetune.sh"

# Post-run evaluation summary for the CI log.
if [[ -n "${EVAL_DATA_DIR:-}" ]]; then
  python -m lipsync_tpu_torch.tools.validate_pipeline \
    --data-dir "$EVAL_DATA_DIR" \
    --model-path "$OUTPUT_DIR/best_model_accuracy" \
    --output-dir "$WORKSPACE/eval_out"
  cat "$WORKSPACE/eval_out/metrics.json"
fi
