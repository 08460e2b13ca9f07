#!/usr/bin/env bash
# Finetune-adaptation to the two WORST unseen fake constructions of the
# round-4 zero-shot matrix (docs/eval/unseen_constructions.json):
#
#   composite — perfectly synced A/V, lip-region blending artifacts only.
#               Zero-shot AUC 0.456 / recall 0.0: a sync-trained model has
#               NO gradient toward it; only the artifact branch
#               (models/artifact.py) can carry the signal.
#   freeze    — articulation halts while audio continues.
#               Zero-shot AUC 0.958 / recall 0.667.
#
# Mirrors the round-3 recipe (docs/eval/adaptation_unseen.json — 300
# warp+splice clips, 12 epochs, device-cache) and re-scores the FULL
# 9-construction matrix afterwards so recovery and forgetting are read
# off the same table. Reference use case: finetune.py partial-load
# adaptation (the reference's app/training/finetune.py).
#
# Inputs it expects (from lipsync_tpu_torch/tools/regen_r4.sh):
#   /tmp/r4_weights/best_model_accuracy   base checkpoint
#   /tmp/r4ph_calib_pre                   calibration split
#   /tmp/unseen_r4/pre_*                  the 9 per-construction test sets
set -euo pipefail
cd "$(dirname "$0")/../.."

NPC_ADAPT=${NPC_ADAPT:-150}    # clips/class/construction for the adapt split
NPC_ACAL=${NPC_ACAL:-40}      # clips/class/construction for the calib merge
EPOCHS=${EPOCHS:-12}
A=${A:-/tmp/adapt_r4}
W0=${W0:-/tmp/r4_weights/best_model_accuracy}
OUT=${OUT:-docs/eval/unseen_constructions_adapted.json}

log() { echo "[$(date +%H:%M:%S)] $*"; }
mkdir -p "$A"

# -- 1. adaptation + calib splits (seeds disjoint from train 1/2, eval 101+) --
s=301
for c in composite freeze; do
  if [ ! -d "$A/raw_$c" ]; then
    log "generate adapt split: $c ($NPC_ADAPT/class, seed $s)"
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$A/raw_$c" \
      --n-per-class "$NPC_ADAPT" --style phoneme --jitter \
      --fake-modes "$c" --seed "$s"
  fi
  if [ ! -d "$A/rawcal_$c" ]; then
    log "generate adapt-calib split: $c ($NPC_ACAL/class, seed $((s+10)))"
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$A/rawcal_$c" \
      --n-per-class "$NPC_ACAL" --style phoneme --jitter \
      --fake-modes "$c" --seed "$((s+10))"
  fi
  s=$((s+1))
done

for d in raw_composite raw_freeze rawcal_composite rawcal_freeze; do
  if [ ! -d "$A/pre_${d#raw}" ]; then
    log "precompute $d"
    python -m lipsync_tpu_torch.tools.precompute_training_tensors \
      --data-dir "$A/$d" --output-dir "$A/pre_${d#raw}" --mode full_sequence
  fi
done

[ -d "$A/pre_train" ] || python scripts/merge_preprocessed_dirs.py \
  "$A/pre__composite" "$A/pre__freeze" --out "$A/pre_train"
[ -d "$A/pre_calib" ] || python scripts/merge_preprocessed_dirs.py \
  /tmp/r4ph_calib_pre "$A/pre_cal_composite" "$A/pre_cal_freeze" \
  --out "$A/pre_calib"

# -- 2. finetune ------------------------------------------------------------
if [ ! -d "$A/weights/best_model_f1" ]; then
  log "finetune $EPOCHS epochs (2 frozen) from $W0"
  python -m lipsync_tpu_torch.training.finetune --preprocessed-dir "$A/pre_train" \
    --checkpoint "$W0" --output-dir "$A/weights" \
    --epochs "$EPOCHS" --frozen-epochs 2 --batch-size 32 --device-cache
fi
WA="$A/weights/best_model_f1"

# -- 3. refit Platt on the merged calib split --------------------------------
log "refit Platt calibration"
python -m lipsync_tpu_torch.tools.fit_calibrator --preprocessed-dir "$A/pre_calib" \
  --model-path "$WA" --method platt | tee "$A/platt.txt"
PA=$(awk '/calibration_platt_a/{print $2}' "$A/platt.txt")
PB=$(awk '/calibration_platt_b/{print $2}' "$A/platt.txt")
log "platt a=$PA b=$PB"

# -- 4. re-score the full 9-construction matrix ------------------------------
log "re-score the 9-construction matrix with the adapted model"
python -m lipsync_tpu_torch.tools.eval_unseen_fakes --model-path "$WA" \
  --model-name "phoneme_r4_adapted_composite_freeze" \
  --work-dir /tmp/unseen_r4 --skip-generate --skip-precompute \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$OUT"
log "done — $OUT"
