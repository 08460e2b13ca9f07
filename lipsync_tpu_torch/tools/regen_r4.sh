#!/usr/bin/env bash
# Regenerate the round-4 /tmp datasets, model, and eval artifacts end to end.
#
# Everything under /tmp is disposable and may be wiped between runs —
# this script is the durable record of how to rebuild it all:
#   1. phoneme-tier train/calib splits (disjoint seeds) + precompute
#   2. train the sync model (--device-cache: the corpus resident on the card)
#   3. Platt-calibrate on the disjoint calib split
#   4. multiface 2f/3f scenes + production-replay eval
#      (r3 VERDICT item 1 -> docs/eval/multiface_{2f,3f}_r4.json)
#   5. unseen-fake-construction matrix, all 9 constructions
#      (r3 VERDICT item 6 -> docs/eval/unseen_constructions.json)
#
# Sizes are scaled by env overrides (the defaults are the JAX recipe's and
# have not been timed on the card). The r3 full-scale recipe used
# NPC_TRAIN=750 NPC_CALIB=150 (BENCHMARKS.md "Held-out sync learning").
set -euo pipefail
cd "$(dirname "$0")/../.."

NPC_TRAIN=${NPC_TRAIN:-500}     # clips per class, train split
NPC_CALIB=${NPC_CALIB:-100}     # clips per class, calibration split
EPOCHS=${EPOCHS:-60}
BATCH=${BATCH:-32}
MF_PER_KIND=${MF_PER_KIND:-8}   # multiface scenes per scene kind
UNSEEN_NPC=${UNSEEN_NPC:-60}    # clips per class per construction
W=${W:-/tmp/r4_weights}
OUT=${OUT:-docs/eval}

log() { echo "[$(date +%H:%M:%S)] $*"; }

# -- 1. datasets ----------------------------------------------------------
if [ ! -d /tmp/r4ph_train ]; then
  log "generate train split (${NPC_TRAIN}/class phoneme, hardened)"
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir /tmp/r4ph_train \
    --n-per-class "$NPC_TRAIN" --style phoneme --jitter --hard-negatives --seed 1
fi
if [ ! -d /tmp/r4ph_calib ]; then
  log "generate calib split (${NPC_CALIB}/class)"
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir /tmp/r4ph_calib \
    --n-per-class "$NPC_CALIB" --style phoneme --jitter --hard-negatives --seed 2
fi

# -- 2. precompute (full_sequence; real Haar detection path) --------------
for split in train calib; do
  if [ ! -d "/tmp/r4ph_${split}_pre" ]; then
    log "precompute ${split} tensors"
    python -m lipsync_tpu_torch.tools.precompute_training_tensors \
      --data-dir "/tmp/r4ph_${split}" --output-dir "/tmp/r4ph_${split}_pre" \
      --mode full_sequence
  fi
done

# -- 3. train --------------------------------------------------------------
if [ ! -d "$W/best_model_accuracy" ]; then
  log "train ($EPOCHS epochs max, batch $BATCH, device-cache)"
  # Small-dataset recipe (docs/TRAINING.md): unfreeze immediately,
  # encoder LR 1e-4.
  python -m lipsync_tpu_torch.training.train \
    --preprocessed-dir /tmp/r4ph_train_pre --output-dir "$W" \
    --epochs "$EPOCHS" --batch-size "$BATCH" --device-cache \
    --phase2-start-epoch 0 --phase3-start-epoch 0 --lr-encoder 1e-4 \
    --early-stopping-patience 8
fi

# -- 4. calibrate -----------------------------------------------------------
log "fit Platt calibration on the calib split"
python -m lipsync_tpu_torch.tools.fit_calibrator --preprocessed-dir /tmp/r4ph_calib_pre \
  --model-path "$W/best_model_accuracy" --method platt | tee /tmp/r4_platt.txt
PA=$(awk '/calibration_platt_a/{print $2}' /tmp/r4_platt.txt)
PB=$(awk '/calibration_platt_b/{print $2}' /tmp/r4_platt.txt)
log "platt a=$PA b=$PB"

# -- 5. multiface scenes + production-replay eval ---------------------------
for nf in 2 3; do
  if [ ! -d "/tmp/mf_scenes_${nf}f" ]; then
    log "generate ${nf}-face scenes (${MF_PER_KIND}/kind, 7 s)"
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --style multiface \
      --output-dir "/tmp/mf_scenes_${nf}f" --n-faces "$nf" \
      --n-per-class "$MF_PER_KIND" --seconds 7 --seed "1${nf}"
  fi
  log "multiface production replay (${nf}f)"
  python -m lipsync_tpu_torch.tools.eval_multiface --data-dir "/tmp/mf_scenes_${nf}f" \
    --model-path "$W/best_model_accuracy" \
    --calibration-method platt \
    --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
    --output "$OUT/multiface_${nf}f_r4.json"
done

# -- 6. unseen-fake construction matrix -------------------------------------
log "unseen-fake matrix (9 constructions, ${UNSEEN_NPC}/class each)"
python -m lipsync_tpu_torch.tools.eval_unseen_fakes --model-path "$W/best_model_accuracy" \
  --model-name "phoneme_r4_${NPC_TRAIN}pc" \
  --work-dir /tmp/unseen_r4 --n-per-class "$UNSEEN_NPC" \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$OUT/unseen_constructions.json"

log "done — artifacts in $OUT"
