#!/usr/bin/env bash
# MECHANICS smoke for the cocktail-party adaptation recipe
# (lipsync_tpu_torch/tools/train_interference_r4.sh): rebuild a tiny version of every
# /tmp prerequisite and drive the real adaptation script end to end.
#
# Purpose: the full-scale recipe needs the regen_r4.sh artifacts
# plus a model trained past the ~1000-clip learning threshold
# (docs/eval/learning_curve.json) — too expensive to re-run casually.
# This smoke validates every STAGE executes (interference-mixed
# generation, precompute, merge, finetune-from-checkpoint, Platt refit,
# both multiface replays, the seen-construction forgetting check) at
# sizes that finish in minutes (see PERF.md for the card's run at even
# smaller env sizes). The model it trains
# is BELOW the learning threshold, so the smoke's metric values are
# meaningless by design — only exit codes and artifact shapes matter.
set -euo pipefail
cd "$(dirname "$0")/../.."

S=${S:-/tmp/smoke_r4}
OUT=${OUT:-$S/out}
NPC_TRAIN=${NPC_TRAIN:-30}    # clips/class, base train split (mechanics only)
NPC_CALIB=${NPC_CALIB:-10}
EPOCHS=${EPOCHS:-4}
MF_PER_KIND=${MF_PER_KIND:-1} # multiface scenes per kind
UNSEEN_NPC=${UNSEEN_NPC:-6}
# The adaptation recipe's own sizes (step 6); the JAX launcher pins them.
INTF_NPC=${INTF_NPC:-20}
INTF_NPC_CAL=${INTF_NPC_CAL:-8}
INTF_EPOCHS=${INTF_EPOCHS:-3}

log(){ echo "[$(date +%H:%M:%S)] smoke: $*"; }
mkdir -p "$OUT"

# -- 1. tiny clean splits ---------------------------------------------------
[ -d "$S/train" ] || { log "gen train"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$S/train" \
    --n-per-class "$NPC_TRAIN" --style phoneme --jitter --hard-negatives --seed 1; }
[ -d "$S/calib" ] || { log "gen calib"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$S/calib" \
    --n-per-class "$NPC_CALIB" --style phoneme --jitter --hard-negatives --seed 2; }
for sp in train calib; do
  [ -d "$S/${sp}_pre" ] || { log "precompute $sp"; \
    python -m lipsync_tpu_torch.tools.precompute_training_tensors --data-dir "$S/$sp" \
      --output-dir "$S/${sp}_pre" --mode full_sequence; }
done

# -- 2. base checkpoint (below learning threshold; mechanics only) ----------
[ -d "$S/w/best_model_accuracy" ] || { log "train base"; \
  python -m lipsync_tpu_torch.training.train --preprocessed-dir "$S/train_pre" \
    --output-dir "$S/w" --epochs "$EPOCHS" --batch-size 16 --device-cache \
    --phase2-start-epoch 0 --phase3-start-epoch 0 --lr-encoder 1e-4; }

# -- 3. base Platt ----------------------------------------------------------
log "fit base platt"
python -m lipsync_tpu_torch.tools.fit_calibrator --preprocessed-dir "$S/calib_pre" \
  --model-path "$S/w/best_model_accuracy" --method platt | tee "$S/platt.txt"
PA=$(awk '/calibration_platt_a/{print $2}' "$S/platt.txt")
PB=$(awk '/calibration_platt_b/{print $2}' "$S/platt.txt")

# -- 4. multiface scenes + PRE-adaptation replay ----------------------------
for nf in 2 3; do
  [ -d "$S/mf_${nf}f" ] || { log "gen ${nf}f scenes"; \
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --style multiface \
      --output-dir "$S/mf_${nf}f" --n-faces "$nf" \
      --n-per-class "$MF_PER_KIND" --seconds 7 --seed "1${nf}"; }
  log "base replay ${nf}f"
  python -m lipsync_tpu_torch.tools.eval_multiface --data-dir "$S/mf_${nf}f" \
    --model-path "$S/w/best_model_accuracy" --speaking-score-mode articulation \
    --calibration-method platt \
    --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
    --output "$OUT/multiface_${nf}f_smoke_base.json"
done

# -- 5. seen-construction pre dirs (for the forgetting check) ---------------
log "unseen shift/swap/scramble (base)"
python -m lipsync_tpu_torch.tools.eval_unseen_fakes --model-path "$S/w/best_model_accuracy" \
  --model-name smoke_base --work-dir "$S/unseen" --n-per-class "$UNSEEN_NPC" \
  --constructions shift,swap,scramble \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$OUT/unseen_smoke_base.json"

# -- 6. the adaptation recipe itself ----------------------------------------
log "drive train_interference_r4.sh"
NPC=$INTF_NPC NPC_CAL=$INTF_NPC_CAL EPOCHS=$INTF_EPOCHS T="$S/intf" \
  W0="$S/w/best_model_accuracy" \
  CAL0="$S/calib_pre" MF_DIR="$S/mf" UNSEEN_DIR="$S/unseen" \
  OUT="$OUT" SUFFIX=_smoke bash lipsync_tpu_torch/tools/train_interference_r4.sh
log "done — artifacts in $OUT"
ls -la "$OUT"
