#!/usr/bin/env bash
# Grand-union flagship: ONE training run over both synthetic tiers, all
# nine fake constructions, and cocktail-party interference clips — then
# the full eval matrix against that single checkpoint (VERDICT r4 item 2).
#
# Every previous demonstration was a sequential finetune with measured
# trades (composite+freeze adaptation dropped warp/splice AUC
# 0.971/0.980 -> 0.953/0.955; round 3's adapted grid pushed 67 ms-shift
# false alarms 4.6% -> 42.6%). This script replaces the prose ("joint
# training is the production recipe") with the model: the checkpoint is
# meant to be committed to weights/flagship and becomes the default for
# the serving engine and eval scripts.
#
# Done-criteria chased (VERDICT r4 item 2): AUC >=0.99 on seen families,
# >=0.95 on every sync-visible family, composite >=0.99, av_shift_2f
# (133 ms) real->fake flip >=95% with av_shift_1f (67 ms) false-flips
# <=10%, both tiers held simultaneously.
#
# Reference analog being replaced: the 3-phase single-corpus train.py +
# per-construction finetune.py chain
# (the reference's app/training/{train,finetune}.py).
set -euo pipefail
cd "$(dirname "$0")/../.."

NPC_PH=${NPC_PH:-1350}       # phoneme union: /9 constructions = 150 each
NPC_INTF=${NPC_INTF:-300}    # interference (babble-mix) clips/class
NPC_ENV=${NPC_ENV:-300}      # envelope-tier clips/class
NPC_CAL_PH=${NPC_CAL_PH:-225}
NPC_CAL_INTF=${NPC_CAL_INTF:-60}
NPC_CAL_ENV=${NPC_CAL_ENV:-60}
EPOCHS=${EPOCHS:-60}
BATCH=${BATCH:-32}           # the JAX recipe's batch; the card's own
                             # limit with the device-cache corpus beside
                             # it has not been measured (bench_train_scaling
                             # measures the step alone)
U=${U:-/tmp/union_flagship}
W=${W:-$U/weights}
OUT=${OUT:-docs/eval}
SUFFIX=${SUFFIX:-_flagship}
ALL9="shift,swap,scramble,warp,splice,freeze,revoice,retime,composite"

log() { echo "[$(date +%H:%M:%S)] $*"; }
mkdir -p "$U"

# Resume guards are parameter-pinned (ADVICE r4): refuse stale artifacts.
# Only DATASET-shaping knobs are pinned; changing EPOCHS/BATCH only
# affects training, so clear $W (not $U) when changing those.
PARAMS="NPC_PH=$NPC_PH NPC_INTF=$NPC_INTF NPC_ENV=$NPC_ENV NPC_CAL=$NPC_CAL_PH/$NPC_CAL_INTF/$NPC_CAL_ENV"
if [ -f "$U/params.env" ]; then
  if [ "$(cat "$U/params.env")" != "$PARAMS" ]; then
    echo "ERROR: $U holds artifacts built with different knobs (rm -rf $U)" >&2
    exit 2
  fi
else
  echo "$PARAMS" > "$U/params.env"
fi

# -- 1. train + calib splits (seeds disjoint from every other recipe) ------
[ -d "$U/raw_ph" ] || { log "generate phoneme all-9 train ($NPC_PH/class)"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$U/raw_ph" \
    --n-per-class "$NPC_PH" --style phoneme --jitter --hard-negatives \
    --fake-modes "$ALL9" --seed 501; }
[ -d "$U/raw_intf" ] || { log "generate interference train ($NPC_INTF/class)"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$U/raw_intf" \
    --n-per-class "$NPC_INTF" --style phoneme --jitter --hard-negatives \
    --fake-modes "$ALL9" --interference-prob 0.7 --seed 502; }
[ -d "$U/raw_env" ] || { log "generate envelope-tier train ($NPC_ENV/class)"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$U/raw_env" \
    --n-per-class "$NPC_ENV" --style envelope --jitter --hard-negatives \
    --seed 503; }
[ -d "$U/rawcal_ph" ] || python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
    --output-dir "$U/rawcal_ph" --n-per-class "$NPC_CAL_PH" \
    --style phoneme --jitter --hard-negatives --fake-modes "$ALL9" --seed 511
[ -d "$U/rawcal_intf" ] || python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
    --output-dir "$U/rawcal_intf" --n-per-class "$NPC_CAL_INTF" \
    --style phoneme --jitter --hard-negatives --fake-modes "$ALL9" \
    --interference-prob 0.7 --seed 512
[ -d "$U/rawcal_env" ] || python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
    --output-dir "$U/rawcal_env" --n-per-class "$NPC_CAL_ENV" \
    --style envelope --jitter --hard-negatives --seed 513

for d in ph intf env; do
  [ -d "$U/pre_$d" ] || { log "precompute raw_$d"; \
    python -m lipsync_tpu_torch.tools.precompute_training_tensors --data-dir "$U/raw_$d" \
      --output-dir "$U/pre_$d" --mode full_sequence; }
  [ -d "$U/precal_$d" ] || { log "precompute rawcal_$d"; \
    python -m lipsync_tpu_torch.tools.precompute_training_tensors --data-dir "$U/rawcal_$d" \
      --output-dir "$U/precal_$d" --mode full_sequence; }
done
[ -d "$U/pre_train" ] || python scripts/merge_preprocessed_dirs.py \
  "$U/pre_ph" "$U/pre_intf" "$U/pre_env" --out "$U/pre_train"
[ -d "$U/pre_calib" ] || python scripts/merge_preprocessed_dirs.py \
  "$U/precal_ph" "$U/precal_intf" "$U/precal_env" --out "$U/pre_calib"

if [ -n "${DATA_ONLY:-}" ]; then
  log "DATA_ONLY set — datasets ready, exiting before training"
  exit 0
fi

# -- 2. train from scratch (small-dataset recipe, docs/TRAINING.md) --------
if [ ! -d "$W/best_model_accuracy" ]; then
  log "train ($EPOCHS epochs max, batch $BATCH, device-cache)"
  python -m lipsync_tpu_torch.training.train \
    --preprocessed-dir "$U/pre_train" --output-dir "$W" \
    --epochs "$EPOCHS" --batch-size "$BATCH" --device-cache \
    --phase2-start-epoch 0 --phase3-start-epoch 0 --lr-encoder 1e-4 \
    --early-stopping-patience 8
fi
WF="$W/best_model_accuracy"

# -- 3. calibrate (smoothed-target Platt; logits saved for refits) ----------
log "fit Platt calibration"
python -m lipsync_tpu_torch.tools.fit_calibrator --preprocessed-dir "$U/pre_calib" \
  --model-path "$WF" --method platt --save-logits "$U/calib_logits.npz" \
  | tee "$U/platt.txt"
PA=$(awk '/calibration_platt_a/{print $2}' "$U/platt.txt")
PB=$(awk '/calibration_platt_b/{print $2}' "$U/platt.txt")
log "platt a=$PA b=$PB"

# -- 4. eval matrix ---------------------------------------------------------
# 4a. 9-construction matrix on the SAME held-out sets as the zero-shot run
#     (lipsync_tpu_torch/tools/regen_r4.sh populates /tmp/unseen_r4).
log "9-construction matrix"
python -m lipsync_tpu_torch.tools.eval_unseen_fakes --model-path "$WF" \
  --model-name "union_flagship" --work-dir /tmp/unseen_r4 \
  --skip-generate --skip-precompute --in-process \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$OUT/unseen_constructions${SUFFIX}.json"

# 4b. robustness grid (incl. av_shift_1f/2f misalignment sensitivity) on a
#     fresh held-out phoneme set.
[ -d "$U/raw_test" ] || python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
  --output-dir "$U/raw_test" --n-per-class 60 --style phoneme --jitter \
  --hard-negatives --seed 601
[ -d "$U/pre_test" ] || python -m lipsync_tpu_torch.tools.precompute_training_tensors \
  --data-dir "$U/raw_test" --output-dir "$U/pre_test" --mode full_sequence
log "robustness grid"
python -m lipsync_tpu_torch.tools.eval_robustness_grid --preprocessed-dir "$U/pre_test" \
  --model-path "$WF" --calibration-method platt \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$OUT/robustness_grid${SUFFIX}.json"

# 4c. cross-tier: the one checkpoint scored on BOTH tiers' held-out sets.
[ -d "$U/raw_test_env" ] || python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
  --output-dir "$U/raw_test_env" --n-per-class 60 --style envelope \
  --jitter --hard-negatives --seed 602
[ -d "$U/pre_test_env" ] || python -m lipsync_tpu_torch.tools.precompute_training_tensors \
  --data-dir "$U/raw_test_env" --output-dir "$U/pre_test_env" \
  --mode full_sequence
log "cross-tier"
python -m lipsync_tpu_torch.tools.eval_cross_tier --model-path "$WF" \
  --model-name "union_flagship" --in-process \
  --test-dir "phoneme=$U/pre_test" --test-dir "envelope=$U/pre_test_env" \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$OUT/cross_tier${SUFFIX}.json"

# 4d. multiface production replay, articulation mode, on the regen
#     scenes + fresh-seed sets (MF_EXTRA, e.g. /tmp/mf_fresh) — all
#     replay sets share ONE loaded engine (one model load for all sets).
log "multiface replays (articulation; shared engine)"
WF="$WF" PA="$PA" PB="$PB" OUT="$OUT" SUFFIX="$SUFFIX" \
MF_EXTRA="${MF_EXTRA:-}" python - <<'PYEOF'
import os, sys
from pathlib import Path
sys.path.insert(0, ".")
from lipsync_tpu_torch.inference.engine import load_engine
from lipsync_tpu_torch.tools import eval_multiface

engine = load_engine(os.environ["WF"])
pa, pb = os.environ["PA"], os.environ["PB"]
out, sfx = os.environ["OUT"], os.environ["SUFFIX"]
sets = [(f"/tmp/mf_scenes_{nf}f", f"{nf}f", "") for nf in (2, 3)]
if os.environ.get("MF_EXTRA"):
    sets += [(f"{os.environ['MF_EXTRA']}_{nf}f", f"{nf}f", "_fresh")
             for nf in (2, 3)]
for data_dir, nf, fresh in sets:
    if not Path(data_dir).is_dir():
        continue
    print(f"[replay] {data_dir} articulation", flush=True)
    eval_multiface.main([
        "--data-dir", data_dir, "--speaking-score-mode", "articulation",
        "--calibration-method", "platt",
        "--calibration-platt-a", pa, "--calibration-platt-b", pb,
        "--output", f"{out}/multiface_{nf}{sfx}_articulation{fresh}.json",
    ], engine=engine)
PYEOF

log "done — checkpoint at $WF; copy into weights/flagship to ship:"
log "  rm -rf weights/flagship && cp -r $WF weights/flagship"
