#!/usr/bin/env bash
# Cocktail-party adaptation: finetune on babble-interference audio and
# re-measure the multiface `mixed` residual.
#
# The multiface production replay pinned the worst residual to `mixed`
# scenes (two SIMULTANEOUS speakers, audio bed = sum of both audible
# streams): every crop is scored against a mix whose speech energy
# overlaps its own articulation span — a condition the single-voice
# training corpus never poses (BENCHMARKS.md "Multi-face production
# replay": per-track accuracy 0.56-0.69 on mixed vs 0.88+ elsewhere).
#
# Recipe: --interference-prob training pairs (label-preserving babble
# mix, make_synthetic_dataset.py), 12-epoch finetune from the round-4
# checkpoint, Platt refit, multiface replay re-run in articulation mode,
# plus a seen-construction forgetting check.
#
# Inputs (from lipsync_tpu_torch/tools/regen_r4.sh): /tmp/r4_weights, /tmp/r4ph_calib_pre,
# /tmp/mf_scenes_{2f,3f}, /tmp/unseen_r4/pre_{shift,swap,scramble}.
set -euo pipefail
cd "$(dirname "$0")/../.."

NPC=${NPC:-300}            # clips/class, interference train split
NPC_CAL=${NPC_CAL:-60}     # clips/class, interference calib split
PROB=${PROB:-0.7}
EPOCHS=${EPOCHS:-12}
T=${T:-/tmp/intf_r4}
W0=${W0:-/tmp/r4_weights/best_model_accuracy}
OUT=${OUT:-docs/eval}      # where the replay artifacts land; point at /tmp
SUFFIX=${SUFFIX:-}         # e.g. "_smoke" for reduced-scale validation runs
CAL0=${CAL0:-/tmp/r4ph_calib_pre}   # clean calib split to merge with
MF_DIR=${MF_DIR:-/tmp/mf_scenes}    # multiface scenes at ${MF_DIR}_{2f,3f}
UNSEEN_DIR=${UNSEEN_DIR:-/tmp/unseen_r4}  # pre_{shift,swap,scramble} inside

log() { echo "[$(date +%H:%M:%S)] $*"; }
mkdir -p "$T"

# The [ -d ... ] resume guards below reuse whatever is already in $T. That is
# only sound if the knobs that shaped those artifacts are unchanged, so pin
# them in a sentinel and refuse to resume across a knob change (ADVICE r4).
PARAMS="NPC=$NPC NPC_CAL=$NPC_CAL PROB=$PROB W0=$W0 CAL0=$CAL0"
if [ -f "$T/params.env" ]; then
  if [ "$(cat "$T/params.env")" != "$PARAMS" ]; then
    echo "ERROR: $T holds artifacts built with different knobs:" >&2
    echo "  was: $(cat "$T/params.env")" >&2
    echo "  now: $PARAMS" >&2
    echo "Use a fresh T= dir (or rm -rf $T) when changing NPC/NPC_CAL/PROB/W0/CAL0." >&2
    exit 2
  fi
else
  echo "$PARAMS" > "$T/params.env"
fi

[ -d "$T/raw" ] || { log "generate interference train split"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$T/raw" \
    --n-per-class "$NPC" --style phoneme --jitter --hard-negatives \
    --interference-prob "$PROB" --seed 401; }
[ -d "$T/rawcal" ] || { log "generate interference calib split"; \
  python -m lipsync_tpu_torch.tools.make_synthetic_dataset --output-dir "$T/rawcal" \
    --n-per-class "$NPC_CAL" --style phoneme --jitter --hard-negatives \
    --interference-prob "$PROB" --seed 411; }
for d in raw rawcal; do
  [ -d "$T/pre_$d" ] || { log "precompute $d"; \
    python -m lipsync_tpu_torch.tools.precompute_training_tensors --data-dir "$T/$d" \
      --output-dir "$T/pre_$d" --mode full_sequence; }
done
[ -d "$T/pre_calib" ] || python scripts/merge_preprocessed_dirs.py \
  "$CAL0" "$T/pre_rawcal" --out "$T/pre_calib"

if [ ! -d "$T/weights/best_model_f1" ]; then
  log "finetune $EPOCHS epochs from $W0"
  python -m lipsync_tpu_torch.training.finetune --preprocessed-dir "$T/pre_raw" \
    --checkpoint "$W0" --output-dir "$T/weights" \
    --epochs "$EPOCHS" --frozen-epochs 2 --batch-size 32 --device-cache
fi
WA="$T/weights/best_model_f1"

log "refit Platt"
python -m lipsync_tpu_torch.tools.fit_calibrator --preprocessed-dir "$T/pre_calib" \
  --model-path "$WA" --method platt | tee "$T/platt.txt"
PA=$(awk '/calibration_platt_a/{print $2}' "$T/platt.txt")
PB=$(awk '/calibration_platt_b/{print $2}' "$T/platt.txt")
log "platt a=$PA b=$PB"

log "multiface replays (2f+3f, articulation, interference-adapted; one engine)"
WA="$WA" PA="$PA" PB="$PB" OUT="$OUT" SUFFIX="$SUFFIX" MF_DIR="$MF_DIR" \
python - <<'PYEOF'
import os, sys
sys.path.insert(0, ".")
from lipsync_tpu_torch.inference.engine import load_engine
from lipsync_tpu_torch.tools import eval_multiface

engine = load_engine(os.environ["WA"])
pa, pb = os.environ["PA"], os.environ["PB"]
out, sfx, mf = os.environ["OUT"], os.environ["SUFFIX"], os.environ["MF_DIR"]
for nf in (2, 3):
    print(f"[replay] interference-adapted articulation {nf}f", flush=True)
    eval_multiface.main([
        "--data-dir", f"{mf}_{nf}f",
        "--speaking-score-mode", "articulation",
        "--calibration-method", "platt",
        "--calibration-platt-a", pa, "--calibration-platt-b", pb,
        "--output", f"{out}/multiface_{nf}f_r4_intf{sfx}.json",
    ], engine=engine)
PYEOF

log "forgetting check on the seen constructions"
python -m lipsync_tpu_torch.tools.eval_unseen_fakes --model-path "$WA" \
  --model-name "phoneme_r4_interference" \
  --work-dir "$UNSEEN_DIR" --skip-generate --skip-precompute \
  --constructions shift,swap,scramble --in-process \
  --calibration-platt-a "$PA" --calibration-platt-b "$PB" \
  --output "$T/seen_forgetting.json"
cat "$T/seen_forgetting.json"
log "done"
