#!/usr/bin/env bash
# Round-5 data-generation phase: everything the grand-union flagship
# run (lipsync_tpu_torch/tools/train_union_flagship.sh) and its eval matrix
# need, with no training — so it can overlap with other card work.
#
# Produces (all under /tmp, disposable; this script is the durable recipe):
#   - /tmp/union_flagship/{raw,pre}_*      train/calib/test splits (DATA_ONLY)
#   - /tmp/mf_scenes_{2,3}f                regen-seed multiface replay scenes
#   - /tmp/mf_fresh_{2,3}f                 FRESH-seed multiface scenes
#                                          (VERDICT r4 item 4 done-criterion)
#   - /tmp/unseen_r4/{raw,pre}_<c>         9-construction held-out sets with
#                                          the SAME seeds eval_unseen_fakes.py
#                                          defaults to (seed 101+k, 60/class,
#                                          3 s), so the flagship eval can run
#                                          --skip-generate --skip-precompute
#                                          and stay comparable to the
#                                          committed zero-shot matrix.
set -euo pipefail
cd "$(dirname "$0")/../.."
log() { echo "[$(date +%H:%M:%S)] $*"; }

log "flagship train/calib/test data (DATA_ONLY)"
DATA_ONLY=1 bash lipsync_tpu_torch/tools/train_union_flagship.sh

for nf in 2 3; do
  [ -d "/tmp/mf_scenes_${nf}f" ] || { log "multiface scenes ${nf}f (regen seeds)"; \
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --style multiface \
      --output-dir "/tmp/mf_scenes_${nf}f" --n-faces "$nf" \
      --n-per-class 8 --seconds 7 --seed "1${nf}"; }
  [ -d "/tmp/mf_fresh_${nf}f" ] || { log "multiface scenes ${nf}f (fresh seeds)"; \
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --style multiface \
      --output-dir "/tmp/mf_fresh_${nf}f" --n-faces "$nf" \
      --n-per-class 8 --seconds 7 --seed "81${nf}"; }
done

ALL9=(shift swap scramble warp splice freeze revoice retime composite)
k=0
for c in "${ALL9[@]}"; do
  [ -d "/tmp/unseen_r4/raw_$c" ] || { log "unseen set: $c (seed $((101 + k)))"; \
    python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
      --output-dir "/tmp/unseen_r4/raw_$c" --n-per-class 60 --seconds 3.0 \
      --seed "$((101 + k))" --style phoneme --jitter --fake-modes "$c"; }
  [ -d "/tmp/unseen_r4/pre_$c" ] || { log "unseen precompute: $c"; \
    python -m lipsync_tpu_torch.tools.precompute_training_tensors \
      --data-dir "/tmp/unseen_r4/raw_$c" --output-dir "/tmp/unseen_r4/pre_$c" \
      --mode full_sequence --storage-format zarr; }
  k=$((k + 1))
done

log "datagen complete"
