#!/usr/bin/env bash
# Convergence, stage (a): ARCHITECTURE.md's round-3 anchor with the PyTorch port.
# hparams/synthetic/ours_savp as the zoo file stands, batch 16, STEPS steps (2000) with
# --steps_per_call 4, one run a seed; then evaluate (best of 4 stochastic samples, 64 test
# sequences) on each run and on the repeat baseline. Prints one "convergence <name>: psnr_max ...
# ssim_max ..." line a run, the means of evaluate's {psnr,ssim}_max.txt.
# Usage: convergence.sh <runs_root> [seed...]   (default seeds 7 8)
# Env: STEPS (2000), DEVICE (cuda), BATCH (16); MODEL_HPARAMS, k=v overrides of the zoo file for a
# rehearsal at a small width on the CPU (the anchor takes none).
set -euo pipefail

RUNS=${1:?usage: $0 <runs_root> [seed...]}
shift
SEEDS=("$@")
[ ${#SEEDS[@]} -gt 0 ] || SEEDS=(7 8)
STEPS=${STEPS:-2000}
DEVICE=${DEVICE:-cuda}
BATCH=${BATCH:-16}

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
EVAL=(--num_samples 64 --num_stochastic_samples 4 --only_metrics --device "$DEVICE")

report() {  # <name> <results dir>: the means of the best-of-4 metric files
  python - "$1" "$2" <<'EOF'
import glob, sys

import numpy as np

name, results = sys.argv[1], sys.argv[2]
means = {m: float(np.loadtxt(glob.glob(f"{results}/**/{m}_max.txt", recursive=True)[0]).mean())
         for m in ("psnr", "ssim")}
print(f"convergence {name}: psnr_max {means['psnr']} ssim_max {means['ssim']}")
EOF
}

for seed in "${SEEDS[@]}"; do
  run="$RUNS/seed$seed"
  start=$(date +%s)
  python -m video_prediction_torch.train --dataset synthetic --model savp \
    --model_hparams_dict "$REPO/hparams/synthetic/ours_savp/model_hparams.json" --output_dir "$run" \
    --model_hparams "${MODEL_HPARAMS:-}" --batch_size "$BATCH" --max_steps "$STEPS" --steps_per_call 4 \
    --seed "$seed" --device "$DEVICE" \
    --progress_freq 500 --summary_freq 100 --image_summary_freq 0 --eval_summary_freq 0 \
    --accum_eval_summary_freq 0 --save_freq "$STEPS"
  echo "convergence seed$seed: trained $STEPS steps in $(($(date +%s) - start)) s"
  python -m video_prediction_torch.evaluate --checkpoint "$run" --results_dir "$RUNS/results_seed$seed" "${EVAL[@]}"
  report "seed$seed" "$RUNS/results_seed$seed"
done
python -m video_prediction_torch.evaluate --model repeat --dataset synthetic --results_dir "$RUNS/results_repeat" \
  "${EVAL[@]}"
report repeat "$RUNS/results_repeat"
