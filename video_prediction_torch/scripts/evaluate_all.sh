#!/usr/bin/env bash
# Evaluate every trained run under a runs root with the PyTorch port (the port of scripts/evaluate_all.sh).
# Usage: evaluate_all.sh <runs_root/dataset> <test_input_dir> <results_dir> [extra python -m video_prediction_torch.evaluate flags...]
set -euo pipefail
RUNS=${1:?usage: $0 <runs_root/dataset> <test_input_dir> <results_dir> [flags...]}
INPUT_DIR=${2?missing input_dir (may be empty: "")}
RESULTS=${3:?}
shift 3
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
for run in "$RUNS"/*/; do
  [ -f "$run/options.json" ] || continue
  echo "=== evaluating $run ==="
  PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" python -m video_prediction_torch.evaluate --checkpoint "$run" \
    --input_dir "$INPUT_DIR" --results_dir "$RESULTS" "$@"
done
