#!/usr/bin/env bash
# Train every zoo variant for a dataset with the PyTorch port (the port of scripts/train_all.sh).
# Usage: train_all.sh <dataset> <input_dir> <runs_root> [extra python -m video_prediction_torch.train flags...]
set -euo pipefail

DATASET=${1:?usage: $0 <dataset> <input_dir> <runs_root> [flags...]}
INPUT_DIR=${2?missing input_dir (may be empty: "")}
RUNS=${3:?}
shift 3

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
ZOO="$REPO/hparams/$DATASET"
[ -d "$ZOO" ] || { echo "no hparams zoo for dataset '$DATASET' under $ZOO" >&2; exit 1; }

for variant_dir in "$ZOO"/*/; do
  variant="$(basename "$variant_dir")"
  json="$variant_dir/model_hparams.json"
  [ -f "$json" ] || continue
  # model class: dna_*/sna_*/sv2p* variants map to their model; ours_* -> savp
  case "$variant" in
    dna*) model=dna ;;
    sna*) model=sna ;;
    sv2p*) model=sv2p ;;
    *) model=savp ;;
  esac
  echo "=== $DATASET/$variant (model=$model) ==="
  PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" python -m video_prediction_torch.train \
    --dataset "$DATASET" --input_dir "$INPUT_DIR" \
    --model "$model" --model_hparams_dict "$json" \
    --output_dir "$RUNS/$DATASET/$variant" "$@"
done
