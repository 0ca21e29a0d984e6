#!/usr/bin/env bash
# Convergence of the PyTorch port against ARCHITECTURE.md's anchors, in two stages (STAGE).
#
# Stage a (default): the round-3 anchor. hparams/synthetic/ours_savp as the zoo file stands,
# batch 16, STEPS steps (2000) with --steps_per_call 4, one run a seed; then evaluate (best of 4
# stochastic samples, 64 test sequences) on each run and on the repeat baseline.
#
# Stage b: the round-5 crossover. The same zoo file with gate_dtype=bfloat16,
# schedule_sampling_k=900 and kl_anneal_steps=[4000,8000], one seed, STEPS steps (10000) with
# --steps_per_call 4 and --save_freq SAVE_FREQ (500), in legs that stop at each of STOPS
# (2000 5000) and at STEPS, each evaluated as above and --resume'd; in the leg that passes
# KILL_AFTER (3500) the train process is killed with SIGKILL KILL_DELAY seconds (12: about 100
# steps) after that step is kept, then --resume'd from the newest kept step. Then the repeat
# baseline, and the loss, KL and scheduled-sampling curves from the event files
# (utils/summary.py#read_events): one "curve step N: ..." line every SAVE_FREQ steps, and d_loss's
# mean before and after the crossover (p(ground truth) = 0.5).
#
# Prints one "convergence <name>: psnr_max ... ssim_max ..." line a run or step, the means of
# evaluate's {psnr,ssim}_max.txt.
# Usage: convergence.sh <runs_root> [seed...]   (default seeds: stage a 7 8, stage b 7)
# Env: STAGE (a), STEPS (a 2000, b 10000), DEVICE (cuda), BATCH (16), SUMMARY_FREQ (100); stage b:
# STOPS, SAVE_FREQ, KILL_AFTER, KILL_DELAY; MODEL_HPARAMS, k=v overrides of the zoo file for a rehearsal at a small
# width on the CPU (the anchors take none).
set -euo pipefail

RUNS=${1:?usage: $0 <runs_root> [seed...]}
shift
SEEDS=("$@")
STAGE=${STAGE:-a}
DEVICE=${DEVICE:-cuda}
BATCH=${BATCH:-16}

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
EVAL=(--num_samples 64 --num_stochastic_samples 4 --only_metrics --device "$DEVICE")
TRAIN=(--dataset synthetic --model savp --model_hparams_dict "$REPO/hparams/synthetic/ours_savp/model_hparams.json"
       --batch_size "$BATCH" --steps_per_call 4 --device "$DEVICE" --summary_freq "${SUMMARY_FREQ:-100}"
       --image_summary_freq 0 --eval_summary_freq 0 --accum_eval_summary_freq 0)

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

latest() {  # <run dir>: the newest kept checkpoint step
  python -c "import sys; from video_prediction_torch.train.checkpoint import latest_step; print(latest_step(sys.argv[1]))" "$1"
}

curves() {  # <run dir> <save freq>: the summaries of every event file, the newest file's where steps repeat
  python - "$1" "$2" <<'EOF'
import glob, sys

from video_prediction_torch.utils.summary import read_events

run, every = sys.argv[1], int(sys.argv[2])
by_step = {}
for path in sorted(glob.glob(f"{run}/events.out.tfevents.*")):
    for event in read_events(path):
        scalars = {tag: v for tag, v in event.values if isinstance(v, float)}
        if scalars:
            by_step.setdefault(event.step, {}).update(scalars)
tags = ("g_loss", "d_loss", "g/l1", "g/kl", "kl_weight", "schedule_sampling_prob")
for step in sorted(s for s in by_step if s % every == 0):
    print(f"curve step {step}: " + " ".join(f"{t}={by_step[step][t]:.6g}" for t in tags if t in by_step[step]))
cross = min((s for s in sorted(by_step) if by_step[s].get("schedule_sampling_prob", 1.0) <= 0.5), default=None)
for name, steps in (("before", [s for s in by_step if cross is None or s < cross]),
                    ("after", [s for s in by_step if cross is not None and s >= cross])):
    d = [by_step[s]["d_loss"] for s in steps if "d_loss" in by_step[s]]
    print(f"curve d_loss {name} the crossover (step {cross}): mean {sum(d) / len(d) if d else float('nan'):.6g} "
          f"over {len(d)} summaries, last {d[-1] if d else float('nan'):.6g}")
EOF
}

if [ "$STAGE" = a ]; then
  [ ${#SEEDS[@]} -gt 0 ] || SEEDS=(7 8)
  STEPS=${STEPS:-2000}
  for seed in "${SEEDS[@]}"; do
    run="$RUNS/seed$seed"
    start=$(date +%s)
    python -m video_prediction_torch.train "${TRAIN[@]}" --output_dir "$run" --model_hparams "${MODEL_HPARAMS:-}" \
      --max_steps "$STEPS" --seed "$seed" --progress_freq 500 --save_freq "$STEPS"
    echo "convergence seed$seed: trained $STEPS steps in $(($(date +%s) - start)) s"
    python -m video_prediction_torch.evaluate --checkpoint "$run" --results_dir "$RUNS/results_seed$seed" "${EVAL[@]}"
    report "seed$seed" "$RUNS/results_seed$seed"
  done
elif [ "$STAGE" = b ]; then
  [ ${#SEEDS[@]} -gt 0 ] || SEEDS=(7)
  STEPS=${STEPS:-10000}
  read -r -a STOPS <<< "${STOPS:-2000 5000}"
  SAVE_FREQ=${SAVE_FREQ:-500}
  KILL_AFTER=${KILL_AFTER:-3500}
  KILL_DELAY=${KILL_DELAY:-12}
  HP="gate_dtype=bfloat16,schedule_sampling_k=900,kl_anneal_steps=[4000,8000]${MODEL_HPARAMS:+,$MODEL_HPARAMS}"
  for seed in "${SEEDS[@]}"; do
    run="$RUNS/b_seed$seed"
    args=("${TRAIN[@]}" --output_dir "$run" --model_hparams "$HP" --seed "$seed" --progress_freq "$SAVE_FREQ"
          --save_freq "$SAVE_FREQ")
    resume=()
    for stop in "${STOPS[@]}" "$STEPS"; do
      start=$(date +%s)
      have=$(latest "$run")
      [ "$have" != None ] || have=0
      if [ -n "$KILL_AFTER" ] && [ "$have" -lt "$KILL_AFTER" ] && [ "$stop" -gt "$KILL_AFTER" ]; then
        python -m video_prediction_torch.train "${args[@]}" "${resume[@]}" --max_steps "$stop" &
        pid=$!
        while kill -0 "$pid" 2>/dev/null && [ ! -d "$run/checkpoints/$KILL_AFTER" ]; do sleep 0.2; done
        sleep "$KILL_DELAY"
        kill -9 "$pid" 2>/dev/null || true
        wait "$pid" || true
        echo "convergence b_seed$seed: killed with SIGKILL $KILL_DELAY s after step $KILL_AFTER was kept;" \
             "resuming from step $(latest "$run")"
        resume=(--resume)
      fi
      python -m video_prediction_torch.train "${args[@]}" "${resume[@]}" --max_steps "$stop"
      resume=(--resume)
      echo "convergence b_seed$seed: trained to step $stop in $(($(date +%s) - start)) s"
      results="$RUNS/results_b_seed${seed}_step$stop"
      python -m video_prediction_torch.evaluate --checkpoint "$run" --results_dir "$results" "${EVAL[@]}"
      report "b_seed${seed}_step$stop" "$results"
    done
    curves "$run" "$SAVE_FREQ"
  done
else
  echo "STAGE must be a or b, got $STAGE" >&2
  exit 2
fi
python -m video_prediction_torch.evaluate --model repeat --dataset synthetic --results_dir "$RUNS/results_repeat" \
  "${EVAL[@]}"
report repeat "$RUNS/results_repeat"
