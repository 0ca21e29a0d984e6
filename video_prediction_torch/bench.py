"""Benchmark: SAVP training throughput on BAIR-shaped 64x64 video, on one GPU.

    python -m video_prediction_torch.bench [--device cuda] [--batches 16,32,64] [--steps N]
        [--sequence_length 12] [--size 64] [--model_hparams k=v,...]
        [--gen_batch 64] [--gen_samples 4]

Port of the JAX package's ``bench.py``. It measures the sustained train
frames/s of the flagship full SAVP model (VAE + GAN, ConvLSTM/CDNA
generator, video SN discriminators; ``bench_common.savp_bench_hparams``) on
the synthetic BAIR-shaped batch (64x64x3, context 2, 10 frames predicted)
with random weights from a seed, at the JAX package's rows: batch 16
(the headline), 32 and 64, bf16 compute and bf16 ConvLSTM gates, gate convs
merged, merged and split, ``scan_unroll=0`` (in the port: the split mask
input, and no recompute: ``models/savp.py#recomputes``). Then the generation row: the eval-path rollout at batch 64 x 4
samples = effective batch 256 (``bench_common.generation_probe``). It prints
ONE JSON line, with the JAX package's keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``device_kind``, ``timing``, ``rows``, ``generation``) and
``power_limit_w`` and ``cudnn_allow_tf32``; each row also has ``peak_gib``
(peak device memory of the row), its last losses and its kernel launches a
timed step, the generation row its ``acc``, ``compile_s``, ``peak_gib`` and
launches a rollout.

Timing: ``bench_common.timed_train``, best of 2 rounds of 30 chained steps
(20 above batch 32), each round ended by one value fetch, after one warm-up
step (the kernels' first-use build, cuDNN's first calls). PyTorch's
TF32 and cuDNN settings are left as the CLIs leave them (cuDNN's benchmark
mode off).

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` on steps after the
timed rounds, at every row:
- ``flops_per_step``: one whole train step, the forward and backward
  convolutions and matrix products it executes (``mfu``);
- ``model_flops_per_step``: 3 x one ``compute_losses(train=True)`` under
  ``torch.no_grad()``, the JAX package's rule (1 forward + 2 backward;
  ``mfu_model``).
What it does not count: elementwise work (norms, activations, the losses,
Adam), which XLA's cost analysis in the JAX package includes, the bodies of
the hand-written kernels K1-K3 (not PyTorch operators; on the CPU, where
their plain versions run, K3's ``einsum`` is counted), and the spectral
norm's matrix-vector products (``aten.mv`` has no FLOP formula; its
``einsum`` for sigma is counted). So the port's ``mfu`` is not the JAX
package's ``mfu`` and no target for it. ``mfu`` is against the dense bf16
peak of the card (``PEAK_BF16_FLOPS``, NVIDIA's published figures), null for
a card not in the table and on the CPU.

The generation row is not wrapped in ``try``: a failure there fails the run.
Non-finite losses or a non-finite rollout sum exit 1. ``--device cuda``
(the default) without a CUDA device raises; ``--device cpu`` runs the same
code on the CPU, where the kernels are their plain versions and nothing
launches.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
from typing import List, Optional

import torch

from video_prediction_torch.bench_common import (
    CONTEXT,
    SEED,
    SEQ_LEN,
    SIZE,
    generation_probe,
    launches_since,
    savp_bench_hparams,
    synthetic_batch,
    timed_train,
)
from video_prediction_torch.utils.device import device_or_raise

REF_BASELINE_FRAMES_PER_SEC = 300.0  # the JAX package's estimate of the TF1 GPU baseline (its bench.py docstring)

HEADLINE_BATCH = 16
BATCHES = (16, 32, 64)
# the JAX package's rows: the scan fully unrolled (in the port, scan_unroll=0
# selects the split mask input), gate convs merged at 16 and 32 and split at
# 64, bf16 gates; PREVENT_CSE (the remat CSE barrier) is set in no row, so
# no row recomputes the cell in its backward pass, in JAX (XLA merges the
# recompute back) or in the port (models/savp.py#recomputes)
UNROLL = {16: 0, 32: 0, 64: 0}
GATE_CONV = {16: "merged", 32: "merged", 64: "split"}
PREVENT_CSE: dict[int, bool] = {}
GATE_DTYPE = {16: "bfloat16", 32: "bfloat16", 64: "bfloat16"}
ROUNDS = 2
GEN_BATCH, GEN_SAMPLES, GEN_ROLLOUTS = 64, 4, 15

# dense (no sparsity) bf16 tensor-core peak by torch.cuda.get_device_name,
# from NVIDIA's H100 data sheets; a card not here reports mfu null
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # SXM5
    "NVIDIA H100 PCIe": 756.5e12,
}

METRIC = "train_frames_per_sec_per_chip_bair64_savp"
TIMING = ("sustained: best of 2 rounds of chained train steps, each round ended by one value fetch of g_loss, "
          "which waits for every queued CUDA kernel; host clock")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--batches", default=",".join(map(str, BATCHES)), help="comma-separated train batch sizes")
    p.add_argument("--steps", type=int, default=0, help="chained steps a round (0: 30 up to batch 32, 20 above)")
    p.add_argument("--sequence_length", type=int, default=SEQ_LEN)
    p.add_argument("--size", type=int, default=SIZE, help="frame height and width")
    p.add_argument("--model_hparams", default="", help="extra k=v,... ModelHparams overrides, every row")
    p.add_argument("--gen_batch", type=int, default=GEN_BATCH, help="generation row: eval batch")
    p.add_argument("--gen_samples", type=int, default=GEN_SAMPLES, help="generation row: samples a rollout")
    return p.parse_args(argv)


def peak_flops(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in W as ``nvidia-smi`` reports it; None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


def step_flops(step_fn, ts, batch) -> float:
    """FLOPs that ``FlopCounterMode`` counts in one train step (it takes the step)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        float(step_fn(ts, batch)["g_loss"])
    return float(counter.get_total_flops())


def forward_flops(model, batch) -> float:
    """FLOPs that ``FlopCounterMode`` counts in one ``compute_losses`` at
    step 0 under ``torch.no_grad()``: the loss's forward, no backward."""
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator(device=batch["images"].device).manual_seed(SEED)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.compute_losses(batch, 0, generator=gen)
    return float(counter.get_total_flops())


def peak_gib(device: torch.device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None


def reset_peak(device: torch.device) -> None:
    """Free what the last row left and start a new peak."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def bench_row(batch_size: int, n_steps: int, sequence_length: int, size: int, extra: str,
              device: torch.device) -> dict:
    """One train row: sec a step, the FLOP counts, the peak memory, the last
    losses and the kernel launches a timed step."""
    hp = savp_bench_hparams(
        batch_size,
        scan_unroll=UNROLL.get(batch_size, 1),
        lstm_gate_conv=GATE_CONV.get(batch_size, "merged"),
        prevent_cse=PREVENT_CSE.get(batch_size, False),
        gate_dtype=GATE_DTYPE.get(batch_size, "float32"),
        sequence_length=sequence_length,
        extra=extra,
    )
    reset_peak(device)
    batch = synthetic_batch(batch_size, sequence_length, size, device)
    t = timed_train(hp, batch, device, n_steps, ROUNDS)
    row = {
        "sec_per_step": t["sec_per_step"],
        "peak_gib": peak_gib(device),
        "g_loss": float(t["scalars"]["g_loss"]),
        "d_loss": float(t["scalars"]["d_loss"]),
        "launches_per_step": t["launches_per_step"],
    }
    # counted on steps after the timed rounds
    row["flops"] = step_flops(t["step_fn"], t["ts"], batch)
    row["model_flops"] = 3.0 * forward_flops(t["ts"].model, batch)
    return row


def main(argv=None) -> dict:
    """Run the bench; print its JSON line and return it as a dict."""
    args = parse_args(argv)
    device = device_or_raise(args.device)
    from video_prediction_torch import kernels as K

    batches: List[int] = [int(b) for b in args.batches.split(",")]
    headline = HEADLINE_BATCH if HEADLINE_BATCH in batches else batches[0]
    peak = peak_flops(device)
    frames_per_example = args.sequence_length - CONTEXT

    rows = {}
    for bs in batches:
        r = bench_row(bs, args.steps or (30 if bs <= 32 else 20), args.sequence_length, args.size,
                      args.model_hparams, device)
        sec = r["sec_per_step"]
        rows[f"batch{bs}"] = {
            "frames_per_sec_per_chip": round(bs * frames_per_example / sec, 2),
            "ms_per_step": round(sec * 1e3, 3),
            "mfu": round(r["flops"] / sec / peak, 4) if peak else None,
            "mfu_model": round(r["model_flops"] / sec / peak, 4) if peak else None,
            "flops_per_step": r["flops"],
            "model_flops_per_step": r["model_flops"],
            "peak_gib": r["peak_gib"],
            "g_loss": r["g_loss"],
            "d_loss": r["d_loss"],
            "launches_per_step": r["launches_per_step"],
        }
    bad = {k: (row["g_loss"], row["d_loss"]) for k, row in rows.items()
           if not (math.isfinite(row["g_loss"]) and math.isfinite(row["d_loss"]))}
    if bad:
        print(json.dumps({"error": f"non-finite losses (g, d): {bad}"}), file=sys.stderr)
        raise SystemExit(1)

    # the eval-side rollout at effective batch gen_batch x gen_samples; a
    # failure here fails the run
    reset_peak(device)
    before = K.launch_counts()
    g = generation_probe(args.gen_batch, args.gen_samples, n_rollouts=GEN_ROLLOUTS,
                         sequence_length=args.sequence_length, size=args.size, rounds=ROUNDS,
                         extra_hparams=args.model_hparams, device=device)
    if not math.isfinite(g["acc"]):
        print(json.dumps({"error": f"non-finite generation rollout sum {g['acc']}"}), file=sys.stderr)
        raise SystemExit(1)
    generation = {
        "gen_frames_per_sec_per_chip": round(g["gen_frames_per_sec"], 2),
        "ms_per_rollout": round(g["ms_per_rollout"], 3),
        "effective_batch": g["effective_batch"],
        "acc": g["acc"],
        "compile_s": g["compile_s"],
        "peak_gib": peak_gib(device),
        # the first rollout and the timed ones
        "launches_per_rollout": launches_since(before, 1 + ROUNDS * GEN_ROLLOUTS),
    }

    value = rows[f"batch{headline}"]["frames_per_sec_per_chip"]
    line = {
        "metric": METRIC,
        "value": value,
        "unit": "frames/sec/chip",
        "vs_baseline": round(value / REF_BASELINE_FRAMES_PER_SEC, 3),
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "power_limit_w": power_limit_w(device),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "timing": TIMING,
        "rows": rows,
        "generation": generation,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
