"""Operating-point probe of the SAVP train step.

    python -m video_prediction_torch.bench_probe --batch B [--device cuda] [--unroll 1] [--gate split] \\
        [--steps 20] [--sequence_length 12] [--context_frames 2] [--size 64] [--prevent_cse] \\
        [--hparams k=v,...] [--gate_dtype float32]

Port of ``scripts/bench_probe.py``. Times ONE (batch, scan_unroll,
lstm_gate_conv, gate_dtype) configuration of the train step ``bench``
measures (``bench_common.timed_train``: the same hparams, batch and clock,
best of 2 rounds of ``--steps`` chained steps) and prints one ``RESULT ...``
line with the JAX tool's fields; ``compile_s`` is the first step's seconds,
with the kernels' first-use build where it happens. In the port ``--unroll
0`` selects the split mask input. The step recomputes the generator cell in
its backward pass (the hparams' ``remat``, ``full`` by default) unless
``--unroll 0`` without ``--prevent_cse`` (the remat CSE barrier), as the
JAX tool's step does (``models/savp.py#recomputes``). ``--device cuda``
(the default) without a CUDA device raises.

Examples:
    python -m video_prediction_torch.bench_probe --batch 48 --gate split
    python -m video_prediction_torch.bench_probe --batch 16 --unroll 0 --gate merged --steps 30
"""

from __future__ import annotations

import argparse

import torch


def probe(
    batch_size: int,
    unroll: int,
    gate: str,
    n_steps: int = 20,
    sequence_length: int = 12,
    context_frames: int = 2,
    size: int = 64,
    rounds: int = 2,
    prevent_cse: bool = False,
    gate_dtype: str = "float32",
    extra_hparams: str = "",
    device: torch.device | str = "cuda",
) -> dict:
    """Sustained time a step of one configuration; returns the result row."""
    from video_prediction_torch.bench_common import savp_bench_hparams, synthetic_batch, timed_train

    hp = savp_bench_hparams(
        batch_size,
        scan_unroll=unroll,
        lstm_gate_conv=gate,
        prevent_cse=prevent_cse,
        gate_dtype=gate_dtype,
        sequence_length=sequence_length,
        context_frames=context_frames,
        extra=extra_hparams,
    )
    t = timed_train(hp, synthetic_batch(batch_size, sequence_length, size, device), device, n_steps, rounds)
    sec = t["sec_per_step"]
    return {
        "batch": batch_size,
        "unroll": unroll,
        "gate": gate,
        "gate_dtype": gate_dtype,
        "ms_per_step": sec * 1e3,
        "frames_per_sec": batch_size * (sequence_length - context_frames) / sec,
        "compile_s": t["compile_s"],
        "g_loss": float(t["scalars"]["g_loss"]),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, required=True)
    p.add_argument("--unroll", type=int, default=1, help="scan_unroll (0: the split mask input)")
    p.add_argument("--gate", choices=("merged", "split"), default="split")
    p.add_argument("--steps", type=int, default=20, help="chained steps per timing round")
    p.add_argument("--sequence_length", type=int, default=12)
    p.add_argument("--context_frames", type=int, default=2)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--prevent_cse", action="store_true",
                   help="keep the remat CSE barrier at --unroll 0: the cell is recomputed in the backward pass")
    p.add_argument("--hparams", default="", help="extra k=v,... ModelHparams overrides")
    p.add_argument("--gate_dtype", choices=("float32", "bfloat16"), default="float32",
                   help="ConvLSTM gate-math dtype")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from video_prediction_torch.utils.device import device_or_raise

    device = device_or_raise(args.device)
    r = probe(
        args.batch,
        args.unroll,
        args.gate,
        n_steps=args.steps,
        sequence_length=args.sequence_length,
        context_frames=args.context_frames,
        size=args.size,
        prevent_cse=args.prevent_cse,
        gate_dtype=args.gate_dtype,
        extra_hparams=args.hparams,
        device=device,
    )
    r["prevent_cse"] = args.prevent_cse
    r["hparams"] = args.hparams
    print(
        "RESULT batch={batch} unroll={unroll} gate={gate} prevent_cse={prevent_cse} "
        "gate_dtype={gate_dtype} hparams={hparams!r} "
        "ms_per_step={ms_per_step:.1f} frames_per_sec={frames_per_sec:.1f} "
        "compile_s={compile_s:.0f} g_loss={g_loss:.4f}".format(**r),
        flush=True,
    )
    return r


if __name__ == "__main__":
    main()
