"""Generation (inference) throughput probe: the eval-side workload.

    python -m video_prediction_torch.bench_generate [--device cuda] [--batch 16] [--samples 8] \\
        [--unroll 0] [--gate split] [--gate_dtype bfloat16] [--rollouts 20] [--sequence_length 12] \\
        [--context_frames 2] [--size 64] [--hparams k=v,...]

Port of ``scripts/bench_generate.py``. ``evaluate`` puts a batch's
stochastic samples on the device together (effective batch = batch x
samples); this probe times that rollout (``bench_common.generation_probe``:
``forward(train=False)`` under ``torch.no_grad()``, random weights from a
seed, rollout means summed into one device scalar and fetched once a round)
at one operating point and prints one ``RESULT ...`` line with the JAX
tool's fields. ``--unroll`` is ``scan_unroll`` (0: the split mask input in
the port). ``--device cuda`` (the default) without a CUDA device raises.

Examples:
    python -m video_prediction_torch.bench_generate --batch 16 --samples 4
    python -m video_prediction_torch.bench_generate --batch 64 --samples 16 --gate_dtype bfloat16
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16, help="eval batch_size")
    p.add_argument(
        "--samples",
        type=int,
        default=8,
        help="samples_per_rollout (evaluate's default 8); effective device batch is batch x samples",
    )
    p.add_argument("--unroll", type=int, default=0, help="scan_unroll (0: the split mask input)")
    p.add_argument("--gate", choices=("merged", "split"), default="split")
    p.add_argument("--gate_dtype", choices=("float32", "bfloat16"), default="bfloat16")
    p.add_argument("--rollouts", type=int, default=20, help="chained rollouts per round")
    p.add_argument("--sequence_length", type=int, default=12)
    p.add_argument("--context_frames", type=int, default=2)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--hparams", default="", help="extra k=v,... ModelHparams overrides")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from video_prediction_torch.bench_common import generation_probe
    from video_prediction_torch.utils.device import device_or_raise

    device = device_or_raise(args.device)
    r = generation_probe(
        args.batch,
        args.samples,
        unroll=args.unroll,
        gate=args.gate,
        gate_dtype=args.gate_dtype,
        n_rollouts=args.rollouts,
        sequence_length=args.sequence_length,
        context_frames=args.context_frames,
        size=args.size,
        extra_hparams=args.hparams,
        device=device,
    )
    print(
        "RESULT batch={batch} samples={samples_per_rollout} eff={effective_batch} "
        "unroll={unroll} gate={gate} gate_dtype={gate_dtype} "
        "ms_per_rollout={ms_per_rollout:.1f} gen_frames_per_sec={gen_frames_per_sec:.0f} "
        "compile_s={compile_s:.0f}".format(**r),
        flush=True,
    )
    return r


if __name__ == "__main__":
    main()
