"""Profile the train step: the device's busy share and where its time goes.

    python -m video_prediction_torch.train.profile_step [--device cuda] [--batch_size 16] \\
        [--tf32] [--steps 2] [--model_hparams k=v,...] [--top 15]

Port of ``scripts/profile_step.py``. Builds the flagship (the ``savp``
defaults overridden by ``hparams/bair_action_free/ours_savp``, then by
``--model_hparams``) with random weights from a seed, runs ``WARMUP``
train steps on one fixed device batch of the ``synthetic`` dataset, times
``--steps`` steps unprofiled, then records ``--steps`` more under
``torch.profiler`` (device activity only, so that the host runs nearly as
unprofiled) in one window, synchronized at both ends. It prints the
device kernels that take the most time and, as its last line, one JSON
object of per-step figures:

- ``step_ms``: an unprofiled step, host clock between synchronizations;
- ``window_ms``: the profiled window's host wall time;
- ``busy_ms``: the union of the intervals of the device's kernels, copies
  and sets within that window; ``busy_share`` is ``busy_ms / window_ms``.
  What the profiler costs the host is inside the window, so the share is
  a lower bound of an unprofiled step's (compare ``window_ms`` with
  ``step_ms``);
- ``device_ms``: the summed durations of the device events by group:
  ``conv_gemm`` (cuDNN and cuBLAS kernels and their layout transforms),
  ``K1``, ``K2``, ``K3`` (the port's kernels, forward and backward), and
  ``other``; ``launches``: device events per step.

On the CPU there are no device events: the busy and device figures are 0.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from typing import Dict, List, Tuple

import torch

SEED = 0
WARMUP = 3
GROUPS = (
    ("K1", re.compile(r"\bcdna_(forward|backward)_kernel|\bcdna_kernel_grad_reduce")),
    ("K2", re.compile(r"\bln_gate_(forward|backward)_kernel|\bln_grad_reduce")),
    ("K3", re.compile(r"\bcomposite_(forward|backward)_kernel")),
    ("conv_gemm", re.compile(r"conv|cudnn|xmma|gemm|cutlass|wgrad|dgrad|fprop|winograd|nchw|nhwc|fft|"
                             r"pointwise_mult_and_sum_complex", re.I)),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--model_hparams", default="", help="comma-separated k=v overrides of ours_savp")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--tf32", action="store_true", help="TF32 convs and matmuls (off: full fp32)")
    p.add_argument("--steps", type=int, default=2, help="steps timed, and steps profiled")
    p.add_argument("--top", type=int, default=15)
    return p.parse_args(argv)


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if pattern.search(name):
            return group
    return "other"


def union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Length in ms of the union of ``intervals`` (us)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total / 1e3


def main(argv=None) -> Dict[str, object]:
    args = parse_args(argv)

    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = args.tf32
        torch.backends.cuda.matmul.allow_tf32 = args.tf32
    zoo = zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo), args.model_hparams or None,
                               extra=dict(batch_size=args.batch_size))
    raw = next(SyntheticVideoDataset(mode="train", seed=SEED).make_iterator(hp.batch_size))
    data = batch_to_device({k: v[:, : hp.sequence_length] for k, v in raw.items()}, device)
    actions = data.get("actions")
    model = get_model_class("savp")(hp, image_shape=tuple(data["images"].shape[2:]),
                                    action_dim=0 if actions is None else actions.shape[-1])
    ts = create_train_state(model, SEED, device)
    step = make_train_step(model)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(WARMUP):
        step(ts, data)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(ts, data)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[activity]) as prof:
        sync()  # the device is idle here: every device event below is the window's
        t0 = time.perf_counter()
        for _ in range(args.steps):
            scalars = step(ts, data)
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    # kernels, copies and sets; not the ranges that annotate them
    device_events = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CPU
                     and not getattr(e, "is_user_annotation", False)]
    busy_ms = union_ms([(e.time_range.start, e.time_range.end) for e in device_events]) / args.steps

    by_group = {g: 0.0 for g, _ in GROUPS}
    by_group["other"] = 0.0
    by_name: Dict[str, List[float]] = {}
    for e in device_events:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / args.steps
        by_group[group_of(e.name)] += ms
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"{ms:9.3f} ms {n / args.steps:7.1f}x  [{group_of(name)}] {name[:100]}")

    summary = {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "batch_size": hp.batch_size, "tf32": bool(args.tf32 and cuda), "steps": args.steps,
        "step_ms": step_ms, "window_ms": window_ms, "busy_ms": busy_ms,
        "busy_share": busy_ms / window_ms,
        "device_ms": by_group, "launches": len(device_events) / args.steps,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "finite": all(bool(torch.isfinite(v)) for v in scalars.values()),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
