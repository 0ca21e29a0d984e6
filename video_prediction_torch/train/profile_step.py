"""Profile the train step: the device's busy share and where its time goes.

    python -m video_prediction_torch.train.profile_step [--device cuda] [--model savp] [--batch_size 16] \\
        [--tf32] [--steps 2] [--model_hparams_dict FILE] [--model_hparams k=v,...] [--sequence_length T] \\
        [--context_frames C] [--image_size 64] [--outdir DIR] [--top 15]
    python -m video_prediction_torch.train.profile_step --model dna \\
        --model_hparams_dict hparams/bair/dna_l2/model_hparams.json --tf32

Port of ``scripts/profile_step.py``. Builds ``--model`` with random weights
from a seed: its class's defaults overridden by ``--model_hparams_dict``
(without it, by ``hparams/bair_action_free/ours_savp`` for ``savp``, the
flagship, and by nothing for the other models), then by
``--model_hparams``, then by ``--sequence_length``, ``--context_frames`` and
``--batch_size`` where given. It runs ``WARMUP`` train steps on one fixed
device batch of the ``synthetic`` dataset (``--image_size`` px, the
hparams' sequence structure), times ``--steps`` steps unprofiled, then
records ``--steps`` more under ``torch.profiler`` (device activity only, so
that the host runs nearly as unprofiled) in one window, synchronized at both
ends, whose trace it writes to ``--outdir`` (default: a new temporary
directory, kept) as ``trace.json`` (Chrome trace format; the last window
profiled) and names. ``ground_truth`` and ``repeat`` have no train step and
raise. It prints the device kernels that take the most time and, as its last
line, one JSON object of per-step figures:

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
  ``other``; ``launches``: device events per step;
- ``phase_ms``: the last profiled step's phases in device ms, from the
  step's own events (``losses``, ``backward``, ``update``;
  ``utils/trace.py#StepPhases``), None on the CPU.

The window is checked against the kernel wrappers' launch counters: each
launch of a wrapper gives ``KERNELS_PER_LAUNCH`` device events of its
group, so the window must hold exactly that many K1, K2 and K3 events. The
profiler now and then loses device records; a window that holds another
count is profiled again, up to ``WINDOWS`` windows in all. ``windows`` says
how many were profiled; if none was whole, ``shortfall`` gives each group's
events against the expected count and that group's ``device_ms`` is None,
not too short a time.

On the CPU there are no device events: the busy and device figures are 0.
``--device cuda`` (the default) without a CUDA device raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

SEED = 0
WARMUP = 3
WINDOWS = 5
GROUPS = (
    ("K1", re.compile(r"\bcdna_(forward|backward)_kernel|\bcdna_kernel_grad_reduce")),
    ("K2", re.compile(r"\bln_gate_(forward|backward)_kernel|\bln_(gate_)?grad_reduce")),
    ("K3", re.compile(r"\bcomposite_(forward|backward)_kernel")),
    ("conv_gemm", re.compile(r"conv|cudnn|xmma|gemm|cutlass|wgrad|dgrad|fprop|winograd|nchw|nhwc|fft|"
                             r"pointwise_mult_and_sum_complex", re.I)),
)


# device kernels one call of each wrapper launches: (group, events); the
# backward kernels of K1 and K2 each add a reduce kernel
KERNELS_PER_LAUNCH = {
    "apply_cdna_kernels": ("K1", 1), "apply_cdna_kernels_backward": ("K1", 2),
    "fused_ln_gate": ("K2", 1), "fused_ln_gate_backward": ("K2", 2),
    "composite": ("K3", 1), "composite_backward": ("K3", 1),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="savp", help="a trainable model of models.get_model_class")
    p.add_argument("--model_hparams_dict", default="",
                   help="JSON file of model hparams (default: the ours_savp zoo file for savp, none otherwise)")
    p.add_argument("--model_hparams", default="", help="comma-separated k=v overrides")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--sequence_length", type=int, default=0, help="0: the hparams'")
    p.add_argument("--context_frames", type=int, default=0, help="0: the hparams'")
    p.add_argument("--image_size", type=int, default=64, help="the synthetic frames' height and width")
    p.add_argument("--outdir", default="", help="trace directory (default: a new temporary directory, kept)")
    p.add_argument("--tf32", action="store_true", help="TF32 convs and matmuls (off: full fp32)")
    p.add_argument("--steps", type=int, default=2, help="steps timed, and steps profiled")
    p.add_argument("--top", type=int, default=15)
    return p.parse_args(argv)


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if pattern.search(name):
            return group
    return "other"


def window_shortfall(events: List[Tuple[str, float, float]], launches: Dict[str, int]) -> Dict[str, List[int]]:
    """Groups whose device events in ``events`` (name, start, end) disagree
    with the wrappers' ``launches`` in the same window: group -> [events,
    expected]. Empty for a whole window."""
    want: Dict[str, int] = {}
    for wrapper, n in launches.items():
        group, per_launch = KERNELS_PER_LAUNCH[wrapper]
        want[group] = want.get(group, 0) + n * per_launch
    got = {group: 0 for group in want}
    for name, _, _ in events:
        group = group_of(name)
        if group in got:
            got[group] += 1
    return {group: [got[group], want[group]] for group in want if got[group] != want[group]}


def profile_window(step, steps: int, cuda: bool, sync, trace: str = ""):
    """One profiled window of ``steps`` calls of ``step()``: its device events
    (name, start, end in us), host wall ms per step, the last step's
    scalars and the wrappers' launch counts over the window. The window's
    trace goes to the file ``trace`` where one is named."""
    from video_prediction_torch import kernels as K

    activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    K.reset_launch_counts()
    with torch.profiler.profile(activities=[activity]) as prof:
        sync()  # the device is idle here: every device event below is the window's
        t0 = time.perf_counter()
        for _ in range(steps):
            scalars = step()
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3 / steps
    if trace:
        prof.export_chrome_trace(trace)
    # kernels, copies and sets; not the ranges that annotate them
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU and not getattr(e, "is_user_annotation", False)]
    return events, window_ms, scalars, K.launch_counts()


def whole_window(profile: Callable[[], tuple], windows: int = WINDOWS) -> tuple:
    """Profile a window with ``profile()`` (events, window ms, scalars,
    launch counts) until its events agree with its launch counts, at most
    ``windows`` times: (events, window ms, scalars, windows run, shortfall
    of the last window)."""
    for n in range(1, windows + 1):
        events, window_ms, scalars, launches = profile()
        shortfall = window_shortfall(events, launches)
        if not shortfall:
            break
        print(f"profile window {n}: device events short of the launch counts {launches}: "
              f"{json.dumps(shortfall)} (group: [events, expected])")
    return events, window_ms, scalars, n, shortfall


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

    from video_prediction_torch.configs.hparams import DatasetHparams, resolve_model_hparams, zoo_dir
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class, input_dims, trainable_models
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step
    from video_prediction_torch.utils.device import device_or_raise
    from video_prediction_torch.utils.trace import phase_ms

    model_cls = get_model_class(args.model)
    if not model_cls.trainable:
        raise ValueError(f"--model {args.model} has no train step; the trainable models are "
                         f"{trainable_models()}")
    device = device_or_raise(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = args.tf32
        torch.backends.cuda.matmul.allow_tf32 = args.tf32
    hparams_dict = args.model_hparams_dict
    if not hparams_dict and args.model == "savp":
        hparams_dict = str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json")
    extra = {k: v for k, v in (("sequence_length", args.sequence_length), ("context_frames", args.context_frames))
             if v}
    hp = resolve_model_hparams(model_cls.default_hparams(), hparams_dict or None, args.model_hparams or None,
                               extra=dict(extra, batch_size=args.batch_size))
    dhp = DatasetHparams(context_frames=hp.context_frames, sequence_length=hp.sequence_length)
    raw = next(SyntheticVideoDataset(mode="train", hparams=dhp, seed=SEED, image_size=args.image_size)
               .make_iterator(hp.batch_size))
    data = batch_to_device(raw, device)
    model = model_cls(hp, **input_dims(hp, data))
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

    outdir = args.outdir or tempfile.mkdtemp(prefix="profile_step_")
    os.makedirs(outdir, exist_ok=True)
    trace = os.path.join(outdir, "trace.json")
    device_events, window_ms, scalars, windows, shortfall = whole_window(
        lambda: profile_window(lambda: step(ts, data), args.steps, cuda, sync, trace))
    busy_ms = union_ms([(start, end) for _, start, end in device_events]) / args.steps

    by_group: Dict[str, object] = {g: 0.0 for g, _ in GROUPS}
    by_group["other"] = 0.0
    by_name: Dict[str, List[float]] = {}
    for name, start, end in device_events:
        ms = (end - start) / 1e3 / args.steps
        by_group[group_of(name)] += ms
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    for group in shortfall:
        by_group[group] = None  # events lost: no time rather than too short a time
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"{ms:9.3f} ms {n / args.steps:7.1f}x  [{group_of(name)}] {name[:100]}")

    print(f"trace of the profiled window: {trace}")
    summary = {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu", "model": args.model,
        "batch_size": hp.batch_size, "sequence_length": hp.sequence_length, "context_frames": hp.context_frames,
        "image_size": int(data["images"].shape[2]), "tf32": bool(args.tf32 and cuda), "steps": args.steps,
        "step_ms": step_ms, "window_ms": window_ms, "busy_ms": busy_ms,
        "busy_share": busy_ms / window_ms,
        "device_ms": by_group, "launches": len(device_events) / args.steps,
        "phase_ms": (phase_ms() or [None])[-1],
        "windows": windows, "shortfall": shortfall or None,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "finite": all(bool(torch.isfinite(v)) for v in scalars.values()), "trace": trace,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
