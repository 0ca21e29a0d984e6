"""What every kind of cell shares: the benchmark's files by name, seeds,
frames and weights made from the seed, the window's clock and spans, the
profiled window and its reduction, and the device's description.

The program is imported by the kinds (``benchmark/kinds/``) and, here,
only inside ``profiled_window`` (the kernel wrappers' launch counters).
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3, the data sheet's rate
BENCH_DIR = Path(__file__).resolve().parent
# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "video_prediction_tpu")
# the port's kernels by device name, and cuDNN / cuBLAS with their layout
# transforms (the groups of the port's train/profile_step.py)
GROUPS = (
    ("K1", re.compile(r"\bcdna_(forward|backward)_kernel|\bcdna_kernel_grad_reduce")),
    ("K2", re.compile(r"\bln_gate_(forward|backward)_kernel|\bln_(gate_)?grad_reduce")),
    ("K3", re.compile(r"\bcomposite_(forward|backward)_kernel")),
    ("conv_gemm", re.compile(r"conv|cudnn|xmma|gemm|cutlass|wgrad|dgrad|fprop|winograd|nchw|nhwc|fft|"
                             r"pointwise_mult_and_sum_complex", re.I)),
)
# device events of one launch of each kernel wrapper of the port
EVENTS_PER_LAUNCH = {
    "apply_cdna_kernels": ("K1", 1), "apply_cdna_kernels_backward": ("K1", 2),
    "fused_ln_gate": ("K2", 1), "fused_ln_gate_backward": ("K2", 2),
    "composite": ("K3", 1), "composite_backward": ("K3", 1),
}


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if pattern.search(name):
            return group
    return "other"


# ------------------------------------------------------------------ files --
def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(spec: Dict, workload: str) -> Tuple[Dict, Dict, Dict]:
    """``(cell, configuration, traffic)`` of ``workload``: the configuration's
    file by its entry in ``configs``, the traffic mix by its name under
    ``benchmark/traffic/``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, load_json(ROOT / config_entry["file"]), load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")


def cell_metrics(spec: Dict, workload: str) -> Tuple[List[Dict], List[Dict]]:
    """The end-to-end and the per-layer metrics that ``workload`` reports."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if m["moves"] in names and workload in m.get("workloads", [workload])]
    return e2e, layer


def load_reader(name: str) -> Callable:
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ------------------------------------------------------------------ seeds --
# the streams of a run's seed: 0 weights, 1 clips, 2 noise, 3 the train
# state's generator, 5 VGG16's weights, 6-8 the kinds' choices; actions and
# states take one that no other draw uses
CONDITIONING_STREAM = 9


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, *stream]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def make_clips(n: int, t: int, h: int, w: int, c: int, gen: torch.Generator, device) -> np.ndarray:
    """``n`` distinct uint8 clips ``[n,t,h,w,c]``: each a periodic texture of
    three plane waves a channel (random integer frequencies, phases and
    amplitudes) drifting at its own velocity, made on ``device`` in a few
    large calls and copied to the host."""
    j = 3

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    fy = torch.randint(-3, 4, (n, j), generator=gen, device=device).float()
    fx = torch.randint(-3, 4, (n, j), generator=gen, device=device).float()
    phase, amp = 2 * torch.pi * u(n, j), 0.12 + 0.1 * u(n, j, c)
    vy, vx = 3 * (2 * u(n) - 1), 3 * (2 * u(n) - 1)
    ys = torch.arange(h, device=device).float()[None, None, :, None]
    xs = torch.arange(w, device=device).float()[None, None, None, :]
    ts = torch.arange(t, device=device).float()[None, :, None, None]
    out = torch.empty((n, t, h, w, c), dtype=torch.uint8)
    for lo in range(0, n, 256):
        sl = slice(lo, min(n, lo + 256))
        img = 0.5 + torch.zeros((sl.stop - lo, t, h, w, c), device=device)
        for k in range(j):
            arg = (fy[sl, k, None, None, None] * (ys + vy[sl, None, None, None] * ts) / h
                   + fx[sl, k, None, None, None] * (xs + vx[sl, None, None, None] * ts) / w)
            wave = torch.sin(2 * torch.pi * arg + phase[sl, k, None, None, None])
            img += wave[..., None] * amp[sl, None, None, None, k, :]
        out[sl] = (img.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu()
    return out.numpy()


def make_conditioning(n: int, t: int, action_dim: int, state_dim: int, gen: torch.Generator,
                      device) -> Dict[str, np.ndarray]:
    """float32 ``actions [n,t,action_dim]``, uniform in [-1, 1] (the
    commands), and ``states [n,t,state_dim]``, a random walk from a uniform
    start in [-1, 1] with Gaussian steps of std 0.05 (a drifting end-effector
    position), each made on ``device`` in one call; nothing of a dim of 0 is
    drawn."""
    out = {}
    if action_dim:
        out["actions"] = (2 * torch.rand((n, t, action_dim), generator=gen, device=device) - 1).cpu().numpy()
    if state_dim:
        start = 2 * torch.rand((n, 1, state_dim), generator=gen, device=device) - 1
        steps = 0.05 * torch.randn((n, t - 1, state_dim), generator=gen, device=device)
        out["states"] = torch.cat([start, start + steps.cumsum(1)], dim=1).cpu().numpy()
    return out


def make_inputs(n: int, t: int, shape, cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """``n`` distinct clips of ``t`` frames as the program's loaders yield
    them: uint8 ``images`` (``make_clips``, stream 1) and, where the
    configuration states an ``action_dim`` or a ``state_dim`` above 0,
    ``actions`` and ``states`` (``make_conditioning``, ``CONDITIONING_STREAM``).
    """
    out = {"images": make_clips(n, t, *shape, generator(seed, 1, device), device)}
    dims = cfg.get("action_dim", 0), cfg.get("state_dim", 0)
    if any(dims):
        out.update(make_conditioning(n, t, *dims, generator(seed, CONDITIONING_STREAM, device), device))
    return out


def rows_of(inputs: Dict[str, np.ndarray], rows) -> Dict[str, np.ndarray]:
    """The clips ``rows`` (an index or a slice) of every key of ``inputs``."""
    return {k: v[rows] for k, v in inputs.items()}


def weight_rule(name: str, shape) -> Tuple[str, float]:
    """How the benchmark draws a weight of the program's model by its name:
    ``normal`` with std 1/sqrt(fan in) for a weight, ``zeros`` for a bias,
    ``ones`` for a norm scale, the ConvLSTM's LayerNorm rows (scale 1, bias
    0), a unit ``u`` for a spectral vector."""
    last = name.rsplit(".", 1)[-1]
    if last == "weight":
        return "normal", 1.0 / float(np.sqrt(np.prod(shape[1:])))
    if last == "bias":
        return "zeros", 0.0
    if last == "scale":
        return "ones", 0.0
    if last == "ln":
        return "ln", 0.0
    if last == "u":
        return "unit", 0.0
    raise ValueError(f"no rule for {name} {tuple(shape)}")


@torch.no_grad()
def make_weights(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device,
                 rule: Callable = weight_rule) -> Dict[str, torch.Tensor]:
    """fp32 weights by name on ``device`` from ``gen``: one Gaussian draw for
    all of them, cut and scaled by ``rule``."""
    rules = {k: rule(k, s) for k, s in shapes.items()}
    total = sum(int(np.prod(s)) for k, s in shapes.items() if rules[k][0] in ("normal", "unit"))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for k, s in shapes.items():
        kind, std = rules[k]
        n = int(np.prod(s))
        if kind in ("normal", "unit"):
            v = flat[offset : offset + n].view(s)
            offset += n
            out[k] = v * std if kind == "normal" else v * torch.rsqrt(v.square().sum() + 1e-12)
        elif kind == "ln":
            out[k] = torch.zeros(s, device=device)
            out[k][0::2] = 1.0
        else:
            out[k] = (torch.zeros if kind == "zeros" else torch.ones)(s, device=device)
    return out


def he_rule(name: str, shape) -> Tuple[str, float]:
    """VGG16's convs: He-normal weights (std sqrt(2 / fan in)), zero biases."""
    if name.endswith(".weight"):
        return "normal", float(np.sqrt(2.0 / np.prod(shape[1:])))
    return "zeros", 0.0


# ------------------------------------------------------------------ clock --
class Spans:
    """Host-clock spans by name (seconds), and the window's phases
    ``(label, start, end)`` on ``time.perf_counter``."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = collections.defaultdict(list)
        self.phases: List[Tuple[str, float, float]] = []
        self.record_phases = False

    def __call__(self, name: str, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        self.durations[name].append(t1 - t0)
        if self.record_phases:
            self.phases.append((name, t0, t1))
        return out


def closed_loop(unit: Callable[[], None], seconds: Optional[float] = None, count: Optional[int] = None) -> Dict:
    """``unit()`` again and again, each waiting for the last, until
    ``seconds`` have passed (or ``count`` units): the window's units and
    seconds."""
    n, t0 = 0, time.perf_counter()
    while True:
        unit()
        n += 1
        if (count is not None and n >= count) or (count is None and time.perf_counter() - t0 >= seconds):
            break
    return {"units": n, "seconds": time.perf_counter() - t0}


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def quantile(values: List[float], q: float) -> float:
    s = sorted(values)
    k = (len(s) - 1) * q
    lo = int(np.floor(k))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


# -------------------------------------------------------------- profiling --
def union_s(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of ``intervals`` (us) in seconds, and the
    merged intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, [(a, b) for a, b in merged]


def profiled_window(run_units: Callable[[], None], sync: Callable[[], None], device) -> Dict:
    """Run ``run_units()`` under ``torch.profiler`` (device activity only)
    from an idle device: its device events ``(name, start us, end us)``, the
    host's wall time, the port's kernel launches, and the offset between
    the profiler's clock and ``time.perf_counter`` (from a marker launched
    on the idle device first)."""
    from video_prediction_torch import kernels as K

    marker = torch.zeros(1, device=device)
    sync()
    K.reset_launch_counts()
    cuda = torch.device(device).type == "cuda"  # on the CPU (a rehearsal) no event is a device event
    activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[activity]) as prof:
        sync()
        t0 = time.perf_counter()
        marker.add_(1.0)
        run_units()
        sync()
        t1 = time.perf_counter()
    launches = K.launch_counts()
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: e[1])
    offset_us = events[0][1] - t0 * 1e6 if events else 0.0
    return {"events": events, "wall_s": t1 - t0, "t0": t0, "launches": launches, "offset_us": offset_us}


def shortfall(events, launches: Dict[str, int]) -> Dict[str, List[int]]:
    """Kernel groups whose device events disagree with the wrappers' counted
    launches: group -> [events, expected]."""
    want: Dict[str, int] = {}
    for wrapper, n in launches.items():
        group, per = EVENTS_PER_LAUNCH[wrapper]
        want[group] = want.get(group, 0) + n * per
    got = {g: 0 for g in want}
    for name, _, _ in events:
        g = group_of(name)
        if g in got:
            got[g] += 1
    return {g: [got[g], want[g]] for g in want if got[g] != want[g]}


def breakdown(trace: Dict, phases: List[Tuple[str, float, float]], top: int = 10) -> Dict:
    """The device operations that took most time, and the device's idle time
    by what the host was doing (the harness's phase in progress when each gap
    began), each as ``[[name, seconds], ...]``, longest first."""
    by_op: Dict[str, float] = collections.defaultdict(float)
    for name, a, b in trace["events"]:
        by_op[name] += (b - a) / 1e6
    _, merged = union_s([(a, b) for _, a, b in trace["events"]])
    idle: Dict[str, float] = collections.defaultdict(float)
    off = trace["offset_us"]
    for (_, end), (start, _) in zip(merged, merged[1:]):
        host_t = (end - off) / 1e6
        label = "other"
        for name, p0, p1 in phases:
            if p0 <= host_t < p1:
                label = name
        idle[label] += (start - end) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def exact_fp32():
    """True fp32 convolutions and products inside the block (TF32 off), the
    process's flags restored after: where the reference runs."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ----------------------------------------------------------------- device --
def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------- readers --
# what the per-layer metrics' readers (benchmark/metrics/<name>.py) share;
# ``data``: the cell, the window (its spans by name, in seconds) and the
# profiled window (``trace``)
def span_mean_ms(data: Dict, name: str) -> Optional[float]:
    d = data["window"]["spans"].get(name)
    return 1e3 * sum(d) / len(d) if d else None


def mfu_pct(data: Dict) -> float:
    """Counted model FLOPs of the window's units over its time, as a share of
    the configuration's peak."""
    w, c = data["window"], data["cell"]
    return 100.0 * c.flops_per_unit() * w["units"] / w["seconds"] / data["peak_flops"]


def group_events(trace: Dict) -> Dict[str, List[float]]:
    """Device seconds of each event, by group."""
    out: Dict[str, List[float]] = collections.defaultdict(list)
    for name, a, b in trace["events"]:
        out[group_of(name)].append((b - a) / 1e6)
    return out


def hand_kernels_roofline_pct(data: Dict) -> Optional[float]:
    """The K1-K3 launches' least time (their bytes over the HBM rate) over
    their device time in the profiled window; nothing where the window's
    events are not exactly the launches the units make."""
    trace, c = data["trace"], data["cell"]
    if trace["shortfall"]:
        return None
    work, units = c.kernel_work(), trace["units"]
    events = group_events(trace)
    if any(len(events.get(g, [])) != n * units for g, n in work["events"].items()):
        return None
    device_s = sum(sum(events[g]) for g in work["events"])
    return 100.0 * sum(work["bytes"].values()) * units / HBM_BYTES_PER_S / device_s


def device_idle_pct(data: Dict) -> float:
    trace = data["trace"]
    busy, _ = union_s([(a, b) for _, a, b in trace["events"]])
    return 100.0 * (1.0 - busy / trace["wall_s"])
