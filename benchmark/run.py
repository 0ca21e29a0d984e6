"""The benchmark of the port, ``video_prediction_torch``, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the cell, its configuration and its
traffic mix by name (``BENCHMARK.json``, ``benchmark/configs/``,
``benchmark/traffic/``), builds the cell's kind (``benchmark/kinds/<kind>.py``),
sets it up from the seed, runs whole units of work for ``--seconds``,
checks the outputs against the plain reference of the configuration's model
(``benchmark/models/<model>.py``; a model without one exits before set-up)
within the cell's limits (``benchmark/limits/<cell>.json``), and prints one
JSON line. With ``--trace 0`` it reports the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics (``benchmark/metrics/<metric>.py``), read
from the window's spans and a profiled window of ``trace_units`` units
after it. Without a CUDA device, or with fewer than the cell asks for, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time
from typing import Dict, Optional

# caches of anything the run compiles stay inside the checkout, at fixed paths
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_ROOT, "build", "triton_cache"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from benchmark import common, models  # noqa: E402

PROFILE_WINDOWS = 5  # a profiled window that lost device records is profiled again, up to this many


class Context:
    """What a cell's kind is given: its files, its model's own parts (the
    plain reference and the work counts, ``benchmark/models/<model>.py``),
    the seed, the device, and the device's clock."""

    def __init__(self, cell: Dict, cfg: Dict, traffic: Dict, seed: int, device, overrides: Optional[Dict] = None):
        self.cell, self.cfg, self.traffic, self.seed = cell, cfg, traffic, seed
        self.parts = models.find(cfg)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.overrides = dict(overrides or {})

    def event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, event) -> None:
        if event is not None:
            event.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def empty_cache(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def limits_of(cell_name: str) -> Dict[str, float]:
    path = common.BENCH_DIR / "limits" / f"{cell_name}.json"
    return common.load_json(path)["limits"] if path.exists() else {}


def read_layers(spec: Dict, cell, c, ctx: Context, window: Dict, trace: Dict) -> Dict:
    """Each per-layer metric of the cell that its reader finds something to
    read in."""
    _, layer = common.cell_metrics(spec, cell["name"])
    data = {"cell": c, "ctx": ctx, "window": window, "trace": trace, "peak_flops": ctx.cfg["peak_flops"]}
    out = {}
    for m in layer:
        value = common.load_reader(m["name"])(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def profile(c, ctx: Context) -> Dict:
    """A profiled window of ``trace_units`` units; profiled again where its
    device events fall short of the kernel wrappers' launches."""
    c.spans.record_phases = True
    for n in range(1, PROFILE_WINDOWS + 1):
        trace = common.profiled_window(lambda: c.run(count=ctx.traffic["trace_units"]), ctx.sync, ctx.device)
        trace["units"] = ctx.traffic["trace_units"]
        trace["shortfall"] = common.shortfall(trace["events"], trace["launches"])
        trace["windows"] = n
        if not trace["shortfall"]:
            break
        print(f"profiled window {n}: device events short of the launches: {trace['shortfall']}", file=sys.stderr)
    c.spans.record_phases = False
    return trace


def run_cell(spec: Dict, workload: str, seed: int, seconds: float, trace_on: bool, device,
             overrides: Optional[Dict] = None, traffic_overrides: Optional[Dict] = None, setup_clock=None) -> Dict:
    """Set up, run the window, (trace,) check: the result line's fields, and
    ``checks``, each number compared with its limit. ``overrides`` and
    ``traffic_overrides``: smaller sizes, for the rehearsal on the CPU."""
    cell, cfg, traffic = common.resolve(spec, workload)
    traffic = dict(traffic, **(traffic_overrides or {}))
    ctx = Context(cell, cfg, traffic, seed, device, overrides)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    c = kind.Cell(ctx)
    c.setup()
    ctx.sync()
    setup_s = setup_clock() if setup_clock else None
    c.spans.durations.clear()
    window = c.run(seconds=seconds)
    window["spans"] = {k: list(v) for k, v in c.spans.durations.items()}
    unit_ms = list(c.unit_ms[-window["units"]:])
    e2e, _ = common.cell_metrics(spec, workload)
    values = dict(c.end_to_end(window), setup_s=setup_s)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    result: Dict = {"correct": False, "attempted": window["units"], "failed": 0}
    trace = None
    if trace_on:
        trace = profile(c, ctx)
        metrics = read_layers(spec, cell, c, ctx, window, trace)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    info = {"units": window["units"], "window_s": window["seconds"], "unit_ms": unit_ms, "peak_bytes": peak,
            "setup_s": setup_s}
    c.free()
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    t0 = time.perf_counter()
    want = c.reference()
    info["reference_s"] = time.perf_counter() - t0
    info["reference_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    numbers = c.compare(c.outputs, want)
    limits = limits_of(workload)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    compared = [k for k in numbers if limits.get(k) is not None]
    result["correct"] = bool(compared) and all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                                               for k in compared)
    result["metrics"] = metrics
    result["device"] = {"count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        busy, _ = common.union_s([(a, b) for _, a, b in trace["events"]])
        result["device"].update(busy_s=busy, window_s=trace["wall_s"])
        result["breakdown"] = common.breakdown(trace, c.spans.phases)
    result["checks"] = checks  # last on the line: each number compared beside its limit
    return {"result": result, "checks": checks, "info": info, "cell": c, "want": want}


def describe(info: Dict, checks: Dict) -> None:
    """The earlier lines on standard error; the numbers compared last."""
    ms = info["unit_ms"]
    if ms:
        print(f"units: {info['units']} in {info['window_s']:.3f} s; unit ms median {common.quantile(ms, 0.5):.3f}, "
              f"p95 {common.quantile(ms, 0.95):.3f} (n={len(ms)})", file=sys.stderr)
    print(f"setup_s: {info['setup_s']!r}", file=sys.stderr)
    print(f"card: {common.power_limit()}", file=sys.stderr)
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
    print(f"peak allocated: {info['peak_bytes'] / 2**30:.3f} GiB", file=sys.stderr)
    print(f"reference: {info['reference_s']:.3f} s, peak allocated after the program was freed "
          f"{info['reference_peak_bytes'] / 2**30:.3f} GiB", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = common.benchmark_spec()
    cell, cfg, _ = common.resolve(spec, args.workload)
    models.find(cfg)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    wanted = {k: cfg["precision"][k] for k in flags}
    if flags != wanted:
        print(f"the process's TF32 flags {flags} are not the configuration's {wanted}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                   setup_clock=common.process_age_s)
    result = out["result"]
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), **result["device"]}
    describe(out["info"], result["checks"])
    loaded = common.forbidden_modules(sys.modules)
    if loaded:
        print(f"modules that no run may load were loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
