"""A rehearsal of every kind of cell at a tiny size on the CPU, through the
harness's own functions (``run.run_cell``) with the port's plain paths:

    python3 -m benchmark.rehearse [--trace]

It prints one JSON line: each cell's checks and whether it came out
correct, and the loaded modules whose top-level name no run may load.
The sizes are the configurations' own shapes cut down (``TINY``), computed
in fp32 (``PLAIN``: the CPU rehearses the harness, not a precision; a bf16
configuration's gaps at these widths say nothing of the card's); the
limits are the cells' (fp32 against fp32 reads far below them).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import common, run

TINY = {"ngf": 4, "nef": 8, "ndf": 4, "nz": 4, "clip_length": 3, "image_shape": (32, 32, 3)}
PLAIN = {"compute_dtype": "float32", "gate_dtype": "float32"}
TINY_SEQUENCE = {"train": {"context_frames": 2, "sequence_length": 5},
                 "generate": {"context_frames": 2, "sequence_length": 5},
                 "evaluate": {"context_frames": 2, "sequence_length": 5, "long_sequence_length": 7}}
TINY_TRAFFIC = {"train": {"batch_size": 2, "steps_per_call": 2, "pool_calls": 2, "trace_units": 1},
                "generate": {"clips_per_request": 2, "samples_per_clip": 2, "pool_clips": 8, "warmup_requests": 1,
                             "check_requests": 2, "trace_units": 2},
                "evaluate": {"batch_size": 2, "num_samples": 3, "samples_per_rollout": 2, "pool_batches": 2,
                             "trace_units": 1}}


def rehearse(workload: str, seed: int = 12345, seconds: float = 0.5, trace: bool = False):
    spec = common.benchmark_spec()
    _, _, traffic = common.resolve(spec, workload)
    kind = traffic["kind"]
    return run.run_cell(spec, workload, seed, seconds, trace, "cpu",
                        overrides=dict(TINY, **TINY_SEQUENCE[kind], **PLAIN), traffic_overrides=TINY_TRAFFIC[kind])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--workload", action="append", help="default: every cell")
    args = p.parse_args(argv)
    torch.set_num_threads(2)
    workloads = args.workload or [w["name"] for w in common.benchmark_spec()["workloads"]]
    out = {}
    for w in workloads:
        run_out = rehearse(w, trace=args.trace)
        r = run_out["result"]
        out[w] = {"correct": r["correct"], "attempted": r["attempted"], "checks": run_out["checks"],
                  "metrics": sorted(r["metrics"])}
    print(json.dumps({"cells": out, "forbidden": common.forbidden_modules(sys.modules)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
