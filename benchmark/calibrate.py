"""The readings that the limits of ``correct`` are set from, on the card, in
one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control 3] [--faults 3] [--seconds 2]

For each seed: a run of the cell (set-up, a short window at the cell's own
load, the check) gives the program's numbers; on the first ``--control``
seeds the control, the program with its bfloat16 compute switched on
(``CONTROL``), is checked the same way; on the first
``--faults`` seeds each fault of ``benchmark/faults.py`` that the cell can
have (on the card its replay faults too) is planted under the program and
its run checked. One JSON line a
reading, on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import common, faults, run

# the control: the program's own lower-precision path switched on. The
# configurations state fp32 (with cuDNN's TF32); the port's bf16 compute
# (convs, norms' outputs, recurrent states in bfloat16, the gate maths in
# fp32) is the step below it
CONTROL = {"compute_dtype": "bfloat16"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the rehearsal's sizes (benchmark/rehearse.py), for the CPU")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cpu" and not args.tiny:
        raise SystemExit("the cells' own sizes run on the card; on the CPU pass --tiny")
    spec = common.benchmark_spec()
    _, _, traffic = common.resolve(spec, args.workload)
    kind = traffic["kind"]
    sizes = {}
    if args.tiny:
        from benchmark import rehearse

        sizes = {"overrides": dict(rehearse.TINY, **rehearse.TINY_SEQUENCE[kind]),
                 "traffic_overrides": rehearse.TINY_TRAFFIC[kind]}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run.run_cell(spec, args.workload, seed, args.seconds, False, args.device, **sizes)
        c = out["cell"]
        numbers = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"seed": seed, "mode": "program", "numbers": numbers, "units": out["info"]["units"]}),
              flush=True)
        if hasattr(c, "detail"):
            print(json.dumps({"seed": seed, "detail": c.detail(c.outputs, out["want"])}), flush=True)
        del out, c
        if i < args.control:
            control = dict(sizes, overrides=dict(sizes.get("overrides", {}), **CONTROL))
            out = run.run_cell(spec, args.workload, seed, args.seconds, False, args.device, **control)
            numbers = {k: v["value"] for k, v in out["checks"].items()}
            print(json.dumps({"seed": seed, "mode": "control_bf16", "numbers": numbers}), flush=True)
            if hasattr(out["cell"], "detail"):
                print(json.dumps({"seed": seed, "detail_control": out["cell"].detail(out["cell"].outputs, out["want"])}),
                      flush=True)
            del out
        if i < args.faults:
            cuda = torch.device(args.device).type == "cuda"
            for name in faults.FAULTS[kind] + (faults.CUDA_FAULTS[kind] if cuda else ()):
                with faults.fault(name, kind):
                    out = run.run_cell(spec, args.workload, seed, args.seconds, False, args.device, **sizes)
                numbers = {k: v["value"] for k, v in out["checks"].items()}
                print(json.dumps({"seed": seed, "mode": "fault_" + name, "numbers": numbers}), flush=True)
                del out
    loaded = common.forbidden_modules(sys.modules)
    print(json.dumps({"forbidden": loaded}))
    return 1 if loaded else 0


if __name__ == "__main__":
    sys.exit(main())
