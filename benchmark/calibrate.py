"""The readings that the limits of ``correct`` are set from, on the card, in
one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control 3] [--faults 3] [--seconds 2]

For each seed: a run of the cell (set-up, a short window at the cell's own
load, the check) gives the program's numbers; on the first ``--control``
seeds the control, the program one precision below its configuration's
(``control``), is checked the same way; on the first
``--faults`` seeds each fault of ``benchmark/faults.py`` that the cell can
have (on the card its replay faults too) is planted under the program and
its run checked. One JSON line a
reading, on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, NamedTuple

import torch

from benchmark import common, faults, program, run

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class Control(NamedTuple):
    """The program one precision below its configuration's: hparams that
    switch on its own lower-precision path, and a context that plants one
    under it."""

    overrides: Dict
    plant: contextlib.AbstractContextManager


def control(cfg: Dict) -> Control:
    """The control of configuration ``cfg``. An fp32 configuration (with
    cuDNN's TF32): the port's own bf16 compute (convs, norms' outputs,
    recurrent states in bfloat16, the gate maths in fp32). A bf16
    configuration: as configured, with every conv of the generator (the
    ConvLSTMs' gate convs among them) rounding its output to float8 e4m3
    (``fp8_convs``)."""
    if cfg["precision"]["dtype"] == "float32":
        return Control({"compute_dtype": "bfloat16"}, contextlib.nullcontext())
    if cfg["precision"]["dtype"] == "bfloat16":
        return Control({}, fp8_convs())
    raise ValueError(f"no control for a configuration in {cfg['precision']['dtype']}")


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 (3 mantissa bits against bf16's 7; beyond
    its range clipped to it) in the forward pass; the gradient passes
    through unchanged, as fp8 training keeps its gradients wider."""
    rounded = t.clamp(-FP8_MAX, FP8_MAX).to(FP8).to(t.dtype)
    return t + (rounded - t).detach()


@contextlib.contextmanager
def fp8_convs():
    """Every model built (``program.build_model``) while this is on gets a
    forward hook on each conv of its generator that rounds the conv's output
    to float8 e4m3 (``fp8_round``). The port is not changed."""
    from video_prediction_torch.ops.layers import Conv2D

    def make(original):
        def build(*args, **kwargs):
            model, weights = original(*args, **kwargs)
            for module in model.generator.modules():
                if isinstance(module, Conv2D):
                    module.register_forward_hook(lambda mod, inputs, out: fp8_round(out))
            return model, weights

        return build

    with faults.patched(program, "build_model", make):
        yield


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
    _, cfg, traffic = common.resolve(spec, args.workload)
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
        info = out["info"]
        print(json.dumps({"seed": seed, "mode": "program", "numbers": numbers, "units": info["units"],
                          "peak_bytes": info["peak_bytes"], "reference_s": info["reference_s"],
                          "reference_peak_bytes": info["reference_peak_bytes"]}), flush=True)
        if hasattr(c, "detail"):
            print(json.dumps({"seed": seed, "detail": c.detail(c.outputs, out["want"])}), flush=True)
        del out, c
        if i < args.control:
            ctl = control(cfg)
            with ctl.plant:
                out = run.run_cell(spec, args.workload, seed, args.seconds, False, args.device,
                                   **dict(sizes, overrides=dict(sizes.get("overrides", {}), **ctl.overrides)))
            numbers = {k: v["value"] for k, v in out["checks"].items()}
            print(json.dumps({"seed": seed, "mode": "control", "numbers": numbers}), flush=True)
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
