"""The control of ``correct`` on the card, at each cell's own size: the
program one precision below its configuration's (``calibrate.control``: its
bfloat16 compute under an fp32 configuration, its generator's convs rounded
to float8 under a bf16 one) must fail the cell's limits, where the program
as configured passes them; and each fault that breaks only a
replayed CUDA graph (``faults.CUDA_FAULTS``) must fail them. Needs a CUDA
device; on the card:

    python -m pytest --noconftest benchmark/tests/test_bench_control.py -q
"""

import pytest
import torch

from benchmark import calibrate, common, faults, run

pytestmark = pytest.mark.gpu
SPEC = common.benchmark_spec()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_where_the_program_passes(cuda, cell):
    out = run.run_cell(SPEC, cell, 4242424242, 1.0, False, cuda)
    assert out["result"]["correct"], out["checks"]
    ctl = calibrate.control(common.resolve(SPEC, cell)[1])
    with ctl.plant:
        control = run.run_cell(SPEC, cell, 4242424242, 1.0, False, cuda, overrides=ctl.overrides)
    assert not control["result"]["correct"], control["checks"]


CUDA_CASES = [(w["name"], f) for w in SPEC["workloads"]
              for f in faults.CUDA_FAULTS[common.resolve(SPEC, w["name"])[2]["kind"]]]


@pytest.mark.parametrize("cell,fault", CUDA_CASES)
def test_replay_fault_is_caught(cuda, cell, fault):
    kind = common.resolve(SPEC, cell)[2]["kind"]
    with faults.fault(fault, kind):
        out = run.run_cell(SPEC, cell, 4242424243, 1.0, False, cuda)
    assert not out["result"]["correct"], out["checks"]
