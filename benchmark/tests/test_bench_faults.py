"""The check against planted faults: the harness driven at a tiny size on
the CPU (its look for a card skipped), with the timed path broken underneath
(``benchmark/faults.py``), must come out not correct; the same run unbroken
must come out correct. Within the cell's own limits."""

import pytest

from benchmark import common, faults, rehearse

SPEC = common.benchmark_spec()
CASES = [(w["name"], f) for w in SPEC["workloads"]
         for f in faults.FAULTS[common.resolve(SPEC, w["name"])[2]["kind"]]]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_sound_run_is_correct(cell):
    out = rehearse.rehearse(cell)
    assert out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    kind = common.resolve(SPEC, cell)[2]["kind"]
    with faults.fault(fault, kind):
        out = rehearse.rehearse(cell)
    assert not out["result"]["correct"], out["checks"]
