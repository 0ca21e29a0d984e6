"""The kernel tooling's pure-Python parts on the CPU: where the build
(``video_prediction_torch/kernels/_lib.py``) puts the library and ptxas's
report, and how the report is read into registers and spills per kernel
instantiation; the device-time script (``kernels/bench.py``) refuses to run
without a card, runs a profiler session again that lost device records, and
makes K2's inputs as ``chip_smoke.py`` uses them and K3's as it times them."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from video_prediction_torch.kernels import _lib, bench

torch.set_num_threads(1)

PTXAS_LOG = """# cdna.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119cdna_forward_kernelIfLi3ELi5ELi4EEEvPKT_PKfPS1_iiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119cdna_forward_kernelIfLi3ELi5ELi4EEEvPKT_PKfPS1_iiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 111 registers, used 1 barriers, 8 bytes smem, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120cdna_backward_kernelIfLi0ELi0ELi0EEEvPKT_PKfS3_PS1_Pfiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120cdna_backward_kernelIfLi0ELi0ELi0EEEvPKT_PKfS3_PS1_Pfiiiiiiiii
    40 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 48 registers, 8 bytes smem, 432 bytes cmem[0]
# ln_gate.cu
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc522ln_gate_forward_kernelIfLi256ELi8EEEvNS_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc522ln_gate_forward_kernelIfLi256ELi8EEEvNS_4ArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 74 registers, used 1 barriers
ptxas info    : Compile time = 279.550 ms
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc523ln_gate_backward_kernelIfLi32ELi4EEEvNS_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc523ln_gate_backward_kernelIfLi32ELi4EEEvNS_4ArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc523ln_gate_backward_kernelI13__nv_bfloat16Li0ELi16EEEvNS_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc523ln_gate_backward_kernelI13__nv_bfloat16Li0ELi16EEEvNS_4ArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 205 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc519ln_gate_grad_reduceEPKfPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__59cf225a_10_ln_gate_cu_d377fbc519ln_gate_grad_reduceEPKfPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 1 barriers, 2048 bytes smem

# composite.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4e1a7c02_12_composite_cu_d377fbc524composite_forward_kernelIfLi7ELi3EEEvNS_3FwdIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__4e1a7c02_12_composite_cu_d377fbc524composite_forward_kernelIfLi7ELi3EEEvNS_3FwdIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4e1a7c02_12_composite_cu_d377fbc524composite_forward_kernelI13__nv_bfloat16Li0ELi0EEEvNS_3FwdIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__4e1a7c02_12_composite_cu_d377fbc524composite_forward_kernelI13__nv_bfloat16Li0ELi0EEEvNS_3FwdIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4e1a7c02_12_composite_cu_d377fbc525composite_backward_kernelIfEEvPKT_S3_S3_PS1_S4_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__4e1a7c02_12_composite_cu_d377fbc525composite_backward_kernelIfEEvPKT_S3_S3_PS1_S4_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    log = tmp_path / "lib.ptxas.txt"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_lib, "ptxas_log_path", lambda: log)
    rows = _lib.ptxas_report()
    assert [r[1:] for r in rows] == [(111, 0, 0), (48, 36, 32), (74, 0, 0), (94, 0, 0), (205, 0, 0), (24, 0, 0),
                                     (32, 0, 0), (32, 0, 0), (72, 0, 0)]
    assert "cdna_forward_kernel" in rows[0][0] and "cdna_backward_kernel" in rows[1][0]
    # mangled, or demangled where the toolkit has cu++filt
    assert "ln_gate_forward_kernel" in rows[2][0] and all("ln_gate_backward_kernel" in r[0] for r in rows[3:5])
    assert "ln_gate_grad_reduce" in rows[5][0]
    # K3 forward's compile-time (K=7, C=3) and run-time instantiations, and its backward
    assert all("composite_forward_kernel" in r[0] for r in rows[6:8]) and "composite_backward_kernel" in rows[8][0]


@pytest.mark.parametrize("flag", ["-lineinfo", "-DVP_TEST"])
def test_library_name_follows_flags(monkeypatch, flag):
    """The library's name hashes the sources and the flags, so a change of
    either builds anew; ptxas's report sits beside it."""
    before = _lib.library_path()
    monkeypatch.setattr(_lib, "NVCC_FLAGS", _lib.NVCC_FLAGS + [flag])
    after = _lib.library_path()
    assert before != after and after.parent == before.parent == _lib.BUILD_DIR
    assert _lib.ptxas_log_path() == after.with_suffix(".ptxas.txt")
    assert "-Xptxas" in _lib.NVCC_FLAGS and "-v" in _lib.NVCC_FLAGS


def test_bench_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert bench.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("counts, expect_ms, expect_sessions", [
    ([40], 0.002, 1),  # a whole session: 2 events a call of 1 us each
    ([0, 40], 0.002, 2),  # the first session lost every record
    ([0, 33, 40], 0.002, 3),  # the second lost some
    ([0, 0, 33, 0, 7], 0.5, 5),  # none whole: CUDA events behind a queued sleep
])
def test_device_ms_runs_a_session_again_that_lost_records(monkeypatch, counts, expect_ms, expect_sessions):
    sessions, calls = [], []
    def events(fn, group, iters):
        sessions.append((group, iters))
        return [(10.0 * i, 10.0 * i + 1.0) for i in range(counts[len(sessions) - 1])]
    monkeypatch.setattr(bench, "profiled_events", events)
    monkeypatch.setattr(bench, "queued_ms", lambda fn, iters: 0.5)
    monkeypatch.setattr(bench, "REPEATS", [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms = bench.device_ms(lambda: calls.append(1), "K3", iters=20, warmup=3)
    assert ms == pytest.approx(expect_ms) and sessions == [("K3", 20)] * expect_sessions and len(calls) == 3
    repeat = {"group": "K3", "event_counts": counts, **({"queued_ms": 0.5} if expect_ms == 0.5 else {})}
    assert bench.REPEATS == ([] if expect_sessions == 1 else [repeat])


def test_ln_inputs():
    z, c, lnp, dcn, dhn = bench.ln_inputs(torch.Generator().manual_seed(0), 7, 12, "cpu")
    assert z.shape == (7, 48) and lnp.shape == (10, 12) and lnp.is_contiguous()
    assert c.shape == dcn.shape == dhn.shape == (7, 12)
    assert float((lnp[0::2] - 1.0).abs().max()) < 1.0 and float(lnp[1::2].abs().max()) < 1.0  # scales near 1, biases near 0


def test_composite_inputs():
    cand, logits = bench.composite_inputs(torch.Generator().manual_seed(0), 3, "cpu")
    assert cand.shape == (3, 7, 64, 64, 3) and logits.shape == (3, 64, 64, 7)
    assert cand.is_contiguous() and logits.is_contiguous() and 0.0 <= float(cand.min()) <= float(cand.max()) < 1.0


def test_ln_gate_step_ms_counts_each_width_as_often_as_a_step_calls_it():
    """A generator step calls C=64 and C=128 twice, C=32 and C=256 once."""
    assert bench.ln_gate_step_ms({32: 1.0, 64: 10.0, 128: 100.0, 256: 1000.0}) == pytest.approx(1221.0)


@pytest.mark.parametrize("counts, want", [
    ([40], {"row": 0.003, "reduce": 0.001}),  # 20 calls, each a 3 us row kernel and a 1 us reduce
    ([0, 39, 40], {"row": 0.003, "reduce": 0.001}),  # sessions that lost records are run again
    ([0] * 5, None),  # none whole
])
def test_device_ms_by_kernel_splits_a_whole_session_by_name(monkeypatch, counts, want):
    sessions = []

    def events(fn, group, iters):
        sessions.append(group)
        n = counts[len(sessions) - 1]
        return [("row", 10.0 * i, 10.0 * i + 3.0) if i % 2 == 0 else ("reduce", 10.0 * i, 10.0 * i + 1.0)
                for i in range(n)]

    monkeypatch.setattr(bench, "profiled_named_events", events)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = bench.device_ms_by_kernel(lambda: None, "K2", iters=20)
    assert sessions == ["K2"] * len(counts)
    assert got == (None if want is None else pytest.approx(want))


def test_flushing_writes_the_buffer_before_each_call(monkeypatch):
    monkeypatch.setattr(bench, "L2_FLUSH_BYTES", 64)
    calls = []
    fn = bench.flushing(lambda: calls.append(1), "cpu")
    fn()
    fn()
    assert calls == [1, 1]



def _exports() -> dict:
    """name -> parameter list of every ``VP_EXPORT`` function in ``csrc/``."""
    out = {}
    for src in sorted((Path(_lib.__file__).parent / "csrc").glob("*.cu")):
        for m in re.finditer(r"VP_EXPORT\s+[\w\s\*]+?\b(vp_\w+)\(([^)]*)\)", src.read_text()):
            out[m.group(1)] = [a.strip() for a in m.group(2).split(",") if a.strip()]
    return out


@pytest.mark.parametrize("name", sorted(_lib._SIGNATURES))
def test_ctypes_signature_matches_the_export(name):
    """ctypes passes what ``_SIGNATURES`` lists and nothing else checks it
    against the C side, so a parameter added to or removed from an export
    must show here: same count, pointers where the C side takes pointers."""
    params = _exports()[name]
    want = _lib._SIGNATURES[name]
    assert len(want) == len(params), (name, params)
    for ctype, param in zip(want, params):
        assert (ctype is ctypes.c_void_p) == ("*" in param), (name, param, ctype)
