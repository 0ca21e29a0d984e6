"""The kernel tooling's pure-Python parts on the CPU: where the build
(``video_prediction_torch/kernels/_lib.py``) puts the library and ptxas's
report, and how the report is read into registers and spills per kernel
instantiation; the device-time script (``kernels/bench.py``) refuses to run
without a card, runs a profiler session again that lost device records, and
makes K2's inputs as ``chip_smoke.py`` uses them."""

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
ptxas info    : Compiling entry function '_Z14ln_grad_reducePKfPfii' for 'sm_90a'
ptxas info    : Function properties for _Z14ln_grad_reducePKfPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 376 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    log = tmp_path / "lib.ptxas.txt"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_lib, "ptxas_log_path", lambda: log)
    rows = _lib.ptxas_report()
    assert [r[1:] for r in rows] == [(111, 0, 0), (48, 36, 32), (12, 0, 0)]
    assert "cdna_forward_kernel" in rows[0][0] and "cdna_backward_kernel" in rows[1][0]
    assert "ln_grad_reduce" in rows[2][0]  # mangled, or demangled where the toolkit has cu++filt


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
