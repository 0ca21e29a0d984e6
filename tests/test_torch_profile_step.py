"""The train-step profiler (``python -m video_prediction_torch.train.profile_step``)
on the CPU at a small width: it runs the step, and its summary line is
consistent (the CPU has no device events, so nothing counts as busy); and
the interval union that gives the device's busy time."""

import json

import pytest
import torch

from video_prediction_torch.train.profile_step import group_of, main, union_ms

torch.set_num_threads(1)

SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4"


def test_profile_step_runs_on_cpu(capsys):
    summary = main(["--device", "cpu", "--batch_size", "2", "--steps", "1",
                    "--model_hparams", SMALL])
    assert summary["finite"] and summary["step_ms"] > 0 and summary["window_ms"] > 0
    assert summary["busy_ms"] == 0.0 and summary["launches"] == 0 and summary["busy_share"] == 0.0
    assert sorted(summary["device_ms"]) == ["K1", "K2", "K3", "conv_gemm", "other"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary


@pytest.mark.parametrize("intervals, want_us", [
    ([], 0.0),
    ([(1.0, 3.0), (2.0, 5.0), (7.0, 8.0)], 5.0),  # overlap merges
    ([(1.0, 9.0), (2.0, 3.0)], 8.0),  # nested
    ([(8.0, 20.0), (-5.0, 2.0), (2.0, 4.0)], 21.0),  # unsorted, touching
])
def test_union_ms(intervals, want_us):
    assert union_ms(intervals) == pytest.approx(want_us / 1e3)


def test_kernel_groups():
    assert group_of("void cdna_backward_kernel<float>(float const*, float const*)") == "K1"
    assert group_of("cdna_kernel_grad_reduce(float const*, float*, int)") == "K1"
    # the instantiations on C, kernel size and N, as the profiler names them
    assert group_of("void (anonymous namespace)::cdna_forward_kernel<float, 3, 5, 4>(float const*, ...)") == "K1"
    assert group_of("void (anonymous namespace)::cdna_backward_kernel<__nv_bfloat16, 0, 0, 0>(...)") == "K1"
    assert group_of("(anonymous namespace)::cdna_kernel_grad_reduce(float const*, float*, int, int, int)") == "K1"
    assert group_of("ln_grad_reduce(float const*, float*, int, int)") == "K2"
    assert group_of("void ln_gate_forward_kernel<__nv_bfloat16>(...)") == "K2"
    assert group_of("void composite_backward_kernel<float>(...)") == "K3"
    assert group_of("sm90_xmma_fprop_implicit_gemm_tf32f32") == "conv_gemm"
    assert group_of("void pointwise_mult_and_sum_complex<float2, 8, 4>(...)") == "conv_gemm"  # cuDNN's FFT convs
    assert group_of("void at::native::vectorized_elementwise_kernel<4>") == "other"
