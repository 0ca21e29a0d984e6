"""The train-step profiler (``python -m video_prediction_torch.train.profile_step``)
on the CPU at a small width: it runs the step, and its summary line is
consistent (the CPU has no device events, so nothing counts as busy); the
``dna_l2`` model through ``--model`` and ``--model_hparams_dict``, the
flags that shape the batch, the kept trace, the refusal of the models
without a train step; the
interval union that gives the device's busy time; the groups kernel names
fall into; and the check of a window's device events against the kernel
wrappers' launch counts, with its reruns and its report of a shortfall."""

import json
from pathlib import Path

import pytest
import torch

from video_prediction_torch.train import profile_step
from video_prediction_torch.train.profile_step import group_of, main, union_ms, whole_window, window_shortfall

torch.set_num_threads(1)

SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4"


def test_profile_step_runs_on_cpu(capsys):
    summary = main(["--device", "cpu", "--batch_size", "2", "--steps", "1",
                    "--model_hparams", SMALL])
    assert summary["finite"] and summary["step_ms"] > 0 and summary["window_ms"] > 0
    assert summary["busy_ms"] == 0.0 and summary["launches"] == 0 and summary["busy_share"] == 0.0
    assert sorted(summary["device_ms"]) == ["K1", "K2", "K3", "conv_gemm", "other"]
    assert summary["windows"] == 1 and summary["shortfall"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary


DNA_L2 = str(Path(__file__).resolve().parent.parent / "hparams" / "bair" / "dna_l2" / "model_hparams.json")


def test_profile_step_dna_l2_on_cpu(tmp_path, capsys):
    """``--model dna --model_hparams_dict bair/dna_l2`` at a small width: the
    dna model trains (its l2 and state terms), the frame size and sequence
    structure come from the flags, and ``--outdir`` keeps the window's trace."""
    summary = main(["--device", "cpu", "--model", "dna", "--model_hparams_dict", DNA_L2, "--model_hparams", "ngf=4",
                    "--batch_size", "2", "--steps", "1", "--image_size", "32", "--sequence_length", "5",
                    "--context_frames", "3", "--outdir", str(tmp_path / "trace")])
    assert summary["finite"] and summary["model"] == "dna" and summary["shortfall"] is None
    assert (summary["image_size"], summary["sequence_length"], summary["context_frames"]) == (32, 5, 3)
    assert summary["trace"] == str(tmp_path / "trace" / "trace.json")
    with open(summary["trace"]) as f:
        assert json.load(f)["traceEvents"]
    out = capsys.readouterr().out
    assert f"trace of the profiled window: {summary['trace']}" in out
    assert json.loads(out.strip().splitlines()[-1]) == summary


def test_profile_step_flags_reach_the_batch(monkeypatch):
    """``--image_size``, ``--sequence_length`` and ``--context_frames`` shape
    the synthetic batch the step trains on and the model's hparams; without
    ``--model_hparams_dict`` ``savp`` is the ours_savp flagship."""
    seen = {}
    real = profile_step.profile_window

    def window(step, steps, cuda, sync, trace=""):
        seen["trace"] = trace
        return real(step, steps, cuda, sync, trace)

    from video_prediction_torch.train import step as step_module

    make = step_module.make_train_step

    def make_train_step(model):
        step = make(model)
        seen["hp"] = model.hparams

        def recording(ts, batch):
            seen["images"] = tuple(batch["images"].shape)
            return step(ts, batch)

        return recording

    monkeypatch.setattr(profile_step, "profile_window", window)
    monkeypatch.setattr(step_module, "make_train_step", make_train_step)
    summary = main(["--device", "cpu", "--batch_size", "2", "--steps", "1", "--model_hparams", SMALL,
                    "--image_size", "16", "--sequence_length", "4", "--context_frames", "1"])
    assert seen["images"] == (2, 4, 16, 16, 3)
    hp = seen["hp"]
    assert (hp.sequence_length, hp.context_frames, hp.batch_size, hp.ngf, hp.nz) == (4, 1, 2, 4, 4)
    assert hp.kl_weight > 0 and hp.video_sn_vae_gan_weight > 0  # the ours_savp zoo file
    assert summary["trace"] == seen["trace"] and seen["trace"].endswith("trace.json")


@pytest.mark.parametrize("model", ["repeat", "ground_truth"])
def test_profile_step_refuses_models_without_a_train_step(model):
    with pytest.raises(ValueError, match=r"no train step.*\['dna', 'savp', 'sna', 'sv2p'\]"):
        main(["--device", "cpu", "--model", model])


@pytest.mark.parametrize("intervals, want_us", [
    ([], 0.0),
    ([(1.0, 3.0), (2.0, 5.0), (7.0, 8.0)], 5.0),  # overlap merges
    ([(1.0, 9.0), (2.0, 3.0)], 8.0),  # nested
    ([(8.0, 20.0), (-5.0, 2.0), (2.0, 4.0)], 21.0),  # unsorted, touching
])
def test_union_ms(intervals, want_us):
    assert union_ms(intervals) == pytest.approx(want_us / 1e3)


# K2's kernels of csrc/ln_gate.cu as the profiler names them: forward and
# backward, fp32 and bf16, each compile-time width with its values a lane
# and the run-time instantiation's; and its reduce
K2_NAMES = [
    f"void (anonymous namespace)::ln_gate_{d}_kernel<{t}, {ct}, {vpt}>((anonymous namespace)::Args<{t}>)"
    for d in ("forward", "backward")
    for t, widths in (("float", ((32, 4), (64, 4), (128, 4), (256, 8))),
                      ("__nv_bfloat16", ((32, 8), (64, 8), (128, 8), (256, 8))))
    for ct, vpt in widths + tuple((0, v) for v in (1, 2, 4, 8, 16))
] + ["(anonymous namespace)::ln_gate_grad_reduce(float const*, float*, int, int)"]
# K3 forward's instantiations as the profiler names them: compile-time K = 7
# and 6 at C = 3, and the run-time one, fp32 and bf16
K3_NAMES = [
    f"void (anonymous namespace)::composite_forward_kernel<{t}, {k}, {c}>((anonymous namespace)::Fwd<{t}>)"
    for t in ("float", "__nv_bfloat16") for k, c in ((7, 3), (6, 3), (0, 0))
]


@pytest.mark.parametrize("name, group", [
    ("void cdna_backward_kernel<float>(float const*, float const*)", "K1"),
    ("cdna_kernel_grad_reduce(float const*, float*, int)", "K1"),
    # the instantiations on C, kernel size and N, as the profiler names them
    ("void (anonymous namespace)::cdna_forward_kernel<float, 3, 5, 4>(float const*, ...)", "K1"),
    ("void (anonymous namespace)::cdna_backward_kernel<__nv_bfloat16, 0, 0, 0>(...)", "K1"),
    ("(anonymous namespace)::cdna_kernel_grad_reduce(float const*, float*, int, int, int)", "K1"),
    # the earlier K2 kernels' names, so that an earlier checkout is grouped alike
    ("ln_grad_reduce(float const*, float*, int, int)", "K2"),
    ("void ln_gate_forward_kernel<__nv_bfloat16>(...)", "K2"),
    *[(name, "K2") for name in K2_NAMES],
    ("void composite_backward_kernel<float>(...)", "K3"),
    ("void composite_forward_kernel<float>(...)", "K3"),  # the earlier K3 forward, so a parent checkout is grouped
    *[(name, "K3") for name in K3_NAMES],
    ("sm90_xmma_fprop_implicit_gemm_tf32f32", "conv_gemm"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(...)", "conv_gemm"),  # cuDNN's FFT convs
    ("void at::native::vectorized_elementwise_kernel<4>", "other"),
    ("Memset (Device)", "other"),
])
def test_kernel_groups(name, group):
    assert group_of(name) == group


LAUNCHES = {"apply_cdna_kernels": 2, "fused_ln_gate": 12, "composite": 2, "apply_cdna_kernels_backward": 2,
            "fused_ln_gate_backward": 12, "composite_backward": 2}


def fake_events(k1=6, k2=36, k3=4, other=3):
    """Device events (name, start, end) of a window: K1 2 + 2 x 2, K2 12 + 12
    x 2 and K3 2 + 2 for ``LAUNCHES``, and some others."""
    names = (["cdna_forward_kernel<float, 3, 5, 4>"] * k1 + [K2_NAMES[0]] * k2
             + ["composite_forward_kernel<float>"] * k3 + ["sm90_xmma_fprop"] * other)
    return [(name, 10.0 * i, 10.0 * i + 2.0) for i, name in enumerate(names)]


@pytest.mark.parametrize("events, want", [
    (fake_events(), {}),
    (fake_events(k2=35), {"K2": [35, 36]}),  # one record of a backward's reduce lost
    (fake_events(k1=0, k3=3), {"K1": [0, 6], "K3": [3, 4]}),
    (fake_events(other=0), {}),  # the other groups are not counted by launches
])
def test_window_shortfall(events, want):
    assert window_shortfall(events, LAUNCHES) == want


@pytest.mark.parametrize("k2_counts, windows, short", [
    ([36], 1, None),
    ([30, 36], 2, None),
    ([0, 12, 35, 36], 4, None),
    ([35, 0, 35, 34, 30], 5, {"K2": [30, 36]}),  # never whole: the last window's shortfall is reported
])
def test_whole_window_reruns_a_short_window(k2_counts, windows, short):
    calls = []

    def profile():
        calls.append(1)
        return fake_events(k2=k2_counts[len(calls) - 1]), 5.0, {"loss": 1.0}, LAUNCHES

    events, window_ms, scalars, n, shortfall = whole_window(profile)
    assert n == len(calls) == windows and (shortfall or None) == short
    assert sum(group_of(e[0]) == "K2" for e in events) == k2_counts[-1]


def test_main_reports_a_shortfall_instead_of_a_short_time(monkeypatch, capsys):
    """Fed windows that always lack K2 records, ``main`` profiles five and
    reports the shortfall, with no K2 time; the other groups keep theirs."""
    windows = []

    def fake_window(step, steps, cuda, sync, trace=""):
        windows.append(step())  # the step still runs
        return fake_events(k2=20), 5.0 * steps, windows[-1], LAUNCHES

    monkeypatch.setattr(profile_step, "profile_window", fake_window)
    summary = main(["--device", "cpu", "--batch_size", "2", "--steps", "1", "--model_hparams", SMALL])
    assert len(windows) == profile_step.WINDOWS == summary["windows"] == 5
    assert summary["shortfall"] == {"K2": [20, 36]} and summary["device_ms"]["K2"] is None
    assert summary["device_ms"]["K1"] == pytest.approx(6 * 2e-3) and summary["launches"] == 6 + 20 + 4 + 3
    out = capsys.readouterr().out
    assert out.count("profile window") == 5 and json.loads(out.strip().splitlines()[-1]) == summary
