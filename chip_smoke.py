#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``video_prediction_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA GPU, ``nvcc``
and ``nvidia-smi``. Phases, each fatal on failure:

1. report the device (name and power limit from ``nvidia-smi``);
2. build the CUDA kernels from ``video_prediction_torch/kernels/csrc``;
3. compare each kernel with its plain PyTorch version on the card, at the
   generation slice's shapes (batch 8), fp32 and bf16, and time both;
4. drive ``video_prediction_torch.generate`` at the full ``ours_savp`` width
   (64x64, ngf=32, nz=8) from a run directory with seeded random weights, and
   check GIFs, finite outputs and the kernel launch counts per rollout;
5. compare the GPU rollout (kernels) with the CPU rollout (plain versions)
   of the same weights, batch and z, with TF32 off;
6. time the no-grad rollout at effective batch 8 and 64.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 8
# (tolerance on |kernel - plain|: atol + rtol * |plain|)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# K2 widths of one generator step at ngf=32, 64x64: encoder 64, 128, 256 at
# 32, 16, 8 px; decoder 128, 64, 32 at 16, 32, 64 px
LN_GATE_STEP = [(64, 32), (128, 16), (256, 8), (128, 16), (64, 32), (32, 64)]
# kernel launches in one rollout of 11 generator steps (12 frames)
LAUNCHES_PER_ROLLOUT = {"apply_cdna_kernels": 11, "fused_ln_gate": 66, "composite": 11}
# |GPU - CPU| on gen_images in [0, 1]: fp32 with TF32 off, but sums in
# other orders through 11 recurrent steps; 1e-3 is a quarter of one 8-bit
# gray level of the written GIFs
ROLLOUT_TOL = 1e-3
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed nothing")
    return out.splitlines()[0].strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(out, ref, dtype_name: str):
    """(max |out - ref|, whether every element is within the tolerance)."""
    atol, rtol = TOL[dtype_name]
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool(((diff <= atol + rtol * ref.abs()) & torch.isfinite(out)).all())
    return float(diff.max()), ok


def kernel_phase(dev) -> list:
    """Phase 3: every kernel against its plain version, fp32 and bf16."""
    from video_prediction_torch import kernels as K

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
    results = []

    # K1 ------------------------------------------------------------------
    image = rand(BATCH, 64, 64, 3)
    kern = torch.softmax(randn(BATCH, 25, 4), dim=1).reshape(BATCH, 5, 5, 4).contiguous()
    errs = {}
    for dt in ("float32", "bfloat16"):
        img = image.to(getattr(torch, dt))
        err, ok = max_err(K.apply_cdna_kernels(img, kern), K.apply_cdna_kernels_reference(img, kern), dt)
        print(f"K1 apply_cdna_kernels {dt} [8,64,64,3]x[8,5,5,4]: max_abs_err {err:.3g} (tol {TOL[dt]})")
        check(ok, f"K1 {dt} disagrees with its plain version: {err}")
        errs[dt] = err
    ms = cuda_ms(lambda: K.apply_cdna_kernels(image, kern))
    plain_ms = cuda_ms(lambda: K.apply_cdna_kernels_reference(image, kern))
    print(f"K1 time per call (1 call per step), fp32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(
        name="apply_cdna_kernels", route="cuda", source="video_prediction_torch/kernels/csrc/cdna.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:82",
        max_abs_err=errs["float32"], ms=ms, plain_ms=plain_ms,
    ))

    # K2 ------------------------------------------------------------------
    errs = {"float32": 0.0, "bfloat16": 0.0}
    ms = plain_ms = 0.0
    per_width = {}
    for cdim, px in sorted(set(LN_GATE_STEP)):
        r = BATCH * px * px
        z = randn(r, 4 * cdim) * 2.0
        c = randn(r, cdim)
        lnp = torch.cat([1.0 + 0.1 * randn(5, cdim), 0.1 * randn(5, cdim)], dim=0)
        lnp = lnp.reshape(2, 5, cdim).transpose(0, 1).reshape(10, cdim).contiguous()  # scale, bias per LN
        for dt in ("float32", "bfloat16"):
            zz, cc = z.to(getattr(torch, dt)), c.to(getattr(torch, dt))
            out = K.fused_ln_gate(zz, cc, lnp)
            ref = K.fused_ln_gate_reference(zz, cc, lnp)
            check(out[0].dtype == cc.dtype and out[1].dtype == cc.dtype, "K2 output dtype must follow c")
            e0, ok0 = max_err(out[0], ref[0], dt)
            e1, ok1 = max_err(out[1], ref[1], dt)
            print(f"K2 fused_ln_gate {dt} R={r} C={cdim}: max_abs_err c {e0:.3g} h {e1:.3g} (tol {TOL[dt]})")
            check(ok0 and ok1, f"K2 {dt} C={cdim} disagrees with its plain version: {e0}, {e1}")
            errs[dt] = max(errs[dt], e0, e1)
        per_width[cdim] = (
            cuda_ms(lambda: K.fused_ln_gate(z, c, lnp)),
            cuda_ms(lambda: K.fused_ln_gate_reference(z, c, lnp)),
        )
        print(f"K2 time per call C={cdim} R={r}, fp32: kernel {per_width[cdim][0]:.4f} ms, "
              f"plain {per_width[cdim][1]:.4f} ms")
    for cdim, _ in LN_GATE_STEP:
        ms += per_width[cdim][0]
        plain_ms += per_width[cdim][1]
    print(f"K2 time per generator step (6 calls), fp32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(
        name="fused_ln_gate", route="cuda", source="video_prediction_torch/kernels/csrc/ln_gate.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:145",
        max_abs_err=errs["float32"], ms=ms, plain_ms=plain_ms,
    ))

    # K3 ------------------------------------------------------------------
    cand = rand(BATCH, 7, 64, 64, 3)
    logits = randn(BATCH, 64, 64, 7) * 3.0
    errs = {}
    for dt in ("float32", "bfloat16"):
        cd, lg = cand.to(getattr(torch, dt)), logits.to(getattr(torch, dt))
        out, masks = K.composite(cd, lg, with_masks=True)
        ref, ref_masks = K.composite_reference(cd, lg, with_masks=True)
        e0, ok0 = max_err(out, ref, dt)
        e1, ok1 = max_err(masks, ref_masks, "float32")
        print(f"K3 composite {dt} [8,7,64,64,3]: max_abs_err out {e0:.3g} masks {e1:.3g} (tol {TOL[dt]})")
        check(ok0 and ok1, f"K3 {dt} disagrees with its plain version: {e0}, {e1}")
        errs[dt] = max(e0, e1)
    ms = cuda_ms(lambda: K.composite(cand, logits))
    plain_ms = cuda_ms(lambda: K.composite_reference(cand, logits))
    print(f"K3 time per call (1 call per step), fp32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(
        name="composite", route="cuda", source="video_prediction_torch/kernels/csrc/composite.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:198",
        max_abs_err=errs["float32"], ms=ms, plain_ms=plain_ms,
    ))
    return results


def slice_hparams():
    """``savp`` defaults overridden by the ``ours_savp`` zoo file, as
    ``scripts/train.py`` resolves them: 64x64, ngf=32, nz=8, 12 frames."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class

    zoo = zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo))
    check((hp.ngf, hp.nz, hp.sequence_length, hp.context_frames) == (32, 8, 12, 2), f"unexpected slice config {hp}")
    return hp


def synthetic_batch(batch_size: int, seed: int, device):
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset
    from video_prediction_torch.generate import batch_to_device

    return batch_to_device(next(SyntheticVideoDataset(mode="test", seed=seed).make_iterator(batch_size)), device)


def generate_phase():
    """Phase 4: ``video_prediction_torch.generate`` on a run directory with
    seeded flax-like random weights; returns the model and the launch counts."""
    import shutil

    from video_prediction_torch import generate
    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import DatasetHparams
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.checkpoint import write_run_dir

    hp = slice_hparams()
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)  # synthetic: 4 action dims
    model.init_weights(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    run_dir, results = os.path.join(WORK_DIR, "run"), os.path.join(WORK_DIR, "results")
    write_run_dir(run_dir, "savp", "synthetic", hp, DatasetHparams(context_frames=2, sequence_length=12), model)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = generate.main([
        "--checkpoint", run_dir, "--results_dir", results, "--device", "cuda",
        "--batch_size", "8", "--num_samples", "16", "--num_stochastic_samples", "2",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    rollouts = summary["rollouts"]
    gifs = [f for f in os.listdir(summary["out_dir"]) if f.endswith(".gif")]
    print(f"generate: {n_params} params, {rollouts} rollouts, {len(gifs)} GIFs, {wall:.2f} s wall "
          f"(build, restore and first-call set-up included); launches {launches}")
    check(rollouts == 4 and summary["gifs"] == 32 and len(gifs) == 32, f"unexpected generate summary {summary}")
    check(summary["all_finite"], "generate produced non-finite values")
    want = {k: n * rollouts for k, n in LAUNCHES_PER_ROLLOUT.items()}
    check(launches == want, f"kernel launches {launches}, want {want} ({rollouts} rollouts)")
    return model, launches


def cpu_vs_gpu_phase(cpu_model, gpu_model, dev) -> None:
    """Phase 5: the same weights, batch and z through the plain versions on
    the CPU and the kernels on the GPU, fp32 with TF32 off, batch 2."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_batch(2, seed=1, device="cpu")
    z = torch.randn(2, 11, 8, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = cpu_model(batch, zs_prior=z)["gen_images"]
        out = gpu_model({k: v.to(dev) for k, v in batch.items()}, zs_prior=z.to(dev))["gen_images"].cpu()
    err = float((out - ref).abs().max())
    print(f"rollout GPU vs CPU, batch 2, fp32 (TF32 off): max_abs_err {err:.3g} (tol {ROLLOUT_TOL}), "
          f"gen_images mean {float(ref.mean()):.4f} std {float(ref.std()):.4f}")
    check(bool(torch.isfinite(out).all()), "GPU rollout is not finite")
    check(err <= ROLLOUT_TOL, f"GPU rollout differs from the CPU rollout by {err}")


def timing_phase(gpu_model, dev, ident: str) -> None:
    """Phase 6: no-grad rollout time with CUDA events after warm-up."""
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for bsz in (8, 64):
            batch = synthetic_batch(bsz, seed=2, device=dev)
            z = torch.randn(bsz, 11, 8, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
            with torch.inference_mode():
                ms = cuda_ms(lambda: gpu_model(batch, zs_prior=z), iters=10, warmup=3)
            frames = bsz * 10  # predicted frames per rollout (T - context_frames), as bench_generate counts
            print(f"rollout batch {bsz}, {'TF32 convs' if tf32 else 'fp32 (TF32 off)'}: {ms:.2f} ms, "
                  f"{frames / ms * 1e3:.0f} generated frames/s [{ident}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import video_prediction_torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from a checkout of the repo",
              file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(video_prediction_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        print(f"chip_smoke: FAIL: imported the port from {pkg_dir}, not from {ROOT}", file=sys.stderr)
        return 1

    try:
        # 1. device
        dev = torch.device("cuda", 0)
        ident = gpu_identity()
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {ident}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        # 2. build
        from video_prediction_torch.kernels import _lib

        t0 = time.perf_counter()
        _lib.load_library()
        print(f"build: {time.perf_counter() - t0:.2f} s -> {_lib.library_path().relative_to(ROOT)}")

        # 3. kernels against their plain versions
        kernel_results = kernel_phase(dev)
        torch.cuda.synchronize()

        # 4. the generation entry point at full width
        model, launches = generate_phase()
        for entry in kernel_results:
            entry["launches"] = launches[entry["name"]]

        # 5. GPU rollout (kernels) against CPU rollout (plain versions)
        gpu_model = copy.deepcopy(model).to(dev).eval()
        cpu_vs_gpu_phase(model, gpu_model, dev)

        # 6. rollout time
        timing_phase(gpu_model, dev, ident)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": kernel_results}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
