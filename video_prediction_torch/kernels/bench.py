"""Device time of the port's six kernels at the shapes of the main paths.

    python3 video_prediction_torch/kernels/bench.py [--root DIR] [--iters 20] [--detail] [--e2e]

``device_ms`` is what ``chip_smoke.py`` reports as a kernel's device time:
the summed durations of the kernel's own device events (grouped as
``train/profile_step.py`` groups them: K1, K2, K3, each with its reduce
kernel) over ``iters`` calls recorded by ``torch.profiler`` with device
activity only, after warm-up, divided by ``iters``. It is not paced by the
host, unlike CUDA events around back-to-back Python calls. A profiler
session that lost device records is run again (``device_ms``).

Run as a script it times every kernel, forward at batch 8, 32 and 64 and
backward at 32 (K2 per generator step of six calls, and per width), K2 also
in bf16 at the bf16 model's batches (``BF16_LN_GATE``), and prints one JSON
object. ``--root`` imports the kernels from another
checkout of the repository whose wrappers take the same arguments (the
kernels of an earlier commit, for a comparison inside one run). Needs a
CUDA device.

``--detail`` adds, for K2: each width's time with the 50 MB L2 flushed
before every call (a 128 MB memset, which is not in the K2 group, so not
counted), the backward's time split by device kernel (the row kernel and
the d ln_params reduce) and ptxas's registers and spills of every K2
instantiation; for K3: the forward's time at batch 8 with the L2 flushed
the same way, ptxas's rows of every K3 instantiation, and the device time
of one copy of the same bytes as the batch-8 forward moves (the least one
kernel of that size takes here); and the video discriminator's bf16
conv3d layers, forward and backward, by input layout (``conv3d_layouts``:
why ``ops/spectral.py#SpectralConv3D`` copies a bf16 input to NCDHW).

``--e2e`` times the fp32 model (``bair_action_free/ours_savp``, seeded
random weights) at the CLIs' default of TF32 convs: the no-grad rollout at
batch 8 and 64 and the train step at batch 16 (``e2e_ms``), with the same
``--root``, so that two checkouts' whole paths compare in one run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Callable, Dict, Optional

import torch

# (C, px) of the six K2 calls of one generator step (ngf=32, 64x64), as in
# roofline.py; a copy, so that the script also times a checkout without it
LN_GATE_STEP = ((64, 32), (128, 16), (256, 8), (128, 16), (64, 32), (32, 64))
# the sleep that holds the stream while the host queues ``queued_ms``'s calls:
# about 25 ms at the H100's 1.98 GHz, far longer than queuing 20 calls takes
QUEUE_CYCLES = 50_000_000
# the ``device_ms`` calls whose first profiler session lost device records:
# each session's event count, and ``queued_ms``'s time where none was whole
REPEATS: list = []


# K2's batches in the bf16 model (``compute_dtype`` and ``gate_dtype``
# bfloat16): the generation rollout (8), the evaluate and ``*_tpu`` rollout
# (64), and the ``*_tpu`` train step's doubled batch (2 x 64)
BF16_LN_GATE = {"fused_ln_gate": (8, 64, 128), "fused_ln_gate_backward": (128,)}

# bytes written between calls to flush the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def profiled_named_events(fn: Callable[[], object], group: Optional[str], iters: int) -> list:
    """(name, start, end), times in us, of the device events of profile group
    ``group`` (every device event if None) in one profiler session of
    ``iters`` calls."""
    from video_prediction_torch.train.profile_step import group_of

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CPU and not getattr(e, "is_user_annotation", False)
            and (group is None or group_of(e.name) == group)]


def profiled_events(fn: Callable[[], object], group: Optional[str], iters: int) -> list:
    """(start, end) in us of the device events of ``profiled_named_events``."""
    return [(start, end) for _, start, end in profiled_named_events(fn, group, iters)]


def queued_ms(fn: Callable[[], object], iters: int) -> float:
    """Device ms per call of ``fn`` from CUDA events around ``iters`` calls
    queued behind a sleep kernel, so that the host's pace does not enter: all
    of ``fn``'s device work, and the gaps between its kernels."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable[[], object], group: Optional[str] = None, iters: int = 20, warmup: int = 3,
              sessions: int = 5) -> float:
    """Mean device time per call of ``fn`` in ms: the durations of its device
    events of profile group ``group`` (every device event if None).

    ``fn`` launches as many events of the group in every call, so a session
    holds a positive multiple of ``iters`` of them. Now and then a session
    comes back without some or all of its device records (seen on an H100
    with torch 2.11: none of 20 K3 launches), which would read as a failure
    or as too short a time; such a session is run again, up to ``sessions``
    sessions in all. If none is whole, the time is ``queued_ms``'s instead.
    ``REPEATS`` records both."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(sessions):
        events = profiled_events(fn, group, iters)
        counts.append(len(events))
        if events and len(events) % iters == 0:
            if len(counts) > 1:
                REPEATS.append({"group": group, "event_counts": counts})
            return sum(end - start for start, end in events) / 1e3 / iters
    ms = queued_ms(fn, iters)
    REPEATS.append({"group": group, "event_counts": counts, "queued_ms": ms})
    print(f"device_ms: the profiler recorded {counts} device events of group {group} in {sessions} sessions of "
          f"{iters} calls; timed by CUDA events behind a queued sleep instead: {ms:.4f} ms", file=sys.stderr)
    return ms


def device_ms_by_kernel(fn: Callable[[], object], group: str, iters: int = 20, warmup: int = 3,
                        sessions: int = 5) -> Optional[Dict[str, float]]:
    """``device_ms`` split by device kernel name: ms per call of each kernel
    of ``group``, from the first whole session of up to ``sessions`` (None if
    none is whole)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        events = profiled_named_events(fn, group, iters)
        if events and len(events) % iters == 0:
            out: Dict[str, float] = {}
            for name, start, end in events:
                out[name] = out.get(name, 0.0) + (end - start) / 1e3 / iters
            return out
    return None


def flushing(fn: Callable[[], object], dev) -> Callable[[], object]:
    """``fn`` with ``L2_FLUSH_BYTES`` written before every call, so that it
    finds its inputs in device memory, not in the L2."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    return lambda: (buf.zero_(), fn())


def ln_inputs(gen: torch.Generator, rows: int, cdim: int, dev, dtype: torch.dtype = torch.float32):
    """z [R,4C], c [R,C], ln_params [10,C] (scale, bias per LayerNorm) and two
    upstream gradients [R,C], as ``chip_smoke.py`` makes them: ln_params
    fp32, the others drawn in fp32 and rounded to ``dtype``."""
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    lnp = torch.cat([1.0 + 0.1 * randn(5, cdim), 0.1 * randn(5, cdim)], dim=0)
    lnp = lnp.reshape(2, 5, cdim).transpose(0, 1).reshape(10, cdim).contiguous()
    z, c, dcn, dhn = randn(rows, 4 * cdim) * 2.0, randn(rows, cdim), randn(rows, cdim), randn(rows, cdim)
    return z.to(dtype), c.to(dtype), lnp, dcn.to(dtype), dhn.to(dtype)


def ln_gate_widths(fn, batch: int, dev, iters: int, flush: bool = False, by_kernel: bool = False,
                   dtype: torch.dtype = torch.float32) -> Dict[int, object]:
    """Device ms per call of ``fn(z, c, lnp, dc', dh)`` at each K2 width of a
    generator step at ``batch``, in ``dtype`` (C -> ms; with ``by_kernel``, C
    -> {device kernel: ms}); with ``flush``, the L2 flushed before every call."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    out: Dict[int, object] = {}
    for cdim, px in sorted(set(LN_GATE_STEP)):
        z, c, lnp, dcn, dhn = ln_inputs(gen, batch * px * px, cdim, dev, dtype)
        call = lambda: fn(z, c, lnp, dcn, dhn)  # noqa: E731
        call = flushing(call, dev) if flush else call
        out[cdim] = device_ms_by_kernel(call, "K2", iters=iters) if by_kernel else device_ms(call, "K2", iters=iters)
    return out


def ln_gate_step_ms(per_width: Dict[int, float]) -> float:
    """Device ms of one generator step's six K2 calls, from ``ln_gate_widths``."""
    return sum(per_width[cdim] for cdim, _ in LN_GATE_STEP)


def all_kernels(dev, iters: int = 20, widths: Optional[dict] = None) -> Dict[str, Dict[str, float]]:
    """Device ms of the six kernels: forward at batch 8, 32 and 64, backward
    at 32; K2 also in bf16 at the bf16 model's shapes (``BF16_LN_GATE``); K2's
    per width also into ``widths`` where given."""
    from video_prediction_torch import kernels as K

    widths = {} if widths is None else widths
    gen = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, Dict[str, float]] = {name: {} for name in K.WRAPPERS}
    for batch in (8, 32, 64):
        image = torch.rand(batch, 64, 64, 3, generator=gen, device=dev)
        kern = torch.softmax(torch.randn(batch, 25, 4, generator=gen, device=dev), 1).reshape(batch, 5, 5, 4)
        cand, logits = composite_inputs(gen, batch, dev)
        out["apply_cdna_kernels"][f"batch {batch}"] = device_ms(lambda: K.apply_cdna_kernels(image, kern), "K1",
                                                                iters=iters)
        per_width = ln_gate_widths(lambda z, c, lnp, *_: K.fused_ln_gate(z, c, lnp), batch, dev, iters)
        widths.setdefault("fused_ln_gate", {})[f"batch {batch}"] = per_width
        out["fused_ln_gate"][f"batch {batch}"] = ln_gate_step_ms(per_width)
        out["composite"][f"batch {batch}"] = device_ms(lambda: K.composite(cand, logits), "K3", iters=iters)
        if batch == 32:
            grad = torch.randn(batch, 4, 64, 64, 3, generator=gen, device=dev)
            out["apply_cdna_kernels_backward"]["batch 32"] = device_ms(
                lambda: K.apply_cdna_kernels_backward(image, kern, grad), "K1", iters=iters)
            per_width = ln_gate_widths(K.fused_ln_gate_backward, batch, dev, iters)
            widths["fused_ln_gate_backward"] = {"batch 32": per_width}
            out["fused_ln_gate_backward"]["batch 32"] = ln_gate_step_ms(per_width)
            g3 = torch.randn(batch, 64, 64, 3, generator=gen, device=dev)
            out["composite_backward"]["batch 32"] = device_ms(lambda: K.composite_backward(cand, logits, g3), "K3",
                                                              iters=iters)
    for name, batches in BF16_LN_GATE.items():
        fn = K.fused_ln_gate_backward if name.endswith("backward") else lambda z, c, lnp, *_: K.fused_ln_gate(z, c, lnp)
        for batch in batches:
            per_width = ln_gate_widths(fn, batch, dev, iters, dtype=torch.bfloat16)
            widths.setdefault(name, {})[f"bfloat16 batch {batch}"] = per_width
            out[name][f"bfloat16 batch {batch}"] = ln_gate_step_ms(per_width)
    return out


def ln_gate_detail(dev, iters: int) -> dict:
    """``--detail``: K2 with the L2 flushed, the backward by device kernel
    and ptxas's K2 rows."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import _lib

    fwd = lambda z, c, lnp, *_: K.fused_ln_gate(z, c, lnp)  # noqa: E731
    return {
        "flushed": {"fused_ln_gate": {"batch 8": ln_gate_widths(fwd, 8, dev, iters, flush=True)},
                    "fused_ln_gate_backward": {"batch 32": ln_gate_widths(K.fused_ln_gate_backward, 32, dev, iters,
                                                                          flush=True)}},
        "backward_by_kernel": {"batch 32": ln_gate_widths(K.fused_ln_gate_backward, 32, dev, iters, by_kernel=True)},
        "ptxas": [row for row in _lib.ptxas_report() if re.search(r"ln_(gate|grad)_", row[0])],
    }


def composite_inputs(gen: torch.Generator, batch: int, dev):
    """Candidates [B,7,64,64,3] and mask logits [B,64,64,7] (``ours_savp``'s
    7 candidates), fp32."""
    cand = torch.rand(batch, 7, 64, 64, 3, generator=gen, device=dev)
    return cand, torch.randn(batch, 64, 64, 7, generator=gen, device=dev) * 3.0


def composite_detail(dev, iters: int) -> dict:
    """``--detail``: K3 forward at batch 8 with the L2 flushed, ptxas's K3
    rows, and beside them the device time of one copy that moves the same
    bytes as K3 at batch 8 (reads half, writes half; L2-warm, as K3's warm
    figure is): what one kernel of that size takes on this card at least."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import _lib
    from video_prediction_torch.kernels import roofline as RL

    cand, logits = composite_inputs(torch.Generator(device=dev).manual_seed(8), 8, dev)
    src = torch.zeros(RL.composite_forward(8, 7)[0] // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    return {"flushed": {"composite": {"batch 8": device_ms(flushing(lambda: K.composite(cand, logits), dev), "K3",
                                                           iters=iters)}},
            "ptxas": [row for row in _lib.ptxas_report() if "composite_" in row[0]],
            "copy_same_bytes_batch_8": device_ms(lambda: dst.copy_(src), iters=iters)}


def conv3d_layouts(dev, batch: int = 128, ndf: int = 32, iters: int = 3) -> list:
    """ms of one forward and backward of each of the video discriminator's
    six conv3d layers in bf16 (``models/networks.py#VideoSNDiscriminator``,
    ``ndf`` as the zoo's), at ``batch`` clips of 10 frames of 64x64 (the
    ``*_tpu`` train step's discriminator update on real and fake clips), from
    the clip's channels-last view (``permute`` of NTHWC) and from a
    contiguous NCDHW copy: CUDA events around ``iters`` calls after one."""
    import torch.nn.functional as F

    from video_prediction_torch.models.networks import VideoSNDiscriminator
    from video_prediction_torch.ops.spectral import same_pads

    gen = torch.Generator(device=dev).manual_seed(3)
    shape, cin, rows = [10, 64, 64], 3, []
    for i, (mult, k, st) in enumerate(VideoSNDiscriminator.SPEC):
        cout = ndf * mult
        x = torch.randn(batch, *shape, cin, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(cout, cin, *k, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
        pads = [p for n, kk, ss in reversed(list(zip(shape, k, st))) for p in same_pads(n, kk, ss)]
        row = {"layer": f"sn_conv3d{i}", "in": [batch, *shape, cin], "weight": list(w.shape)}
        for layout in ("channels_last", "contiguous"):
            xc = x.permute(0, 4, 1, 2, 3)
            xc = (xc.contiguous() if layout == "contiguous" else xc).detach().requires_grad_()

            def call():
                y = F.conv3d(F.pad(xc, pads), w, stride=st)
                y.backward(torch.ones_like(y))

            call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            row[f"{layout}_ms"] = start.elapsed_time(end) / iters
        rows.append(row)
        shape, cin = [-(-n // ss) for n, ss in zip(shape, st)], cout
    return rows


def e2e_ms(dev, iters: int = 10) -> Dict[str, float]:
    """ms of the fp32 ``ours_savp`` rollout (no grad, CUDA events around
    ``iters`` calls after 3) at batch 8 and 64, and of its train step at
    batch 16 (host clock, synchronised, over ``iters`` steps after 2), with
    cuDNN's TF32 convs, as the CLIs run; beside each, the device events of
    one call and their summed device ms (one profiler session of 2 calls),
    the work the device is given whatever the host's pace."""
    import time

    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    zoo = zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo))

    def data(batch: int, seed: int):
        return batch_to_device(next(SyntheticVideoDataset(mode="test", seed=seed).make_iterator(batch)), dev)

    def timed(label: str, fn, warmup: int, events_ms) -> None:
        for _ in range(warmup):
            fn()
        events = profiled_named_events(fn, None, 2)
        out[f"{label} device events"] = len(events) / 2
        out[f"{label} device ms"] = sum(end - start for _, start, end in events) / 1e3 / 2
        out[label] = events_ms(fn)

    def cuda_events_ms(fn) -> float:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    out: Dict[str, float] = {}
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    for batch in (8, 64):
        x = data(batch, 2)
        z = torch.randn(batch, hp.sequence_length - 1, hp.nz, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
        with torch.inference_mode():
            timed(f"rollout batch {batch}", lambda: model(x, zs_prior=z), 3, cuda_events_ms)
    del model
    model = get_model_class("savp")(hp.replace(batch_size=16), image_shape=(64, 64, 3), action_dim=4)
    ts, step, x = create_train_state(model, 0, dev), make_train_step(model), data(16, 8)
    timed("train step batch 16", lambda: step(ts, x), 2, host_ms)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   help="checkout whose video_prediction_torch to time (default: this one)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--detail", action="store_true",
                   help="also K2 and K3 with the L2 flushed, K2 by device kernel, ptxas's rows and the bf16 "
                        "conv3d layouts")
    p.add_argument("--e2e", action="store_true",
                   help="time the fp32 rollout (batch 8, 64) and train step (batch 16) instead of the kernels")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import video_prediction_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(video_prediction_torch.__file__))) != root:
        print(f"bench: imported {video_prediction_torch.__file__}, not from {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.e2e:
        print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "e2e_ms": e2e_ms(dev)}))
        return 0
    widths: dict = {}
    result = {"root": root, "device": torch.cuda.get_device_name(0),
              "device_ms": all_kernels(dev, args.iters, widths), "ln_gate_widths": widths}
    if args.detail:
        result["ln_gate_detail"] = ln_gate_detail(dev, args.iters)
        result["composite_detail"] = composite_detail(dev, args.iters)
        result["conv3d_layouts"] = conv3d_layouts(dev)
    result["repeats"] = REPEATS
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
