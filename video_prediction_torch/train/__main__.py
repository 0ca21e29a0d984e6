"""Training CLI.

    python -m video_prediction_torch.train --dataset synthetic --model savp \\
        --model_hparams_dict hparams/bair_action_free/ours_savp/model_hparams.json \\
        --output_dir RUN_DIR [--max_steps N] [--batch_size B] [--resume] [--checkpoint RUN_DIR] [--device cuda]
    python -m video_prediction_torch.train --dataset bair --input_dir DATA/train \\
        --val_input_dir DATA/val --model_hparams_dict ... --output_dir RUN_DIR

Port of ``scripts/train.py`` with the same flag shape, plus ``--device``:
resolves the hparams as it does (model-class defaults, then
``--model_hparams_dict``, then ``--model_hparams``; the dataset's sequence
structure fills what neither set), writes the run directory's option files,
builds the model and its train state from ``--seed``, restores the newest
kept step's train state (``checkpoints/<step>/train_state.pt``,
``train/checkpoint.py``) with ``--resume`` (the step, the model, both
Adams and the noise generator; the data stream starts afresh from
``--seed``, at the batch that fixed the shapes, as ``scripts/train.py``'s
does), or else, with ``--checkpoint RUN_DIR``, warm-starts from another
run's newest params file: every parameter whose name and shape match
is copied, the rest keep their initial values, and the step, the Adams and
the spectral ``u`` buffers start afresh (``scripts/train.py:191-194``,
``checkpoint.py#_merge_matching``); then runs the train step until ``max_steps`` on batches that a
``data.DeviceFeeder`` thread sends to the device ahead of the step (uint8,
through pinned memory, on a side stream). The TFRecord datasets read
``--input_dir`` for training and ``--val_input_dir`` (default: the same
directory) for the eval summaries. Every
``--progress_freq`` steps it prints ``step N: g_loss= d_loss= steps/s=
frames/s=`` (frames per step = batch x (T - context)); every
``--summary_freq`` steps the loss terms and the schedule scalars (``lr``,
``schedule_sampling_prob``, ``kl_weight``) at the step the losses were
taken; every ``--gif_freq`` steps (0: ``--image_summary_freq``) the GIF
``gen_images``, ground truth beside the prior rollout for the first 8
clips of the batch fetched next; every ``--eval_summary_freq`` and
``--accum_eval_summary_freq`` steps the eval metrics (``eval/*`` and
``accum_eval/*``: the prior rollout's PSNR, SSIM and MSE) averaged over 8
and 64 validation batches, drawn from one ``val`` iterator that walks on
from firing to firing; every ``--save_freq`` steps, and at the end, it
writes the step's checkpoint, ``checkpoints/<step>/`` (the train state and
the params file that ``generate`` and ``evaluate`` read), keeping the
newest three, as ``scripts/train.py``'s ``CheckpointManager`` does; the
final save writes nothing where a periodic one wrote that step. The
summaries are printed, returned by ``main`` and
written to a TensorBoard event file in ``output_dir``
(``utils/summary.py``, no TensorFlow) unless ``--no_tensorboard``; the JAX
CLI writes one only where TensorFlow imports.

``--steps_per_call K`` takes K optimizer steps a call, as the JAX CLI's
fused dispatch does: the feeder stacks K batches ``[K, B, ...]``, and on
CUDA the K steps run as one CUDA graph (``train/step.py``; the first call
runs them eagerly, the second captures them). The run may overshoot
``--max_steps`` by up to K-1 steps; each frequency fires when one of its
multiples falls in the K steps of a call, the printed losses are the last
step's, the schedule scalars are taken at the call's first step, and the
GIF and eval summaries at the end of the call, on the last batch of the
stack. ``--steps_per_call 1`` is the loop of one step a call.
``--profile_steps start,stop`` records the steps numbered ``start``
to ``stop`` (0-based: the step taken when ``start`` steps are done, through
the one taken when ``stop`` are; whole calls, so with K > 1 from the call
that holds ``start`` through the one that holds ``stop``) under ``torch.profiler`` (host and, on a
GPU, device activity), synchronizes the device before it stops, as
``scripts/train.py:265-267`` does, and writes the trace to
``output_dir/profile/trace_<start>-<stop>.json``, with the port's spans
(``utils/trace.py``) as a process of their own, ``program spans``, on the
trace's clock; the line that names the file gives the device ms of the
last step's phases (losses, backward, update) on a GPU. The losses are
those of a run without it.

Data parallel, one process per GPU (the counterpart of ``scripts/train.py``'s
multi-host parts, ``parallel/``)::

    torchrun --standalone --nproc_per_node N -m video_prediction_torch.train --batch_size 64 ...

joins the process group that ``torchrun``'s environment describes (NCCL on
CUDA, gloo with ``--device cpu``); ``--device cuda`` is then
``cuda:LOCAL_RANK``. ``--batch_size`` stays the global batch: each rank
reads its share (``per_host_batch``) from train and val streams seeded
``--seed`` plus its rank, the step mean-reduces the gradients and the
losses over the ranks, and the printed frames/s count the global batch.
Every rank builds the state from ``--seed`` (or resumes or warm-starts
it), then takes rank 0's parameters and buffers. Only rank 0 writes: the
option files, the event file and its GIFs (of rank 0's rows), the
printed summaries and progress, the profile and the checkpoints. Every
rank runs every collective at the same steps. The process group is
destroyed at exit, on an error too; after an error under a group no final
checkpoint is written, since the other ranks may be inside a collective.

``--spatial_shards k`` (the JAX CLI's flag) shards image height over k
ranks, ``parallel/mesh.py#make_spatial_mesh``: rank r has data coordinate
r // k and spatial coordinate r % k, and the world's ranks split into
W/k data x k spatial. The k ranks of a spatial group read the same
examples (streams seeded ``--seed`` plus the data coordinate, global batch
/ (W/k) a rank) and keep their own rows of the images (the feeder cuts
them on the host); the step's halos, statistics and gathers run over the
spatial group (``parallel/spatial.py``). The first batch must pass
``validate_spatial_mesh`` (at least 4 rows a shard at the bottleneck).
The parameters are whole on every rank, so the checkpoints are those of
an unsharded run; the GIF summaries gather the rows first. ``k`` must
divide the world: ``--spatial_shards 2`` in one process raises, as the JAX
CLI does on one device::

    torchrun --standalone --nproc_per_node 2 -m video_prediction_torch.train --spatial_shards 2 --device cpu ...
"""


from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from video_prediction_torch.utils import trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", default="", help="directory of train tfrecords (unused for synthetic)")
    p.add_argument("--val_input_dir", default="", help="defaults to --input_dir")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--dataset_hparams", default="", help="comma-separated k=v overrides")
    p.add_argument("--model", default="savp")
    p.add_argument("--model_hparams", default="", help="comma-separated k=v overrides")
    p.add_argument("--model_hparams_dict", default="", help="JSON file of model hparams")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--resume", action="store_true", help="resume from the newest kept train state in output_dir")
    p.add_argument("--checkpoint", default="", help="warm-start the params matching by name and shape from "
                   "this run dir's newest checkpoint (--resume takes precedence)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batch_size", type=int, default=0, help="0 -> hparams.batch_size")
    p.add_argument("--max_steps", type=int, default=0, help="0 -> hparams.max_steps")
    p.add_argument("--summary_freq", type=int, default=1000)
    p.add_argument("--image_summary_freq", type=int, default=5000)
    p.add_argument("--eval_summary_freq", type=int, default=25000)
    p.add_argument("--accum_eval_summary_freq", type=int, default=100000,
                   help="eval metrics accumulated over 64 validation batches")
    p.add_argument("--progress_freq", type=int, default=100)
    p.add_argument("--save_freq", type=int, default=5000)
    p.add_argument("--gif_freq", type=int, default=0, help="0 -> use image_summary_freq")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps fused into one call (on CUDA one CUDA graph of K steps over stacked "
                   "batches); amortizes the host's per-step launch overhead. Training may overshoot max_steps "
                   "by up to K-1 steps when it is not a multiple of K")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="shard image HEIGHT over this many ranks (the mesh's second axis): spatial partitioning with "
                   "halo exchanges. Divides per-device activation memory. The remaining ranks form the data axis")
    p.add_argument("--no_tensorboard", action="store_true", help="write no TensorBoard event file")
    p.add_argument("--device", default="cuda", help="torch device to run on, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--profile_steps", default="", help="'start,stop' steps for a torch.profiler trace")
    return p.parse_args(argv)


def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """``"start,stop"`` -> (start, stop); ``""`` -> (-1, -1), no profile."""
    if not spec:
        return -1, -1
    start, stop = (int(x) for x in spec.split(","))
    if not 0 <= start <= stop:
        raise ValueError(f"--profile_steps wants 0 <= start <= stop, got {spec!r}")
    return start, stop


def main(argv=None) -> Dict[str, object]:
    """Run the CLI. Returns a summary: the ``start_step`` and final ``step``,
    the last step's ``scalars`` (floats), the last ``summaries`` of each
    kind (``--summary_freq``'s scalars, and the ``eval/*`` and
    ``accum_eval/*`` means, floats by tag), the names of the parameters
    ``--checkpoint`` copied (``warm_started``), and whether every loss
    printed or returned was finite (``all_finite``)."""
    args = parse_args(argv)

    import torch.distributed as dist

    from video_prediction_torch.parallel.distributed import local_device, maybe_initialize

    created = maybe_initialize(device=args.device)
    try:
        return _main(args, local_device(args.device))
    finally:
        if created:
            dist.destroy_process_group()


def _main(args, device: torch.device) -> Dict[str, object]:
    import torch.distributed as dist

    from video_prediction_torch.configs.hparams import apply_overrides, load_hparams_json, parse_overrides
    from video_prediction_torch.data import DeviceFeeder, get_dataset_class
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class, input_dims
    from video_prediction_torch.models.base import images_to_float
    from video_prediction_torch.parallel.distributed import is_primary, per_host_batch, rank
    from video_prediction_torch.parallel.mesh import (
        broadcast_module_,
        image_rows,
        make_spatial_mesh,
        validate_spatial_mesh,
    )
    from video_prediction_torch.parallel.spatial import gather_rows
    from video_prediction_torch.train import schedules
    from video_prediction_torch.train.checkpoint import (
        has_train_state,
        load_train_state,
        save_train_state,
        warm_start,
        write_options,
    )
    from video_prediction_torch.train.state import create_train_state, param_count, split_params
    from video_prediction_torch.train.step import make_eval_step, make_train_step
    from video_prediction_torch.utils.gif import encode_gif, tile_image_grid
    from video_prediction_torch.utils.summary import EventWriter

    group = dist.group.WORLD if dist.is_initialized() else None
    spatial = make_spatial_mesh(args.spatial_shards)
    k_sp = args.spatial_shards
    primary = is_primary()
    prof_start, prof_stop = parse_profile_steps(args.profile_steps)

    # ---- hparams, resolved as scripts/train.py resolves them ----
    dataset_cls = get_dataset_class(args.dataset)
    dhp = dataset_cls.default_hparams
    if args.dataset_hparams:
        dhp = apply_overrides(dhp, parse_overrides(args.dataset_hparams))
    model_cls = get_model_class(args.model)
    hp = model_cls.default_hparams()
    explicit = set()
    for overrides in (load_hparams_json(args.model_hparams_dict) if args.model_hparams_dict else {},
                      parse_overrides(args.model_hparams) if args.model_hparams else {}):
        hp = apply_overrides(hp, overrides)
        explicit |= set(overrides)
    backfill = {k: getattr(dhp, k) for k in ("context_frames", "sequence_length") if k not in explicit}
    if backfill:
        hp = hp.replace(**backfill)
    dhp = dhp.replace(context_frames=hp.context_frames, sequence_length=hp.sequence_length)
    if args.batch_size:
        hp = hp.replace(batch_size=args.batch_size)
    if args.max_steps:
        hp = hp.replace(max_steps=args.max_steps)
    write_options(args.output_dir, args.model, args.dataset, hp, dhp, args.seed)

    # ---- data, model, train state ----
    spc = args.steps_per_call
    if spc < 1:
        raise ValueError(f"--steps_per_call must be at least 1, got {spc}")
    local_bs = per_host_batch(hp.batch_size, k_sp)
    # the data coordinate folded into the data seed only, as scripts/train.py folds the
    # process index: every spatial group reads other examples, while the weights and the
    # noise are seeded alike
    data_seed = args.seed + rank() // k_sp
    host_iter = dataset_cls(args.input_dir, mode="train", hparams=dhp, seed=data_seed).make_iterator(local_bs)
    batch = next(host_iter)
    validate_spatial_mesh(k_sp, *batch["images"].shape[-3:-1])
    rows = (spatial.coord, k_sp) if spatial is not None else None
    # the first batch fixes the parameter shapes, as in the JAX package's init
    model = model_cls(hp, **input_dims(hp, batch))
    ts = create_train_state(model, args.seed, device, steps_per_call=spc)
    g_params, d_params = split_params(model)
    log = print if primary else _quiet
    log(f"device: {device}; generator params: {param_count(g_params):,}; "
        f"discriminator params: {param_count(d_params):,}")
    if group is not None:
        log(f"data parallel: {dist.get_world_size()} ranks ({dist.get_backend()}), {local_bs} of the global batch of "
            f"{hp.batch_size} a rank")
    log(f"data axis: {dist.get_world_size() // k_sp if group is not None else 1}, spatial axis: {k_sp}")
    warm_started = []
    if args.resume and has_train_state(args.output_dir):
        # the whole train state; the data stream is not replayed up to the
        # step: training goes on from the batch above, as in the JAX CLI
        load_train_state(args.output_dir, ts)
        log(f"resumed from step {ts.step}")
    elif args.checkpoint:
        warm_started = warm_start(args.checkpoint, ts.model)
        log(f"warm-started {len(warm_started)} of {len(list(ts.model.parameters()))} params from {args.checkpoint}")
    if group is not None:
        broadcast_module_(ts.model, 0, group)
    train_step = make_train_step(model, steps_per_call=spc, group=group, spatial=spatial)
    eval_step = make_eval_step(model, group=group, spatial=spatial)
    # one persistent val iterator: successive eval firings walk on through the
    # validation set, as in the JAX CLI
    val_dir = args.val_input_dir or args.input_dir
    val_iter = dataset_cls(val_dir, mode="val", hparams=dhp, seed=data_seed).make_iterator(local_bs)

    # ---- loop ----
    start_step = step = ts.step
    frames_per_step = hp.batch_size * (hp.sequence_length - hp.context_frames)
    gif_freq = args.gif_freq or args.image_summary_freq
    t_last, last_timed_step = time.perf_counter(), start_step
    scalars: Dict[str, torch.Tensor] = {}
    summaries: Dict[str, float] = {}
    all_finite = True
    writer = None if args.no_tensorboard or not primary else EventWriter(args.output_dir)

    def write(at: int, kind: str, vals: Dict[str, float]) -> None:
        summaries.update(vals)
        log(f"{kind} step {at}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()), flush=True)
        if writer is not None:
            writer.scalars(at, vals)

    def crossed(freq: int) -> bool:
        """A multiple of ``freq`` fell in the last call's steps, ``(prev, step]``."""
        return bool(freq) and prev // freq != step // freq

    # the train stream, from the batch that fixed the shapes, on the device,
    # stacked [K, B, ...] for K steps a call
    train_iter = DeviceFeeder(_prepend(batch, host_iter), device, stack=spc, rows=rows)
    profiler: Optional[torch.profiler.profile] = None
    clock: List[Tuple[int, int]] = []  # the profile's clock markers (utils/trace.py#mark_clock)
    finished = False
    try:
        batch = next(train_iter)
        while step < hp.max_steps:
            if primary and profiler is None and step <= prof_start < step + spc:
                profiler, clock = _start_profiler(device)
            scalars = train_step(ts, batch)
            batch = next(train_iter)  # taken while the steps run on the device
            prev, step = step, ts.step
            if profiler is not None and prev <= prof_stop < step:
                _stop_profiler(profiler, clock, device, args.output_dir, prof_start, prof_stop)
                profiler = None
            if crossed(args.summary_freq):
                # the schedules at the call's first step, as the JAX CLI takes them
                vals = {k: float(v) for k, v in scalars.items()}
                vals["lr"] = schedules.learning_rate(prev, hp)
                vals["schedule_sampling_prob"] = schedules.ground_truth_prob(prev, hp)
                if hp.kl_weight:
                    vals["kl_weight"] = hp.kl_weight * schedules.kl_weight(prev, hp)
                write(step, "summary", vals)
            if crossed(gif_freq) and not args.no_tensorboard:  # on every rank: eval_step reduces the metrics
                # the batch fetched next (its last, stacked), as the JAX CLI takes it
                last = batch if spc == 1 else {k: v[-1] for k, v in batch.items()}
                rng = torch.Generator(device=device).manual_seed(args.seed + step)
                gen, _ = eval_step(last, generator=rng)
                gt = images_to_float(last["images"])
                side = torch.cat([gt[:, 1:], gen], dim=3)  # [B, T-1, H, 2W, C]: ground truth | prediction
                if spatial is not None:  # every rank of the group joins the gather
                    side = gather_rows(side, spatial, dim=2)
                if writer is not None:  # rank 0's rows, as scripts/train.py's _local_np gives them
                    grid = tile_image_grid(side[:8].cpu().numpy())
                    writer.image(step, "gen_images", encode_gif(grid, fps=4), *grid.shape[1:])
            for freq, n_eval, prefix in ((args.eval_summary_freq, 8, "eval"),
                                         (args.accum_eval_summary_freq, 64, "accum_eval")):
                if crossed(freq):
                    rng = torch.Generator(device=device).manual_seed(args.seed + step)
                    accum: Dict[str, torch.Tensor] = {}
                    for _ in range(n_eval):
                        val = next(val_iter)
                        if rows is not None:
                            val = image_rows(val, *rows)
                        _, metrics = eval_step(batch_to_device(val, device), generator=rng)
                        for k, v in metrics.items():
                            if v.ndim == 0:
                                accum[k] = accum[k] + v if k in accum else v
                    write(step, prefix, {f"{prefix}/{k}": float(v) / n_eval for k, v in accum.items()})
            if crossed(args.progress_freq):
                g_loss, d_loss = float(scalars["g_loss"]), float(scalars["d_loss"])  # waits for the steps
                all_finite &= math.isfinite(g_loss) and math.isfinite(d_loss)
                sps = (step - last_timed_step) / (time.perf_counter() - t_last)
                log(f"step {step}: g_loss={g_loss:.4f} d_loss={d_loss:.4f} "
                    f"steps/s={sps:.2f} frames/s={sps * frames_per_step:.0f}", flush=True)
                t_last, last_timed_step = time.perf_counter(), step
            if crossed(args.save_freq):
                save_train_state(args.output_dir, ts)
        finished = True
    finally:
        if profiler is not None:  # the run ended inside the window
            _stop_profiler(profiler, clock, device, args.output_dir, prof_start, ts.step - 1)
        train_iter.close()
        if writer is not None:
            writer.close()
        if finished or group is None:  # after an error the other ranks may be inside a collective
            save_train_state(args.output_dir, ts)
    final = {k: float(v) for k, v in scalars.items()}
    all_finite &= all(math.isfinite(v) for v in final.values())
    log(f"done at step {ts.step}; checkpoints in {args.output_dir}/checkpoints")
    return {"start_step": start_step, "step": ts.step, "scalars": final, "summaries": summaries,
            "warm_started": warm_started, "all_finite": all_finite}


def _start_profiler(device: torch.device) -> Tuple[torch.profiler.profile, List[Tuple[int, int]]]:
    """A started profiler, and its clock markers."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler, trace.mark_clock()


def _stop_profiler(profiler: torch.profiler.profile, clock: List[Tuple[int, int]], device: torch.device,
                   output_dir: str, start: int, stop: int) -> None:
    """Stop ``profiler`` once the device has run what was queued (a CUDA
    call returns at enqueue: stopping earlier cuts the window's last
    kernels) and write its trace under ``output_dir/profile/``, the spans
    recorded since ``clock`` in it; print its path and the last step's
    phases."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    trace_dir = os.path.join(output_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{start}-{stop}.json")
    profiler.export_chrome_trace(path)
    trace.write_chrome_track(path, clock)
    phases = trace.phase_ms()
    last = "" if not phases else " (last step, device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases[-1].items()) + ")"
    print(f"profile of steps {start}-{stop}: {path}{last}", flush=True)


def _quiet(*args, **kwargs) -> None:
    """``print`` on ranks other than 0."""


def _prepend(first, rest):
    """``first``, then the items of ``rest``; closing it closes ``rest``."""
    yield first
    yield from rest


if __name__ == "__main__":
    main()
