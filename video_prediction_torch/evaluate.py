"""Evaluation CLI: per-frame PSNR/SSIM (and VGG/LPIPS) curves, best-of-N.

    python -m video_prediction_torch.evaluate --checkpoint RUN_DIR --results_dir OUT [--device cuda]
    python -m video_prediction_torch.evaluate --model repeat --dataset synthetic --results_dir OUT

Port of ``scripts/evaluate.py`` with the same flags, plus ``--device`` and
``--checkpoint_step``. Restores a run directory (``options.json``,
``model_hparams.json``, ``dataset_hparams.json`` and the params file of the
newest kept step, or of ``--checkpoint_step``, ``train/checkpoint.py``) and
prints ``restored step N from RUN_DIR``, or,
without ``--checkpoint``, builds a parameter-free baseline (``ground_truth``,
``repeat``) from ``--model`` and ``--dataset``. For each test batch it rolls
out ``--num_stochastic_samples`` prior samples in chunks of
``--samples_per_rollout``, the samples riding the batch dimension (each
example repeated k times in a row), and reduces each metric per example and
frame by the max (best of N) and the mean over the samples. It writes what
the JAX CLI writes, under ``RESULTS_DIR/<dataset>/<model>/``:
``<metric>.txt`` (one sample) or ``<metric>_{max,avg}.txt``, each
``[N, T - context]``; and, unless ``--only_metrics``, ``index.html`` with
``images/{gt,gen}_XXXXX.gif`` (the best-PSNR sample). LPIPS is lower-better:
its max is taken on the negated distance and the sign restored on write.

Unlike the JAX CLI, which pulls every rollout to the host, the metrics of a
whole chunk are computed in one call on the device, where the running max and
sum stay; the host receives them, and the best rollout, once per batch. The
VGG and LPIPS metrics featurise the batch's target frames once, not once a
sample (``BestOfN``); the values are those of a call per sample. The model
and every metric run on ``--device``; a CUDA device that is not there
raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from video_prediction_torch.utils import trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", default="")
    p.add_argument("--checkpoint", default="",
                   help="run directory to restore; may be omitted for the baselines (--model ground_truth|repeat)")
    p.add_argument("--checkpoint_step", type=int, default=None,
                   help="the kept checkpoint step to restore (default: the newest)")
    p.add_argument("--dataset", default="")
    p.add_argument("--dataset_hparams", default="")
    p.add_argument("--model", default="")
    p.add_argument("--model_hparams", default="")
    p.add_argument("--mode", default="test")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=32,
                   help="test examples to evaluate; 0 -> the whole test set (num_examples_per_epoch())")
    p.add_argument("--num_stochastic_samples", type=int, default=1)
    p.add_argument("--samples_per_rollout", type=int, default=8,
                   help="stochastic samples batched into one rollout (on the batch dimension)")
    p.add_argument("--sequence_length", type=int, default=0,
                   help="evaluate at this sequence length (0 -> trained length)")
    p.add_argument("--long", action="store_true", help="evaluate at the dataset's long_sequence_length")
    p.add_argument("--gif_length", type=int, default=0, help="0 -> full sequence")
    p.add_argument("--fps", type=int, default=4)
    p.add_argument("--only_metrics", action="store_true")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--vgg_weights_path", default="",
                   help="VGG16 .npz (see models/vgg.py); enables the per-frame VGG cosine similarity")
    p.add_argument("--lpips_weights_path", default="",
                   help="LPIPS linear weights .npz (lin{0..4}/weight); with --vgg_weights_path, enables LPIPS")
    p.add_argument("--device", default="cuda", help="torch device to run on, e.g. cuda, cuda:1 or cpu")
    return p.parse_args(argv)


def metric_fns(device: torch.device, vgg_weights_path: str = "", lpips_weights_path: str = ""
               ) -> Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """The per-frame metrics of a run, by name, each ``(target, pred) ->
    [...]`` on ``device``, higher is better (``lpips`` is the negated
    distance)."""
    from video_prediction_torch import metrics as M

    fns = {"psnr": M.peak_signal_to_noise_ratio, "ssim": M.structural_similarity}
    if vgg_weights_path:
        from video_prediction_torch.models.vgg import VGGMetric

        fns["vgg_csim"] = VGGMetric(weights_path=vgg_weights_path, device=device)
    if lpips_weights_path:
        from video_prediction_torch.models.lpips import LPIPSMetric

        lpips = LPIPSMetric(vgg_weights_path=vgg_weights_path, lin_weights_path=lpips_weights_path, device=device)
        fns["lpips"] = Negated(lpips)
    return fns


class Negated:
    """``-metric``, with its ``prepare``/``score`` split (``BestOfN``)."""

    def __init__(self, metric):
        self.metric = metric

    def __call__(self, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return -self.metric(target, pred)

    def prepare(self, target: torch.Tensor):
        return self.metric.prepare(target)

    def score(self, prepared, pred: torch.Tensor) -> torch.Tensor:
        return -self.metric.score(prepared, pred)


def sample_chunks(model, batch: Dict[str, torch.Tensor], n_samples: int, samples_per_rollout: int,
                  generator: Optional[torch.Generator]) -> Iterator[torch.Tensor]:
    """Stochastic rollouts of ``batch`` in chunks of ``samples_per_rollout``:
    the batch is tiled once (each example ``k`` times in a row, as
    ``np.repeat`` on axis 0), and each chunk is one rollout of the tiled
    batch, reshaped to ``[B, take, T-1, H, W, C]``."""
    k = max(1, min(samples_per_rollout, n_samples))
    b = batch["images"].shape[0]
    tiled = {key: v.repeat_interleave(k, dim=0) for key, v in batch.items()}
    done = 0
    while done < n_samples:
        gen = model(tiled, train=False, generator=generator)["gen_images"]
        yield gen.reshape(b, k, *gen.shape[1:])[:, : min(k, n_samples - done)]
        done += k


class BestOfN:
    """Running reductions over stochastic samples, on the device: per metric
    the max and the sum per ``[B, T - context]``, and the rollout with the
    best mean PSNR per example (the first one to reach it, as the JAX CLI's
    strict ``>`` keeps it).

    A metric is a function ``(target, pred) -> [...]``, given the target
    expanded to every sample, or an object with a ``prepare``/``score``
    split (``models/vgg.py#VGGMetric``, ``models/lpips.py#LPIPSMetric``):
    then the first update computes ``prepare(target)`` once, for every
    chunk of this batch, and each update calls ``score(prepared, pred)``,
    so that the target's frames are featurised once a batch, not once a
    sample. Spans (``utils/trace.py``): ``bestofn.update``, with a
    ``metric.<name>`` child a metric, and inside the first update's a
    ``metric.<name>.target`` around ``prepare``; each timed on the device
    too."""

    def __init__(self, fns: Dict[str, Callable], target: torch.Tensor, context_frames: int, keep_best: bool):
        self.fns, self.target, self.ctx, self.keep_best = fns, target, context_frames, keep_best
        self.span_names, self.device = {m: "metric." + m for m in fns}, target.device
        self.split = {m for m, fn in fns.items() if hasattr(fn, "prepare")}
        self.prepared: Dict[str, object] = {}
        self.best: Dict[str, torch.Tensor] = {}
        self.sum: Dict[str, torch.Tensor] = {}
        self.n = 0
        self.best_gen: Optional[torch.Tensor] = None
        self.best_score: Optional[torch.Tensor] = None

    def update(self, chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fold in ``chunk [B, take, T-1, H, W, C]``; returns its metrics, each ``[B, take, Tp]``."""
        with trace.span("bestofn.update"):
            pred = chunk[:, :, self.ctx - 1:]
            target = self.target[:, None].expand_as(pred)
            vals = {}
            for m, fn in self.fns.items():
                with trace.span(self.span_names[m], self.device):
                    if m not in self.split:
                        vals[m] = fn(target, pred)
                        continue
                    if m not in self.prepared:
                        with trace.span(self.span_names[m] + ".target", self.device):
                            self.prepared[m] = fn.prepare(self.target)
                    vals[m] = fn.score(self.prepared[m], pred)
            for m, v in vals.items():
                top, total = v.max(dim=1).values, v.sum(dim=1)
                self.best[m] = top if m not in self.best else torch.maximum(self.best[m], top)
                self.sum[m] = total if m not in self.sum else self.sum[m] + total
            self.n += chunk.shape[1]
            if self.keep_best:
                score = vals["psnr"].mean(dim=-1)  # [B, take]
                top, idx = score.max(dim=1)  # the first maximum within the chunk
                gen = chunk[torch.arange(chunk.shape[0], device=chunk.device), idx]
                if self.best_gen is None:
                    self.best_gen, self.best_score = gen, top
                else:
                    better = top > self.best_score
                    self.best_gen = torch.where(better[:, None, None, None, None], gen, self.best_gen)
                    self.best_score = torch.maximum(self.best_score, top)
            return vals

    def mean(self) -> Dict[str, torch.Tensor]:
        return {m: s / self.n for m, s in self.sum.items()}


def main(argv=None) -> Dict[str, object]:
    """Run the CLI. Returns a summary: ``results_dir``, the number of
    ``rollouts`` (generator calls), ``metrics`` (the mean of each written
    array, by file stem), and whether every written value was finite or
    ``inf`` (``ground_truth``'s PSNR) rather than NaN (``no_nan``), and the
    checkpoint ``step`` restored (None for a baseline)."""
    args = parse_args(argv)

    from video_prediction_torch.configs.hparams import (
        DatasetHparams,
        ModelHparams,
        adopt_inference_defaults,
        apply_overrides,
        parse_overrides,
    )
    from video_prediction_torch.data import get_dataset_class
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class, input_dims
    from video_prediction_torch.models.base import images_to_float
    from video_prediction_torch.train.checkpoint import load_params
    from video_prediction_torch.utils.device import device_or_raise
    from video_prediction_torch.utils.gif import save_gif
    from video_prediction_torch.utils.html import HTML

    device = device_or_raise(args.device)

    # ---- rebuild what was trained (the JAX CLI reads the same saved options) ----
    run_dir = args.checkpoint
    if run_dir:
        with open(os.path.join(run_dir, "options.json")) as f:
            options = json.load(f)
        with open(os.path.join(run_dir, "model_hparams.json")) as f:
            hp = apply_overrides(ModelHparams(), json.load(f))
        with open(os.path.join(run_dir, "dataset_hparams.json")) as f:
            dhp = apply_overrides(DatasetHparams(), json.load(f))
    else:
        if not (args.model and args.dataset):
            raise SystemExit("--checkpoint omitted: both --model and --dataset are required")
        options = {"model": args.model, "dataset": args.dataset}
        hp = get_model_class(args.model).default_hparams()
        dhp = get_dataset_class(args.dataset).default_hparams
        hp = hp.replace(context_frames=dhp.context_frames, sequence_length=dhp.sequence_length)
    model_name = args.model or options["model"]
    dataset_name = args.dataset or options["dataset"]
    user_overrides = parse_overrides(args.model_hparams) if args.model_hparams else {}
    if user_overrides:
        hp = apply_overrides(hp, user_overrides)
    if args.dataset_hparams:
        dhp = apply_overrides(dhp, parse_overrides(args.dataset_hparams))
    hp = adopt_inference_defaults(hp, user_overrides)

    eval_len = args.sequence_length or (dhp.long_sequence_length if args.long else 0)
    if eval_len:
        if eval_len > dhp.sequence_length:
            print(f"long rollout: sequence_length {dhp.sequence_length} -> {eval_len}")
        # the data only: the generator takes its length from the input, and
        # the model keeps the trained length, which sets its discriminators'
        # widths, so that the trained params file fits it at any eval length
        dhp = dhp.replace(sequence_length=eval_len)

    dataset = get_dataset_class(dataset_name)(args.input_dir, mode=args.mode, hparams=dhp, seed=args.seed)
    # the first batch fixes the parameter shapes; drawn from an iterator of its
    # own, as the JAX CLI draws it, so that both walk the same test batches
    batch0 = next(dataset.make_iterator(args.batch_size))
    model = get_model_class(model_name)(hp, **input_dims(hp, batch0))
    step = None  # the baselines restore nothing
    if model.trainable:
        if not run_dir:
            raise SystemExit(f"model {model_name!r} is trainable; --checkpoint is required")
        step = load_params(run_dir, model, device, args.checkpoint_step)
        print(f"restored step {step} from {run_dir}")
    model.to(device).eval()
    rng = torch.Generator(device=device).manual_seed(args.seed)

    results_dir = os.path.join(args.results_dir, dataset_name, model_name)
    os.makedirs(results_dir, exist_ok=True)
    html = None if args.only_metrics else HTML(results_dir, title=f"{dataset_name}/{model_name}")
    fns = metric_fns(device, args.vgg_weights_path, args.lpips_weights_path)

    num_samples = args.num_samples
    if num_samples == 0:
        num_samples = dataset.num_examples_per_epoch()
        print(f"evaluating the whole test set: {num_samples} examples")
    all_best: Dict[str, list] = {m: [] for m in fns}
    all_mean: Dict[str, list] = {m: [] for m in fns}
    it = dataset.make_iterator(args.batch_size)
    n_done = rollouts = 0
    with torch.inference_mode():
        while n_done < num_samples:
            batch = next(it)
            images = batch["images"]
            if images.dtype == np.uint8:  # datasets ship uint8; metrics and GIFs want [0, 1]
                images = images.astype(np.float32) / 255.0
            tbatch = batch_to_device(batch, device)
            # normalized on the device, as the model normalizes its input:
            # ground_truth's prediction equals it bit for bit
            target = images_to_float(tbatch["images"])[:, hp.context_frames:]
            red = BestOfN(fns, target, hp.context_frames, keep_best=html is not None)
            for chunk in sample_chunks(model, tbatch, args.num_stochastic_samples, args.samples_per_rollout, rng):
                red.update(chunk)
                rollouts += 1
            # one copy to the host per batch
            for m, v in red.best.items():
                all_best[m].append(v.cpu().numpy())
            for m, v in red.mean().items():
                all_mean[m].append(v.cpu().numpy())

            if html is not None:
                best_gen = red.best_gen.float().cpu().numpy()
                gif_len = args.gif_length or images.shape[1]
                for b in range(images.shape[0]):
                    if n_done + b >= num_samples:
                        break
                    gt_name = f"gt_{n_done + b:05d}.gif"
                    gen_name = f"gen_{n_done + b:05d}.gif"
                    save_gif(os.path.join(html.get_image_dir(), gt_name), images[b, :gif_len], args.fps)
                    gen_full = np.concatenate([images[b, :1], best_gen[b]], axis=0)
                    save_gif(os.path.join(html.get_image_dir(), gen_name), gen_full[:gif_len], args.fps)
                    html.add_header(f"example {n_done + b}")
                    html.add_images([f"images/{gt_name}", f"images/{gen_name}"], ["ground truth", model_name],
                                    height=128)
            n_done += images.shape[0]

    # ---- metric arrays, one row per example (the reference's format) ----
    # with one stochastic sample max and mean coincide: <name>.txt; else <name>_{max,avg}.txt
    single = args.num_stochastic_samples == 1
    reductions = [("max", all_best)] if single else [("max", all_best), ("avg", all_mean)]
    summary_metrics: Dict[str, float] = {}
    no_nan = True
    for red_name, metr in reductions:
        for name, chunks in metr.items():
            arr = np.concatenate(chunks, axis=0)[:num_samples]  # [N, Tp]
            if name == "lpips":
                arr = -arr  # stored negated for the best-of-N max
            stem = name if single else f"{name}_{red_name}"
            np.savetxt(os.path.join(results_dir, f"{stem}.txt"), arr)
            no_nan &= not bool(np.isnan(arr).any())
            summary_metrics[stem] = float(arr.mean())
            print(f"{name} ({red_name}): mean={arr.mean():.4f}  "
                  f"per-frame={np.array2string(arr.mean(axis=0), precision=3)}")

    if html is not None:
        print(f"gallery: {html.save()}")
    return {"results_dir": results_dir, "rollouts": rollouts, "metrics": summary_metrics, "no_nan": no_nan,
            "step": step}


if __name__ == "__main__":
    main()
