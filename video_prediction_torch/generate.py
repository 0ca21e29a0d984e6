"""Generation CLI: dump predicted GIFs/PNGs without metrics.

    python -m video_prediction_torch.generate --checkpoint RUN_DIR --results_dir OUT [--device cuda]

Port of ``scripts/generate.py`` with the same flags, plus ``--device`` and
``--checkpoint_step``. Restores a run directory (``options.json``,
``model_hparams.json``, ``dataset_hparams.json`` and the params file of the
newest kept step, or of ``--checkpoint_step``, ``train/checkpoint.py``),
prints ``restored step N from RUN_DIR``, then rolls
out ``model.forward(..., train=False)`` — the no-grad prior rollout — for
``--num_samples`` sequences x ``--num_stochastic_samples`` draws of z and
writes one GIF per sequence and draw under
``RESULTS_DIR/<dataset>/<model>/generated``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", default="")
    p.add_argument("--checkpoint", required=True, help="run directory")
    p.add_argument("--checkpoint_step", type=int, default=None,
                   help="the kept checkpoint step to restore (default: the newest)")
    p.add_argument("--dataset", default="")
    p.add_argument("--dataset_hparams", default="")
    p.add_argument("--model", default="")
    p.add_argument("--model_hparams", default="")
    p.add_argument("--mode", default="test")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--num_stochastic_samples", type=int, default=1)
    p.add_argument("--sequence_length", type=int, default=0,
                   help="generate at this sequence length (0 -> trained length)")
    p.add_argument("--long", action="store_true", help="generate at the dataset's long_sequence_length")
    p.add_argument("--gif_length", type=int, default=0)
    p.add_argument("--fps", type=int, default=4)
    p.add_argument("--save_png", action="store_true", help="also dump per-frame PNGs")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda", help="torch device to run on, e.g. cuda, cuda:1 or cpu")
    return p.parse_args(argv)


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors. Images stay uint8 across the copy and
    are normalized on the device (``models.base.normalize_batch``). To a
    CUDA device the copy goes from pinned memory and does not wait for the
    work already queued."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)
    return out


def main(argv=None) -> Dict[str, object]:
    """Run the CLI. Returns a summary: ``out_dir``, the number of
    ``rollouts`` (generator calls), of ``gifs`` written, whether every
    generated value was finite (``all_finite``) and the checkpoint ``step``
    restored."""
    args = parse_args(argv)

    from video_prediction_torch.configs.hparams import (
        DatasetHparams,
        ModelHparams,
        adopt_inference_defaults,
        apply_overrides,
        parse_overrides,
    )
    from video_prediction_torch.data import get_dataset_class
    from video_prediction_torch.models import get_model_class, input_dims
    from video_prediction_torch.train.checkpoint import load_params
    from video_prediction_torch.utils.device import device_or_raise
    from video_prediction_torch.utils.gif import save_gif

    device = device_or_raise(args.device)
    run_dir = args.checkpoint
    with open(os.path.join(run_dir, "options.json")) as f:
        options = json.load(f)
    with open(os.path.join(run_dir, "model_hparams.json")) as f:
        hp = apply_overrides(ModelHparams(), json.load(f))
    with open(os.path.join(run_dir, "dataset_hparams.json")) as f:
        dhp = apply_overrides(DatasetHparams(), json.load(f))
    model_name = args.model or options["model"]
    dataset_name = args.dataset or options["dataset"]
    user_overrides = parse_overrides(args.model_hparams) if args.model_hparams else {}
    if user_overrides:
        hp = apply_overrides(hp, user_overrides)
    if args.dataset_hparams:
        dhp = apply_overrides(dhp, parse_overrides(args.dataset_hparams))
    hp = adopt_inference_defaults(hp, user_overrides)

    gen_len = args.sequence_length or (dhp.long_sequence_length if args.long else 0)
    if gen_len:
        # the data only: the model keeps the trained length (see evaluate.py)
        dhp = dhp.replace(sequence_length=gen_len)

    dataset = get_dataset_class(dataset_name)(args.input_dir, mode=args.mode, hparams=dhp, seed=args.seed)
    it = dataset.make_iterator(args.batch_size)
    batch0 = next(it)
    # the first batch fixes the parameter shapes, as in the JAX package's init
    model = get_model_class(model_name)(hp, **input_dims(hp, batch0)).to(device)
    step = load_params(run_dir, model, device, args.checkpoint_step)
    print(f"restored step {step} from {run_dir}")
    model.eval()
    rng = torch.Generator(device=device).manual_seed(args.seed)

    out_dir = os.path.join(args.results_dir, dataset_name, model_name, "generated")
    os.makedirs(out_dir, exist_ok=True)

    n_done = rollouts = gifs = 0
    all_finite = True
    batch = batch0
    with torch.inference_mode():
        while n_done < args.num_samples:
            tbatch = batch_to_device(batch, device)
            for s in range(args.num_stochastic_samples):
                gen = model(tbatch, train=False, generator=rng)["gen_images"].float().cpu().numpy()
                rollouts += 1
                all_finite &= bool(np.isfinite(gen).all())
                gif_len = args.gif_length or gen.shape[1]
                for b in range(gen.shape[0]):
                    if n_done + b >= args.num_samples:
                        break
                    stem = f"gen_{n_done + b:05d}_sample{s:02d}"
                    save_gif(os.path.join(out_dir, stem + ".gif"), gen[b, :gif_len], args.fps)
                    gifs += 1
                    if args.save_png:
                        from PIL import Image

                        for t in range(min(gif_len, gen.shape[1])):
                            img = (np.clip(gen[b, t], 0, 1) * 255).astype(np.uint8)
                            Image.fromarray(img).save(os.path.join(out_dir, f"{stem}_t{t:03d}.png"))
            n_done += batch["images"].shape[0]
            batch = next(it)
    print(f"wrote {gifs} generations from {rollouts} rollouts to {out_dir}")
    if not all_finite:
        print("warning: some generated values were not finite")
    return {"out_dir": out_dir, "rollouts": rollouts, "gifs": gifs, "all_finite": all_finite, "step": step}


if __name__ == "__main__":
    main()
