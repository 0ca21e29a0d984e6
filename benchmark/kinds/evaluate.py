"""Evaluation cells: ``evaluate`` as the port's CLI runs it, best of
``num_samples`` prior samples. A unit is one batch of ``batch_size`` test
clips of the configuration's ``long_sequence_length`` frames (``--long``)
from a seeded pool: the clips go to the device (``batch_to_device``), the
port's ``evaluate.sample_chunks`` rolls out ``samples_per_rollout`` samples
of every clip at a time, ``evaluate.BestOfN.update`` scores each chunk with
the cell's metrics (PSNR, SSIM and the VGG16 cosine, with VGG16 weights made
from the seed) and keeps the running best and sum, and the batch's
reductions and best rollout are fetched to the host.

The check takes one completed batch, drawn from the seed, and computes its
every chunk again with the plain reference (rollout and metrics) from the
same weights, clips and prior draws (the generator's state at the batch's
start): each chunk's metrics and the batch's best and mean. Where the
configuration has actions and states, each clip carries its own
(``common.make_inputs``). The rollout's FLOPs and reference come from
``benchmark/models/<model>.py`` (``ctx.parts``), the metrics' from
``benchmark/counts.py`` and ``benchmark/reference/metrics.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import common, counts, program
from benchmark.reference import metrics as refm


class Cell:
    def __init__(self, ctx):
        self.ctx, cfg, traffic = ctx, ctx.cfg, ctx.traffic
        self.parts = ctx.parts
        self.b, self.n = traffic["batch_size"], traffic["num_samples"]
        self.spr = traffic["samples_per_rollout"]
        self.hp = program.hparams(cfg, ctx.overrides)
        self.t = ctx.overrides.get("long_sequence_length", cfg["long_sequence_length"])
        self.ctx_frames = self.hp.context_frames
        self.shape = tuple(ctx.overrides.get("image_shape", cfg["image_shape"]))
        self.metrics = traffic["metrics"]
        self.spans = common.Spans()
        self.unit_ms: List[float] = []
        self.batches: List[Dict] = []

    def setup(self) -> None:
        from video_prediction_torch import metrics as M
        from video_prediction_torch.evaluate import BestOfN, sample_chunks

        ctx, dev = self.ctx, self.ctx.device
        self.BestOfN, self.sample_chunks = BestOfN, sample_chunks
        self.model, self.weights = program.build_model(ctx.cfg, self.hp, self.shape, ctx.seed, dev)
        self.model.eval()
        fns = {"psnr": M.peak_signal_to_noise_ratio, "ssim": M.structural_similarity}
        self.vgg_weights = None
        if "vgg_csim" in self.metrics:
            fns["vgg_csim"], self.vgg_weights = program.vgg_metric(ctx.seed, dev)
        self.fns = {m: fns[m] for m in self.metrics}
        pool = ctx.traffic["pool_batches"] * self.b
        self.pool = common.make_inputs(pool, self.t, self.shape, ctx.cfg, ctx.seed, dev)
        self.host = program.host_batches(self.pool, self.b)
        self.rng = common.generator(ctx.seed, 2, dev)
        self.next_batch = 0
        self.batch(record=False)  # every shape of a batch: the full chunks, the last one's cut, the metrics

    def batch(self, record: bool = True) -> None:
        sp, ctx = self.spans, self.ctx
        index = self.next_batch % self.ctx.traffic["pool_batches"]
        self.next_batch += 1
        host = next(self.host)
        t0 = time.perf_counter()
        tbatch = sp("to_device", program.batch_to_device, host, ctx.device)
        target = tbatch["images"].float().div(255.0)[:, self.ctx_frames:]
        red = self.BestOfN(self.fns, target, self.ctx_frames, keep_best=True)
        state = self.rng.get_state()
        vals, metric_marks = [], []
        with torch.inference_mode():
            chunks = self.sample_chunks(self.model, tbatch, self.n, self.spr, self.rng)
            while True:
                chunk = sp("rollout_host", next, chunks, None)
                if chunk is None:
                    break
                start = ctx.event()
                vals.append(sp("metrics_host", red.update, chunk))
                metric_marks.append((start, ctx.event()))
            best, mean, _ = sp("fetch", lambda: ({m: v.cpu() for m, v in red.best.items()},
                                                  {m: v.cpu() for m, v in red.mean().items()},
                                                  red.best_gen.float().cpu()))
        t1 = time.perf_counter()
        if ctx.cuda:
            self.spans.durations["metrics_device"] += [a.elapsed_time(b) / 1e3 for a, b in metric_marks]
        if record:
            self.unit_ms.append((t1 - t0) * 1e3)
            self.batches.append({"index": index, "state": state, "vals": vals, "best": best, "mean": mean})

    def run(self, seconds: float = None, count: int = None) -> Dict:
        return common.closed_loop(self.batch, seconds, count)

    def frames_per_unit(self) -> int:
        return self.b * self.n * (self.t - self.ctx_frames)

    def end_to_end(self, window: Dict) -> Dict[str, float]:
        return {"eval_frames_per_s": window["units"] * self.frames_per_unit() / window["seconds"]}

    def flops_per_unit(self) -> float:
        rollouts = self.parts.rollout_flops(self.hp.to_dict(), self.b * self.n, self.t, *self.shape)
        return rollouts + counts.metrics_flops(self.b, self.n, self.t - self.ctx_frames, *self.shape, self.metrics)

    def kernel_work(self) -> Dict:
        hp, (h, w, c) = self.hp.to_dict(), self.shape
        chunks = -(-self.n // self.spr)
        steps = chunks * (self.t - 1)
        nbytes = self.parts.kernel_bytes(hp, self.b * self.spr, h, w, c, False)
        events = self.parts.kernel_events(hp, h, w, False)
        return {"bytes": {g: v * steps for g, v in nbytes.items()}, "events": {g: v * steps for g, v in events.items()}}

    def free(self) -> None:
        pick = np.random.default_rng(common.sub_seed(self.ctx.seed, 8)).integers(len(self.batches))
        chosen = self.batches[pick]
        self.chosen = {k: chosen[k] for k in ("index", "state")}
        self.outputs = {"chunks": [{m: v.float().cpu() for m, v in c.items()} for c in chosen["vals"]],
                        "best": chosen["best"], "mean": chosen["mean"]}
        del self.model, self.batches, self.fns
        self.ctx.empty_cache()

    def reference(self) -> Dict:
        """The chosen batch again: its chunks' metrics, its best and mean."""
        hp, dev = self.hp.to_dict(), self.ctx.device
        i = self.chosen["index"]
        rows = common.rows_of(self.pool, slice(i * self.b, (i + 1) * self.b))
        clips = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        clips["images"] = clips["images"].float().div(255.0)
        target = clips["images"][:, self.ctx_frames:]
        tiled = {k: v.repeat_interleave(self.spr, dim=0) for k, v in clips.items()}
        gen = torch.Generator(device=dev)
        gen.set_state(self.chosen["state"])
        chunks, done = [], 0
        while done < self.n:
            take = min(self.spr, self.n - done)
            zs = torch.randn((tiled["images"].shape[0], self.t - 1, hp["nz"]), generator=gen, device=dev)
            with common.exact_fp32(), torch.no_grad():
                frames = self.parts.eval_rollout(self.weights, hp, tiled, zs).float()
                pred = frames.reshape(self.b, self.spr, *frames.shape[1:])[:, :take, self.ctx_frames - 1:]
                vals = refm.chunk_metrics(self.vgg_weights, target, pred, self.metrics)
            chunks.append({m: vals[m].float().cpu() for m in self.metrics})
            done += self.spr
        red = refm.best_and_mean(chunks)
        return {"chunks": chunks, "best": {m: red[m + "_max"] for m in self.metrics},
                "mean": {m: red[m + "_avg"] for m in self.metrics}}

    @staticmethod
    def compare(out: Dict, want: Dict) -> Dict[str, float]:
        """For each metric, the widest gap over every sample, clip and frame
        of the batch's chunks, and of its best and mean, from the
        reference's."""
        gaps = {}
        for m in want["best"]:
            pairs = [(o[m], w[m]) for o, w in zip(out["chunks"], want["chunks"])]
            pairs += [(out["best"][m], want["best"][m]), (out["mean"][m], want["mean"][m])]
            gaps[f"{m}_gap"] = max(float((o.float() - w.float()).abs().max()) for o, w in pairs)
        return gaps
