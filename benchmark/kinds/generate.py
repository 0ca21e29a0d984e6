"""Generation cells: one client in a closed loop, no think time. A request is
``clips_per_request`` context clips, drawn from a seeded pool (a different
set each request), times ``samples_per_clip`` prior samples: the clips go to
the device as the port's ``generate`` sends them (``batch_to_device``:
uint8, pinned), each repeated ``samples_per_clip`` times in a row, one
``forward(train=False)`` of the port's model rolls them out with the prior
drawn from the run's generator, and the predicted frames come back to the
host as uint8 (``generate``'s rounding). A request is timed from its issue
until its frames are on the host.

The check keeps a seeded sample of the completed requests (reservoir
sampling) with their frames and the generator's state at their issue, and
rolls each out again with the plain reference from the same weights, clips
and prior draws. Where the configuration has actions and states, each clip
carries its own (``common.make_inputs``). The reference comes from
``benchmark/models/<model>.py`` (``ctx.parts``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import common, program


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    return (frames.float().clamp(0, 1) * 255 + 0.5).to(torch.uint8)


def frame_gaps(got_u8: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """How far delivered uint8 frames lie from the reference's frames, in
    levels of 255, past the half level that rounding itself may take."""
    gap = ((got_u8.float() - want.float().clamp(0, 1) * 255).abs() - 0.5).clamp(min=0)
    return {"frame_gap_max": float(gap.max()), "frame_gap_mean": float(gap.mean())}


class Cell:
    def __init__(self, ctx):
        self.ctx, cfg, traffic = ctx, ctx.cfg, ctx.traffic
        self.parts = ctx.parts
        self.clips, self.samples = traffic["clips_per_request"], traffic["samples_per_clip"]
        self.hp = program.hparams(cfg, ctx.overrides)
        self.t, self.ctx_frames = self.hp.sequence_length, self.hp.context_frames
        self.shape = tuple(ctx.overrides.get("image_shape", cfg["image_shape"]))
        self.spans = common.Spans()
        self.unit_ms: List[float] = []
        self.kept: List[Dict] = []
        self.done = 0

    def setup(self) -> None:
        ctx, dev = self.ctx, self.ctx.device
        self.model, self.weights = program.build_model(ctx.cfg, self.hp, self.shape, ctx.seed, dev)
        self.model.eval()
        self.pool = common.make_inputs(ctx.traffic["pool_clips"], self.t, self.shape, ctx.cfg, ctx.seed, dev)
        self.choice = np.random.default_rng(common.sub_seed(ctx.seed, 6))
        self.keep = np.random.default_rng(common.sub_seed(ctx.seed, 7))
        self.rng = common.generator(ctx.seed, 2, dev)
        for _ in range(ctx.traffic["warmup_requests"]):
            self.request(record=False)

    def request(self, record: bool = True) -> None:
        sp = self.spans
        idx = np.sort(self.choice.choice(len(self.pool["images"]), self.clips, replace=False))
        t0 = time.perf_counter()
        batch = sp("to_device", program.batch_to_device, common.rows_of(self.pool, idx), self.ctx.device)
        tiled = {k: v.repeat_interleave(self.samples, dim=0) for k, v in batch.items()}
        state = self.rng.get_state()
        with torch.inference_mode():
            gen = sp("rollout_host", self.model, tiled, train=False, generator=self.rng)["gen_images"]
            frames = sp("fetch", lambda: to_uint8(gen[:, self.ctx_frames - 1:]).cpu())
        t1 = time.perf_counter()
        if not record:
            return
        self.unit_ms.append((t1 - t0) * 1e3)
        self.done += 1
        slots = self.ctx.traffic["check_requests"]
        slot = len(self.kept) if len(self.kept) < slots else int(self.keep.integers(self.done))
        if slot < slots:  # reservoir sampling: each completed request kept with the same chance
            entry = {"idx": idx, "state": state, "frames": frames}
            if slot == len(self.kept):
                self.kept.append(entry)
            else:
                self.kept[slot] = entry

    def run(self, seconds: float = None, count: int = None) -> Dict:
        return common.closed_loop(self.request, seconds, count)

    def frames_per_unit(self) -> int:
        return self.clips * self.samples * (self.t - self.ctx_frames)

    def end_to_end(self, window: Dict) -> Dict[str, float]:
        lat = self.unit_ms[-window["units"]:]
        return {"gen_frames_per_s": window["units"] * self.frames_per_unit() / window["seconds"],
                "gen_request_ms_p95": common.quantile(lat, 0.95)}

    def flops_per_unit(self) -> float:
        return self.parts.rollout_flops(self.hp.to_dict(), self.clips * self.samples, self.t, *self.shape)

    def kernel_work(self) -> Dict:
        hp, (h, w, c) = self.hp.to_dict(), self.shape
        steps = self.t - 1
        nbytes = self.parts.kernel_bytes(hp, self.clips * self.samples, h, w, c, False)
        events = self.parts.kernel_events(hp, h, w, False)
        return {"bytes": {g: v * steps for g, v in nbytes.items()}, "events": {g: v * steps for g, v in events.items()}}

    def free(self) -> None:
        self.outputs = [e["frames"] for e in self.kept]
        del self.model
        self.ctx.empty_cache()

    def reference(self) -> List[torch.Tensor]:
        """The reference's frames (float, [0, 1]) of each kept request."""
        hp, dev, out = self.hp.to_dict(), self.ctx.device, []
        gen = torch.Generator(device=dev)
        for e in self.kept:
            batch = {k: torch.from_numpy(v).to(dev).repeat_interleave(self.samples, dim=0)
                     for k, v in common.rows_of(self.pool, e["idx"]).items()}
            batch["images"] = batch["images"].float().div(255.0)
            gen.set_state(e["state"])
            zs = torch.randn((batch["images"].shape[0], self.t - 1, hp["nz"]), generator=gen, device=dev)
            with common.exact_fp32(), torch.no_grad():
                frames = self.parts.eval_rollout(self.weights, hp, batch, zs)
            out.append(frames[:, self.ctx_frames - 1:].float())
        return out

    @staticmethod
    def compare(out, want) -> Dict[str, float]:
        """Over every pixel of the kept requests: the widest and the mean gap
        of a delivered level from the reference's value, past rounding's half
        level (``frame_gaps``). ``out``: uint8 frames, or float frames (the
        control) rounded as the program rounds them."""
        gaps = [frame_gaps((o if o.dtype == torch.uint8 else to_uint8(o)).cpu(), w.cpu()) for o, w in zip(out, want)]
        return {"frame_gap_max": max(g["frame_gap_max"] for g in gaps),
                "frame_gap_mean": float(np.mean([g["frame_gap_mean"] for g in gaps]))}
