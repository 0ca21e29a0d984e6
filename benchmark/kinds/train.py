"""Training cells: the VAE-GAN train step as the port's train CLI runs it
with ``--steps_per_call K``: ``train/step.py#make_train_step`` (a
``MultiStep``, on CUDA one graph of K steps) fed by
``data/loader.py#DeviceFeeder(stack=K)`` from a host pool of distinct
clips made from the seed.

Set-up builds the train state, runs the first call (K eager steps, on the
benchmark's own noise, with the first gradients and the first step's
rollout read on the way) and the second (the capture). The pool's clips
carry the configuration's actions and states where it has them
(``common.make_inputs``). The window replays
calls, at most ``IN_FLIGHT`` queued on the device, and ends with the last
call's loss fetched to the host. After it, the check's call: the same
train state set back in place to the seeded start, then one more call of
the window's own (on CUDA a replay of its graph) on the pool's first clips
with the benchmark's noise, whose K steps' losses and each leaf's change
are read. The plain reference follows those K steps from the same
weights, clips and noise.

The model's own parts, its reference and its work counts, come from
``benchmark/models/<model>.py`` (``ctx.parts``); nothing here names a model.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import common, program

IN_FLIGHT = 2


def draw_noise(hp, batch: int, seq_len: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One step's noise in the form the port's step takes: the teacher-forcing
    uniforms ``[T-1,B]``, the posterior's and the prior's Gaussians
    ``[B,T-1,nz]``, the discriminator clip's start."""
    clip = min(hp.clip_length, seq_len - 1)
    return {"use_gt_u": torch.rand((seq_len - 1, batch), generator=gen, device=device),
            "eps_q": torch.randn((batch, seq_len - 1, hp.nz), generator=gen, device=device),
            "z_p": torch.randn((batch, seq_len - 1, hp.nz), generator=gen, device=device),
            "clip_start": torch.randint(0, seq_len - clip, (), generator=gen, device=device)}


class Cell:
    def __init__(self, ctx):
        self.ctx, cfg, traffic = ctx, ctx.cfg, ctx.traffic
        self.parts = ctx.parts
        self.k, self.b = traffic["steps_per_call"], traffic["batch_size"]
        self.hp = program.hparams(cfg, dict(ctx.overrides, batch_size=self.b))
        self.t = self.hp.sequence_length
        self.shape = tuple(ctx.overrides.get("image_shape", cfg["image_shape"]))
        self.spans = common.Spans()
        self.unit_ms: List[float] = []

    # ------------------------------------------------------------ set-up --
    def setup(self) -> None:
        from video_prediction_torch.data import DeviceFeeder
        from video_prediction_torch.train.state import TrainState, make_optimizers
        from video_prediction_torch.train.step import make_train_step

        ctx, dev = self.ctx, self.ctx.device
        self.model, self.weights = program.build_model(ctx.cfg, self.hp, self.shape, ctx.seed, dev)
        opt_g, opt_d = make_optimizers(self.model, self.k)
        self.ts = TrainState(self.model, opt_g, opt_d, 0, common.generator(ctx.seed, 3, dev))
        self.step = make_train_step(self.model, steps_per_call=self.k)
        n_pool = self.ctx.traffic["pool_calls"] * self.k * self.b
        self.pool = common.make_inputs(n_pool, self.t, self.shape, ctx.cfg, ctx.seed, dev)
        self.feeder = DeviceFeeder(program.host_batches(self.pool, self.b), dev, stack=self.k)
        gen = common.generator(ctx.seed, 2, dev)
        self.noises = [draw_noise(self.hp, self.b, self.t, gen, dev) for _ in range(self.k)]
        self.read = self._watch_first_step()
        self.step(self.ts, next(self.feeder), self.noises)
        for handle in self.read.pop("handles"):
            handle.remove()
        self.step(self.ts, next(self.feeder))  # the capture, and its first replay
        self.ctx.sync()

    def _watch_first_step(self) -> Dict:
        """Hooks on the discriminators' Adam, which steps after the
        generator's: after the first step each leaf's first gradient norm,
        from Adam's first moment (``exp_avg / (1 - beta1)``); and on the
        generator the first step's rollout. Removed before the capture."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        read: Dict = {}
        opts = [o for o in (self.ts.opt_g, self.ts.opt_d) if o is not None]

        def hook(opt, args, kwargs):
            if "grad" not in read:
                read["grad"] = {names[id(p)]: opt_state(opts, p)["exp_avg"].norm() / (1 - g["betas"][0])
                                for o in opts for g in o.param_groups for p in g["params"]}

        def frames(module, args, out):  # the first step's doubled rollout, prior then posterior
            if "frames" not in read:
                read["frames"] = out["gen_images"].detach().clone()

        read["handles"] = [opts[-1].register_step_post_hook(hook), self.model.generator.register_forward_hook(frames)]
        return read

    # ------------------------------------------------------------ window --
    def run(self, seconds: float = None, count: int = None) -> Dict:
        """Calls until ``seconds`` have passed (or ``count`` calls), at most
        ``IN_FLIGHT`` queued; the last call's loss fetched to the host."""
        sp, ctx = self.spans, self.ctx
        marks = [ctx.event()]
        pending = collections.deque()
        n, t0 = 0, time.perf_counter()
        while True:
            batches = sp("feeder_wait", next, self.feeder)
            out = sp("call_host", self.step, self.ts, batches)
            marks.append(ctx.event())
            pending.append(marks[-1])
            n += 1
            if len(pending) > IN_FLIGHT:
                sp("device_wait", ctx.wait, pending.popleft())
            if (count is not None and n >= count) or (count is None and time.perf_counter() - t0 >= seconds):
                break
        sp("fetch", float, out["g_loss"])
        t1 = time.perf_counter()
        self.unit_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])] if ctx.cuda else []
        return {"units": n, "seconds": t1 - t0}

    def frames_per_unit(self) -> int:
        return self.k * self.b * (self.t - self.hp.context_frames)

    def end_to_end(self, window: Dict) -> Dict[str, float]:
        return {"train_frames_per_s": window["units"] * self.frames_per_unit() / window["seconds"]}

    # ------------------------------------------------------------- work --
    def flops_per_unit(self) -> float:
        return self.k * self.parts.train_step_flops(self.hp.to_dict(), self.b, self.t, *self.shape)

    def kernel_work(self) -> Dict:
        """Bytes and device events of K1-K3 in one call: per step the doubled
        batch's rollout forward (twice where the cell is recomputed in the
        backward pass) and backward."""
        hp, (h, w, c) = self.hp.to_dict(), self.shape
        forwards = 2 if hp["remat"] and (hp["scan_unroll"] != 0 or hp["remat_prevent_cse"]) else 1
        steps = self.k * (self.t - 1)
        nbytes, events = collections.Counter(), collections.Counter()
        for backward, times in ((False, forwards), (True, 1)):
            nbytes.update({g: v * times * steps
                           for g, v in self.parts.kernel_bytes(hp, 2 * self.b, h, w, c, backward).items()})
            events.update({g: v * times * steps for g, v in self.parts.kernel_events(hp, h, w, backward).items()})
        return {"bytes": dict(nbytes), "events": dict(events)}

    # ------------------------------------------------------------ check --
    def check_call(self) -> Dict:
        """The check's call, through the window's call and feed: the train
        state set back in place to the seeded start (weights and ``u``
        vectors, both Adams' moments and counts at 0, step 0), then one call
        (on CUDA a replay of the window's graph) on the pool's first K
        batches with the benchmark's noise. Its K steps' ``g_loss`` and
        ``d_loss``, and each leaf's change over them."""
        from video_prediction_torch.data import DeviceFeeder

        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(self.weights[k])
            for opt in (self.ts.opt_g, self.ts.opt_d):
                for state in (opt.state.values() if opt is not None else ()):
                    for v in state.values():
                        if torch.is_tensor(v):
                            v.zero_()
        self.ts.step = 0
        feeder = DeviceFeeder(program.host_batches(self.pool, self.b), self.ctx.device, stack=self.k)
        try:
            self.step(self.ts, next(feeder), self.noises)
        finally:
            feeder.close()
        keys = self.step.keys
        losses = self.step.scalars_by_step[:, [keys.index("g_loss"), keys.index("d_loss")]].cpu().numpy()
        with torch.no_grad():
            change = {n: float((p.detach() - self.weights[n]).norm()) for n, p in self.model.named_parameters()}
        return {"losses": [tuple(float(x) for x in r) for r in losses], "change_norms": change}

    def free(self) -> None:
        self.feeder.close()
        self.outputs = dict(self.check_call(), grad_norms={n: float(v) for n, v in self.read["grad"].items()},
                            first_frames=self.read["frames"].float())
        del self.feeder, self.step, self.ts, self.model, self.read
        self.ctx.empty_cache()

    def reference(self) -> Dict:
        """The reference's K steps on the check call's batches: the pool's
        first K x B clips, B a step, every key."""
        calls = {k: torch.from_numpy(v[: self.k * self.b]).to(self.ctx.device).reshape(self.k, self.b, *v.shape[1:])
                 for k, v in self.pool.items()}
        batches = [{k: v[i] for k, v in calls.items()} for i in range(self.k)]
        with common.exact_fp32():
            return self.parts.train_steps(self.weights, self.hp.to_dict(), batches, self.noises)

    @staticmethod
    def leaf_gaps(out: Dict, want: Dict) -> Dict[str, Dict[str, float]]:
        """Each leaf's gap of first-gradient norms and (for the leaves that
        move) of change norms, over the larger of the reference leaf's norm
        and the median leaf's; leaves whose reference gradient is under a
        thousandth of the median leaf's are left out of the change."""
        g_ref = want["grad_norms"]
        g_med = float(np.median(list(g_ref.values())))
        grad = {k: abs(out["grad_norms"][k] - g) / max(g, g_med) for k, g in g_ref.items()}
        moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
        c_ref = want["change_norms"]
        c_med = float(np.median([c_ref[k] for k in moved]))
        change = {k: abs(out["change_norms"][k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved}
        return {"grad": grad, "change": change}

    @staticmethod
    def step_gaps(out: Dict, want: Dict):
        """Each step's relative gaps of ``g_loss`` and ``d_loss``; the
        absolute gap where the reference's loss is 0 (a model with no
        discriminator)."""
        return [[abs(p - r) / abs(r) if r else abs(p - r) for p, r in zip(ps, rs)]
                for ps, rs in zip(out["losses"], want["losses"])]

    @classmethod
    def compare(cls, out: Dict, want: Dict) -> Dict[str, float]:
        """The numbers that decide ``correct``: the largest relative gap of a
        step's ``g_loss`` or ``d_loss`` in the check's call, and of its first
        step's; the worst and the median leaf's gap of change norms over the
        check's call and of first-gradient norms in set-up's first call
        (``leaf_gaps``); the widest gap of that call's first rollout frames,
        in levels of 255."""
        steps = cls.step_gaps(out, want)
        gaps = cls.leaf_gaps(out, want)
        frames, ref_frames = out["first_frames"], want["first_frames"].to(out["first_frames"].device)
        return {"loss_gap": float(max(max(s) for s in steps)), "first_loss_gap": float(max(steps[0])),
                "grad_gap": float(max(gaps["grad"].values())), "grad_median_gap": float(np.median(list(gaps["grad"].values()))),
                "change_gap": float(max(gaps["change"].values())),
                "change_median_gap": float(np.median(list(gaps["change"].values()))),
                "first_frames_gap": 255.0 * float((frames - ref_frames).abs().max())
                if frames.shape == ref_frames.shape else float("inf")}

    @classmethod
    def detail(cls, out: Dict, want: Dict) -> Dict:
        """Where the gaps come from: each step's loss gaps, the worst leaves
        (gap, reference gradient over the median leaf's, share of its
        reference gradient's elements under ten times Adam's epsilon)."""
        gaps = cls.leaf_gaps(out, want)
        med = float(np.median(list(want["grad_norms"].values())))
        worst = {kind: [(k, v, want["grad_norms"][k] / med, want["tiny_grad_share"][k])
                        for k, v in sorted(g.items(), key=lambda kv: -kv[1])[:4]]
                 for kind, g in gaps.items()}
        return {"step_loss_gaps": cls.step_gaps(out, want), "losses": want["losses"], "worst_leaves": worst}


def opt_state(opts, p) -> Dict:
    for o in opts:
        if p in o.state:
            return o.state[p]
    raise KeyError("parameter has no optimizer state")
