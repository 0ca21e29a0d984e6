"""Faults planted under the timed path, to show that the check catches them.
Each is a context manager that patches the port in this process only (no
file changes): the check must come out not correct while it is on.

- ``state_unchanged``: a train step leaves the parameters and ``u`` vectors
  as they were; a generator step returns its recurrent state unchanged;
- ``half_batch``: a train step takes the first half of its batch (the mean
  over those rows); a rollout computes the first half of its rows and
  repeats it;
- ``answer_altered``: one predicted frame of one sample is changed where the
  rollout produces it.

On CUDA a train call after the first replays a captured graph; two faults
break that replay alone (``CUDA_FAULTS``), and show only on the card:

- ``replay_stale_inputs``: the replay runs on the batch and noise that the
  static buffers held before, without the call's own copied in;
- ``replay_state_unchanged``: a replayed call leaves the parameters and
  ``u`` vectors as they were before it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _train_state_unchanged(original):
    def update(ts, batch, noise, *args, **kwargs):
        kept = [t.detach().clone() for t in ts.model.state_dict().values()]
        scalars = original(ts, batch, noise, *args, **kwargs)
        for t, k in zip(ts.model.state_dict().values(), kept):
            t.copy_(k)
        return scalars

    return update


def _train_half_batch(original):
    def update(ts, batch, noise, *args, **kwargs):
        half = batch["images"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        noise = {k: (v[:, :half] if k == "use_gt_u" else v if v.ndim == 0 else v[:half]) for k, v in noise.items()}
        return original(ts, batch, noise, *args, **kwargs)

    return update


def _cell_state_unchanged(original):
    def forward(self, state, x, *args, **kwargs):
        new_state, out = original(self, state, x, *args, **kwargs)
        return (state[0],) + tuple(new_state[1:]), out

    return forward


def _rollout_half_batch(original):
    def forward(self, batch, *args, **kwargs):
        if kwargs.get("train"):
            return original(self, batch, *args, **kwargs)
        half = batch["images"].shape[0] // 2
        out = original(self, {k: v[:half] for k, v in batch.items()}, *args, **kwargs)
        out["gen_images"] = out["gen_images"].repeat(2, *[1] * (out["gen_images"].ndim - 1))
        return out

    return forward


def _rollout_answer_altered(original):
    def forward(self, batch, *args, **kwargs):
        out = original(self, batch, *args, **kwargs)
        if not kwargs.get("train"):
            gen = out["gen_images"].clone()
            gen[0, -1] = (gen[0, -1] + 0.05).clamp(0, 1)
            out["gen_images"] = gen
        return out

    return forward


def _replay_stale_inputs(original):
    def call(self, ts, batches, noises):
        if self._graph is None:
            return original(self, ts, batches, noises)
        self._graph.replay()
        return self._out.clone()

    return call


def _replay_state_unchanged(original):
    def call(self, ts, batches, noises):
        if self._graph is None:
            return original(self, ts, batches, noises)
        kept = [t.detach().clone() for t in ts.model.state_dict().values()]
        table = original(self, ts, batches, noises)
        for t, k in zip(ts.model.state_dict().values(), kept):
            t.copy_(k)
        return table

    return call


@contextlib.contextmanager
def fault(name: str, kind: str):
    """Plant fault ``name`` under a cell of ``kind`` (train, generate,
    evaluate)."""
    from video_prediction_torch.models.base import VideoPredictionModel
    from video_prediction_torch.models.savp import SAVPCell
    from video_prediction_torch.train import step as step_module

    if name.startswith("replay_"):
        make = {"replay_stale_inputs": _replay_stale_inputs, "replay_state_unchanged": _replay_state_unchanged}[name]
        with patched(step_module.MultiStep, "_cuda_call", make):
            yield
    elif kind == "train":
        make = {"state_unchanged": _train_state_unchanged, "half_batch": _train_half_batch}[name]
        with patched(step_module, "_update", make):
            yield
    elif name == "state_unchanged":
        with patched(SAVPCell, "forward", _cell_state_unchanged):
            yield
    else:
        make = {"half_batch": _rollout_half_batch, "answer_altered": _rollout_answer_altered}[name]
        with patched(VideoPredictionModel, "forward", make):
            yield


FAULTS = {"train": ("state_unchanged", "half_batch"),
          "generate": ("state_unchanged", "half_batch", "answer_altered"),
          "evaluate": ("state_unchanged", "half_batch", "answer_altered")}
CUDA_FAULTS = {"train": ("replay_stale_inputs", "replay_state_unchanged"), "generate": (), "evaluate": ()}
