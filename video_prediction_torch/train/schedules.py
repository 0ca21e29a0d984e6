"""Scheduled sampling: the teacher-forcing mask.

Port of ``video_prediction_tpu/train/schedules.py#sample_use_gt_mask``, the
branch without noise: evaluation, or ``schedule_sampling="none"``. The
training branch, which samples, is still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from video_prediction_torch.configs.hparams import ModelHparams


def sample_use_gt_mask(batch: int, seq_len: int, hp: ModelHparams, train: bool,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-(timestep, sample) teacher-forcing mask ``[T-1, B]`` (bool): the
    inputs of steps ``t < context_frames`` are ground truth, the rest are
    the model's own predictions."""
    if train and hp.schedule_sampling != "none":
        raise NotImplementedError("the sampled training mask is not ported yet (ROADMAP.md, queue 1)")
    in_context = torch.arange(seq_len - 1, device=device)[:, None] < hp.context_frames
    return in_context.expand(seq_len - 1, batch)
