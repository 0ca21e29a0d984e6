"""Training schedules: LR decay, KL annealing, scheduled sampling.

Port of ``video_prediction_tpu/train/schedules.py``. The schedules are
plain functions of the integer step returning Python floats (the port runs
its step loop on the host). ``sample_use_gt_mask`` takes the uniform noise of
its training branch as an input, so that a test can feed the JAX package's
numbers: ``jax.random.bernoulli(key, p, shape)`` is ``uniform(key, shape) <
p`` (``jax/_src/random.py#_bernoulli``, mode "low").
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from video_prediction_torch.configs.hparams import ModelHparams


def learning_rate(step: int, hp: ModelHparams) -> float:
    """Piecewise-linear decay from ``lr`` to ``end_lr`` over
    ``decay_steps = (start, end)``."""
    s0, s1 = hp.decay_steps
    if s1 <= s0:
        return float(hp.lr)
    frac = min(max((step - s0) / (s1 - s0), 0.0), 1.0)
    return hp.lr + (hp.end_lr - hp.lr) * frac


def kl_weight(step: int, hp: ModelHparams) -> float:
    """Annealed KL coefficient (multiplies ``hp.kl_weight``): ``none`` 1,
    ``linear`` 0 -> 1 over ``kl_anneal_steps``, ``sigmoid`` a logistic ramp
    with rate ``kl_anneal_k`` centred midway."""
    if hp.kl_anneal == "none":
        return 1.0
    s0, s1 = hp.kl_anneal_steps
    if hp.kl_anneal == "linear":
        return min(max((step - s0) / max(s1 - s0, 1), 0.0), 1.0)
    if hp.kl_anneal == "sigmoid":
        k = hp.kl_anneal_k
        if k <= 0:
            k = (s1 - s0) / 10.0 or 1.0
        x = (step - 0.5 * (s0 + s1)) / k
        return 1.0 / (1.0 + math.exp(-x)) if x >= 0 else math.exp(x) / (1.0 + math.exp(x))  # no overflow
    raise ValueError(f"unknown kl_anneal {hp.kl_anneal!r}")


def ground_truth_prob(step: int, hp: ModelHparams) -> float:
    """Probability of feeding the ground-truth frame after the context frames:
    ``inverse_sigmoid`` k/(k + exp(step/k)) (exponent clipped at 30),
    ``linear`` 1 -> 0 over ``schedule_sampling_steps``, ``none`` 0,
    ``always`` 1."""
    if hp.schedule_sampling == "none":
        return 0.0
    if hp.schedule_sampling == "always":
        return 1.0
    s0, s1 = hp.schedule_sampling_steps
    step_rel = max(step - s0, 0.0)
    if hp.schedule_sampling == "inverse_sigmoid":
        k = hp.schedule_sampling_k
        return k / (k + math.exp(min(step_rel / k, 30.0)))
    if hp.schedule_sampling == "linear":
        return min(max(1.0 - step_rel / max(s1 - s0, 1), 0.0), 1.0)
    raise ValueError(f"unknown schedule_sampling {hp.schedule_sampling!r}")


def sample_use_gt_mask(batch: int, seq_len: int, hp: ModelHparams, train: bool,
                       device: torch.device | str = "cpu", step: int = 0,
                       uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-(timestep, sample) teacher-forcing mask ``[T-1, B]`` (bool).

    The inputs of steps ``t < context_frames`` are always ground truth. In
    evaluation, or with ``schedule_sampling="none"``, the rest are the
    model's own predictions. In training, ``uniforms`` ``[T-1, B]`` in [0, 1)
    decide the rest: i.i.d. ``u < p`` with ``p = ground_truth_prob(step)``,
    or with ``schedule_sampling_exact`` exactly round(p*B) ground-truth
    samples per timestep, the ones with the lowest uniforms.
    """
    tm1 = seq_len - 1
    in_context = torch.arange(tm1, device=device)[:, None] < hp.context_frames
    if not train or hp.schedule_sampling == "none":
        return in_context.expand(tm1, batch)
    if uniforms is None or tuple(uniforms.shape) != (tm1, batch):
        raise ValueError(f"the training mask needs uniforms of shape {(tm1, batch)}")
    p = ground_truth_prob(step, hp)
    if hp.schedule_sampling_exact:
        k = round(p * batch)
        # stable ranks, as jnp.argsort(jnp.argsort(u)) gives them
        ranks = torch.argsort(torch.argsort(uniforms, dim=1, stable=True), dim=1, stable=True)
        return in_context | (ranks < k)
    return in_context | (uniforms < p)
