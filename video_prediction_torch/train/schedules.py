"""Training schedules: LR decay, KL annealing, scheduled sampling.

Port of ``video_prediction_tpu/train/schedules.py``. Each schedule takes the
step in one of two forms:

- a Python int: the schedule returns a Python float, computed on the host in
  double precision (the summaries, and the train step of one step a call);
- a 0-d integer tensor: the schedule returns a 0-d float32 tensor on the
  step's device, computed as the JAX package computes it
  (``step.astype(jnp.float32)`` and float32 arithmetic). The host never
  reads the step, so a CUDA graph of several train steps holds the
  schedules of the step tensor it advances, not of the step at capture.

``sample_use_gt_mask`` takes the uniform noise of its training branch as an
input, so that a test can feed the JAX package's numbers:
``jax.random.bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``
(``jax/_src/random.py#_bernoulli``, mode "low").
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from video_prediction_torch.configs.hparams import ModelHparams

Step = Union[int, torch.Tensor]
Value = Union[float, torch.Tensor]


def _const(value: float, step: Step) -> Value:
    """``value`` in the form ``step`` asks for."""
    return torch.full((), value, dtype=torch.float32, device=step.device) if torch.is_tensor(step) else float(value)


def _float(step: Step) -> Value:
    return step.to(torch.float32) if torch.is_tensor(step) else float(step)


def _clip(x: Value, lo: Optional[float], hi: Optional[float]) -> Value:
    if torch.is_tensor(x):
        return x.clamp(lo, hi)
    return min(max(x, lo if lo is not None else -math.inf), hi if hi is not None else math.inf)


def learning_rate(step: Step, hp: ModelHparams) -> Value:
    """Piecewise-linear decay from ``lr`` to ``end_lr`` over
    ``decay_steps = (start, end)``."""
    s0, s1 = hp.decay_steps
    if s1 <= s0:
        return _const(hp.lr, step)
    frac = _clip((_float(step) - s0) / (s1 - s0), 0.0, 1.0)
    return hp.lr + (hp.end_lr - hp.lr) * frac


def kl_weight(step: Step, hp: ModelHparams) -> Value:
    """Annealed KL coefficient (multiplies ``hp.kl_weight``): ``none`` 1,
    ``linear`` 0 -> 1 over ``kl_anneal_steps``, ``sigmoid`` a logistic ramp
    with rate ``kl_anneal_k`` centred midway."""
    if hp.kl_anneal == "none":
        return _const(1.0, step)
    s0, s1 = hp.kl_anneal_steps
    if hp.kl_anneal == "linear":
        return _clip((_float(step) - s0) / max(s1 - s0, 1), 0.0, 1.0)
    if hp.kl_anneal == "sigmoid":
        k = hp.kl_anneal_k
        if k <= 0:
            k = (s1 - s0) / 10.0 or 1.0
        x = (_float(step) - 0.5 * (s0 + s1)) / k
        if torch.is_tensor(x):
            return torch.sigmoid(x)
        return 1.0 / (1.0 + math.exp(-x)) if x >= 0 else math.exp(x) / (1.0 + math.exp(x))  # no overflow
    raise ValueError(f"unknown kl_anneal {hp.kl_anneal!r}")


def ground_truth_prob(step: Step, hp: ModelHparams) -> Value:
    """Probability of feeding the ground-truth frame after the context frames:
    ``inverse_sigmoid`` k/(k + exp(step/k)) (exponent clipped at 30),
    ``linear`` 1 -> 0 over ``schedule_sampling_steps``, ``none`` 0,
    ``always`` 1."""
    if hp.schedule_sampling == "none":
        return _const(0.0, step)
    if hp.schedule_sampling == "always":
        return _const(1.0, step)
    s0, s1 = hp.schedule_sampling_steps
    step_rel = _clip(_float(step) - s0, 0.0, None)
    if hp.schedule_sampling == "inverse_sigmoid":
        k = hp.schedule_sampling_k
        x = _clip(step_rel / k, None, 30.0)
        return k / (k + (torch.exp(x) if torch.is_tensor(x) else math.exp(x)))
    if hp.schedule_sampling == "linear":
        return _clip(1.0 - step_rel / max(s1 - s0, 1), 0.0, 1.0)
    raise ValueError(f"unknown schedule_sampling {hp.schedule_sampling!r}")


def sample_use_gt_mask(batch: int, seq_len: int, hp: ModelHparams, train: bool,
                       device: torch.device | str = "cpu", step: Step = 0,
                       uniforms: Optional[torch.Tensor] = None, ranks: Optional[torch.Tensor] = None,
                       total: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
    """Per-(timestep, sample) teacher-forcing mask ``[T-1, B]`` (bool).

    The inputs of steps ``t < context_frames`` are always ground truth. In
    evaluation, or with ``schedule_sampling="none"``, the rest are the
    model's own predictions. In training, ``uniforms`` ``[T-1, B]`` in [0, 1)
    decide the rest: i.i.d. ``u < p`` with ``p = ground_truth_prob(step)``,
    or with ``schedule_sampling_exact`` exactly round(p*B) ground-truth
    samples per timestep, the ones with the lowest uniforms. With a step
    tensor, ``p`` and that count stay on the device. Under data parallel
    these B columns are a rank's share of a global batch of ``total``:
    ``ranks`` ``[T-1, B]`` then holds their ranks in the global rows
    (``use_gt_ranks`` of the global uniforms), and the count is round(p *
    ``total``) over the global batch, as the JAX mesh step draws it.
    """
    tm1 = seq_len - 1
    in_context = torch.arange(tm1, device=device)[:, None] < hp.context_frames
    if not train or hp.schedule_sampling == "none":
        return in_context.expand(tm1, batch)
    if uniforms is None or tuple(uniforms.shape) != (tm1, batch):
        raise ValueError(f"the training mask needs uniforms of shape {(tm1, batch)}")
    p = ground_truth_prob(step, hp)
    if hp.schedule_sampling_exact:
        if ranks is None:
            ranks, total = use_gt_ranks(uniforms), batch
        k = torch.round(p * total) if torch.is_tensor(p) else round(p * total)
        return in_context | (ranks < k)
    return in_context | (uniforms < p)


def use_gt_ranks(uniforms: torch.Tensor) -> torch.Tensor:
    """The rank of each of ``uniforms`` ``[T-1, B]`` in its row, stable, as
    ``jnp.argsort(jnp.argsort(u))`` gives them."""
    return torch.argsort(torch.argsort(uniforms, dim=1, stable=True), dim=1, stable=True)
