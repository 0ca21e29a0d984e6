"""Shared benchmark plumbing of ``bench``, ``bench_generate`` and ``bench_probe``.

Port of ``video_prediction_tpu/bench_common.py``. The three tools time the
same flagship configuration (full SAVP: VAE + GAN, ConvLSTM/CDNA generator,
video SN discriminators, bf16 compute) under the same clock, so the
hparams, the synthetic batch, the chained-steps timing loop and the
generation probe live here once.

The clock: a CUDA call returns once its work is queued. The port's train
step updates its ``TrainState`` in place and returns the loss tensors
without a host sync, so ``n_steps`` steps are queued back to back, each on
the state the one before left, and one ``float(scalars["g_loss"])`` at the
end copies a value that the device can only produce after every queued step
has run. The host clock around the chain is the sustained rate, as the JAX
package's value fetch is. Rollouts accumulate into one device scalar that is
fetched the same way.

Importing this module builds nothing and runs nothing.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from video_prediction_torch.configs.hparams import ModelHparams, apply_overrides, parse_overrides

SEQ_LEN = 12
CONTEXT = 2
SIZE = 64
SEED = 0  # the weights: jax.random.PRNGKey(0) in the JAX package


def savp_bench_hparams(
    batch_size: int,
    *,
    scan_unroll: int,
    lstm_gate_conv: str,
    prevent_cse: bool = False,
    gate_dtype: str = "float32",
    sequence_length: int = SEQ_LEN,
    context_frames: int = CONTEXT,
    extra: str = "",
) -> ModelHparams:
    """The benchmark ``ModelHparams``: full SAVP, bf16 compute, the same
    fields and values as the JAX package's. ``extra`` is a ``k=v,...``
    override string applied last. In the port ``scan_unroll == 0`` selects
    the split mask input (``models/savp.py``), and the train step recomputes
    the generator cell unless ``scan_unroll == 0`` without ``prevent_cse``
    (``models/savp.py#recomputes``), as the JAX step does."""
    hp = ModelHparams(
        context_frames=context_frames,
        sequence_length=sequence_length,
        batch_size=batch_size,
        l1_weight=100.0,
        kl_weight=0.01,
        nz=8,
        video_sn_gan_weight=0.1,
        video_sn_vae_gan_weight=0.1,
        gan_loss_type="LSGAN",
        beta1=0.5,
        transformation="cdna",
        num_transformed_images=4,
        schedule_sampling_k=900.0,
        compute_dtype="bfloat16",
        scan_unroll=scan_unroll,
        lstm_gate_conv=lstm_gate_conv,
        remat_prevent_cse=prevent_cse,
        gate_dtype=gate_dtype,
    )
    if extra:
        hp = apply_overrides(hp, parse_overrides(extra))
    return hp


def synthetic_batch(batch_size: int, sequence_length: int = SEQ_LEN, size: int = SIZE,
                    device: torch.device | str = "cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's deterministic BAIR-shaped image batch: the same
    ``np.random.RandomState(0).rand`` bytes, fp32 in [0, 1), on ``device``."""
    rng = np.random.RandomState(0)
    images = rng.rand(batch_size, sequence_length, size, size, 3).astype(np.float32)
    return {"images": torch.from_numpy(images).to(device)}


def build_model(hp: ModelHparams, batch: Dict[str, torch.Tensor]):
    """The ``savp`` model of ``hp`` with the shapes ``batch`` fixes, on the CPU,
    weights not yet initialized."""
    from video_prediction_torch.models import get_model_class, input_dims

    return get_model_class("savp")(hp, **input_dims(hp, batch))


def train_setup(hp: ModelHparams, batch: Dict[str, torch.Tensor], device: torch.device | str):
    """``(ts, step_fn)``: the train state of the ``savp`` model of ``hp`` with
    weights from ``SEED``, on ``device``, and its train step."""
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    model = build_model(hp, batch)
    return create_train_state(model, SEED, device), make_train_step(model)


def rollout_mean(model, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                 zs_prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of one eval-path rollout's ``gen_images`` (``forward(train=
    False)`` under ``torch.no_grad()``), a 0-d tensor on the batch's device:
    the unit of the generation probe."""
    with torch.no_grad():
        return model(batch, train=False, generator=generator, zs_prior=zs_prior)["gen_images"].mean()


def generation_probe(
    batch_size: int,
    samples_per_rollout: int,
    *,
    unroll: int = 0,
    gate: str = "split",
    gate_dtype: str = "bfloat16",
    n_rollouts: int = 20,
    sequence_length: int = SEQ_LEN,
    context_frames: int = CONTEXT,
    size: int = SIZE,
    rounds: int = 2,
    extra_hparams: str = "",
    device: torch.device | str = "cuda",
) -> dict:
    """Sustained time a rollout of the eval-path forward at effective batch
    ``batch_size * samples_per_rollout``, what ``evaluate`` runs a chunk.
    Each round sums ``n_rollouts`` rollout means into one device scalar and
    fetches it; best of ``rounds``. The rollouts' prior z come from one
    seeded ``torch.Generator`` on the device, which advances from rollout to
    rollout. ``compile_s`` is the first rollout's seconds, with the kernels'
    first-use build where it happens. Returns the JAX package's keys."""
    device = torch.device(device)
    hp = savp_bench_hparams(
        batch_size,
        scan_unroll=unroll,
        lstm_gate_conv=gate,
        gate_dtype=gate_dtype,
        sequence_length=sequence_length,
        context_frames=context_frames,
        extra=extra_hparams,
    )
    eff = batch_size * samples_per_rollout
    batch = synthetic_batch(eff, sequence_length, size, device)
    model = build_model(hp, batch)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(SEED)

    t0 = time.perf_counter()
    float(rollout_mean(model, batch, gen))
    compile_s = time.perf_counter() - t0

    dt = float("inf")
    val = float("nan")
    for _ in range(rounds):
        t0 = time.perf_counter()
        acc = torch.zeros((), device=device)
        for _ in range(n_rollouts):
            # acc depends on every rollout: its value exists only once all have run
            acc = acc + rollout_mean(model, batch, gen)
        val = float(acc)
        dt = min(dt, time.perf_counter() - t0)
    frames = eff * (sequence_length - context_frames)
    return {
        "batch": batch_size,
        "samples_per_rollout": samples_per_rollout,
        "effective_batch": eff,
        "unroll": unroll,
        "gate": gate,
        "gate_dtype": gate_dtype,
        "ms_per_rollout": dt / n_rollouts * 1e3,
        "gen_frames_per_sec": frames / (dt / n_rollouts),
        "compile_s": compile_s,
        "acc": val,
    }


def timed_chained_steps(
    step_fn: Callable, ts, batch: Dict[str, torch.Tensor], n_steps: int, rounds: int = 2
) -> Tuple[float, object, dict]:
    """Best-of-``rounds`` sustained seconds a step over ``n_steps`` chained
    steps, synced by fetching the final ``g_loss`` value. ``step_fn(ts,
    batch)`` updates ``ts`` in place and returns the step's scalars.
    Returns (sec_per_step, ts, final scalars)."""
    dt = float("inf")
    scalars = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            scalars = step_fn(ts, batch)
        float(scalars["g_loss"])  # the value exists only once every queued step has run
        dt = min(dt, time.perf_counter() - t0)
    return dt / n_steps, ts, scalars


def launches_since(before: Dict[str, int], calls: int) -> Dict[str, float]:
    """Each kernel wrapper's launches since the counts ``before``, a call of ``calls``."""
    from video_prediction_torch import kernels as K

    return {name: (n - before[name]) / calls for name, n in K.launch_counts().items()}


def timed_train(hp: ModelHparams, batch: Dict[str, torch.Tensor], device: torch.device | str, n_steps: int,
                rounds: int = 2) -> dict:
    """The train step of ``hp`` on ``batch``, timed as ``bench`` and
    ``bench_probe`` time it: the state from ``SEED`` (``train_setup``), one
    first step whose seconds are ``compile_s`` (the kernels' first-use build
    and cuDNN's first calls, where they happen), then
    ``timed_chained_steps``. Returns ``sec_per_step``, ``compile_s``, the
    last ``scalars``, the kernels' ``launches_per_step`` in the timed
    rounds, and ``ts`` and ``step_fn`` for further steps."""
    from video_prediction_torch import kernels as K

    ts, step_fn = train_setup(hp, batch, device)
    t0 = time.perf_counter()
    float(step_fn(ts, batch)["g_loss"])  # a value fetch: the first step has run
    compile_s = time.perf_counter() - t0
    before = K.launch_counts()
    sec, ts, scalars = timed_chained_steps(step_fn, ts, batch, n_steps, rounds)
    return {"sec_per_step": sec, "compile_s": compile_s, "scalars": scalars,
            "launches_per_step": launches_since(before, rounds * n_steps), "ts": ts, "step_fn": step_fn}
