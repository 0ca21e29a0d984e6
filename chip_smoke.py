#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``video_prediction_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA GPU, ``nvcc``
and ``nvidia-smi``. Phases, each fatal on failure:

1. report the device (name and power limit from ``nvidia-smi``);
2. build the CUDA kernels from ``video_prediction_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print ptxas's registers and spills
   of every kernel instantiation; none of K1's, K2's or K3's may spill;
3. compare each forward kernel with its plain PyTorch version on the card,
   at the shapes of the generation rollout (batch 8), of the train step's
   rollout (the doubled batch 2 x 16) and of the evaluate rollout (8
   examples x 8 samples = 64; K3 also at SV2P's 6 candidates), fp32 and
   bf16, and time it; K1 also against its library yardstick, one grouped
   ``F.conv2d`` (TF32 off), checked equal to K1 before it is timed; K2 also
   at C = 8, 40 and 300 and on views that start one element past a 16-byte
   boundary (its run-time instantiation), and twice to equal bits; K3 at
   each compile-time instantiation (7 and 6 candidates, aligned tensors) and
   at its run-time one (such views, ``dna_l2``'s 3 candidates at the train
   step's shapes, and 33x31 with 16 candidates), with and without the masks,
   twice to equal bits;
4. compare each backward kernel with autograd of its plain version, at the
   training step's shapes (the doubled batch 2 x 16; K3 also at 3
   candidates) and at odd shapes, fp32
   and bf16 (K2 also on unaligned views), and time it (K1 against one
   ``convolution_backward`` of the grouped conv, checked first; K1 and K2
   run twice to equal bits);
5. drive ``video_prediction_torch.generate`` at the full ``ours_savp`` width
   (64x64, ngf=32, nz=8) from a run directory with seeded random weights, and
   check GIFs, finite outputs and the kernel launch counts per rollout;
6. compare the GPU rollout (kernels) with the CPU rollout (plain versions)
   of the same weights, batch and z, with TF32 off;
7. time the no-grad rollout at effective batch 8 and 64;
8. drive ``python -m video_prediction_torch.train``'s ``main`` at the full
   ``ours_savp`` width, batch 16, for 3 steps, then ``--resume`` for one
   more, and check finite losses, the forward and backward launch counts per
   train step (``train_launches``: the zoo file's ``remat`` recomputes the
   cell in the backward pass, so K1-K3 run forward twice a step), the moved
   spectral u and the resumed step counter;
9. compare one GPU train step (kernels) with the CPU train step (plain
   versions) of the same weights, batch and noise at a small width, TF32
   off: every loss term, gradient and parameter after the step;
10. time the train step at batch 16, fp32 with TF32 off and with cuDNN's
    default, with the peak device memory;
11. drive ``video_prediction_torch.evaluate``'s ``main`` on phase 5's run
    directory: 16 examples, best of 8 samples in one rollout of 64, VGG and
    LPIPS from seeded ``.npz`` weights; check the metric files, the gallery
    and the launch counts per rollout; then the ``ground_truth`` (PSNR inf,
    SSIM 1) and ``repeat`` baselines without a checkpoint; then VGG and LPIPS
    through ``BestOfN``, the target featurised once for two chunks, against
    each metric on the target expanded to every sample, TF32 on and off;
12. ``sv2p`` at full width from a run directory with seeded weights:
    ``evaluate`` with best of 2 and its launch counts, and its GPU rollout
    against its CPU rollout with TF32 off;
13. PSNR and SSIM on the card against the CPU with cuDNN's TF32 left on, VGG
    and LPIPS with it off (and how far TF32 moves them);
14. time one evaluate batch at the defaults, split into the rollout and the
    metrics, with PSNR/SSIM alone and with VGG and LPIPS;
15. the bf16 model (``hparams/bair_action_free/ours_savp_tpu``: the
    flagship's widths, bf16 compute and gates, batch 64) from a run
    directory with seeded random weights: ``generate`` and ``evaluate`` at
    their defaults (``evaluate`` best of 8); check finite outputs, the launch
    counts per rollout and the dtype of every launch (K1 and K3 fp32, K2
    bf16);
16. the GPU bf16 rollout (kernels) against the CPU bf16 rollout (plain
    versions) of the same weights, batch and z, batch 2, TF32 off, under the
    ratio rule: max|GPU bf16 - CPU bf16| <= 2 max|CPU bf16 - CPU fp32| (the
    fp32 rollout of the same weights);
17. ``train``'s ``main`` on ``ours_savp_tpu`` at batch 64: 2 steps, then
    ``--resume`` for a third; finite losses, launch counts and dtypes per
    step; then one GPU bf16 train step against the CPU bf16 step at ngf=8,
    from each of two seeds, against the CPU fp32 step: each loss term within
    2 times the CPU bf16 term's distance from the fp32 one (a GAN term plus
    one bf16 ulp of its logit), each gradient leaf within 4 times that
    distance plus one rounding of its largest entry;
18. time the bf16 rollout at batch 8 and 64, the bf16 train step at batch 16
    and 64 with its peak device memory, and one bf16 evaluate batch;
19. the TFRecord datasets: write BAIR-schema records (64 train in 4 files,
    16 val, 16 test; 30 raw 64x64 frames of the ``synthetic`` generator with
    its actions and states) through the port's writer (``data/records.py``);
    ``train``'s ``main`` on them (``--dataset bair``, ``--val_input_dir``,
    ``ours_savp``, batch 16, TF32 convs, 3 steps and an eval firing of 8 val
    batches), with the launches per train step against phase 8's; the
    feeder's first device batch against the host pipeline's, byte for byte;
    one step of the action-conditioned ``bair/ours_savp`` with
    ``use_state=True``; ``evaluate`` (best of 8) and ``generate`` on the
    test records with phase 11's and phase 5's checks; print whether the
    native JPEG codec links and PIL is present, the host pipeline's
    examples/s, the train step on the records through the feeder beside the
    same model's step on a fixed device batch, and an evaluate batch from the
    records beside one on a fixed batch;
20. the action-conditioned zoo files on phase 19's records read with
    ``use_state=True`` (4-D actions, 3-D states): ``train``'s ``main`` at
    full width, batch 16, TF32 convs, 3 steps each of ``--model dna``
    (``bair/dna_l2``), ``--model sna`` (``bair/sna_l2``) and ``--model
    savp`` (``bair/ours_gan``), with finite losses (a ``state`` term where
    ``state_weight > 0``), the launches per step (K1 none for ``dna``) and
    the stem conv's 3 + 4 + 3 input channels; ``evaluate`` and ``generate``
    from each run directory on ``test/`` with phase 19's checks; the GPU
    rollout against the CPU rollout (TF32 off, ngf=8) for each generator
    option under ``use_states`` (dna, stp, flow, direct, GRU cells, the
    context-frame backgrounds, learned initial states, ``deconv2d``,
    ``max_pool_conv2d``) and one ``dna_l2`` train step under phase 9's
    rule; ``apply_dna_kernels`` (torch ops, no hand kernel) against and
    beside the JAX package's shifted multiply-adds, device time a call; K3
    at 3 candidates, batch 16, forward and backward; the ``dna_l2`` train
    step at batch 16 with its peak memory and its rollout at batch 8 and 64;
    and the phase's wall time;
21. the training objectives: ``bair/ours_savp`` with ``learn_prior``,
    ``z_l1_weight``, the image and acvideo SN-GAN and SN-VAE-GAN weights and
    ``vgg_cdist_weight`` (phase 14's seeded VGG16 ``.npz``), "bair/ours_savp+
    objectives": ``train``'s ``main`` on phase 19's records (with their
    actions), full width, batch 16, TF32 convs, 3 steps and a resumed 4th,
    with every loss term (``kl``, ``z_l1``, ``vgg_cdist``, the GAN, VAE-GAN,
    feature-matching and discriminator terms of the six discriminators),
    finite, and phase 8's launches a step; ``evaluate`` (best of 8) and
    ``generate`` from its run directory with phase 19's checks; one train
    step GPU against CPU (TF32 off, ngf=8) of each objective alone under
    phase 9's rule (``z_l1``'s median leaf within 5e-4, measured, and read
    again beside the flagship's with PyTorch's own convs) and one
    ``learn_prior`` eval rollout within 1e-5; the train step at batch 16
    (median of 7) with its peak memory beside the flagship's, and the
    ``learn_prior`` rollout at batch 8 and 64 beside the flagship's, in
    turns; and the phase's wall time;
22. the port's benchmark (``python -m video_prediction_torch.bench``): first
    K1 and K3 (fp32) and K2 (bf16) forward at the shapes of its generation
    row (batch 64 x 4 samples = 256) against their plain versions under
    phase 3's tolerances, timed as phase 3 times them (K1 also against its
    yardstick); every kernel its train rows launch, at each row's doubled
    batch (32, 64, 128) in the row's dtype (K1 and K3 fp32, K2 bf16),
    forward against its plain version and backward against autograd of its
    plain version under phases 3 and 4's tolerances; one GPU train step of
    its batch-16 row's configuration
    (merged gate convs, bf16 compute and gates, ``scan_unroll=0``) at ngf=8
    against the CPU's under phase 17's rule; then its ``main`` at its
    defaults (train rows at batch 16, 32 and 64, the generation row), which
    prints its JSON line: each row's launches a train step (K1 11/11, K2
    66/66, K3 11/11) and finite losses, K2 launched only in bf16, ``mfu``
    and ``mfu_model`` in (0, 1], ``device_kind`` the ``nvidia-smi`` name,
    the generation row's launches a rollout and a finite ``acc``;
23. ``python -m video_prediction_torch.train.profile_step --model dna
    --model_hparams_dict hparams/bair/dna_l2/model_hparams.json --tf32`` at
    batch 16: a whole window (no ``shortfall``), finite losses, the trace
    kept under ``build/chip_smoke/profile_dna``, K3's device time and none
    of K1's; its top kernels and summary printed;
24. ``--steps_per_call 4``, K train steps as one CUDA graph
    (``train/step.py#MultiStep``), for the flagship at batch 16 (TF32 convs)
    and ``synthetic/ours_savp`` with bf16 gates (bf16 compute and gates,
    merged gate convs, batch 16): (a) 3 calls (the first eager, the second
    captured and replayed, the third replayed) against 12 eager steps from
    the same weights, batches, noise seed and Adams, with cuDNN's
    deterministic algorithms, every step's loss terms, each parameter leaf
    and each spectral ``u`` within ``SPC_SPREAD_RATIO`` times the spread of
    a second eager run plus ``SPC_FLOOR``; (b) each call's launches, the capture's taken out, 4
    times ``train_launches`` of the config (the flagship recomputes with
    ``remat`` ``full``, ``synthetic/ours_savp`` at ``scan_unroll=0`` does
    not) in the config's dtypes; (c) ms a step eager
    against graphed (and against a graph of one step) in turns, each one's
    busy share in a profiled window (the graphs' windows checked against the
    replays' launch counts), the capture time and each run's peak memory; (d) ``train``'s ``main`` with
    ``--steps_per_call 4 --max_steps 10`` (stops at 12), ``--resume`` to 16,
    its launches (16 steps and two GIF rollouts) and the event files read
    back with ``utils/summary.py#read_events``: the tags ``g_loss``, ``lr``,
    ``schedule_sampling_prob``, ``kl_weight`` and ``gen_images``;
25. data-parallel training over ``torch.distributed`` (``parallel/``, the
    train step's ``group``): (a) the flagship at batch 16 (TF32 convs,
    cuDNN's deterministic algorithms) through 3 calls of ``MultiStep(4)``
    under a 1-rank NCCL group (``file://`` rendezvous in ``build/``) against
    the same without a group: every loss term, leaf and ``u`` equal bit for
    bit, and the all-reduce inside the graph (the captured graph's nodes,
    from its DOT dump, are those of the graph without a group plus 4 times
    those of one ``all_reduce_mean_`` of the same tensors captured alone,
    which is also timed alone); the
    train CLI under ``torchrun --standalone --nproc_per_node 1
    --steps_per_call 4 --max_steps 8``, then ``--resume`` to 12: rank 0's
    option files, checkpoints and event files; (b) two processes on this
    card over gloo, global batch 16 (8 a rank), 3 steps, TF32 off and
    cuDNN's deterministic algorithms on both sides, against
    one process on the whole batch from the same weights, batches and noise
    seed under phase 9's rule (losses within 1e-4, the first step's median
    leaf gradient within 1e-4, every leaf within 1e-2, the parameters
    within Adam's bound), both ranks' parameters and ``u``s equal bit for
    bit, each rank's launches a step phase 8's; (c) where there are two
    cards, NCCL at world size 2, ``MultiStep(4)`` for 3 calls, with (b)'s
    checks (printed either way); (d) ms a step of the graph without a group
    against the 1-rank NCCL graph, in turns, each one's busy share, the
    all-reduce's device ms a step, and the gloo pair's ms a step (two
    processes sharing one card: no scaling figure).
26. spatial partitioning (``--spatial_shards``, ``parallel/spatial.py``):
    (a) two gloo processes on this card at dp1 x sp2 (each rank the 16
    samples' half of the rows), 3 steps of the flagship, TF32 off and
    cuDNN's deterministic algorithms, against phase 25 (b)'s one process
    under phase 25's ``dp_compare``, with the all-reduces a rank a step
    counted (calls and MB) and ms a step; (b) K1 on the halo-extended shard
    [32, 36, 64, 3] (and checked on 128 px's [32, 68, 128, 3]), K2 at the
    six (R, C) of H/2 in fp32 and bf16, K3 over 2048 pixels at batches 16
    and 32, forward and backward against their plain versions, timed as
    phases 3-4; (c) ``--spatial_shards 1`` in phase 25's ``torchrun`` run,
    its log's ``spatial axis: 1`` (k = 2 under NCCL needs two cards); (d)
    the peak memory allocated of each rank in (a) against the one process,
    and of ``kth/ours_savp_128`` (128 px, 20 frames), one step, at 8 in one
    process alone and as the gloo pair (at 16 alone: phase 28 (b));
27. a JAX run directory carried into the port (``tools/export_jax_run.py``
    where jax is, ``video_prediction_torch.convert`` here): (a) the JAX run
    of ``tests/fixtures/jax_run_small`` (32 px, small width, its step-3
    export, the batches and JAX step noise of steps 3-4 and JAX's losses of
    them) converted, resumed at K = 1 and under ``MultiStep(2)``, TF32 off
    and cuDNN's deterministic algorithms: g_loss and d_loss within phase
    9's 1e-4 of JAX's, Adam's steps at 5; (b) the full-width flagship's
    train state (``tests/fixtures/jax_state_shapes/``'s leaves filled from
    a seed at init scale, step and Adam counts 1000) converted, then
    ``generate`` and ``evaluate`` on the converted directory and
    ``train --resume --steps_per_call 4`` for one call: "resumed from step
    1000", finite losses, Adam's steps at 1004, phase 8's launches a step;
    the conversions' seconds and files' MB printed;
28. ``remat``, the generator cell recomputed in the backward pass
    (``models/savp.py#recomputes``): (a) one flagship train step at batch 16
    with ``remat`` off, ``full`` and ``names`` from the same weights, batch
    and noise, TF32 off and cuDNN's deterministic algorithms: the loss terms
    and gradient leaves of ``full`` and ``names`` under phase 9's rule
    against off, and each setting's launches exactly ``train_launches``
    (22 / 132 / 22 forward and 11 / 66 / 11 backward with recompute, 11 /
    66 / 11 each way without); (b) in a process of its own, the flagship and
    ``kth/ours_savp_128`` at batch 16, each setting, TF32 convs: ms a step
    and peak allocated MiB eagerly and as ``MultiStep(4)`` (kth only with
    ``full`` graphed: its graph without recompute needs nearly the card;
    every recomputing run must fit the card; off may not); (c)
    ``MultiStep(4)`` with ``names`` against eager steps under phase 24's
    rule (phase 24 holds the flagship's ``full``), with its launches;
29. checkpoints kept per step (``train/checkpoint.py``): (a) ``train``'s
    ``main`` at the flagship's full width, batch 16, ``--save_freq 1`` for
    4 steps: four saves, each timed (seconds and MB), the final save of a
    kept step writing nothing, the newest three steps kept and whole; (b)
    ``python -m video_prediction_torch.train --save_freq 2`` killed with
    SIGKILL once its first step is kept, then ``--resume``d 2 steps from the
    newest kept step in this process, TF32 off and cuDNN's deterministic
    algorithms: its train state (parameters, buffers, both Adams, the noise
    generator) and losses equal that step's state taken the same steps by
    hand on the fresh stream's first batches, bit for bit; (c)
    ``generate`` and ``evaluate`` from (a)'s run directory at the newest
    and the oldest kept step (``--checkpoint_step``), each restoring the
    step it prints; (d) phase 20's ``dna_l2`` train step GPU against CPU
    again, its median leaf printed beside ``Z_L1_GRAD_MEDIAN_TOL`` (the
    norms keep the two-pass variance: flax's E[x^2] - E[x]^2 failed phases
    20 and 21's gates, ``ROADMAP.md`` queue 3).

The line before the last is ``{"kernels": [...]}``, one entry per kernel
at the train step's shapes (the forward kernels' at the generation shapes
under ``"generation"``, and at the evaluate shapes, with phase 11's
launches, under ``"evaluate"``), and ``composite_k3``: K3 at 3 candidates
and batch 16 with phase 20's ``dna`` launches and its backward under
``"backward"``; K2's times are per generator step of six calls. Its
fields:

- ``launches``: launches in phase 8's four train steps; ``launches_per_train_step``
  and ``launches_per_rollout`` (a no-grad rollout of 11 generator steps);
  ``remat``: phase 28 (a)'s ``launches_per_train_step`` by setting;
  ``objectives``: ``launches`` in phase 21's four train steps and
  ``launches_per_train_step``;
- ``max_abs_err``: fp32 kernel against plain version;
- ``device_ms``: the kernel's own device time per call (K2: per step), the
  durations of its device events (the backward with its reduce kernel) from
  ``torch.profiler`` with device activity only, over 20 calls after warm-up
  (a session that lost device records is run again, up to five in all; if
  none is whole, CUDA events around 20 calls queued behind a sleep kernel;
  a line before the ``nvidia-smi`` line lists both);
- ``ms`` and ``plain_ms``: CUDA events around back-to-back Python calls of
  the kernel's wrapper and of its plain version, so paced by the host for the
  smaller kernels;
- ``bytes``, ``bound_ms``, ``bound_by``, ``share_of_bound``: each input read
  once and each output written once, over 3.35e12 B/s (or the operations over
  the fp32 rate, whichever is larger; ``kernels/roofline.py``), and
  ``bound_ms / device_ms``;
- ``library_ms``: the device time of the one PyTorch call that computes the
  same function on the same inputs, where there is one (K1: a grouped
  ``F.conv2d`` and its ``convolution_backward``, TF32 off, inputs laid out
  beforehand), else null;
- K2's forward and backward entries also have ``"bfloat16"``: K2 on bf16
  z and c at the bf16 model's shapes (forward at the generation batch 8,
  the rollout batch 64 and the train step's doubled batch 128; backward at
  128), each with ``device_ms`` (a step of six calls; ``per_width_ms`` a
  call at each width), ``ms`` and ``plain_ms`` (a step, as above),
  ``bytes``, ``bound_ms``, ``share_of_bound`` and ``max_abs_err`` against
  the plain version, and ``launches`` (phase 17's three train steps);
- ``data_parallel``: phase 25's ``launches_per_rank_per_step``, (a)'s
  ``bitwise``, (d)'s ``graph_ms`` and ``nccl1_graph_ms`` (in turns),
  ``graph_busy_share`` and ``nccl1_busy_share``, ``allreduce_device_ms``
  (one ``all_reduce_mean_`` of a step's gradients and scalars, alone),
  ``allreduce_mb`` and ``allreduce_device_ops`` (its graph nodes), ``gloo_pair_ms`` beside
  ``gloo_one_process_ms`` (steps 2-3), ``gloo_figures`` ((b)'s loss,
  gradient and parameter figures) and ``nccl_world2`` ((c)'s, or null);
- ``spatial``: phase 26's, on each of the six: (b)'s figures at the
  shard's shapes (``shapes``, ``max_abs_err``, ``ms``, ``plain_ms``,
  ``device_ms``, ``bytes``, ``bound_ms``, ``bound_by``, ``share_of_bound``,
  ``library_ms``; K3 forward's ``batches`` 16 and 32), (a)'s
  ``launches_per_rank_per_step``, ``figures`` (``dp_compare``'s),
  ``collectives_per_rank_step`` and ``rank_ms``, and (d)'s
  ``flagship_peak_mib`` and ``kth128``;
- ``steps_per_call``: phase 24's, by config (``launches_per_step``, the
  ``dtype``, ``eager_ms``, ``graph_ms`` and ``graph1_ms`` a step in turns) and
  ``cli_launches``, the launches of its CLI run;
- ``bench``: ``launches`` in phase 22's run of the bench (3 x 2 x 30 or 20
  timed steps, and the steps around them, and 31 rollouts of 256),
  ``max_abs_err_by_row_batch`` (the largest error against the plain version
  at each train row's doubled batch) and, for
  the forward kernels, the batch-256 figures of phase 22 (``shapes``,
  ``max_abs_err``, ``ms``, ``plain_ms``, ``device_ms``, ``bytes``,
  ``bound_ms``, ``bound_by``, ``share_of_bound``, ``library_ms``; K2 bf16 a
  step of six calls, with ``per_width_ms``).

The line before it is the ``nvidia-smi`` identity, and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 8
EVAL_BATCH = 64  # evaluate's defaults: 8 examples x 8 stochastic samples in one rollout
TRAIN_BATCH = 16  # the flagship's batch; the train step's rollout runs on 2 x 16 (prior and posterior)
# (tolerance on |kernel - plain|: atol + rtol * |plain|)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# d kernels and d ln_params sum H*W*C = 12288 or R (up to 131072) terms in
# another order than autograd: atol 1e-4 of the largest reference value
REDUCTION_RTOL = 1e-4
# kernel launches in one rollout of 11 generator steps (12 frames)
LAUNCHES_PER_ROLLOUT = {"apply_cdna_kernels": 11, "fused_ln_gate": 66, "composite": 11}
BACKWARD = {"apply_cdna_kernels_backward": "apply_cdna_kernels", "fused_ln_gate_backward": "fused_ln_gate",
            "composite_backward": "composite"}


def train_launches(hp, steps: int = 1, per_rollout: dict = LAUNCHES_PER_ROLLOUT) -> dict:
    """Kernel launches of ``steps`` train steps of the model of ``hp``: one
    rollout a step forward (of the doubled batch, where there is one), run
    again in the backward pass where the cell is recomputed
    (``models/savp.py#recomputes``: ``remat`` and (``scan_unroll != 0`` or
    ``remat_prevent_cse``)), and one rollout's backward kernels."""
    from video_prediction_torch.models.savp import recomputes

    forward = 2 if recomputes(hp) else 1
    want = {k: n * forward * steps for k, n in per_rollout.items()}
    want.update({k: per_rollout[fwd] * steps for k, fwd in BACKWARD.items()})
    return want
# |GPU - CPU| of the metrics on the same frames: PSNR in dB (TF32 on: the
# SSIM filter is fp32 regardless), SSIM; VGG cosine and LPIPS with TF32 off
METRIC_TOL = {"psnr": 1e-4, "ssim": 1e-5, "perceptual": 1e-5}
# |GPU - CPU| on gen_images in [0, 1]: fp32 with TF32 off, but sums in
# other orders through 11 recurrent steps; 1e-3 is a quarter of one 8-bit
# gray level of the written GIFs
ROLLOUT_TOL = 1e-3
# GPU vs CPU train step at fp32 with TF32 off: losses through one doubled
# rollout and the discriminators. Gradients: the median leaf within 1e-4 of
# its max |g|; every leaf within 1e-2 of its max |g| plus 1e-5 of the model's
# largest. Measured on an H100 at ngf=8: median 1e-5, worst 5.8e-3
# (down1_norm.bias; the instance norm after the first downsampling
# amplifies rounding, and PyTorch's own non-cuDNN convs give 2.6e-3 on other
# leaves), and the conv biases in front of an instance norm have gradient 0
# up to the floor.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL, TRAIN_GRAD_MEDIAN_TOL, TRAIN_GRAD_FLOOR = 1e-2, 1e-4, 1e-5
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")
TRAIN_STEPS = 4  # phase 8: 3 steps, then a resumed 4th
BF16_TRAIN_STEPS = 3  # phase 17: 2 steps, then a resumed 3rd
# the dtype each kernel runs in, in the bf16 model: fp32 images, CDNA kernels
# and (exactly cast) mask logits; bf16 ConvLSTM gates and states
BF16_MODEL_DTYPES = {"apply_cdna_kernels": "float32", "fused_ln_gate": "bfloat16", "composite": "float32",
                     "apply_cdna_kernels_backward": "float32", "fused_ln_gate_backward": "bfloat16",
                     "composite_backward": "float32"}
# the rule for bf16 against the plain versions: max|GPU bf16 - CPU bf16| at
# most BF16_RATIO times max|CPU bf16 - CPU fp32|, from the same weights
BF16_RATIO = 2.0
# phase 17's train step, each loss term and each gradient leaf on its own:
# the terms by BF16_RATIO (the GAN terms plus one bf16 ulp of their logit,
# ``term_floor``), the leaves
# by BF16_GRAD_RATIO plus one bf16 rounding of the leaf's largest fp32 entry
# (tests/test_torch_bf16.py holds the CPU step to the JAX one by the same rule)
BF16_GRAD_RATIO = 4.0
BF16_ROUNDING = 2.0**-8
BF16_STEP_SEEDS = (17, 27)  # two witnesses: weights, batch and noise from each


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed nothing")
    return out.splitlines()[0].strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def roofline(entry: dict, bytes_and_ops) -> dict:
    """Add the bytes, the bound and what sets it (``kernels/roofline.py``),
    and the device time's share of the bound, to a kernel entry."""
    from video_prediction_torch.kernels import roofline as RL

    nbytes, ops = bytes_and_ops
    entry.update(bytes=nbytes, bound_ms=RL.bound_ms(nbytes, ops), bound_by=RL.bound_by(nbytes, ops))
    entry["share_of_bound"] = entry["bound_ms"] / entry["device_ms"]
    return entry


def timing_line(label: str, e: dict) -> str:
    lib = f", library {e['library_ms']:.4f}" if e.get("library_ms") is not None else ""
    return (f"{label}: device {e['device_ms']:.4f} ms (bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
            f"{100 * e['share_of_bound']:.1f}% of it){lib}; host-paced kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms")


class NoTF32:
    """cuDNN's and cuBLAS's TF32 off inside, restored after."""

    def __enter__(self):
        self.flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.flags


def cdna_as_grouped_conv(image, kern):
    """K1's inputs laid out for one grouped ``F.conv2d`` (the library
    yardstick): x ``[1, B*C, H, W]`` and w ``[B*C*N, 1, kh, kw]``, each
    sample's N kernels repeated over its C channels."""
    b, h, w, c = image.shape
    _, kh, kw, n = kern.shape
    x = image.permute(0, 3, 1, 2).reshape(1, b * c, h, w).contiguous()
    wt = kern.permute(0, 3, 1, 2)[:, None].expand(b, c, n, kh, kw).reshape(b * c * n, 1, kh, kw).contiguous()
    return x, wt


def cdna_library_forward(x, wt, groups: int):
    return torch.nn.functional.conv2d(x, wt, padding=(wt.shape[2] - 1) // 2, groups=groups)


def cdna_library_backward(go, x, wt, groups: int):
    """d x and d w of the grouped conv: one ``convolution_backward`` call."""
    pad = [(wt.shape[2] - 1) // 2, (wt.shape[3] - 1) // 2]
    return torch.ops.aten.convolution_backward(go, x, wt, None, [1, 1], pad, [1, 1], False, [0, 0], groups,
                                               [True, True, False])[:2]


def max_err(out, ref, dtype_name: str):
    """(max |out - ref|, whether every element is within the tolerance)."""
    atol, rtol = TOL[dtype_name]
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool(((diff <= atol + rtol * ref.abs()) & torch.isfinite(out)).all())
    return float(diff.max()), ok


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts one element past a 16-byte
    boundary (a view with storage offset 1)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0, "could not make an unaligned view")
    return view


def kernel_phase(dev, batch: int, composite_ks=(7,)) -> list:
    """Phase 3: every forward kernel against its plain version, fp32 and
    bf16, at the shapes a rollout at ``batch`` gives it (K3 with each
    candidate count of ``composite_ks``: 7 for ``ours_savp``, 6 for ``sv2p``)."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import device_ms, ln_inputs

    g = torch.Generator(device=dev).manual_seed(batch)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
    results = []

    # K1 ------------------------------------------------------------------
    image = rand(batch, 64, 64, 3)
    kern = torch.softmax(randn(batch, 25, 4), dim=1).reshape(batch, 5, 5, 4).contiguous()
    shapes = f"[{batch},64,64,3]x[{batch},5,5,4]"
    errs = {}
    for dt in ("float32", "bfloat16"):
        img = image.to(getattr(torch, dt))
        err, ok = max_err(K.apply_cdna_kernels(img, kern), K.apply_cdna_kernels_reference(img, kern), dt)
        print(f"K1 apply_cdna_kernels {dt} {shapes}: max_abs_err {err:.3g} (tol {TOL[dt]})")
        check(ok, f"K1 {dt} {shapes} disagrees with its plain version: {err}")
        errs[dt] = err
    entry = dict(
        name="apply_cdna_kernels", route="cuda", source="video_prediction_torch/kernels/csrc/cdna.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:82", shapes=shapes, max_abs_err=errs["float32"],
        ms=cuda_ms(lambda: K.apply_cdna_kernels(image, kern)),
        plain_ms=cuda_ms(lambda: K.apply_cdna_kernels_reference(image, kern)),
        device_ms=device_ms(lambda: K.apply_cdna_kernels(image, kern), "K1"),
    )
    # the yardstick: one grouped conv (TF32 off), checked to be the same function first
    x, wt = cdna_as_grouped_conv(image, kern)
    with NoTF32():
        lib = cdna_library_forward(x, wt, batch * 3).view(batch, 3, 4, 64, 64).permute(0, 2, 3, 4, 1)
        err, ok = max_err(lib, K.apply_cdna_kernels(image, kern), "float32")
        print(f"K1 yardstick F.conv2d(groups={batch * 3}) vs the kernel, fp32: max_abs_err {err:.3g}")
        check(ok, f"K1's grouped-conv yardstick disagrees with K1 at batch {batch}: {err}")
        entry["library_ms"] = device_ms(lambda: cdna_library_forward(x, wt, batch * 3))
    results.append(roofline(entry, RL.cdna_forward(batch, 64, 64, 3)))
    print(timing_line(f"K1 per call (1 call per step), fp32, batch {batch}", entry))

    # K2 ------------------------------------------------------------------
    errs = {"float32": 0.0, "bfloat16": 0.0}
    per_width = {}
    step_shapes = [(cdim, batch * px * px) for cdim, px in sorted(set(RL.LN_GATE_STEP))]
    for cdim, r in step_shapes + [(8, 77), (40, 77), (300, 1000)]:
        z, c, lnp, _, _ = ln_inputs(g, r, cdim, dev)
        for dt in ("float32", "bfloat16"):
            zz, cc = z.to(getattr(torch, dt)), c.to(getattr(torch, dt))
            for label, (za, ca) in (("", (zz, cc)), (", unaligned", (unaligned(zz), unaligned(cc)))):
                out = K.fused_ln_gate(za, ca, lnp)
                ref = K.fused_ln_gate_reference(za, ca, lnp)
                check(out[0].dtype == cc.dtype and out[1].dtype == cc.dtype, "K2 output dtype must follow c")
                again = K.fused_ln_gate(za, ca, lnp)
                check(all(torch.equal(a, b) for a, b in zip(out, again)),
                      f"K2 {dt} C={cdim}{label} is not deterministic")
                e0, ok0 = max_err(out[0], ref[0], dt)
                e1, ok1 = max_err(out[1], ref[1], dt)
                print(f"K2 fused_ln_gate {dt} R={r} C={cdim}{label}: max_abs_err c {e0:.3g} h {e1:.3g} "
                      f"(tol {TOL[dt]}); bitwise equal twice")
                check(ok0 and ok1, f"K2 {dt} C={cdim}{label} disagrees with its plain version: {e0}, {e1}")
                if (cdim, r) in step_shapes and not label:
                    errs[dt] = max(errs[dt], e0, e1)
        if (cdim, r) not in step_shapes:
            continue
        per_width[cdim] = (
            cuda_ms(lambda: K.fused_ln_gate(z, c, lnp)),
            cuda_ms(lambda: K.fused_ln_gate_reference(z, c, lnp)),
            device_ms(lambda: K.fused_ln_gate(z, c, lnp), "K2"),
        )
        print(f"K2 per call C={cdim} R={r}, fp32: device {per_width[cdim][2]:.4f} ms (bound "
              f"{RL.bound_ms(*RL.ln_gate_forward([(r, cdim)])):.4f} ms); host-paced kernel "
              f"{per_width[cdim][0]:.4f} ms, plain {per_width[cdim][1]:.4f} ms")
    ms, plain_ms, dms = (sum(per_width[cdim][j] for cdim, _ in RL.LN_GATE_STEP) for j in range(3))
    entry = dict(
        name="fused_ln_gate", route="cuda", source="video_prediction_torch/kernels/csrc/ln_gate.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:145",
        shapes=f"R={', '.join(str(batch * px * px) for _, px in sorted(set(RL.LN_GATE_STEP)))} at "
               f"C={', '.join(str(c) for c, _ in sorted(set(RL.LN_GATE_STEP)))}, 6 calls a step",
        max_abs_err=errs["float32"], ms=ms, plain_ms=plain_ms, device_ms=dms, library_ms=None,
    )
    results.append(roofline(entry, RL.ln_gate_forward(RL.ln_gate_step(batch))))
    print(timing_line(f"K2 per generator step (6 calls), fp32, batch {batch}", entry))

    # K3 ------------------------------------------------------------------
    # each candidate count's compile-time instantiation (aligned tensors),
    # and the run-time one (the same shape one element past a 16-byte
    # boundary, and 33x31 with 16 candidates)
    from video_prediction_torch.kernels.composite import STAGED, device_plan

    errs = {"float32": 0.0, "bfloat16": 0.0}
    for k, h, w in [(k, 64, 64) for k in composite_ks] + [(16, 33, 31)]:
        cand = rand(batch, k, h, w, 3)
        logits = randn(batch, h, w, k) * 3.0
        for dt in ("float32", "bfloat16"):
            cd, lg = cand.to(getattr(torch, dt)), logits.to(getattr(torch, dt))
            ref, ref_masks = K.composite_reference(cd, lg, with_masks=True)
            for label, (ca, la) in (("", (cd, lg)), (", unaligned", (unaligned(cd), unaligned(lg)))):
                p = device_plan(ca, la)
                want = k if (k, 3) in STAGED and (h, w) == (64, 64) and not label else 0
                check(p.staged == want, f"K3 {dt} [{batch},{k},{h},{w},3]{label}: plan {p}, want staged={want}")
                out, masks = K.composite(ca, la, with_masks=True)
                again, no_masks = K.composite(ca, la)
                check(no_masks is None and torch.equal(again, out), f"K3 {dt} K={k}{label} is not deterministic")
                e0, ok0 = max_err(out, ref, dt)
                e1, ok1 = max_err(masks, ref_masks, "float32")
                inst = f"compile-time K={p.staged}" if p.staged else "run-time"
                print(f"K3 composite {dt} [{batch},{k},{h},{w},3]{label} ({inst}, tile {p.tile}, {p.blocks} "
                      f"blocks): max_abs_err out {e0:.3g} masks {e1:.3g} (tol {TOL[dt]}); bitwise equal twice")
                check(ok0 and ok1, f"K3 {dt} with {k} candidates{label} disagrees with its plain version: {e0}, {e1}")
                if (h, w) == (64, 64) and not label:
                    errs[dt] = max(errs[dt], e0, e1)
    cand = rand(batch, 7, 64, 64, 3)
    logits = randn(batch, 64, 64, 7) * 3.0
    entry = dict(
        name="composite", route="cuda", source="video_prediction_torch/kernels/csrc/composite.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:198",
        shapes=" and ".join(f"[{batch},{k},64,64,3]" for k in composite_ks) + " (timed at 7)",
        max_abs_err=errs["float32"], ms=cuda_ms(lambda: K.composite(cand, logits)),
        plain_ms=cuda_ms(lambda: K.composite_reference(cand, logits)),
        device_ms=device_ms(lambda: K.composite(cand, logits), "K3"), library_ms=None,
    )
    results.append(roofline(entry, RL.composite_forward(batch, 7)))
    print(timing_line(f"K3 per call (1 call per step), fp32, batch {batch}", entry))
    return results


def plain_grads(reference, inputs, grads):
    """Autograd of the plain version in fp32 on the inputs' values, rounded
    once to the inputs' dtypes (for bf16 the plain version's own autograd
    rounds each tap's or gate's gradient to bf16 at its ``.float()`` casts
    before summing; the kernels sum in fp32)."""
    from video_prediction_torch.kernels._lib import plain_vjp

    out = plain_vjp(reference, [x.float() for x in inputs], [g.float() for g in grads])
    return [o.to(x.dtype) for o, x in zip(out, inputs)]


def reduction_err(out, ref):
    """(max |out - ref|, ok) for a reduction output: atol REDUCTION_RTOL of max |ref|."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    tol = REDUCTION_RTOL * float(ref.abs().max()) + REDUCTION_RTOL * ref.abs()
    return float(diff.max()), bool(((diff <= tol) & torch.isfinite(out)).all())


def plain_backward_ms(reference, inputs, grads) -> float:
    """Device time of the plain version's backward alone: autograd over one
    recorded graph, kept for the repeats."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    outs = reference(*leaves)
    return cuda_ms(lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True), iters=20)


def backward_phase(dev) -> list:
    """Phase 4: every backward kernel against autograd of its plain version,
    fp32 and bf16, at the train step's shapes and at odd shapes."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import device_ms, ln_inputs

    g = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
    b2 = 2 * TRAIN_BATCH
    results = []

    def compare(name, outs, refs, kinds, dt, label):
        errs = []
        for out, ref, kind in zip(outs, refs, kinds):
            err, ok = reduction_err(out, ref) if kind == "sum" else max_err(out, ref, dt)
            check(ok, f"{name} {dt} {label}: output {len(errs)} disagrees with plain autograd: {err}")
            errs.append(err)
        print(f"{name} {dt} {label}: max_abs_err {', '.join(f'{e:.3g}' for e in errs)} "
              f"(tol {TOL[dt]}; reductions {REDUCTION_RTOL} of max)")
        return max(errs)

    # K1 backward ---------------------------------------------------------
    err32 = 0.0
    for (b, h, w, c, k, n) in [(b2, 64, 64, 3, 5, 4), (3, 37, 23, 2, 3, 5)]:
        image = rand(b, h, w, c)
        kern = torch.softmax(randn(b, k * k, n), dim=1).reshape(b, k, k, n).contiguous()
        grad = randn(b, n, h, w, c)
        for dt in ("float32", "bfloat16"):
            img, gr = image.to(getattr(torch, dt)), grad.to(getattr(torch, dt))
            e = compare("K1 backward", K.apply_cdna_kernels_backward(img, kern, gr),
                        plain_grads(K.apply_cdna_kernels_reference, (img, kern), (gr,)), ("elem", "sum"), dt,
                        f"[{b},{h},{w},{c}]x[{b},{k},{k},{n}]")
            if dt == "float32" and b == b2:
                err32 = e
    image, kern, grad = rand(b2, 64, 64, 3), torch.softmax(randn(b2, 25, 4), 1).reshape(b2, 5, 5, 4), randn(b2, 4, 64, 64, 3)
    entry = dict(
        name="apply_cdna_kernels_backward", route="cuda", source="video_prediction_torch/kernels/csrc/cdna.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:82", shapes=f"[{b2},64,64,3]x[{b2},5,5,4]",
        max_abs_err=err32, ms=cuda_ms(lambda: K.apply_cdna_kernels_backward(image, kern, grad)),
        plain_ms=plain_backward_ms(K.apply_cdna_kernels_reference, (image, kern), (grad,)),
        device_ms=device_ms(lambda: K.apply_cdna_kernels_backward(image, kern, grad), "K1"),
    )
    # the yardstick: one convolution_backward of the grouped conv (TF32 off),
    # checked against K1 backward first (d kernels summed over C, untimed)
    first, second = (K.apply_cdna_kernels_backward(image, kern, grad) for _ in range(2))
    check(all(torch.equal(a, b) for a, b in zip(first, second)), "K1 backward is not deterministic")
    x, wt = cdna_as_grouped_conv(image, kern)
    go = grad.permute(0, 4, 1, 2, 3).reshape(1, b2 * 3 * 4, 64, 64).contiguous()
    with NoTF32():
        gx, gw = cdna_library_backward(go, x, wt, b2 * 3)
        d_image, d_kern = K.apply_cdna_kernels_backward(image, kern, grad)
        e0, ok0 = max_err(gx.view(b2, 3, 64, 64).permute(0, 2, 3, 1), d_image, "float32")
        e1, ok1 = reduction_err(gw.view(b2, 3, 4, 5, 5).sum(1).permute(0, 2, 3, 1), d_kern)
        print(f"K1 backward yardstick convolution_backward(groups={b2 * 3}) vs the kernel, fp32: max_abs_err "
              f"d image {e0:.3g}, d kernels {e1:.3g}")
        check(ok0 and ok1, f"K1 backward's yardstick disagrees with the kernel: {e0}, {e1}")
        entry["library_ms"] = device_ms(lambda: cdna_library_backward(go, x, wt, b2 * 3))
    results.append(roofline(entry, RL.cdna_backward(b2, 64, 64, 3)))
    print(timing_line(f"K1 backward per call (1 call per step), fp32, batch {b2}", entry))

    # K2 backward ---------------------------------------------------------
    err32, per_width = 0.0, {}
    train_shapes = {(cdim, b2 * px * px) for cdim, px in RL.LN_GATE_STEP}
    for cdim, r in sorted(train_shapes) + [(8, 77), (40, 77), (300, 1000)]:
        z, c, lnp, dcn, dhn = ln_inputs(g, r, cdim, dev)
        for dt in ("float32", "bfloat16"):
            zz, cc, d1, d2 = (x.to(getattr(torch, dt)) for x in (z, c, dcn, dhn))
            ref = plain_grads(K.fused_ln_gate_reference, (zz, cc, lnp), (d1, d2))
            e = compare("K2 backward", K.fused_ln_gate_backward(zz, cc, lnp, d1, d2), ref, ("elem", "elem", "sum"),
                        dt, f"R={r} C={cdim}")
            if dt == "float32" and (cdim, r) in train_shapes:
                err32 = max(err32, e)
            views = [unaligned(x) for x in (zz, cc, d1, d2)]
            compare("K2 backward", K.fused_ln_gate_backward(views[0], views[1], lnp, *views[2:]), ref,
                    ("elem", "elem", "sum"), dt, f"R={r} C={cdim}, unaligned")
        if (cdim, r) in train_shapes:
            run = lambda: K.fused_ln_gate_backward(z, c, lnp, dcn, dhn)  # noqa: E731
            first, second = run(), run()
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"K2 backward at R={r} C={cdim} is not deterministic")
            per_width[cdim] = (cuda_ms(run, iters=20),
                               plain_backward_ms(K.fused_ln_gate_reference, (z, c, lnp), (dcn, dhn)),
                               device_ms(run, "K2"))
            print(f"K2 backward per call C={cdim} R={r}, fp32: device {per_width[cdim][2]:.4f} ms (bound "
                  f"{RL.bound_ms(*RL.ln_gate_backward([(r, cdim)])):.4f} ms); host-paced kernel "
                  f"{per_width[cdim][0]:.4f} ms, plain {per_width[cdim][1]:.4f} ms; bitwise equal twice")
    ms, plain_ms, dms = (sum(per_width[cdim][j] for cdim, _ in RL.LN_GATE_STEP) for j in range(3))
    entry = dict(
        name="fused_ln_gate_backward", route="cuda", source="video_prediction_torch/kernels/csrc/ln_gate.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:145",
        shapes=f"R={', '.join(str(r) for _, r in sorted(train_shapes))} at "
               f"C={', '.join(str(c) for c, _ in sorted(train_shapes))}, 6 calls a step",
        max_abs_err=err32, ms=ms, plain_ms=plain_ms, device_ms=dms, library_ms=None,
    )
    results.append(roofline(entry, RL.ln_gate_backward(RL.ln_gate_step(b2))))
    print(timing_line(f"K2 backward per generator step (6 calls), fp32, batch {b2}", entry))

    # K3 backward ---------------------------------------------------------
    def composite_image(a, m):
        return K.composite_reference(a, m)[0]

    err32 = 0.0
    for (b, k, h, w, c) in [(b2, 7, 64, 64, 3), (b2, 3, 64, 64, 3), (3, 5, 17, 19, 1)]:
        cand, logits, grad = rand(b, k, h, w, c), randn(b, h, w, k) * 3.0, randn(b, h, w, c)
        for dt in ("float32", "bfloat16"):
            cd, lg, gr = (x.to(getattr(torch, dt)) for x in (cand, logits, grad))
            e = compare("K3 backward", K.composite_backward(cd, lg, gr),
                        plain_grads(composite_image, (cd, lg), (gr,)), ("elem", "elem"), dt, f"[{b},{k},{h},{w},{c}]")
            if dt == "float32" and (b, k) == (b2, 7):
                err32 = e
    cand, logits, grad = rand(b2, 7, 64, 64, 3), randn(b2, 64, 64, 7) * 3.0, randn(b2, 64, 64, 3)
    entry = dict(
        name="composite_backward", route="cuda", source="video_prediction_torch/kernels/csrc/composite.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:198", shapes=f"[{b2},7,64,64,3], [{b2},64,64,7]",
        max_abs_err=err32, ms=cuda_ms(lambda: K.composite_backward(cand, logits, grad)),
        plain_ms=plain_backward_ms(composite_image, (cand, logits), (grad,)),
        device_ms=device_ms(lambda: K.composite_backward(cand, logits, grad), "K3"), library_ms=None,
    )
    results.append(roofline(entry, RL.composite_backward(b2, 7)))
    print(timing_line(f"K3 backward per call (1 call per step), fp32, batch {b2}", entry))
    return results


def slice_hparams():
    """``savp`` defaults overridden by the ``ours_savp`` zoo file, as
    ``scripts/train.py`` resolves them: 64x64, ngf=32, nz=8, 12 frames."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class

    zoo = zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo))
    check((hp.ngf, hp.nz, hp.sequence_length, hp.context_frames) == (32, 8, 12, 2), f"unexpected slice config {hp}")
    return hp


def synthetic_batch(batch_size: int, seed: int, device):
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset
    from video_prediction_torch.generate import batch_to_device

    return batch_to_device(next(SyntheticVideoDataset(mode="test", seed=seed).make_iterator(batch_size)), device)


def generate_phase():
    """Phase 4: ``video_prediction_torch.generate`` on a run directory with
    seeded flax-like random weights; returns the model and the launch counts."""
    import shutil

    from video_prediction_torch import generate
    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import DatasetHparams
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.checkpoint import write_run_dir

    hp = slice_hparams()
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)  # synthetic: 4 action dims
    model.init_weights(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    run_dir, results = os.path.join(WORK_DIR, "run"), os.path.join(WORK_DIR, "results")
    write_run_dir(run_dir, "savp", "synthetic", hp, DatasetHparams(context_frames=2, sequence_length=12), model)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = generate.main([
        "--checkpoint", run_dir, "--results_dir", results, "--device", "cuda",
        "--batch_size", "8", "--num_samples", "16", "--num_stochastic_samples", "2",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    rollouts = summary["rollouts"]
    gifs = [f for f in os.listdir(summary["out_dir"]) if f.endswith(".gif")]
    print(f"generate: {n_params} params, {rollouts} rollouts, {len(gifs)} GIFs, {wall:.2f} s wall "
          f"(build, restore and first-call set-up included); launches {launches}")
    check(rollouts == 4 and summary["gifs"] == 32 and len(gifs) == 32, f"unexpected generate summary {summary}")
    check(summary["all_finite"], "generate produced non-finite values")
    want = {k: n * rollouts for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})  # no-grad rollouts: no backward
    check(launches == want, f"kernel launches {launches}, want {want} ({rollouts} rollouts)")
    return model, launches


def cpu_vs_gpu_phase(cpu_model, gpu_model, dev) -> None:
    """Phase 5: the same weights, batch and z through the plain versions on
    the CPU and the kernels on the GPU, fp32 with TF32 off, batch 2."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_batch(2, seed=1, device="cpu")
    z = torch.randn(2, 11, 8, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = cpu_model(batch, zs_prior=z)["gen_images"]
        out = gpu_model({k: v.to(dev) for k, v in batch.items()}, zs_prior=z.to(dev))["gen_images"].cpu()
    err = float((out - ref).abs().max())
    print(f"rollout GPU vs CPU, batch 2, fp32 (TF32 off): max_abs_err {err:.3g} (tol {ROLLOUT_TOL}), "
          f"gen_images mean {float(ref.mean()):.4f} std {float(ref.std()):.4f}")
    check(bool(torch.isfinite(out).all()), "GPU rollout is not finite")
    check(err <= ROLLOUT_TOL, f"GPU rollout differs from the CPU rollout by {err}")


def timing_phase(gpu_model, dev, ident: str) -> None:
    """Phase 6: no-grad rollout time with CUDA events after warm-up."""
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for bsz in (8, 64):
            batch = synthetic_batch(bsz, seed=2, device=dev)
            z = torch.randn(bsz, 11, 8, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
            with torch.inference_mode():
                ms = cuda_ms(lambda: gpu_model(batch, zs_prior=z), iters=10, warmup=3)
            frames = bsz * 10  # predicted frames per rollout (T - context_frames), as bench_generate counts
            print(f"rollout batch {bsz}, {'TF32 convs' if tf32 else 'fp32 (TF32 off)'}: {ms:.2f} ms, "
                  f"{frames / ms * 1e3:.0f} generated frames/s [{ident}]")


def ptxas_phase(report) -> None:
    """Phase 2, after the build: registers and spills of every kernel
    instantiation, from ptxas's report; no K1, K2 or K3 kernel may spill."""
    check(bool(report), "ptxas reported no kernels")
    for name, regs, spill_st, spill_ld in report:
        print(f"ptxas: {regs:3d} registers, spills {spill_st}/{spill_ld} bytes (stores/loads): {name[:150]}")
    for group, stem in (("K1", "cdna_"), ("K2", "ln_gate_"), ("K3", "composite_")):  # mangled or demangled
        rebuilt = [r for r in report if stem in r[0]]
        check(bool(rebuilt), f"no {group} kernels in ptxas's report")
        spilling = [r for r in rebuilt if r[2] or r[3]]
        check(not spilling, f"{group} kernels spill: {spilling}")
        print(f"ptxas: the {len(rebuilt)} {group} kernels spill nothing, at most {max(r[1] for r in rebuilt)} "
              f"registers ({', '.join(f'{r[1]}' for r in rebuilt)})")
    print(f"ptxas: {len(report)} kernels")


def train_phase(init_seed: int = 0) -> dict:
    """Phase 8: ``python -m video_prediction_torch.train``'s ``main`` at full
    width, batch 16: 3 steps, then ``--resume`` for a 4th; returns the
    launch counts of the 4 steps."""
    import shutil

    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.train.checkpoint import PARAMS_FILE, checkpoint_file

    run_dir = os.path.join(WORK_DIR, "train")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--dataset", "synthetic", "--model", "savp",
            "--model_hparams_dict", str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
            "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
            "--progress_freq", "1", "--save_freq", "1000", "--seed", str(init_seed)]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_main(argv + ["--max_steps", "3"])
    resumed = train_main(argv + ["--max_steps", "4", "--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    print(f"train: 3 steps then a resumed 4th, {wall:.2f} s wall (set-up, checkpoints and the first steps "
          f"included); last losses {resumed['scalars']}; launches {launches}")
    check(first["all_finite"] and resumed["all_finite"], "train produced non-finite losses")
    check((first["start_step"], first["step"]) == (0, 3), f"unexpected first run {first}")
    check((resumed["start_step"], resumed["step"]) == (3, 4), f"the resumed run did not continue at step 3: {resumed}")
    # one doubled-batch rollout a step, again in the backward pass (remat), and its backward
    want = train_launches(slice_hparams(), TRAIN_STEPS)
    check(launches == want, f"kernel launches {launches}, want {want} ({TRAIN_STEPS} train steps)")

    from video_prediction_torch.models import get_model_class

    trained = torch.load(checkpoint_file(run_dir, PARAMS_FILE), weights_only=True)
    init = get_model_class("savp")(slice_hparams(), image_shape=(64, 64, 3), action_dim=4)
    init.init_weights(torch.Generator().manual_seed(init_seed))
    start = init.state_dict()
    for key in ("video", "video_vae"):
        name = f"discriminator.{key}.sn_conv3d5.u"
        moved = float((trained[name] - start[name]).abs().max())
        print(f"spectral u {name}: moved by up to {moved:.3g} over 4 steps")
        check(moved > 0.0, f"{name} did not move")
    return launches


def train_cpu_vs_gpu_phase(dev, model_name: str = "savp", hp=None, median_tol: float = TRAIN_GRAD_MEDIAN_TOL) -> float:
    """Phase 9 (and 20, for ``dna_l2``, and 21, for each objective): one
    train step on the CPU (plain versions) and on the GPU (kernels) from the
    same weights, batch and noise, fp32 with TF32 off, at ngf=8 (64 px, 6
    frames, batch 2) of ``hp`` (the flagship's by default) and model
    ``model_name``; the median leaf's gradient within ``median_tol``.
    Returns that median."""
    from video_prediction_torch.models import get_model_class, input_dims
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = (hp or slice_hparams()).replace(ngf=8, nef=8, ndf=8, sequence_length=6, batch_size=2)
    batch = {k: v[:, :6] for k, v in synthetic_batch(2, seed=6, device="cpu").items()}
    cpu_model = get_model_class(model_name)(hp, **input_dims(hp, batch))
    cpu_model.init_weights(torch.Generator().manual_seed(5))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    noise = cpu_model.draw_noise(2, 6, torch.Generator().manual_seed(7))
    step = make_train_step(cpu_model)
    states = [TrainState(m, *make_optimizers(m), 0, torch.Generator()) for m in (cpu_model, gpu_model)]
    s_cpu = step(states[0], batch, noise)
    s_gpu = step(states[1], {k: v.to(dev) for k, v in batch.items()},
                 {k: v.to(dev) if torch.is_tensor(v) else v for k, v in noise.items()})
    check(sorted(s_cpu) == sorted(s_gpu), f"loss terms differ: {sorted(s_cpu)} vs {sorted(s_gpu)}")
    worst_loss = 0.0
    for k in s_cpu:
        a, b = float(s_cpu[k]), float(s_gpu[k])
        worst_loss = max(worst_loss, abs(a - b) / max(abs(a), 1e-12))
        check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(a) + 1e-7, f"loss {k}: CPU {a} vs GPU {b}")
    lr = cpu_model.hparams.lr
    params = dict(gpu_model.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in cpu_model.parameters())
    param_worst, rel = 0.0, []
    for name, p in cpu_model.named_parameters():
        g_cpu, g_gpu = p.grad, params[name].grad.cpu()
        scale = float(g_cpu.abs().max())
        err = float((g_gpu - g_cpu).abs().max())
        if scale > TRAIN_GRAD_FLOOR * gmax:
            rel.append((err / scale, name))
        check(err <= TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR * gmax, f"gradient of {name}: max |dg| {err:.3g}, "
              f"max |g| {scale:.3g}")
        # Adam's first step moves each weight by lr * g / (|g| + 1e-8), at
        # most lr: where |g| is near the gradient tolerance the two sides may
        # step apart by up to 2 lr; where |g| is ten times above it and above
        # 1e-6 (eps then moves the step by under 1%) they step alike
        settled = g_cpu.abs() > max(10.0 * (TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR * gmax), 1e-6)
        diff = (params[name].detach().cpu() - p.detach()).abs()
        param_worst = max(param_worst, float(diff[settled].max()) if settled.any() else 0.0)
        check(bool((diff[settled] <= 1e-6 + 0.01 * lr).all()) and bool((diff <= 2.0 * lr + 1e-6).all()),
              f"parameter {name} after the step differs by {float(diff.max()):.3g}")
    rel.sort()
    median = rel[len(rel) // 2][0]
    worst = ", ".join(f"{n} {r:.3g}" for r, n in rel[-3:])
    check(median <= median_tol, f"median leaf gradient error {median:.3g} (worst leaves {worst})")
    for name, buf in cpu_model.named_buffers():
        err = float((dict(gpu_model.named_buffers())[name].cpu() - buf).abs().max())
        check(err <= 1e-5, f"spectral {name} differs by {err:.3g} after the step")
    print(f"{model_name} train step GPU vs CPU, ngf=8, batch 2, fp32 (TF32 off): {len(s_cpu)} loss terms within rel "
          f"{worst_loss:.3g} (tol {TRAIN_LOSS_RTOL}); gradient error over each leaf's max: median {median:.3g}"
          f" (tol {median_tol}), worst {worst} (tol {TRAIN_GRAD_TOL} + {TRAIN_GRAD_FLOOR} of the "
          f"largest); parameters after the step within {param_worst:.3g} where |g| is well above the tolerance")
    return median


def train_timing_phase(dev, ident: str) -> None:
    """Phase 10: ms per train step at batch 16 on a fixed device batch, CUDA
    synchronised host clock over 5 steps after 2 warm-up steps, and the
    peak device memory."""
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    hp = slice_hparams().replace(batch_size=TRAIN_BATCH)
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
    ts = create_train_state(model, 0, dev)
    step = make_train_step(model)
    data = synthetic_batch(TRAIN_BATCH, seed=8, device=dev)
    frames = TRAIN_BATCH * (hp.sequence_length - hp.context_frames)
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(ts, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 5
        for _ in range(n):
            scalars = step(ts, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(bool(torch.isfinite(v)) for v in scalars.values()), "timed train steps gave non-finite losses")
        print(f"train step batch {TRAIN_BATCH}, {'TF32 convs' if tf32 else 'fp32 (TF32 off)'}: {ms:.2f} ms, "
              f"{frames / ms * 1e3:.1f} frames/s, peak memory {peak:.2f} GiB [{ident}]")


def write_perceptual_weights(seed: int = 0):
    """Seeded random VGG16 and LPIPS weights in the ``.npz`` layout both
    packages read (``conv{b}_{i}/kernel`` HWIO, ``lin{i}/weight``), under
    ``build/chip_smoke/``: no real weights ship with the repository."""
    import numpy as np

    rng = np.random.RandomState(seed)
    vgg, c_in = {}, 3
    for block, n_convs, ch in [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]:
        for i in range(1, n_convs + 1):
            std = np.sqrt(2.0 / (9 * c_in))  # He init keeps the relu taps away from 0 through 13 layers
            vgg[f"conv{block}_{i}/kernel"] = (std * rng.randn(3, 3, c_in, ch)).astype(np.float32)
            vgg[f"conv{block}_{i}/bias"] = (0.01 * rng.randn(ch)).astype(np.float32)
            c_in = ch
    os.makedirs(WORK_DIR, exist_ok=True)
    vgg_path, lin_path = os.path.join(WORK_DIR, "vgg16.npz"), os.path.join(WORK_DIR, "lpips_lin.npz")
    np.savez(vgg_path, **vgg)
    np.savez(lin_path, **{f"lin{i}/weight": rng.rand(c).astype(np.float32) / c
                          for i, c in enumerate([64, 128, 256, 512, 512])})
    return vgg_path, lin_path


def read_metric(out_dir: str, stem: str, shape):
    import numpy as np

    arr = np.loadtxt(os.path.join(out_dir, f"{stem}.txt"))
    check(arr.shape == shape, f"{stem}.txt has shape {arr.shape}, want {shape}")
    return arr


def evaluate_phase(vgg_path: str, lin_path: str) -> dict:
    """Phase 11: ``video_prediction_torch.evaluate`` at full width on the run
    directory of phase 5: 16 examples in batches of 8, best of 8 samples in
    one rollout of 64, with VGG and LPIPS; then both baselines without a
    checkpoint. Returns the launch counts of the ``ours_savp`` run."""
    import numpy as np

    from video_prediction_torch import evaluate
    from video_prediction_torch import kernels as K

    set_tf32_default()
    results = os.path.join(WORK_DIR, "eval")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = evaluate.main([
        "--checkpoint", os.path.join(WORK_DIR, "run"), "--results_dir", results, "--device", "cuda",
        "--batch_size", "8", "--num_samples", "16", "--num_stochastic_samples", "8", "--samples_per_rollout", "8",
        "--vgg_weights_path", vgg_path, "--lpips_weights_path", lin_path,
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    out = summary["results_dir"]
    rollouts = summary["rollouts"]
    print(f"evaluate ours_savp: {rollouts} rollouts of 64, {wall:.2f} s wall (restore, VGG/LPIPS set-up, GIFs "
          f"included), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"means {summary['metrics']}; launches {launches}")
    check(rollouts == 2, f"unexpected evaluate summary {summary}")
    want = {k: n * rollouts for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})
    check(launches == want, f"evaluate kernel launches {launches}, want {want} ({rollouts} rollouts)")
    for name in ("psnr", "ssim", "vgg_csim", "lpips"):
        best, mean = read_metric(out, f"{name}_max", (16, 10)), read_metric(out, f"{name}_avg", (16, 10))
        check(bool(np.isfinite(best).all() and np.isfinite(mean).all()), f"{name}: non-finite values")
        if name == "lpips":  # a distance: the best sample is the smallest
            check(bool((best <= mean + 1e-6).all()), "lpips: max above avg")
        else:
            check(bool((best >= mean - 1e-6).all()), f"{name}: max below avg")
    gifs = [f for f in os.listdir(os.path.join(out, "images")) if f.endswith(".gif")]
    check(os.path.exists(os.path.join(out, "index.html")) and len(gifs) == 32, f"{len(gifs)} GIFs, want 32")

    for name in ("ground_truth", "repeat"):
        K.reset_launch_counts()
        summary = evaluate.main(["--model", name, "--dataset", "synthetic", "--results_dir", results,
                                 "--device", "cuda", "--batch_size", "8", "--num_samples", "16"])
        psnr, ssim = read_metric(summary["results_dir"], "psnr", (16, 10)), read_metric(summary["results_dir"],
                                                                                      "ssim", (16, 10))
        print(f"evaluate {name}: PSNR mean {psnr.mean():.4f}, SSIM mean {ssim.mean():.6f}, "
              f"SSIM max |1 - x| {np.abs(1.0 - ssim).max():.3g}")
        check(sum(K.launch_counts().values()) == 0, f"{name} launched kernels")
        if name == "ground_truth":
            check(bool(np.isposinf(psnr).all()), "ground_truth PSNR is not inf")
            check(bool((np.abs(ssim - 1.0) <= 1e-6).all()), "ground_truth SSIM is not 1")
        else:
            check(bool(np.isfinite(psnr).all() and np.isfinite(ssim).all()), "repeat gave non-finite metrics")
    split_metrics_check(torch.device("cuda", 0), vgg_path, lin_path)
    return launches


def split_metrics_check(dev, vgg_path: str, lin_path: str) -> None:
    """Phase 11, the CLI's perceptual metrics through ``BestOfN``: two chunks
    of 8 clips x 8 samples, whose target ``prepare`` featurises once, each
    chunk's ``vgg_csim`` and ``lpips`` against the metric called on the
    target expanded to every sample, with cuDNN's default TF32 (as the CLI
    runs) and with it off."""
    from video_prediction_torch.evaluate import BestOfN, metric_fns

    g = torch.Generator().manual_seed(11)
    frames = torch.rand(8, 11, 64, 64, 3, generator=g)  # context 2: 10 scored frames
    target = frames[:, 1:].to(dev)
    chunks = [(frames[:, None] + 0.1 * torch.randn(8, 8, 11, 64, 64, 3, generator=g)).clamp(0.0, 1.0).to(dev)
              for _ in range(2)]
    fns = {m: fn for m, fn in metric_fns(dev, vgg_path, lin_path).items() if m in ("vgg_csim", "lpips")}
    with torch.inference_mode():
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            red = BestOfN(fns, target, 2, keep_best=False)
            check(red.split == set(fns), f"BestOfN splits {red.split}, want {set(fns)}")
            errs = {m: 0.0 for m in fns}
            for chunk in chunks:
                vals, pred = red.update(chunk), chunk[:, :, 1:]
                for m, fn in fns.items():
                    want = fn(target[:, None].expand_as(pred), pred)
                    errs[m] = max(errs[m], float((vals[m] - want).abs().max()))
            print(f"BestOfN's prepared target (TF32 {'on' if tf32 else 'off'}) against the metric on the expanded "
                  f"target: max_abs_err {errs} (tol {METRIC_TOL['perceptual']})")
            for m, err in errs.items():
                check(err <= METRIC_TOL["perceptual"], f"{m} through BestOfN's split differs by {err}")
    set_tf32_default()


def sv2p_phase(dev) -> None:
    """Phase 12: ``sv2p`` (one z per sequence, 6 candidates) at full width from
    a run directory with seeded random weights: ``evaluate`` with best of 2,
    then its GPU rollout against its CPU rollout, TF32 off."""
    import numpy as np

    from video_prediction_torch import evaluate
    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import DatasetHparams, resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.checkpoint import write_run_dir

    set_tf32_default()
    cls = get_model_class("sv2p")
    hp = resolve_model_hparams(cls.default_hparams(), str(zoo_dir() / "bair_action_free" / "sv2p" / "model_hparams.json"))
    check((hp.ngf, hp.nz, hp.latent_time_invariant, hp.where_add) == (32, 8, True, "middle"), f"unexpected sv2p {hp}")
    model = cls(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(3))
    check(model.generator.cell.num_masks == 6, "sv2p should composite 6 candidates")
    run_dir = os.path.join(WORK_DIR, "sv2p_run")
    write_run_dir(run_dir, "sv2p", "synthetic", hp, DatasetHparams(context_frames=2, sequence_length=12), model)
    K.reset_launch_counts()
    summary = evaluate.main(["--checkpoint", run_dir, "--results_dir", os.path.join(WORK_DIR, "eval"),
                             "--device", "cuda", "--batch_size", "8", "--num_samples", "8",
                             "--num_stochastic_samples", "2", "--only_metrics"])
    torch.cuda.synchronize()
    launches, rollouts = K.launch_counts(), summary["rollouts"]
    want = {k: n * rollouts for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})
    print(f"evaluate sv2p: {rollouts} rollout of 16, means {summary['metrics']}; launches {launches}")
    check(rollouts == 1 and launches == want, f"sv2p evaluate: {rollouts} rollouts, launches {launches}, want {want}")
    for stem in ("psnr_max", "psnr_avg", "ssim_max", "ssim_avg"):
        check(bool(np.isfinite(read_metric(summary["results_dir"], stem, (8, 10))).all()), f"sv2p {stem} not finite")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_batch(2, seed=4, device="cpu")
    z = torch.randn(2, 1, 8, generator=torch.Generator().manual_seed(4))
    gpu_model = copy.deepcopy(model).to(dev).eval()
    with torch.inference_mode():
        ref = model.eval()(batch, zs_prior=z)["gen_images"]
        out = gpu_model({k: v.to(dev) for k, v in batch.items()}, zs_prior=z.to(dev))["gen_images"].cpu()
    err = float((out - ref).abs().max())
    print(f"sv2p rollout GPU vs CPU, batch 2, fp32 (TF32 off): max_abs_err {err:.3g} (tol {ROLLOUT_TOL})")
    check(bool(torch.isfinite(out).all()) and err <= ROLLOUT_TOL, f"sv2p GPU rollout differs from the CPU by {err}")
    set_tf32_default()


def metrics_phase(dev, vgg_path: str, lin_path: str) -> None:
    """Phase 13: the same ``[8,10,64,64,3]`` target and prediction through
    ``metrics.py``, ``VGGMetric`` and ``LPIPSMetric`` on the card and on the
    CPU: PSNR and SSIM with cuDNN's default TF32 left on (SSIM's filter runs in
    fp32 all the same), VGG and LPIPS with TF32 off, and their TF32 shift."""
    from video_prediction_torch import metrics as M
    from video_prediction_torch.models.lpips import LPIPSMetric
    from video_prediction_torch.models.vgg import VGGMetric

    g = torch.Generator().manual_seed(13)
    target = torch.rand(8, 10, 64, 64, 3, generator=g)
    pred = (target + 0.1 * torch.randn(target.shape, generator=g)).clamp(0.0, 1.0)
    td, pd = target.to(dev), pred.to(dev)
    set_tf32_default()
    check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 default is off on this build")
    for name, fn, tol in (("psnr", M.peak_signal_to_noise_ratio, METRIC_TOL["psnr"]),
                          ("ssim", M.structural_similarity, METRIC_TOL["ssim"])):
        err = float((fn(td, pd).cpu() - fn(target, pred)).abs().max())
        print(f"metric {name} GPU (TF32 on) vs CPU: max_abs_err {err:.3g} (tol {tol})")
        check(err <= tol, f"{name} on the card differs from the CPU by {err}")
    check(torch.backends.cudnn.allow_tf32, "SSIM left cuDNN's TF32 off")
    metrics = {"vgg_csim": (VGGMetric(vgg_path, device=dev), VGGMetric(vgg_path)),
               "lpips": (LPIPSMetric(vgg_path, lin_path, device=dev), LPIPSMetric(vgg_path, lin_path))}
    for name, (on_gpu, on_cpu) in metrics.items():
        ref = on_cpu(target, pred)
        torch.backends.cudnn.allow_tf32 = False
        err = float((on_gpu(td, pd).cpu() - ref).abs().max())
        torch.backends.cudnn.allow_tf32 = True
        err_tf32 = float((on_gpu(td, pd).cpu() - ref).abs().max())
        print(f"metric {name} GPU vs CPU: max_abs_err {err:.3g} with TF32 off (tol {METRIC_TOL['perceptual']}), "
              f"{err_tf32:.3g} with TF32 on; CPU mean {float(ref.mean()):.6f}")
        check(err <= METRIC_TOL["perceptual"], f"{name} on the card differs from the CPU by {err}")
    set_tf32_default()


def eval_timing_phase(model, dev, ident: str, vgg_path: str = "", lin_path: str = "", label: str = "") -> None:
    """Phase 14: one evaluate batch at the defaults (8 examples x 8 samples in
    one rollout of 64), cuDNN's default TF32, as the CLI runs it: tile and
    roll out, the metrics of the chunk with the running best-of-N, and the
    copies to the host; with PSNR/SSIM alone and, given their weights, with
    VGG and LPIPS added. CUDA events at the part boundaries of each of 10
    batches after 3 warm-up batches, so that the parts add up to the batch.
    ``label`` names the model in the lines."""
    from video_prediction_torch.evaluate import BestOfN, metric_fns, sample_chunks

    set_tf32_default()
    batch = synthetic_batch(8, seed=14, device=dev)
    target = batch["images"][:, 2:].float() / 255.0
    rng = torch.Generator(device=dev).manual_seed(14)
    iters, warmup = 10, 3
    with torch.inference_mode():
        runs = [("PSNR/SSIM", metric_fns(dev))]
        if vgg_path:
            runs.append(("PSNR/SSIM/VGG/LPIPS", metric_fns(dev, vgg_path, lin_path)))
        for metrics_label, fns in runs:
            parts = []  # (rollout, metrics, whole batch) ms
            torch.cuda.reset_peak_memory_stats()
            for i in range(warmup + iters):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                chunk = next(sample_chunks(model, batch, 8, 8, rng))  # one chunk at the defaults
                ev[1].record()
                red = BestOfN(fns, target, 2, keep_best=True)
                red.update(chunk)
                ev[2].record()
                for v in list(red.best.values()) + list(red.mean().values()) + [red.best_gen]:
                    v.cpu()
                ev[3].record()
                ev[3].synchronize()
                if i >= warmup:
                    parts.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), ev[0].elapsed_time(ev[3])))
            peak = torch.cuda.max_memory_allocated() / 2**30
            rollout_ms, metrics_ms, batch_ms = (sum(p[j] for p in parts) / iters for j in range(3))
            spread = max(p[2] for p in parts) - min(p[2] for p in parts)
            print(f"evaluate batch 8 x 8 samples, {label + ', ' if label else ''}{metrics_label}, TF32 convs: "
                  f"rollout {rollout_ms:.2f} ms, metrics "
                  f"{metrics_ms:.2f} ms, whole batch {batch_ms:.2f} ms (max - min over {iters}: {spread:.2f} ms), "
                  f"{8e3 / batch_ms:.1f} evaluated examples/s; peak memory {peak:.2f} GiB [{ident}]")


# ---------------------------------------------------------------------------
# the bf16 model (phases 15-18)
# ---------------------------------------------------------------------------
def tpu_hparams():
    """``savp`` defaults overridden by ``bair_action_free/ours_savp_tpu``: the
    flagship's widths, bf16 compute and gates, split gate convs, batch 64."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class

    zoo = zoo_dir() / "bair_action_free" / "ours_savp_tpu" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo))
    got = (hp.ngf, hp.nz, hp.sequence_length, hp.compute_dtype, hp.gate_dtype, hp.lstm_gate_conv, hp.batch_size)
    check(got == (32, 8, 12, "bfloat16", "bfloat16", "split", 64), f"unexpected ours_savp_tpu config {got}")
    return hp


def check_launch_dtypes(label: str) -> dict:
    """Every launch since the last reset ran in its ``BF16_MODEL_DTYPES`` dtype."""
    from video_prediction_torch import kernels as K

    dtypes = K.launch_dtypes()
    for name, by_dtype in dtypes.items():
        check(set(by_dtype) == {BF16_MODEL_DTYPES[name]},
              f"{label}: {name} launched on {by_dtype}, want only {BF16_MODEL_DTYPES[name]}")
    check("fused_ln_gate" in dtypes, f"{label}: K2 did not launch")
    return dtypes


def ratio_check(label: str, gpu16, cpu16, cpu32) -> float:
    """The bf16 rule; returns max|GPU bf16 - CPU bf16| / max|CPU bf16 - CPU fp32|."""
    lhs = float((gpu16.detach().float().cpu() - cpu16.detach().float()).abs().max())
    rhs = float((cpu16.detach().float() - cpu32.detach().float()).abs().max())
    check(bool(torch.isfinite(gpu16).all()), f"{label}: the GPU bf16 values are not finite")
    check(rhs > 0.0, f"{label}: the CPU bf16 values equal the fp32 ones; the rule would say nothing")
    check(lhs <= BF16_RATIO * rhs, f"{label}: max|GPU bf16 - CPU bf16| {lhs:.3g} > {BF16_RATIO} x "
                                   f"max|CPU bf16 - CPU fp32| {rhs:.3g}")
    return lhs / rhs


def bf16_generate_evaluate_phase():
    """Phase 15: ``generate`` and ``evaluate`` at their defaults on a run
    directory of the bf16 model with seeded random weights; returns the model."""
    import numpy as np

    from video_prediction_torch import evaluate, generate
    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import DatasetHparams
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.checkpoint import write_run_dir

    set_tf32_default()
    hp = tpu_hparams()
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(10))
    run_dir = os.path.join(WORK_DIR, "tpu_run")
    write_run_dir(run_dir, "savp", "synthetic", hp, DatasetHparams(context_frames=2, sequence_length=12), model)
    results = os.path.join(WORK_DIR, "tpu_results")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = generate.main(["--checkpoint", run_dir, "--results_dir", results, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, rollouts = K.launch_counts(), summary["rollouts"]
    dtypes = check_launch_dtypes("generate bf16")
    print(f"generate ours_savp_tpu (bf16): {rollouts} rollouts of 8, {summary['gifs']} GIFs, {wall:.2f} s wall; "
          f"launches {launches}; by dtype {dtypes}")
    check(rollouts == 2 and summary["gifs"] == 16, f"unexpected generate summary {summary}")
    check(summary["all_finite"], "generate (bf16) produced non-finite values")
    want = {k: n * rollouts for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})
    check(launches == want, f"generate bf16 kernel launches {launches}, want {want}")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = evaluate.main(["--checkpoint", run_dir, "--results_dir", results, "--device", "cuda",
                             "--num_stochastic_samples", "8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, rollouts = K.launch_counts(), summary["rollouts"]
    dtypes = check_launch_dtypes("evaluate bf16")
    print(f"evaluate ours_savp_tpu (bf16): {rollouts} rollouts of 64 (32 examples, best of 8), {wall:.2f} s wall; "
          f"means {summary['metrics']}; launches {launches}; by dtype {dtypes}")
    check(rollouts == 4, f"unexpected evaluate summary {summary}")
    want = {k: n * rollouts for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})
    check(launches == want, f"evaluate bf16 kernel launches {launches}, want {want}")
    for name in ("psnr", "ssim"):
        best = read_metric(summary["results_dir"], f"{name}_max", (32, 10))
        mean = read_metric(summary["results_dir"], f"{name}_avg", (32, 10))
        check(bool(np.isfinite(best).all() and np.isfinite(mean).all()), f"bf16 {name}: non-finite values")
        check(bool((best >= mean - 1e-6).all()), f"bf16 {name}: max below avg")
    return model


def bf16_cpu_vs_gpu_phase(model, dev) -> None:
    """Phase 16: the bf16 rollout on the GPU (kernels) and on the CPU (plain
    versions), batch 2, TF32 off, under the rule against the CPU fp32 rollout
    of the same weights."""
    from video_prediction_torch.models import get_model_class

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = get_model_class("savp")(model.hparams.replace(compute_dtype="float32", gate_dtype="float32"),
                                   image_shape=(64, 64, 3), action_dim=4)
    fp32.load_state_dict(model.state_dict())
    gpu_model = copy.deepcopy(model).to(dev).eval()
    batch = synthetic_batch(2, seed=16, device="cpu")
    z = torch.randn(2, 11, 8, generator=torch.Generator().manual_seed(16))
    with torch.inference_mode():
        cpu16 = model.eval()(batch, zs_prior=z)["gen_images"]
        cpu32 = fp32.eval()(batch, zs_prior=z)["gen_images"]
        gpu16 = gpu_model({k: v.to(dev) for k, v in batch.items()}, zs_prior=z.to(dev))["gen_images"]
    ratio = ratio_check("bf16 rollout", gpu16, cpu16, cpu32)
    print(f"rollout GPU vs CPU, batch 2, bf16 (TF32 off): max|GPU bf16 - CPU bf16| "
          f"{float((gpu16.cpu() - cpu16).abs().max()):.3g}, max|CPU bf16 - CPU fp32| "
          f"{float((cpu16 - cpu32).abs().max()):.3g}: ratio {ratio:.3f} (rule {BF16_RATIO})")
    set_tf32_default()


def bf16_train_phase(dev) -> dict:
    """Phase 17: ``train``'s ``main`` on ``ours_savp_tpu`` at batch 64, 2
    steps, then ``--resume`` for a third; then one GPU bf16 train step against
    the CPU's at ngf=8 (``bf16_step_check``), from each of two seeds.
    Returns the launch counts of the 3 CLI steps."""
    import shutil

    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train.__main__ import main as train_main

    set_tf32_default()
    run_dir = os.path.join(WORK_DIR, "tpu_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--dataset", "synthetic", "--model", "savp",
            "--model_hparams_dict", str(zoo_dir() / "bair_action_free" / "ours_savp_tpu" / "model_hparams.json"),
            "--output_dir", run_dir, "--device", "cuda", "--progress_freq", "1", "--save_freq", "1000"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_main(argv + ["--max_steps", "2"])
    resumed = train_main(argv + ["--max_steps", "3", "--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    dtypes = check_launch_dtypes("train bf16")
    print(f"train ours_savp_tpu (bf16), batch 64: 2 steps then a resumed 3rd, {wall:.2f} s wall; last losses "
          f"{resumed['scalars']}; launches {launches}; by dtype {dtypes}")
    check(first["all_finite"] and resumed["all_finite"], "train (bf16) produced non-finite losses")
    check((first["start_step"], first["step"], resumed["start_step"], resumed["step"]) == (0, 2, 2, 3),
          f"unexpected bf16 train runs {first}, {resumed}")
    want = train_launches(tpu_hparams(), BF16_TRAIN_STEPS)  # scan_unroll=0: no recompute
    check(launches == want, f"train bf16 kernel launches {launches}, want {want}")

    for seed in BF16_STEP_SEEDS:
        bf16_step_check(dev, seed)
    return launches


def term_floor(name: str, value: float) -> float:
    """One bf16 ulp of the logit behind a GAN log-loss term (a mean of
    softplus of the discriminator's bf16 logits): dL = (1 - e^-L) du, with
    |u| = |log(e^L - 1)|. At L = 4e-5 (logits near -10, ulp 0.0625) one ulp
    moves the term by 6%, so two bf16 runs may differ there by more than
    either differs from fp32. 0 for the other terms, which the ratio alone
    holds."""
    if "gan" in name and not name.endswith("feat") and value > 0.0:
        _, exp = math.frexp(abs(math.log(math.expm1(value))))  # |u| = m 2^exp, 0.5 <= m < 1
        return 2.0 ** (exp - 8) * -math.expm1(-value)
    return 0.0


def bf16_step_readings(dev, seed: int, hp=None, keys=None) -> dict:
    """One train step of ``hp`` (default ``ours_savp_tpu`` at ngf=8: 64 px, 6
    frames, batch 2, the KL at full weight from step 0), TF32 off, with
    weights, batch (its ``keys``, default all: images, actions, states) and
    noise from ``seed``: on the CPU in fp32 and bf16 (plain versions) and on
    the GPU in bf16 (kernels). Returns ``{"terms": {name: (cpu32, cpu16,
    gpu16)}, "leaves": {name: (max|GPU bf16 - CPU bf16|, max|CPU bf16 - CPU
    fp32|, max|CPU fp32|)}}``."""
    from video_prediction_torch.models import get_model_class, input_dims

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if hp is None:
        hp = tpu_hparams().replace(ngf=8, nef=8, ndf=8, sequence_length=6, batch_size=2, kl_anneal="none")
    batch = {k: v[:, :6] for k, v in synthetic_batch(2, seed=seed, device="cpu").items() if keys is None or k in keys}
    cpu16 = get_model_class("savp")(hp, **input_dims(hp, batch))
    cpu16.init_weights(torch.Generator().manual_seed(seed))
    cpu32 = get_model_class("savp")(hp.replace(compute_dtype="float32", gate_dtype="float32"),
                                    **input_dims(hp, batch))
    cpu32.load_state_dict(cpu16.state_dict())
    gpu16 = copy.deepcopy(cpu16).to(dev)
    noise = cpu16.draw_noise(2, 6, torch.Generator().manual_seed(seed + 1))
    runs = {}
    for key, m, on in (("cpu32", cpu32, "cpu"), ("cpu16", cpu16, "cpu"), ("gpu16", gpu16, dev)):
        total, aux = m.compute_losses({k: v.to(on) for k, v in batch.items()}, 0,
                                      noise={k: v.to(on) if torch.is_tensor(v) else v for k, v in noise.items()})
        total.backward()
        runs[key] = ({k: float(v.detach()) for k, v in {**aux["g_losses"], **aux["d_losses"]}.items()},
                     {n: p.grad.detach().float().cpu() for n, p in m.named_parameters()})
    set_tf32_default()
    check(sorted(runs["gpu16"][0]) == sorted(runs["cpu16"][0]), "bf16 loss terms differ")
    check(sorted(runs["gpu16"][1]) == sorted(runs["cpu16"][1]), "bf16 parameters differ")
    (l32, g32), (l16, g16), (lg, gg) = runs["cpu32"], runs["cpu16"], runs["gpu16"]
    return {"terms": {t: (l32[t], l16[t], lg[t]) for t in sorted(l16)},
            "leaves": {n: (float((gg[n] - g16[n]).abs().max()), float((g16[n] - g32[n]).abs().max()),
                           float(g32[n].abs().max())) for n in sorted(g16)}}


def bf16_step_check(dev, seed: int, hp=None, keys=None, label: str = "") -> None:
    """Phase 17's second part: the GPU bf16 step against the CPU's, each
    loss term by BF16_RATIO plus ``term_floor``, each gradient leaf by
    BF16_GRAD_RATIO plus one rounding of its largest fp32 entry
    (``bf16_step_readings`` of ``hp`` and ``keys``)."""
    r = bf16_step_readings(dev, seed, hp, keys)
    term_ratios, leaf_ratios = {}, {}
    for t, (c32, c16, g16) in r["terms"].items():
        check(math.isfinite(g16), f"bf16 step (seed {seed}): loss {t} is not finite")
        lhs, rhs = abs(g16 - c16), abs(c16 - c32)
        allowed = BF16_RATIO * rhs + term_floor(t, c32)
        check(lhs <= allowed, f"bf16 step (seed {seed}): loss {t}: |GPU bf16 - CPU bf16| {lhs:.3g} > {BF16_RATIO} x "
                              f"|CPU bf16 - CPU fp32| {rhs:.3g} + a logit's ulp {term_floor(t, c32):.3g} "
                              f"(CPU fp32 {c32:.6g}, CPU bf16 {c16:.6g}, GPU bf16 {g16:.6g})")
        term_ratios[t] = lhs / allowed if allowed else 0.0
    for n, (lhs, rhs, scale) in r["leaves"].items():
        check(math.isfinite(lhs), f"bf16 step (seed {seed}): the gradient of {n} is not finite")
        allowed = BF16_GRAD_RATIO * rhs + BF16_ROUNDING * scale
        check(lhs <= allowed, f"bf16 step (seed {seed}): gradient {n}: max|GPU bf16 - CPU bf16| {lhs:.3g} > "
                              f"{BF16_GRAD_RATIO} x max|CPU bf16 - CPU fp32| {rhs:.3g} + one rounding of its "
                              f"max {BF16_ROUNDING * scale:.3g}")
        leaf_ratios[n] = lhs / rhs if rhs else 0.0
    worst = sorted(leaf_ratios.items(), key=lambda kv: -kv[1])[:3]
    print(f"train step GPU vs CPU{label}, ngf=8, batch 2, bf16 (TF32 off), seed {seed}: {len(term_ratios)} loss terms and "
          f"{len(leaf_ratios)} gradient leaves each within its rule; share of the allowed difference used by the "
          f"worst term {max(term_ratios.values()):.3f}; largest leaf ratios max|GPU - CPU bf16| / max|CPU bf16 - "
          f"fp32| {', '.join(f'{n} {v:.2f}' for n, v in worst)} (rule {BF16_GRAD_RATIO}); per term (CPU fp32, "
          f"CPU bf16, GPU bf16): { {t: tuple(f'{v:.6g}' for v in vals) for t, vals in r['terms'].items()} }")


def ln_gate_bf16_entries(dev) -> tuple:
    """K2 on bf16 z and c at the bf16 model's shapes (``bench.BF16_LN_GATE``):
    a step of six calls' device time, bytes and bound, and the largest error
    against the plain version; (forward, backward) sub-entries."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import BF16_LN_GATE, ln_gate_step_ms, ln_gate_widths, ln_inputs

    labels = {8: "generation batch 8", 64: "rollout batch 64", 128: "train step batch 128"}
    entries = ({}, {})
    for (name, batches), out in zip(BF16_LN_GATE.items(), entries):
        backward = name.endswith("backward")
        for batch in batches:
            g = torch.Generator(device=dev).manual_seed(batch)
            err, ms, plain_ms = 0.0, {}, {}
            for cdim, px in sorted(set(RL.LN_GATE_STEP)):
                z, c, lnp, d1, d2 = ln_inputs(g, batch * px * px, cdim, dev, torch.bfloat16)
                if backward:
                    ms[cdim] = cuda_ms(lambda: K.fused_ln_gate_backward(z, c, lnp, d1, d2), iters=10)
                    plain_ms[cdim] = plain_backward_ms(K.fused_ln_gate_reference, (z, c, lnp), (d1, d2))
                else:
                    ms[cdim] = cuda_ms(lambda: K.fused_ln_gate(z, c, lnp), iters=10)
                    plain_ms[cdim] = cuda_ms(lambda: K.fused_ln_gate_reference(z, c, lnp), iters=10)
                if backward:
                    outs = K.fused_ln_gate_backward(z, c, lnp, d1, d2)
                    refs = plain_grads(K.fused_ln_gate_reference, (z, c, lnp), (d1, d2))
                    errs = [max_err(outs[0], refs[0], "bfloat16"), max_err(outs[1], refs[1], "bfloat16"),
                            reduction_err(outs[2], refs[2])]
                else:
                    errs = [max_err(o, r, "bfloat16") for o, r in zip(K.fused_ln_gate(z, c, lnp),
                                                                       K.fused_ln_gate_reference(z, c, lnp))]
                check(all(ok for _, ok in errs), f"K2 {name} bf16 batch {batch} C={cdim}: {errs}")
                err = max(err, *(e for e, _ in errs))
            fn = K.fused_ln_gate_backward if backward else (lambda z, c, lnp, *_: K.fused_ln_gate(z, c, lnp))
            widths = ln_gate_widths(fn, batch, dev, 20, dtype=torch.bfloat16)
            sub = dict(max_abs_err=err, ms=ln_gate_step_ms(ms), plain_ms=ln_gate_step_ms(plain_ms),
                       device_ms=ln_gate_step_ms(widths), per_width_ms={str(c): t for c, t in widths.items()})
            count = RL.ln_gate_backward if backward else RL.ln_gate_forward
            out[labels[batch]] = roofline(sub, count(RL.ln_gate_step(batch), itemsize=2))
            print(f"K2 {'backward' if backward else 'forward'} per generator step (6 calls), bf16, batch {batch}: "
                  f"device {sub['device_ms']:.4f} ms (bound {sub['bound_ms']:.4f} ms, "
                  f"{100 * sub['share_of_bound']:.1f}% of it), {sub['bytes'] / 1e6:.2f} MB, a call at C = "
                  f"{', '.join(f'{c}: {t:.4f}' for c, t in widths.items())} ms; host-paced kernel {sub['ms']:.4f} ms, "
                  f"plain {sub['plain_ms']:.4f} ms; max_abs_err {err:.3g}")
    return entries


def bf16_timing_phase(model, dev, ident: str) -> None:
    """Phase 18: the bf16 rollout at batch 8 and 64, the bf16 train step at
    batch 16 and 64 with its peak memory, and one bf16 evaluate batch, at the
    CLIs' TF32 default (cuDNN's TF32 convs; the bf16 convs are bf16 either way)."""
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    set_tf32_default()
    gpu_model = copy.deepcopy(model).to(dev).eval()
    for bsz in (8, 64):
        batch = synthetic_batch(bsz, seed=18, device=dev)
        z = torch.randn(bsz, 11, 8, device=dev, generator=torch.Generator(device=dev).manual_seed(18))
        with torch.inference_mode():
            ms = cuda_ms(lambda: gpu_model(batch, zs_prior=z), iters=10, warmup=3)
        print(f"rollout batch {bsz}, bf16 (ours_savp_tpu): {ms:.2f} ms, {bsz * 10 / ms * 1e3:.0f} generated "
              f"frames/s [{ident}]")
    eval_timing_phase(gpu_model, dev, ident, label="bf16 (ours_savp_tpu)")
    del gpu_model
    hp = tpu_hparams()
    for bsz in (16, 64):
        m = get_model_class("savp")(hp.replace(batch_size=bsz), image_shape=(64, 64, 3), action_dim=4)
        ts = create_train_state(m, 0, dev)
        step = make_train_step(m)
        data = synthetic_batch(bsz, seed=19, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(ts, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 3
        for _ in range(n):
            scalars = step(ts, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(bool(torch.isfinite(v)) for v in scalars.values()), "timed bf16 train steps gave non-finite losses")
        print(f"train step batch {bsz}, bf16 (ours_savp_tpu): {ms:.2f} ms, {bsz * 10 / ms * 1e3:.1f} frames/s, "
              f"peak memory {peak:.2f} GiB [{ident}]")
        del ts, step, m
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the TFRecord datasets (phase 19)
# ---------------------------------------------------------------------------
RECORDS = {"train": (4, 16), "val": (1, 16), "test": (1, 16)}  # files x records of 30 frames
RECORD_FRAMES = 30


def write_bair_records(root: str) -> dict:
    """Phase 19, first part: BAIR-schema records (``%d/image_aux1/encoded``
    raw 64x64x3 uint8, 4-D ``%d/action``, 3-D ``%d/endeffector_pos``, 30
    frames) through the port's own writer, the frames and the actions from
    the port's ``synthetic`` generator so that the content moves. Returns the
    split directories."""
    import shutil

    from video_prediction_torch.configs.hparams import DatasetHparams
    from video_prediction_torch.data.records import TFRecordWriter, bytes_feature, encode_example, float_feature
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset

    shutil.rmtree(root, ignore_errors=True)
    dirs, n_bytes, n_records = {}, 0, 0
    t0 = time.perf_counter()
    for split, (files, per_file) in RECORDS.items():
        dirs[split] = os.path.join(root, split)
        os.makedirs(dirs[split])
        it = SyntheticVideoDataset(mode=split, seed=19, hparams=DatasetHparams(sequence_length=RECORD_FRAMES)
                                   ).make_iterator(per_file)
        for f in range(files):
            batch = next(it)
            path = os.path.join(dirs[split], f"bair_{split}_{f}.tfrecord")
            with TFRecordWriter(path) as w:
                for b in range(per_file):
                    feat = {}
                    for i in range(RECORD_FRAMES):
                        feat[f"{i}/image_aux1/encoded"] = bytes_feature([batch["images"][b, i].tobytes()])
                        feat[f"{i}/action"] = float_feature(batch["actions"][b, i])
                        feat[f"{i}/endeffector_pos"] = float_feature(batch["states"][b, i])
                    w.write(encode_example(feat))
            n_bytes += os.path.getsize(path)
            n_records += per_file
    print(f"records: {n_records} BAIR-schema records ({', '.join(f'{k} {f * n}' for k, (f, n) in RECORDS.items())}"
          f"), {n_bytes} bytes, written in {time.perf_counter() - t0:.2f} s by data/records.py (host)")
    return dirs


def host_pipeline_rate(train_dir: str, dhp) -> None:
    """The host pipeline alone (``NativeVideoPipeline`` on one prefetch
    thread, BAIR raw, train mode): the first batch waits for the 1024-example
    shuffle buffer; then examples/s over 50 batches of 16."""
    from video_prediction_torch.data import get_dataset_class

    ds = get_dataset_class("bair")(train_dir, mode="train", hparams=dhp, seed=0)
    t0 = time.perf_counter()
    it = ds.make_iterator(TRAIN_BATCH)
    next(it)
    first = time.perf_counter() - t0
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        batch = next(it)
    dt = time.perf_counter() - t0
    it.close()
    check(batch["images"].shape == (TRAIN_BATCH, dhp.sequence_length, 64, 64, 3), f"host batch {batch['images'].shape}")
    print(f"host pipeline, BAIR raw, train mode: first batch after {first:.3f} s (1024-example shuffle buffer), "
          f"then {n * TRAIN_BATCH / dt:.1f} examples/s over {n} batches of {TRAIN_BATCH} (host, one thread)")


def records_train_phase(dirs: dict, per_step: dict, dev) -> str:
    """Phase 19, train: ``train``'s ``main`` on the records, fp32 with TF32
    convs, batch 16, 3 steps and an eval firing of 8 batches on
    ``--val_input_dir``; the feeder's first device batch against the host
    pipeline's; the launches per train step against phase 8's; then one step
    of the action-conditioned ``bair/ours_savp`` with ``use_state=True``.
    Returns the run directory."""
    import shutil

    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import DatasetHparams, apply_overrides, zoo_dir
    from video_prediction_torch.data import DeviceFeeder, get_dataset_class
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.train.checkpoint import PARAMS_FILE, checkpoint_file

    set_tf32_default()
    run_dir = os.path.join(WORK_DIR, "records_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--dataset", "bair", "--input_dir", dirs["train"], "--val_input_dir", dirs["val"], "--model", "savp",
            "--model_hparams_dict", str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
            "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH), "--max_steps", "3", "--device", "cuda",
            "--progress_freq", "1", "--save_freq", "1000", "--eval_summary_freq", "3",
            "--accum_eval_summary_freq", "0", "--seed", "0"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    print(f"train on records: 3 steps and an eval firing of 8 val batches, {wall:.2f} s wall (set-up, shuffle "
          f"buffer and first steps included); losses {summary['scalars']}; eval {summary['summaries']}; "
          f"launches {launches}")
    check(summary["all_finite"] and summary["step"] == 3, f"train on records: {summary}")
    check("eval/psnr" in summary["summaries"], "train on records: no eval firing")
    # 3 train steps as phase 8's, and 8 no-grad eval rollouts
    want = {k: n + 8 * LAUNCHES_PER_ROLLOUT.get(k, 0) for k, n in train_launches(slice_hparams(), 3).items()}
    check(launches == want, f"train on records: launches {launches}, want {want} (phase 8 a step: {per_step})")

    with open(os.path.join(run_dir, "dataset_hparams.json")) as f:
        dhp = apply_overrides(DatasetHparams(), json.load(f))
    ds = get_dataset_class("bair")
    host = next(ds(dirs["train"], mode="train", hparams=dhp, seed=0).make_iterator(TRAIN_BATCH))
    feeder = DeviceFeeder(ds(dirs["train"], mode="train", hparams=dhp, seed=0).make_iterator(TRAIN_BATCH), dev)
    try:
        first = next(feeder)
        check(sorted(first) == sorted(host) == ["images"], f"first batch keys {sorted(first)}, {sorted(host)}")
        got = first["images"].cpu().numpy()
        check(first["images"].dtype == torch.uint8 and got.tobytes() == host["images"].tobytes(),
              "the feeder's first device batch differs from the host pipeline's")
    finally:
        feeder.close()
    print(f"feeder: first device batch {tuple(first['images'].shape)} uint8 equals the host pipeline's byte for byte")
    host_pipeline_rate(dirs["train"], dhp)

    ac_dir = os.path.join(WORK_DIR, "records_train_actions")
    shutil.rmtree(ac_dir, ignore_errors=True)
    K.reset_launch_counts()
    ac = train_main(["--dataset", "bair", "--input_dir", dirs["train"], "--dataset_hparams", "use_state=True",
                     "--model", "savp", "--model_hparams_dict",
                     str(zoo_dir() / "bair" / "ours_savp" / "model_hparams.json"), "--output_dir", ac_dir,
                     "--batch_size", str(TRAIN_BATCH), "--max_steps", "1", "--device", "cuda", "--progress_freq", "1",
                     "--save_freq", "1000", "--eval_summary_freq", "0", "--accum_eval_summary_freq", "0",
                     "--seed", "0"])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    # the actions from the records enter the generator's stem conv beside the image and z
    stem = "generator.cell.stem.weight"
    widths = [torch.load(checkpoint_file(d, PARAMS_FILE), weights_only=True)[stem].shape[1] for d in (run_dir, ac_dir)]
    print(f"action-conditioned bair/ours_savp on records (use_state=True): 1 step, losses {ac['scalars']}; "
          f"launches {launches}; stem input channels {widths[1]} (action-free {widths[0]})")
    check(ac["all_finite"] and ac["step"] == 1, f"action-conditioned step: {ac}")
    want = train_launches(ac_hparams("savp", "ours_savp"))
    check(launches == want, f"action-conditioned step launches {launches}, want {want}")
    check(widths[1] - widths[0] == 4, f"stem input channels {widths}: the 4 action dims did not reach the model")
    return run_dir


def records_eval_phase(dirs: dict, run_dir: str, model: str = "savp", per_rollout: dict = LAUNCHES_PER_ROLLOUT,
                       label: str = "") -> None:
    """Phase 19 (and 20, for each ``model``): ``evaluate`` (8 x 8 samples, 16
    examples) and ``generate`` (batch 8, 16 examples x 2 samples) from a run
    directory trained on the records, on ``test/``, with phase 11's and phase
    5's checks and ``per_rollout`` launches a rollout."""
    import numpy as np

    from video_prediction_torch import evaluate, generate
    from video_prediction_torch import kernels as K

    set_tf32_default()
    results = os.path.join(WORK_DIR, "records_eval")
    K.reset_launch_counts()
    summary = evaluate.main(["--checkpoint", run_dir, "--input_dir", dirs["test"], "--results_dir", results,
                             "--device", "cuda", "--batch_size", "8", "--num_samples", "16",
                             "--num_stochastic_samples", "8", "--samples_per_rollout", "8"])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    out, rollouts = summary["results_dir"], summary["rollouts"]
    print(f"evaluate{label} on test records: {rollouts} rollouts of 64, means {summary['metrics']}; launches {launches}")
    check(out.endswith(os.path.join("bair", model)), f"evaluate wrote to {out}")
    check(rollouts == 2 and summary["no_nan"], f"unexpected evaluate summary {summary}")
    want = {k: n * rollouts for k, n in per_rollout.items()}
    want.update({k: 0 for k in BACKWARD})
    check(launches == want, f"evaluate on records: launches {launches}, want {want}")
    check(sorted(f for f in os.listdir(out) if f.endswith(".txt")) ==
          ["psnr_avg.txt", "psnr_max.txt", "ssim_avg.txt", "ssim_max.txt"], f"metric files {os.listdir(out)}")
    for name in ("psnr", "ssim"):
        best, mean = read_metric(out, f"{name}_max", (16, 10)), read_metric(out, f"{name}_avg", (16, 10))
        check(bool(np.isfinite(best).all() and np.isfinite(mean).all()), f"{name}: non-finite values")
        check(bool((best >= mean - 1e-6).all()), f"{name}: max below avg")
    gifs = [f for f in os.listdir(os.path.join(out, "images")) if f.endswith(".gif")]
    check(os.path.exists(os.path.join(out, "index.html")) and len(gifs) == 32, f"{len(gifs)} GIFs, want 32")

    K.reset_launch_counts()
    summary = generate.main(["--checkpoint", run_dir, "--input_dir", dirs["test"], "--results_dir", results,
                             "--device", "cuda", "--batch_size", "8", "--num_samples", "16",
                             "--num_stochastic_samples", "2"])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    rollouts = summary["rollouts"]
    gifs = [f for f in os.listdir(summary["out_dir"]) if f.endswith(".gif")]
    print(f"generate{label} on test records: {rollouts} rollouts, {len(gifs)} GIFs; launches {launches}")
    check(rollouts == 4 and summary["gifs"] == 32 and len(gifs) == 32 and summary["all_finite"],
          f"unexpected generate summary {summary}")
    want = {k: n * rollouts for k, n in per_rollout.items()}
    want.update({k: 0 for k in BACKWARD})
    check(launches == want, f"generate on records: launches {launches}, want {want}")


def records_timing_phase(dirs: dict, run_dir: str, dev, ident: str) -> None:
    """Phase 19, times on one card in one call, TF32 convs: ms per train step
    at batch 16 on a fixed device batch and on the records through the
    feeder, alternated (fixed, records, records, fixed; 5 steps each after 2
    warm-up steps, CUDA-synchronised host clock); ms per evaluate batch (8 x
    8 samples) from the records, host reading and copy included, beside the
    same on a fixed device batch (10 batches after 3)."""
    import statistics

    from video_prediction_torch.configs.hparams import DatasetHparams, apply_overrides
    from video_prediction_torch.data import DeviceFeeder, get_dataset_class
    from video_prediction_torch.evaluate import BestOfN, metric_fns, sample_chunks
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    set_tf32_default()
    with open(os.path.join(run_dir, "dataset_hparams.json")) as f:
        dhp = apply_overrides(DatasetHparams(), json.load(f))
    ds = get_dataset_class("bair")
    hp = slice_hparams().replace(batch_size=TRAIN_BATCH)
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=0)
    ts = create_train_state(model, 0, dev)
    step = make_train_step(model)
    feeder = DeviceFeeder(ds(dirs["train"], mode="train", hparams=dhp, seed=0).make_iterator(TRAIN_BATCH), dev)
    times = {"fixed": [], "records": []}
    try:
        fixed = next(feeder)
        for _ in range(2):
            step(ts, fixed)
            step(ts, next(feeder))
        for kind in ("fixed", "records", "records", "fixed"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                scalars = step(ts, fixed if kind == "fixed" else next(feeder))
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3 / 5)
            check(all(bool(torch.isfinite(v)) for v in scalars.values()), "timed steps gave non-finite losses")
    finally:
        feeder.close()
    print(f"train step batch {TRAIN_BATCH}, TF32 convs, one model: fixed device batch "
          f"{' / '.join(f'{t:.2f}' for t in times['fixed'])} ms, records through the feeder "
          f"{' / '.join(f'{t:.2f}' for t in times['records'])} ms (fixed, records, records, fixed; 5 steps each) "
          f"[{ident}]")
    del ts, step, model
    torch.cuda.empty_cache()

    model = get_model_class("savp")(slice_hparams(), image_shape=(64, 64, 3), action_dim=0)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).eval()
    fns = metric_fns(dev)
    rng = torch.Generator(device=dev).manual_seed(19)
    it = ds(dirs["test"], mode="test", hparams=dhp, seed=0).make_iterator(8)
    fixed = batch_to_device(next(it), dev)
    ms = {"records": [], "fixed": []}
    with torch.inference_mode():
        for i in range(13):
            for kind in ("records", "fixed"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = batch_to_device(next(it), dev) if kind == "records" else fixed
                target = batch["images"][:, hp.context_frames:].float() / 255.0
                red = BestOfN(fns, target, hp.context_frames, keep_best=True)
                for chunk in sample_chunks(model, batch, 8, 8, rng):
                    red.update(chunk)
                for v in list(red.best.values()) + list(red.mean().values()) + [red.best_gen]:
                    v.cpu()
                torch.cuda.synchronize()
                if i >= 3:
                    ms[kind].append((time.perf_counter() - t0) * 1e3)
    it.close()
    print(f"evaluate batch 8 x 8 samples, PSNR/SSIM, TF32 convs: from the test records {statistics.median(ms['records']):.2f}"
          f" ms (median of 10; min {min(ms['records']):.2f}, max {max(ms['records']):.2f}), on a fixed device batch "
          f"{statistics.median(ms['fixed']):.2f} ms (min {min(ms['fixed']):.2f}, max {max(ms['fixed']):.2f}), "
          f"alternated [{ident}]")


def records_phase(per_step: dict, dev, ident: str) -> dict:
    """Phase 19: the TFRecord datasets through train, evaluate and generate;
    returns the records' split directories."""
    import importlib.util

    from video_prediction_torch import native

    print(f"native codec: {'available' if native.codec_available() else 'unavailable'} (libjpeg linked by g++); "
          f"PIL: {'present' if importlib.util.find_spec('PIL') else 'absent'}")
    dirs = write_bair_records(os.path.join(WORK_DIR, "records"))
    run_dir = records_train_phase(dirs, per_step, dev)
    records_eval_phase(dirs, run_dir)
    records_timing_phase(dirs, run_dir, dev, ident)
    return dirs


# ---------------------------------------------------------------------------
# the action-conditioned zoo files (phase 20)
# ---------------------------------------------------------------------------
AC_ZOO = (("dna", "dna_l2"), ("sna", "sna_l2"), ("savp", "ours_gan"))  # model, hparams/bair/<file>
AC_TRAIN_STEPS = 3
AC_STEM_CHANNELS = 3 + 4 + 3  # image, action, state; no z (nz=0)
# one rollout a step on the single batch (nz=0: no doubled rollout); dna has
# no CDNA transformation, so no K1; its 3 candidates (DNA, previous, scratch)
# take K3's run-time instantiation
AC_PER_ROLLOUT = {"dna": {**LAUNCHES_PER_ROLLOUT, "apply_cdna_kernels": 0}, "sna": LAUNCHES_PER_ROLLOUT,
                  "savp": LAUNCHES_PER_ROLLOUT}
# phase 20's GPU-against-CPU rollouts: the generator options, each under use_states
AC_VARIANTS = {
    "dna": dict(transformation="dna"),
    "stp": dict(transformation="stp"),
    "flow": dict(transformation="flow"),
    "direct": dict(transformation="direct"),
    "gru": dict(conv_rnn="gru"),
    "context_images_background": dict(context_images_background=True),
    "learn_initial_state": dict(learn_initial_state=True),
    "deconv2d": dict(upsample_layer="deconv2d"),
    "max_pool_conv2d": dict(downsample_layer="max_pool_conv2d"),
}


def ac_hparams(model: str, zoo: str, **extra):
    """``model``'s defaults overridden by ``hparams/bair/<zoo>``, then ``extra``."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class

    path = zoo_dir() / "bair" / zoo / "model_hparams.json"
    return resolve_model_hparams(get_model_class(model).default_hparams(), str(path), extra=extra or None)


def ac_train_phase(dirs: dict) -> tuple:
    """Phase 20, train: ``train``'s ``main`` on phase 19's BAIR records with
    ``--dataset_hparams use_state=True``, each zoo file at full width, batch
    16, TF32 convs, 3 steps: finite losses with a ``state`` term where
    ``state_weight > 0``, the launches per step, the stem conv's input
    channels. Returns the run directories by model, and ``dna``'s launches."""
    import shutil

    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.train.checkpoint import PARAMS_FILE, checkpoint_file

    set_tf32_default()
    runs, dna_launches = {}, None
    for model, zoo in AC_ZOO:
        run_dir = os.path.join(WORK_DIR, f"ac_{zoo}")
        shutil.rmtree(run_dir, ignore_errors=True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        summary = train_main([
            "--dataset", "bair", "--input_dir", dirs["train"], "--dataset_hparams", "use_state=True",
            "--model", model, "--model_hparams_dict", str(zoo_dir() / "bair" / zoo / "model_hparams.json"),
            "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH), "--max_steps", str(AC_TRAIN_STEPS),
            "--device", "cuda", "--progress_freq", "1", "--save_freq", "1000", "--eval_summary_freq", "0",
            "--accum_eval_summary_freq", "0", "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        with open(os.path.join(run_dir, "model_hparams.json")) as f:
            state_weight = json.load(f)["state_weight"]
        stem = torch.load(checkpoint_file(run_dir, PARAMS_FILE),
                          weights_only=True)["generator.cell.stem.weight"].shape[1]
        print(f"train {model} (bair/{zoo}) on records, use_state=True: {AC_TRAIN_STEPS} steps, {wall:.2f} s wall; "
              f"losses {summary['scalars']}; launches {launches}; stem input channels {stem}")
        check(summary["all_finite"] and summary["step"] == AC_TRAIN_STEPS, f"train {zoo}: {summary}")
        check(("g/state" in summary["scalars"]) == bool(state_weight),
              f"train {zoo}: state_weight {state_weight}, loss terms {sorted(summary['scalars'])}")
        want = train_launches(ac_hparams(model, zoo), AC_TRAIN_STEPS, AC_PER_ROLLOUT[model])
        check(launches == want, f"train {zoo}: launches {launches}, want {want}")
        check(stem == AC_STEM_CHANNELS, f"train {zoo}: stem input channels {stem}, want {AC_STEM_CHANNELS}")
        runs[model] = run_dir
        if model == "dna":
            dna_launches = launches
    return runs, dna_launches


def ac_cpu_vs_gpu_phase(dev) -> None:
    """Phase 20: the GPU rollout (kernels) against the CPU rollout (plain
    versions) of the same weights, batch and z for each generator option of
    ``AC_VARIANTS`` under ``use_states`` (``bair/ours_savp`` at ngf=8, 64 px,
    12 frames, batch 2, TF32 off; the zero-initialized ``stp_head`` and
    ``init_state_*`` filled with seeded values), ``gen_images`` and
    ``gen_states`` within phase 6's tolerance; then one ``dna_l2`` train step
    under phase 9's."""
    from video_prediction_torch.models import get_model_class, input_dims

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_batch(2, seed=20, device="cpu")
    z = torch.randn(2, 11, 8, generator=torch.Generator().manual_seed(20))
    worst = {}
    for name, extra in AC_VARIANTS.items():
        hp = ac_hparams("savp", "ours_savp", ngf=8, use_states=True, **extra)
        model = get_model_class("savp")(hp, **input_dims(hp, batch))
        g = torch.Generator().manual_seed(20)
        model.init_weights(g)
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if "stp_head.weight" in pname or "init_state_" in pname:
                    p.copy_(0.05 * torch.randn(p.shape, generator=g))
        gpu_model = copy.deepcopy(model).to(dev).eval()
        with torch.inference_mode():
            ref = model.eval()(batch, zs_prior=z)
            out = gpu_model({k: v.to(dev) for k, v in batch.items()}, zs_prior=z.to(dev))
        errs = [float((out[k].cpu() - ref[k]).abs().max()) for k in ("gen_images", "gen_states")]
        worst[name] = errs
        check(all(bool(torch.isfinite(out[k]).all()) for k in ("gen_images", "gen_states")), f"{name}: not finite")
        check(max(errs) <= ROLLOUT_TOL, f"{name} rollout GPU vs CPU: gen_images {errs[0]}, gen_states {errs[1]}")
    print("rollout GPU vs CPU, bair/ours_savp with use_states, ngf=8, batch 2, fp32 (TF32 off), max_abs_err "
          f"gen_images / gen_states (tol {ROLLOUT_TOL}): "
          + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in worst.items()))
    train_cpu_vs_gpu_phase(dev, "dna", ac_hparams("dna", "dna_l2"))
    set_tf32_default()


def dna_taps(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """The JAX package's form of ``apply_dna_kernels`` (``ops/cdna.py:87-115``):
    kh*kw shifted multiply-adds, 75 eager ops a call; timed beside the port's
    unfold form."""
    b, h, w, kh, kw, n = kernels.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    padded = torch.nn.functional.pad(image, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    acc = torch.zeros((b, n, h, w, image.shape[-1]), dtype=torch.float32, device=image.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + padded[:, None, i:i + h, j:j + w].float() * kernels[:, :, :, i, j, :].permute(0, 3, 1, 2)[..., None]
    return acc.to(image.dtype)


def dna_op_phase(dev, ident: str) -> None:
    """Phase 20, ``apply_dna_kernels`` (torch ops, no hand kernel): the
    port's unfold form against the JAX package's 25 shifted multiply-adds
    (``dna_taps``) on the card, then the device time per call of each, in
    turns (port, JAX form, JAX form, port), the forward at the rollout
    batches 8 and 64 and at the train step's 16, and forward with backward
    at 16, beside the bound. A call is several PyTorch kernels, so its time
    is ``queued_ms``'s: CUDA events around 20 calls queued behind a sleep
    kernel, the device's work and the gaps between its kernels, not the
    host's pace."""
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import queued_ms
    from video_prediction_torch.ops.cdna import apply_dna_kernels, normalize_kernels

    def in_turns(call) -> str:
        port, jax_form = [], []
        for f in (apply_dna_kernels, dna_taps, dna_taps, apply_dna_kernels):
            for _ in range(3):
                call(f)
            (port if f is apply_dna_kernels else jax_form).append(queued_ms(lambda: call(f), 20))
        return (f"device (queued) {' / '.join(f'{t:.4f}' for t in port)} ms a call (the JAX package's shifted "
                f"multiply-adds {' / '.join(f'{t:.4f}' for t in jax_form)} ms; in turns)")

    g = torch.Generator(device=dev).manual_seed(21)
    for b in (8, 16, 64):
        image = torch.rand(b, 64, 64, 3, generator=g, device=dev)
        kern = normalize_kernels(torch.randn(b, 64, 64, 5, 5, 1, generator=g, device=dev), "relu")
        err, ok = max_err(apply_dna_kernels(image, kern), dna_taps(image, kern), "float32")
        check(ok, f"apply_dna_kernels disagrees with the shifted multiply-adds at batch {b}: {err}")
        nbytes, ops = RL.dna_forward(b, 64, 64, 3)
        print(f"apply_dna_kernels forward batch {b}: {in_turns(lambda f: f(image, kern))}; bound "
              f"{RL.bound_ms(nbytes, ops):.5f} ms by {RL.bound_by(nbytes, ops)}; max_abs_err {err:.3g} [{ident}]")
        if b == 16:
            grad = torch.randn(b, 1, 64, 64, 3, generator=g, device=dev)
            leaves = [image.requires_grad_(), kern.requires_grad_()]
            nbytes += RL.dna_backward(b, 64, 64, 3)[0]
            print(f"apply_dna_kernels forward and backward batch {b}: "
                  f"{in_turns(lambda f: torch.autograd.grad(f(*leaves), leaves, grad))}; bound "
                  f"{RL.bound_ms(nbytes):.5f} ms [{ident}]")


def composite_k3_entry(dev, launches: dict) -> dict:
    """Phase 20: K3 at ``dna_l2``'s 3 candidates and the train step's batch
    16 (its run-time instantiation), forward and backward, against the plain
    version, timed, with the launches of phase 20's ``dna`` train steps: the
    ``kernels`` line's entry for K = 3."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import device_ms
    from video_prediction_torch.kernels.composite import device_plan

    g = torch.Generator(device=dev).manual_seed(22)
    b = TRAIN_BATCH
    cand = torch.rand(b, 3, 64, 64, 3, generator=g, device=dev)
    logits = torch.randn(b, 64, 64, 3, generator=g, device=dev) * 3.0
    grad = torch.randn(b, 64, 64, 3, generator=g, device=dev)
    check(device_plan(cand, logits).staged == 0, "K3 at 3 candidates should take the run-time instantiation")
    out, _ = K.composite(cand, logits)
    err, ok = max_err(out, K.composite_reference(cand, logits)[0], "float32")
    check(ok, f"K3 at K=3 disagrees with its plain version: {err}")
    berrs = []
    for got, want in zip(K.composite_backward(cand, logits, grad),
                         plain_grads(lambda a, m: K.composite_reference(a, m)[0], (cand, logits), (grad,))):
        e, ok = max_err(got, want, "float32")
        check(ok, f"K3 backward at K=3 disagrees with plain autograd: {e}")
        berrs.append(e)
    entry = dict(
        name="composite_k3", route="cuda", source="video_prediction_torch/kernels/csrc/composite.cu",
        replaces="video_prediction_tpu/ops/pallas_kernels.py:198", shapes=f"[{b},3,64,64,3], [{b},64,64,3]",
        max_abs_err=err, ms=cuda_ms(lambda: K.composite(cand, logits)),
        plain_ms=cuda_ms(lambda: K.composite_reference(cand, logits)),
        device_ms=device_ms(lambda: K.composite(cand, logits), "K3"), library_ms=None,
        launches=launches["composite"], launches_per_train_step=launches["composite"] // AC_TRAIN_STEPS,
        launches_per_rollout=AC_PER_ROLLOUT["dna"]["composite"],
    )
    roofline(entry, RL.composite_forward(b, 3))
    backward = dict(
        max_abs_err=max(berrs), ms=cuda_ms(lambda: K.composite_backward(cand, logits, grad)),
        plain_ms=plain_backward_ms(lambda a, m: K.composite_reference(a, m)[0], (cand, logits), (grad,)),
        device_ms=device_ms(lambda: K.composite_backward(cand, logits, grad), "K3"),
        launches=launches["composite_backward"],
    )
    entry["backward"] = roofline(backward, RL.composite_backward(b, 3))
    print(timing_line(f"K3 at K=3 per call, fp32, batch {b}", entry))
    print(timing_line(f"K3 backward at K=3 per call, fp32, batch {b}", backward))
    return entry


def ac_timing_phase(dev, ident: str) -> None:
    """Phase 20, times (TF32 convs): the ``dna_l2`` train step at batch 16 on
    a fixed device batch (5 steps after 2, CUDA-synchronised host clock) and
    its peak device memory; its no-grad rollout at batch 8 and 64."""
    from video_prediction_torch.models import get_model_class, input_dims
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    set_tf32_default()
    hp = ac_hparams("dna", "dna_l2", batch_size=TRAIN_BATCH)
    data = synthetic_batch(TRAIN_BATCH, seed=23, device=dev)
    model = get_model_class("dna")(hp, **input_dims(hp, data))
    ts = create_train_state(model, 0, dev)
    step = make_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(ts, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        scalars = step(ts, data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    check(all(bool(torch.isfinite(v)) for v in scalars.values()), "timed dna_l2 steps gave non-finite losses")
    print(f"dna_l2 train step batch {TRAIN_BATCH}, TF32 convs: {ms:.2f} ms, {TRAIN_BATCH * 10 / ms * 1e3:.1f} "
          f"frames/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{ident}]")
    model.eval()
    for bsz in (8, 64):
        batch = synthetic_batch(bsz, seed=24, device=dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(batch), iters=10, warmup=3)
        print(f"dna_l2 rollout batch {bsz}, TF32 convs: {ms:.2f} ms, {bsz * 10 / ms * 1e3:.0f} generated frames/s "
              f"[{ident}]")
    del ts, step, model
    torch.cuda.empty_cache()


def ac_phase(dirs: dict, dev, ident: str) -> dict:
    """Phase 20: ``bair/dna_l2``, ``bair/sna_l2`` and ``bair/ours_gan`` through
    train, evaluate and generate on the records, the generator options GPU
    against CPU, the DNA op, K3 at 3 candidates and the times. Returns the
    K = 3 entry of the ``kernels`` line."""
    t0 = time.perf_counter()
    runs, dna_launches = ac_train_phase(dirs)
    for model, run_dir in runs.items():
        records_eval_phase(dirs, run_dir, model, AC_PER_ROLLOUT[model], label=f" {model}")
    ac_cpu_vs_gpu_phase(dev)
    dna_op_phase(dev, ident)
    entry = composite_k3_entry(dev, dna_launches)
    ac_timing_phase(dev, ident)
    print(f"phase 20 (action-conditioned zoo): {time.perf_counter() - t0:.2f} s wall")
    return entry


# ---------------------------------------------------------------------------
# the training objectives (phase 21)
# ---------------------------------------------------------------------------
# bair/ours_savp+objectives: the bair/ours_savp zoo file with every objective
# the JAX package has beyond it switched on (the vgg_weights_path is phase
# 14's seeded .npz)
OBJECTIVES = dict(learn_prior=True, z_l1_weight=1.0, image_sn_gan_weight=0.1, image_sn_vae_gan_weight=0.1,
                  acvideo_sn_gan_weight=0.1, acvideo_sn_vae_gan_weight=0.1, vgg_cdist_weight=1.0)
OBJ_TRAIN_STEPS = 4  # 3 steps, then a resumed 4th
OBJ_G_TERMS = sorted(["l1", "vgg_cdist", "kl", "z_l1"] + [f"{d}_{k}" for d in ("acvideo", "image", "video")
                                                          for k in ("gan", "vae_gan", "vae_gan_feat")])
OBJ_D_TERMS = sorted(f"{d}_{k}_{s}" for d in ("acvideo", "image", "video") for k in ("gan", "vae_gan")
                     for s in ("real", "fake"))
# phase 21's GPU-against-CPU train steps: each objective alone on bair/ours_savp
# without its video GANs, the KL unannealed so that it enters
OBJ_ALONE = {
    "learn_prior": dict(learn_prior=True),
    "z_l1": dict(z_l1_weight=1.0),
    "image_gan": dict(image_sn_gan_weight=0.1, image_sn_vae_gan_weight=0.1),
    "acvideo_gan": dict(acvideo_sn_gan_weight=0.1, acvideo_sn_vae_gan_weight=0.1),
    "vgg_cdist": dict(vgg_cdist_weight=1.0),
}
# z_l1 alone: the median leaf within 5e-4, not phase 9's 1e-4. Its gradient
# reaches the generator through the posterior's instance norms of the
# generated frames and amplifies the convs' rounding more than the
# flagship's: on an H100 at ngf=8 (TF32 off) its median leaf read 1.37e-4
# with cuDNN's convs and 8.17e-4 with PyTorch's own, the flagship's 3.84e-5
# with PyTorch's own, its loss terms within 1e-7 either way, and every leaf
# within phase 9's 1e-2 (worst 5.4e-3). Phase 21 measures it again with
# PyTorch's own convs (``objectives_cpu_vs_gpu_phase``)
Z_L1_GRAD_MEDIAN_TOL = 5e-4
# the learn_prior eval rollout GPU against CPU (TF32 off), gen_images, the
# prior's statistics and the z it took
LEARN_PRIOR_ROLLOUT_TOL = 1e-5


def objectives_hparams(vgg_path: str, **extra):
    """``bair/ours_savp`` with ``OBJECTIVES`` and ``vgg_path``, then ``extra``."""
    return ac_hparams("savp", "ours_savp", **OBJECTIVES, vgg_weights_path=vgg_path, **extra)


def objectives_train_phase(dirs: dict, vgg_path: str) -> tuple:
    """Phase 21, train: ``train``'s ``main`` on phase 19's BAIR records read
    with ``use_state=True`` (so with their 4-D actions; the model leaves the
    states unused) with ``bair/ours_savp`` and every objective, batch 16, TF32
    convs, 3 steps, then ``--resume`` to a 4th: finite losses, every term,
    the launches per step against phase 8's. Returns the run directory and
    the launches of the 4 steps."""
    import shutil

    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.train.checkpoint import PARAMS_FILE, checkpoint_file

    set_tf32_default()
    run_dir = os.path.join(WORK_DIR, "objectives")
    shutil.rmtree(run_dir, ignore_errors=True)
    overrides = ",".join(f"{k}={v}" for k, v in OBJECTIVES.items()) + f",vgg_weights_path={vgg_path}"
    argv = ["--dataset", "bair", "--input_dir", dirs["train"], "--dataset_hparams", "use_state=True",
            "--model", "savp", "--model_hparams_dict", str(zoo_dir() / "bair" / "ours_savp" / "model_hparams.json"),
            "--model_hparams", overrides, "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH),
            "--device", "cuda", "--progress_freq", "1", "--save_freq", "1000", "--eval_summary_freq", "0",
            "--accum_eval_summary_freq", "0", "--seed", "0"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_main(argv + ["--max_steps", str(OBJ_TRAIN_STEPS - 1)])
    resumed = train_main(argv + ["--max_steps", str(OBJ_TRAIN_STEPS), "--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    scalars = resumed["scalars"]
    print(f"train bair/ours_savp+objectives on records: {OBJ_TRAIN_STEPS - 1} steps then a resumed "
          f"{OBJ_TRAIN_STEPS}th, {wall:.2f} s wall; losses {scalars}; launches {launches}")
    check(first["all_finite"] and resumed["all_finite"], "train with the objectives gave non-finite losses")
    check((resumed["start_step"], resumed["step"]) == (OBJ_TRAIN_STEPS - 1, OBJ_TRAIN_STEPS),
          f"the resumed run did not continue: {resumed}")
    g_terms = sorted(k[2:] for k in scalars if k.startswith("g/"))
    d_terms = sorted(k[2:] for k in scalars if k.startswith("d/"))
    check(g_terms == OBJ_G_TERMS and d_terms == OBJ_D_TERMS, f"loss terms g {g_terms}, d {d_terms}")
    # one doubled-batch rollout (prior and posterior) a step, recomputed, and its backward, as phase 8
    want = train_launches(objectives_hparams(vgg_path), OBJ_TRAIN_STEPS)
    check(launches == want, f"train with the objectives: launches {launches}, want {want}")
    params = torch.load(checkpoint_file(run_dir, PARAMS_FILE), weights_only=True)
    check(any(k.startswith("generator.cell.prior.") for k in params) and not any("vgg" in k for k in params),
          "the checkpoint should hold the learned prior and no VGG weights")
    return run_dir, launches


def objectives_cpu_vs_gpu_phase(dev, vgg_path: str) -> None:
    """Phase 21: one train step of each objective alone (``OBJ_ALONE``) on the
    CPU and on the GPU under phase 9's rule (``z_l1``'s median leaf under
    ``Z_L1_GRAD_MEDIAN_TOL``), and one ``learn_prior`` eval
    rollout of the all-objectives model, GPU against CPU within
    ``LEARN_PRIOR_ROLLOUT_TOL``, ngf=8, 64 px, TF32 off."""
    from video_prediction_torch.models import get_model_class, input_dims

    alone = {}
    for name, extra in OBJ_ALONE.items():
        if "vgg_cdist_weight" in extra:
            extra = dict(extra, vgg_weights_path=vgg_path)
        print(f"objective alone: {name}")
        alone[name] = ac_hparams("savp", "ours_savp", video_sn_gan_weight=0.0, video_sn_vae_gan_weight=0.0,
                                 kl_anneal="none", **extra)
        train_cpu_vs_gpu_phase(dev, "savp", alone[name],
                               Z_L1_GRAD_MEDIAN_TOL if name == "z_l1" else TRAIN_GRAD_MEDIAN_TOL)
    # the measurement behind Z_L1_GRAD_MEDIAN_TOL: z_l1 and the flagship with
    # PyTorch's own convs in place of cuDNN's, read and not held to a median
    torch.backends.cudnn.enabled = False
    try:
        print("z_l1 alone and the flagship, PyTorch's own convs (cuDNN off):")
        medians = {name: train_cpu_vs_gpu_phase(dev, "savp", hp, 1.0)
                   for name, hp in (("z_l1", alone["z_l1"]), ("flagship", slice_hparams()))}
    finally:
        torch.backends.cudnn.enabled = True
    print(f"median leaf gradient error with PyTorch's own convs: z_l1 {medians['z_l1']:.3g}, flagship "
          f"{medians['flagship']:.3g} ({medians['z_l1'] / medians['flagship']:.1f} times)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = objectives_hparams(vgg_path, ngf=8, nef=8, ndf=8)
    batch = synthetic_batch(2, seed=21, device="cpu")
    model = get_model_class("savp")(hp, **input_dims(hp, batch))
    model.init_weights(torch.Generator().manual_seed(21))
    gpu_model = copy.deepcopy(model).to(dev).eval()
    eps = torch.randn(2, 11, 8, generator=torch.Generator().manual_seed(21))
    with torch.inference_mode():
        ref = model.eval()(batch, zs_prior=eps)
        out = gpu_model({k: v.to(dev) for k, v in batch.items()}, zs_prior=eps.to(dev))
    keys = ("gen_images", "prior_mu", "prior_logvar", "zs_sampled_prior")
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) for k in keys}
    print(f"learn_prior rollout GPU vs CPU, all objectives, ngf=8, batch 2, fp32 (TF32 off): max_abs_err {errs} "
          f"(tol {LEARN_PRIOR_ROLLOUT_TOL})")
    check(all(bool(torch.isfinite(out[k]).all()) for k in keys), "learn_prior rollout: not finite")
    check(max(errs.values()) <= LEARN_PRIOR_ROLLOUT_TOL, f"learn_prior rollout GPU vs CPU: {errs}")
    set_tf32_default()


def objectives_timing_phase(dev, ident: str, vgg_path: str) -> None:
    """Phase 21, times (TF32 convs): the train step of ``bair/ours_savp+objectives``
    and of the flagship at batch 16 on a fixed device batch (median of 7 steps
    after 2, each a CUDA-synchronised host clock) with the objectives' peak
    device memory; the no-grad ``learn_prior`` rollout at batch 8 and 64
    beside the flagship's, in turns."""
    import statistics

    from video_prediction_torch.models import get_model_class, input_dims
    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step

    set_tf32_default()
    data = synthetic_batch(TRAIN_BATCH, seed=25, device=dev)
    models = {}
    for label, hp in (("objectives", objectives_hparams(vgg_path, batch_size=TRAIN_BATCH)),
                      ("flagship", slice_hparams().replace(batch_size=TRAIN_BATCH))):
        model = get_model_class("savp")(hp, **input_dims(hp, data))
        ts = create_train_state(model, 0, dev)
        step = make_train_step(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(ts, data)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scalars = step(ts, data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(all(bool(torch.isfinite(v)) for v in scalars.values()), f"timed {label} steps gave non-finite losses")
        ms = statistics.median(times)
        print(f"{label} train step batch {TRAIN_BATCH}, TF32 convs: median {ms:.2f} ms of 7 "
              f"({min(times):.2f}-{max(times):.2f}), {TRAIN_BATCH * 10 / ms * 1e3:.1f} frames/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{ident}]")
        models[label] = model.eval()
        del ts, step
    for bsz in (8, 64):
        batch = synthetic_batch(bsz, seed=26, device=dev)
        eps = torch.randn(bsz, 11, 8, device=dev, generator=torch.Generator(device=dev).manual_seed(26))
        turns = {label: [] for label in models}
        for label in ("objectives", "flagship", "flagship", "objectives"):
            with torch.inference_mode():
                turns[label].append(cuda_ms(lambda: models[label](batch, zs_prior=eps), iters=10, warmup=3))
        print(f"rollout batch {bsz}, TF32 convs, in turns: learn_prior (objectives) "
              f"{' / '.join(f'{t:.2f}' for t in turns['objectives'])} ms, flagship "
              f"{' / '.join(f'{t:.2f}' for t in turns['flagship'])} ms [{ident}]")
    del models
    torch.cuda.empty_cache()


def objectives_phase(dirs: dict, dev, ident: str, vgg_path: str, kernel_results: list) -> None:
    """Phase 21: ``bair/ours_savp+objectives`` through train (with a resume),
    evaluate and generate on the records; each objective GPU against CPU; the
    times. Adds the launches of its 4 train steps to each kernel's entry of
    the ``kernels`` line under ``"objectives"``."""
    t0 = time.perf_counter()
    run_dir, launches = objectives_train_phase(dirs, vgg_path)
    for entry in kernel_results:
        if entry["name"] in launches:
            entry["objectives"] = {"launches": launches[entry["name"]],
                                   "launches_per_train_step": launches[entry["name"]] // OBJ_TRAIN_STEPS}
    records_eval_phase(dirs, run_dir, "savp", LAUNCHES_PER_ROLLOUT, label=" objectives")
    objectives_cpu_vs_gpu_phase(dev, vgg_path)
    objectives_timing_phase(dev, ident, vgg_path)
    print(f"phase 21 (training objectives): {time.perf_counter() - t0:.2f} s wall")


# ---------------------------------------------------------------------------
# phases 22-23: the port's bench (python -m video_prediction_torch.bench) and
# the dna_l2 profile
# ---------------------------------------------------------------------------
BENCH_GEN_BATCH = 256  # the bench's generation row: 64 examples x 4 samples in one rollout
BENCH_ROWS = ("batch16", "batch32", "batch64")


def bench_kernel_entries(dev) -> dict:
    """Phase 22, first: K1 and K3 (fp32) and K2 (bf16, the bench's gates)
    forward at the shapes of the bench's generation row (batch 256), each
    against its plain version under phase 3's tolerances, then timed: device
    time (K2 a generator step of six calls), host-paced ``ms`` and
    ``plain_ms``, bytes and bound; K1 also against its grouped-conv
    yardstick. Returns {wrapper: entry}."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import device_ms, ln_gate_step_ms, ln_gate_widths, ln_inputs

    b = BENCH_GEN_BATCH
    g = torch.Generator(device=dev).manual_seed(b)
    entries = {}

    image = torch.rand(b, 64, 64, 3, generator=g, device=dev)
    kern = torch.softmax(torch.randn(b, 25, 4, generator=g, device=dev), dim=1).reshape(b, 5, 5, 4).contiguous()
    err, ok = max_err(K.apply_cdna_kernels(image, kern), K.apply_cdna_kernels_reference(image, kern), "float32")
    check(ok, f"K1 fp32 at batch {b} disagrees with its plain version: {err}")
    e = dict(shapes=f"[{b},64,64,3]x[{b},5,5,4]", max_abs_err=err,
             ms=cuda_ms(lambda: K.apply_cdna_kernels(image, kern), iters=20),
             plain_ms=cuda_ms(lambda: K.apply_cdna_kernels_reference(image, kern), iters=5, warmup=1),
             device_ms=device_ms(lambda: K.apply_cdna_kernels(image, kern), "K1"))
    x, wt = cdna_as_grouped_conv(image, kern)
    with NoTF32():
        lib = cdna_library_forward(x, wt, b * 3).view(b, 3, 4, 64, 64).permute(0, 2, 3, 4, 1)
        lerr, lok = max_err(lib, K.apply_cdna_kernels(image, kern), "float32")
        check(lok, f"K1's grouped-conv yardstick disagrees with K1 at batch {b}: {lerr}")
        e["library_ms"] = device_ms(lambda: cdna_library_forward(x, wt, b * 3))
    entries["apply_cdna_kernels"] = roofline(e, RL.cdna_forward(b, 64, 64, 3))
    del image, kern, x, wt, lib

    err, ms, plain_ms = 0.0, {}, {}
    for cdim, px in sorted(set(RL.LN_GATE_STEP)):
        z, c, lnp, _, _ = ln_inputs(g, b * px * px, cdim, dev, torch.bfloat16)
        errs = [max_err(o, r, "bfloat16") for o, r in zip(K.fused_ln_gate(z, c, lnp),
                                                           K.fused_ln_gate_reference(z, c, lnp))]
        check(all(ok for _, ok in errs), f"K2 bf16 at batch {b} C={cdim} disagrees with its plain version: {errs}")
        err = max(err, *(e for e, _ in errs))
        ms[cdim] = cuda_ms(lambda: K.fused_ln_gate(z, c, lnp), iters=10)
        plain_ms[cdim] = cuda_ms(lambda: K.fused_ln_gate_reference(z, c, lnp), iters=3, warmup=1)
        del z, c
    widths = ln_gate_widths(lambda z, c, lnp, *_: K.fused_ln_gate(z, c, lnp), b, dev, 10, dtype=torch.bfloat16)
    e = dict(shapes=f"bf16, R={', '.join(str(b * px * px) for _, px in sorted(set(RL.LN_GATE_STEP)))} at "
                    f"C={', '.join(str(c) for c, _ in sorted(set(RL.LN_GATE_STEP)))}, 6 calls a step",
             max_abs_err=err, ms=ln_gate_step_ms(ms), plain_ms=ln_gate_step_ms(plain_ms),
             device_ms=ln_gate_step_ms(widths), per_width_ms={str(c): t for c, t in widths.items()}, library_ms=None)
    entries["fused_ln_gate"] = roofline(e, RL.ln_gate_forward(RL.ln_gate_step(b), itemsize=2))

    cand = torch.rand(b, 7, 64, 64, 3, generator=g, device=dev)
    logits = torch.randn(b, 64, 64, 7, generator=g, device=dev) * 3.0
    err, ok = max_err(K.composite(cand, logits)[0], K.composite_reference(cand, logits)[0], "float32")
    check(ok, f"K3 fp32 at batch {b} disagrees with its plain version: {err}")
    e = dict(shapes=f"[{b},7,64,64,3]", max_abs_err=err, ms=cuda_ms(lambda: K.composite(cand, logits), iters=20),
             plain_ms=cuda_ms(lambda: K.composite_reference(cand, logits), iters=5, warmup=1),
             device_ms=device_ms(lambda: K.composite(cand, logits), "K3"), library_ms=None)
    entries["composite"] = roofline(e, RL.composite_forward(b, 7))
    del cand, logits
    for name, e in entries.items():
        print(timing_line(f"{name} forward at batch {b} ({e['shapes']}), max_abs_err {e['max_abs_err']:.3g}", e))
    torch.cuda.empty_cache()
    return entries


def bench_row_kernel_checks(dev) -> dict:
    """Phase 22, second: every kernel the bench's train rows launch, at each
    row's doubled batch (2 x 16, 32, 64: the prior and the posterior
    rollout), in the row's dtype (K1 and K3 fp32, K2 bf16), forward against
    its plain version and backward against autograd of its plain version,
    under phases 3 and 4's tolerances (the batch-256 forwards of the
    generation row: ``bench_kernel_entries``). Returns {wrapper: {batch:
    max_abs_err}}."""
    from video_prediction_torch import bench
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import ln_inputs

    def held(name, b, outs, refs, kinds, dt):
        errs = []
        for out, ref, kind in zip(outs, refs, kinds):
            err, ok = reduction_err(out, ref) if kind == "sum" else max_err(out, ref, dt)
            check(ok, f"{name} {dt} at the bench's batch {b}: output {len(errs)} disagrees with its plain version: "
                      f"{err}")
            errs.append(err)
        by_batch = found.setdefault(name, {})
        by_batch[str(b)] = max(by_batch.get(str(b), 0.0), *errs)

    def composite_image(a, m):
        return K.composite_reference(a, m)[0]

    found = {}
    for b in (2 * rows for rows in bench.BATCHES):
        g = torch.Generator(device=dev).manual_seed(b)
        image = torch.rand(b, 64, 64, 3, generator=g, device=dev)
        kern = torch.softmax(torch.randn(b, 25, 4, generator=g, device=dev), dim=1).reshape(b, 5, 5, 4).contiguous()
        grad = torch.randn(b, 4, 64, 64, 3, generator=g, device=dev)
        held("apply_cdna_kernels", b, [K.apply_cdna_kernels(image, kern)],
             [K.apply_cdna_kernels_reference(image, kern)], ("elem",), "float32")
        held("apply_cdna_kernels_backward", b, K.apply_cdna_kernels_backward(image, kern, grad),
             plain_grads(K.apply_cdna_kernels_reference, (image, kern), (grad,)), ("elem", "sum"), "float32")
        del image, kern, grad
        for cdim, px in sorted(set(RL.LN_GATE_STEP)):
            z, c, lnp, dcn, dhn = ln_inputs(g, b * px * px, cdim, dev, torch.bfloat16)
            held("fused_ln_gate", b, K.fused_ln_gate(z, c, lnp), K.fused_ln_gate_reference(z, c, lnp),
                 ("elem", "elem"), "bfloat16")
            held("fused_ln_gate_backward", b, K.fused_ln_gate_backward(z, c, lnp, dcn, dhn),
                 plain_grads(K.fused_ln_gate_reference, (z, c, lnp), (dcn, dhn)), ("elem", "elem", "sum"), "bfloat16")
            del z, c, dcn, dhn
        cand = torch.rand(b, 7, 64, 64, 3, generator=g, device=dev)
        logits = torch.randn(b, 64, 64, 7, generator=g, device=dev) * 3.0
        grad = torch.randn(b, 64, 64, 3, generator=g, device=dev)
        held("composite", b, K.composite(cand, logits, with_masks=True),
             K.composite_reference(cand, logits, with_masks=True), ("elem", "elem"), "float32")
        held("composite_backward", b, K.composite_backward(cand, logits, grad),
             plain_grads(composite_image, (cand, logits), (grad,)), ("elem", "elem"), "float32")
        del cand, logits, grad
    for name, by_batch in found.items():
        print(f"{name} at the bench rows' doubled batches, max_abs_err by batch: "
              f"{', '.join(f'{b}: {e:.3g}' for b, e in by_batch.items())} (tol {TOL}; reductions {REDUCTION_RTOL} "
              f"of max)")
    torch.cuda.empty_cache()
    return found


def bench_step_hparams():
    """The bench's batch-16 row (merged gate convs, bf16 compute and gates,
    ``scan_unroll=0``) at ngf=8, 6 frames, batch 2, the KL at full weight."""
    from video_prediction_torch import bench
    from video_prediction_torch.bench_common import savp_bench_hparams

    return savp_bench_hparams(2, scan_unroll=bench.UNROLL[16], lstm_gate_conv=bench.GATE_CONV[16],
                              gate_dtype=bench.GATE_DTYPE[16], sequence_length=6,
                              extra="ngf=8,nef=8,ndf=8,kl_anneal=none")


def bench_phase(dev, ident: str, kernel_results: list) -> None:
    """Phase 22: the batch-256 forward kernels against their plain versions;
    every kernel of the train rows at each row's doubled batch, forward and
    backward, against its plain version; one GPU train step of the bench's merged-gate bf16 configuration against
    the CPU's (phase 17's rule); then ``video_prediction_torch.bench``'s
    ``main`` at its defaults, which prints its JSON line: each row's launches
    a train step and finite losses, K2 launched in bf16 only, ``mfu`` and
    ``mfu_model`` in (0, 1], the card's name, and the generation row's
    launches a rollout and finite ``acc``. Adds ``"bench"`` to each kernel's
    entry: its launches in the bench's run, its largest error at each
    row's doubled batch and, forward, the batch-256 timings."""
    from video_prediction_torch import bench
    from video_prediction_torch import kernels as K
    from video_prediction_torch.bench_common import savp_bench_hparams

    t0 = time.perf_counter()
    timed = bench_kernel_entries(dev)
    checked = bench_row_kernel_checks(dev)
    check(bench.GATE_CONV[16] == "merged" and bench.GATE_DTYPE[16] == "bfloat16", "the bench's batch-16 row moved")
    bf16_step_check(dev, BF16_STEP_SEEDS[0], bench_step_hparams(), keys=("images",),
                    label=" (the bench's merged-gate bf16 configuration)")
    set_tf32_default()
    torch.cuda.empty_cache()

    K.reset_launch_counts()
    t1 = time.perf_counter()
    line = bench.main([])
    bench_s = time.perf_counter() - t1
    launches = K.launch_counts()
    dtypes = check_launch_dtypes("bench")
    check(sorted(line["rows"]) == sorted(BENCH_ROWS), f"bench rows {sorted(line['rows'])}")
    for key, row in line["rows"].items():
        check(math.isfinite(row["g_loss"]) and math.isfinite(row["d_loss"]), f"bench {key}: non-finite losses")
        # scan_unroll=0 without the CSE barrier: K1-K3 forward and backward once a generator step each
        b = int(key[len("batch"):])
        want = train_launches(savp_bench_hparams(b, scan_unroll=bench.UNROLL[b], lstm_gate_conv=bench.GATE_CONV[b],
                                                 prevent_cse=bench.PREVENT_CSE.get(b, False),
                                                 gate_dtype=bench.GATE_DTYPE[b]))
        check(row["launches_per_step"] == want, f"bench {key}: launches a step {row['launches_per_step']}, want {want}")
        for m in ("mfu", "mfu_model"):
            check(row[m] is not None and 0.0 < row[m] <= 1.0, f"bench {key}: {m} {row[m]} not in (0, 1]")
        check(row["peak_gib"] > 0.0, f"bench {key}: peak_gib {row['peak_gib']}")
    check(line["device_kind"] == ident.split(",")[0].strip(), f"bench device_kind {line['device_kind']!r}, "
                                                              f"nvidia-smi {ident!r}")
    gen = line["generation"]
    want = {**LAUNCHES_PER_ROLLOUT, **{k: 0 for k in BACKWARD}}
    check(gen["effective_batch"] == BENCH_GEN_BATCH, f"bench generation row {gen}")
    check(gen["launches_per_rollout"] == want, f"bench generation launches a rollout {gen['launches_per_rollout']}, "
                                                f"want {want}")
    check(math.isfinite(gen["acc"]), f"bench generation acc {gen['acc']}")
    print(f"bench: {bench_s:.2f} s wall; launches {launches}; by dtype {dtypes}; rows and generation as the line "
          f"above [{ident}]")
    for entry in kernel_results:
        name = entry["name"]
        if name in launches:
            entry["bench"] = {"launches": launches[name], **timed.get(name, {}),
                              "max_abs_err_by_row_batch": checked[name]}
    print(f"phase 22 (bench): {time.perf_counter() - t0:.2f} s wall")


def profile_dna_phase(ident: str) -> None:
    """Phase 23: ``profile_step --model dna --model_hparams_dict bair/dna_l2
    --tf32`` at batch 16 (it prints its top kernels and its summary): a
    whole window (no ``shortfall``), finite losses, the trace kept, K3's
    device time and none of K1 (``dna`` composites 3 candidates and has no
    CDNA)."""
    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train import profile_step

    t0 = time.perf_counter()
    outdir = os.path.join(WORK_DIR, "profile_dna")
    summary = profile_step.main(["--model", "dna", "--model_hparams_dict",
                                 str(zoo_dir() / "bair" / "dna_l2" / "model_hparams.json"), "--tf32",
                                 "--outdir", outdir])
    set_tf32_default()
    check(summary["shortfall"] is None, f"dna_l2 profile: device events short of the launches {summary['shortfall']}")
    check(summary["finite"], "dna_l2 profile: non-finite losses")
    check(os.path.getsize(summary["trace"]) > 0, f"dna_l2 profile: no trace at {summary['trace']}")
    check(summary["device_ms"]["K1"] == 0.0 and summary["device_ms"]["K3"] > 0.0,
          f"dna_l2 profile: device ms by group {summary['device_ms']}")
    print(f"phase 23 (dna_l2 profile): {time.perf_counter() - t0:.2f} s wall; trace {summary['trace']} "
          f"({os.path.getsize(summary['trace'])} bytes) [{ident}]")


# ---------------------------------------------------------------------------
# --steps_per_call: K train steps as one CUDA graph (phase 24)
# ---------------------------------------------------------------------------
SPC = 4  # steps a call
SPC_CALLS = 3  # the first call eager, the second captures and replays, the third replays
SPC_SEED = 24
# graph against eager: each figure within SPC_SPREAD_RATIO times the spread
# of two eager runs of the same steps, plus SPC_FLOOR: one TF32 rounding
# (2^-10) of a figure, should the capture take another cuDNN algorithm than
# the eager step. The runs take cuDNN's deterministic algorithms: with its
# default ones the flagship's (TF32) two eager runs are 0.005 to 0.175 of a
# loss term apart after 12 steps, from one H100 run to the next (PERF.md
# §6), too wide and too variable a spread to hold the graph to. With them,
# and for synthetic/ours_savp (bf16) with either, the graphed run is
# expected to equal its eager run bit for bit
SPC_SPREAD_RATIO = 2.0
SPC_FLOOR = {"loss_rel": 1e-3, "param_rel_l2": 1e-3, "u": 1e-3}
SPC_CLI_STEPS = (10, 12, 16)  # --max_steps 10 overshoots to 12; --resume to 16
SPC_TAGS = ("g_loss", "lr", "schedule_sampling_prob", "kl_weight", "gen_images")


def synthetic_savp_hparams():
    """``savp`` defaults overridden by ``hparams/synthetic/ours_savp`` and the
    crossover run's bf16 gates: the flagship's widths, bf16 compute and
    gates, merged gate convs; batch 16."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class

    zoo = zoo_dir() / "synthetic" / "ours_savp" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo),
                               extra=dict(gate_dtype="bfloat16", batch_size=TRAIN_BATCH))
    got = (hp.ngf, hp.nz, hp.sequence_length, hp.compute_dtype, hp.gate_dtype, hp.lstm_gate_conv)
    check(got == (32, 8, 12, "bfloat16", "bfloat16", "merged"), f"unexpected synthetic/ours_savp config {got}")
    return hp


def spc_configs():
    return (("bair_action_free/ours_savp", slice_hparams().replace(batch_size=TRAIN_BATCH)),
            ("synthetic/ours_savp", synthetic_savp_hparams()))


def spc_stack(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def spc_run(model, dev, batches, k: int) -> dict:
    """``len(batches)`` train steps of a copy of ``model`` on the card, ``k``
    a call, from the same weights and noise seed, with the Adams of SPC
    steps a call either way (capturable, the learning rate a device tensor:
    the same update, where a host-float learning rate rounds its step size
    otherwise, an ulp that 12 steps of this GAN grow to 1e-3 of g_loss):
    every step's scalars, the parameters and buffers after, the launches of
    each call, the peak memory and the ``MultiStep`` (None for k = 1)."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = copy.deepcopy(model).to(dev)
    ts = TrainState(m, *make_optimizers(m, SPC), 0, torch.Generator(device=dev).manual_seed(SPC_SEED))
    step = make_train_step(m, k)
    rows, calls = [], []
    t0 = time.perf_counter()
    for c in range(len(batches) // k):
        K.reset_launch_counts()
        if k == 1:
            s = step(ts, batches[c])
            rows.append(torch.stack([v.float() for v in s.values()])[None])
            keys = list(s)
        else:
            step(ts, spc_stack(batches[c * k:(c + 1) * k]))
            rows.append(step.scalars_by_step)
            keys = step.keys
        torch.cuda.synchronize()
        calls.append(K.launch_dtypes())
    wall = time.perf_counter() - t0
    out = {"keys": keys, "scalars": torch.cat(rows).cpu(), "calls": calls, "wall_s": wall, "step": ts.step,
           "params": {n: p.detach().cpu() for n, p in m.named_parameters()},
           "buffers": {n: b.detach().cpu() for n, b in m.named_buffers()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "multi": step if k > 1 else None}
    del ts, m
    return out


def spc_diff(a: dict, b: dict, init: dict) -> dict:
    """How far run ``b`` is from run ``a``: every step's every loss term
    (relative), each parameter leaf (the L2 of the difference over the L2 of
    the leaf's change from ``init``) and each spectral ``u`` (max abs)."""
    check(a["keys"] == b["keys"], f"loss terms differ: {a['keys']} vs {b['keys']}")
    loss = ((a["scalars"] - b["scalars"]).abs() / a["scalars"].abs().clamp_min(1e-12)).amax(dim=0)
    params = {n: float((a["params"][n] - p).norm() / (a["params"][n] - init[n]).norm().clamp_min(1e-30))
              for n, p in b["params"].items()}
    us = {n: float((a["buffers"][n] - u).abs().max()) for n, u in b["buffers"].items()}
    return {"loss_rel": dict(zip(a["keys"], loss.tolist())), "param_rel_l2": params, "u": us}


def spc_check(label: str, graph: dict, spread: dict) -> dict:
    """Each figure of the graphed run within SPC_SPREAD_RATIO x the eager
    spread + SPC_FLOOR; returns the worst figure of each kind with its
    allowance."""
    worst = {}
    for kind, figures in graph.items():
        allowed = {n: SPC_SPREAD_RATIO * spread[kind][n] + SPC_FLOOR[kind] for n in figures}
        name = max(figures, key=lambda n: figures[n] / allowed[n])
        worst[kind] = (name, figures[name], spread[kind][name], allowed[name])
        over = {n: (v, allowed[n]) for n, v in figures.items() if v > allowed[n]}
        check(not over, f"{label}: graph against eager, {kind} over its allowance: {over}")
    return worst


def spc_timing(model, dev, batches, ident: str, label: str) -> dict:
    """Phase 24 (c): ms a step of the eager step (one a call), the graph of
    SPC steps and a graph of one step (``MultiStep(1)``, which the CLI does
    not offer: the JAX package has no such switch), in turns (eager, graph,
    graph of one, graph of one, graph, eager; SPC steps each, after
    warm-up), and each one's device busy share over one profiled window of
    SPC steps; the graphs' windows also check that the profiler sees every
    kernel the replays launch (``profile_step.window_shortfall``)."""
    from video_prediction_torch.train import profile_step as PS
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import MultiStep, make_train_step

    runs = {}
    for name, k in (("eager", 1), ("graph", SPC), ("graph1", 1)):
        m = copy.deepcopy(model).to(dev)
        ts = TrainState(m, *make_optimizers(m, SPC), 0, torch.Generator(device=dev).manual_seed(SPC_SEED))
        step = MultiStep(1) if name == "graph1" else make_train_step(m, k)
        data = batches[0] if name == "eager" else spc_stack(batches[:k])
        runs[name] = (k, lambda step=step, ts=ts, data=data: step(ts, data), step)
        for _ in range(2):  # a graph: an eager call, then the capture
            runs[name][1]()
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    for name in ("eager", "graph", "graph1", "graph1", "graph", "eager"):
        k, call, _ = runs[name]
        t0 = time.perf_counter()
        for _ in range(SPC // k):
            scalars = call()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / SPC)
        check(all(bool(torch.isfinite(v)) for v in scalars.values()), f"{label}: non-finite timed losses")
    out = {f"{name}_ms": t for name, t in times.items()}
    out["capture_s"] = {name: runs[name][2].capture_s for name in ("graph", "graph1")}
    for name, (k, call, _) in runs.items():
        events, window_ms, _, windows, shortfall = PS.whole_window(
            lambda call=call, k=k: PS.profile_window(call, SPC // k, True, torch.cuda.synchronize))
        busy_ms = PS.union_ms([(a, b) for _, a, b in events]) / SPC
        out[name] = {"window_ms_per_step": window_ms / k, "busy_ms": busy_ms,
                     "busy_share": busy_ms / (window_ms / k), "device_ops": len(events) / SPC,
                     "windows": windows, "shortfall": shortfall or None}
        check(not shortfall, f"{label}: the profiler missed {name} kernels: {shortfall}")
    print(f"steps_per_call {label}: ms a step (in turns) " + "; ".join(
        f"{name} {', '.join(str(t) for t in times[name])}, busy {out[name]['busy_share']} "
        f"({out[name]['busy_ms']} ms, {out[name]['device_ops']} device ops a step)" for name in runs)
        + f"; capture {out['capture_s']} s [{ident}]")
    del runs
    torch.cuda.empty_cache()
    return out


def spc_cli_phase(per_step: dict) -> dict:
    """Phase 24 (d): ``train``'s ``main`` on the flagship at batch 16 with
    ``--steps_per_call 4 --max_steps 10`` (stops at 12: the eager call, the
    capture, a replay), then ``--resume`` to 16; the event file read back
    with the port's reader; the launches of the 16 steps and the two GIF
    rollouts. Returns those launches."""
    import glob
    import shutil

    from video_prediction_torch import kernels as K
    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.utils.summary import Image, read_events

    set_tf32_default()
    run_dir = os.path.join(WORK_DIR, "train_spc")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--dataset", "synthetic", "--model", "savp",
            "--model_hparams_dict", str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
            "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
            "--steps_per_call", str(SPC), "--progress_freq", "4", "--summary_freq", "4",
            "--image_summary_freq", "8", "--save_freq", "8", "--seed", str(SPC_SEED)]
    first_max, first_end, resumed_end = SPC_CLI_STEPS
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_main(argv + ["--max_steps", str(first_max)])
    resumed = train_main(argv + ["--max_steps", str(resumed_end), "--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    check(first["all_finite"] and resumed["all_finite"], "train --steps_per_call produced non-finite losses")
    check((first["start_step"], first["step"], resumed["start_step"], resumed["step"])
          == (0, first_end, first_end, resumed_end), f"unexpected --steps_per_call runs {first}, {resumed}")
    gifs = 2  # at steps 8 and 16: one no-grad rollout each
    want = {k: n * resumed_end + (gifs * LAUNCHES_PER_ROLLOUT.get(k, 0)) for k, n in per_step.items()}
    check(launches == want, f"train --steps_per_call launches {launches}, want {want}")
    files = sorted(glob.glob(os.path.join(run_dir, "events.out.tfevents.*")))
    check(len(files) == 2, f"want one event file a run, got {files}")
    tags, images = {}, 0
    for path in files:
        for event in read_events(path):
            for tag, value in event.values:
                tags.setdefault(tag, []).append(event.step)
                images += isinstance(value, Image)
    missing = [t for t in SPC_TAGS if t not in tags]
    check(not missing, f"event files lack {missing}: {sorted(tags)}")
    check(tags["g_loss"] == [4, 8, 12, 16] and tags["gen_images"] == [8, 16],
          f"summaries at steps {tags['g_loss']}, GIFs at {tags['gen_images']}")
    print(f"train --steps_per_call {SPC}: --max_steps {first_max} stopped at {first['step']}, resumed to "
          f"{resumed['step']}, {wall:.2f} s wall (set-up, capture and checkpoints included); event files "
          f"{[os.path.basename(f) for f in files]}: {len(tags)} tags, {images} GIFs; launches {launches}")
    return launches


def spc_phase(dev, ident: str, per_step: dict, kernel_results: list) -> None:
    """Phase 24: ``--steps_per_call`` as one CUDA graph of SPC train steps,
    for the flagship (TF32 convs) and ``synthetic/ours_savp`` (bf16): (a)
    SPC_CALLS calls of SPC steps against SPC_CALLS x SPC eager steps from the
    same weights, batches and noise seed, within SPC_SPREAD_RATIO times the
    spread of two eager runs plus SPC_FLOOR, with cuDNN's deterministic
    algorithms; (b) the launches of each call,
    eager, captured and replayed, SPC times phase 8's per step, in each
    config's dtypes; (c) ms a step, busy share and capture time
    (``spc_timing``), and the peak memory of each run; (d) the CLI
    (``spc_cli_phase``)."""
    from video_prediction_torch.models import get_model_class

    t_phase = time.perf_counter()
    set_tf32_default()
    n = SPC * SPC_CALLS
    for label, hp in spc_configs():
        model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
        model.init_weights(torch.Generator().manual_seed(SPC_SEED))
        init = {k: v.detach().clone() for k, v in model.named_parameters()}
        batches = [{k: v.to(dev) for k, v in b.items()} for b in spc_host_batches(hp, n)]
        torch.backends.cudnn.deterministic = True  # see SPC_FLOOR
        try:
            eager = spc_run(model, dev, batches, 1)
            again = spc_run(model, dev, batches, 1)
            graph = spc_run(model, dev, batches, SPC)
        finally:
            torch.backends.cudnn.deterministic = False
        per_config = train_launches(hp)  # the flagship recomputes (remat full), synthetic/ours_savp not
        for run, k in ((eager, 1), (graph, SPC)):
            for c, counts in enumerate(run["calls"]):
                want = {name: {dtype_of(hp, name): per * k} for name, per in per_config.items()}
                check(counts == want, f"{label}: launches of call {c} ({k} steps a call) {counts}, want {want}")
        check(graph["step"] == n, f"{label}: the graphed run took {graph['step']} steps, want {n}")
        spread, apart = spc_diff(eager, again, init), spc_diff(eager, graph, init)
        multi = graph["multi"]
        print(f"steps_per_call {label}: eager spread: loss rel {max(spread['loss_rel'].values()):.3g}, leaf L2 "
              f"{max(spread['param_rel_l2'].values()):.3g}, u {max(spread['u'].values()):.3g}; graph against eager:"
              f" loss rel {max(apart['loss_rel'].values()):.3g}, leaf L2 {max(apart['param_rel_l2'].values()):.3g},"
              f" u {max(apart['u'].values()):.3g}; peak {eager['peak_gib']:.2f} GiB eager, {graph['peak_gib']:.2f}"
              f" GiB graphed; capture {multi.capture_s} s; launches a replay {multi.graph_launches} [{ident}]")
        worst = spc_check(label, apart, spread)
        print(f"steps_per_call {label}: worst (name, graph, eager spread, allowance): {worst}")
        timing = spc_timing(model, dev, batches, ident, label)
        del eager, again, graph, multi, batches
        torch.cuda.empty_cache()
        for entry in (e for e in kernel_results if e["name"] in per_step):  # not phase 20's composite_k3
            entry.setdefault("steps_per_call", {})[label] = {
                "launches_per_step": per_config[entry["name"]], "dtype": dtype_of(hp, entry["name"]),
                "eager_ms": timing["eager_ms"], "graph_ms": timing["graph_ms"], "graph1_ms": timing["graph1_ms"]}
    launches = spc_cli_phase(per_step)
    for entry in (e for e in kernel_results if e["name"] in per_step):
        entry.setdefault("steps_per_call", {})["cli_launches"] = launches[entry["name"]]
    print(f"phase 24 (steps_per_call): {time.perf_counter() - t_phase:.2f} s wall")


# ---------------------------------------------------------------------------
# data parallel over torch.distributed (phase 25)
# ---------------------------------------------------------------------------
DP_SEED = 25
DP_STEPS = 3  # (b): K = 1
DP_WORKER = "--data-parallel-rank"  # chip_smoke.py DP_WORKER <job dir> <rank>: one rank of (b) or (c)
DP_TIMEOUT = 300  # seconds for a spawned run; a deadlock fails the phase
DP_CLI_STEPS = (8, 12)  # torchrun: --max_steps 8 (two calls of SPC), then --resume to 12
GRAD_BYTES = 4  # the all-reduce carries the fp32 gradients
DP_REDUCE_CALLS = 5  # all_reduce_mean_ calls in the window that times one alone
DOT_NODE = re.compile(r'^"graph_\d+_node_\d+"\[', re.M)  # a node of cudaGraphDebugDotPrint's output
# KERNEL, MEMCPY, MEMSET, ... after "{"; EVENT_RECORD on the line after the node's ID
DOT_KIND = re.compile(r'label="(?:\{|[^"\n]*\n)\s*(\w+)')
PHASE_MARKS = 4  # event-record nodes a graphed step: start, losses, backward, update (train/step.py#_update)
DOT_KERNEL = re.compile(r'\| \{ID \| [^|]*\| (\S+?)\\<\\<\\<')  # the kernel's mangled name before <<<


def dp_flagship(dev, remat: str = ""):
    """The flagship at batch 16 from DP_SEED's weights, on ``dev``; ``remat``
    a key of REMAT (phase 28) or "" for the zoo file's (``full``)."""
    from video_prediction_torch.models import get_model_class

    hp = slice_hparams().replace(batch_size=TRAIN_BATCH, **REMAT.get(remat, {}))
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(DP_SEED))
    return model.to(dev)


def dp_run(dev, k: int, calls: int, group=None, rank: int = 0, world: int = 1, spatial: int = 1,
           config: str = "flagship", remat: str = "") -> dict:
    """``calls`` calls of ``k`` train steps of the flagship, TF32 off, with
    cuDNN's deterministic algorithms, on this rank's rows of the global
    batches of the synthetic stream (batch 16), from DP_SEED's weights and
    noise seed, data parallel over ``group``: every step's scalars, the
    gradients after the first call, the parameters and buffers after the
    last, the launches and ms a step of each call. The deterministic
    algorithms make each side of (b)'s comparison the same from run to run:
    with cuDNN's default ones a GAN term near 1e-7 read 0.72 of its
    allowance after 3 steps in one run (PERF.md), so the comparison
    would hold or fail by chance. ``spatial`` k > 1: image height sharded
    over spatial groups of k ranks (phase 26), this rank's rows of its data
    coordinate's samples, and the all-reduces of the last call counted
    (``collectives``: calls and MB a step). ``config`` "kth128_<batch>":
    ``kth/ours_savp_128`` at that batch (phase 26 (d)) instead of the
    flagship. ``remat``: the model's ``REMAT`` setting ("": its zoo file's).
    ``peak_mib``: the most memory allocated during the run above what was
    allocated at its start."""
    import torch.distributed as dist

    from video_prediction_torch import kernels as K
    from video_prediction_torch.parallel.mesh import make_spatial_mesh, shard_batch
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.zeros((), device=dev)  # the allocator's statistics exist once it has allocated
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    mesh = make_spatial_mesh(spatial) if spatial > 1 else None
    reduce_calls = []
    try:
        model = (dp_flagship(dev, remat) if config == "flagship" else
                 sp_kth_model(dev, int(config.split("_")[1]), remat))
        ts = TrainState(model, *make_optimizers(model, k), 0, torch.Generator(device=dev).manual_seed(DP_SEED))
        step = make_train_step(model, k, group=group, spatial=mesh)
        host = spc_host_batches(model.hparams, k * calls, model.generator.image_shape[0])
        if mesh is None:
            batches = [shard_batch(b, rank, world) for b in host]
        else:
            batches = [shard_batch(b, mesh.data_rank, mesh.data_size, spatial=(mesh.coord, mesh.k)) for b in host]
        batches = [{key: v.to(dev) for key, v in b.items()} for b in batches]
        rows, launches, ms, grads1 = [], [], [], None
        all_reduce = dist.all_reduce
        for c in range(calls):
            if mesh is not None and c == calls - 1:  # count the last call's collectives
                def counted(tensor, *args, **kwargs):
                    reduce_calls.append(tensor.numel() * tensor.element_size())
                    return all_reduce(tensor, *args, **kwargs)

                dist.all_reduce = counted
            K.reset_launch_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            try:
                if k == 1:
                    scalars = step(ts, batches[c])
                    rows.append(torch.stack([v.float() for v in scalars.values()])[None])
                    keys = list(scalars)
                else:
                    step(ts, spc_stack(batches[c * k:(c + 1) * k]))
                    rows.append(step.scalars_by_step)
                    keys = step.keys
                torch.cuda.synchronize(dev)
            finally:
                dist.all_reduce = all_reduce
            ms.append((time.perf_counter() - t0) * 1e3 / k)
            launches.append(K.launch_counts())
            if c == 0:
                grads1 = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        peak_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    finally:
        torch.backends.cudnn.deterministic = False
        set_tf32_default()
    return {"keys": keys, "scalars": torch.cat(rows).cpu(), "grads1": grads1, "launches": launches, "ms": ms,
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()}, "lr": model.hparams.lr,
            "peak_mib": peak_mib, "batch": model.hparams.batch_size,
            "collectives": {"calls": len(reduce_calls) // k, "mb": sum(reduce_calls) / 1e6 / k} if mesh else None}


def dp_worker(argv) -> int:
    """One rank of phase 25 (b) or (c), or phase 26 (a) or (d), in a process
    of its own: ``DP_WORKER <job dir> <rank>``, the job (backend, world size,
    each rank's device, K, calls, spatial shards, config) in ``<job
    dir>/job.json``; writes ``dp_run``'s readings to ``<job
    dir>/rank<rank>.pt``, or ``{"oom": True}`` where the card ran out of
    memory. A job of one rank runs without a process group."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from video_prediction_torch.parallel.distributed import maybe_initialize

    path, rank = argv[0], int(argv[1])
    with open(os.path.join(path, "job.json")) as f:
        job = json.load(f)
    dev = torch.device(job["devices"][rank])
    if job["world"] > 1:
        maybe_initialize(f"file://{path}/rendezvous", job["world"], rank, backend=job["backend"], device=str(dev))
    try:
        out = dp_run(dev, job["k"], job["calls"], dist.group.WORLD if job["world"] > 1 else None, rank,
                     job["world"], job.get("spatial", 1), job.get("config", "flagship"))
    except torch.cuda.OutOfMemoryError:
        if job["world"] > 1:
            raise
        out = {"oom": True}  # phase 26 (d) asks whether one process fits
    finally:
        if job["world"] > 1:
            dist.destroy_process_group()
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    return 0


def dp_spawn(name: str, backend: str, devices: list, k: int, calls: int, spatial: int = 1,
             config: str = "flagship") -> tuple:
    """Run ``dp_worker`` as ``len(devices)`` processes; returns their readings
    and the wall seconds. Each must exit 0 within DP_TIMEOUT."""
    import shutil

    path = os.path.join(WORK_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    with open(os.path.join(path, "job.json"), "w") as f:
        json.dump({"backend": backend, "world": len(devices), "devices": devices, "k": k, "calls": calls,
                   "spatial": spatial, "config": config}, f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), DP_WORKER, path, str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(len(devices))]
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            outputs.append("(timed out)")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs), f"{name}: ranks exited {[p.returncode for p in procs]} "
          f"(killed after {DP_TIMEOUT} s if negative):\n" + "\n".join(o[-3000:] for o in outputs))
    return [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False) for r in range(len(devices))], wall


def dp_compare(label: str, ref: dict, ranks: list, per_step: dict, k: int) -> dict:
    """Phase 25 (b) and (c): the ranks' parameters and ``u``s equal bit for
    bit; each rank's launches a call K times phase 8's per step; against the
    one-process run on the whole batch, phase 9's rule: every loss term of
    every step within TRAIN_LOSS_RTOL; for K = 1 the first step's gradients,
    the median leaf within TRAIN_GRAD_MEDIAN_TOL of its max and every leaf
    within TRAIN_GRAD_TOL of it plus TRAIN_GRAD_FLOOR of the largest (after
    a call of K > 1 steps the gradient is the K-th step's, on parameters
    that Adam's first steps moved apart where a gradient is at rounding
    level); the parameters within Adam's bound (2 lr a step). Returns the
    figures."""
    first = ranks[0]
    for r, out in enumerate(ranks[1:], 1):
        for kind in ("params", "buffers"):
            differ = [n for n, v in first[kind].items() if not torch.equal(v, out[kind][n])]
            check(not differ, f"{label}: rank {r}'s {kind} differ from rank 0's: {differ[:5]}")
        check(torch.equal(first["scalars"], out["scalars"]), f"{label}: rank {r} reports other scalars")
    for r, out in enumerate(ranks):
        for c, counts in enumerate(out["launches"]):
            want = {name: n * k for name, n in per_step.items()}
            check(counts == want, f"{label}: rank {r}, call {c}: launches {counts}, want {want}")
    check(first["keys"] == ref["keys"], f"{label}: loss terms {first['keys']} vs {ref['keys']}")
    a, b = ref["scalars"], first["scalars"]
    over = (b - a).abs() > TRAIN_LOSS_RTOL * a.abs() + 1e-7
    check(not bool(over.any()), f"{label}: loss terms off at (step, term) {over.nonzero().tolist()}: {b} vs {a}")
    loss_rel = float(((b - a).abs() / a.abs().clamp_min(1e-12)).max())
    share = (b - a).abs() / (TRAIN_LOSS_RTOL * a.abs() + 1e-7)  # of each term's allowance
    worst_at = divmod(int(share.argmax()), a.shape[1])
    figures = {"loss_rel": loss_rel, "loss_share_of_tol": float(share.max()),
               "loss_worst": f"step {worst_at[0] + 1} {ref['keys'][worst_at[1]]} {float(b[worst_at])} against "
                             f"{float(a[worst_at])}"}
    if k == 1:
        gmax = max(float(g.abs().max()) for g in ref["grads1"].values())
        rel = []
        for name, g in ref["grads1"].items():
            scale, err = float(g.abs().max()), float((first["grads1"][name] - g).abs().max())
            check(err <= TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR * gmax,
                  f"{label}: gradient of {name}: max |dg| {err:.3g}, max |g| {scale:.3g}")
            if scale > TRAIN_GRAD_FLOOR * gmax:
                rel.append((err / scale, name))
        rel.sort()
        figures["grad_median"] = rel[len(rel) // 2][0]
        figures["grad_worst"] = rel[-1][0]
        check(figures["grad_median"] <= TRAIN_GRAD_MEDIAN_TOL,
              f"{label}: median leaf gradient error {figures['grad_median']:.3g}")
        grads = (f", the first step's gradients median leaf {figures['grad_median']:.3g} (tol "
                 f"{TRAIN_GRAD_MEDIAN_TOL}), worst {rel[-1][1]} {rel[-1][0]:.3g}")
    else:
        grads = ""
    steps = a.shape[0]
    figures["param_worst"] = max(float((first["params"][n] - v).abs().max()) for n, v in ref["params"].items())
    check(figures["param_worst"] <= 2.0 * ref["lr"] * steps + 1e-6,
          f"{label}: a parameter {figures['param_worst']:.3g} apart")
    print(f"data parallel {label}: {len(ranks)} ranks against one process, {steps} steps: losses within rel "
          f"{loss_rel:.3g} (tol {TRAIN_LOSS_RTOL} + 1e-7; the worst, {figures['loss_worst']}, at "
          f"{figures['loss_share_of_tol']:.3g} of its allowance){grads}, parameters within "
          f"{figures['param_worst']:.3g} (Adam's bound {2.0 * ref['lr'] * steps:.3g}); ranks' parameters and u bit "
          f"for bit; launches a rank a step "
          f"{dict((n, c // k) for n, c in first['launches'][-1].items())}")
    return figures


def dp_graph_run(model, dev, batches, group) -> dict:
    """Phase 25 (a): SPC_CALLS calls of ``MultiStep(SPC)`` on a copy of
    ``model`` under ``group`` (None: no data parallel), as ``spc_run``;
    keeps the train state and a replay for the profile and the timing."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    m = copy.deepcopy(model).to(dev)
    ts = TrainState(m, *make_optimizers(m, SPC), 0, torch.Generator(device=dev).manual_seed(SPC_SEED))
    step = make_train_step(m, SPC, group=group)
    step.keep_graph = True  # for graph_nodes
    rows, calls = [], []
    for c in range(SPC_CALLS):
        K.reset_launch_counts()
        step(ts, spc_stack(batches[c * SPC:(c + 1) * SPC]))
        rows.append(step.scalars_by_step)
        torch.cuda.synchronize()
        calls.append(K.launch_dtypes())
    last = spc_stack(batches[-SPC:])
    return {"keys": step.keys, "scalars": torch.cat(rows).cpu(), "calls": calls, "step": step, "ts": ts,
            "params": {n: p.detach().cpu().clone() for n, p in m.named_parameters()},
            "buffers": {n: b.detach().cpu().clone() for n, b in m.named_buffers()},
            "replay": lambda: step(ts, last)}


def dp_replay_profile(call) -> dict:
    """One profiled call (SPC graphed steps): device events by name, ms a
    step, busy ms a step and busy share (profile_step's window check)."""
    from collections import Counter

    from video_prediction_torch.train import profile_step as PS

    events, window_ms, _, windows, shortfall = PS.whole_window(
        lambda: PS.profile_window(call, 1, True, torch.cuda.synchronize))
    check(not shortfall, f"the profiler missed graph kernels: {shortfall}")
    busy = PS.union_ms([(a, b) for _, a, b in events]) / SPC
    return {"names": Counter(name for name, _, _ in events), "busy_ms": busy, "busy_share": busy / (window_ms / SPC),
            "device_ops": len(events) / SPC, "windows": windows}


def graph_nodes(path: str) -> "Counter":
    """The nodes of a CUDA graph's DOT dump (``cudaGraphDebugDotPrint``,
    verbose) by kind, kernels by mangled name. Unlike a profiler session,
    which can lose device records, this is the graph itself."""
    from collections import Counter

    with open(path) as f:
        text = f.read()
    starts = [m.start() for m in DOT_NODE.finditer(text)]
    nodes = Counter()
    for a, b in zip(starts, starts[1:] + [len(text)]):
        kind = DOT_KIND.search(text, a, b)
        check(kind is not None, f"{path}: a graph node without a kind: {text[a:a + 300]}")
        name = DOT_KERNEL.search(text, a, b) if kind.group(1) == "KERNEL" else None
        nodes[name.group(1) if name else kind.group(1)] += 1
    return nodes


def short_nodes(nodes) -> dict:
    """``nodes`` with each mangled kernel name cut to its first 100
    characters (names alike that far are counted together)."""
    out: dict = {}
    for name, n in nodes.items():
        out[name[:100]] = out.get(name[:100], 0) + n
    return out


def dp_reduce_nodes(reduce, path: str) -> "Counter":
    """The graph nodes of one ``reduce()`` captured alone (not replayed)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        reduce()
    graph.enable_debug_mode()
    graph.debug_dump(path)
    return graph_nodes(path)


def dp_reduce_alone(reduce, ops: int, sessions: int = 10) -> float:
    """The device ms of one ``reduce()`` of ``ops`` graph nodes, from a
    profiler session of DP_REDUCE_CALLS calls behind a 1-element fill: a
    session can lose device records (a first run here lost the first
    call's concatenation), so the fill goes first and is left out, and a
    session without DP_REDUCE_CALLS x ``ops`` records is run again,
    ``sessions`` times at most."""
    from video_prediction_torch.train import profile_step as PS

    marker = torch.zeros(1, device="cuda")
    for _ in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            marker.fill_(1.0)
            for _ in range(DP_REDUCE_CALLS):
                reduce()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CPU and "FillFunctor" not in e.name]
        if len(events) == DP_REDUCE_CALLS * ops:
            break
        print(f"all_reduce_mean_ profile: {len(events)} device records, not {DP_REDUCE_CALLS} x {ops}")
    check(len(events) == DP_REDUCE_CALLS * ops,
          f"no whole profile of {DP_REDUCE_CALLS} all_reduce_mean_ calls in {sessions} sessions")
    return PS.union_ms([(a, b) for _, a, b in events]) / DP_REDUCE_CALLS


def dp_graph_phase(dev, ident: str, per_step: dict) -> dict:
    """Phase 25 (a) and the graphs' half of (d): the flagship at batch 16,
    TF32 convs, cuDNN's deterministic algorithms, ``MultiStep(SPC)`` for
    SPC_CALLS calls without a group and under a 1-rank NCCL group
    (``file://`` rendezvous in ``build/``): every loss term, leaf and ``u``
    equal bit for bit; the launches a call; the all-reduce inside the graph
    (its nodes, from ``MultiStep.dump_graph``, are the graph's without a
    group plus SPC times those of one ``all_reduce_mean_`` of the same
    tensors captured alone and one event-record node, the step's
    ``allreduce`` phase mark, beside the PHASE_MARKS of each step of both
    graphs; that reduce is also timed alone); a profiled
    replay of each, whose extra device records are printed; then ms a step
    of both graphs in turns and each one's busy share."""
    from collections import Counter

    import torch.distributed as dist

    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.parallel.mesh import all_reduce_mean_

    set_tf32_default()
    model = dp_flagship("cpu")
    batches = [{k: v.to(dev) for k, v in b.items()} for b in spc_host_batches(model.hparams, SPC * SPC_CALLS)]
    path = os.path.join(WORK_DIR, "dp_nccl1")
    os.makedirs(path, exist_ok=True)
    rendezvous = os.path.join(path, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    check(maybe_initialize(f"file://{rendezvous}", 1, 0, backend="nccl", device="cuda:0"),
          "a 1-rank NCCL group was not created")
    try:
        torch.backends.cudnn.deterministic = True  # see SPC_FLOOR
        try:
            plain = dp_graph_run(model, dev, batches, None)
            nccl = dp_graph_run(model, dev, batches, dist.group.WORLD)
        finally:
            torch.backends.cudnn.deterministic = False
        check(nccl["keys"] == plain["keys"], f"(a): loss terms {nccl['keys']} vs {plain['keys']}")
        check(torch.equal(nccl["scalars"], plain["scalars"]),
              f"(a): the 1-rank NCCL graph's losses are not the plain graph's bit for bit: "
              f"{(nccl['scalars'] - plain['scalars']).abs().max()}")
        for kind in ("params", "buffers"):
            differ = [n for n, v in plain[kind].items() if not torch.equal(v, nccl[kind][n])]
            check(not differ, f"(a): {kind} differ from the plain graph's: {differ[:5]}")
        for run in (plain, nccl):
            for c, counts in enumerate(run["calls"]):
                want = {name: {"float32": n * SPC} for name, n in per_step.items()}
                check(counts == want, f"(a): launches of call {c} {counts}, want {want}")
        profiles = {name: dp_replay_profile(run["replay"]) for name, run in (("graph", plain), ("nccl1", nccl))}
        ts = nccl["ts"]
        tensors = [p.grad for opt in (ts.opt_g, ts.opt_d) for g in opt.param_groups for p in g["params"]]
        n_grads = sum(t.numel() for t in tensors)
        tensors += [torch.zeros((), device=dev) for _ in nccl["keys"]]
        group = dist.group.WORLD
        alone = dp_reduce_nodes(lambda: all_reduce_mean_(tensors, group), os.path.join(path, "reduce.dot"))
        reduce_ms = dp_reduce_alone(lambda: all_reduce_mean_(tensors, group), sum(alone.values()))
        nodes = {}
        for name, run in (("graph", plain), ("nccl1", nccl)):
            run["step"].dump_graph(os.path.join(path, f"{name}.dot"))
            nodes[name] = graph_nodes(os.path.join(path, f"{name}.dot"))
        check(nodes["graph"]["EVENT_RECORD"] == SPC * PHASE_MARKS,
              f"(a): the plain graph holds {nodes['graph']['EVENT_RECORD']} event-record nodes, not {SPC} steps x "
              f"{PHASE_MARKS} phase marks")
        extra, missing = nodes["nccl1"] - nodes["graph"], nodes["graph"] - nodes["nccl1"]
        want = Counter({name: SPC * n for name, n in alone.items()}) + Counter({"EVENT_RECORD": SPC})
        check(bool(alone) and not missing and extra == want,
              f"(a): the NCCL graph's nodes beyond the plain graph's {short_nodes(extra)} (and short of them "
              f"{short_nodes(missing)}) are not {SPC} x one all_reduce_mean_'s {short_nodes(alone)} and {SPC} "
              f"allreduce phase marks")
        records = profiles["nccl1"]["names"] - profiles["graph"]["names"]
        print(f"data parallel (a): MultiStep({SPC}) under a 1-rank NCCL group equals the graph without one bit for "
              f"bit ({SPC_CALLS} calls: losses, {len(plain['params'])} leaves, {len(plain['buffers'])} u); its "
              f"graph holds {sum(nodes['nccl1'].values())} nodes, the plain graph's {sum(nodes['graph'].values())} "
              f"and {SPC} x one all_reduce_mean_ of {n_grads:,} gradients and {len(nccl['keys'])} scalars "
              f"({short_nodes(alone)}; {reduce_ms:.4f} device ms alone, {n_grads * GRAD_BYTES / 1e6:.1f} MB); "
              f"a profiled replay's device records beyond the plain graph's: {dict(records)} [{ident}]")
        times = {"graph": [], "nccl1": []}
        for name in ("graph", "nccl1", "nccl1", "graph"):
            call = (plain if name == "graph" else nccl)["replay"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scalars = call()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / SPC)
            check(all(bool(torch.isfinite(v)) for v in scalars.values()), "(d): non-finite timed losses")
        print("data parallel (d): ms a step in turns (graph, nccl1, nccl1, graph): " + "; ".join(
            f"{name} {', '.join(str(t) for t in times[name])}, busy {profiles[name]['busy_share']} "
            f"({profiles[name]['busy_ms']} ms, {profiles[name]['device_ops']} device ops a step)" for name in times)
            + f"; the all-reduce {reduce_ms} device ms a step [{ident}]")
    finally:
        dist.destroy_process_group()
    del plain, nccl, ts, tensors
    torch.cuda.empty_cache()
    return {"graph_ms": times["graph"], "nccl1_graph_ms": times["nccl1"],
            "graph_busy_share": profiles["graph"]["busy_share"], "nccl1_busy_share": profiles["nccl1"]["busy_share"],
            "allreduce_device_ms": reduce_ms, "allreduce_mb": n_grads * GRAD_BYTES / 1e6,
            "allreduce_device_ops": sum(alone.values()), "bitwise": True}


def dp_cli_phase() -> None:
    """Phase 25, the CLI: ``torchrun --standalone --nproc_per_node 1 -m
    video_prediction_torch.train --steps_per_call 4 --max_steps 8`` on the
    synthetic data (flagship, batch 16), then ``--resume`` to 12: rank 0's
    option files, checkpoints and event files, the summaries read back."""
    import glob
    import shutil

    from video_prediction_torch.configs.hparams import zoo_dir
    from video_prediction_torch.train.checkpoint import (TRAIN_STATE_FILE, checkpoint_file, has_train_state,
                                                         kept_steps, latest_step)
    from video_prediction_torch.utils.summary import read_events

    run_dir = os.path.join(WORK_DIR, "train_dp")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
            "-m", "video_prediction_torch.train", "--dataset", "synthetic", "--model", "savp",
            "--model_hparams_dict", str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
            "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
            "--steps_per_call", str(SPC), "--progress_freq", str(SPC), "--summary_freq", str(SPC),
            "--image_summary_freq", "8", "--save_freq", "8", "--seed", str(DP_SEED), "--spatial_shards", "1"]
    first, end = DP_CLI_STEPS
    t0 = time.perf_counter()
    outs = []
    for extra in (["--max_steps", str(first)], ["--max_steps", str(end), "--resume"]):
        proc = subprocess.run(argv + extra, cwd=ROOT, capture_output=True, text=True, timeout=DP_TIMEOUT)
        check(proc.returncode == 0, f"torchrun train {extra}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        outs.append(proc.stdout)
    wall = time.perf_counter() - t0
    check("data parallel: 1 ranks (nccl)" in outs[0] and f"done at step {first}" in outs[0],
          f"torchrun train: {outs[0][-2000:]}")
    check("data axis: 1, spatial axis: 1" in outs[0], f"torchrun train --spatial_shards 1: {outs[0][-2000:]}")
    check(f"resumed from step {first}" in outs[1] and f"done at step {end}" in outs[1],
          f"torchrun train --resume: {outs[1][-2000:]}")
    for name in ("options.json", "model_hparams.json", "dataset_hparams.json"):
        check(os.path.isfile(os.path.join(run_dir, name)), f"torchrun train wrote no {name}")
    check(latest_step(run_dir) == end and has_train_state(run_dir), f"torchrun train kept steps {kept_steps(run_dir)}")
    state = torch.load(checkpoint_file(run_dir, TRAIN_STATE_FILE), weights_only=True)
    check(state["step"] == end, f"the checkpoint is at step {state['step']}, want {end}")
    files = sorted(glob.glob(os.path.join(run_dir, "events.out.tfevents.*")))
    check(len(files) == 2, f"want one event file a run, got {files}")
    tags = {}
    for path in files:
        for event in read_events(path):
            for tag, _ in event.values:
                tags.setdefault(tag, []).append(event.step)
    check(tags.get("g_loss") == [4, 8, 12] and tags.get("gen_images") == [8],
          f"torchrun train: summaries at {tags.get('g_loss')}, GIFs at {tags.get('gen_images')}")
    print(f"torchrun --standalone --nproc_per_node 1 train --steps_per_call {SPC} --spatial_shards 1 (phase 26 "
          f"(c): 'spatial axis: 1' logged): --max_steps {first}, then "
          f"--resume to {end}, {wall:.2f} s wall (two launches, set-up, captures and checkpoints included); rank 0 "
          f"wrote the option files, checkpoints and {len(files)} event files ({len(tags)} tags)")


def dp_phase(dev, ident: str, per_step: dict, kernel_results: list) -> dict:
    """Phase 25: data-parallel training over ``torch.distributed`` (see the
    module docstring): (a) and (d)'s graphs (``dp_graph_phase``), the CLI
    under ``torchrun`` (``dp_cli_phase``), (b) two gloo ranks on this card
    and (c) two NCCL ranks where there are two cards. Returns (b)'s
    one-process run, phase 26's reference."""
    t_phase = time.perf_counter()
    graphs = dp_graph_phase(dev, ident, per_step)
    dp_cli_phase()
    torch.cuda.empty_cache()
    ref = dp_run(dev, 1, DP_STEPS)
    ranks, wall = dp_spawn("dp_gloo", "gloo", ["cuda:0", "cuda:0"], 1, DP_STEPS)
    gloo = dp_compare("(b) gloo, two processes on cuda:0", ref, ranks, per_step, 1)
    gloo_ms = ranks[0]["ms"][1:]  # the first step sets up cuDNN and the kernels
    print(f"data parallel (d): the gloo pair, two processes sharing one card (not a scaling figure), ms a step "
          f"{gloo_ms} against one process's {ref['ms'][1:]} on the whole batch; {wall:.2f} s wall with the "
          f"processes' set-up [{ident}]")
    cards = torch.cuda.device_count()
    nccl2 = None
    if cards >= 2:
        ref4 = dp_run(dev, SPC, SPC_CALLS)
        ranks4, _ = dp_spawn("dp_nccl2", "nccl", ["cuda:0", "cuda:1"], SPC, SPC_CALLS)
        nccl2 = dp_compare(f"(c) NCCL, two cards, MultiStep({SPC})", ref4, ranks4, per_step, SPC)
        nccl2["ms"] = ranks4[0]["ms"]
    print(f"data parallel (c): NCCL at world size 2 {'ran' if nccl2 else 'not run'} ({cards} CUDA device"
          f"{'s' if cards != 1 else ''})")
    for entry in (e for e in kernel_results if e["name"] in per_step):
        entry["data_parallel"] = {
            "launches_per_rank_per_step": per_step[entry["name"]], **graphs, "gloo_pair_ms": gloo_ms,
            "gloo_one_process_ms": ref["ms"][1:], "gloo_figures": gloo, "nccl_world2": nccl2}
    print(f"phase 25 (data parallel): {time.perf_counter() - t_phase:.2f} s wall")
    return ref


# ---------------------------------------------------------------------------
# spatial partitioning (phase 26)
# ---------------------------------------------------------------------------
SP_K = 2  # spatial shards: dp1 x sp2 on the one card
SP_KTH_BATCH = 8  # kth/ours_savp_128: without remat two ranks of 16 did not fit the card together


def sp_kth_model(dev, batch: int, remat: str = ""):
    """``kth/ours_savp_128`` (128 px, 4 scales) at ``batch`` with the KTH
    dataset's 10 context frames of 20 (``data/kth.py:37``), from DP_SEED's
    weights, on ``dev``; the synthetic clips' actions condition it.
    ``remat`` as ``dp_flagship``'s."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
    from video_prediction_torch.models import get_model_class

    zoo = zoo_dir() / "kth" / "ours_savp_128" / "model_hparams.json"
    hp = resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo),
                               extra=dict(batch_size=batch, context_frames=10, sequence_length=20,
                                          **REMAT.get(remat, {})))
    model = get_model_class("savp")(hp, image_shape=(128, 128, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(DP_SEED))
    return model.to(dev)


def sp_kernel_entries(dev, per_rank_step: dict) -> dict:
    """Phase 26 (b): each kernel at the shapes a dp1 x sp2 rank of the
    flagship's train step gives it, forward and backward, against its plain
    version, timed as phases 3-4 time them: K1 on the halo-extended shard
    [32, 36, 64, 3] (the doubled batch, 32 rows and 2 + 2 of halo; also
    checked, untimed, on 128 px's [32, 68, 128, 3]), K2 at the six (R, C)
    of H/2 in fp32 and bf16, K3 over 2048 pixels at batches 16 and 32 (7
    candidates). Returns each wrapper's entry (name -> dict), with
    ``launches_per_rank_per_step`` from (a)."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import roofline as RL
    from video_prediction_torch.kernels.bench import device_ms, ln_inputs
    from video_prediction_torch.kernels.composite import device_plan

    g = torch.Generator(device=dev).manual_seed(26)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
    b2, hs = 2 * TRAIN_BATCH, 64 // SP_K + 4
    out = {}

    # K1, forward and backward, on the extended shard
    for b, h, w in ((b2, 128 // SP_K + 4, 128), (b2, hs, 64)):
        image = rand(b, h, w, 3)
        kern = torch.softmax(randn(b, 25, 4), dim=1).reshape(b, 5, 5, 4).contiguous()
        grad = randn(b, 4, h, w, 3)
        shapes = f"[{b},{h},{w},3]x[{b},5,5,4]"
        e0, ok0 = max_err(K.apply_cdna_kernels(image, kern), K.apply_cdna_kernels_reference(image, kern), "float32")
        got = K.apply_cdna_kernels_backward(image, kern, grad)
        want = plain_grads(K.apply_cdna_kernels_reference, (image, kern), (grad,))
        e1, ok1 = max_err(got[0], want[0], "float32")
        e2, ok2 = reduction_err(got[1], want[1])
        print(f"K1 on a shard {shapes}, fp32: forward max_abs_err {e0:.3g}; backward d image {e1:.3g}, d kernels "
              f"{e2:.3g}")
        check(ok0 and ok1 and ok2, f"K1 on the shard {shapes} disagrees with its plain version: {e0}, {e1}, {e2}")
    x, wt = cdna_as_grouped_conv(image, kern)
    go = grad.permute(0, 4, 1, 2, 3).reshape(1, b2 * 12, hs, 64).contiguous()
    with NoTF32():
        fwd_lib = device_ms(lambda: cdna_library_forward(x, wt, b2 * 3))
        bwd_lib = device_ms(lambda: cdna_library_backward(go, x, wt, b2 * 3))
    entry = dict(shapes=shapes, max_abs_err=e0, ms=cuda_ms(lambda: K.apply_cdna_kernels(image, kern)),
                 plain_ms=cuda_ms(lambda: K.apply_cdna_kernels_reference(image, kern)),
                 device_ms=device_ms(lambda: K.apply_cdna_kernels(image, kern), "K1"), library_ms=fwd_lib)
    out["apply_cdna_kernels"] = roofline(entry, RL.cdna_forward(b2, hs, 64, 3))
    entry = dict(shapes=shapes, max_abs_err=max(e1, e2),
                 ms=cuda_ms(lambda: K.apply_cdna_kernels_backward(image, kern, grad)),
                 plain_ms=plain_backward_ms(K.apply_cdna_kernels_reference, (image, kern), (grad,)),
                 device_ms=device_ms(lambda: K.apply_cdna_kernels_backward(image, kern, grad), "K1"),
                 library_ms=bwd_lib)
    out["apply_cdna_kernels_backward"] = roofline(entry, RL.cdna_backward(b2, hs, 64, 3))

    # K2 at H/2: each width's R halved
    widths = sorted({(c, b2 * (px // SP_K) * px) for c, px in RL.LN_GATE_STEP})
    errs, times = {"forward": 0.0, "backward": 0.0}, {}
    for cdim, r in widths:
        z, c, lnp, dcn, dhn = ln_inputs(g, r, cdim, dev)
        for dt in ("float32", "bfloat16"):
            zz, cc, d1, d2 = (t.to(getattr(torch, dt)) for t in (z, c, dcn, dhn))
            fwd = K.fused_ln_gate(zz, cc, lnp)
            ref = K.fused_ln_gate_reference(zz, cc, lnp)
            bwd = K.fused_ln_gate_backward(zz, cc, lnp, d1, d2)
            bref = plain_grads(K.fused_ln_gate_reference, (zz, cc, lnp), (d1, d2))
            fe = [max_err(a, b, dt) for a, b in zip(fwd, ref)]
            be = [max_err(bwd[0], bref[0], dt), max_err(bwd[1], bref[1], dt), reduction_err(bwd[2], bref[2])]
            print(f"K2 on a shard R={r} C={cdim} {dt}: forward max_abs_err {max(e for e, _ in fe):.3g}, backward "
                  f"{max(e for e, _ in be):.3g}")
            check(all(ok for _, ok in fe + be), f"K2 {dt} R={r} C={cdim} on the shard disagrees with its plain "
                  f"version: {fe}, {be}")
            if dt == "float32":
                errs["forward"] = max(errs["forward"], *(e for e, _ in fe))
                errs["backward"] = max(errs["backward"], *(e for e, _ in be))
        times[cdim] = (cuda_ms(lambda: K.fused_ln_gate(z, c, lnp)),
                       cuda_ms(lambda: K.fused_ln_gate_reference(z, c, lnp)),
                       device_ms(lambda: K.fused_ln_gate(z, c, lnp), "K2"),
                       cuda_ms(lambda: K.fused_ln_gate_backward(z, c, lnp, dcn, dhn), iters=20),
                       plain_backward_ms(K.fused_ln_gate_reference, (z, c, lnp), (dcn, dhn)),
                       device_ms(lambda: K.fused_ln_gate_backward(z, c, lnp, dcn, dhn), "K2"))
    step = [(b2 * (px // SP_K) * px, c) for c, px in RL.LN_GATE_STEP]
    shapes = f"R={', '.join(str(r) for _, r in widths)} at C={', '.join(str(c) for c, _ in widths)}, 6 calls a step"
    for name, j, rl in (("fused_ln_gate", 0, RL.ln_gate_forward), ("fused_ln_gate_backward", 3, RL.ln_gate_backward)):
        entry = dict(shapes=shapes, max_abs_err=errs["forward" if j == 0 else "backward"], library_ms=None,
                     **{key: sum(times[c][j + i] for c, _ in RL.LN_GATE_STEP)
                        for i, key in enumerate(("ms", "plain_ms", "device_ms"))})
        out[name] = roofline(entry, rl(step))

    # K3 over the shard's 2048 pixels
    hk = 64 // SP_K
    for b in (TRAIN_BATCH, b2):
        cand, logits, grad = rand(b, 7, hk, 64, 3), randn(b, hk, 64, 7) * 3.0, randn(b, hk, 64, 3)
        check(device_plan(cand, logits).staged == 7, f"K3 at [{b},7,32,64,3] did not take its staged instantiation")
        e0, ok0 = max_err(K.composite(cand, logits)[0], K.composite_reference(cand, logits)[0], "float32")
        got = K.composite_backward(cand, logits, grad)
        want = plain_grads(lambda a, m: K.composite_reference(a, m)[0], (cand, logits), (grad,))
        (e1, ok1), (e2, ok2) = max_err(got[0], want[0], "float32"), max_err(got[1], want[1], "float32")
        print(f"K3 on a shard [{b},7,{hk},64,3], fp32 (staged K=7): forward max_abs_err {e0:.3g}, backward "
              f"{max(e1, e2):.3g}")
        check(ok0 and ok1 and ok2, f"K3 [{b},7,32,64,3] on the shard disagrees with its plain version")
        fwd = dict(shapes=f"[{b},7,{hk},64,3]", max_abs_err=e0, library_ms=None,
                   ms=cuda_ms(lambda: K.composite(cand, logits)),
                   plain_ms=cuda_ms(lambda: K.composite_reference(cand, logits)),
                   device_ms=device_ms(lambda: K.composite(cand, logits), "K3"))
        fwd = roofline(fwd, RL.composite_forward(b, 7, hk, 64))
        out.setdefault("composite", {"batches": {}})["batches"][b] = fwd
    out["composite"].update(out["composite"]["batches"][b2])
    entry = dict(shapes=f"[{b2},7,{hk},64,3]", max_abs_err=max(e1, e2), library_ms=None,
                 ms=cuda_ms(lambda: K.composite_backward(cand, logits, grad)),
                 plain_ms=plain_backward_ms(lambda a, m: K.composite_reference(a, m)[0], (cand, logits), (grad,)),
                 device_ms=device_ms(lambda: K.composite_backward(cand, logits, grad), "K3"))
    out["composite_backward"] = roofline(entry, RL.composite_backward(b2, 7, hk, 64))
    for name, entry in out.items():
        entry["launches_per_rank_per_step"] = per_rank_step[name]
        print(timing_line(f"{name} on a dp1 x sp2 shard ({entry['shapes']})", entry))
    return out


def sp_memory_kth(ident: str) -> dict:
    """Phase 26 (d), 128 px: ``kth/ours_savp_128``, one step, at SP_KTH_BATCH
    in one process alone and as two gloo ranks at dp1 x sp2 sharing the
    card: each one's peak allocated MiB and ms (one process alone at batch
    16: phase 28 (b), with ``remat`` off, ``full`` and ``names``)."""
    (one,), _ = dp_spawn("sp_kth_one", "gloo", ["cuda:0"], 1, 1, config=f"kth128_{SP_KTH_BATCH}")
    check(not one.get("oom"), f"kth/ours_savp_128 does not fit the card at batch {SP_KTH_BATCH}")
    ranks, _ = dp_spawn("sp_kth_gloo", "gloo", ["cuda:0", "cuda:0"], 1, 1, SP_K, f"kth128_{SP_KTH_BATCH}")
    for r, out in enumerate(ranks):
        check(torch.isfinite(out["scalars"]).all().item(), f"kth128 rank {r}: losses {out['scalars']}")
    print(f"spatial memory (d), kth/ours_savp_128 (128 px, 20 frames, remat full), one step: batch {SP_KTH_BATCH}: "
          f"one process {one['peak_mib']:.1f} MiB peak allocated, each dp1 x sp2 rank "
          f"{[round(o['peak_mib'], 1) for o in ranks]} MiB ({ranks[0]['peak_mib'] / one['peak_mib']:.3f} of it); ms "
          f"{one['ms'][0]:.1f} against {[round(o['ms'][0], 1) for o in ranks]} (gloo, two processes on one card) "
          f"[{ident}]")
    return {"batch": SP_KTH_BATCH, "one_process_peak_mib": one["peak_mib"], "rank_peak_mib": [o["peak_mib"] for o in ranks],
            "one_process_ms": one["ms"][0], "rank_ms": [o["ms"][0] for o in ranks]}


def sp_phase(dev, ident: str, per_step: dict, ref: dict, kernel_results: list) -> None:
    """Phase 26: spatial partitioning (``--spatial_shards``; see the module
    docstring): (a) two gloo ranks at dp1 x sp2 on this card against (b)
    of phase 25's one process, (b) the kernels at the shard's shapes, (c)
    (in phase 25's CLI run), (d) the peak memory per rank."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ranks, wall = dp_spawn("sp_gloo", "gloo", ["cuda:0", "cuda:0"], 1, DP_STEPS, SP_K)
    figures = dp_compare("spatial (a) dp1 x sp2, gloo, two processes on cuda:0", ref, ranks, per_step, 1)
    coll = ranks[0]["collectives"]
    print(f"spatial (a): all-reduces a rank a train step {coll['calls']} ({coll['mb']:.1f} MB; halos, norm "
          f"statistics, pools, gathers and the gradients'); ms a step {ranks[0]['ms'][1:]} against one process's "
          f"{ref['ms'][1:]}; {wall:.2f} s wall with the processes' set-up [{ident}]")
    print(f"spatial memory (d), flagship at batch 16, 3 steps: one process {ref['peak_mib']:.1f} MiB peak "
          f"allocated, each dp1 x sp2 rank {[round(o['peak_mib'], 1) for o in ranks]} MiB "
          f"({ranks[0]['peak_mib'] / ref['peak_mib']:.3f} of it) [{ident}]")
    kth = sp_memory_kth(ident)
    per_rank_step = {n: c for n, c in ranks[0]["launches"][-1].items()}
    shard = sp_kernel_entries(dev, per_rank_step)
    for entry in kernel_results:
        if entry["name"] in shard:
            entry["spatial"] = {**shard[entry["name"]], "figures": figures, "collectives_per_rank_step": coll,
                                "flagship_peak_mib": {"one_process": ref["peak_mib"],
                                                      "ranks": [o["peak_mib"] for o in ranks]},
                                "kth128": kth, "rank_ms": ranks[0]["ms"][1:]}
    print(f"spatial (c): NCCL at k = 2 not run (one card: NCCL refuses two ranks on one GPU)")
    print(f"phase 26 (spatial partitioning): {time.perf_counter() - t_phase:.2f} s wall")


# ---------------------------------------------------------------------------
# a JAX run directory carried into the port (phase 27)
# ---------------------------------------------------------------------------
# tools/write_jax_fixtures.py writes both from the JAX package (this machine has no jax)
JAX_RUN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jax_run_small")
JAX_FLAGSHIP_SHAPES = os.path.join(ROOT, "tests", "fixtures", "jax_state_shapes", "bair_action_free_ours_savp.json")
JAX_SAVED_STEP, JAX_STEPS = 3, (3, 4)  # the fixture's checkpoint, then its two recorded steps
JAX_RESUME_STEP = 1000  # (b): the filled state's step and Adam counts, the schedules mid-way
JAX_RESUME_K = 4
JAX_FILL_SEED = 27


def run_dir_model(run_dir: str, batch: dict):
    """The port model a run directory's option files describe, for ``batch``'s shapes."""
    from video_prediction_torch.configs.hparams import apply_overrides, load_hparams_json
    from video_prediction_torch.models import get_model_class, input_dims

    with open(os.path.join(run_dir, "options.json")) as f:
        cls = get_model_class(json.load(f)["model"])
    hp = apply_overrides(cls.default_hparams(), load_hparams_json(os.path.join(run_dir, "model_hparams.json")))
    return cls(hp, **input_dims(hp, batch))


def convert_jax_export(export_dir: str, port_dir: str, label: str) -> dict:
    """``python -m video_prediction_torch.convert``'s ``convert_run``, its
    seconds and the files' MB printed."""
    import shutil

    from video_prediction_torch.convert import convert_run

    shutil.rmtree(port_dir, ignore_errors=True)
    out = convert_run(export_dir, port_dir)
    sizes = ", ".join(f"{os.path.basename(k)} {n / 1e6:.1f} MB" for k, n in out["bytes"].items())
    print(f"convert {label}: step {out['step']} in {out['seconds']:.2f} s; {sizes}")
    return out


def adam_steps(opts) -> set:
    return {float(slots["step"]) for opt in opts if opt is not None for slots in opt.state.values()}


def jax_resume_phase(dev, port_dir: str) -> dict:
    """Phase 27 (a): the converted JAX run resumed on the card, TF32 off and
    cuDNN's deterministic algorithms, at K = 1 and under ``MultiStep(2)``
    (capturable Adams, device step tensors); steps 3 and 4 on the fixture's
    batches with the JAX step's noise, each loss within phase 9's rule of
    the loss JAX recorded. Returns the largest relative difference by K."""
    import numpy as np

    from video_prediction_torch.train.state import create_train_state
    from video_prediction_torch.train.step import make_train_step
    from video_prediction_torch.train.checkpoint import load_train_state

    with np.load(os.path.join(JAX_RUN_FIXTURE, "steps.npz")) as npz:
        rec = {k: npz[k] for k in npz.files}
    batches = [{key: torch.from_numpy(rec[f"step{k}/{key}"]).to(dev) for key in ("images", "actions")}
               for k in JAX_STEPS]
    noises = [{key: int(rec[f"step{k}/noise/{key}"]) if key == "clip_start" else
               torch.from_numpy(rec[f"step{k}/noise/{key}"]).to(dev)
               for key in ("use_gt_u", "eps_q", "z_p", "clip_start")} for k in JAX_STEPS]
    want = [(float(rec[f"step{k}/g_loss"]), float(rec[f"step{k}/d_loss"])) for k in JAX_STEPS]
    worst = {}
    torch.backends.cudnn.deterministic = True
    try:
        with NoTF32():
            for k in (1, len(JAX_STEPS)):
                model = run_dir_model(port_dir, {key: v.cpu() for key, v in batches[0].items()})
                ts = create_train_state(model, 0, dev, steps_per_call=k)
                load_train_state(port_dir, ts)
                check(ts.step == JAX_SAVED_STEP, f"the converted run resumed at step {ts.step}")
                step = make_train_step(model, steps_per_call=k)
                if k == 1:
                    got = []
                    for batch, noise in zip(batches, noises):
                        s = step(ts, batch, noise=noise)
                        got.append((float(s["g_loss"]), float(s["d_loss"])))
                else:
                    step(ts, {key: torch.stack([b[key] for b in batches]) for key in batches[0]}, noises=noises)
                    table = step.scalars_by_step.cpu()
                    got = [(float(row[step.keys.index("g_loss")]), float(row[step.keys.index("d_loss")]))
                           for row in table]
                steps = adam_steps((ts.opt_g, ts.opt_d))
                check(ts.step == JAX_STEPS[-1] + 1 and steps == {float(ts.step)},
                      f"K={k}: step {ts.step}, Adam steps {steps}")
                worst[k] = 0.0
                for (a, b), (ja, jb) in zip(got, want):
                    for name, x, ref in (("g_loss", a, ja), ("d_loss", b, jb)):
                        worst[k] = max(worst[k], abs(x - ref) / abs(ref))
                        check(abs(x - ref) <= TRAIN_LOSS_RTOL * abs(ref) + 1e-7,
                              f"K={k}: {name} {x} on the card, {ref} from JAX")
                print(f"JAX run resumed at step {JAX_SAVED_STEP}, K={k}"
                      f"{' (MultiStep: capturable Adams, device step)' if k > 1 else ''}: steps "
                      f"{JAX_STEPS} (g_loss, d_loss) {got} against JAX's {want}: worst rel {worst[k]:.3g} (tol "
                      f"{TRAIN_LOSS_RTOL}); Adam steps {sorted(steps)}")
                del ts, model, step
    finally:
        torch.backends.cudnn.deterministic = False
    return worst


def fill_jax_state(spec: dict, seed: int, step: int) -> dict:
    """Values for the leaf table of a shape file at about init scale: kernels
    N(0, 1/fan_in), scales 1 + N(0, 0.1), biases and ``u`` N(0, 0.1), Adam's
    mu N(0, 1e-3) and nu |N(0, 1e-6)|, each count and the step ``step``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for path, (shape, dtype) in sorted(spec["leaves"].items()):
        if dtype == "int32":
            out[path] = np.full(shape, step, np.int32)
            continue
        if dtype == "uint32":
            out[path] = rng.integers(0, 2**31, size=shape, dtype=np.uint32)
            continue
        v = rng.standard_normal(shape, dtype=np.float32)
        leaf = path.split("/")[-1]
        if "/nu/" in path:
            v = np.abs(v) * np.float32(1e-6)
        elif "/mu/" in path:
            v *= np.float32(1e-3)
        elif leaf == "scale":
            v = np.float32(1.0) + np.float32(0.1) * v
        elif leaf in ("bias", "u"):
            v *= np.float32(0.1)
        else:
            v *= np.float32(1.0 / math.sqrt(max(1, math.prod(shape[:-1]))))
        out[path] = v
    return out


def jax_flagship_phase(ident: str, per_step: dict, vgg_path: str, lin_path: str) -> dict:
    """Phase 27 (b): the full-width flagship's JAX train state (the shape
    file's leaves filled from a seed at step 1000), exported as the JAX
    side exports it and converted; ``generate`` and ``evaluate`` on the
    converted directory, then the train CLI's ``--resume --steps_per_call
    4`` for one call: "resumed from step 1000", finite losses, Adam's steps
    at 1004, phase 8's launches a step. Returns the readings."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from video_prediction_torch import evaluate, generate
    from video_prediction_torch import kernels as K
    from video_prediction_torch.convert import JAX_STATE_FILE, RUN_FILES
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.train.checkpoint import TRAIN_STATE_FILE, checkpoint_file

    with open(JAX_FLAGSHIP_SHAPES) as f:
        spec = json.load(f)
    export_dir = os.path.join(WORK_DIR, "jax_flagship_export")
    port_dir = os.path.join(WORK_DIR, "jax_flagship")
    shutil.rmtree(export_dir, ignore_errors=True)
    os.makedirs(export_dir)
    t0 = time.perf_counter()
    for name, key in zip(RUN_FILES, ("options", "model_hparams", "dataset_hparams")):
        with open(os.path.join(export_dir, name), "w") as f:
            json.dump(spec[key], f, indent=2)
    np.savez(os.path.join(export_dir, JAX_STATE_FILE), **fill_jax_state(spec, JAX_FILL_SEED, JAX_RESUME_STEP))
    print(f"filled {len(spec['leaves'])} leaves of {os.path.basename(JAX_FLAGSHIP_SHAPES)} at step "
          f"{JAX_RESUME_STEP} in {time.perf_counter() - t0:.2f} s")
    readings = {"convert": convert_jax_export(export_dir, port_dir, "the full-width flagship")}
    shutil.rmtree(export_dir)

    set_tf32_default()
    results = os.path.join(WORK_DIR, "jax_flagship_results")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    gen = generate.main(["--checkpoint", port_dir, "--dataset", "synthetic", "--results_dir", results,
                         "--device", "cuda", "--batch_size", str(BATCH), "--num_samples", str(BATCH)])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = {k: n * gen["rollouts"] for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})
    check(gen["all_finite"] and gen["gifs"] == BATCH and launches == want,
          f"generate on the converted run: {gen}, launches {launches}, want {want}")
    readings["generate_s"] = time.perf_counter() - t0
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ev = evaluate.main(["--checkpoint", port_dir, "--dataset", "synthetic", "--results_dir", results,
                        "--device", "cuda", "--batch_size", str(BATCH), "--num_samples", str(BATCH),
                        "--num_stochastic_samples", "8", "--vgg_weights_path", vgg_path,
                        "--lpips_weights_path", lin_path])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = {k: n * ev["rollouts"] for k, n in LAUNCHES_PER_ROLLOUT.items()}
    want.update({k: 0 for k in BACKWARD})
    check(ev["no_nan"] and ev["rollouts"] == 1 and launches == want,
          f"evaluate on the converted run: {ev}, launches {launches}, want {want}")
    readings["evaluate_s"] = time.perf_counter() - t0
    print(f"generate and evaluate on the converted run: {gen['rollouts']} and {ev['rollouts']} rollouts in "
          f"{readings['generate_s']:.2f} s and {readings['evaluate_s']:.2f} s wall (restore and set-up included); "
          f"evaluate means {ev['metrics']}")

    torch.cuda.empty_cache()
    end = JAX_RESUME_STEP + JAX_RESUME_K
    argv = ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict",
            os.path.join(port_dir, "model_hparams.json"), "--output_dir", port_dir, "--resume", "--device", "cuda",
            "--batch_size", str(TRAIN_BATCH), "--steps_per_call", str(JAX_RESUME_K), "--max_steps", str(end),
            "--progress_freq", str(JAX_RESUME_K), "--no_tensorboard"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = train_main(argv)
    torch.cuda.synchronize()
    readings["train_s"] = time.perf_counter() - t0
    launches = K.launch_counts()
    print(log.getvalue(), end="")
    want = {k: n * JAX_RESUME_K for k, n in per_step.items()}
    check(f"resumed from step {JAX_RESUME_STEP}" in log.getvalue(), "the train CLI did not log the resume")
    check((out["start_step"], out["step"]) == (JAX_RESUME_STEP, end) and out["all_finite"],
          f"train --resume on the converted run: {out}")
    check(launches == want, f"train --resume launches {launches}, want {want} ({JAX_RESUME_K} steps)")
    state = torch.load(checkpoint_file(port_dir, TRAIN_STATE_FILE), weights_only=True)
    steps = {float(slots["step"]) for key in ("opt_g", "opt_d") for slots in state[key]["state"].values()}
    check(state["step"] == end and steps == {float(end)}, f"saved step {state['step']}, Adam steps {steps}")
    readings.update({"losses": out["scalars"], "launches": launches})
    print(f"train --resume --steps_per_call {JAX_RESUME_K} on the converted full-width flagship: steps "
          f"{JAX_RESUME_STEP}-{end} in {readings['train_s']:.2f} s wall (one eager call; set-up and checkpoint "
          f"included), g_loss {out['scalars']['g_loss']:.6g}, d_loss {out['scalars']['d_loss']:.6g}; Adam steps "
          f"{sorted(steps)}; launches {launches} [{ident}]")
    return readings


def jax_run_phase(ident: str, per_step: dict, vgg_path: str, lin_path: str) -> None:
    """Phase 27: a JAX run directory carried into the port, (a) against
    the losses JAX recorded, (b) at full width through the entry points."""
    t_phase = time.perf_counter()
    port_dir = os.path.join(WORK_DIR, "jax_run_small")
    convert = convert_jax_export(JAX_RUN_FIXTURE, port_dir, "tests/fixtures/jax_run_small")
    worst = jax_resume_phase(torch.device("cuda", 0), port_dir)
    flagship = jax_flagship_phase(ident, per_step, vgg_path, lin_path)
    summary = {"small": {"convert_s": convert["seconds"], "worst_loss_rel_by_k": worst},
               "flagship": {"convert_s": flagship["convert"]["seconds"],
                            "mb": {os.path.basename(k): n / 1e6 for k, n in flagship["convert"]["bytes"].items()},
                            **{k: flagship[k] for k in ("generate_s", "evaluate_s", "train_s", "losses")}}}
    print(f"phase 27 readings [{ident}]: {json.dumps(summary)}")
    print(f"phase 27 (JAX run carried into the port): {time.perf_counter() - t_phase:.2f} s wall")


# ---------------------------------------------------------------------------
# remat: the generator cell recomputed in the backward pass (phase 28)
# ---------------------------------------------------------------------------
REMAT = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
         "names": dict(remat=True, remat_policy="names")}
REMAT_WORKER = "--remat-memory"  # chip_smoke.py REMAT_WORKER <job dir>: phase 28 (b) in a process of its own
REMAT_TIMEOUT = 600  # seconds for (b)'s process
REMAT_CONFIGS = ("flagship", "kth128_16")  # dp_run's configs at batch 16
REMAT_ORDER = ("full", "names", "off")  # off last: the one that may not fit the card
# the settings each config runs graphed as well as eagerly: kth/ours_savp_128's graph
# without recompute needs nearly the whole card (out of memory once after phases
# 1-27, PR 16), and its names graph times as its full one (PR 16)
REMAT_GRAPHED = {"flagship": REMAT_ORDER, "kth128_16": ("full",)}


def remat_step_phase(dev) -> dict:
    """Phase 28 (a): one flagship train step at batch 16 with ``remat`` off,
    ``full`` and ``names`` (``dp_run``: the same weights, batch and noise,
    TF32 off, cuDNN's deterministic algorithms): each loss term of ``full``
    and ``names`` within phase 9's rule of the step without recompute, each
    gradient leaf within phase 9's leaf rule, and each setting's launches
    exactly ``train_launches`` (22 / 132 / 22 forward and 11 / 66 / 11
    backward where the cell is recomputed). Returns the readings."""
    from video_prediction_torch.models.savp import recomputes

    runs, out = {}, {}
    for policy in REMAT:
        torch.cuda.empty_cache()
        run = runs[policy] = dp_run(dev, 1, 1, remat=policy)
        hp = slice_hparams().replace(**REMAT[policy])
        want = train_launches(hp)
        check(recomputes(hp) == (policy != "off"), f"remat {policy}: recomputes(hp) is {recomputes(hp)}")
        check(run["launches"][0] == want, f"remat {policy}: launches a step {run['launches'][0]}, want {want}")
        check(bool(torch.isfinite(run["scalars"]).all()), f"remat {policy}: losses {run['scalars']}")
        out[policy] = {"launches": run["launches"][0], "ms": run["ms"][0], "peak_mib": run["peak_mib"]}
    off = runs["off"]
    gmax = max(float(g.abs().max()) for g in off["grads1"].values())
    for policy in ("full", "names"):
        run = runs[policy]
        check(run["keys"] == off["keys"], f"remat {policy}: loss terms {run['keys']} vs {off['keys']}")
        a, b = off["scalars"], run["scalars"]
        over = (b - a).abs() > TRAIN_LOSS_RTOL * a.abs() + 1e-7
        check(not bool(over.any()), f"remat {policy}: loss terms off at {over.nonzero().tolist()}: {b} vs {a}")
        rel = []
        for name, g in off["grads1"].items():
            err = float((run["grads1"][name] - g).abs().max())
            scale = float(g.abs().max())
            check(err <= TRAIN_GRAD_TOL * scale + TRAIN_GRAD_FLOOR * gmax,
                  f"remat {policy}: gradient of {name} off by {err} (max |g| {scale})")
            rel.append(err / max(scale, 1e-30))
        median = sorted(rel)[len(rel) // 2]
        check(median <= TRAIN_GRAD_MEDIAN_TOL, f"remat {policy}: median leaf {median}")
        out[policy].update(loss_max_abs_diff=float((b - a).abs().max()), grad_median_rel=median,
                           grad_max_rel=max(rel))
        print(f"remat (a) {policy} against off, flagship at batch 16, one step, TF32 off, deterministic cuDNN: "
              f"loss terms max |diff| {out[policy]['loss_max_abs_diff']:.3g}, gradient leaves max rel "
              f"{max(rel):.3g} (median {median:.3g}); launches {run['launches'][0]}")
    print(f"remat (a): ms a step (TF32 off; one step, the first of its process's model) and peak allocated MiB: "
          + "; ".join(f"{p} {o['ms']:.1f} ms {o['peak_mib']:.1f} MiB" for p, o in out.items()))
    return out


def _out_of_memory(e: BaseException) -> bool:
    """Whether ``e``, or an error it was raised while handling, is the card running out of memory."""
    while e is not None:
        if isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e):
            return True
        e = e.__context__
    return False


def remat_memory_run(dev, config: str, policy: str, graphed: bool = True) -> dict:
    """Phase 28 (b), one model and ``remat`` setting: ms a step and the peak
    memory allocated above what was allocated before the model was built,
    eagerly (3 steps, the last two timed) and graphed (``MultiStep(SPC)``,
    SPC_CALLS calls: the first eager, the second captured, the third
    replayed and timed; the cache is emptied before the capture, so that the
    graph's pool can take what the eager call freed; unless ``graphed`` is
    False), TF32 convs as the CLIs run. A mode that runs out of memory reads
    ``{"oom": True}``, and the graph is not tried after an eager one does."""
    import gc

    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    set_tf32_default()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    batch = int(config.split("_")[1]) if config != "flagship" else TRAIN_BATCH
    model = dp_flagship(dev, policy) if config == "flagship" else sp_kth_model(dev, batch, policy)
    ts = TrainState(model, *make_optimizers(model, SPC), 0, torch.Generator(device=dev).manual_seed(DP_SEED))
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in spc_host_batches(model.hparams, SPC, model.generator.image_shape[0])]
    out = {}
    for mode, k in (("eager", 1), ("graph", SPC))[:2 if graphed else 1]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(model, k)
        ms = []
        try:
            for c in range(SPC_CALLS):
                if k > 1 and c == 1:
                    torch.cuda.empty_cache()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                step(ts, batches[c] if k == 1 else spc_stack(batches))
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3 / k)
        except RuntimeError as e:
            if not _out_of_memory(e):
                raise
            out[mode] = {"oom": True}
            break
        peak_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        out[mode] = {"ms": ms[1:] if k == 1 else ms[2:], "peak_mib": peak_mib}
        if k > 1:
            out[mode]["capture_s"] = step.capture_s
        del step
    del ts, model, batches
    return out


def remat_worker(argv) -> int:
    """Phase 28 (b) in a process of its own (``REMAT_WORKER <job dir>``):
    ``remat_memory_run`` of every config of REMAT_CONFIGS for every setting in
    REMAT_ORDER (graphed as REMAT_GRAPHED says), written to ``<job
    dir>/readings.json``."""
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    readings = {config: {policy: remat_memory_run(dev, config, policy, policy in REMAT_GRAPHED[config])
                         for policy in REMAT_ORDER} for config in REMAT_CONFIGS}
    with open(os.path.join(argv[0], "readings.json"), "w") as f:
        json.dump(readings, f)
    return 0


def remat_memory_phase(ident: str) -> dict:
    """Phase 28 (b): ``remat_worker`` in a process of its own (the card
    otherwise empty of this process's cache), within REMAT_TIMEOUT; prints
    each config's and setting's ms a step and peak allocated MiB. Every
    recomputing run must fit the card."""
    import shutil

    path = os.path.join(WORK_DIR, "remat_memory")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"remat (b): the card has {free / 2**20:.1f} of {total / 2**20:.1f} MiB free for the worker (this process "
          f"holds {torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved, and its context)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), REMAT_WORKER, path], cwd=ROOT,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=REMAT_TIMEOUT)
    check(proc.returncode == 0, f"remat (b): the worker exited {proc.returncode}:\n{proc.stdout[-3000:]}")
    with open(os.path.join(path, "readings.json")) as f:
        readings = json.load(f)
    for config, by_policy in readings.items():
        for policy, modes in by_policy.items():
            if policy != "off":
                check(not any(m.get("oom") for m in modes.values()), f"remat (b) {config} {policy}: {modes}")
            print(f"remat (b) {config} at batch 16, remat {policy} (TF32 convs): " + "; ".join(
                f"{mode} out of memory" if m.get("oom") else
                f"{mode} {', '.join(str(t) for t in m['ms'])} ms a step, {m['peak_mib']} MiB peak allocated"
                + (f", capture {m['capture_s']} s" if "capture_s" in m else "")
                for mode, m in modes.items()) + f" [{ident}]")
    print(f"remat (b): {time.perf_counter() - t0:.2f} s wall with the process's set-up")
    return readings


def remat_graph_phase(dev, ident: str) -> dict:
    """Phase 28 (c): phase 24 (a) and (b) for the flagship with ``remat_policy
    names`` (phase 24 runs the flagship with its zoo file's ``full``):
    SPC_CALLS calls of ``MultiStep(SPC)`` against SPC_CALLS x SPC eager steps
    from the same weights, batches and noise seed, with cuDNN's
    deterministic algorithms, within SPC_SPREAD_RATIO times the spread of a
    second eager run plus SPC_FLOOR; each call's launches SPC times
    ``train_launches``."""
    from video_prediction_torch.models import get_model_class

    hp = slice_hparams().replace(batch_size=TRAIN_BATCH, **REMAT["names"])
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(SPC_SEED))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    batches = [{k: v.to(dev) for k, v in b.items()} for b in spc_host_batches(hp, SPC * SPC_CALLS)]
    set_tf32_default()
    torch.backends.cudnn.deterministic = True
    try:
        eager = spc_run(model, dev, batches, 1)
        again = spc_run(model, dev, batches, 1)
        graph = spc_run(model, dev, batches, SPC)
    finally:
        torch.backends.cudnn.deterministic = False
    per_step = train_launches(hp)
    for run, k in ((eager, 1), (graph, SPC)):
        for c, counts in enumerate(run["calls"]):
            want = {name: {dtype_of(hp, name): n * k} for name, n in per_step.items()}
            check(counts == want, f"remat (c): launches of call {c} ({k} steps a call) {counts}, want {want}")
    spread, apart = spc_diff(eager, again, init), spc_diff(eager, graph, init)
    worst = spc_check("remat (c) names", apart, spread)
    multi = graph["multi"]
    print(f"remat (c) names: MultiStep({SPC}) against eager steps, worst (name, graph, eager spread, allowance): "
          f"{worst}; capture {multi.capture_s} s; launches a replay {multi.graph_launches}; peak "
          f"{eager['peak_gib']:.2f} GiB eager, {graph['peak_gib']:.2f} GiB graphed [{ident}]")
    out = {"worst": {kind: list(w) for kind, w in worst.items()}, "capture_s": multi.capture_s,
           "graph_launches": multi.graph_launches}
    del eager, again, graph, multi, batches
    torch.cuda.empty_cache()
    return out


def remat_phase(dev, ident: str, kernel_results: list) -> None:
    """Phase 28: ``remat`` on the card, (a) ``remat_step_phase``, (b)
    ``remat_memory_phase``, (c) ``remat_graph_phase``."""
    t_phase = time.perf_counter()
    steps = remat_step_phase(dev)
    memory = remat_memory_phase(ident)
    graph = remat_graph_phase(dev, ident)
    for entry in (e for e in kernel_results if e["name"] in steps["off"]["launches"]):
        entry["remat"] = {"launches_per_train_step": {p: r["launches"][entry["name"]] for p, r in steps.items()}}
    summary = {"steps": {p: {k: v for k, v in r.items() if k != "launches"} for p, r in steps.items()},
               "memory": memory, "names_graph": graph}
    print(f"phase 28 readings [{ident}]: {json.dumps(summary)}")
    print(f"phase 28 (remat): {time.perf_counter() - t_phase:.2f} s wall")


# ---------------------------------------------------------------------------
# checkpoints kept per step, the last three (phase 29)
# ---------------------------------------------------------------------------
CKPT_STEPS = 4  # (a): --save_freq 1, four saves, three kept
CKPT_KILL_FREQ = 2  # (b): the killed run's --save_freq
CKPT_KILL_TIMEOUT = 240  # seconds for the killed run to keep its first step
CKPT_RESUME_STEPS = 2  # (b): the resumed run's steps past the newest kept one
CKPT_SEED = 29


def ckpt_argv(run_dir: str, steps: int, save_freq: int) -> list:
    from video_prediction_torch.configs.hparams import zoo_dir

    return ["--dataset", "synthetic", "--model", "savp",
            "--model_hparams_dict", str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
            "--output_dir", run_dir, "--batch_size", str(TRAIN_BATCH), "--device", "cuda", "--max_steps", str(steps),
            "--save_freq", str(save_freq), "--progress_freq", "1", "--no_tensorboard", "--seed", str(CKPT_SEED)]


def ckpt_retention(run_dir: str) -> dict:
    """Phase 29 (a): the train CLI at full width, batch 16, ``--save_freq 1``
    for CKPT_STEPS steps: every periodic save writes its step, the final
    save (a step kept already) writes nothing, the newest three steps are
    kept, each whole, and nothing else. Returns the seconds and MB of each
    save."""
    import shutil

    from video_prediction_torch.train import checkpoint
    from video_prediction_torch.train.__main__ import main as train_main

    shutil.rmtree(run_dir, ignore_errors=True)
    saves, real_save = [], checkpoint.save_train_state

    def timed(path, ts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wrote = real_save(path, ts)
        saves.append((ts.step, wrote, time.perf_counter() - t0))
        return wrote

    checkpoint.save_train_state = timed
    try:
        out = train_main(ckpt_argv(run_dir, CKPT_STEPS, 1))
    finally:
        checkpoint.save_train_state = real_save
    check(out["all_finite"] and out["step"] == CKPT_STEPS, f"checkpoints (a): train {out}")
    want = [(s, True) for s in range(1, CKPT_STEPS + 1)] + [(CKPT_STEPS, False)]
    check([(s, w) for s, w, _ in saves] == want, f"checkpoints (a): saves (step, wrote) {saves}, want {want}")
    kept = list(range(CKPT_STEPS - checkpoint.MAX_TO_KEEP + 1, CKPT_STEPS + 1))
    root = os.path.join(run_dir, checkpoint.CHECKPOINT_DIR)
    check(checkpoint.kept_steps(run_dir) == kept and sorted(os.listdir(root)) == sorted(str(s) for s in kept),
          f"checkpoints (a): {sorted(os.listdir(root))} kept, want {kept}")
    mb = {}
    for s in kept:
        names = sorted(os.listdir(os.path.join(root, str(s))))
        check(names == [checkpoint.PARAMS_FILE, checkpoint.TRAIN_STATE_FILE], f"checkpoints (a): step {s} holds {names}")
        mb[s] = sum(os.path.getsize(os.path.join(root, str(s), n)) for n in names) / 1e6
    seconds = [t for _, w, t in saves if w]
    print(f"checkpoints (a): train --save_freq 1 at full width, batch 16, {CKPT_STEPS} steps: {len(seconds)} saves "
          f"of {mb[kept[-1]]:.1f} MB (train state and params) in {', '.join(f'{t:.3f}' for t in seconds)} s (the "
          f"copy to the host included), the final save of step {CKPT_STEPS} skipped in {saves[-1][2]:.4f} s; steps "
          f"{kept} kept, {sum(mb.values()):.1f} MB")
    return {"save_s": seconds, "skip_s": saves[-1][2], "step_mb": mb[kept[-1]], "kept": kept}


def ckpt_kill_and_resume(run_dir: str) -> dict:
    """Phase 29 (b): ``python -m video_prediction_torch.train`` with
    ``--save_freq`` CKPT_KILL_FREQ killed with SIGKILL as soon as its first
    step is kept (inside the next step), then the newest kept step restored
    and ``--resume``d CKPT_RESUME_STEPS steps in this process, TF32 off and
    cuDNN's deterministic algorithms: the resumed run's train state equals,
    bit for bit, the newest kept step's state taken the same steps by hand
    on the fresh stream's first batches (``tests/test_torch_train_cli.py``'s
    ``test_resume_equals_an_unbroken_run`` at full width)."""
    import shutil
    import signal

    from video_prediction_torch.configs.hparams import DatasetHparams, ModelHparams, apply_overrides
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset
    from video_prediction_torch.generate import batch_to_device
    from video_prediction_torch.models import get_model_class
    from video_prediction_torch.train import checkpoint
    from video_prediction_torch.train.__main__ import main as train_main
    from video_prediction_torch.train.state import create_train_state, optimizer_param_names
    from video_prediction_torch.train.step import make_train_step

    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    torch.cuda.empty_cache()  # the card's memory for the process to be killed
    log_path = os.path.join(run_dir, "killed.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "video_prediction_torch.train",
                                 *ckpt_argv(run_dir, 1000, CKPT_KILL_FREQ)], cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            while not checkpoint.kept_steps(run_dir) and proc.poll() is None \
                    and time.perf_counter() - t0 < CKPT_KILL_TIMEOUT:
                time.sleep(0.05)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    newest = checkpoint.latest_step(run_dir)
    check(proc.returncode == -signal.SIGKILL and newest is not None and newest % CKPT_KILL_FREQ == 0,
          f"checkpoints (b): the run exited {proc.returncode} with steps {checkpoint.kept_steps(run_dir)}:\n{tail}")
    killed_at = max((int(m) for m in re.findall(r"^step (\d+):", tail, re.M)), default=0)
    kill_s = time.perf_counter() - t0

    set_tf32_default()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        t1 = time.perf_counter()
        end = newest + CKPT_RESUME_STEPS
        out = train_main(ckpt_argv(run_dir, end, CKPT_KILL_FREQ) + ["--resume"])
        resume_s = time.perf_counter() - t1
        check((out["start_step"], out["step"]) == (newest, end) and out["all_finite"],
              f"checkpoints (b): --resume {out}")
        # by hand: the newest kept state, then the same steps on the fresh stream's first batches
        dev = torch.device("cuda", 0)
        with open(os.path.join(run_dir, "model_hparams.json")) as f:
            hp = apply_overrides(ModelHparams(), json.load(f))
        model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
        ts = create_train_state(model, CKPT_SEED, dev)
        checkpoint.load_train_state(run_dir, ts, step=newest)
        with open(os.path.join(run_dir, "dataset_hparams.json")) as f:
            dhp = apply_overrides(DatasetHparams(), json.load(f))
        it = SyntheticVideoDataset("", mode="train", hparams=dhp, seed=CKPT_SEED).make_iterator(TRAIN_BATCH)
        step = make_train_step(model)
        for _ in range(CKPT_RESUME_STEPS):
            scalars = step(ts, batch_to_device(next(it), dev))
    finally:
        torch.backends.cudnn.deterministic = False
        set_tf32_default()
    check(out["scalars"] == {k: float(v) for k, v in scalars.items()},
          f"checkpoints (b): the resumed run's last losses {out['scalars']}, by hand {scalars}")
    saved = torch.load(checkpoint.checkpoint_file(run_dir, checkpoint.TRAIN_STATE_FILE), weights_only=True)
    check(saved["step"] == ts.step == end, f"checkpoints (b): saved step {saved['step']}, by hand {ts.step}")
    mine = ts.model.state_dict()
    off = [k for k, v in saved["model"].items() if not torch.equal(v, mine[k].cpu())]
    check(not off, f"checkpoints (b): the resumed run's parameters and buffers differ from by hand at {off[:8]}")
    for key, opt in (("opt_g", ts.opt_g), ("opt_d", ts.opt_d)):
        names = optimizer_param_names(ts.model, opt)
        for name, p in zip(names, [q for g in opt.param_groups for q in g["params"]]):
            for slot, v in opt.state[p].items():
                check(torch.equal(saved[key]["state"][name][slot].cpu(), v.cpu()),
                      f"checkpoints (b): {key} {name} {slot} differs from by hand")
    check(torch.equal(saved["rng"], ts.rng.get_state()), "checkpoints (b): the noise generator differs from by hand")
    print(f"checkpoints (b): train --save_freq {CKPT_KILL_FREQ} killed with SIGKILL at step {killed_at} (its log's "
          f"last progress line) once step {newest} was kept, {kill_s:.2f} s after its launch; step {newest} restored "
          f"and --resume'd to {end} in {resume_s:.2f} s (TF32 off, deterministic cuDNN): the train state (step, "
          f"{len(saved['model'])} parameters and buffers, both Adams, the noise generator) and the losses equal "
          f"by hand bit for bit; kept steps {checkpoint.kept_steps(run_dir)}")
    return {"killed_at": killed_at, "resumed_from": newest, "end": end, "kill_s": kill_s, "resume_s": resume_s}


def ckpt_readers(run_dir: str, older: int) -> dict:
    """Phase 29 (c): ``generate`` and ``evaluate`` on (a)'s run directory, at
    the newest kept step and at ``older``: each prints and returns the step
    it restored, and its outputs are finite."""
    import contextlib
    import io

    from video_prediction_torch import evaluate, generate
    from video_prediction_torch.train.checkpoint import latest_step

    out = {}
    for step in (None, older):
        want = latest_step(run_dir) if step is None else step
        extra = [] if step is None else ["--checkpoint_step", str(step)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gen = generate.main(["--checkpoint", run_dir, "--results_dir", os.path.join(run_dir, f"gen{want}"),
                                 "--batch_size", str(BATCH), "--num_samples", str(BATCH), *extra])
            ev = evaluate.main(["--checkpoint", run_dir, "--results_dir", os.path.join(run_dir, f"eval{want}"),
                                "--batch_size", str(BATCH), "--num_samples", str(BATCH), "--num_stochastic_samples",
                                "2", "--only_metrics", *extra])
        check(gen["step"] == ev["step"] == want and buf.getvalue().count(f"restored step {want} from {run_dir}") == 2,
              f"checkpoints (c): step {want}: generate {gen['step']}, evaluate {ev['step']}")
        check(gen["all_finite"] and ev["no_nan"], f"checkpoints (c): step {want}: generate {gen}, evaluate {ev}")
        out[want] = {"psnr_max": ev["metrics"]["psnr_max"], "ssim_max": ev["metrics"]["ssim_max"]}
    print(f"checkpoints (c): generate and evaluate restored steps {sorted(out)} of {run_dir}: evaluate's means "
          f"{out}")
    return out


def checkpoint_phase(dev, ident: str) -> dict:
    """Phase 29: (a) ``ckpt_retention``, (b) ``ckpt_kill_and_resume``, (c)
    ``ckpt_readers``, and (d) phase 20's ``dna_l2`` train step GPU against
    CPU again, its median leaf printed beside ``Z_L1_GRAD_MEDIAN_TOL``."""
    t_phase = time.perf_counter()
    run_dir = os.path.join(WORK_DIR, "checkpoints")
    readings = {"retention": ckpt_retention(run_dir)}
    readings["kill"] = ckpt_kill_and_resume(os.path.join(WORK_DIR, "checkpoints_killed"))
    readings["readers"] = ckpt_readers(run_dir, readings["retention"]["kept"][0])
    median = train_cpu_vs_gpu_phase(dev, "dna", ac_hparams("dna", "dna_l2"))
    set_tf32_default()
    readings["dna_l2_grad_median"] = median
    print(f"dna_l2 train step GPU vs CPU (TF32 off, the norms' two-pass variance): median leaf "
          f"{median:.3g}, phase 9's tolerance {TRAIN_GRAD_MEDIAN_TOL}, Z_L1_GRAD_MEDIAN_TOL {Z_L1_GRAD_MEDIAN_TOL} "
          f"[{ident}]")
    print(f"phase 29 readings [{ident}]: {json.dumps(readings)}")
    print(f"phase 29 (checkpoints): {time.perf_counter() - t_phase:.2f} s wall")
    return readings


def dtype_of(hp, name: str) -> str:
    """The dtype ``name`` launches on in the model of ``hp``: K2 in the gate dtype, K1 and K3 fp32."""
    return hp.gate_dtype if name.startswith("fused_ln_gate") else "float32"


def spc_host_batches(hp, n: int, size: int = 64) -> list:
    """``n`` batches of the ``synthetic`` train stream (uint8 images, actions) of ``size`` px as CPU tensors."""
    from video_prediction_torch.configs.hparams import DatasetHparams
    from video_prediction_torch.data.synthetic import SyntheticVideoDataset

    dhp = DatasetHparams(context_frames=hp.context_frames, sequence_length=hp.sequence_length)
    it = SyntheticVideoDataset(mode="train", hparams=dhp, seed=SPC_SEED, image_size=size).make_iterator(hp.batch_size)
    return [{k: torch.from_numpy(v) for k, v in next(it).items()} for _ in range(n)]


def set_tf32_default() -> None:
    """cuDNN's default (TF32 convs) and PyTorch's (no TF32 matmuls), which the CLIs run under."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import video_prediction_torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from a checkout of the repo",
              file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(video_prediction_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        print(f"chip_smoke: FAIL: imported the port from {pkg_dir}, not from {ROOT}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    try:
        # 1. device
        dev = torch.device("cuda", 0)
        ident = gpu_identity()
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {ident}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        # 2. build
        from video_prediction_torch.kernels import _lib

        t0 = time.perf_counter()
        _lib.load_library()
        print(f"build: {time.perf_counter() - t0:.2f} s -> {_lib.library_path().relative_to(ROOT)}")
        ptxas_phase(_lib.ptxas_report())

        # 3. forward kernels against their plain versions, at the generation
        # and at the train step's shapes
        generation = kernel_phase(dev, BATCH)
        kernel_results = kernel_phase(dev, 2 * TRAIN_BATCH, composite_ks=(7, 3))
        evaluation = kernel_phase(dev, EVAL_BATCH, composite_ks=(7, 6))
        timed = ("shapes", "max_abs_err", "ms", "plain_ms", "device_ms", "bytes", "bound_ms", "share_of_bound",
                 "library_ms")
        for entry, gen, ev in zip(kernel_results, generation, evaluation):
            entry["generation"] = {k: gen[k] for k in timed}
            entry["evaluate"] = {k: ev[k] for k in timed}
        torch.cuda.synchronize()

        # 4. backward kernels against autograd of their plain versions
        kernel_results += backward_phase(dev)
        # and K2 on bf16 z and c at the bf16 model's shapes (its launches: phase 17)
        k2_bf16 = dict(zip(("fused_ln_gate", "fused_ln_gate_backward"), ln_gate_bf16_entries(dev)))
        torch.cuda.synchronize()

        # 5. the generation entry point at full width
        model, _ = generate_phase()

        # 6. GPU rollout (kernels) against CPU rollout (plain versions)
        gpu_model = copy.deepcopy(model).to(dev).eval()
        cpu_vs_gpu_phase(model, gpu_model, dev)

        # 7. rollout time
        timing_phase(gpu_model, dev, ident)
        del gpu_model

        # 8. the training entry point at full width, with a resume
        launches = train_phase()
        per_train_step = train_launches(slice_hparams())  # phase 8 held its launches to 4 x these
        for entry in kernel_results:
            entry["launches"] = launches[entry["name"]]
            entry["launches_per_train_step"] = launches[entry["name"]] // TRAIN_STEPS
            entry["launches_per_rollout"] = LAUNCHES_PER_ROLLOUT.get(entry["name"], 0)  # no-grad: no backward

        # 9. GPU train step (kernels) against CPU train step (plain versions)
        train_cpu_vs_gpu_phase(dev)

        # 10. train step time and peak memory
        train_timing_phase(dev, ident)

        # 11. the evaluation entry point at full width, best of 8, VGG and LPIPS; the baselines
        vgg_path, lin_path = write_perceptual_weights()
        launches = evaluate_phase(vgg_path, lin_path)
        for entry in kernel_results:
            if entry["name"] in launches and "evaluate" in entry:
                entry["evaluate"]["launches"] = launches[entry["name"]]

        # 12. SV2P at full width: evaluate, and its GPU rollout against the CPU
        sv2p_phase(dev)

        # 13. the metrics on the card against the CPU
        metrics_phase(dev, vgg_path, lin_path)

        # 14. evaluate batch time: rollout and metrics
        gpu_model = copy.deepcopy(model).to(dev).eval()
        eval_timing_phase(gpu_model, dev, ident, vgg_path, lin_path)
        del gpu_model

        # 15. the bf16 model: generate and evaluate at their defaults
        bf16_model = bf16_generate_evaluate_phase()

        # 16. its GPU rollout against the CPU's, under the bf16 rule
        bf16_cpu_vs_gpu_phase(bf16_model, dev)

        # 17. its training entry point at batch 64, with a resume; one step GPU vs CPU
        launches = bf16_train_phase(dev)
        for entry, sub in k2_bf16.items():
            for part in sub.values():
                part["launches"] = launches[entry]
                part["launches_per_train_step"] = launches[entry] // BF16_TRAIN_STEPS
            next(e for e in kernel_results if e["name"] == entry)["bfloat16"] = sub

        # 18. bf16 times: rollout, evaluate batch, train step and its memory
        bf16_timing_phase(bf16_model, dev, ident)
        del bf16_model
        torch.cuda.empty_cache()

        # 19. the TFRecord datasets: records written by the port, train (with
        # the feeder and --val_input_dir), evaluate and generate on them
        dirs = records_phase(per_train_step, dev, ident)

        # 20. the action-conditioned zoo files (dna_l2, sna_l2, ours_gan) on
        # the records through train, evaluate and generate; the generator
        # options GPU against CPU; the DNA op; K3 at 3 candidates
        kernel_results.append(ac_phase(dirs, dev, ident))

        # 21. bair/ours_savp with every objective (learned prior, image and
        # acvideo discriminators, z_l1, vgg_cdist) through train, evaluate
        # and generate on the records; each objective GPU against CPU; times
        objectives_phase(dirs, dev, ident, vgg_path, kernel_results)

        # 22. the port's bench at bench.py's rows and generation row; the
        # batch-256 forward kernels; the merged-gate bf16 step GPU vs CPU
        bench_phase(dev, ident, kernel_results)

        # 23. the dna_l2 train step's profile
        profile_dna_phase(ident)

        # 24. --steps_per_call: K train steps as one CUDA graph, against
        # eager steps; its launches, times and memory; the CLI with summaries
        spc_phase(dev, ident, per_train_step, kernel_results)

        # 25. data parallel over torch.distributed: a 1-rank NCCL graph against
        # the graph without a group; the CLI under torchrun; two gloo ranks on
        # this card (and two NCCL ranks where there are two cards) against one process
        dp_ref = dp_phase(dev, ident, per_train_step, kernel_results)

        # 26. spatial partitioning: two gloo ranks at dp1 x sp2 on this card
        # against one process; the kernels at the shard's shapes; the peak
        # memory per rank, flagship and kth/ours_savp_128
        sp_phase(dev, ident, per_train_step, dp_ref, kernel_results)

        # 27. a JAX run directory carried into the port: the small run against
        # JAX's recorded losses (K = 1 and MultiStep), the full-width flagship
        # through generate, evaluate and train --resume --steps_per_call 4
        jax_run_phase(ident, per_train_step, vgg_path, lin_path)

        # 28. remat: the generator cell recomputed in the backward pass: one
        # flagship step off, full and names against each other and their
        # launches; ms a step and peak memory, eager and graphed, flagship and
        # kth/ours_savp_128 at 16; MultiStep(4) with names against eager steps
        remat_phase(dev, ident, kernel_results)

        # 29. checkpoints kept per step: the train CLI at full width saving
        # each step (three kept), killed with SIGKILL between saves and resumed
        # bit for bit; generate and evaluate from the newest and an older step;
        # the dna_l2 step GPU against CPU with flax's norm variance
        checkpoint_phase(dev, ident)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    from video_prediction_torch.kernels.bench import REPEATS

    print(f"chip_smoke: phases 1-29 in {time.perf_counter() - t_start:.1f} s")
    print(f"device_ms: profiler sessions run again for lost device records (event counts; queued_ms where "
          f"none was whole): {json.dumps(REPEATS)}")
    print(ident)
    print(json.dumps({"kernels": kernel_results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dp_worker(sys.argv[2:]) if sys.argv[1:2] == [DP_WORKER] else
             remat_worker(sys.argv[2:]) if sys.argv[1:2] == [REMAT_WORKER] else main())
