"""video_prediction_torch: the PyTorch/CUDA port of ``video_prediction_tpu``.

A second package beside the JAX one, with the same layout (``configs/``,
``data/``, ``ops/``, ``models/``, ``train/``, ``utils/``) plus ``kernels/``,
which holds the hand-written Hopper kernels that replace the JAX package's
Pallas kernels. It imports ``torch`` and never ``jax``: the JAX package is the
reference the port is tested against, not a dependency.

Ported: every module of the JAX package that runs off the TPU. Generation
(``python -m video_prediction_torch.generate``), training (``python -m
video_prediction_torch.train``: the SAVP VAE-GAN step and every objective,
``--steps_per_call`` as one CUDA graph, data parallel under ``torchrun``,
``--spatial_shards``, the generator cell recomputed in the backward pass
per ``remat``) and evaluation (``python -m video_prediction_torch.evaluate``:
the metrics, the baselines and SV2P) for all six models and every option of
the JAX ``ModelHparams``; bf16 compute and gates; the TFRecord datasets on
the JAX package's native backend, without TensorFlow (``data/``,
``native/``); the bench tools; and a JAX run directory carried into the
port (``convert.py``). See ``ROADMAP.md`` for what is still to come.
"""

__version__ = "0.1.0"
