"""video_prediction_torch: the PyTorch/CUDA port of ``video_prediction_tpu``.

A second package beside the JAX one, with the same layout (``configs/``,
``data/``, ``ops/``, ``models/``, ``train/``, ``utils/``) plus ``kernels/``,
which holds the hand-written Hopper kernels that replace the JAX package's
Pallas kernels. It imports ``torch`` and never ``jax``: the JAX package is the
reference the port is tested against, not a dependency.

Ported so far: the SAVP prior-rollout generation path
(``python -m video_prediction_torch.generate``), the SAVP VAE-GAN training
step with its video SN discriminators (``python -m
video_prediction_torch.train``) and the evaluation path with its metrics,
the baselines and SV2P (``python -m video_prediction_torch.evaluate``), bf16
compute and gates, and the TFRecord datasets on the JAX package's native
backend, without TensorFlow (``data/``, ``native/``). See ``ROADMAP.md`` for
what is still to come.
"""

__version__ = "0.1.0"
