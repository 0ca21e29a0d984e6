"""Hyperparameter dataclasses and the hparams zoo (copied from the JAX
package). Re-exports the public names of
``video_prediction_tpu/configs/__init__.py``, all of them."""

from video_prediction_torch.configs.hparams import (  # noqa: F401
    ModelHparams,
    DatasetHparams,
    parse_overrides,
    apply_overrides,
    load_hparams_json,
    resolve_model_hparams,
)
