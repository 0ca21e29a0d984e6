"""Training: schedules, the train state (two Adams), the train step, run
directories and checkpoints, and the CLI (``python -m
video_prediction_torch.train``, in ``__main__.py``). Re-exports the public
names of ``video_prediction_tpu/train/__init__.py``, all of them."""

from video_prediction_torch.train.state import TrainState, create_train_state  # noqa: F401
from video_prediction_torch.train.step import make_train_step, make_eval_step  # noqa: F401
