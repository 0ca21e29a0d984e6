"""Training: schedules, the train state (two Adams), the train step, run
directories and checkpoints, and the CLI (``python -m
video_prediction_torch.train``, in ``__main__.py``)."""
