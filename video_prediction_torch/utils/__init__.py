"""Host-side utilities (GIF encoding, HTML galleries, the tools' device).
Re-exports the public names of ``video_prediction_tpu/utils/__init__.py``,
all of them."""

from video_prediction_torch.utils.gif import encode_gif, save_gif  # noqa: F401
from video_prediction_torch.utils.html import HTML  # noqa: F401
