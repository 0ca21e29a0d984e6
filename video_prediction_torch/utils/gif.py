"""Animated-GIF encoding for summaries and saved predictions.

Counterpart of the reference's ``video_prediction/utils/ffmpeg_gif.py#
encode_gif`` (an ffmpeg subprocess pipe). This environment has no ffmpeg,
so we encode with PIL — same API: a ``[T, H, W, 3]`` float/uint8 array in,
GIF bytes out. Used for the TensorBoard GIF summaries (a distinctive
reference feature, SURVEY §5) and ``evaluate.py``/``generate.py`` outputs.

A copy of ``video_prediction_tpu/utils/gif.py`` (numpy and PIL only; copied
because importing the JAX package imports jax).
"""

from __future__ import annotations

import io
import numpy as np


def _to_uint8(images: np.ndarray) -> np.ndarray:
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = (np.clip(images, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return images


def encode_gif(images: np.ndarray, fps: int = 4) -> bytes:
    """Encode ``[T, H, W, 3]`` (float in [0,1] or uint8) to GIF bytes."""
    from PIL import Image

    images = _to_uint8(images)
    if images.ndim != 4 or images.shape[-1] not in (1, 3):
        raise ValueError(f"expected [T,H,W,1|3], got {images.shape}")
    if images.shape[-1] == 1:
        images = np.tile(images, (1, 1, 1, 3))
    frames = [Image.fromarray(f) for f in images]
    buf = io.BytesIO()
    frames[0].save(
        buf,
        format="GIF",
        save_all=True,
        append_images=frames[1:],
        duration=max(int(1000 / fps), 20),
        loop=0,
    )
    return buf.getvalue()


def save_gif(path: str, images: np.ndarray, fps: int = 4) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(images, fps))


def tile_image_grid(batch_images: np.ndarray, max_cols: int = 8) -> np.ndarray:
    """Tile ``[B, T, H, W, C]`` into ``[T, H*rows, W*cols, C]`` for one GIF
    showing the whole batch (reference ``tf_utils.add_gif_summaries``
    grid behavior)."""
    b, t, h, w, c = batch_images.shape
    cols = min(b, max_cols)
    rows = (b + cols - 1) // cols
    pad = rows * cols - b
    if pad:
        batch_images = np.concatenate(
            [batch_images, np.zeros((pad, t, h, w, c), batch_images.dtype)], axis=0
        )
    grid = batch_images.reshape(rows, cols, t, h, w, c)
    grid = grid.transpose(2, 0, 3, 1, 4, 5)  # [T, rows, H, cols, W, C]
    return grid.reshape(t, rows * h, cols * w, c)
