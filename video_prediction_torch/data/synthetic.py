"""Synthetic moving-shapes video dataset (no files required).

Not present in the reference (which ships download scripts instead); this
fills the same role for tests, benchmarks, and demos without network
access: deterministic procedurally-generated sequences of bouncing squares
with action conditioning (action = velocity delta), BAIR-shaped
(``images [T,64,64,3]``, ``actions [T,4]``, ``states [T,3]``).

A copy of ``video_prediction_tpu/data/synthetic.py`` (numpy only; copied
because importing the JAX package imports jax). ``tests/test_torch_configs.py``
checks that both copies emit the same bytes at the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from video_prediction_torch.configs.hparams import DatasetHparams


class SyntheticVideoDataset:
    """Bouncing-squares generator with the ``BaseVideoDataset`` iterator API."""

    default_hparams = DatasetHparams(context_frames=2, sequence_length=12)

    def __init__(
        self,
        input_dir: str = "",
        mode: str = "train",
        hparams: Optional[DatasetHparams] = None,
        seed: Optional[int] = None,
        image_size: int = 64,
        num_shapes: int = 3,
    ):
        self.mode = mode
        self.hparams = hparams or self.default_hparams
        self.image_size = image_size
        self.num_shapes = num_shapes
        base_seed = (seed if seed is not None else 0) + {"train": 0, "val": 10_000, "test": 20_000}.get(mode, 0)
        self._rng = np.random.RandomState(base_seed)

    def num_examples_per_epoch(self) -> int:
        return 256

    def _batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Vectorized batch generation: the whole [B, T, shapes] trajectory
        is computed with numpy broadcasting and rendered via separable
        box masks instead of a per-pixel python loop."""
        hp = self.hparams
        T = hp.sequence_length
        S = self.image_size
        K = self.num_shapes
        B = batch_size
        rng = self._rng

        pos = rng.uniform(S * 0.2, S * 0.8, (B, K, 2))
        vel = rng.uniform(-2.5, 2.5, (B, K, 2))
        half = rng.randint(S // 20, S // 10, (B, K)).astype(np.float64)
        colors = rng.uniform(0.4, 1.0, (B, K, 3)).astype(np.float32)

        # roll out bouncing trajectories [T, B, K, 2]
        traj = np.empty((T, B, K, 2))
        vels = np.empty((T, B, K, 2))
        lo = half[..., None]
        hi = S - half[..., None]
        p, v = pos, vel
        for t in range(T):
            traj[t] = p
            vels[t] = v
            p = p + v
            bounce = (p < lo) | (p > hi)
            v = np.where(bounce, -v, v)
            p = np.clip(p, lo, hi)

        # render with separable masks: [T,B,K,S] per axis -> outer product
        coords = np.arange(S)
        dy = np.abs(coords[None, None, None, :] - traj[..., 0:1])  # [T,B,K,S]
        dx = np.abs(coords[None, None, None, :] - traj[..., 1:2])
        my = (dy <= half[None, ..., None]).astype(np.float32)
        mx = (dx <= half[None, ..., None]).astype(np.float32)
        # [T,B,K,S,S] box masks; max-composite over shapes with colors.
        # uint8 output: images stay bytes until the device normalizes them.
        box = my[..., :, None] * mx[..., None, :]
        img = np.max(box[..., None] * colors[None, :, :, None, None, :], axis=2)
        img = (np.moveaxis(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)  # [B,T,S,S,3]
        # sensor-noise floor: real cameras never emit exact-zero frames —
        # dither the background with low-level noise like a real sensor
        noise_floor = rng.randint(1, 6, img.shape).astype(np.uint8)
        img = np.maximum(img, noise_floor)

        # all 4 action dims / 3 state dims carry signal (velocities of the
        # first two shapes; position + size of the first) — no all-zero
        # columns
        actions = np.concatenate(
            [np.moveaxis(vels[:, :, 0], 0, 1), np.moveaxis(vels[:, :, min(1, K - 1)], 0, 1)],
            axis=-1,
        ).astype(np.float32)
        states = np.concatenate(
            [np.moveaxis(traj[:, :, 0], 0, 1) / S, (half[:, None, 0:1] / S).repeat(T, axis=1)],
            axis=-1,
        ).astype(np.float32)
        return {"images": img, "actions": actions, "states": states}

    def make_iterator(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._batch(batch_size)

    def make_batch(self, batch_size: int):
        return self.make_iterator(batch_size)
