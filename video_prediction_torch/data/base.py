"""Dataset base classes: TFRecord video pipelines -> numpy batches, without
TensorFlow.

The port of ``video_prediction_tpu/data/base.py`` (reference
``video_prediction/datasets/base_dataset.py``: ``BaseVideoDataset`` /
``VideoDataset``) on its native backend only: the C++ TFRecord reader and
Example parser (``video_prediction_torch.native``), numpy preprocessing and
a prefetch thread (``data/native_loader.py``). The JAX package's default
tf.data backend is not ported: ``backend="tf"`` (or ``VP_DATA_BACKEND=tf``)
raises, and its TF-only methods (``parser``, ``preprocess_images``,
``_slice_sequences``, ``make_dataset``/``make_batch``) raise
``NotImplementedError`` naming the native path. Batches cross to the device
as uint8 (``data/loader.py#DeviceFeeder``).

The methods the native backend runs are copies of the JAX package's;
``tests/test_torch_data.py`` keeps each equal to its original and the
batches equal byte for byte at the same seed.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from video_prediction_torch.configs.hparams import DatasetHparams

_NO_TF = (
    "the PyTorch port has no tf.data backend; its TFRecord pipeline is the native one "
    "(make_iterator, data/native_loader.py#NativeVideoPipeline)"
)


def _pil_decode(raw) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


_DECODE_POOL = None
_DECODE_POOL_SIZE = 0
_DECODE_POOL_LOCK = threading.Lock()


def _decode_pool():
    """Shared frame-decode thread pool for the native backend, sized by
    ``VP_DATA_DECODE_WORKERS`` (0/1 = serial, the default). The native
    JPEG decoder releases the GIL, so N workers scale the decode-bound
    path nearly linearly on an N-core host — the role tf.data's
    ``num_parallel_calls`` plays for the reference pipeline. Correctness
    is covered by a pooled-vs-serial parity test; its throughput has not
    been measured."""
    global _DECODE_POOL, _DECODE_POOL_SIZE
    n = int(os.environ.get("VP_DATA_DECODE_WORKERS", "0"))
    if n <= 1:
        return None
    with _DECODE_POOL_LOCK:  # prefetch threads race here; don't leak pools
        if _DECODE_POOL is None or _DECODE_POOL_SIZE != n:
            from concurrent.futures import ThreadPoolExecutor

            if _DECODE_POOL is not None:
                _DECODE_POOL.shutdown(wait=False)
            _DECODE_POOL = ThreadPoolExecutor(n, thread_name_prefix="vp-decode")
            _DECODE_POOL_SIZE = n
        return _DECODE_POOL


class BaseVideoDataset:
    """API mirror of the reference's ``BaseVideoDataset``:
    ``__init__(input_dir, mode, hparams)``, ``make_batch``/``make_iterator``,
    ``num_examples_per_epoch``."""

    # subclasses override
    default_hparams = DatasetHparams()

    def __init__(
        self,
        input_dir: str,
        mode: str = "train",
        hparams: Optional[DatasetHparams] = None,
        seed: Optional[int] = None,
    ):
        self.input_dir = input_dir
        self.mode = mode
        self.hparams = hparams or self.default_hparams
        self.seed = seed

        self.filenames = sorted(
            glob.glob(os.path.join(input_dir, "*.tfrecord*"))
            + glob.glob(os.path.join(input_dir, "*.tfrecords"))
        )

    # ------------------------------------------------------------------ #
    def num_examples_per_epoch(self) -> int:
        """Count records (cached), with the native reader."""
        if not hasattr(self, "_num_examples"):
            from video_prediction_torch import native

            self._num_examples = sum(sum(1 for _ in native.read_records(f)) for f in self.filenames)
        return self._num_examples

    @property
    def source_sequence_length(self) -> int:
        """Frames stored per record (the slice window comes from hparams)."""
        raise NotImplementedError

    # ---- the JAX package's tf.data path: not ported ---------------------- #
    def parser(self, serialized):
        raise NotImplementedError(f"parser: {_NO_TF}; parse_example_np parses natively")

    def preprocess_images(self, images):
        raise NotImplementedError(f"preprocess_images: {_NO_TF}; _materialize_images crops and scales")

    def _slice_sequences(self, example):
        raise NotImplementedError(f"_slice_sequences: {_NO_TF}; NativeVideoPipeline slices")

    def make_dataset(self, batch_size: int):
        raise NotImplementedError(f"make_dataset: {_NO_TF}")

    def make_batch(self, batch_size: int):
        raise NotImplementedError(f"make_batch: {_NO_TF}")

    def _resolve_backend(self, backend: Optional[str]) -> str:
        """native, the port's only backend. Resolution: explicit arg >
        VP_DATA_BACKEND env > auto (native); ``tf`` is refused."""
        backend = backend or os.environ.get("VP_DATA_BACKEND", "")
        if backend == "tf":
            raise ValueError(f"data backend 'tf': {_NO_TF}")
        if backend and backend != "native":
            raise ValueError(f"unknown data backend {backend!r} (want 'native')")
        return "native"

    def make_iterator(
        self, batch_size: int, backend: Optional[str] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite numpy-batch iterator: the C++ TFRecord reader and the
        numpy pipeline (``data/native_loader.py``)."""
        self._resolve_backend(backend)
        from video_prediction_torch.data.native_loader import NativeVideoPipeline

        yield from NativeVideoPipeline(self, batch_size)


class VideoDataset(BaseVideoDataset):
    """TFRecord datasets with per-frame feature keys like
    ``"%d/image_aux1/encoded"`` (the BAIR/softmotion family layout).

    Subclasses configure class attrs instead of rewriting the parser —
    the single choke point the reference spreads across per-dataset files.
    """

    # class attrs overridden by subclasses
    IMAGE_KEY = "%d/image_aux1/encoded"
    IMAGE_SHAPE = (64, 64, 3)  # H, W, C
    IMAGE_ENCODING = "raw"  # raw | jpeg | png
    ACTION_KEY: Optional[str] = "%d/action"
    ACTION_DIM = 4
    STATE_KEY: Optional[str] = "%d/endeffector_pos"
    STATE_DIM = 3
    SOURCE_SEQUENCE_LENGTH = 30

    @property
    def source_sequence_length(self) -> int:
        return self.SOURCE_SEQUENCE_LENGTH

    def parse_example_np(
        self, feats: Dict[str, Any], time_indices=None
    ) -> Dict[str, np.ndarray]:
        """TF-free counterpart of ``parser``: consume the feature dict from
        ``native.parse_example`` / ``native.iter_examples`` and produce the
        same ``{images uint8 [T,H,W,C], actions?, states?}`` contract, with
        crop/scale preprocessing done in numpy (``data/native_loader.py``).

        ``time_indices`` selects which stored frames to materialize (the
        loader passes the random temporal window here, so only the sliced
        frames are JPEG-decoded/copied — 2.5x fewer decodes at the zoo's
        sequence_length 12 of 30 stored frames); default all frames.
        """
        if time_indices is None:
            time_indices = range(self.SOURCE_SEQUENCE_LENGTH)
        hp = self.hparams
        # strict exactly-one unpack: a record with several byte payloads
        # under one frame key is malformed and must raise, not silently
        # train on the first payload
        raws = []
        for i in time_indices:
            (raw,) = feats[self.IMAGE_KEY % i]
            raws.append(raw)
        out = {"images": self._materialize_images(raws)}
        if self.ACTION_KEY and hp.use_state:
            out["actions"] = np.stack(
                [feats[self.ACTION_KEY % i] for i in time_indices]
            ).astype(np.float32)
        if self.STATE_KEY and hp.use_state:
            out["states"] = np.stack(
                [feats[self.STATE_KEY % i] for i in time_indices]
            ).astype(np.float32)
        return out

    def _materialize_images(self, raws) -> np.ndarray:
        """Decode a list of per-frame payloads and apply crop/scale — the
        single implementation both native parse paths share."""
        from video_prediction_torch.data.native_loader import (
            bilinear_resize_uint8,
            center_crop_or_pad,
        )

        h, w, c = self.IMAGE_SHAPE
        hp = self.hparams
        if self.IMAGE_ENCODING == "raw":
            decode = lambda raw: np.frombuffer(raw, np.uint8).reshape(h, w, c)
        elif self.IMAGE_ENCODING == "jpeg":
            from video_prediction_torch import native

            if native.codec_available():
                decode = native.decode_jpeg  # C++ libjpeg, no PIL
            else:  # pragma: no cover - fallback when libjpeg is absent
                decode = _pil_decode
        elif self.IMAGE_ENCODING == "png":
            decode = _pil_decode
        else:
            raise ValueError(self.IMAGE_ENCODING)
        pool = _decode_pool()
        # the C decoder releases the GIL, so a thread pool scales the
        # dominant JPEG-decode cost across host cores (the role tf.data's
        # num_parallel_calls plays for the reference); serial by default
        frames = list(pool.map(decode, raws)) if pool else [decode(r) for r in raws]
        images = np.stack(frames)
        if hp.crop_size:
            images = center_crop_or_pad(images, hp.crop_size)
        if hp.scale_size and images.shape[1:3] != (hp.scale_size, hp.scale_size):
            images = bilinear_resize_uint8(images, hp.scale_size, hp.scale_size)
        return images

    # ---- native gather fast path -------------------------------------- #
    def gather_plan(self):
        """Ordered key request for ``native.iter_gathered`` (cached):
        ``(keys, has_actions, has_states)`` — images keys first (one per
        stored frame), then per-frame actions, then states."""
        if getattr(self, "_gather_plan_cache", None) is None:
            T = self.SOURCE_SEQUENCE_LENGTH
            hp = self.hparams
            keys = [self.IMAGE_KEY % i for i in range(T)]
            has_a = bool(self.ACTION_KEY and hp.use_state)
            has_s = bool(self.STATE_KEY and hp.use_state)
            if has_a:
                keys += [self.ACTION_KEY % i for i in range(T)]
            if has_s:
                keys += [self.STATE_KEY % i for i in range(T)]
            self._gather_plan_cache = (keys, has_a, has_s)
        return self._gather_plan_cache

    def parse_gathered_np(self, g, time_indices=None) -> Dict[str, np.ndarray]:
        """Consume one ``native.GatheredExample`` for :meth:`gather_plan`'s
        request — the data-plane hot path: no per-feature dict, key
        matching already done in C++. Same contract and preprocessing as
        :meth:`parse_example_np`."""
        T = self.SOURCE_SEQUENCE_LENGTH
        if time_indices is None:
            time_indices = range(T)
        _, has_a, has_s = self.gather_plan()
        nvals = g.nvals
        types = g.types
        if not (types[:T] == 0).all() or not (nvals[:T] == 1).all():
            raise ValueError(
                "malformed record: every stored frame key must hold exactly "
                "one bytes payload"
            )
        # request order puts image payloads first, one per frame
        out = {"images": self._materialize_images([g.byte_values[i] for i in time_indices])}
        idx = list(time_indices)
        fpos = 0
        if has_a:
            na = int(nvals[T : 2 * T].sum())
            out["actions"] = g.floats[:na].reshape(T, -1)[idx].astype(np.float32)
            fpos = na
        if has_s:
            s0 = 2 * T if has_a else T
            ns = int(nvals[s0 : s0 + T].sum())
            out["states"] = (
                g.floats[fpos : fpos + ns].reshape(T, -1)[idx].astype(np.float32)
            )
        return out
