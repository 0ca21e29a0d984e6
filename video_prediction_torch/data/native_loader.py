"""TF-free data pipeline over the native C++ TFRecord reader.

A copy of ``video_prediction_tpu/data/native_loader.py`` with its imports
pointing at the port (``tests/test_torch_data.py`` keeps the code equal, and
the stream equal byte for byte at the same seed): parse -> decode ->
crop/scale -> random temporal slice -> shuffle/repeat -> batch -> prefetch,
using ``video_prediction_torch.native`` for record framing + Example parsing
(C++), numpy for preprocessing, libjpeg (or PIL where it is absent) for
JPEG and PIL for PNG decode, and a background thread for batch prefetch.
It is the port's only TFRecord backend (``data/base.py#make_iterator``).

Reference counterpart: ``datasets/base_dataset.py`` (whose heavy lifting is
tf.data's C++ core); this module plays that role with our own native code.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def bilinear_resize_uint8(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize with half-pixel centers (tf.image.resize semantics),
    vectorized over leading dims; uint8 in/out (rounded, clipped)."""
    *lead, h, w, c = images.shape
    x = images.reshape(-1, h, w, c).astype(np.float32)

    def coords(n_out, n_in):
        q = (np.arange(n_out, dtype=np.float32) + 0.5) * (n_in / n_out) - 0.5
        q = np.clip(q, 0.0, n_in - 1.0)
        lo = np.floor(q).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = q - lo
        return lo, hi, frac.astype(np.float32)

    y0, y1, fy = coords(out_h, h)
    x0, x1, fx = coords(out_w, w)
    top = x[:, y0][:, :, x0] * (1 - fx[None, None, :, None]) + x[:, y0][:, :, x1] * fx[None, None, :, None]
    bot = x[:, y1][:, :, x0] * (1 - fx[None, None, :, None]) + x[:, y1][:, :, x1] * fx[None, None, :, None]
    out = top * (1 - fy[None, :, None, None]) + bot * fy[None, :, None, None]
    out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.reshape(*lead, out_h, out_w, c)


def center_crop_or_pad(images: np.ndarray, size: int) -> np.ndarray:
    """Center crop (or zero-pad) the spatial dims to ``size`` x ``size``
    (tf.image.resize_with_crop_or_pad semantics)."""
    *lead, h, w, c = images.shape
    out = images
    # crop
    if h > size:
        top = (h - size) // 2
        out = out[..., top : top + size, :, :]
    if w > size:
        left = (w - size) // 2
        out = out[..., :, left : left + size, :]
    # pad
    *lead, h2, w2, _ = out.shape
    if h2 < size or w2 < size:
        pt = (size - h2) // 2
        pl = (size - w2) // 2
        pad = [(0, 0)] * len(lead) + [(pt, size - h2 - pt), (pl, size - w2 - pl), (0, 0)]
        out = np.pad(out, pad)
    return out


class NativeVideoPipeline:
    """Iterator of numpy batches for a ``VideoDataset``-style dataset.

    The dataset supplies schema (``parse_example_np``) and hparams; this
    class supplies shuffling, slicing, batching, and threaded prefetch.
    """

    SHUFFLE_BUFFER = 1024
    PREFETCH_BATCHES = 4

    def __init__(self, dataset, batch_size: int):
        self.ds = dataset
        self.batch_size = batch_size
        hp = dataset.hparams
        self.shuffle = dataset.mode == "train" or (
            dataset.mode == "val" and hp.shuffle_on_val
        )
        self.rng = np.random.RandomState(dataset.seed if dataset.seed is not None else 0)
        if not dataset.filenames:
            raise FileNotFoundError(f"no tfrecords under {dataset.input_dir!r}")

    # ------------------------------------------------------------------ #
    def _raw_examples(self) -> Iterator[Any]:
        """Infinite (repeated) stream of native-parsed examples via the
        batched zero-copy C boundary: ``GatheredExample``s when the
        dataset uses the stock schema parser (keys matched in C++ against
        the fixed request — no per-example Python dict), parsed feature
        dicts otherwise."""
        from video_prediction_torch import native
        from video_prediction_torch.data.base import VideoDataset

        use_gather = (
            type(self.ds).parse_example_np is VideoDataset.parse_example_np
        )
        keys = self.ds.gather_plan()[0] if use_gather else None
        files = list(self.ds.filenames)
        while True:
            if self.shuffle:
                self.rng.shuffle(files)
            for f in files:
                if use_gather:
                    yield from native.iter_gathered(f, keys)
                else:
                    yield from native.iter_examples(f)

    def _examples(self) -> Iterator[Dict[str, np.ndarray]]:
        """Parsed + sliced examples, with a shuffle buffer in train mode."""

        hp = self.ds.hparams
        source_len = self.ds.source_sequence_length
        seq_len = hp.sequence_length
        # time_shift quantizes the random start offset of a CONTIGUOUS
        # window (reference slice_sequences semantics; see
        # data/base.py#_slice_sequences for the full note)
        shift = max(hp.time_shift, 1)
        if seq_len > source_len:
            raise ValueError(
                f"sequence_length {seq_len} > stored length {source_len}"
            )
        num_shifts = (source_len - seq_len) // shift

        from video_prediction_torch import native

        buf: List[Dict[str, np.ndarray]] = []
        for raw in self._raw_examples():
            # random temporal window chosen BEFORE parsing, so only the
            # sliced frames are decoded/copied (time_indices — 2.5x fewer
            # JPEG decodes at seq 12 of 30)
            off = (
                self.rng.randint(0, num_shifts + 1) * shift
                if (self.ds.mode == "train" and num_shifts > 0)
                else 0
            )
            idx = range(off, off + seq_len)
            if isinstance(raw, native.GatheredExample):
                ex = self.ds.parse_gathered_np(raw, time_indices=idx)
            else:
                ex = self.ds.parse_example_np(raw, time_indices=idx)
            if not self.shuffle:
                yield ex
                continue
            buf.append(ex)
            if len(buf) >= self.SHUFFLE_BUFFER:
                i = self.rng.randint(len(buf))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
        # (infinite stream: never drains)

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        it = self._examples()
        while True:
            examples = [next(it) for _ in range(self.batch_size)]
            yield {k: np.stack([e[k] for e in examples]) for k in examples[0]}

    # ------------------------------------------------------------------ #
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetch batches on a background thread (the tf.data .prefetch
        role): parsing/decode overlaps device compute."""
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH_BATCHES)
        stop = threading.Event()

        def worker():
            try:
                for b in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate to consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
