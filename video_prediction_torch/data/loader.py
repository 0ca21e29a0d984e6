"""Background host -> device feed.

The counterpart of ``video_prediction_tpu/data/loader.py#DeviceFeeder``: a
background thread pulls numpy batches from the dataset iterator and sends
them to the device ahead of consumption, so that the train step does not
wait on the host. On a CUDA device each batch stays uint8 (images are
normalized on the device, ``models/base.py#normalize_batch``) and goes
through pinned memory:

- the worker copies the host batch into a pinned buffer from a small ring,
  and copies that to the device with ``non_blocking=True`` on a side
  ``torch.cuda.Stream``, then records an event on it;
- a pinned buffer is refilled only after the event of its last copy has
  completed;
- the consumer's stream waits on the event before it gets the batch, and
  each device tensor is marked used on the consumer's stream
  (``record_stream``), so that the caching allocator does not hand its
  memory to a later copy while the consumer's work still reads it.

On the CPU it hands over the host arrays as tensors (``torch.from_numpy``),
not pinned. With ``stack=K`` it groups K consecutive host batches into one
``[K, B, ...]`` batch (``np.stack``, as the JAX package's ``_stack_batches``
does), which takes the same path: the train step of K steps a call
(``train/step.py``) reads it. A last group short of K batches is dropped. An
error in the host iterator or the copy reaches the consumer
at its next ``next()``; the end of the host iterator ends the feeder with
``StopIteration``; ``close()`` stops the thread. Data parallel (one process
per GPU, ``parallel/``): each rank's feeder carries that rank's rows to its
own device, ``cuda:LOCAL_RANK``: its side stream is made there, and its
thread makes that device current before it pins and copies. Spatial
partitioning (``rows=(coord, k)``): it cuts each host batch's images to the
``coord``-th of k slices of their height (``parallel/mesh.py#image_rows``)
before the copy, so only this rank's rows are pinned and sent.

Spans (``utils/trace.py``): ``feeder.wait``, the consumer's wait in
``next()``; ``feeder.produce``, on the feeder's thread, one a batch from
the host iterator's ``next`` (the stacking) to the copy queued.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from video_prediction_torch.parallel.mesh import image_rows
from video_prediction_torch.utils import trace

_END = object()
PREFETCH = 2  # batches queued ahead of the consumer, as in the JAX package


class DeviceFeeder:
    """Background-thread prefetcher: numpy iterator -> tensors on ``device``."""

    def __init__(self, host_iterator: Iterator[Dict[str, Any]], device, stack: int = 1,
                 rows: Optional[Tuple[int, int]] = None):
        if stack < 1:
            raise ValueError(f"stack must be at least 1, got {stack}")
        self._it = stack_batches(host_iterator, stack) if stack > 1 else host_iterator
        self._rows = rows
        self._stacked = stack > 1
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            # pinned buffers by key, and the event of each one's last copy
            self._slots: List[Optional[Dict[str, torch.Tensor]]] = [None] * (PREFETCH + 1)
            self._copied: List[Optional[torch.cuda.Event]] = [None] * (PREFETCH + 1)
        self._thread = threading.Thread(target=self._work, name="vp-device-feeder", daemon=True)
        self._thread.start()

    def _to_device(self, batch: Dict[str, Any], slot: int):
        if self._rows is not None:
            batch = image_rows(batch, *self._rows, stacked=self._stacked)
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the buffer's last copy has finished
        pinned = self._slots[slot]
        if pinned is None or any(k not in pinned or pinned[k].shape != v.shape or pinned[k].dtype != v.dtype
                                 for k, v in host.items()):
            pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in host.items()}
            self._slots[slot] = pinned
        with torch.cuda.stream(self._stream):
            out = {}
            for k, v in host.items():
                pinned[k].copy_(v)
                out[k] = pinned[k].to(self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._copied[slot] = ready
        return out, ready

    def _put(self, item) -> bool:
        """Queue ``item`` unless the feeder is closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            if self._cuda:  # a new thread starts on cuda:0, which is another rank's GPU
                torch.cuda.set_device(self._device)
            slot, it = 0, iter(self._it)
            while not self._stop.is_set():
                with trace.span("feeder.produce"):
                    batch = next(it, _END)
                    if batch is _END:
                        break
                    item = self._to_device(batch, slot)
                if not self._put(item):
                    return
                if self._cuda:
                    slot = (slot + 1) % len(self._slots)
        except BaseException as e:  # surfaced on the next __next__
            self._err = e
        finally:
            close = getattr(self._it, "close", None)
            if close is not None:  # a generator: run its clean-up (its prefetch thread stops)
                close()
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        with trace.span("feeder.wait"):
            item = self._q.get()
        if item is _END:
            self._q.put(_END)  # later calls end too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the thread (and the host iterator, where it is a generator)."""
        self._stop.set()
        self._thread.join(10.0)


def stack_batches(it: Iterator[Dict[str, Any]], k: int) -> Iterator[Dict[str, np.ndarray]]:
    """Group ``k`` consecutive batches of ``it`` into one with a leading
    ``[k]`` axis; a last group short of ``k`` is dropped. Closing the
    generator closes ``it`` where it is a generator."""
    try:
        while True:
            group = list(itertools.islice(it, k))
            if len(group) < k:
                return
            yield {key: np.stack([g[key] for g in group]) for key in group[0]}
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
