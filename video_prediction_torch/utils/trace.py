"""Spans and counters inside the port, read beside a ``torch.profiler`` trace.

A span times one piece of the program's work on the host clock
(``time.perf_counter_ns``, the clock the benchmark and the train CLI time
with)::

    with trace.span("multistep.replay"):
        graph.replay()

It records its name, start and end, its own id, the id of the span open on
the same thread when it began (its parent, None for a root), the id of its
root (shared by every span of one unit of work: a call, a request, a
chunk), its depth below that root and its thread. Each thread keeps its own
stack of open spans, so a span on ``DeviceFeeder``'s thread is a root there.

A span records only while a ``torch.profiler`` session is active in the
process (the flag every profiler sets on start and clears on stop, CPU or
CUDA activity alike): every reader of spans runs one, and a span is read
against the device trace the profiler takes. With no profiler a span costs
that flag's read and allocates nothing. ``setup_span`` records always:
the one-off spans of a process's set-up (``multistep.eager``,
``multistep.capture``), kept in a list of ``MAX_SETUP``.

``span(name, device=...)`` with a CUDA device also records a pair of
timing CUDA events around the span on the current stream; ``spans()``
resolves them to ``device_ms`` when it is read, never where they are
recorded. ``StepPhases`` holds the timing events at the phase boundaries
of train steps (``train/step.py#_update``): the CUDA graph of a
``MultiStep`` captures them as event-record nodes, so that every replay
records them; ``phase_ms()`` reads the last steps' phases.

``spans()`` lists what was recorded, ``clear()`` empties it, and
``counters()`` reads the kernel wrappers' launch counters
(``kernels.launch_counts()``). ``mark_clock`` and ``write_chrome_track``
put the spans into a profiler's Chrome trace, on the trace's clock.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
import warnings
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 18  # hot spans kept, the oldest dropped first
MAX_SETUP = 32  # set-up spans kept
CLOCK_MARK = "trace.clock"  # the user annotation that ties the host clock to a trace's

_spans: Deque["_Span"] = collections.deque(maxlen=MAX_SPANS)
_setup: Deque["_Span"] = collections.deque(maxlen=MAX_SETUP)
_ids = itertools.count(1)
_local = threading.local()
_last_phases: Optional["StepPhases"] = None


class _Span:
    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "root", "depth", "thread", "setup", "events",
                 "device_ms", "_sink")

    def __init__(self, name: str, sink: Deque["_Span"], device: Optional[torch.device] = None):
        self.name, self._sink, self.setup = name, sink, sink is _setup
        self.events, self.device_ms = None, None
        if device is not None and device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.depth = len(stack)
        self.thread = threading.get_ident()
        stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        _local.stack.pop()
        self._sink.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def as_dict(self) -> Dict:
        out = {k: getattr(self, k) for k in ("name", "start_ns", "end_ns", "id", "parent", "root", "depth",
                                             "thread", "setup")}
        if self.events is not None:  # resolved once, after the device ran the span's work
            self.events[1].synchronize()
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        if self.device_ms is not None:
            out["device_ms"] = self.device_ms
        return out


class _Off:
    """The span that records nothing (no profiler active)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, device: Optional[torch.device] = None):
    """A context manager that records a span named ``name`` while a profiler
    is active, and nothing otherwise. ``device``: on a CUDA device, also a
    pair of timing events around the span (``device_ms``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, _spans, device)


def setup_span(name: str) -> _Span:
    """A set-up span, recorded always; ``.seconds`` is its duration once it
    has closed."""
    return _Span(name, _setup)


def spans() -> List[Dict]:
    """The recorded spans, set-up spans among them (``setup``), in order of
    their starts: ``name``, ``start_ns``, ``end_ns``, ``id``, ``parent``,
    ``root``, ``depth``, ``thread`` and, for a span with device events,
    ``device_ms`` (this waits for the device to run the span's work)."""
    recorded = list(_setup) + list(_spans)
    return [s.as_dict() for s in sorted(recorded, key=lambda s: s.start_ns)]


def clear() -> None:
    """Forget every recorded span, set-up spans too."""
    global _last_phases
    _spans.clear()
    _setup.clear()
    _last_phases = None


def counters() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by wrapper
    (``kernels.launch_counts()``)."""
    from video_prediction_torch import kernels

    return kernels.launch_counts()


class StepPhases:
    """Timing CUDA events at the phase boundaries of train steps, on the
    current stream: ``mark("start")`` opens a step, each later mark closes
    the phase named by it (``losses``, ``backward``, ``allreduce``,
    ``update``). The events are ``external``: recorded inside a CUDA graph's
    capture they become the graph's event-record nodes, and every replay
    records them again."""

    def __init__(self):
        self.steps: List[List] = []

    def mark(self, label: str) -> None:
        if label == "start":
            self.steps.append([])
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.steps[-1].append((label, event))

    def times(self) -> List[Dict[str, float]]:
        """Each step's phases in device ms (waits for the device)."""
        out = []
        for marks in self.steps:
            marks[-1][1].synchronize()
            out.append({label: a.elapsed_time(b) for (_, a), (label, b) in zip(marks, marks[1:])})
        return out


class _NoPhases:
    """The phases of a step that records none."""

    __slots__ = ()

    def mark(self, label: str) -> None:
        pass


NO_PHASES = _NoPhases()


def phases_for(device: torch.device):
    """The phase events for eager steps about to run on ``device``: a new
    ``StepPhases``, the one ``phase_ms()`` reads from now on, on a CUDA
    device while a profiler is active; else ``NO_PHASES``."""
    if device.type != "cuda" or not _profiler._is_profiler_enabled:
        return NO_PHASES
    return use_phases(StepPhases())


def use_phases(phases):
    """Make ``phases`` (a graph's, replayed again) the ones ``phase_ms()``
    reads; ``NO_PHASES`` changes nothing. Returns ``phases``."""
    global _last_phases
    if phases is not NO_PHASES:
        _last_phases = phases
    return phases


def phase_ms() -> Optional[List[Dict[str, float]]]:
    """The device ms of each phase of each of the last steps that recorded
    phase events (a graph's last replay: its K steps), or None where no step
    recorded any. Waits for the device."""
    return _last_phases.times() if _last_phases is not None else None


def mark_clock(marks: int = 3) -> List[Tuple[int, int]]:
    """Inside a profiler session with CPU activity: ``marks`` user
    annotations named ``CLOCK_MARK``, each with the host clock (ns) just
    before and just after it (the first takes the profiler's first-call
    cost; ``write_chrome_track`` uses the tightest)."""
    out = []
    for _ in range(marks):
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(CLOCK_MARK):
            pass
        out.append((t0, time.perf_counter_ns()))
    return out


def write_chrome_track(path: str, marks: List[Tuple[int, int]]) -> int:
    """Add the spans recorded since ``marks`` (``mark_clock``'s, in the
    session that wrote ``path``) to the Chrome trace at ``path``, as a
    process of their own (``program spans``, a thread a host thread), moved
    onto the trace's clock by the marker whose host-clock bracket is the
    tightest. Returns the number of spans written: none, with a warning,
    where the trace does not hold the markers (the profile is kept as it
    is)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    stamps = [float(e["ts"]) for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X"]
    if len(stamps) != len(marks):
        warnings.warn(f"{path} holds {len(stamps)} {CLOCK_MARK!r} markers, not {len(marks)}: no program spans "
                      f"written into it")
        return 0
    (before, _), stamp = min(zip(marks, sorted(stamps)), key=lambda m: m[0][1] - m[0][0])
    offset_us = stamp - before / 1e3
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    track = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": "program spans"}}]
    for s in spans():
        if s["start_ns"] < marks[0][0]:
            continue
        args = {k: s[k] for k in ("id", "parent", "root", "setup", "device_ms") if k in s}
        track.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid, "tid": s["thread"],
                      "ts": s["start_ns"] / 1e3 + offset_us, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                      "args": args})
    events.extend(track)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(track) - 1
