"""The program's own spans and device events (``video_prediction_torch/utils/trace.py``)
beside the profiled window, for the per-layer metrics that read them.

The program records its spans only while a ``torch.profiler`` session is
active, so a cell's spans are those of its profiled window. A window that
is profiled again (``run.profile``) leaves its earlier tries' spans behind:
``window_spans`` keeps those that lie inside the last window, from
``trace["t0"]`` to ``t0 + wall_s`` on the host clock. A device time maps
to the host clock through the window's ``offset_us`` (``common.profiled_window``).
That offset runs late by 55-312 us on an H100 (its marker is the profiler
session's first launch; ``tests/test_torch_trace.py`` holds it under
400 us), so an idle gap maps onto the host clock up to that much early;
PERF.md gives the idle shares read with the offset less 312 us beside them.
Where the program has no such module (a commit before it) every function
here gives None, and the metric is left off the line.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from benchmark import common


def program_trace():
    """The program's ``utils.trace`` module, or None where it has none."""
    try:
        from video_prediction_torch.utils import trace
    except ImportError:
        return None
    return trace


def all_spans() -> Optional[List[Dict]]:
    trace = program_trace()
    return None if trace is None else trace.spans()


def window_spans(data: Dict) -> Optional[List[Dict]]:
    """The program's spans that lie inside the last profiled window; None
    where the program records none."""
    spans = all_spans()
    if spans is None:
        return None
    t = data["trace"]
    lo = t["t0"] * 1e9
    hi = lo + t["wall_s"] * 1e9
    return [s for s in spans if not s["setup"] and lo <= s["start_ns"] and s["end_ns"] <= hi]


def mean_ms(data: Dict, name: str) -> Optional[float]:
    """Mean host ms of the window's spans named ``name``."""
    spans = window_spans(data)
    d = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans or () if s["name"] == name]
    return sum(d) / len(d) if d else None


def device_mean_ms(data: Dict, name: str) -> Optional[float]:
    """Mean device ms of the window's spans named ``name`` (their own CUDA
    events)."""
    spans = window_spans(data)
    d = [s["device_ms"] for s in spans or () if s["name"] == name and "device_ms" in s]
    return sum(d) / len(d) if d else None


def owners(spans: List[Dict], times_ns: List[float]) -> List[Optional[Dict]]:
    """For each of ``times_ns`` (ascending) the innermost span open then: the
    deepest, the latest started among equals; None where none is open."""
    marks = sorted([(s["start_ns"], 0, i) for i, s in enumerate(spans)] +
                   [(s["end_ns"], 1, i) for i, s in enumerate(spans)])
    active: Dict[int, Dict] = {}
    out, j = [], 0
    for t in times_ns:
        while j < len(marks) and marks[j][0] <= t:
            _, end, i = marks[j]
            if end:
                active.pop(i, None)
            else:
                active[i] = spans[i]
            j += 1
        out.append(max(active.values(), key=lambda s: (s["depth"], s["start_ns"])) if active else None)
    return out


def idle_gaps(data: Dict, spans: List[Dict]) -> List[Tuple[Optional[str], float]]:
    """Each device idle gap of the window (between its merged device
    intervals): the name of the innermost program span open when it began
    (None where none was), and its seconds."""
    t = data["trace"]
    _, merged = common.union_s([(a, b) for _, a, b in t["events"]])
    gaps = [(end, start) for (_, end), (start, _) in zip(merged, merged[1:])]
    found = owners(spans, [(end - t["offset_us"]) * 1e3 for end, _ in gaps])
    return [(o["name"] if o else None, (start - end) / 1e6) for o, (end, start) in zip(found, gaps)]


def idle_share_pct(data: Dict, name: str) -> Optional[float]:
    """Share of the window's device idle time (its gaps) whose gap began
    inside a span named ``name``; None without spans or device gaps."""
    spans = window_spans(data)
    if not spans:
        return None
    gaps = idle_gaps(data, spans)
    total = sum(s for _, s in gaps)
    if not total:
        return None
    by_owner: Dict[Optional[str], float] = collections.defaultdict(float)
    for owner, s in gaps:
        by_owner[owner] += s
    return 100.0 * by_owner[name] / total


def phase_mean_ms(phase: str) -> Optional[float]:
    """The program's last train steps' phase ``phase`` in device ms (a
    graph's last replay: the mean over its K steps)."""
    trace = program_trace()
    steps = trace.phase_ms() if trace is not None else None
    d = [s[phase] for s in steps or () if phase in s]
    return sum(d) / len(d) if d else None


def setup_s(names: Tuple[str, ...]) -> Optional[float]:
    """Seconds of the program's set-up spans: the last of each of ``names``,
    summed; None where one is missing."""
    last = {s["name"]: s for s in all_spans() or () if s["setup"]}
    if any(n not in last for n in names):
        return None
    return sum((last[n]["end_ns"] - last[n]["start_ns"]) / 1e9 for n in names)
