"""The port's spans and device events (``video_prediction_torch/utils/trace.py``)
and the benchmark's readers of them (``benchmark/spans.py``,
``benchmark/metrics/``).

On the CPU: with no profiler a span records nothing (set-up spans aside);
under a CPU ``torch.profiler`` session spans nest with their parent, root
and depth, on the main thread and on ``DeviceFeeder``'s; a ``MultiStep(2)``
call, a small SAVP forward and ``BestOfN.update`` record their spans; the
profiler's flag that spans read is pinned; the spans go into a Chrome trace
on its clock; the readers' window filter, idle-gap attribution and each new
reader on made-up data. On the card (``gpu``-marked, skipped here): the
phase events of a replayed ``MultiStep(4)`` graph against CUDA events
around the replay, a kernel launched in a span against the span's start
on the device's clock, and the graph's nodes with and without the phase
events. No jax here, so the file runs on a card machine without it::

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import json
import re
import threading

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark import spans as bspans
from video_prediction_torch import kernels as K
from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
from video_prediction_torch.data import DeviceFeeder
from video_prediction_torch.evaluate import BestOfN
from video_prediction_torch.models import get_model_class
from video_prediction_torch.train.state import TrainState, make_optimizers
from video_prediction_torch.train.step import MultiStep, make_train_step
from video_prediction_torch.utils import trace

torch.set_num_threads(1)

ZOO = zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=5, clip_length=3, batch_size=2)


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def named(records, name):
    return [s for s in records if s["name"] == name]


def small_model(seed=0, **extra):
    cls = get_model_class("savp")
    hp = resolve_model_hparams(cls.default_hparams(), str(ZOO), extra=dict(SMALL, **extra))
    model = cls(hp, image_shape=(32, 32, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def small_batch(k=None, seed=1):
    g = torch.Generator().manual_seed(seed)
    lead = (k,) if k else ()
    return {"images": torch.randint(0, 256, (*lead, 2, 5, 32, 32, 3), generator=g, dtype=torch.uint8),
            "actions": torch.randn(*lead, 2, 5, 4, generator=g)}


# ---- the profiler's flag ----------------------------------------------------


def _inside():
    """The flag, and whether a span records."""
    return torch.autograd.profiler._is_profiler_enabled, trace.span("a") is not trace.span("b")


def _context(ctx):
    with ctx:
        return _inside()


def _started(prof):
    prof.start()
    try:
        return _inside()
    finally:
        prof.stop()


@pytest.mark.parametrize("how", ["profile", "start_stop", "autograd_profile"])
def test_spans_read_the_flag_every_profiler_sets(how):
    """``torch.autograd.profiler._is_profiler_enabled`` is a bool, False with
    no profiler, True inside ``torch.profiler.profile`` (as a context and by
    ``start``/``stop``) and inside the legacy ``torch.autograd.profiler.profile``,
    False again after: the one read a span makes, and spans record exactly
    while it is True. A torch that moves the flag fails here."""
    assert _inside() == (False, False)
    if how == "profile":
        inside = _context(cpu_profile())
    elif how == "start_stop":
        inside = _started(cpu_profile())
    else:
        inside = _context(torch.autograd.profiler.profile())
    assert inside == (True, True)
    assert _inside() == (False, False)


# ---- spans ------------------------------------------------------------------


def test_without_a_profiler_only_setup_spans_record():
    """No profiler: ``span`` hands back one shared no-op (nothing allocated,
    nothing recorded); a set-up span records, with its duration."""
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        with trace.span("b", torch.device("cpu")):
            pass
    assert trace.spans() == []
    with trace.setup_span("multistep.capture") as s:
        with trace.span("inner"):
            pass
    got = trace.spans()
    assert [(r["name"], r["setup"], r["parent"], r["root"] == r["id"]) for r in got] == [
        ("multistep.capture", True, None, True)]
    assert s.seconds == (got[0]["end_ns"] - got[0]["start_ns"]) / 1e9 >= 0


def test_spans_nest_on_the_main_thread():
    """Under a CPU profiler: parent, root and depth from the thread's stack
    of open spans; a span opened after a root closes is a new root; starts
    and ends on ``perf_counter_ns``, children inside their parents."""
    with cpu_profile():
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
            with trace.span("d"):
                pass
        with trace.span("e"):
            pass
    got = {s["name"]: s for s in trace.spans()}
    assert list(got) == ["a", "b", "c", "d", "e"]
    a, b, c, d, e = (got[n] for n in "abcde")
    assert (a["parent"], b["parent"], c["parent"], d["parent"], e["parent"]) == (None, a["id"], b["id"], a["id"], None)
    assert {a["root"], b["root"], c["root"], d["root"]} == {a["id"]} and e["root"] == e["id"]
    assert (a["depth"], b["depth"], c["depth"], d["depth"], e["depth"]) == (0, 1, 2, 1, 0)
    assert a["start_ns"] <= b["start_ns"] <= c["start_ns"] <= c["end_ns"] <= b["end_ns"] <= d["start_ns"]
    assert d["end_ns"] <= a["end_ns"] <= e["start_ns"]
    assert len({s["thread"] for s in got.values()}) == 1 and not any(s["setup"] for s in got.values())


def test_feeder_spans_nest_on_the_feeder_thread():
    """``DeviceFeeder``'s thread keeps its own stack: each ``feeder.produce``
    is a root there, and a span the host iterator opens is its child; the
    consumer's ``feeder.wait`` spans are on the main thread."""

    def host():
        for i in range(3):
            with trace.span("host.batch"):
                yield {"images": np.full((2, 5, 8, 8, 3), i, np.uint8)}

    with cpu_profile():
        feeder = DeviceFeeder(host(), "cpu")
        try:
            got_batches = [next(feeder) for _ in range(3)]
        finally:
            feeder.close()
    assert [int(b["images"][0, 0, 0, 0, 0]) for b in got_batches] == [0, 1, 2]
    records = trace.spans()
    produce, inner, wait = (named(records, n) for n in ("feeder.produce", "host.batch", "feeder.wait"))
    assert len(produce) >= 3 and len(inner) == 3 and len(wait) == 3
    main = threading.get_ident()
    assert {s["thread"] for s in wait} == {main} and all(s["parent"] is None for s in wait)
    assert {s["thread"] for s in produce + inner} != {main} and len({s["thread"] for s in produce + inner}) == 1
    ids = {s["id"]: s for s in produce}
    for s in inner:
        parent = ids[s["parent"]]
        assert parent["parent"] is None and s["root"] == parent["id"] == parent["root"] and s["depth"] == 1


def test_multistep_call_records_its_spans():
    """A CPU ``MultiStep(2)`` call drawing its own noise records one
    ``multistep.call`` (a root) with its ``multistep.noise`` child; the K
    steps' generator rollouts are inside the call too. No profiler: none."""
    model = small_model()
    ts = TrainState(model, *make_optimizers(model, 2), 0, torch.Generator().manual_seed(1))
    step = make_train_step(model, 2)
    assert isinstance(step, MultiStep)
    step(ts, small_batch(2))
    assert trace.spans() == []
    with cpu_profile():
        step(ts, small_batch(2, seed=2))
    records = trace.spans()
    (call,) = named(records, "multistep.call")
    (noise,) = named(records, "multistep.noise")
    assert call["parent"] is None and call["root"] == call["id"]
    assert noise["parent"] == call["id"] and noise["root"] == call["id"]
    rollouts = named(records, "model.rollout")
    assert rollouts and all(r["root"] == call["id"] for r in rollouts)
    assert not named(records, "multistep.replay") and not named(records, "multistep.copy_in")
    assert all(call["start_ns"] <= s["start_ns"] <= s["end_ns"] <= call["end_ns"] for s in records)
    assert trace.phase_ms() is None  # no device events on the CPU


def test_a_rollout_records_one_step_span_a_timestep():
    """A small SAVP forward (T = 5) records one ``model.rollout`` with
    exactly T - 1 ``savp.step`` children, in order, inside it."""
    model = small_model().eval()
    batch = small_batch()
    with torch.inference_mode(), cpu_profile():
        model(batch, train=False, generator=torch.Generator().manual_seed(3))
    records = trace.spans()
    (rollout,) = named(records, "model.rollout")
    steps = named(records, "savp.step")
    assert len(steps) == batch["images"].shape[1] - 1 == 4
    assert all(s["parent"] == rollout["id"] == s["root"] and s["depth"] == rollout["depth"] + 1 for s in steps)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(steps, steps[1:]))
    assert rollout["start_ns"] <= steps[0]["start_ns"] and steps[-1]["end_ns"] <= rollout["end_ns"]


def test_bestofn_update_records_a_span_a_metric():
    """``BestOfN.update`` records one ``bestofn.update`` with one
    ``metric.<name>`` child a metric function; on the CPU no device time."""
    from video_prediction_torch import metrics as M

    target = torch.rand(2, 3, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    fns = {"psnr": M.peak_signal_to_noise_ratio, "mae": lambda t, p: (t - p).abs().mean(dim=(-3, -2, -1))}
    red = BestOfN(fns, target, context_frames=2, keep_best=True)
    chunk = torch.rand(2, 4, 4, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    with cpu_profile():
        red.update(chunk)
        red.update(chunk)
    records = trace.spans()
    updates = named(records, "bestofn.update")
    assert len(updates) == 2
    for name in ("metric.psnr", "metric.mae"):
        spans = named(records, name)
        assert sorted(s["parent"] for s in spans) == sorted(u["id"] for u in updates)
        assert all("device_ms" not in s for s in spans)
    assert len(records) == 6


def test_bestofn_prepares_a_split_metric_once_in_the_first_update():
    """A metric with ``prepare`` records one ``metric.<name>.target`` a
    ``BestOfN``, a child of the first update's ``metric.<name>``."""
    from video_prediction_torch.models.vgg import VGGMetric

    g = torch.Generator().manual_seed(0)
    target, chunk = torch.rand(2, 2, 32, 32, 3, generator=g), torch.rand(2, 2, 3, 32, 32, 3, generator=g)
    red = BestOfN({"vgg_csim": VGGMetric(allow_random=True)}, target, context_frames=2, keep_best=False)
    with torch.inference_mode(), cpu_profile():
        for _ in range(3):
            red.update(chunk)
    records = trace.spans()
    metric = named(records, "metric.vgg_csim")
    (prepare,) = named(records, "metric.vgg_csim.target")
    assert len(metric) == 3 and prepare["parent"] == metric[0]["id"]
    assert prepare["depth"] == metric[0]["depth"] + 1 and "device_ms" not in prepare
    assert len(records) == 7


def test_counters_read_the_launch_counters():
    """``counters()`` is ``kernels.launch_counts()``, read through."""
    K.reset_launch_counts()
    K.add_launches({"composite": {"float32": 3}, "fused_ln_gate": {"bfloat16": 2}})
    try:
        assert trace.counters() == K.launch_counts()
        assert trace.counters()["composite"] == 3 and trace.counters()["fused_ln_gate"] == 2
    finally:
        K.reset_launch_counts()


def test_no_phase_events_on_the_cpu():
    """The step's phase events exist only on a CUDA device; on the CPU, with
    a profiler or without, a step records none."""
    with cpu_profile():
        assert trace.phases_for(torch.device("cpu")) is trace.NO_PHASES
    assert trace.phases_for(torch.device("cpu")) is trace.NO_PHASES and trace.phase_ms() is None
    trace.NO_PHASES.mark("start")  # a no-op


def test_spans_go_into_the_chrome_trace_on_its_clock(tmp_path):
    """``write_chrome_track`` adds the spans recorded since the clock
    markers as a process of their own; an annotation opened inside a span
    lies inside it on the trace's clock (within 1 ms)."""
    with trace.span("before"):  # not profiled: not recorded
        pass
    with cpu_profile() as prof:
        marks = trace.mark_clock()
        for i in range(3):
            with trace.span("outer"):
                with torch.profiler.record_function(f"inner{i}"):
                    torch.ones(1000).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert trace.write_chrome_track(path, marks) == 3
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    (meta,) = [e for e in events if e.get("ph") == "M" and e.get("args", {}).get("name") == "program spans"]
    assert [e["name"] for e in mine] == ["outer"] * 3 and {e["pid"] for e in mine} == {meta["pid"]}
    for i, outer in enumerate(mine):
        (inner,) = [e for e in events if e.get("name") == f"inner{i}" and e.get("ph") == "X"]
        assert outer["ts"] - 1000 <= float(inner["ts"]) <= float(inner["ts"]) + inner["dur"] <= outer["ts"] + outer[
            "dur"] + 1000


def test_a_trace_without_the_clock_markers_is_kept_as_it_is(tmp_path):
    """Where the trace lacks the clock markers (a profile taken without CPU
    activity), ``write_chrome_track`` warns and leaves the file as it was,
    rather than stopping the run that profiled."""
    with cpu_profile() as prof:
        with trace.span("outer"):
            torch.ones(10).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    before = path.read_text()
    with pytest.warns(UserWarning, match="no program spans"):
        assert trace.write_chrome_track(str(path), [(0, 1)] * 3) == 0
    assert path.read_text() == before


# ---- benchmark/spans.py and the readers -------------------------------------


def _span(name, start_us, end_us, depth=0, setup=False, **kw):
    return dict(name=name, start_ns=int(start_us * 1e3), end_ns=int(end_us * 1e3), id=0, parent=None, root=0,
                depth=depth, thread=1, setup=setup, **kw)


T0_S, OFFSET_US = 100.0, 5_000.0  # the window starts at host 100 s; device us = host us + 5000


def _data(events_host_us, wall_s=0.01):
    """A profiled window at ``T0_S`` whose device events lie at the given
    host-clock microseconds, shifted onto the device's clock."""
    t0 = T0_S * 1e6
    events = [("k", t0 + a + OFFSET_US, t0 + b + OFFSET_US) for a, b in events_host_us]
    return {"trace": {"t0": T0_S, "wall_s": wall_s, "events": events, "offset_us": OFFSET_US}}


MADE_UP = [
    _span("multistep.call", 1e8 - 50, 1e8 + 10),  # began before the window: left out
    _span("multistep.call", 1e8 + 100, 1e8 + 5_000),
    _span("multistep.replay", 1e8 + 1_000, 1e8 + 3_000, depth=1),
    _span("feeder.produce", 1e8 + 500, 1e8 + 4_000),  # another thread, a root
    _span("multistep.call", 1e8 + 6_000, 1e8 + 9_000),
    _span("multistep.replay", 1e8 + 7_000, 1e8 + 8_000, depth=1),
    _span("multistep.capture", 1e8 - 3e6, 1e8 - 1e6, setup=True),  # set-up: read whole, not in the window
    _span("multistep.eager", 1e8 - 9e6, 1e8 - 4e6, setup=True),
    _span("multistep.replay", 1e8 + 20_000, 1e8 + 21_000, depth=1),  # after the window: left out
]
# device busy 0-1500, 2000-2500, 3500-7100, 7600-9500 (host us after t0): gaps at
# 1500 (in the replay, 500 us), 2500 (in the replay, 1000 us), 7100 (in the replay, 500 us)
EVENTS = [(0, 1_000), (900, 1_500), (2_000, 2_500), (3_500, 7_100), (7_600, 9_500)]


@pytest.fixture
def made_up(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [dict(s) for s in MADE_UP])
    monkeypatch.setattr(trace, "phase_ms", lambda: [{"losses": 1.0, "backward": 3.0, "update": 0.5},
                                                     {"losses": 1.5, "backward": 5.0, "update": 1.5}])
    return _data(EVENTS)


def test_window_filter_keeps_the_last_window(made_up):
    got = bspans.window_spans(made_up)
    assert [(s["name"], s["start_ns"]) for s in got] == [
        ("multistep.call", int((1e8 + 100) * 1e3)), ("multistep.replay", int((1e8 + 1_000) * 1e3)),
        ("feeder.produce", int((1e8 + 500) * 1e3)), ("multistep.call", int((1e8 + 6_000) * 1e3)),
        ("multistep.replay", int((1e8 + 7_000) * 1e3))]


def test_idle_gaps_are_named_by_the_innermost_open_span(made_up):
    gaps = bspans.idle_gaps(made_up, bspans.window_spans(made_up))
    assert [(n, round(s * 1e6)) for n, s in gaps] == [("multistep.replay", 500), ("multistep.replay", 1000),
                                                      ("multistep.replay", 500)]
    # gaps at 1000 (in a replay), 4300 (in a call, out of its replay), 5700 (between calls)
    moved = _data([(0, 1_000), (4_200, 4_300), (5_600, 5_700), (9_800, 9_900)])
    found = bspans.idle_gaps(moved, bspans.window_spans(moved))
    assert [(n, round(s * 1e6)) for n, s in found] == [("multistep.replay", 3200), ("multistep.call", 1300),
                                                       (None, 4100)]
    assert [n for n, _ in bspans.idle_gaps(_data([(0, 600), (700, 800)]), bspans.window_spans(made_up))] == [
        "feeder.produce"]


def test_owners_take_the_deepest_then_the_latest():
    spans = [_span("a", 0, 100), _span("b", 10, 50, depth=1), _span("c", 20, 30, depth=1), _span("d", 60, 70)]
    got = bspans.owners(spans, [1e3 * t for t in (0, 15, 25, 30, 55, 65, 100, 200)])
    assert [g["name"] if g else None for g in got] == ["a", "b", "c", "b", "a", "d", None, None]


def test_each_new_reader_on_made_up_data(made_up):
    """Each reader of this module's metrics on the made-up window; and None
    where the program recorded nothing."""
    read = {m: common.load_reader(m)(made_up) for m in (
        "replay_host_ms.train", "idle_in_replay_pct.train", "backward_device_ms.train", "update_device_ms.train",
        "first_call_s.train", "step_host_ms.gen", "idle_in_step_pct.gen", "step_host_ms.eval",
        "vgg_device_ms.eval")}
    assert read["replay_host_ms.train"] == pytest.approx(1.5)  # 2 ms and 1 ms
    assert read["idle_in_replay_pct.train"] == pytest.approx(100.0)
    assert read["backward_device_ms.train"] == pytest.approx(4.0)
    assert read["update_device_ms.train"] == pytest.approx(1.0)
    assert read["first_call_s.train"] == pytest.approx(7.0)  # 5 s eager + 2 s capture
    assert read["step_host_ms.gen"] is None and read["step_host_ms.eval"] is None
    assert read["idle_in_step_pct.gen"] == pytest.approx(0.0)
    assert read["vgg_device_ms.eval"] is None


def test_generation_and_evaluation_readers(monkeypatch):
    steps = [_span("model.rollout", 1e8, 1e8 + 4_000)]
    steps += [_span("savp.step", 1e8 + 1_000 * i, 1e8 + 1_000 * i + 800, depth=1) for i in range(4)]
    steps += [_span("metric.vgg_csim", 1e8 + 4_100, 1e8 + 4_200, device_ms=d) for d in (30.0, 34.0)]
    monkeypatch.setattr(trace, "spans", lambda: [dict(s) for s in steps])
    data = _data([(0, 500), (550, 1_500), (1_900, 4_000)])  # gaps at 500 (a step, 50 us), 1500 (a step, 400 us)
    assert common.load_reader("step_host_ms.gen")(data) == pytest.approx(0.8)
    assert common.load_reader("step_host_ms.eval")(data) == pytest.approx(0.8)
    assert common.load_reader("idle_in_step_pct.gen")(data) == pytest.approx(100.0)
    assert common.load_reader("vgg_device_ms.eval")(data) == pytest.approx(32.0)
    steps[2]["end_ns"] = int((1e8 + 1_400) * 1e3)  # the second gap now begins in the rollout alone
    assert common.load_reader("idle_in_step_pct.gen")(data) == pytest.approx(100.0 * 50 / 450)


def test_readers_give_none_without_the_program_module(monkeypatch):
    """A program with no ``utils.trace`` (the commit before it): every new
    reader returns None, and the metric is left off the line."""
    monkeypatch.setattr(bspans, "program_trace", lambda: None)
    data = _data(EVENTS)
    for m in ("replay_host_ms.train", "idle_in_replay_pct.train", "backward_device_ms.train",
              "update_device_ms.train", "first_call_s.train", "step_host_ms.gen", "idle_in_step_pct.gen",
              "step_host_ms.eval", "vgg_device_ms.eval"):
        assert common.load_reader(m)(data) is None, m


def test_readers_give_none_without_device_events(monkeypatch):
    """The CPU rehearsal's window has spans but no device events: the idle
    shares are None, the host means are read."""
    monkeypatch.setattr(trace, "spans", lambda: [dict(s) for s in MADE_UP])
    data = _data([])
    assert common.load_reader("idle_in_replay_pct.train")(data) is None
    assert common.load_reader("replay_host_ms.train")(data) == pytest.approx(1.5)


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase events are CUDA events in a captured graph")
    return torch.device("cuda", 0)


def _card_step(dev, k, keep_graph=False):
    """The flagship at batch 4 and 6 frames on the card, ``MultiStep(k)``,
    one call eager and the next captured."""
    cls = get_model_class("savp")
    hp = resolve_model_hparams(cls.default_hparams(), str(ZOO), extra=dict(sequence_length=6, batch_size=4))
    model = cls(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev)
    ts = TrainState(model, *make_optimizers(model, k), 0, torch.Generator(device=dev).manual_seed(3))
    step = make_train_step(model, k)
    step.keep_graph = keep_graph
    g = torch.Generator().manual_seed(1)
    batches = {"images": torch.randint(0, 256, (k, 4, 6, 64, 64, 3), generator=g, dtype=torch.uint8).to(dev),
               "actions": torch.randn(k, 4, 6, 4, generator=g).to(dev)}
    step(ts, batches)
    step(ts, batches)
    torch.cuda.synchronize()
    return ts, step, batches


@pytest.mark.gpu
def test_replay_phases_sum_to_the_replay(dev):
    """A ``MultiStep(4)`` replay's phase events (losses, backward, update of
    each of its 4 steps), summed, lie within 3% of the replay's device time
    between CUDA events around it, three replays in a row; the capture's
    set-up span is ``capture_s``."""
    ts, step, batches = _card_step(dev, 4)
    (capture,) = [s for s in trace.spans() if s["name"] == "multistep.capture"]
    assert step.capture_s == pytest.approx((capture["end_ns"] - capture["start_ns"]) / 1e9)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        a.record()
        step(ts, batches)
        b.record()
        torch.cuda.synchronize()
        phases = trace.phase_ms()
        assert len(phases) == 4 and all(list(p) == ["losses", "backward", "update"] for p in phases)
        total = sum(sum(p.values()) for p in phases)
        assert abs(total - a.elapsed_time(b)) <= 0.03 * a.elapsed_time(b), (total, a.elapsed_time(b))


@pytest.mark.gpu
def test_a_kernel_starts_inside_its_span_on_the_device_clock(dev):
    """In a profiled window (``benchmark/common.py#profiled_window``), a kernel
    launched inside a span starts on the device no earlier than the span's
    start mapped onto the device's clock, less 50 us, and no later than
    200 us after its end: 20 launches, each on an idle device. The first
    10 tie the clocks (the least lag from a span's start to its kernel's
    start); the last 10 are held to it. The window's ``offset_us``, which
    ``benchmark/spans.py`` maps the idle gaps with, lies between that tie
    less 100 us and the tie plus 400 us: its marker is the profiler
    session's first launch, which starts later than the launches after it
    (55-312 us on an H100), and the idle shares are read under that error.
    A window whose device records fall short is profiled again, as the
    benchmark does (5 windows at most)."""
    x = torch.zeros(1 << 20, device=dev)
    x.add_(1.0)  # the op's first call, which sets up its dispatch, outside the window
    torch.cuda.synchronize()

    def units():
        for _ in range(20):
            torch.cuda.synchronize()  # each launch on an idle device
            with trace.span("test.launch"):
                x.add_(1.0)

    for _ in range(5):
        trace.clear()
        window = common.profiled_window(units, torch.cuda.synchronize, dev)
        if len(window["events"]) == 21:
            break
    launched = [s for s in trace.spans() if s["name"] == "test.launch"]
    assert len(launched) == 20 and len(window["events"]) == 21  # the window's marker and 20 launches
    pairs = [(s["start_ns"] / 1e3, s["end_ns"] / 1e3, start_us) for s, (_, start_us, _) in
             zip(launched, window["events"][1:])]
    tie = min(start_us - host_start for host_start, _, start_us in pairs[:10])
    assert tie - 100.0 <= window["offset_us"] <= tie + 400.0, (window["offset_us"], tie)
    for host_start, host_end, start_us in pairs[10:]:
        assert host_start + tie - 50.0 <= start_us <= host_end + tie + 200.0, (host_start, host_end, start_us, tie)


@pytest.mark.gpu
def test_phase_events_add_only_event_record_nodes(dev, tmp_path, monkeypatch):
    """The captured graph of ``MultiStep(2)`` holds one event-record node a
    phase mark, 4 a step (start, losses, backward, update), 8 in all; its
    other nodes are those of the graph captured without the phase events."""
    def nodes(tag):
        _, step, _ = _card_step(dev, 2, keep_graph=True)
        path = str(tmp_path / f"graph_{tag}.dot")
        step.dump_graph(path)
        with open(path) as f:
            text = f.read()
        return len(re.findall(r'^"graph_\d+_node_\d+"\[', text, re.M)), text.count("EVENT_RECORD")

    phased, records = nodes("phases")
    monkeypatch.setattr(trace, "StepPhases", lambda: trace.NO_PHASES)
    plain, none = nodes("plain")
    assert records == 8 and none == 0
    assert phased - records == plain
