"""The port's own tracing (``gsjax_torch.utils.profiling``'s registry):
spans, counters and the layer clock inside the train dispatch and the
frame, and the benchmark's readers of them (``gsbench/metrics``).

Imports neither JAX nor gsjax nor the shared conftest helpers, so it runs
where only the port is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_tracing.py

Tests marked ``cuda`` skip (inside the test) without a CUDA device.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from gsjax_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_SEGMENTS = ["prep", "composite_fwd", "loss", "composite_bwd", "reduce", "prep_bwd",
                  "adam", "stats"]
VIEW_SEGMENTS = ["copy_in", "prep", "composite_infer", "finish"]


class _Logged(profiling.Registry):
    """A registry that also lists the marks made while a call is open."""

    def __init__(self):
        super().__init__()
        self.marked = []

    def mark(self, segment):
        if self.clock is not None:
            self.marked.append(segment)
        super().mark(segment)


@pytest.fixture
def reg(monkeypatch):
    r = _Logged()
    monkeypatch.setattr(profiling, "REGISTRY", r)
    return r


def _scene(dev, n=400, capacity=512, w=64, h=48, max_pairs=1 << 14, max_tiles=16):
    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.ops import RasterizeSettings
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig

    torch.manual_seed(0)
    state = toy_state(n, capacity, device=dev)
    cams = stack_render_cameras([bench_camera(w, h, yaw, (0.02 * yaw, 0.0, 0.0))
                                 for yaw in (0.0, 0.01, -0.01)], dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)).to(dev)
    cfg = TrainConfig(settings=RasterizeSettings(
        max_pairs=max_pairs, max_tiles_per_gauss=max_tiles, expansion="compact",
        backend="kernel"),
        extent=3.0)
    tx = make_optimizer(OptimizationParams(), 3.0)
    return state, tx.init(state.params), tx, cams, images, cfg


# ---- spans and counters ----------------------------------------------------


def test_spans_nest_with_serials_and_parents():
    r = profiling.Registry()
    with r.span("outside"):
        pass
    with r.call("dispatch", "train", 2) as c:
        c.take("eager")
        with r.span("dispatch.prepare"):
            with r.span("inner"):
                pass
    with r.call("frame", "view", 1):
        with r.span("frame.bind"):
            pass
    ring = [(e["serial"], e["name"], e["parent"]) for e in r.records()["ring"]]
    assert ring == [(0, "outside", None), (1, "inner", "dispatch.prepare"),
                    (1, "dispatch.prepare", "dispatch"), (1, "dispatch", None),
                    (2, "frame.bind", "frame"), (2, "frame", None)]
    rec = r.records()["untraced"]
    assert rec["counters"] == {"train.eager": 2}
    assert rec["spans"]["dispatch"]["count"] == 1 and rec["spans"]["dispatch"]["seconds"] > 0


def test_traced_and_untraced_totals_are_kept_apart():
    from torch.profiler import ProfilerActivity, profile

    r = profiling.Registry()
    with r.span("a"):
        r.count("n", 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with r.span("a"):
            r.count("n")
        with r.span("a"):
            pass
    rec = r.records()
    assert rec["untraced"]["spans"]["a"]["count"] == 1
    assert rec["traced"]["spans"]["a"]["count"] == 2
    assert rec["untraced"]["counters"] == {"n": 3} and rec["traced"]["counters"] == {"n": 1}
    # a traced span sits on the profiler's timeline; an untraced one costs no event
    names = [e.key for e in prof.key_averages()]
    assert profiling.SPAN_PREFIX + "a" in names
    assert [e["traced"] for e in rec["ring"]] == [False, True, True]


def test_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    r = profiling.Registry()
    for i in range(10):
        with r.span(f"s{i}"):
            pass
    assert [e["name"] for e in r.records()["ring"]] == ["s6", "s7", "s8", "s9"]
    assert len(r.records()["untraced"]["spans"]) == 10


# ---- the layer clock ---------------------------------------------------------


def test_eager_chained_dispatch_marks_the_train_segments_in_order(reg):
    from gsjax_torch.train.step import make_train_step_chained

    torch.set_num_threads(2)
    state, opt, tx, cams, images, cfg = _scene("cpu")
    chained = make_train_step_chained(tx, cams, images, cfg, 3)
    chained(state, opt, [0, 1, 2])
    assert reg.marked == ([None] + TRAIN_SEGMENTS) * 3
    rec = reg.records()["untraced"]
    eager = rec["layers"]["train"]["eager"]
    assert eager["items"] == 3 and eager["calls"] == 1 and eager["unread"] == 0
    assert list(eager["seconds"]) == TRAIN_SEGMENTS
    assert all(v > 0 for v in eager["seconds"].values())
    assert reg.layer_ms("train") == {"eager": eager["ms"]}
    assert rec["counters"] == {"train.eager": 3}
    assert {"dispatch", "dispatch.prepare", "dispatch.eager"} <= set(rec["spans"])


def test_eager_frame_marks_the_view_segments(reg):
    from gsjax_torch.data.cameras import index_render_camera
    from gsjax_torch.train.step import make_render_fn

    torch.set_num_threads(2)
    state, _, _, cams, _, cfg = _scene("cpu")
    render_fn = make_render_fn(cfg, with_stats=True, as_uint8=True)
    img, dropped = render_fn(state, index_render_camera(cams, torch.tensor(0)),
                             torch.zeros(3))
    assert img.dtype == torch.uint8 and int(dropped) == 0
    # the copy (none on the eager path), then the frame from its own start
    assert reg.marked == [None, "copy_in", None] + VIEW_SEGMENTS[1:]
    eager = reg.records()["untraced"]["layers"]["view"]["eager"]
    assert list(eager["seconds"]) == VIEW_SEGMENTS and eager["items"] == 1
    assert reg.layer_ms("view") == {"eager": eager["ms"]}


def test_layer_functions_called_directly_record_nothing(reg):
    """``gsbench/stages.py`` calls the layers one by one, outside any
    dispatch or frame: the marks inside them do nothing."""
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.cuda_composite import (
        composite, composite_bwd, composite_fwd, pack_gauss_attrs, reduce_pair_grads,
    )
    from gsjax_torch.ops.projection import num_tiles, preprocess
    from gsjax_torch.data.cameras import index_render_camera
    from gsjax_torch.ops.rasterize import render
    from gsjax_torch.train.step import _activated_from, render_state

    state, _, _, cams, _, cfg = _scene("cpu")
    cam = index_render_camera(cams, torch.tensor(0))
    tx, ty = num_tiles(cam.width, cam.height)
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    sp = preprocess(*_activated_from(params), cam, state.active_sh_degree,
                    active_mask=state.active)
    bins = build_tile_bins(sp, tx, ty, 1 << 14, max_tiles_per_gauss=16, expansion="compact")
    blend = (sp.means2d, sp.conics, sp.colors, sp.opacities)
    attrs = pack_gauss_attrs(*(t.detach() for t in blend))
    tc, tT, ncon = composite_fwd(bins.tile_start, bins.pair_gauss, attrs, tx, ty)
    pg = composite_bwd(bins.tile_start, bins.pair_gauss, attrs, torch.ones_like(tc),
                       torch.zeros_like(tT), tT, ncon, tx, ty)
    reduce_pair_grads(pg, bins.pair_gauss, bins.tile_start, attrs.shape[0])
    colors, _ = composite(*blend, bins.tile_start, bins.pair_gauss, tx, ty)
    colors.sum().backward()  # CompositeFunction's backward and composite_grads
    render_state(state, cam, torch.zeros(3), cfg.settings)
    render(cam, *_activated_from(params), state.active_sh_degree, torch.zeros(3),
           cfg.settings, active_mask=state.active)
    assert reg.marked == [] and reg.clock is None
    assert reg.records()["untraced"]["layers"] == {}


class _FakeEvent:
    """A CUDA event's clock, for the graph path on the CPU: ``t`` ms, and
    whether the card has passed it."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done


class _FakeDriver:
    """The CUDA driver's event calls on :class:`_FakeEvent`s."""

    @staticmethod
    def passed(e):
        return e.done

    @staticmethod
    def elapsed_s(a, b):
        return (b.t - a.t) * 1e-3


def test_graph_calls_are_read_once_the_card_has_passed_them(monkeypatch):
    """The graph path's bookkeeping, with the capture's event-record nodes
    replaced by fake events and the host's clock by a fake one: a call is
    read at a later call once its last event has completed, a call whose
    graph replays again first is unread, and the idle share is the device
    segments against the host intervals of calls that were read (the
    time before a segment's start is not busy)."""
    ticks = iter(range(0, 10**12, 10_000_000))  # each host reading 10 ms later
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    monkeypatch.setattr(profiling, "_current_stream", lambda: None)
    monkeypatch.setattr(profiling, "_driver", _FakeDriver)
    r = profiling.Registry()
    marks = [(None, _FakeEvent(0.0)), ("prep", _FakeEvent(2.0)), ("loss", _FakeEvent(5.0)),
             (None, _FakeEvent(5.5)), ("prep", _FakeEvent(6.5)), ("loss", _FakeEvent(8.5))]

    def dispatch():
        with r.call("dispatch", "train", 2) as c:
            c.take("graph")
            r.replaying(marks, [])

    dispatch()
    assert r.pending and r.layers[False] == {}  # nothing read yet
    dispatch()  # reads the first
    layers = r.records()["untraced"]["layers"]["train"]["graph"]
    assert layers["calls"] == 2 and layers["items"] == 4
    # (2 + 1) ms and (3 + 2) ms a call, over its 2 steps
    assert layers["ms"] == {"prep": 1.5, "loss": 2.5}
    # the first call's interval (host readings 10 ms apart: 3 in the call,
    # so 30 ms to the next call's start) is known; the second's is not
    assert layers["device_s"] == pytest.approx(8e-3) and layers["interval_s"] == pytest.approx(
        0.03)
    assert layers["idle"] == pytest.approx(100 * (1 - 8 / 30))

    marks[-1][1].done = False  # the card has not passed the third replay ...
    dispatch()
    assert r.records()["untraced"]["layers"]["train"]["graph"]["calls"] == 2
    dispatch()  # ... and its graph replays again: it is unread
    assert r.records()["untraced"]["layers"]["train"]["graph"]["unread"] == 1
    monkeypatch.setattr(profiling, "profiler_on", lambda: True)
    dispatch()  # a traced call counts apart, and ends no untraced interval
    rec = r.records()
    assert rec["traced"]["counters"] == {"train.graph": 2}
    assert rec["untraced"]["counters"] == {"train.graph": 8}
    # the intervals of the first two calls: the third was unread, and the
    # fourth's ended in a traced call
    assert rec["untraced"]["layers"]["train"]["graph"]["interval_s"] == pytest.approx(0.06)


def test_a_nested_call_spoils_both_clocks():
    r = profiling.Registry()
    with r.call("dispatch", "train", 1) as outer:
        outer.take("eager")
        r.mark(None)
        with r.call("frame", "view", 1) as inner:
            inner.take("eager")
            r.mark(None)
            r.mark("prep")
        r.mark("prep")
    rec = r.records()["untraced"]["layers"]
    assert rec["train"]["eager"]["unread"] == 1 and rec["train"]["eager"]["calls"] == 0
    assert rec["view"]["eager"]["unread"] == 1


# ---- the benchmark's readers ---------------------------------------------------

READERS = {
    "graph_prep_ms.train": ("train", 1.5), "graph_loss_ms": ("train", 4.0),
    "graph_reduce_ms": ("train", 0.5), "graph_prep_bwd_ms": ("train", 2.5),
    "graph_adam_ms": ("train", 1.0), "graph_stats_ms": ("train", 0.25),
    "host_prepare_ms.train": ("train", 1e3 * (0.02 + 0.01 + 0.005) / 70),
    # the mean replay (the first launch apart) and outputs a call, over 20 steps a call
    "host_launch_ms.train": ("train", 1e3 * (0.004 / 2 + 0.002 / 3) / 20),
    "graph_idle.train": ("train", 2.0),
    "graph_copy_in_ms.view": ("view", 0.2), "graph_prep_ms.view": ("view", 7.0),
    "graph_finish_ms.view": ("view", 0.1),
    "host_prepare_ms.view": ("view", 1e3 * (0.003 + 0.006) / 30),
    "host_launch_ms.view": ("view", 1e3 * (0.002 / 2 + 0.001 / 3) / (20 / 3)),
    "graph_idle.view": ("view", 10.0),
}


def _planted() -> dict:
    """Records as a registry writes them: untraced totals that the readers
    read, and traced ones they must not."""
    untraced = {
        "spans": {"dispatch.prepare": {"count": 2, "seconds": 0.02},
                  "dispatch.bind": {"count": 2, "seconds": 0.01},
                  "dispatch.copy_in": {"count": 2, "seconds": 0.005},
                  "graph.first_replay": {"count": 1, "seconds": 0.9},
                  "graph.replay": {"count": 2, "seconds": 0.004},
                  "graph.outputs": {"count": 3, "seconds": 0.002},
                  "frame.bind": {"count": 30, "seconds": 0.003},
                  "frame.copy_in": {"count": 30, "seconds": 0.006}},
        "counters": {"train.graph": 60, "train.capture": 10, "view.graph": 20,
                     "view.capture": 1, "view.eager": 9},
        "layers": {
            "train": {"graph": {"ms": {"prep": 1.5, "loss": 4.0, "reduce": 0.5,
                                       "prep_bwd": 2.5, "adam": 1.0, "stats": 0.25},
                                "idle": 2.0},
                      "capture": {"ms": {"prep": 99.0}, "idle": 99.0}},
            "view": {"graph": {"ms": {"copy_in": 0.2, "prep": 7.0, "finish": 0.1},
                               "idle": 10.0}},
        },
    }
    traced = {"spans": {k: {"count": 1, "seconds": 9.0} for k in untraced["spans"]},
              "counters": {k: 1 for k in untraced["counters"]},
              "layers": {"train": {"graph": {"ms": {}, "idle": 77.0}}}}
    return {"untraced": untraced, "traced": traced, "ring": []}


def _reader(name):
    path = os.path.join(ROOT, "gsbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(READERS))
def test_metric_reader_reads_the_untraced_registry(monkeypatch, name):
    kind, want = READERS[name]
    planted = _planted()
    if name == "host_launch_ms.view":  # a process of frames: their replays
        planted["untraced"]["spans"]["graph.replay"]["seconds"] = 0.002
        planted["untraced"]["spans"]["graph.outputs"]["seconds"] = 0.001
    monkeypatch.setattr(profiling, "records", lambda: planted)
    read = _reader(name)
    assert read({"kind": kind}) == pytest.approx(want)
    assert read({"kind": {"train": "view", "view": "train"}[kind]}) is None
    # an empty registry, and a program without one, read nothing
    monkeypatch.setattr(profiling, "records", profiling.Registry().records)
    assert read({"kind": kind}) is None
    monkeypatch.setitem(sys.modules, "gsjax_torch.utils.profiling",
                        types.ModuleType("gsjax_torch.utils.profiling"))
    assert read({"kind": kind}) is None


def test_every_new_reader_has_its_benchmark_entry():
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name, (kind, _) in READERS.items():
        m = entries[name]
        assert m["moves"] == {"train": "train_step_ms", "view": "frame_ms"}[kind]
        assert m["workloads"] == [f"bench1080.{kind}", f"garden3m.{kind}"] + (
            ["room1m5.train"] if kind == "train" else [])
        assert m["source"] == ("host_clock" if name.startswith("host_") else "device_trace")


# ---- on the card -----------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_dispatch_segments_sum_to_its_event_time(reg):
    """A replayed chained dispatch's eight segments a step, read from the
    event-record nodes of its graph, sum to within 3% of the dispatch's
    device time timed by CUDA events around it (the host's half hidden
    behind a sleep on the card)."""
    from gsjax_torch.train.step import make_train_step_chained

    dev = _cuda()
    n = 4
    state, opt, tx, cams, images, cfg = _scene(dev, 50_000, 65_536, 640, 360, 1 << 21, 64)
    chained = make_train_step_chained(tx, cams, images, cfg, n)
    chained(state, opt, [0, 1, 2, 0])  # warm-up and capture
    g = next(iter(chained.graphs.entries.values()))[1][3]
    assert [s for s, _ in g.marks] == ([None] + TRAIN_SEGMENTS) * n
    chained(state, opt, [0, 1, 2, 0])  # the first launch, which also uploads the graph
    torch.cuda.synchronize()
    before = reg.records()["untraced"]["layers"]["train"]["graph"]["seconds"]
    totals = []
    for i in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # the host's half runs while the card sleeps
        a.record()
        chained(state, opt, [i % 3, 2, 1, 0])
        b.record()
        torch.cuda.synchronize()
        totals.append(a.elapsed_time(b))
    graph = reg.records()["untraced"]["layers"]["train"]["graph"]
    assert graph["calls"] == 4 and graph["items"] == 4 * n and graph["unread"] == 0
    assert list(graph["seconds"]) == TRAIN_SEGMENTS
    timed = {k: graph["seconds"][k] - before[k] for k in TRAIN_SEGMENTS}
    assert all(v > 0 for v in timed.values())
    assert 1e3 * sum(timed.values()) == pytest.approx(sum(totals), rel=0.03)
    assert sum(graph["ms"].values()) * n * 4 == pytest.approx(1e3 * sum(graph["seconds"].values()))


@pytest.mark.cuda
def test_driver_events_time_as_torch_events_do():
    """The clock's own events, created and recorded on the current stream
    through the CUDA driver, and torch's events recorded beside them: the
    driver reads torch's as ``Event.elapsed_time`` does, its own span the
    same work, and neither is passed before the card gets there."""
    dev = _cuda()
    d = profiling._driver()
    a, b = d.create(), d.create()
    ta, tb = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    d.record(a, profiling._current_stream())
    ta.record()
    torch.cuda._sleep(50_000_000)
    tb.record()
    d.record(b, profiling._current_stream())
    assert not d.passed(b) and not tb.query()
    torch.cuda.synchronize(dev)
    assert d.passed(b)
    assert d.elapsed_s(ta.cuda_event, tb.cuda_event) == 1e-3 * ta.elapsed_time(tb) > 0
    assert d.elapsed_s(a, b) == pytest.approx(1e-3 * ta.elapsed_time(tb), rel=0.05)
    d.destroy(a)
    d.destroy(b)


@pytest.mark.cuda
def test_replayed_frame_segments_are_read(reg):
    from gsjax_torch.data.cameras import index_render_camera
    from gsjax_torch.train.step import make_render_fn
    from test_torch_cuda import _graph_fixture

    dev = _cuda()
    state, _, _, cams, _, cfg = _graph_fixture(dev)
    render_fn = make_render_fn(cfg, with_stats=True, as_uint8=True)
    bg = torch.zeros(3, device=dev)
    for i in range(4):
        img, _ = render_fn(state, index_render_camera(cams, torch.tensor(i % 3, device=dev)),
                           bg)
        img.cpu()
    g = next(iter(render_fn.graphs.entries.values()))[1][3]
    assert [s for s, _ in g.marks] == [None] + VIEW_SEGMENTS[1:]  # the copy is outside
    rec = reg.records()["untraced"]
    graph = rec["layers"]["view"]["graph"]
    assert graph["calls"] == 3 and list(graph["seconds"]) == VIEW_SEGMENTS
    assert all(v > 0 for v in graph["seconds"].values())
    assert 0 <= graph["idle"] < 100
    assert rec["counters"] == {"view.capture": 1, "view.graph": 3}
    # the frame's kernels ran at the capture's warm-up and at each replay
    assert reg.records()["launches"] == {"composite_infer": 4, "preprocess_infer": 4}
    assert len(reg.free) == 2  # each frame's two copy-in events, reused by the next
    assert rec["spans"]["graph.first_replay"]["count"] == 1
    assert rec["spans"]["graph.replay"]["count"] == 2


@pytest.mark.cuda
def test_a_dropped_graph_is_still_read(reg):
    """A frame read after its render function, and so its graph, is gone:
    the pending call keeps the graph's events alive until it is read."""
    import gc

    from gsjax_torch.data.cameras import index_render_camera
    from gsjax_torch.train.step import make_render_fn
    from test_torch_cuda import _graph_fixture

    dev = _cuda()
    state, _, _, cams, _, cfg = _graph_fixture(dev)
    render_fn = make_render_fn(cfg, with_stats=True, as_uint8=True)
    cam = index_render_camera(cams, torch.tensor(0, device=dev))
    for _ in range(3):
        img, _ = render_fn(state, cam, torch.zeros(3, device=dev))
        img.cpu()  # the card passes each frame before the next, as a viewer's client waits
    assert len(reg.pending) == 1
    del render_fn
    gc.collect()
    torch.cuda.synchronize()
    graph = reg.records()["untraced"]["layers"]["view"]["graph"]
    assert graph["calls"] == 2 and graph["unread"] == 0 and not reg.pending
    assert all(v > 0 for v in graph["seconds"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_graph_with_the_clock_equals_eager(reg, grad_dtype):
    """The clock's event-record nodes change nothing a replay computes:
    the graphed chained dispatch, its marks in the graph, equals the eager
    one bit for bit."""
    from gsjax_torch.train.step import make_train_step_chained
    from gsjax_torch.train.step import snapshot_differences as _differing
    from test_torch_cuda import _graph_fixture, _run_both

    dev = _cuda()
    state, opt, tx, cams, images, cfg = _graph_fixture(dev, grad_dtype)
    chained = [make_train_step_chained(tx, cams, images, cfg, 3, eager=e) for e in (False, True)]
    (gm, gs), (em, es) = _run_both(state, opt, *chained,
                                   [([0, 2, 1],), ([1, 1, 0],), ([2, 0, 1],)])
    g = next(iter(chained[0].graphs.entries.values()))[1][3]
    assert len(g.marks) == 3 * (1 + len(TRAIN_SEGMENTS))
    assert _differing(gs, es) == []
    assert all(torch.equal(a[k], b[k]) for a, b in zip(gm, em) for k in a)
    assert reg.records()["untraced"]["layers"]["train"]["graph"]["calls"] >= 1
