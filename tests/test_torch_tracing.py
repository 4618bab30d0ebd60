"""The program's spans and counters (``utils/profiling.py``) on the CPU.

With tracing off a span is one shared null context: ``rasterize``,
``map_step`` and ``track_frame`` open no ``record_function`` and record
nothing.  Inside ``recording()`` a ``map_step`` of K keyframes records K
renders (each with its preprocess, binning and core) under one backward
and one Adam step, the render core's backward as a child of the
backward, self times within inclusive ones; the counters equal what the
program's outputs give when read directly, and counting keeps none of
the program's tensors alive.  Under ``torch.profiler`` the
exported Chrome trace holds the ``dgr.*`` ranges nested as the records
say.  The file imports no JAX, so its card test also runs alone::

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import dataclasses
import gc
import json
import time
import weakref

import pytest
import torch

from diff_gaussian_rasterization_tpu_torch import scenes
from diff_gaussian_rasterization_tpu_torch.models import slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    DensifyState)
from diff_gaussian_rasterization_tpu_torch.utils import profiling

torch.set_num_threads(2)

H, W = 48, 64


def world(p=3000, device="cpu"):
    """The tracking benchmark's frame at a small size, a third of its
    slots inactive, and the deferred-accept Gauss-Newton at one level."""
    ts = scenes.tracking_frame(p=p, height=H, width=W, device=device)
    ts.model.active[::3] = False
    return ts._replace(tcfg=dataclasses.replace(ts.tcfg, pyramid=1,
                                                iters=6))


def render(ts, max_instances=None):
    return slam.render_model(ts.model, ts.camera, ts.cfg,
                             max_instances=max_instances)


def track(ts):
    return slam.track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg,
                            ts.camera)


def map_steps(ts, k=2, steps=1):
    """``steps`` map steps over ``k`` keyframes around the frame's view;
    the last step's loss."""
    dev = ts.frame.rgb.device
    views = torch.stack([scenes.orbit_view(a, device=dev) for a in range(k)])
    rgbs = ts.frame.rgb[None].expand(k, -1, -1, -1).contiguous()
    depths = ts.frame.depth[None].expand(k, -1, -1).contiguous()
    mcfg = slam.MappingConfig()
    opt = slam.make_map_optimizer(ts.model, mcfg)
    dstate = DensifyState.zero(ts.model.capacity, device=dev)
    wts = torch.ones(k, device=dev)
    for _ in range(steps):
        loss, dstate, _ = slam.map_step(
            ts.model, opt, dstate, views, rgbs, depths, wts, ts.cfg, mcfg,
            H, W, ts.camera.tanfovx, ts.camera.tanfovy, k)
    return loss


CALLS = {"rasterize": render, "map_step": map_steps, "track_frame": track}


@pytest.fixture
def ts():
    profiling.reset()
    yield world()
    profiling.reset()


@pytest.mark.parametrize("call", list(CALLS))
def test_tracing_off_records_nothing(call, ts, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range was opened with tracing off: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b") is profiling.NULL
    CALLS[call](ts)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def check_times(spans):
    for name, s in spans.items():
        assert s["calls"] > 0
        assert 0 <= s["host_self_s"] <= s["host_s"] + 1e-9, name
        # the CPU has no stream: not measured, never the host's time
        assert s["stream_s"] is None and s["stream_self_s"] is None, name
        assert sum(s["parents"].values()) <= s["calls"]


@pytest.mark.parametrize("k", [1, 3])
def test_map_step_spans(k, ts):
    with profiling.recording():
        map_steps(ts, k)
    spans = profiling.snapshot()["spans"]
    calls = {n: s["calls"] for n, s in spans.items()}
    assert calls == {"map.step": 1, "map.render": k, "render": k,
                     "render.preprocess": k, "render.binning": k,
                     "render.core_fwd": k, "render.assemble": k,
                     "map.backward": 1, "render.core_bwd": k,
                     "map.adam": 1}
    parents = {n: s["parents"] for n, s in spans.items()}
    assert parents["render.core_bwd"] == {"map.backward": k}
    assert parents["render"] == {"map.render": k}
    assert parents["render.preprocess"] == {"render": k}
    assert parents["map.backward"] == parents["map.adam"] == {"map.step": 1}
    assert parents["map.step"] == {}
    check_times(spans)


def test_track_frame_spans(ts):
    with profiling.recording():
        track(ts)
    spans = profiling.snapshot()["spans"]
    iters = ts.tcfg.iters
    assert {n: s["calls"] for n, s in spans.items()} == {
        "track.frame": 1, "track.level": 1, "track.bin": 1,
        "render.preprocess": 1 + iters, "render.binning": 1,
        "track.gn_eval": iters, "render.jvp": iters,
        "render.tangents": iters, "render.core_jvp": iters,
        "render.assemble": iters}
    assert spans["render.preprocess"]["parents"] == {"track.bin": 1,
                                                     "render.jvp": iters}
    assert spans["render.jvp"]["parents"] == {"track.gn_eval": iters}
    check_times(spans)


@pytest.mark.parametrize("budget", [None, 2048])
def test_render_counters(budget, ts):
    with profiling.recording():
        out = render(ts, max_instances=budget)
    c = profiling.snapshot()["counters"]
    slots = budget or ts.cfg.max_instances
    n = int(out.num_rendered)
    assert c == {"render.gaussians": ts.model.capacity,
                 "render.instances": n, "render.filled": min(n, slots),
                 "render.slots": slots,
                 "render.overflows": int(bool(out.overflow))}
    assert bool(out.overflow) == (budget is not None)


def test_counters_keep_no_program_tensor(ts):
    """A counted device value is read, never held: the render's instance
    count (a view of binning's prefix sum, which it would keep alive) is
    freed with the render's outputs while recording goes on."""
    with profiling.recording():
        out = render(ts)
        held = weakref.ref(out.num_rendered)
        n = int(out.num_rendered)
        del out
        gc.collect()
        assert held() is None
    assert profiling.snapshot()["counters"]["render.instances"] == n


@pytest.mark.parametrize("k", [1, 3])
def test_map_step_counters(k, ts):
    with profiling.recording():
        map_steps(ts, k)
    c = profiling.snapshot()["counters"]
    assert c["map.active"] == k * int(ts.model.active.sum())
    assert c["map.gaussians"] == c["render.gaussians"] == \
        k * ts.model.capacity
    assert c["render.slots"] == k * ts.cfg.max_instances


def test_track_frame_counters(ts):
    with profiling.recording():
        _, _, costs = track(ts)
    c = profiling.snapshot()["counters"]
    # deferred accept: a trial is accepted when its cost is below the last
    # accepted one, which is the lowest cost before it
    low, accepts = float("inf"), 0
    for x in costs.tolist():
        accepts += x < low
        low = min(low, x)
    assert c["track.gn_trials"] == ts.tcfg.iters == len(costs)
    assert c["track.gn_accepts"] == accepts
    assert c["track.active"] == int(ts.model.active.sum())


def test_track_frame_counts_the_tangents_slots(ts):
    """A tracked frame preprocesses its slots in the frozen binning, in
    each evaluation's render and in each evaluation's tangents (the
    composite's forward mode): ``render.gaussians`` counts all three; the
    kernel's ``render.prep_kernel`` is counted on the card only."""
    with profiling.recording():
        track(ts)
    c = profiling.snapshot()["counters"]
    assert c["render.gaussians"] == (1 + 2 * ts.tcfg.iters) * \
        ts.model.capacity
    assert "render.prep_kernel" not in c


@pytest.mark.parametrize("done", [True, False])
def test_stream_records_fold_and_reuse_events(done, ts, monkeypatch):
    """Stand-in CUDA events on the host clock: closed spans fold in
    batches once the device has passed them (``done``), so the live
    events stay bounded and are reused, and otherwise wait for the
    snapshot; the stream times come out the same either way."""
    class Event:
        made = 0

        def __init__(self, enable_timing):
            Event.made += 1

        def record(self):
            self.t = time.perf_counter()

        def query(self):
            return done

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profiling, "_free", [])
    n = 3 * profiling.FOLD
    with profiling.recording():
        for i in range(n):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass
            assert len(profiling._pending) == (
                (2 * i + 2) % profiling.FOLD if done else 2 * i + 2)
    spans = profiling.snapshot()["spans"]
    assert not profiling._pending
    assert Event.made == (2 * profiling.FOLD if done else 4 * n)
    outer, inner = spans["outer"], spans["inner"]
    assert outer["calls"] == inner["calls"] == n
    assert 0 < inner["stream_s"] <= outer["stream_s"]
    assert outer["stream_self_s"] == pytest.approx(
        outer["stream_s"] - inner["stream_s"])
    assert inner["stream_self_s"] == inner["stream_s"]


def innermost(events):
    """(name, enclosing name) of each event, by containment in time; the
    enclosing one is the latest to start, the shortest among equals."""
    out = []
    for e in events:
        outer = [o for o in events if o is not e and o["tid"] == e["tid"]
                 and o["ts"] <= e["ts"]
                 and o["ts"] + o["dur"] >= e["ts"] + e["dur"]
                 and (o["ts"], -o["dur"]) != (e["ts"], -e["dur"])]
        best = max(outer, key=lambda o: (o["ts"], -o["dur"]), default=None)
        out.append((e["name"], best and best["name"]))
    return out


@pytest.mark.parametrize("call", ["map_step", "track_frame"])
def test_chrome_trace_nesting(call, ts, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        CALLS[call](ts)
    spans = profiling.snapshot()["spans"]
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("name", "").startswith(profiling.PREFIX)]
    pre = len(profiling.PREFIX)
    got = {}
    for name, parent in innermost(events):
        key = (name[pre:], parent and parent[pre:])
        got[key] = got.get(key, 0) + 1
    want = {}
    for name, s in spans.items():
        for parent, n in s["parents"].items():
            want[(name, parent)] = n
        top = s["calls"] - sum(s["parents"].values())
        if top:
            want[(name, None)] = top
    assert got == want


@pytest.mark.cuda
def test_stream_times_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stream times are the card's")
    profiling.reset()
    monkeypatch.setattr(profiling, "FOLD", 16)   # fold while recording
    ts = world(device="cuda")
    map_steps(ts)           # warm-up, tracing off
    with profiling.recording():
        map_steps(ts, steps=2)
        track(ts)
    spans = profiling.snapshot()["spans"]
    profiling.reset()
    assert spans["render.core_bwd"]["parents"] == {"map.backward": 4}
    for name, s in spans.items():
        # self = inclusive less the children's: a negative self time would
        # be children outlasting their parent on the stream
        assert s["stream_s"] > 0, name
        assert -1e-6 <= s["stream_self_s"] <= s["stream_s"], name
    step = spans["map.step"]
    assert sum(spans[n]["stream_s"] for n in ("map.render", "map.backward",
                                              "map.adam")) \
        <= step["stream_s"] - step["stream_self_s"] + 1e-6


@pytest.mark.cuda
def test_recording_keeps_device_memory_flat(monkeypatch):
    """Renders recorded on the card leave the device memory where it was:
    the counted values go to pinned pages (small ones here, so that they
    fill, land and are reused), and the counters equal the outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pages hold device values")
    profiling.reset()
    monkeypatch.setattr(profiling, "PAGE", 8)
    ts = world(device="cuda")
    n = over = 0
    with profiling.recording():
        for i in range(60):
            out = render(ts, max_instances=2048 if i % 2 else None)
            n += int(out.num_rendered)
            over += int(out.overflow)
            del out
            if i == 9:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        pages = len(profiling._landing) + sum(
            len(v) for v in profiling._spare.values())
        c = profiling.snapshot()["counters"]
    profiling.reset()
    assert after == before
    assert c["render.instances"] == n and c["render.overflows"] == over
    assert over == 30
    # 120 instance values fill 15 pages of 8: each page is read and reused
    assert pages <= 4


@pytest.mark.cuda
def test_prep_kernel_counter_on_the_card():
    """On the card the kernel pair preprocesses every slot of a map step's
    renders (``render.prep_kernel`` = ``render.gaussians``), and fewer than
    a tracked frame counts, whose tangents run the composite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only there")
    profiling.reset()
    ts = world(device="cuda")
    with profiling.recording():
        map_steps(ts, k=2)
    c = profiling.snapshot()["counters"]
    profiling.reset()
    assert c["render.prep_kernel"] == c["render.gaussians"] == \
        2 * ts.model.capacity
    with profiling.recording():
        track(ts)
    c = profiling.snapshot()["counters"]
    profiling.reset()
    iters = ts.tcfg.iters
    assert c["render.prep_kernel"] == (1 + iters) * ts.model.capacity
    assert c["render.gaussians"] == (1 + 2 * iters) * ts.model.capacity
