"""The trace and metric arithmetic on synthetic event lists."""

from __future__ import annotations

import json

import pytest

from splatbench import readers, trace, work


def test_union_of_overlapping_intervals():
    assert trace.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.union_s([]) == 0.0


def test_idle_gaps_are_named_by_the_innermost_host_op():
    device = [(0, 10), (20, 30), (50, 60)]
    host = [(0, 60, "splatbench.step"), (10, 20, "aten::mm"),
            (35, 45, "aten::add"), (36, 44, "aten::copy_")]
    gaps = dict(trace.idle_gaps(device, host, 0, 70))
    assert gaps == pytest.approx({"aten::mm": 10e-6, "aten::copy_": 20e-6,
                                  "python": 10e-6})


def test_chrome_trace_is_read(tmp_path):
    ev = [dict(ph="X", cat="user_annotation", name="splatbench.map_step",
               ts=0, dur=100),
          dict(ph="X", cat="cpu_op", name="aten::mm", ts=5, dur=40),
          dict(ph="X", cat="kernel", name="void render_fwd_kernel<4>()",
               ts=10, dur=20),
          dict(ph="X", cat="kernel", name="gemv", ts=25, dur=10),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=60,
               dur=10),
          dict(ph="i", cat="kernel", name="marker", ts=1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    prof = trace.read_chrome(str(path), units=2, window_s=1e-4)
    assert prof.busy_s == pytest.approx(35e-6)
    assert prof.launches == {"void render_fwd_kernel<4>()": 1, "gemv": 1}
    assert trace.kernel_s(prof, r"render_fwd_kernel") == pytest.approx(
        10e-6)
    assert trace.launches(prof) == 1.0
    assert sum(s for _, s in prof.gaps) == pytest.approx(65e-6)


def test_percentile_rate_and_shares():
    ctx = dict(units=50, window_s=10.0,
               latencies=[i / 1000 for i in range(1, 101)])
    assert readers.rate(ctx) == 5.0
    assert readers.p95_ms(ctx) == pytest.approx(95.0)
    assert readers.p95_ms(dict(latencies=[])) is None
    prof = trace.Profile(units=4, window_s=1.0, busy_s=4e-3,
                         kernels={"render_fwd_kernel": 2e-3}, launches={},
                         gaps=[])
    ctx = dict(prof=prof, host_s=4e-3,
               work=work.Work(dict(render_fwd=work.Piece(0.0, 3.35e6))))
    assert readers.busy_ms(ctx) == pytest.approx(1.0)
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    # 1 us of bytes against 0.5 ms of kernel a unit
    assert readers.roofline(ctx, "render_fwd", "render_fwd") == \
        pytest.approx(0.2)
    assert readers.roofline(ctx, "render_bwd", "render_bwd") is None
    assert readers.step_roofline(ctx) == pytest.approx(0.1)
