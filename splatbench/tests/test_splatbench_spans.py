"""The readers of the program's own counters (``spans.py`` and the
metrics that read it) on a planted snapshot, and without the records."""

from __future__ import annotations

import sys
import types

import pytest

from splatbench import cells, spans, trace

UNITS = 4
SPANS = {"render": dict(calls=16, host_s=0.2, host_self_s=0.1,
                        stream_s=None, stream_self_s=None)}
COUNTERS = {"render.filled": 300, "render.slots": 400, "map.active": 90,
            "map.gaussians": 120}
# the metric, what it reads a unit of UNITS
WANT = {
    "instance_fill.track": 75.0,
    "instance_fill.slam": 75.0,
    "active_share.slam": 75.0,
}


def ctx():
    prof = trace.Profile(units=UNITS, window_s=1.0, busy_s=0.5, kernels={},
                         launches={}, gaps=[])
    return dict(prof=prof, units=10, window_s=20.0, host_s=2.0)


def plant(monkeypatch, snap):
    mod = types.ModuleType(spans.MODULE)
    if snap is not None:
        mod.snapshot = lambda: snap
    monkeypatch.setitem(sys.modules, spans.MODULE, mod)


def test_every_program_metric_has_a_case(root):
    bench = cells.benchmark(root)
    named = {m["name"] for m in bench["per_layer"]
             if hasattr(cells.metric_reader(m["name"]), "spans")}
    assert named == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_planted_records(name, monkeypatch):
    plant(monkeypatch, dict(spans=SPANS, counters=COUNTERS))
    got = cells.metric_reader(name).read(ctx())
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_records_gives_none(name, monkeypatch):
    reader = cells.metric_reader(name)
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    assert reader.read(ctx()) is None
    plant(monkeypatch, None)            # a program module without records
    assert reader.read(ctx()) is None
    plant(monkeypatch, dict(spans={}, counters={}))     # nothing recorded
    assert reader.read(ctx()) is None
    plant(monkeypatch, dict(spans=SPANS, counters=COUNTERS))
    assert reader.read(dict(ctx(), prof=None)) is None  # no traced stretch


def test_share_of_counters(monkeypatch):
    plant(monkeypatch, dict(spans=SPANS, counters=COUNTERS))
    assert spans.share(ctx(), "map.active", "render.slots") == 22.5
    assert spans.share(ctx(), "map.active", "no.such") is None
    assert spans.share(ctx(), "no.such", "render.slots") is None
    plant(monkeypatch, dict(spans=SPANS, counters=dict(COUNTERS,
                                                       **{"render.slots": 0})))
    assert spans.instance_fill(ctx()) is None
