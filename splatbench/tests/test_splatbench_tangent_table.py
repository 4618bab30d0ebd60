"""``tangent_table_mb.track_full`` on a planted snapshot of the program's
counters, and without them (the cases ``test_splatbench_spans.py`` gives
the readers it lists)."""

from __future__ import annotations

import sys
import types

import pytest

from splatbench import cells, spans, trace

NAME = "tangent_table_mb.track_full"


def ctx(prof=True):
    p = trace.Profile(units=4, window_s=1.0, busy_s=0.5, kernels={},
                      launches={}, gaps=[]) if prof else None
    return dict(prof=p, units=10, window_s=20.0, host_s=2.0)


def plant(monkeypatch, snap):
    mod = types.ModuleType(spans.MODULE)
    if snap is not None:
        mod.snapshot = lambda: snap
    monkeypatch.setitem(sys.modules, spans.MODULE, mod)


def test_reads_the_planted_counter(monkeypatch):
    plant(monkeypatch, dict(spans={}, counters={
        "render.tangent_floats": 3_000_000}))
    # 3e6 floats x 4 bytes over 4 frames
    assert cells.metric_reader(NAME).read(ctx()) == pytest.approx(3.0)


@pytest.mark.parametrize("snap", [None, dict(spans={}, counters={}),
                                  dict(spans={}, counters={
                                      "render.slots": 400})])
def test_gives_none_without_the_counter(snap, monkeypatch):
    plant(monkeypatch, snap)
    assert cells.metric_reader(NAME).read(ctx()) is None


def test_gives_none_without_a_traced_stretch(monkeypatch):
    plant(monkeypatch, dict(spans={}, counters={
        "render.tangent_floats": 8}))
    assert cells.metric_reader(NAME).read(ctx(prof=False)) is None
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    assert cells.metric_reader(NAME).read(ctx()) is None
