"""What the Full-variant configuration's PR added to ``BENCHMARK.json``,
and only that: one configuration, two one-chip cells, two per-layer
metrics, the two cells appended to the tracking metrics' lists and
``tum-track`` to ``render_jvp_roofline.track``'s; every bound,
``run_seconds`` and every other list as they were."""

from __future__ import annotations

import pytest

from splatbench import cells

NEW_CELLS = ["tum-track", "replica-track-full"]
APPENDED = ("tracked_frames_per_s", "track_frame_ms_p95",
            "track_device_ms.track", "device_idle_share.track",
            "instance_fill.track", "step_roofline.track")
BOUNDS = {"map_steps_per_s": 0.2, "tracked_frames_per_s": 0.25,
          "track_frame_ms_p95": 0.25, "slam_frames_per_s": 0.25,
          "setup_s": 0.25}


@pytest.fixture
def bench(root):
    return cells.benchmark(root)


def test_configs_and_cells(bench):
    assert [c["name"] for c in bench["configs"]] == [
        "replica-1200x680", "tum-640x480", "replica-full-sh3-1200x680"]
    new = bench["configs"][-1]
    assert new["reduced"] == ["scene"]
    assert cells.config(new["name"])["reduced"] == ["scene"]
    assert [w["name"] for w in bench["workloads"]] == [
        "replica-map", "tum-slam", "replica-track"] + NEW_CELLS
    got = {w["name"]: (w["config"], w["traffic"], w["chips"])
           for w in bench["workloads"][-2:]}
    assert got == {"tum-track": ("tum-640x480", "track-tum", 1),
                   "replica-track-full": ("replica-full-sh3-1200x680",
                                          "track-full", 1)}


def test_metrics(bench):
    assert bench["run_seconds"] == 51
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]} == BOUNDS
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-2:] == ["render_jvp_roofline.track_full",
                          "tangent_table_mb.track_full"]
    assert len(names) == 17
    for m in bench["per_layer"][-2:]:
        assert m["workloads"] == ["replica-track-full"]
        assert m["moves"] == "tracked_frames_per_s"
    for m in bench["end_to_end"] + bench["per_layer"][:-2]:
        if m["name"] in APPENDED:
            assert m["workloads"] == ["replica-track"] + NEW_CELLS
        elif m["name"] == "render_jvp_roofline.track":
            assert m["workloads"] == ["replica-track", "tum-track"]
        elif "workloads" in m:
            assert not set(m["workloads"]) & set(NEW_CELLS), m["name"]
