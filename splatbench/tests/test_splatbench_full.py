"""The two tracking cells of the Full-variant configuration's PR at the
small size on the CPU: ``replica-track-full`` (SH 3, both pose branches,
checked against ``reference_full.py``) and ``tum-track`` (the TUM camera's
tracker, checked against ``reference.py``).  Each builds, reads finite
numbers within its limits, and fails them under the control and under
each planted fault; the full cell stops a program whose dual render lacks
the colour branch; and ``tum-track``'s work counts its line search and
fresh binnings."""

from __future__ import annotations

import math

import pytest

from splatbench import (calibrate, calibrate_full, cells, entry,
                        faults_full, run)
from conftest import SMALL

SEED = 2**31 + 21


def run_small(root, name, planted=None):
    return run.run_cell(name, SEED, 4.0, 0, root, device="cpu",
                        faults=planted, overrides=SMALL)


@pytest.mark.parametrize("name", ["tum-track", "replica-track-full"])
def test_sound_run_is_correct(root, name):
    out = run_small(root, name)
    assert out["correct"], out["checks"]
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())
    assert out["metrics"]["tracked_frames_per_s"]["value"] > 0
    assert out["metrics"]["track_frame_ms_p95"]["value"] > 0


@pytest.mark.parametrize("name,fault", [
    ("replica-track-full", "no_colour"), ("replica-track-full", "no_sigma2d"),
    ("replica-track-full", "altered"), ("tum-track", "altered")])
def test_planted_fault_reads_above_its_limit(root, name, fault):
    """The branch faults read above the ``jvp_gap`` limit, the tracked
    pose moved 1 cm above the ``pose_gap`` limit."""
    key = "jvp_gap" if fault in faults_full.KINDS else "pose_gap"
    out = run_small(root, name, calibrate_full.planted(fault))
    assert not out["correct"], out["checks"]
    c = out["checks"][key]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("name", ["tum-track", "replica-track-full"])
def test_control_fails_the_limits(root, name):
    r = calibrate.readings_for(name, SEED + 1, 4.0, True, root,
                               device="cpu", overrides=SMALL)
    assert not run.check(r["control"], cells.limits(name))[0], r
    assert run.check(r["program"], cells.limits(name))[0], r


def test_a_program_without_the_colour_branch_stops_at_once(root,
                                                          monkeypatch):
    monkeypatch.delattr(entry.port()["rasterize"], "color_branch")
    with pytest.raises(RuntimeError, match="cannot run this configuration"):
        run.open_cell("replica-track-full", SEED, root, device="cpu",
                      overrides=SMALL)


def test_tum_work_counts_the_line_search_and_fresh_binnings(root):
    """Per level of n iterations: n dual renders, n + 1 forward renders
    (the trial steps and the level's last cost), 2n + 1 binnings and
    8n + 1 preprocesses, where the frozen-binning count has none of the
    forward renders and one binning."""
    _, _, _, made = run.open_cell("tum-track", SEED, root, device="cpu",
                                  overrides=SMALL)
    t = made.cfg["tracking"]
    assert t["line_search"] and not t["freeze_binning"]
    w, frozen = made.work(), made.__class__.__mro__[1].work(made)
    n = t["iters"] + t["coarse_iters"] * (t["pyramid"] - 1)
    levels = t["pyramid"]
    assert w.get("render_jvp") == frozen.get("render_jvp")
    assert w.get("render_fwd").ops > 0 and frozen.get("render_fwd").ops == 0
    prep = frozen.get("preprocess").ops / (7 * n + levels)
    assert w.get("preprocess").ops == pytest.approx(prep * (8 * n + levels))
    # a weighted mean of the levels' 2n + 1 binnings (their counts differ)
    per_level = [2 * t["coarse_iters"] + 1] * (levels - 1) + [
        2 * t["iters"] + 1]
    ratio = w.get("binning").nbytes / frozen.get("binning").nbytes
    assert min(per_level) <= ratio <= max(per_level)


def test_full_map_carries_sh3_and_its_work_counts_the_branches(root):
    _, _, _, made = run.open_cell("replica-track-full", SEED, root,
                                  device="cpu", overrides=SMALL)
    assert made.model.sh.shape[1] == 16
    assert made.model.raster_kwargs()["sh_degree"] == 3
    light = made.__class__.__mro__[1].work(made).get("render_jvp")
    full = made.work().get("render_jvp")
    assert full.ops > light.ops and full.nbytes > light.nbytes
    assert 0.0 < made.colour_share(1) < 1.0
