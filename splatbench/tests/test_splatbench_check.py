"""The check that decides ``correct``, at the small size on the CPU: a
sound run passes its limits; the control (the reference in TF32 put in
the program's place) and each fault a cell can have, planted under the
timed path of a whole run (the look for a card skipped), fail them."""

from __future__ import annotations

import pytest

from splatbench import calibrate, cells, entry, faults, run
from conftest import SMALL


def run_small(root, name, fault=None, seconds=1.5, only=None):
    planted = None if fault is None else faults.faults(
        fault, entry.port()["slam"], only)
    return run.run_cell(name, 2**31 + 11, seconds, 0, root, device="cpu",
                        faults=planted, overrides=SMALL)


@pytest.mark.parametrize("name", ["replica-map", "replica-track",
                                  "tum-slam"])
def test_sound_run_is_correct(root, name):
    out = run_small(root, name, seconds=4.0)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name,fault,only", [
    ("replica-map", "unchanged", None), ("replica-map", "half", None),
    ("replica-map", "altered", None), ("replica-track", "unchanged", None),
    ("replica-track", "altered", None), ("tum-slam", "unchanged", None),
    ("tum-slam", "half", None), ("tum-slam", "altered", None),
    ("tum-slam", "unchanged", "track_frame"),
    ("tum-slam", "altered", "track_frame")])
def test_planted_fault_is_not_correct(root, name, fault, only):
    out = run_small(root, name, fault, seconds=4.0, only=only)
    assert not out["correct"], out["checks"]
    if only == "track_frame":
        # the tracker alone, inside the loop: the pose check sees it
        pose = out["checks"]["pose_gap"]
        assert pose["value"] > pose["limit"], out["checks"]


@pytest.mark.parametrize("name", ["replica-map", "replica-track",
                                  "tum-slam"])
def test_control_fails_the_limits(root, name):
    r = calibrate.readings_for(name, 2**31 + 12, 4.0, True, root,
                               device="cpu", overrides=SMALL)
    correct, _, checks = run.check(r["control"], cells.limits(name))
    assert not correct, checks
    assert run.check(r["program"], cells.limits(name))[0]


@pytest.mark.cuda
def test_short_run_on_the_card(root, card):
    out = run.run_cell("replica-map", 2**31 + 13, 2.0, 0, root,
                       device=card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["map_steps_per_s"]["value"] > 0
