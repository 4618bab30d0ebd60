"""The traffic is the same for a seed and another for another seed; the
work it asks for is the same for every seed."""

from __future__ import annotations

import numpy as np
import torch

from splatbench import cells, scene


def test_room_is_deterministic_and_seeded():
    sc = dict(cells.config("replica-1200x680")["scene"], wall_res=10)
    a = scene.room(sc, 2**40 + 7, "cpu")
    b = scene.room(sc, 2**40 + 7, "cpu")
    c = scene.room(sc, 5, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["means3D"], c["means3D"])
    # the layout, and so the size, does not depend on the seed
    assert int(a["active"].sum()) == int(c["active"].sum()) \
        == scene.room_size(sc)


def test_walkthrough_depends_on_the_layout_only():
    a = scene.walkthrough(40, 11, (2.0, 1.5, 2.5))
    b = scene.walkthrough(40, 11, (2.0, 1.5, 2.5))
    assert np.array_equal(a, b)
    r = a[:, :3, :3]
    assert np.allclose(r @ r.transpose(0, 2, 1), np.eye(3), atol=1e-12)


def test_predicted_pose_is_exact_on_constant_motion():
    a = scene.look_at((0, 0, 0), (0, 0, 1))
    step = scene.look_at((0.01, 0, 0), (0.01, 0.02, 1)) @ np.linalg.inv(a)
    b = step @ a
    c = step @ b
    assert np.allclose(scene.predicted(a, b), c, atol=1e-12)


def test_map_schedule_is_seeded(small_entry):
    a = small_entry("replica-map", 123)
    b = small_entry("replica-map", 123)
    c = small_entry("replica-map", 124)
    assert np.array_equal(a.schedule, b.schedule)
    assert not np.array_equal(a.schedule, c.schedule)
    # every window: the newest keyframe and distinct others
    assert all(len(set(r)) == len(r) for r in a.schedule)
    assert torch.equal(a.rgbs, b.rgbs) and torch.equal(a.depths, b.depths)


def test_track_requests_are_seeded(small_entry):
    a = small_entry("replica-track", 9)
    b = small_entry("replica-track", 9)
    assert np.array_equal(a.order, b.order) and a.checked == b.checked
    assert torch.equal(a.view0, b.view0)
    assert sorted(a.order[:a.mix["pool"]]) == list(range(a.mix["pool"]))


def test_map_windows_are_balanced():
    balanced_windows = cells._module("entries", "map_step").balanced_windows
    a = balanced_windows(8, 4, 20, 3)
    b = balanced_windows(8, 4, 20, 4)
    assert a.shape == (20, 4)
    assert not np.array_equal(a, b)
    for w in (a, b):
        block = w[:8]
        assert all(len(set(r)) == 4 for r in block)
        # each keyframe: once the newest, three times one of the others
        assert sorted(block[:, 0]) == list(range(8))
        assert np.bincount(block[:, 1:].ravel(), minlength=8).tolist() \
            == [3] * 8
