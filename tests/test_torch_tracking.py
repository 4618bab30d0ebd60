"""The port's tracking against the JAX package's, on the CPU.

``TrackingConfig``'s fields and defaults, ``downsample_frame``, and
``track_frame`` on ``test_slam.py``'s world (the JAX package's
``io.synthetic`` room, rendered by the JAX package, carried across with
``convert.py``) from ``test_slam.py``'s perturbation, by each method: exact
Gauss-Newton with the default deferred accept and frozen binning, exact
Gauss-Newton with ``line_search`` and a 2-level pyramid, central
differences (``gn_fd``) and Adam, each for a few iterations.  The
per-iteration costs agree at rtol 1e-3 and the final view at atol 1e-4,
and the Gauss-Newton methods meet ``test_slam.py``'s recovery bounds
(rotation and translation error below 0.35 of the perturbation's; 0.5 with
the pyramid, as ``test_tracking_pyramid_recovers_pose`` holds it).  Adam
at its default rate moves the pose by ~lr per step; ``test_slam.py`` holds
it to no recovery bound, and neither does this file.  On a one-rank gloo
mesh, tracking against the gathered visible subset of a map-sharded model
gives the one-device result bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu_torch.convert import (
    camera_from_numpy, gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.models import slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh

from test_slam import CAM_T, CFG, make_world, pose_error
from test_torch_rasterize import port_config
from torch_dist_cases import one_rank_world

torch.set_num_threads(2)

XI = [0.02, -0.015, 0.01, 0.008, -0.01, 0.006]  # test_slam.py's


def test_tracking_config_matches_jax():
    a = [(f.name, f.default) for f in dataclasses.fields(
        jslam.TrackingConfig)]
    b = [(f.name, f.default) for f in dataclasses.fields(
        slam.TrackingConfig)]
    assert a == b


def test_downsample_frame_matches_jax():
    rng = np.random.RandomState(2)
    rgb = rng.uniform(0, 1, (3, 8, 12)).astype(np.float32)
    depth = np.where(rng.uniform(size=(8, 12)) < 0.4, 0.0,
                     rng.uniform(1, 4, (8, 12))).astype(np.float32)
    depth[:2, :2] = 0.0  # an all-invalid window
    for s in (2, 4):
        a = jslam.downsample_frame(jslam.Frame(jnp.asarray(rgb),
                                               jnp.asarray(depth)), s)
        b = slam.downsample_frame(slam.Frame(torch.as_tensor(rgb),
                                             torch.as_tensor(depth)), s)
        np.testing.assert_allclose(b.rgb.numpy(), np.asarray(a.rgb),
                                   rtol=1e-6)
        np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def world():
    model, views, frames = make_world()
    true_view = views[1]
    view0 = jlie.apply_twist(true_view, jnp.asarray(XI))
    port = gaussian_model_from_numpy(
        {f: np.asarray(getattr(model, f))
         for f in PARAM_FIELDS + ("active",)}, device="cpu")
    t = lambda x: torch.as_tensor(np.array(x))
    return dict(jax=(model, view0, frames[1]), true_view=true_view,
                port=(port, t(view0), slam.Frame(t(frames[1].rgb),
                                                 t(frames[1].depth))),
                cam=camera_from_numpy(np.asarray(CAM_T.viewmatrix),
                                      CAM_T.tanfovx, CAM_T.tanfovy,
                                      CAM_T.height, CAM_T.width,
                                      device="cpu"))


# (TrackingConfig, recovery bound)
CASES = {
    "gn_frozen_deferred": (dict(iters=12, sil_threshold=0.95,
                                freeze_binning=True, bin_margin_px=6.0), 0.35),
    "gn_line_search_pyramid": (dict(iters=10, sil_threshold=0.95,
                                    line_search=True, pyramid=2,
                                    coarse_iters=3), 0.5),
    "gn_fd": (dict(iters=3, method="gn_fd", sil_threshold=0.95), 0.35),
    "adam": (dict(iters=4, method="adam", sil_threshold=0.95), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_track_frame_matches_jax(world, case):
    kw, bound = CASES[case]
    jm, jview0, jframe = world["jax"]
    a_view, a_cost, a_costs = jslam.track_frame(
        jm, jview0, jframe, CFG, jslam.TrackingConfig(**kw), CAM_T)
    tm, tview0, tframe = world["port"]
    b_view, b_cost, b_costs = slam.track_frame(
        tm, tview0, tframe, port_config(CFG), slam.TrackingConfig(**kw),
        world["cam"])
    np.testing.assert_allclose(b_costs.numpy(), np.asarray(a_costs),
                               rtol=1e-3)
    np.testing.assert_allclose(float(b_cost), float(a_cost), rtol=1e-3)
    np.testing.assert_allclose(b_view.numpy(), np.asarray(a_view), atol=1e-4)
    if bound is not None:
        r0, t0 = pose_error(np.asarray(jview0), world["true_view"])
        r1, t1 = pose_error(b_view.numpy(), world["true_view"])
        assert r1 < bound * r0 and t1 < bound * t0, (r0, r1, t0, t1)


def test_track_frame_sharded_raises(world):
    """A mesh that is not a DeviceMesh raises; on a one-rank gloo mesh,
    tracking against the visible subset of a map-sharded model (gathered
    at the start pose) gives the one-device pose and costs bit for
    bit."""
    tm, tview0, tframe = world["port"]
    tcfg = slam.TrackingConfig(iters=2, sil_threshold=0.95)
    with pytest.raises(TypeError):
        slam.track_frame(tm, tview0, tframe, port_config(CFG), tcfg,
                         world["cam"], mesh=object())
    one = slam.track_frame(tm, tview0, tframe, port_config(CFG), tcfg,
                           world["cam"])
    with one_rank_world():
        mesh = make_mesh((1, 1), ("tile", "map"), backend="gloo",
                         device="cpu")
        meshed = slam.track_frame(tm, tview0, tframe, port_config(CFG),
                                  tcfg, world["cam"], mesh=mesh,
                                  map_axis="map")
    for a, b in zip(one, meshed):
        assert torch.equal(a, b)
