"""The port's ``run_slam`` on a 2-rank gloo mesh (kf=2, CPU) against the
JAX package's one-device ``run_slam``.

``test_runner.py::test_run_slam_mesh_matches_single_device``'s world and
``SLAMConfig`` (a 768-Gaussian room at 40x56, 7 orbit frames, 8x8 tiles,
Gauss-Newton tracking, keyframes and mapping every 2 frames, windows of 2,
pose-graph refinement at the end): the ranks run the loop on the mesh
(keyframe-sharded mapping, the edge-sharded pose-graph solver) while the
test process runs the JAX package's loop on one device.  Held at that
test's tolerances: every pose within 5e-3 and the ATE within 2e-3 m;
and every rank ends with the same poses, keyframes and map, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.io.replica import ate_rmse
from diff_gaussian_rasterization_tpu.io.synthetic import (
    orbit_trajectory, random_room_model, render_sequence)
from diff_gaussian_rasterization_tpu.models import runner as jrunner
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import start

import torch_dist_cases as cases

H, W = 40, 56
TRACK = dict(iters=6, sil_threshold=0.5)
MAP = dict(iters=8)
LOOP = dict(capacity=4096, keyframe_every=2, map_every=2, window=2,
            seed_every_px=2, init_iters=20, motion_model=False,
            pose_graph_refine=True)


@pytest.fixture(scope="module")
def world():
    cam_t = JaxCamera(viewmatrix=jnp.eye(4), tanfovx=0.7, tanfovy=0.55,
                      height=H, width=W)
    cfg = JaxConfig(tile_h=8, tile_w=8, chunk=16, instance_multiplier=12)
    gt_model = random_room_model(capacity=768, n=768, seed=0)
    views = orbit_trajectory(7)
    frames = render_sequence(gt_model, views, cam_t, cfg)
    np_views = [np.asarray(v) for v in views]
    np_frames = [(np.asarray(f.rgb), np.asarray(f.depth)) for f in frames]
    np_cam = dict(view=np.eye(4, dtype=np.float32), tanfovx=0.7,
                  tanfovy=0.55, height=H, width=W)
    # the ranks run while this process runs the JAX package's loop
    ranks = start(cases.slam_cases, 2,
                  (np_views, np_frames, np_cam, dataclasses.asdict(cfg), LOOP,
                   TRACK, MAP, (2, 1), ("kf", "tile")),
                  backend="gloo", device_type="cpu", timeout=600,
                  threads=1)
    scfg = jrunner.SLAMConfig(raster=cfg,
                              tracking=jslam.TrackingConfig(**TRACK),
                              mapping=jslam.MappingConfig(**MAP), **LOOP)
    state, gt_views = jrunner.run_slam(list(zip(np_views, frames)), scfg,
                                       cam_t)
    return dict(ranks=ranks.join(), jax=state, gt=gt_views)


def test_ranks_bit_identical(world):
    r0, r1 = world["ranks"]
    np.testing.assert_array_equal(r0["est_views"], r1["est_views"])
    np.testing.assert_array_equal(r0["kf_idx"], r1["kf_idx"])
    for k in r0["model"]:
        np.testing.assert_array_equal(r0["model"][k], r1["model"][k],
                                      err_msg=k)


def test_run_slam_on_mesh_matches_jax_one_device(world):
    got = world["ranks"][0]["est_views"]
    want = world["jax"].est_views
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            a, np.asarray(b), atol=5e-3,
            err_msg=f"frame {i} pose diverged between mesh and one device")
    np.testing.assert_array_equal(world["ranks"][0]["kf_idx"],
                                  np.asarray(world["jax"].kf_idx))
    gt = [jnp.asarray(v) for v in world["gt"]]
    ate_mesh = ate_rmse([jnp.asarray(v) for v in got], gt)
    ate_one = ate_rmse(want, gt)
    assert abs(ate_mesh - ate_one) < 2e-3, (ate_mesh, ate_one)
