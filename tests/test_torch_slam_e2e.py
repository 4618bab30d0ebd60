"""The port's whole SLAM loop on the CPU.

``run_slam`` on ``test_runner.py``'s 9-frame orbit (its world and
``SLAMConfig``: 40x56, a 768-Gaussian room, exact Gauss-Newton tracking,
keyframes every 2 frames, windows of 2) must beat the no-tracking
trajectory by the JAX test's own bound, ATE < 0.6 x static; and the port's
``examples/bench_ate.py`` (the record configuration's flags, cut to 8
frames at 48x64, a wall resolution of 16 and a capacity of 4096) must land
below half the no-tracking ATE, ``test_io.py``'s criterion, and below its
16 cm.  The frames are the port's own renders (``io.synthetic``).
"""

import json

import numpy as np
import torch

from diff_gaussian_rasterization_tpu_torch.camera import Camera
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.io.replica import ate_rmse
from diff_gaussian_rasterization_tpu_torch.io.synthetic import (
    orbit_trajectory, random_room_model, render_sequence)
from diff_gaussian_rasterization_tpu_torch.models.runner import (
    SLAMConfig, run_slam)
from diff_gaussian_rasterization_tpu_torch.models.slam import (
    MappingConfig, TrackingConfig)

torch.set_num_threads(2)


def test_run_slam_tracks_orbit():
    h, w = 40, 56
    cam = Camera(viewmatrix=torch.eye(4), tanfovx=0.7, tanfovy=0.55,
                 height=h, width=w)
    cfg = RasterConfig(tile_h=8, tile_w=8, chunk=16, instance_multiplier=12)
    gt_model = random_room_model(capacity=768, n=768, seed=0, device="cpu")
    views = orbit_trajectory(9, device="cpu")
    frames = render_sequence(gt_model, views, cam, cfg)
    scfg = SLAMConfig(
        raster=cfg, tracking=TrackingConfig(iters=10, sil_threshold=0.5),
        mapping=MappingConfig(iters=15), capacity=4096, keyframe_every=2,
        map_every=2, window=2, seed_every_px=2, init_iters=60,
        motion_model=False)
    data = list(zip(views.numpy(), frames))
    state, gt_views = run_slam(data, scfg, cam)
    assert len(state.est_views) == len(gt_views) == 9
    assert all(bool(torch.isfinite(v).all()) for v in state.est_views)
    ate = ate_rmse(state.est_views, gt_views)
    ate_static = ate_rmse([gt_views[0]] * len(gt_views), gt_views)
    assert ate < 0.6 * ate_static, (ate, ate_static)
    assert int(state.model.num_active) > 0
    assert state.kf_idx == [0, 2, 4, 6, 8]


def test_bench_ate_cpu(capsys):
    from diff_gaussian_rasterization_tpu_torch.examples import bench_ate
    bench_ate.main(["--cpu", "--frames", "8", "--res", "48x64",
                    "--wall-res", "16", "--capacity", "4096",
                    "--kf-every", "2", "--map-iters", "10"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "ate_rmse_cm" and rec["device"] == "cpu"
    assert rec["frames"] == 8 and rec["res"] == "64x48"
    assert np.isfinite(rec["value"]) and np.isfinite(rec["ate_aligned_cm"])
    assert rec["value"] < 0.5 * rec["ate_no_tracking_cm"], rec
    assert rec["value"] < 16.0, rec
    assert rec["map_active"] > 0 and rec["keyframes"] == 4
