"""The port's IO against the JAX package's, on the CPU: the synthetic
scenes and trajectories, ``render_sequence``, the Replica and TUM readers
on ``tests/fixtures/``, the ATE metrics, and the checkpoint round trip.

Tolerances: the synthetic models are bit-equal in every field but
``scales_log``, which is within one float32 ulp (XLA:CPU's float32 ``log``
is not correctly rounded; the port's is); each trajectory entry within one
float32 ulp of the largest entry of its column (XLA:CPU fuses
multiply-adds in ``look_at``, the port's ``camera.look_at`` on the CPU
does not: an entry near zero may differ in many of its own ulps);
``render_sequence``'s frames at ``test_torch_rasterize.py``'s render
tolerance (atol 1e-5, rtol 1e-5), the geometric depth (depth over
silhouette) at rtol 1e-4 where both packages keep it; the readers' poses
and frames bit-equal; the ATE metrics at rtol 1e-6 (the same numpy on
float32 poses, whose products numpy's BLAS may round differently).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.io import replica as jreplica
from diff_gaussian_rasterization_tpu.io import synthetic as jsyn
from diff_gaussian_rasterization_tpu.io import tum as jtum
from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu_torch.camera import Camera
from diff_gaussian_rasterization_tpu_torch.io import replica, synthetic, tum
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS)
from diff_gaussian_rasterization_tpu_torch.utils import checkpoint

from test_torch_rasterize import port_config

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPLICA = os.path.join(FIXTURES, "replica_mini", "office0")
TUM = os.path.join(FIXTURES, "tum_mini")
TUM_KW = dict(height=60, width=80, fx=57.0, fy=54.0, cx=39.5, cy=29.5)

MODELS = {
    "random_room": dict(capacity=768, n=768, seed=0),
    "random_room_clutter": dict(capacity=300, n=256, seed=3, extent=1.5),
    "replica_like": dict(seed=0, wall_res=16, n_boxes=2),
    "replica_like_record": dict(seed=0, wall_res=56),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_synthetic_model_matches_jax(name):
    make = "random_room_model" if name.startswith("random") \
        else "replica_like_model"
    a = getattr(jsyn, make)(**MODELS[name])
    b = getattr(synthetic, make)(device="cpu", **MODELS[name])
    assert b.capacity == a.capacity
    assert int(b.num_active) == int(a.num_active)
    for f in PARAM_FIELDS + ("active",):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).detach().numpy()
        if f == "scales_log":
            np.testing.assert_array_max_ulp(y, x, maxulp=1)
        else:
            np.testing.assert_array_equal(y, x, err_msg=f)


TRAJECTORIES = {
    "orbit_9": ("orbit_trajectory", (9,), {}),
    "orbit_4": ("orbit_trajectory", (4,), dict(radius=0.5, height=0.2)),
    "walkthrough_record": ("walkthrough_trajectory", (120,), dict(seed=1)),
    "walkthrough_loop": ("walkthrough_trajectory", (60,),
                         dict(seed=1, close_loop=True)),
    "walkthrough_no_pans": ("walkthrough_trajectory", (48,),
                            dict(seed=2, rot_heavy=False,
                                 extent=(2.0, 1.5, 2.5))),
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_trajectory_matches_jax(name):
    fn, args, kw = TRAJECTORIES[name]
    a = np.asarray(getattr(jsyn, fn)(*args, **kw))
    b = getattr(synthetic, fn)(*args, device="cpu", **kw)
    assert b.dtype == torch.float32
    ulp = np.spacing(np.abs(a).max(axis=1, keepdims=True))
    assert (np.abs(b.numpy() - a) <= ulp).all()


@pytest.mark.parametrize("noise", [(0.0, 0.0), (0.01, 0.005)])
def test_render_sequence_matches_jax(noise):
    from diff_gaussian_rasterization_tpu.config import RasterConfig
    h, w = 24, 32
    cfg = RasterConfig(tile_h=8, tile_w=16, chunk=32, instance_multiplier=10)
    cam_j = JaxCamera(viewmatrix=jnp.eye(4), tanfovx=0.82, tanfovy=0.62,
                      height=h, width=w)
    cam_t = Camera(viewmatrix=torch.eye(4), tanfovx=0.82, tanfovy=0.62,
                   height=h, width=w)
    kw = dict(rgb_noise=noise[0], depth_noise=noise[1], seed=3)
    jm = jsyn.replica_like_model(seed=0, wall_res=16, n_boxes=2)
    jv = jsyn.walkthrough_trajectory(3, seed=1)
    a = jsyn.render_sequence(jm, jv, cam_j, cfg, **kw)
    tm = synthetic.replica_like_model(seed=0, wall_res=16, n_boxes=2,
                                      device="cpu")
    tv = synthetic.walkthrough_trajectory(3, seed=1, device="cpu")
    b = synthetic.render_sequence(tm, tv, cam_t, port_config(cfg), **kw)
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        ra, da = np.asarray(fa.rgb), np.asarray(fa.depth)
        rb, db = fb.rgb.numpy(), fb.depth.numpy()
        assert rb.shape == (3, h, w) and db.shape == (h, w)
        np.testing.assert_allclose(rb, ra, atol=1e-5, rtol=1e-5)
        both = (da > 0) & (db > 0)
        # the silhouette > 0.5 cut may flip on a pixel at the threshold
        assert np.mean((da > 0) != (db > 0)) < 5e-3
        assert both.mean() > 0.5
        np.testing.assert_allclose(db[both], da[both], rtol=1e-4)


def test_replica_reader_matches_jax():
    a = jreplica.ReplicaDataset(REPLICA)
    b = replica.ReplicaDataset(REPLICA, device="cpu")
    assert len(a) == len(b) == 5
    assert (b.height, b.width, b.fx, b.fy, b.depth_scale) == (
        a.height, a.width, a.fx, a.fy, a.depth_scale)
    ca, cb = a.camera_template(), b.camera_template()
    assert (cb.tanfovx, cb.tanfovy, cb.height, cb.width) == (
        ca.tanfovx, ca.tanfovy, ca.height, ca.width)
    assert cb.viewmatrix.device.type == "cpu"
    for (pa, fa), (pb, fb) in zip(a, b):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(fb.rgb.numpy(), np.asarray(fa.rgb))
        np.testing.assert_array_equal(fb.depth.numpy(),
                                      np.asarray(fa.depth))
        assert fb.rgb.dtype == torch.float32
    assert b.frame(0).depth.shape == (60, 80)


def test_tum_reader_matches_jax():
    a = jtum.TUMDataset(TUM, **TUM_KW)
    b = tum.TUMDataset(TUM, device="cpu", **TUM_KW)
    assert len(a) == len(b) == 5
    assert [i[:2] for i in b.items] == [i[:2] for i in a.items]
    for (pa, fa), (pb, fb) in zip(a, b):
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(fb.rgb.numpy(), np.asarray(fa.rgb))
        np.testing.assert_array_equal(fb.depth.numpy(),
                                      np.asarray(fa.depth))
    ca, cb = a.camera_template(), b.camera_template()
    assert (cb.tanfovx, cb.tanfovy) == (ca.tanfovx, ca.tanfovy)
    # the two fixtures hold one trajectory
    rds = replica.ReplicaDataset(REPLICA, device="cpu")
    for i in range(5):
        np.testing.assert_allclose(b.pose(i), rds.pose(i), atol=2e-5)


def test_ate_matches_jax():
    rng = np.random.RandomState(0)
    gt = [np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(scale=0.3,
                                                         size=6)))).T
          for _ in range(7)]
    est = [np.asarray(jlie.apply_twist(jnp.asarray(v), jnp.asarray(
        rng.normal(scale=0.02, size=6)))) for v in gt]
    est_t = [torch.as_tensor(v.copy()) for v in est]
    for fa, fb in ((jreplica.ate_rmse, replica.ate_rmse),
                   (jreplica.ate_rmse_aligned, replica.ate_rmse_aligned)):
        want = fa([jnp.asarray(v) for v in est], [jnp.asarray(v)
                                                  for v in gt])
        np.testing.assert_allclose(fb(est_t, gt), want, rtol=1e-6)
        np.testing.assert_allclose(fb(est, gt), want, rtol=1e-6)
        assert want > 0
    assert replica.ate_rmse(gt, gt) == 0.0
    assert replica.ate_rmse_aligned(gt, gt) < 1e-7


def test_checkpoint_roundtrip(tmp_path):
    """``test_io.py::test_checkpoint_roundtrip`` for the port."""
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        GaussianModel)
    p = 32
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    model = GaussianModel(t(rng.normal(size=(p, 3))), torch.zeros(p, 3),
                          t(rng.normal(size=(p, 4))), torch.zeros(p, 1),
                          t(rng.normal(size=(p, 1, 3))),
                          torch.arange(p) % 3 != 0)
    views = [torch.eye(4) for _ in range(3)]
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, model, est_views=views, step=7)
    restored, payload = checkpoint.restore(path, device="cpu")
    for f in PARAM_FIELDS + ("active",):
        assert torch.equal(getattr(restored, f), getattr(model, f)), f
    assert payload["step"] == 7
    assert payload["est_views"].shape == (3, 4, 4)
    assert "kf_views" not in payload
