"""The port's meshed mapping on a 4-rank gloo world (CPU).

``test_sharding.py::test_kf_x_map_composed_mapping_step_matches_single_
device``'s world (a 512-Gaussian room at 40x56, 8x8 tiles, a corrupted
copy mapped for 3 steps over 3 keyframes with ``uncertainty_prune``
0.05), one spawn for the file: every rank runs ``mapping_round`` on one
rank and on three meshes of its 4 ranks, keyframe-sharded (kf=4: the
window padded to 4 with a weight-0 copy), map-sharded (map=4, 128 rows a
shard's budget, as there) and both composed (kf=2 x map=2, 256).  Held
here, as ``test_sharding.py`` holds the JAX package:

- the losses within 1e-5 and the models within rtol 1e-4 / atol 1e-5 of
  the one-rank round, and the uncertainty-prune ``active`` masks bit-equal
  (some Gaussians pruned);
- the one-rank round against the JAX package's one-device round: the
  masks and the densification counts bit-equal, the loss within rtol
  1e-4 and the fields within ``test_torch_densify.py``'s Adam-step
  tolerance (rtol 1e-5, atol 3 lr / 10 + 1e-6);
- every rank ends with the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.io.synthetic import (
    orbit_trajectory, random_room_model, render_sequence)
from diff_gaussian_rasterization_tpu.models.gaussians import (
    DensifyState as JaxDensifyState)
from diff_gaussian_rasterization_tpu.models.slam import (
    MappingConfig as JaxMappingConfig, make_map_optimizer, mapping_round,
    model_params)
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import spawn

import torch_dist_cases as cases

N = 4
H, W = 40, 56
MESHES = [((4, 1), ("kf", "map"), None, 0),
          ((1, 4), ("kf", "map"), "map", 512 // 4),
          ((2, 2), ("kf", "map"), "map", 512 // 2)]
MCFG = dict(iters=3, uncertainty_prune=0.05)


@pytest.fixture(scope="module")
def world():
    cam_t = JaxCamera(viewmatrix=jnp.eye(4), tanfovx=0.7, tanfovy=0.55,
                      height=H, width=W)
    cfg = JaxConfig(tile_h=8, tile_w=8, chunk=16, instance_multiplier=12)
    gt_model = random_room_model(capacity=512, n=512, seed=0)
    views = orbit_trajectory(4)
    frames = render_sequence(gt_model, views, cam_t, cfg)
    rng = np.random.RandomState(3)
    start = gt_model.replace(
        sh=gt_model.sh + jnp.asarray(
            rng.normal(scale=0.15, size=gt_model.sh.shape), jnp.float32),
        opacities_logit=gt_model.opacities_logit - 0.5)
    kf = (jnp.stack([views[0], views[2], views[3]]),
          jnp.stack([frames[i].rgb for i in (0, 2, 3)]),
          jnp.stack([frames[i].depth for i in (0, 2, 3)]))
    np_start = {k: np.asarray(getattr(start, k))
                for k in PARAM_FIELDS + ("active",)}
    np_cam = dict(view=np.eye(4, dtype=np.float32), tanfovx=0.7,
                  tanfovy=0.55, height=H, width=W)
    ranks = spawn(cases.mapping_cases, N,
                  (np_start, tuple(np.asarray(x) for x in kf), np_cam,
                   dataclasses.asdict(cfg), MCFG, MESHES),
                  backend="gloo", device_type="cpu", timeout=400,
                  threads=1)

    mcfg = JaxMappingConfig(**MCFG)
    jm, _, jd, jl = mapping_round(
        start, make_map_optimizer(mcfg).init(model_params(start)),
        JaxDensifyState.zero(start.capacity), kf, cfg, mcfg, cam_t,
        jax.random.PRNGKey(0))
    return dict(ranks=ranks, start=np_start, jax=(jm, jd, float(jl)))


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def test_ranks_bit_identical(world):
    for r in world["ranks"][1:]:
        assert_tree_equal(world["ranks"][0], r)


@pytest.mark.parametrize("key", [cases.mesh_key(s, n) for s, n, _, _ in
                                 MESHES])
def test_meshed_round_matches_one_rank(world, key):
    one, got = world["ranks"][0]["one"], world["ranks"][0][key]
    assert abs(float(got["loss"]) - float(one["loss"])) < 1e-5
    assert int(one["model"]["active"].sum()) < int(
        world["start"]["active"].sum()), "the threshold pruned nothing"
    np.testing.assert_array_equal(got["model"]["active"],
                                  one["model"]["active"])
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(got["model"][f], one["model"][f],
                                   rtol=1e-4, atol=1e-5, err_msg=f)


def test_one_rank_round_matches_jax(world):
    one = world["ranks"][0]["one"]
    jm, jd, jl = world["jax"]
    np.testing.assert_allclose(float(one["loss"]), jl, rtol=1e-4)
    np.testing.assert_array_equal(one["model"]["active"],
                                  np.asarray(jm.active))
    np.testing.assert_array_equal(one["denom"], np.asarray(jd.denom))
    mcfg = JaxMappingConfig(**MCFG)
    lrs = dict(means3D=mcfg.lr_means, scales_log=mcfg.lr_scales,
               rotations=mcfg.lr_rotations,
               opacities_logit=mcfg.lr_opacities, sh=mcfg.lr_sh)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(one["model"][f], np.asarray(getattr(jm, f)),
                                   rtol=1e-5, atol=3 * lrs[f] / 10 + 1e-6,
                                   err_msg=f)
