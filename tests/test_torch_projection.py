"""The port's preprocess against the JAX package's, field by field.

Same scene arrays (``scenes.make_scene``, numpy seeds) through
``diff_gaussian_rasterization_tpu.ops.projection.preprocess`` and its
PyTorch port.  Integer fields (radius, tile rectangles, tiles touched) and
the mask must be exactly equal; float fields agree to float32 rounding
(the two frameworks contract the small matrix products in other orders).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.ops.projection import (
    compute_cov3d as jax_cov3d, preprocess as jax_preprocess)
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.convert import camera_from_numpy
from diff_gaussian_rasterization_tpu_torch.ops import sh as torch_sh
from diff_gaussian_rasterization_tpu_torch.ops.projection import preprocess

from scenes import make_scene

torch.set_num_threads(2)

TILES = [(8, 16), (8, 8)]
MODES = ["colors_precomp", "cov3D_precomp", "sh0", "sh1", "sh2", "sh3"]


def port_config(cfg: JaxConfig) -> RasterConfig:
    return RasterConfig(**dataclasses.asdict(cfg))


def port_camera(cam):
    return camera_from_numpy(np.asarray(cam.viewmatrix), cam.tanfovx,
                             cam.tanfovy, cam.height, cam.width, device="cpu",
                             znear=cam.znear, zfar=cam.zfar)


def to_torch(scene):
    return {k: torch.as_tensor(np.array(v)) if hasattr(v, "shape") else v
            for k, v in scene.items()}


def scene_for(mode, seed):
    deg = int(mode[2]) if mode.startswith("sh") else None
    scene, cam = make_scene(p=80, h=32, w=40, seed=seed, sh_degree=deg)
    kw = {k: v for k, v in scene.items() if k not in ("bg", "gt_depth")}
    if mode == "cov3D_precomp":
        kw["cov3D_precomp"] = jax_cov3d(kw.pop("scales"), kw.pop("rotations"),
                                        1.0)
    return kw, cam


def assert_prep_equal(a, b):
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), getattr(b, name).detach().numpy()
        assert x.shape == y.shape, name
        if x.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", MODES)
def test_preprocess_matches_jax(mode, tile):
    kw, cam = scene_for(mode, seed=3)
    cfg = JaxConfig(tile_h=tile[0], tile_w=tile[1])
    a = jax_preprocess(kw["means3D"], cam, cfg,
                       **{k: v for k, v in kw.items() if k != "means3D"})
    tkw = to_torch(kw)
    b = preprocess(tkw.pop("means3D"), port_camera(cam), port_config(cfg),
                   **tkw)
    assert_prep_equal(a, b)
    assert bool(b.mask.any())


@pytest.mark.parametrize("opacity_cull,margin", [(False, 0.0), (True, 2.5)])
def test_preprocess_footprint_options_match_jax(opacity_cull, margin):
    """The reference's 3-sigma rect (opacity_cull off) and the binning
    margin give the same integer footprints in both packages."""
    kw, cam = scene_for("colors_precomp", seed=5)
    cfg = JaxConfig(tile_h=8, tile_w=16, opacity_cull=opacity_cull,
                    bin_margin_px=margin)
    a = jax_preprocess(kw["means3D"], cam, cfg,
                       **{k: v for k, v in kw.items() if k != "means3D"})
    tkw = to_torch(kw)
    b = preprocess(tkw.pop("means3D"), port_camera(cam), port_config(cfg),
                   **tkw)
    assert_prep_equal(a, b)


def test_means2d_offset_and_pose_detached_depth():
    """``means2D`` shifts the centers as in the JAX package, and
    ``depth_sgview`` carries no gradient to the view matrix."""
    kw, cam = scene_for("colors_precomp", seed=7)
    off = np.random.RandomState(0).normal(scale=0.02, size=(80, 2))
    cfg = JaxConfig(tile_h=8, tile_w=8)
    a = jax_preprocess(kw["means3D"], cam, cfg, means2D=jnp.asarray(
        off, jnp.float32), **{k: v for k, v in kw.items() if k != "means3D"})
    tkw = to_torch(kw)
    tcam = port_camera(cam)
    view = tcam.viewmatrix.clone().requires_grad_(True)
    b = preprocess(tkw.pop("means3D"), tcam.replace(viewmatrix=view),
                   port_config(cfg),
                   means2D=torch.as_tensor(off, dtype=torch.float32), **tkw)
    assert_prep_equal(a, b)
    g_depth, = torch.autograd.grad(b.depth.sum(), view, retain_graph=True)
    assert float(g_depth.abs().sum()) > 0
    assert not b.depth_sgview.requires_grad


def test_sh_helpers_match_jax():
    from diff_gaussian_rasterization_tpu.ops import sh as jax_sh
    rng = np.random.RandomState(2)
    rgb = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        torch_sh.rgb_to_sh0(torch.as_tensor(rgb)).numpy(),
        np.asarray(jax_sh.rgb_to_sh0(jnp.asarray(rgb))), rtol=1e-6)
    assert [torch_sh.num_sh_coeffs(d) for d in range(4)] == [1, 4, 9, 16]


def test_camera_helpers_match_jax():
    """perspective_matrix, look_at, the projection product and the camera
    center, against the JAX package's camera."""
    from diff_gaussian_rasterization_tpu import camera as jax_camera
    from diff_gaussian_rasterization_tpu_torch import camera as port_cam
    np.testing.assert_allclose(
        port_cam.perspective_matrix(0.82, 0.47, device="cpu").numpy(),
        np.asarray(jax_camera.perspective_matrix(0.82, 0.47)), rtol=1e-6)
    eye, target = (0.3, -0.2, -1.0), (0.1, 0.4, 3.0)
    jv = jax_camera.look_at(eye, target)
    tv = port_cam.look_at(eye, target, device="cpu")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    jc = jax_camera.Camera(viewmatrix=jv, tanfovx=0.6, tanfovy=0.4,
                           height=30, width=40)
    tc = port_camera(jc)
    np.testing.assert_allclose(tc.projmatrix.numpy(),
                               np.asarray(jc.projmatrix), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.campos.numpy(), np.asarray(jc.campos),
                               rtol=1e-5, atol=1e-6)
    assert (tc.focal_x, tc.focal_y) == (jc.focal_x, jc.focal_y)


def test_mark_visible_matches_jax():
    from diff_gaussian_rasterization_tpu.ops.projection import (
        mark_visible as jax_mark_visible)
    from diff_gaussian_rasterization_tpu_torch.ops.projection import (
        mark_visible)
    kw, cam = scene_for("colors_precomp", seed=9)
    pts = np.asarray(kw["means3D"]) - np.array([0.0, 0.0, 2.0], np.float32)
    a = np.asarray(jax_mark_visible(jnp.asarray(pts), cam.viewmatrix))
    b = mark_visible(torch.as_tensor(pts), port_camera(cam).viewmatrix)
    np.testing.assert_array_equal(a, b.numpy())
    assert a.any() and not a.all()
