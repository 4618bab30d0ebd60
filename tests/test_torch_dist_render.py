"""The port's tile-sharded render on a 2-rank gloo world (CPU).

One spawn for the file (a module fixture): each rank renders
``test_sharding.py``'s scene (96 Gaussians, 32x40, 8x8 tiles) with
``rasterize`` unsharded, tile-sharded and with sharded binning, forward
and backward (the means and the view matrix), the per-shard overflow,
and the tile-sharded dual render (``rasterize_with_pose_jvp``, light).
Held here:

- the tile-sharded render, its gradients and the dual render are
  bit-equal to the unsharded port render, on every rank;
- sharded binning matches the unsharded render at ``test_sharding.py``'s
  tolerances (atol 1e-6 on the images, rtol 1e-5 / atol 1e-6 on the
  gradients; the per-Gaussian sums of splats spanning bands add in
  another order), with the instance count equal and no overflow;
- the port's renders, unsharded and shard-binned, match the JAX
  package's (unsharded, and shard-binned on its 8-device virtual mesh,
  ``xla`` backend): images at ``test_sharding.py``'s atol 1e-6, the
  uncertainty sums and the gradients at the port-vs-JAX tolerances of
  ``test_torch_rasterize.py`` (atol 1e-5, rtol 1e-4) and
  ``test_torch_grad.py`` (rtol 5e-4, atol 2e-5): the two packages' sums
  differ that much on one device already;
- a per-shard budget below the deepest band's count raises ``overflow``,
  and the band counts match the JAX package's ``band_instance_counts``;
- the full variant's dual render refuses a mesh (``ValueError``);
- every rank returns the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.ops.projection import (
    preprocess as jax_preprocess)
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    rasterize as jax_rasterize)
from diff_gaussian_rasterization_tpu.parallel.mesh import make_mesh as jmesh
from diff_gaussian_rasterization_tpu.parallel.shard_bin import (
    band_instance_counts as jax_band_counts)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import spawn

import torch_dist_cases as cases
from scenes import make_scene
from test_torch_rasterize import CFG

N = 2


def jax_render(scene, cam, mesh, sb):
    kw = {k: v for k, v in scene.items() if k != "means3D"}

    def loss(means, view):
        cam2 = JaxCamera(viewmatrix=view, tanfovx=cam.tanfovx,
                         tanfovy=cam.tanfovy, height=cam.height,
                         width=cam.width)
        out = jax_rasterize(means, cam2, CFG, backend="xla", tile_batch=4,
                            mesh=mesh, shard_binning=sb, **kw)
        return (jnp.sum(out.color) + 0.3 * jnp.sum(out.depth)
                + 0.1 * jnp.sum(out.depth_median)
                + 0.1 * jnp.sum(out.opacity_map)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(
        scene["means3D"], cam.viewmatrix)
    return out, grads


@pytest.fixture(scope="module")
def world():
    scene, cam = make_scene(p=96, h=32, w=40, seed=0)
    np_scene = {k: np.asarray(v) for k, v in scene.items()}
    np_cam = dict(view=np.asarray(cam.viewmatrix), tanfovx=cam.tanfovx,
                  tanfovy=cam.tanfovy, height=cam.height, width=cam.width)
    ranks = spawn(cases.render_cases, N,
                  (np_scene, np_cam, dataclasses.asdict(CFG)),
                  backend="gloo", device_type="cpu", timeout=240,
                  threads=1)
    jm = jmesh(shape=(1, len(jax.devices())), axis_names=("kf", "tile"))
    return dict(ranks=ranks, scene=scene, cam=cam,
                jax_one=jax_render(scene, cam, None, False),
                jax_sb=jax_render(scene, cam, jm, True))


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def test_ranks_bit_identical(world):
    r0 = world["ranks"][0]
    for r in world["ranks"][1:]:
        assert_tree_equal(r0, r)


def test_tile_sharded_render_bit_equal(world):
    r = world["ranks"][0]
    assert_tree_equal(r["one"], r["tile"])
    assert float(np.abs(r["one"]["g_means"]).max()) > 0
    assert float(np.abs(r["one"]["g_view"]).max()) > 0


def test_shard_binned_matches_unsharded(world):
    a, b = world["ranks"][0]["one"], world["ranks"][0]["sb"]
    for k in ("color", "depth", "depth_median", "opacity_map"):
        np.testing.assert_allclose(b["out"][k], a["out"][k], atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(b["out"]["gau_uncertainty"],
                               a["out"]["gau_uncertainty"], atol=1e-5)
    for k in ("gau_related_pixels", "n_contrib", "n_valid", "radii",
              "num_rendered"):
        np.testing.assert_array_equal(b["out"][k], a["out"][k], err_msg=k)
    assert not bool(b["out"]["overflow"])
    for k in ("g_means", "g_view"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_sharded_renders_match_jax(world):
    r = world["ranks"][0]
    for name, (jout, jgrads) in (("one", world["jax_one"]),
                                 ("sb", world["jax_sb"])):
        out = r[name]["out"]
        for k in ("color", "depth", "opacity_map", "depth_median"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(jout, k)),
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out["gau_uncertainty"],
                                   np.asarray(jout.gau_uncertainty),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(out["gau_related_pixels"],
                                      np.asarray(jout.gau_related_pixels))
        assert int(out["num_rendered"]) == int(jout.num_rendered)
        assert bool(out["overflow"]) == bool(jout.overflow)
        for k, jg in zip(("g_means", "g_view"), jgrads):
            np.testing.assert_allclose(r[name][k], np.asarray(jg),
                                       rtol=5e-4, atol=2e-5, err_msg=k)


def test_shard_binned_overflow_reports_per_shard(world):
    r = world["ranks"][0]
    scene, cam = world["scene"], world["cam"]
    prep = jax_preprocess(
        scene["means3D"], cam, CFG, opacities=scene["opacities"],
        scales=scene["scales"], rotations=scene["rotations"],
        colors_precomp=scene["colors_precomp"])
    tiles_y = -(-cam.height // CFG.tile_h)
    want = np.asarray(jax_band_counts(prep, N, -(-tiles_y // N)))
    np.testing.assert_array_equal(r["counts"], want)
    assert int(r["counts"].sum()) == int(r["touched"])
    assert int(r["counts"].max()) > 128, "scene too sparse for the overflow"
    assert bool(r["ovf_small"])
    assert not bool(r["ovf_fit"])


def test_tile_sharded_dual_render_bit_equal(world):
    r = world["ranks"][0]
    assert_tree_equal(r["jvp_one"], r["jvp_mesh"])
    assert float(np.abs(r["jvp_one"]["dcolor"]).max()) > 0
    assert r["full_raises"]
