"""The port's user examples, run in-process on the CPU at tiny sizes.

``render_ply`` renders a PLY that the port's ``save_ply`` wrote from a
``tests/scenes.py``-sized SH-1 model; its PNGs (read back with PIL) equal
the JAX package's ``render_model`` images of the same PLY, quantized the
same way, within one uint8 level (the orbit views are an ulp apart between
the packages).  ``fit_scene`` lowers its loss and writes a PLY that loads
back to the fitted model.  ``run_slam`` tracks a short orbit to an ATE
below the static-pose baseline's, on one device and with ``--mesh kf=2``
(two ranks it spawns on the CPU, rank 0 printing): the same bound, the
same result from both ranks, and one ATE line printed.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.io.ply import load_ply as jax_load_ply
from diff_gaussian_rasterization_tpu.io.synthetic import (
    orbit_trajectory as jax_orbit)
from diff_gaussian_rasterization_tpu.models.slam import (
    render_model as jax_render_model)
from diff_gaussian_rasterization_tpu_torch.convert import (
    gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.examples import (
    fit_scene, render_ply, run_slam)
from diff_gaussian_rasterization_tpu_torch.io.ply import load_ply, save_ply
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS)

from scenes import make_scene

torch.set_num_threads(2)


def write_scene_ply(path, p=64, seed=0):
    """A ``make_scene`` model with SH degree 1, saved by the port."""
    scene, _ = make_scene(p=p, seed=seed, sh_degree=1)
    op = np.asarray(scene["opacities"], np.float64)
    fields = dict(
        means3D=np.asarray(scene["means3D"]),
        scales_log=np.log(np.asarray(scene["scales"])),
        rotations=np.asarray(scene["rotations"]),
        opacities_logit=np.log(op / (1 - op)).astype(np.float32),
        sh=np.asarray(scene["shs"]), active=np.ones(p, bool))
    save_ply(str(path), gaussian_model_from_numpy(fields, device="cpu"))


def test_render_ply_matches_jax(tmp_path):
    ply = tmp_path / "scene.ply"
    write_scene_ply(ply)
    out = tmp_path / "renders"
    cfg = render_ply.main([str(ply), "--out", str(out), "--res", "32x40",
                           "--fov", "0.55x0.42", "--orbit", "2", "--depth",
                           "--cpu"])
    model = jax_load_ply(str(ply))
    jcfg = JaxConfig(tile_h=16, tile_w=16, instance_multiplier=12,
                     max_instances=cfg.max_instances)
    for i, view in enumerate(jax_orbit(2)):
        cam = JaxCamera(viewmatrix=view, tanfovx=0.55, tanfovy=0.42,
                        height=32, width=40)
        want = jax_render_model(model, cam, jcfg)
        assert not bool(want.overflow)
        rgb = np.clip(np.asarray(want.color), 0, 1)
        rgb = (np.moveaxis(rgb, 0, 2) * 255).round().astype(np.uint8)
        got = np.asarray(Image.open(out / f"view{i:03d}.png"))
        assert got.shape == (32, 40, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - rgb.astype(int))
        assert diff.max() <= 1 and rgb.std() > 10
        sil = np.asarray(want.opacity_map[0])
        d = np.asarray(want.depth[0]) / np.maximum(sil, 1e-6)
        d = np.where(sil > 0.5, d, 0.0)
        d = (d / max(d.max(), 1e-6) * 255).astype(np.uint8)
        got_d = np.asarray(Image.open(out / f"depth{i:03d}.png"))
        assert got_d.shape == (32, 40)
        assert np.abs(got_d.astype(int) - d.astype(int)).max() <= 1


def test_fit_scene_lowers_loss_and_saves_ply(tmp_path):
    ply = tmp_path / "fit.ply"
    res = fit_scene.main(["--iters", "12", "--views", "2", "--hw", "24", "32",
                          "--capacity", "1024", "--densify-every", "6",
                          "--out", str(ply), "--cpu"])
    losses = res["losses"]
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0]
    assert np.isfinite(res["holdout_psnr"]) and np.isfinite(res["train_psnr"])
    model = res["model"]
    loaded = load_ply(str(ply), device="cpu")
    act = model.active
    assert int(loaded.num_active) == int(act.sum()) > 512  # densified
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(loaded, f), getattr(model, f)[act]), f


def test_run_slam_tracks_orbit():
    res = run_slam.main(["--frames", "4", "--res", "24x32", "--gaussians",
                         "300", "--cpu"])
    assert res["frames"] == 4
    assert np.isfinite(res["ate_m"])
    assert res["ate_m"] < 0.5 * res["ate_static_m"]


def test_run_slam_mesh_not_ported(capfd):
    """(The name predates the parallel layer.)  ``--mesh kf=2`` spawns two
    ranks; every rank returns the same run, and only rank 0 prints."""
    res = run_slam.main(["--mesh", "kf=2", "--cpu", "--frames", "4",
                         "--res", "24x32", "--gaussians", "300"])
    assert res["frames"] == 4
    assert np.isfinite(res["ate_m"])
    assert res["ate_m"] < 0.5 * res["ate_static_m"]
    out = capfd.readouterr().out
    assert out.count("ATE RMSE:") == 1, out
    assert "on a kf=2 mesh" in out
