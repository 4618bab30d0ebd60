"""The port's forward ``rasterize`` and ``render_model`` against the JAX
package's, on the CPU.

Same scene arrays through ``diff_gaussian_rasterization_tpu``'s
``rasterize(..., backend="xla")`` and the port's ``rasterize`` (whose render
core runs its plain version on CPU tensors), compared at the tolerances of
``test_rasterize.assert_outputs_close``.  Also: a model carried across by
``convert.py``, a PLY round trip, the bench scene's instance count, and the
loud failure of ``splat_basis_power`` (not ported).  The gradients are
held against the JAX package's in ``test_torch_grad.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.io import ply as jax_ply
from diff_gaussian_rasterization_tpu.models.gaussians import (
    init_model as jax_init_model)
from diff_gaussian_rasterization_tpu.models.slam import (
    render_model as jax_render_model)
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    count_instances as jax_count_instances, rasterize as jax_rasterize)
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.convert import (
    camera_from_numpy, gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.io.ply import load_ply, save_ply
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS, init_model)
from diff_gaussian_rasterization_tpu_torch.models.slam import render_model
from diff_gaussian_rasterization_tpu_torch.ops.rasterize import (
    count_instances, rasterize)
from diff_gaussian_rasterization_tpu_torch.scenes import (
    bench_camera, bench_scene)

from scenes import make_scene

torch.set_num_threads(2)

CFG = JaxConfig(tile_h=8, tile_w=8, chunk=16)
MODEL_FIELDS = PARAM_FIELDS + ("active",)


def port_config(cfg):
    return RasterConfig(**dataclasses.asdict(cfg))


def port_camera(cam):
    return camera_from_numpy(np.asarray(cam.viewmatrix), cam.tanfovx,
                             cam.tanfovy, cam.height, cam.width, device="cpu")


def to_torch(d):
    return {k: torch.as_tensor(np.array(v)) if hasattr(v, "shape") else v
            for k, v in d.items()}


def assert_outputs_close(a, b, atol=1e-5, check_var=False):
    """``test_rasterize.assert_outputs_close``'s tolerances, plus the
    integer diagnostics."""
    n = lambda x: x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    np.testing.assert_allclose(n(a.color), n(b.color), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(n(a.depth), n(b.depth), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(n(a.opacity_map), n(b.opacity_map), atol=atol)
    np.testing.assert_allclose(n(a.depth_median), n(b.depth_median),
                               atol=atol)
    np.testing.assert_allclose(n(a.gau_uncertainty), n(b.gau_uncertainty),
                               atol=atol, rtol=1e-4)
    np.testing.assert_array_equal(n(a.gau_related_pixels),
                                  n(b.gau_related_pixels))
    np.testing.assert_array_equal(n(a.radii), n(b.radii))
    if check_var:
        np.testing.assert_allclose(n(a.depth_var), n(b.depth_var),
                                   atol=1e-4, rtol=1e-5)
    else:
        assert float(np.abs(n(b.depth_var)).max()) == 0.0
    for name in ("n_contrib", "n_valid"):
        assert np.mean(n(getattr(a, name)) != n(getattr(b, name))) < 5e-3
    assert int(n(a.num_rendered)) == int(n(b.num_rendered))
    assert bool(n(a.overflow)) == bool(n(b.overflow))
    for name in a._fields:
        assert n(getattr(a, name)).shape == n(getattr(b, name)).shape, name


CASES = {
    "bg_gt": dict(),
    "ref_var_off": dict(cfg=dict(ref_depth_var=False)),
    "means2d": dict(means2d=True),
    "defaults": dict(drop=("bg", "gt_depth")),
    "sh3": dict(sh_degree=3),
    "nontile_size": dict(h=29, w=35),
    "overflow": dict(max_instances=64),
    "tiles_8x16": dict(cfg=dict(tile_w=16, chunk=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_matches_jax(case):
    c = CASES[case]
    cfg = CFG.replace(**c.get("cfg", {}))
    scene, cam = make_scene(p=96, h=c.get("h", 32), w=c.get("w", 40),
                            seed=0, sh_degree=c.get("sh_degree"))
    kw = {k: v for k, v in scene.items()
          if k != "means3D" and k not in c.get("drop", ())}
    if c.get("means2d"):
        kw["means2D"] = jnp.asarray(np.random.RandomState(1).normal(
            scale=0.02, size=(96, 2)), jnp.float32)
    if "max_instances" in c:
        kw["max_instances"] = c["max_instances"]
    a = jax_rasterize(scene["means3D"], cam, cfg, backend="xla",
                      tile_batch=4, **kw)
    tkw = to_torch(kw)
    b = rasterize(torch.as_tensor(np.array(scene["means3D"])),
                  port_camera(cam), port_config(cfg), **tkw)
    assert_outputs_close(a, b, check_var=not cfg.ref_depth_var)
    assert bool(b.overflow) == (case == "overflow")


def test_render_model_from_converted_jax_model():
    """A JAX ``init_model`` carried across by ``convert.py`` renders the
    same through the port's ``render_model``."""
    rng = np.random.RandomState(3)
    n = 80
    means = rng.uniform(-1, 1, (n, 3))
    means[:, 2] = rng.uniform(1.5, 4.0, n)
    jm = jax_init_model(
        96, sh_degree=2, means=jnp.asarray(means, jnp.float32),
        colors=jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32),
        scales=jnp.asarray(rng.uniform(0.05, 0.2, (n, 3)), jnp.float32),
        opacity=0.6)
    jm = jm.replace(sh=jm.sh.at[:n, 1:].set(jnp.asarray(
        rng.normal(scale=0.2, size=(n, 8, 3)), jnp.float32)))
    scene, cam = make_scene(p=8, h=32, w=40, seed=2)
    a = jax_render_model(jm, cam, CFG, gt_depth=scene["gt_depth"],
                         backend="xla", tile_batch=4)
    tm = gaussian_model_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in MODEL_FIELDS}, device="cpu")
    with torch.no_grad():
        b = render_model(tm, port_camera(cam), port_config(CFG),
                         gt_depth=torch.as_tensor(np.array(
                             scene["gt_depth"])))
    assert_outputs_close(a, b)
    assert float(b.opacity_map.max()) > 0.5


def test_init_model_matches_jax():
    """The port's ``init_model`` seeds the same parameters and activations
    as the JAX package's."""
    rng = np.random.RandomState(8)
    n = 10
    seed = dict(means=rng.normal(size=(n, 3)).astype(np.float32),
                colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                scales=rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32))
    jm = jax_init_model(16, sh_degree=1, opacity=0.3,
                        **{k: jnp.asarray(v) for k, v in seed.items()})
    tm = init_model(16, sh_degree=1, opacity=0.3, device="cpu", **seed)
    for f in MODEL_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).detach().numpy(),
                                   np.asarray(getattr(jm, f)), rtol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(tm.opacities.detach().numpy(),
                               np.asarray(jm.opacities), rtol=1e-6)
    np.testing.assert_allclose(tm.scales.detach().numpy(),
                               np.asarray(jm.scales), rtol=1e-6)
    assert tm.raster_kwargs()["sh_degree"] == 1


def test_ply_round_trip(tmp_path):
    """save_ply -> load_ply keeps the active Gaussians, and the JAX
    package reads the port's file to the same arrays."""
    rng = np.random.RandomState(4)
    n, cap = 20, 32
    arrays = dict(
        means3D=rng.normal(size=(cap, 3)),
        scales_log=rng.normal(size=(cap, 3)),
        rotations=rng.normal(size=(cap, 4)),
        opacities_logit=rng.normal(size=(cap, 1)),
        sh=rng.normal(size=(cap, 9, 3)),
        active=np.arange(cap) < n,
    )
    model = gaussian_model_from_numpy(arrays, device="cpu")
    path = str(tmp_path / "m.ply")
    save_ply(path, model)
    back = load_ply(path, capacity=cap, device="cpu")
    jback = jax_ply.load_ply(path, capacity=cap)
    for f in MODEL_FIELDS:
        x = getattr(model, f).detach().numpy()
        y = getattr(back, f).detach().numpy()
        np.testing.assert_array_equal(x[:n], y[:n], err_msg=f)
        np.testing.assert_array_equal(y, np.asarray(getattr(jback, f)),
                                      err_msg=f)
    assert back.active.tolist() == arrays["active"].tolist()
    with pytest.raises(ValueError):
        load_ply(path, capacity=n - 1, device="cpu")


def test_splat_basis_power_raises():
    """``splat_basis_power=True`` raises; the default config renders and
    back-propagates to the means."""
    scene, cam = make_scene(p=32, h=16, w=24, seed=5)
    tkw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    means = torch.as_tensor(np.array(scene["means3D"])).requires_grad_(True)
    out = rasterize(means, port_camera(cam), port_config(CFG), **tkw)
    assert out.color.requires_grad
    out.color.sum().backward()
    assert means.grad is not None and bool(torch.isfinite(means.grad).all())
    assert float(means.grad.abs().max()) > 0
    with pytest.raises(NotImplementedError, match="splat_basis_power"):
        rasterize(means, port_camera(cam),
                  port_config(CFG.replace(splat_basis_power=True)), **tkw)


def test_track_off_map_off_detach():
    """``map_off`` leaves no gradient path to the Gaussians and
    ``track_off`` none to the view; the values are unchanged."""
    scene, cam = make_scene(p=32, h=16, w=24, seed=6)
    tkw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    means = torch.as_tensor(np.array(scene["means3D"])).requires_grad_(True)
    tcam = port_camera(cam)
    view = tcam.viewmatrix.clone().requires_grad_(True)
    tcam = tcam.replace(viewmatrix=view)
    cfg = port_config(CFG)
    base = rasterize(means, tcam, cfg, **tkw)
    both = rasterize(means, tcam, cfg, track_off=True, map_off=True, **tkw)
    assert not both.color.requires_grad
    mapped = rasterize(means, tcam, cfg, map_off=True, **tkw)
    assert mapped.color.requires_grad  # through the view only
    for f in ("color", "depth", "opacity_map", "depth_median"):
        assert torch.equal(getattr(base, f), getattr(both, f))


def test_bench_scene_instance_count_matches_jax():
    """The bench scene (seed 0, 100k Gaussians, 1200x680, 32x32 tiles):
    the port and the JAX package count the same tile instances on the
    CPU, 234,033."""
    means, kw = bench_scene(device="cpu")
    cam = bench_camera(device="cpu")
    n_port = int(count_instances(means, cam, RasterConfig(), **kw))
    j = lambda t: jnp.asarray(t.numpy())
    jcam = JaxCamera(viewmatrix=jnp.eye(4, dtype=jnp.float32), tanfovx=0.82,
                     tanfovy=0.47, height=680, width=1200)
    n_jax = int(jax_count_instances(
        j(means), jcam, JaxConfig(), opacities=j(kw["opacities"]),
        scales=j(kw["scales"]), rotations=j(kw["rotations"]),
        colors_precomp=j(kw["colors_precomp"])))
    print(f"bench scene instances: port {n_port}, JAX package {n_jax}")
    assert n_port == n_jax == 234_033
