"""The port's reference-style API against the JAX package's, on the CPU.

Each of ``test_api.py``'s ten behaviours, with the same seeded scenes
(``tests/scenes.py``) through ``diff_gaussian_rasterization_tpu``'s
``GaussianRasterizer`` / ``rasterize_gaussians`` (numpy inputs, or torch
tensors that require grad, which take its torch autograd bridge) and
through the port's (CPU tensors, so the render core runs its plain
version).  Outputs compare at ``test_torch_rasterize.py``'s tolerance
(atol 1e-5), gradients at ``test_torch_grad.py``'s (rtol 5e-4 / atol
2e-5).  Last, the port's API against the port's own ``rasterize``, bit for
bit, in outputs and gradients.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diff_gaussian_rasterization_tpu as jdgr
import diff_gaussian_rasterization_tpu_torch as dgr
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig

from scenes import make_scene
from test_torch_rasterize import port_config

torch.set_num_threads(2)

JAX_CFG = JaxConfig(tile_h=8, tile_w=8, chunk=16)
CFG = port_config(JAX_CFG)
OUT_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 2e-5
LEAVES = ("means3D", "means2D", "opacities", "colors_precomp", "scales",
          "rotations")


def np_scene(p=48, h=24, w=32, seed=1, **kw):
    scene, cam = make_scene(p=p, h=h, w=w, seed=seed, **kw)
    return ({k: np.asarray(v) if hasattr(v, "shape") else v
             for k, v in scene.items()}, cam)


def settings(pkg, cam, bg, view, **over):
    kw = dict(image_height=cam.height, image_width=cam.width,
              tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, bg=bg,
              scale_modifier=1.0, viewmatrix=view)
    kw.update(over)
    return pkg.GaussianRasterizationSettings(**kw)


def t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32,
                        requires_grad=grad)


def port_call(scene, cam, *, variant="light", config=CFG, **over):
    """The port's ``GaussianRasterizer`` on CPU tensors of ``scene``."""
    r = dgr.GaussianRasterizer(
        settings(dgr, cam, t(scene["bg"]), t(np.asarray(cam.viewmatrix)),
                 **over), config=config, variant=variant)
    return r(means3D=t(scene["means3D"]), opacities=t(scene["opacities"]),
             colors_precomp=t(scene["colors_precomp"]),
             scales=t(scene["scales"]), rotations=t(scene["rotations"]),
             gt_depth=t(scene["gt_depth"]))


def jax_call(scene, cam, *, variant="light", **over):
    """The JAX package's ``GaussianRasterizer`` on the same arrays."""
    r = jdgr.GaussianRasterizer(
        settings(jdgr, cam, scene["bg"], cam.viewmatrix, **over),
        config=JAX_CFG, variant=variant)
    return r(means3D=scene["means3D"], opacities=scene["opacities"],
             colors_precomp=scene["colors_precomp"], scales=scene["scales"],
             rotations=scene["rotations"], viewmatrix=cam.viewmatrix,
             gt_depth=scene["gt_depth"])


def n(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_rasterizer_eight_tuple():
    """``test_api.test_rasterizer_eight_tuple``: the 8-tuple's shapes,
    dtypes and values against the JAX package's."""
    scene, cam = np_scene()
    out = port_call(scene, cam)
    want = jax_call(scene, cam)
    assert len(out) == 8
    (color, radii, depth, depth_median, depth_var, opacity_map, gau_u,
     gau_np) = out
    assert color.shape == (3, 24, 32) and radii.shape == (48,)
    assert depth.shape == depth_median.shape == (1, 24, 32)
    assert torch.all(depth_var == 0.0)  # reference parity
    assert gau_u.shape == (48, 1) and gau_np.dtype == torch.int32
    assert radii.dtype == torch.int32
    for i, (a, b) in enumerate(zip(out, want)):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(n(a), n(b), err_msg=str(i))
        else:
            np.testing.assert_allclose(n(a), n(b), atol=OUT_ATOL, rtol=1e-4,
                                       err_msg=str(i))


def test_full_variant_four_tuple():
    """``test_api.test_full_variant_four_tuple``: the full package's
    (color, radii, depth, uncertainty = silhouette) against the JAX
    package's."""
    scene, cam = np_scene()
    r = dgr.GaussianRasterizer(settings(dgr, cam, None, None), config=CFG,
                               variant="full")
    assert r.config.pose_cov2d_branch and r.config.pose_sh_branch
    out = port_call(scene, cam, variant="full")
    want = jax_call(scene, cam, variant="full")
    assert len(out) == 4 and out[3].shape == (1, 24, 32)
    u = n(out[3])
    assert u.min() >= 0.0 and u.max() <= 1.0 + 1e-6
    np.testing.assert_array_equal(n(out[1]), n(want[1]))
    for i in (0, 2, 3):
        np.testing.assert_allclose(n(out[i]), n(want[i]), atol=OUT_ATOL,
                                   rtol=1e-4, err_msg=str(i))


@pytest.mark.parametrize("drop,match", [
    ("colors", "SHs or precomputed"), ("both_colors", "SHs or precomputed"),
    ("scales", "scale/rotation pair"), ("both_geometry", "scale/rotation pair")])
def test_input_validation(drop, match):
    """``test_api.test_input_validation``: the reference's two messages, on
    the same inputs as the JAX package's."""
    scene, cam = np_scene(p=16, h=16, w=16, seed=0)
    kw = dict(means3D=scene["means3D"], opacities=scene["opacities"],
              colors_precomp=scene["colors_precomp"],
              scales=scene["scales"], rotations=scene["rotations"])
    if drop == "colors":
        del kw["colors_precomp"]
    elif drop == "both_colors":
        kw["shs"] = np.zeros((16, 1, 3), np.float32)
    elif drop == "scales":
        del kw["scales"], kw["rotations"]
    else:
        kw["cov3D_precomp"] = np.zeros((16, 6), np.float32)
    for pkg, cfg, conv in ((jdgr, JAX_CFG, jnp.asarray), (dgr, CFG, t)):
        r = pkg.GaussianRasterizer(
            settings(pkg, cam, conv(scene["bg"]),
                     conv(np.asarray(cam.viewmatrix))), config=cfg)
        with pytest.raises(ValueError, match=match):
            r(**{k: conv(v) for k, v in kw.items()})


def test_mark_visible():
    """``test_api.test_mark_visible``: the near-plane masks are equal, at
    the identity view and at a moved one."""
    scene, cam = np_scene(p=64, h=16, w=16, seed=2)
    view = np.eye(4, dtype=np.float32)
    view[3, 2] = -1.4  # z_view = z - 1.4: some Gaussians behind the plane
    for v in (np.asarray(cam.viewmatrix), view):
        r = dgr.GaussianRasterizer(settings(dgr, cam, None, t(v)),
                                   config=CFG)
        rj = jdgr.GaussianRasterizer(settings(jdgr, cam, None,
                                              jnp.asarray(v)),
                                     config=JAX_CFG)
        vis = r.markVisible(t(scene["means3D"]))
        assert vis.dtype == torch.bool
        np.testing.assert_array_equal(
            n(vis), np.asarray(rj.markVisible(scene["means3D"])))
    assert 0 < int(vis.sum()) < 64


def test_empty_tensor_convention():
    """``test_api.test_empty_tensor_convention``: empty tensors (the
    reference's placeholders) behave as None, and the render equals the
    JAX package's."""
    scene, cam = np_scene(p=16, h=16, w=16, seed=3)
    s = settings(dgr, cam, t(scene["bg"]), t(np.asarray(cam.viewmatrix)))
    kw = dict(means3D=t(scene["means3D"]), opacities=t(scene["opacities"]),
              colors_precomp=t(scene["colors_precomp"]),
              scales=t(scene["scales"]), rotations=t(scene["rotations"]),
              gt_depth=t(scene["gt_depth"]), raster_settings=s, config=CFG)
    out = dgr.rasterize_gaussians(shs=torch.Tensor([]),
                                  cov3Ds_precomp=torch.Tensor([]),
                                  means2D=torch.Tensor([]), **kw)
    ref = dgr.rasterize_gaussians(**kw)
    want = jdgr.rasterize_gaussians(
        means3D=scene["means3D"], shs=jnp.zeros((0,)),
        colors_precomp=scene["colors_precomp"],
        opacities=scene["opacities"], scales=scene["scales"],
        rotations=scene["rotations"], cov3Ds_precomp=jnp.zeros((0,)),
        viewmatrix=cam.viewmatrix, gt_depth=scene["gt_depth"],
        raster_settings=settings(jdgr, cam, scene["bg"], cam.viewmatrix),
        config=JAX_CFG)
    assert out[0].shape == (3, 16, 16)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    np.testing.assert_allclose(n(out[0]), n(want[0]), atol=OUT_ATOL)


def bridge_leaves(scene, p):
    """Torch leaves that require grad: the scene's parameters, a zero
    means2D [P, 3] and the view matrix."""
    d = {k: t(scene[k], True) for k in LEAVES if k != "means2D"}
    d["means2D"] = torch.zeros(p, 3, requires_grad=True)
    d["viewmatrix"] = t(np.eye(4, dtype=np.float32), True)
    return d


def api_grads(pkg, cfg, scene, cam, loss, alpha_grad, variant="light",
              **call):
    """``loss(out)`` through ``pkg``'s ``GaussianRasterizer`` and
    backward: the outputs and the gradients of ``bridge_leaves``."""
    leaves = bridge_leaves(scene, scene["means3D"].shape[0])
    r = pkg.GaussianRasterizer(
        settings(pkg, cam, t(scene["bg"]), leaves["viewmatrix"]), config=cfg,
        variant=variant, alpha_grad=alpha_grad)
    out = r(**leaves, **call)
    loss(out).backward()
    return out, {k: v.grad for k, v in leaves.items()}


def light_loss(out, w_alpha=0.2):
    """Every differentiable output of the 8-tuple."""
    loss = (out[0].sum() + 0.3 * out[2].sum() + 0.15 * out[3].sum()
            + 0.1 * out[4].sum())
    return loss + w_alpha * out[5].sum() if w_alpha else loss


def full_loss(out, w_alpha=0.2):
    """Every differentiable output of the full variant's 4-tuple."""
    loss = out[0].sum() + 0.3 * out[2].sum()
    return loss + w_alpha * out[3].sum() if w_alpha else loss


@pytest.mark.parametrize("alpha_grad", [True, False])
def test_autograd_contract_against_jax_bridge(alpha_grad):
    """``test_api.test_torch_autograd_bridge``: ``loss.backward()`` through
    the port's API gives every leaf, the view matrix and means2D [P, 3]
    the JAX bridge's gradients; ``alpha_grad=False`` drops the silhouette's
    cotangent in both, and the median and variance cotangents flow."""
    scene, cam = np_scene(p=64, h=32, w=48, seed=0)
    gt = dict(gt_depth=t(scene["gt_depth"]))
    out, g = api_grads(dgr, CFG, scene, cam, light_loss, alpha_grad, **gt)
    want_out, want = api_grads(jdgr, JAX_CFG, scene, cam, light_loss,
                               alpha_grad, **gt)
    assert out[0].requires_grad and not out[1].requires_grad
    assert not out[6].requires_grad and not out[7].requires_grad
    np.testing.assert_allclose(n(out[0]), n(want_out[0]), atol=OUT_ATOL)
    assert set(g) == set(want)
    for k in g:
        assert g[k].shape == want[k].shape, k
        np.testing.assert_allclose(n(g[k]), n(want[k]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        assert float(g[k].abs().max()) > 0, k
    assert g["viewmatrix"].shape == (4, 4)
    assert g["means2D"].shape == (64, 3)
    assert torch.all(g["means2D"][:, 2] == 0)
    # the dropped silhouette term: the same gradients as a loss without it
    if not alpha_grad:
        _, g_plain = api_grads(dgr, CFG, scene, cam,
                               lambda o: light_loss(o, 0.0), True, **gt)
        for k in g:
            assert torch.equal(g[k], g_plain[k]), k


def test_sh_and_cov3d_paths_against_jax_bridge():
    """``test_api.test_torch_bridge_sh_and_cov3d_paths``: the SH colors and
    the precomputed covariance, differentiated, against the JAX bridge."""
    scene, cam = np_scene(p=32, h=16, w=24, seed=2, sh_degree=1)
    s2 = np.asarray(scene["scales"]) ** 2
    cov = np.zeros((32, 6), np.float32)
    cov[:, 0], cov[:, 3], cov[:, 5] = s2[:, 0], s2[:, 1], s2[:, 2]
    grads = []
    for pkg, cfg in ((dgr, CFG), (jdgr, JAX_CFG)):
        leaves = dict(means3D=t(scene["means3D"], True),
                      opacities=t(scene["opacities"], True),
                      shs=t(scene["shs"], True), cov3D_precomp=t(cov, True))
        s = settings(pkg, cam, torch.zeros(3), t(np.eye(4, dtype=np.float32)),
                     sh_degree=1)
        out = pkg.GaussianRasterizer(s, config=cfg)(**leaves)
        (out[0].sum() + 0.3 * out[2].sum()).backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for k in grads[0]:
        assert float(grads[0][k].abs().sum()) > 0, k
        np.testing.assert_allclose(n(grads[0][k]), n(grads[1][k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def dump_keys(snap):
    return set(snap), set(snap["settings"])


def test_forward_debug_snapshot_dump(tmp_path, monkeypatch):
    """``test_api.test_debug_snapshot_dump``: a non-finite render raises
    FloatingPointError and writes snapshot_fw.dump, whose keys are the
    JAX bridge's."""
    scene, cam = np_scene(p=16, h=16, w=16, seed=4)
    scene["colors_precomp"] = scene["colors_precomp"].copy()
    scene["colors_precomp"][:, 0] = np.nan
    snaps = []
    for pkg, cfg, sub in ((dgr, CFG, "port"), (jdgr, JAX_CFG, "jax")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        leaves = bridge_leaves(scene, 16)
        del leaves["means2D"]
        s = settings(pkg, cam, t(scene["bg"]), leaves.pop("viewmatrix"),
                     debug=True)
        with pytest.raises(FloatingPointError, match="non-finite"):
            pkg.rasterize_gaussians(raster_settings=s, config=cfg,
                                    gt_depth=t(scene["gt_depth"]), **{
                                        k.replace("cov3D", "cov3Ds"): v
                                        for k, v in leaves.items()})
        with open("snapshot_fw.dump", "rb") as f:
            snaps.append(pickle.load(f))
    assert dump_keys(snaps[0]) == dump_keys(snaps[1])
    assert np.isnan(snaps[0]["colors_precomp"][:, 0]).all()
    np.testing.assert_array_equal(snaps[0]["means3D"], scene["means3D"])


def test_backward_debug_snapshot_dump(tmp_path, monkeypatch):
    """``test_api.test_torch_backward_snapshot_dump``: non-finite gradients
    raise FloatingPointError and write snapshot_bw.dump with the
    cotangents, keyed as the JAX bridge keys it."""
    scene, cam = np_scene(p=16, h=16, w=16, seed=4)
    snaps = []
    for pkg, cfg, sub in ((dgr, CFG, "port"), (jdgr, JAX_CFG, "jax")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        leaves = bridge_leaves(scene, 16)
        del leaves["means2D"]
        s = settings(pkg, cam, t(scene["bg"]), leaves["viewmatrix"],
                     debug=True)
        out = pkg.GaussianRasterizer(s, config=cfg)(**leaves)
        bad = torch.full((3, 16, 16), float("nan"))
        with pytest.raises(FloatingPointError, match="non-finite"):
            (out[0] * bad).sum().backward()
        with open("snapshot_bw.dump", "rb") as f:
            snaps.append(pickle.load(f))
    assert dump_keys(snaps[0]) == dump_keys(snaps[1])
    assert set(snaps[0]["cotangents"]) == set(snaps[1]["cotangents"])
    for k, v in snaps[0]["cotangents"].items():
        assert v.shape == snaps[1]["cotangents"][k].shape, k
    assert np.isnan(snaps[0]["cotangents"]["color"]).all()


@pytest.mark.parametrize("debug", [True, False])
def test_prefiltered_contract(tmp_path, monkeypatch, debug):
    """``test_api.test_prefiltered_contract``: with ``prefiltered=True`` a
    Gaussian behind the near plane raises, with or without ``debug``, in
    both packages; an all-visible scene renders as without the flag."""
    monkeypatch.chdir(tmp_path)
    scene, cam = np_scene(p=16, h=16, w=16, seed=5)
    behind = scene["means3D"].copy()
    behind[3, 2] = -1.0
    for pkg, cfg, conv in ((jdgr, JAX_CFG, jnp.asarray), (dgr, CFG, t)):
        s = settings(pkg, cam, conv(scene["bg"]),
                     conv(np.asarray(cam.viewmatrix)), prefiltered=True,
                     debug=debug)
        kw = dict(colors_precomp=conv(scene["colors_precomp"]),
                  opacities=conv(scene["opacities"]),
                  scales=conv(scene["scales"]),
                  rotations=conv(scene["rotations"]),
                  viewmatrix=conv(np.asarray(cam.viewmatrix)),
                  raster_settings=s, config=cfg)
        with pytest.raises(RuntimeError, match="prefiltered"):
            pkg.rasterize_gaussians(means3D=conv(behind), **kw)
    out = dgr.rasterize_gaussians(means3D=t(scene["means3D"]), **kw)
    ref = dgr.rasterize_gaussians(
        means3D=t(scene["means3D"]),
        **{**kw, "raster_settings": s._replace(prefiltered=False)})
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("variant,alpha_grad", [
    ("light", True), ("light", False), ("full", True), ("full", False)])
def test_api_bit_equal_to_rasterize(variant, alpha_grad):
    """The port's API and the port's ``rasterize`` on the same inputs and
    loss: every output and every gradient bit-equal (with ``alpha_grad=
    False``, to the loss without its silhouette term)."""
    scene, cam = np_scene(p=72, h=24, w=32, seed=13)
    loss = light_loss if variant == "light" else full_loss
    gt = t(scene["gt_depth"])
    out, g = api_grads(dgr, CFG, scene, cam, loss, alpha_grad, variant,
                       gt_depth=gt)

    leaves = bridge_leaves(scene, 72)
    camera = dgr.Camera(viewmatrix=leaves["viewmatrix"], tanfovx=cam.tanfovx,
                        tanfovy=cam.tanfovy, height=24, width=32)
    kw = {k: v for k, v in leaves.items()
          if k not in ("means3D", "means2D", "viewmatrix")}
    cfg = CFG.full_variant() if variant == "full" else CFG
    ref = dgr.rasterize(leaves["means3D"], camera, cfg, bg=t(scene["bg"]),
                        gt_depth=gt, means2D=leaves["means2D"][:, :2], **kw)
    want = ref[:8] if variant == "light" else (
        ref.color, ref.radii, ref.depth, ref.opacity_map)
    loss(want, 0.2 if alpha_grad else 0.0).backward()
    assert len(out) == len(want)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    for k, v in leaves.items():
        assert torch.equal(g[k], v.grad), k
