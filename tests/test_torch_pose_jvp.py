"""The port's pose JVP and binning reuse against the JAX package's, on the
CPU.

``rasterize_with_pose_jvp`` at the twist basis of the view, light and full
variant, against the JAX package's ``rasterize_with_pose_jvp(...,
backend="xla")`` on the same scene: the primal at
``test_torch_rasterize.assert_outputs_close``'s tolerances and the tangent
images at ``test_pose_jvp_full_variant_pallas_matches_xla``'s rtol 2e-4 /
atol 5e-5; also with K = 2 and 8 view directions, as the JAX package
takes any K.  Then the overflow report of
``test_pose_jvp_overflow_reported`` and the three checks of
``test_binning_reuse_exact_at_bin_pose`` on the port (``bin_for_view`` +
``rasterize(binn=)``), at that test's tolerances.  The overflow test
also holds the tile-sharded dual render on a one-rank gloo mesh bit-equal
to the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    rasterize_with_pose_jvp as jax_pose_jvp)
from diff_gaussian_rasterization_tpu_torch.models import lie
from diff_gaussian_rasterization_tpu_torch.ops.rasterize import (
    bin_for_view, rasterize, rasterize_with_pose_jvp)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh

from scenes import make_scene
from test_torch_rasterize import (CFG, assert_outputs_close, port_camera,
                                  port_config, to_torch)
from torch_dist_cases import one_rank_world

torch.set_num_threads(2)


def twist_basis(view):
    """[6, 4, 4]: the view matrix's derivatives along the twist basis."""
    tw = torch.func.jacfwd(lambda x: lie.apply_twist(view, x))(
        torch.zeros(6, dtype=view.dtype))
    return tw.movedim(-1, 0)


@pytest.mark.parametrize("full", [False, True])
def test_pose_jvp_matches_jax(full):
    cfg = CFG.replace(pose_cov2d_branch=full)
    scene, cam = make_scene(p=96, h=32, w=40, seed=21)
    kw = {k: v for k, v in scene.items() if k != "means3D"}
    tw = jax.jacfwd(lambda xi: jlie.apply_twist(cam.viewmatrix, xi))(
        jnp.zeros((6,), jnp.float32))
    a = jax_pose_jvp(scene["means3D"], cam, cfg, jnp.moveaxis(tw, -1, 0),
                     backend="xla", tile_batch=4, **kw)
    tcam = port_camera(cam)
    b = rasterize_with_pose_jvp(
        torch.as_tensor(np.array(scene["means3D"])), tcam, port_config(cfg),
        twist_basis(tcam.viewmatrix), **to_torch(kw))
    assert_outputs_close(a.out, b.out)
    for name in ("color", "depth", "opacity_map", "depth_median"):
        got, want = getattr(b, name).numpy(), np.asarray(getattr(a, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5,
                                   err_msg=name)
    assert float(b.color.abs().max()) > 0.1
    assert float(b.depth_median.abs().max()) == 0.0
    assert not b.color.requires_grad


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("k_t", [2, 8])
def test_pose_jvp_any_k_matches_jax(k_t, full):
    """K other than the twist basis's 6: its first two directions, and all
    six plus two combinations of them (more than one kernel launch carries
    on the card), the same [K, 4, 4] array for both packages."""
    cfg = CFG.replace(pose_cov2d_branch=full)
    scene, cam = make_scene(p=96, h=32, w=40, seed=22)
    kw = {k: v for k, v in scene.items() if k != "means3D"}
    tw = np.moveaxis(np.asarray(jax.jacfwd(
        lambda xi: jlie.apply_twist(cam.viewmatrix, xi))(
            jnp.zeros((6,), jnp.float32))), -1, 0)
    dirs = tw[:2] if k_t == 2 else np.concatenate(
        [tw, tw[0:1] + 0.5 * tw[3:4], tw[1:2] - tw[5:6]])
    dirs = dirs.astype(np.float32)
    a = jax_pose_jvp(scene["means3D"], cam, cfg, jnp.asarray(dirs),
                     backend="xla", tile_batch=4, **kw)
    b = rasterize_with_pose_jvp(
        torch.as_tensor(np.array(scene["means3D"])), port_camera(cam),
        port_config(cfg), torch.as_tensor(dirs), **to_torch(kw))
    assert_outputs_close(a.out, b.out)
    for name in ("color", "depth", "opacity_map", "depth_median"):
        got, want = getattr(b, name).numpy(), np.asarray(getattr(a, name))
        assert got.shape == want.shape and got.shape[0] == k_t, name
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5,
                                   err_msg=name)
    assert float(b.color.abs().max()) > 0.1


def test_pose_jvp_overflow_reported():
    scene, cam = make_scene(p=96, h=32, w=40, seed=0)
    kw = to_torch({k: v for k, v in scene.items()
                   if k not in ("bg", "gt_depth", "means3D")})
    tcam = port_camera(cam)
    j = rasterize_with_pose_jvp(
        torch.as_tensor(np.array(scene["means3D"])), tcam, port_config(CFG),
        twist_basis(tcam.viewmatrix), max_instances=128, **kw)
    assert bool(j.out.overflow)
    assert bool(torch.isfinite(j.color).all())
    # the tile-sharded dual render: a mesh that is not a DeviceMesh and the
    # full variant on a mesh are refused; on a one-rank gloo mesh the light
    # dual render is the unsharded one bit for bit, overflow included
    means = torch.as_tensor(np.array(scene["means3D"]))
    basis = twist_basis(tcam.viewmatrix)
    with pytest.raises(TypeError):
        rasterize_with_pose_jvp(means, tcam, port_config(CFG), basis,
                                mesh=object(), **kw)
    with one_rank_world():
        mesh = make_mesh((1,), ("tile",), backend="gloo", device="cpu")
        with pytest.raises(ValueError):
            rasterize_with_pose_jvp(means, tcam, port_config(CFG).replace(
                pose_cov2d_branch=True), basis, mesh=mesh, **kw)
        m = rasterize_with_pose_jvp(means, tcam, port_config(CFG), basis,
                                    max_instances=128, mesh=mesh, **kw)
    for name in ("color", "depth", "opacity_map"):
        assert torch.equal(getattr(m, name), getattr(j, name)), name
    for name in j.out._fields:
        assert torch.equal(getattr(m.out, name), getattr(j.out, name)), name


def test_binning_reuse_exact_at_bin_pose():
    scene, cam = make_scene(p=48, h=24, w=32, seed=13)
    kw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    m = torch.as_tensor(np.array(scene["means3D"]))
    tcam = port_camera(cam)
    cfg = port_config(CFG)

    base = rasterize(m, tcam, cfg, **kw)
    binn = bin_for_view(m, tcam, cfg.replace(bin_margin_px=5.0),
                        max_instances=4096,
                        **{k: v for k, v in kw.items()
                           if k not in ("bg", "gt_depth")})
    # the margin must not overflow the budget
    assert not bool(binn.overflow)
    assert int(binn.num_rendered) > int(base.num_rendered)
    reused = rasterize(m, tcam, cfg, binn=binn, **kw)
    np.testing.assert_allclose(base.color.detach().numpy(),
                               reused.color.detach().numpy(), atol=5e-6)
    np.testing.assert_allclose(base.depth.detach().numpy(),
                               reused.depth.detach().numpy(), rtol=3e-6,
                               atol=5e-6)
    np.testing.assert_allclose(base.opacity_map.detach().numpy(),
                               reused.opacity_map.detach().numpy(), atol=5e-6)

    # gradients flow through the reused-binning render
    def grad(**extra):
        mm = m.clone().requires_grad_(True)
        rasterize(mm, tcam, cfg, **extra, **kw).color.sum().backward()
        return mm.grad
    np.testing.assert_allclose(grad(binn=binn).numpy(), grad().numpy(),
                               rtol=1e-4, atol=1e-6)

    # nearby pose: the frozen binning stays a close approximation
    xi = torch.tensor([0.004, -0.003, 0.002, 0.001, -0.002, 0.001])
    cam2 = tcam.replace(viewmatrix=lie.apply_twist(tcam.viewmatrix, xi))
    with torch.no_grad():
        fresh = rasterize(m, cam2, cfg, **kw)
        moved = rasterize(m, cam2, cfg, binn=binn, **kw)
    err = float((fresh.color - moved.color).abs().max())
    assert err < 0.05, err
