"""The port's ``rasterize`` gradients against the JAX package's, on the CPU.

The same scene goes through ``jax.grad`` of the JAX package's ``rasterize``
and ``loss.backward()`` through the port's (whose backward core and
per-Gaussian reduction run their plain versions on CPU tensors).  Every
Gaussian parameter and the view matrix are compared at the tolerances of
``test_rasterize.test_gradient_parity_all_params`` (rtol 5e-4 / atol 2e-5),
and once against the JAX Pallas backend in interpret mode at those of
``test_pallas_kernels.test_rasterize_pallas_backend_end_to_end``.  Then the
gates: ``track_off``/``map_off``, absent cotangents, the phantom
depth-variance backward, and median depth never reaching the pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    rasterize as jax_rasterize)
from diff_gaussian_rasterization_tpu_torch.ops.rasterize import rasterize

from scenes import make_scene
from test_torch_rasterize import CFG, port_camera, port_config, to_torch

torch.set_num_threads(2)

KEYS = ("means3D", "scales", "rotations", "opacities", "shs")


def loss_terms(out, wc, np_=jnp):
    """``test_rasterize._loss``: every differentiable output."""
    s = (lambda x: x.sum()) if np_ is torch else jnp.sum
    return (s(wc * out.color) + 0.3 * s(out.depth)
            + 0.2 * s(out.opacity_map) + 0.15 * s(out.depth_median)
            + 0.1 * s(out.depth_var))


def jax_xla(means, cam, cfg, **kw):
    return jax_rasterize(means, cam, cfg, tile_batch=4,
                         **{"backend": "xla", **kw})


def jax_grads(scene, cam, cfg, keys, loss, render=jax_xla, **kw):
    """jax.grad of ``loss(render(...))`` w.r.t. ``keys`` of the scene and
    the view."""
    def f(params, view):
        cam2 = JaxCamera(viewmatrix=view, tanfovx=cam.tanfovx,
                         tanfovy=cam.tanfovy, height=cam.height,
                         width=cam.width)
        args = dict(scene)
        args.update(params)
        means = args.pop("means3D")
        return loss(render(means, cam2, cfg, **kw, **args))
    g = jax.grad(f, argnums=(0, 1))({k: scene[k] for k in keys},
                                    cam.viewmatrix)
    return {**{k: np.asarray(v) for k, v in g[0].items()},
            "view": np.asarray(g[1])}


def port_grads(scene, cam, cfg, keys, loss, render=rasterize, **kw):
    """The same through the port: grads of the scene ``keys`` and the view
    (None where no gradient reached a leaf)."""
    args = to_torch(scene)
    for k in keys:
        args[k].requires_grad_(True)
    tcam = port_camera(cam)
    view = tcam.viewmatrix.clone().requires_grad_(True)
    means = args.pop("means3D")
    out = render(means, tcam.replace(viewmatrix=view), port_config(cfg),
                 **args, **kw)
    loss(out).backward()
    leaves = {**args, "means3D": means, "view": view}
    return {k: None if leaves[k].grad is None else leaves[k].grad.numpy()
            for k in (*keys, "view")}


def assert_grads_close(a, b, rtol=5e-4, atol=2e-5):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("pose_full,ref_var", [
    (False, False), (True, False), (False, True)])
def test_gradient_parity_with_jax(pose_full, ref_var):
    """``test_rasterize.test_gradient_parity_all_params``'s three cases."""
    cfg = CFG.replace(pose_cov2d_branch=pose_full, pose_sh_branch=pose_full,
                      ref_depth_var=ref_var)
    scene, cam = make_scene(p=72, h=24, w=32, seed=13, sh_degree=1)
    wc = np.random.RandomState(1).uniform(0.5, 1, (3, 1, 1)).astype(
        np.float32)
    a = jax_grads(scene, cam, cfg, KEYS,
                  lambda o: loss_terms(o, jnp.asarray(wc)))
    b = port_grads(scene, cam, cfg, KEYS,
                   lambda o: loss_terms(o, torch.as_tensor(wc), torch))
    assert_grads_close(a, b)
    assert all(float(np.abs(v).max()) > 0 for v in b.values())


def test_gradient_parity_with_jax_pallas_interpret():
    """Against the JAX package's fused Pallas path (``_bwd_kernel`` and
    ``segment_sum._kernel`` in interpret mode)."""
    scene, cam = make_scene(p=48, h=24, w=32, seed=13)
    cfg = CFG.replace(tile_h=8, tile_w=16, chunk=128)
    loss = lambda o, s=jnp.sum: (s(o.color) + 0.3 * s(o.depth)
                                 + 0.1 * s(o.depth_median))
    a = jax_grads(scene, cam, cfg, ("means3D",), loss, backend="pallas")
    b = port_grads(scene, cam, cfg, ("means3D",),
                   lambda o: loss(o, lambda x: x.sum()))
    assert_grads_close(a, b, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("flag", ["track_off", "map_off"])
def test_track_off_map_off_gates(flag):
    """``test_rasterize.test_track_off_map_off_gates``: the gated side gets
    no gradient, the other the JAX package's."""
    scene, cam = make_scene(p=48, h=16, w=24, seed=6)
    loss = lambda o, s=jnp.sum: s(o.color) + s(o.depth)
    a = jax_grads(scene, cam, CFG, ("means3D",), loss, **{flag: True})
    b = port_grads(scene, cam, CFG, ("means3D",),
                   lambda o: loss(o, lambda x: x.sum()), **{flag: True})
    gated, live = ("view", "means3D") if flag == "track_off" else \
        ("means3D", "view")
    assert b[gated] is None and float(np.abs(a[gated]).max()) == 0.0
    assert float(np.abs(b[live]).max()) > 0
    np.testing.assert_allclose(b[live], a[live], rtol=5e-4, atol=2e-5)


def test_absent_cotangents_match_zero_cotangents():
    """``test_rasterize.test_symbolic_zero_cotangent_gating``: a loss that
    never touches median and variance (their streams skipped) gives the
    gradients of one that multiplies them by 0, and the JAX package's."""
    scene, cam = make_scene(p=48, h=16, w=24, seed=6)
    t = lambda x: x.sum()
    loss_min = lambda o: t(o.color) + t(o.opacity_map)
    loss_zero = lambda o: (loss_min(o) + 0.0 * t(o.depth_median)
                           + 0.0 * t(o.depth_var))
    g1 = port_grads(scene, cam, CFG, ("means3D",), loss_min)
    g2 = port_grads(scene, cam, CFG, ("means3D",), loss_zero)
    np.testing.assert_allclose(g1["means3D"], g2["means3D"], rtol=1e-6,
                               atol=1e-8)
    a = jax_grads(scene, cam, CFG, ("means3D",),
                  lambda o: jnp.sum(o.color) + jnp.sum(o.opacity_map))
    assert_grads_close(a, g1)


def test_ref_depth_var_phantom_backward():
    """``test_rasterize.test_ref_depth_var_phantom_backward``: with
    ``ref_depth_var`` the variance reads 0 but its gradient is the true
    variance's, as in the JAX package."""
    scene, cam = make_scene(p=48, h=16, w=24, seed=3)
    args = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    tcam = port_camera(cam)
    vals, grads = {}, {}
    for ref in (True, False):
        means = torch.as_tensor(np.array(scene["means3D"])).requires_grad_()
        out = rasterize(means, tcam, port_config(CFG.replace(
            ref_depth_var=ref)), **args)
        vals[ref] = float(out.depth_var.detach().sum())
        out.depth_var.sum().backward()
        grads[ref] = means.grad.numpy()
    assert vals[True] == 0.0 and vals[False] > 0.0
    np.testing.assert_allclose(grads[True], grads[False], rtol=1e-4,
                               atol=1e-6)
    a = jax_grads(scene, cam, CFG, ("means3D",),
                  lambda o: jnp.sum(o.depth_var))
    np.testing.assert_allclose(grads[True], a["means3D"], rtol=5e-4,
                               atol=2e-5)


def test_median_depth_never_reaches_the_pose():
    """Median depth reads the pose-stopped depth copy: exactly zero
    gradient to the view matrix, the JAX package's gradient to the
    means."""
    scene, cam = make_scene(p=72, h=24, w=32, seed=13)
    loss = lambda o, s=jnp.sum: s(o.depth_median)
    a = jax_grads(scene, cam, CFG, ("means3D",), loss)
    b = port_grads(scene, cam, CFG, ("means3D",),
                   lambda o: loss(o, lambda x: x.sum()))
    assert float(np.abs(b["view"]).max()) == 0.0
    assert float(np.abs(b["means3D"]).max()) > 0
    assert_grads_close(a, b)
