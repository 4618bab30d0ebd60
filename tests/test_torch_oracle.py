"""The port's dense ``render_oracle`` against the JAX package's, and the
port's analytic ``rasterize`` gradients against autograd through it.

``render_oracle`` is plain PyTorch: autograd through it is the ground truth
of the analytic backward, as ``jax.grad`` through the JAX oracle is in
``test_rasterize.py``.  Tolerances are that file's: forward rtol 1e-5 /
atol 1e-5, gradients rtol 5e-4 / atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.ops.oracle import (
    render_oracle as jax_render_oracle)
from diff_gaussian_rasterization_tpu_torch.ops.oracle import render_oracle

from scenes import make_scene
from test_torch_grad import (KEYS, assert_grads_close, jax_grads, loss_terms,
                             port_grads)
from test_torch_rasterize import CFG, port_camera, port_config, to_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("ref_var", [False, True])
def test_oracle_forward_matches_jax(ref_var, tile_mask=True):
    """With the per-pixel tile mask (every pixel sees the Gaussians whose
    tile rectangle covers its tile; without it, below, every pixel sees
    every visible Gaussian)."""
    cfg = CFG.replace(ref_depth_var=ref_var)
    scene, cam = make_scene(p=72, h=24, w=32, seed=13, sh_degree=1)
    kw = {k: v for k, v in scene.items() if k != "means3D"}
    a = jax_render_oracle(scene["means3D"], cam, cfg, pixel_chunk=256,
                          tile_mask=tile_mask, **kw)
    b = render_oracle(torch.as_tensor(np.array(scene["means3D"])),
                      port_camera(cam), port_config(cfg), pixel_chunk=200,
                      tile_mask=tile_mask, **to_torch(kw))
    n = lambda x: x.detach().numpy()
    for f in ("color", "depth", "depth_median", "depth_var", "opacity_map",
              "gau_uncertainty"):
        np.testing.assert_allclose(n(getattr(b, f)), np.asarray(getattr(a, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ("radii", "gau_related_pixels", "n_contrib", "n_valid",
              "num_rendered"):
        np.testing.assert_array_equal(n(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert float(b.opacity_map.max()) > 0.5


@pytest.mark.parametrize("pose_full,ref_var", [(False, False), (True, True)])
def test_oracle_gradients_match_jax_and_rasterize(pose_full, ref_var):
    """Autograd through the port's oracle equals ``jax.grad`` through the
    JAX oracle, and the port's analytic ``rasterize`` backward equals it."""
    cfg = CFG.replace(pose_cov2d_branch=pose_full, pose_sh_branch=pose_full,
                      ref_depth_var=ref_var)
    scene, cam = make_scene(p=72, h=24, w=32, seed=13, sh_degree=1)
    wc = np.random.RandomState(1).uniform(0.5, 1, (3, 1, 1)).astype(
        np.float32)
    a = jax_grads(scene, cam, cfg, KEYS,
                  lambda o: loss_terms(o, jnp.asarray(wc)),
                  render=jax_render_oracle)
    b = port_grads(scene, cam, cfg, KEYS,
                   lambda o: loss_terms(o, torch.as_tensor(wc), torch),
                   render=render_oracle)
    assert_grads_close(a, b)
    c = port_grads(scene, cam, cfg, KEYS,
                   lambda o: loss_terms(o, torch.as_tensor(wc), torch))
    assert_grads_close(b, c)


def test_oracle_forward_no_tile_mask_matches_jax():
    """``render_oracle(tile_mask=False)`` against the JAX oracle's."""
    test_oracle_forward_matches_jax(False, tile_mask=False)


def test_tile_mask_matches_no_mask_closely():
    """``test_oracle.py::test_tile_mask_matches_no_mask_closely`` in the
    port: the tile mask removes only sub-threshold tails of the 3-sigma
    rectangles, and the unmasked render sees more of them."""
    scene, cam = make_scene(p=96, h=32, w=40, seed=2)
    kw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    means = torch.as_tensor(np.array(scene["means3D"]))
    cfg = port_config(CFG)
    a = render_oracle(means, port_camera(cam), cfg, tile_mask=True, **kw)
    b = render_oracle(means, port_camera(cam), cfg, tile_mask=False, **kw)
    np.testing.assert_allclose(a.color.numpy(), b.color.numpy(), atol=2e-2)
    assert int(b.n_valid.sum()) >= int(a.n_valid.sum())
