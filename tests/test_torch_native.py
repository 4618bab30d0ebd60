"""The port's native pose-graph solver, RGB-D decoder and normal-equation
solver against the JAX package's, on the CPU.

``native.pose_graph_optimize`` is built by the port (g++ into its own
build directory, never the JAX package's ``_native/``) from the same
``csrc/pose_graph.cpp`` as the JAX package's library, and holds
``test_native.py``'s noisy chain with a loop closure to the JAX package's
result at atol 1e-12 (the same float64 C++ on the same inputs).
``parallel.sharded.refine_poses_sharded(mesh=None)`` holds the JAX
package's at atol 1e-5 (float32 normal equations summed in another
order).  ``native.decode_rgbd_batch`` (g++ builds ``csrc/rgbd_io.cpp``
against libpng and libjpeg into the same directory) decodes written JPEG /
16-bit PNG pairs bit-equal to the JAX package's ``decode_rgbd_batch`` and
like PIL as ``test_native.test_rgbd_decoder_roundtrip`` holds it; a failed
build raises with the compiler's message.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu import native as jnative
from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu.parallel import sharded as jsharded
from diff_gaussian_rasterization_tpu_torch import native
from diff_gaussian_rasterization_tpu_torch.ops.kernels._build import (
    BUILD_DIR)
from diff_gaussian_rasterization_tpu_torch.parallel import sharded

torch.set_num_threads(2)


def noisy_chain(k=8, seed=0, loop=True):
    """``test_native.py``'s chain: ground truth, noisy start, edges, the
    exact relative measurements (and a loop closure)."""
    rng = np.random.RandomState(seed)
    gt = [jnp.eye(4)]
    for _ in range(1, k):
        gt.append(jlie.apply_twist(gt[-1],
                                   jnp.asarray(rng.normal(scale=0.2,
                                                          size=6))))
    gt = np.stack([np.asarray(v, np.float64) for v in gt])
    edges, zs = [], []
    for i in range(k - 1):
        edges.append((i, i + 1))
        zs.append(gt[i + 1] @ np.linalg.inv(gt[i]))
    if loop:
        edges.append((0, k - 1))
        zs.append(gt[k - 1] @ np.linalg.inv(gt[0]))
    noisy = gt.copy()
    for i in range(1, k):
        noisy[i] = np.asarray(jlie.apply_twist(
            jnp.asarray(gt[i]), jnp.asarray(rng.normal(scale=0.05,
                                                       size=6))))
    return gt, noisy, np.asarray(edges), np.stack(zs)


def max_err(views, gt):
    return max(np.abs(views[i].T - gt[i].T).max() for i in range(len(gt)))


def test_pose_graph_matches_jax_native():
    gt, noisy, edges, zs = noisy_chain()
    refined, err = native.pose_graph_optimize(noisy, edges, zs, iters=15)
    want, want_err = jnative.pose_graph_optimize(noisy, edges, zs, iters=15)
    np.testing.assert_allclose(refined, want, atol=1e-12)
    np.testing.assert_allclose(err, want_err, rtol=1e-9, atol=1e-18)
    assert max_err(refined, gt) < max_err(noisy, gt) * 0.05
    assert err < 1e-8
    # weighted, fewer iterations
    w = np.linspace(1.0, 4.0, len(edges))
    a, _ = native.pose_graph_optimize(noisy, edges, zs, weights=w, iters=3)
    b, _ = jnative.pose_graph_optimize(noisy, edges, zs, weights=w, iters=3)
    np.testing.assert_allclose(a, b, atol=1e-12)


def test_native_builds_in_the_port():
    so = native.build_pose_graph()
    assert so.parent == BUILD_DIR and so.exists()
    assert "diff_gaussian_rasterization_tpu_torch" in str(so)
    assert native.build_pose_graph() == so  # built once


@pytest.mark.parametrize("weighted", [False, True])
def test_refine_poses_matches_jax(weighted):
    gt, noisy, edges, zs = noisy_chain(k=6, seed=1)
    w = np.linspace(1.0, 4.0, len(edges)).astype(np.float32) \
        if weighted else None
    args = (noisy.astype(np.float32), edges.astype(np.int32),
            zs.astype(np.float32))
    want = np.asarray(jsharded.refine_poses_sharded(*args, iters=5,
                                                    weights=w))
    got = sharded.refine_poses_sharded(*args, iters=5, weights=w)
    assert got.dtype == torch.float32 and got.shape == (6, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert max_err(got.numpy(), gt) < 0.05 * max_err(noisy, gt)


def test_chordal_residual_matches_jax():
    _, noisy, edges, zs = noisy_chain(k=4, seed=2)
    rng = np.random.RandomState(3)
    xis = rng.normal(scale=0.01, size=(4, 6)).astype(np.float32)
    v = noisy.astype(np.float32)
    for e, (i, j) in enumerate(edges):
        want = np.asarray(jsharded._se3_chordal_residual(
            jnp.asarray(xis), jnp.asarray(v), i, j,
            jnp.asarray(zs[e], jnp.float32)))
        got = sharded._se3_chordal_residual(
            torch.as_tensor(xis[i]), torch.as_tensor(xis[j]),
            torch.as_tensor(v[i]), torch.as_tensor(v[j]),
            torch.as_tensor(zs[e].astype(np.float32)))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_refine_poses_mesh_raises():
    _, noisy, edges, zs = noisy_chain(k=3)
    with pytest.raises(NotImplementedError):
        sharded.refine_poses_sharded(noisy, edges, zs, mesh=object())



def write_rgbd(tmp_path, n=3, h=32, w=48, seed=0):
    """``test_native.test_rgbd_decoder_roundtrip``'s frames: random JPEG
    colors (quality 95) and 16-bit PNG depths."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    rgb_paths, depth_paths, depths = [], [], []
    for i in range(n):
        rgb = rng.randint(0, 255, (h, w, 3), np.uint8)
        depth = rng.randint(0, 60000, (h, w)).astype(np.uint16)
        rp, dp = str(tmp_path / f"frame{i}.jpg"), str(tmp_path / f"depth{i}.png")
        Image.fromarray(rgb).save(rp, quality=95)
        Image.fromarray(depth).save(dp)
        rgb_paths.append(rp)
        depth_paths.append(dp)
        depths.append(depth)
    return rgb_paths, depth_paths, depths


def test_decode_rgbd_batch_matches_jax_native(tmp_path):
    from PIL import Image
    h, w = 32, 48
    rgb_paths, depth_paths, depths = write_rgbd(tmp_path, h=h, w=w)
    rgb, depth, ok = native.decode_rgbd_batch(
        rgb_paths, depth_paths, h, w, depth_scale=5000.0, n_threads=2)
    want_rgb, want_depth, want_ok = jnative.decode_rgbd_batch(
        rgb_paths, depth_paths, h, w, depth_scale=5000.0, n_threads=2)
    assert ok == want_ok == 3
    assert rgb.dtype == depth.dtype == np.float32
    assert rgb.shape == (3, 3, h, w) and depth.shape == (3, h, w)
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(depth, want_depth)
    for i in range(3):
        ref = np.asarray(Image.open(rgb_paths[i]), np.float32)
        ref = ref.transpose(2, 0, 1) / 255.0
        assert np.abs(rgb[i] - ref).mean() < 0.02
        np.testing.assert_allclose(
            depth[i], depths[i].astype(np.float32) / 5000.0, atol=1e-4)
    # a missing frame stays zero and is not counted
    rgb2, depth2, ok2 = native.decode_rgbd_batch(
        [rgb_paths[0], str(tmp_path / "none.jpg")],
        [depth_paths[0], depth_paths[1]], h, w, 5000.0)
    assert ok2 == 1 and not rgb2[1].any()
    np.testing.assert_array_equal(rgb2[0], rgb[0])


def test_rgbd_io_builds_in_the_port(tmp_path, monkeypatch):
    so = native.build_rgbd_io()
    assert so.parent == BUILD_DIR and so.name.startswith("librgbdio_")
    assert native.build_rgbd_io() == so  # built once
    # a source that does not compile raises with the compiler's message
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for bad.cpp"):
        native._build(bad, "bad")
    assert not list((tmp_path / "build").glob("*.so"))
