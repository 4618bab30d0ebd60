"""Seeded synthetic scenes at the scale the repository measures.

``bench_scene`` draws the benchmark scene with numpy ``RandomState(seed)``
in the same order and with the same distributions as the JAX package's
``bench.py`` (``make_scene``), so both packages render the same Gaussians:
P Gaussians in a 4 x 4 x 5.2 box in front of an identity camera at
1200x680, tan(fov/2) = 0.82 x 0.47; ``kind="room"`` draws the JAX
package's root ``prof.py`` room instead (``make_scene(kind="room")``), a
scene that occludes most of what it holds.  ``random_model`` makes a
``GaussianModel`` of the same Gaussians with random SH bands.
``mapping_model`` is the model of the JAX package's mapping benchmark
(``bench_tracking.make_model``, 500,000 Gaussians in ``bench_mapping.py``),
and ``small_scene`` the JAX package's test scene (``tests/scenes.py``),
each with the same draws in the same order.  ``tracking_frame`` builds the
JAX package's tracking benchmark (``bench_tracking.py``): its model, target
frame, start pose and record configuration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .camera import Camera
from .config import RasterConfig
from .models.gaussians import GaussianModel
from .models.lie import apply_twist
from .models.slam import Frame, TrackingConfig, render_model
from .ops.sh import num_sh_coeffs, rgb_to_sh0

BENCH_P, BENCH_H, BENCH_W = 100_000, 680, 1200
MAPPING_P = 500_000
BENCH_TANFOVX, BENCH_TANFOVY = 0.82, 0.47


def bench_camera(viewmatrix=None, height=BENCH_H, width=BENCH_W,
                 device="cuda") -> Camera:
    if viewmatrix is None:
        viewmatrix = torch.eye(4, dtype=torch.float32, device=device)
    return Camera(viewmatrix=viewmatrix, tanfovx=BENCH_TANFOVX,
                  tanfovy=BENCH_TANFOVY, height=height, width=width)


def bench_scene(seed=0, p=BENCH_P, height=BENCH_H, width=BENCH_W,
                device="cuda", kind="uniform"):
    """``(means3D, kwargs)`` of the benchmark scene; ``kwargs`` holds
    scales, rotations, opacities, colors_precomp, bg and gt_depth.

    ``kind="uniform"`` is the root ``bench.py``'s cloud (``make_scene``,
    ``bench.py:59-74``).  ``kind="room"`` is the root ``prof.py``'s
    occlusion-heavy room (``make_scene(kind="room")``, ``prof.py:44-56``):
    three quarters of the Gaussians on the walls of a 6 m box around the
    camera, the rest clutter inside it, drawn in that function's order.
    (``prof.py``'s own uniform cloud draws the same distributions as
    ``bench.py``'s but its scales and opacities before the rotations, so
    only its means equal this one's.)"""
    if kind not in ("uniform", "room"):
        raise ValueError(f"kind must be 'uniform' or 'room', got {kind!r}")
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if kind == "room":
        n_wall = int(p * 0.75)
        walls = rng.uniform(-3, 3, (n_wall, 3))
        face = rng.randint(0, 6, n_wall)
        axis, sign = face // 2, (face % 2) * 2 - 1
        walls[np.arange(n_wall), axis] = sign * 3.0
        clutter = rng.uniform(-2.4, 2.4, (p - n_wall, 3))
        # the camera at the origin looking along +z: walls 3-6 m away
        means = np.concatenate([walls, clutter]) + np.asarray([0.0, 0.0, 3.2])
        scales = np.exp(rng.uniform(np.log(0.03), np.log(0.12), (p, 3)))
        opac = rng.uniform(0.5, 0.99, (p, 1))
        quats = rng.normal(size=(p, 4))
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    else:
        means = rng.uniform(-2, 2, (p, 3))
        means[:, 2] = rng.uniform(0.8, 6.0, p)
        quats = rng.normal(size=(p, 4))
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        scales = np.exp(rng.uniform(np.log(0.01), np.log(0.05), (p, 3)))
        opac = rng.uniform(0.2, 0.95, (p, 1))
    kw = dict(
        scales=t(scales),
        rotations=t(quats),
        opacities=t(opac),
        colors_precomp=t(rng.uniform(0, 1, (p, 3))),
        bg=torch.zeros(3, dtype=torch.float32, device=device),
        gt_depth=t(rng.uniform(0.8, 6, (height, width))),
    )
    return t(means), kw


def random_model(seed=0, p=BENCH_P, sh_degree=3,
                 device="cuda") -> GaussianModel:
    """A model with the bench scene's Gaussians (geometry, opacities, and
    colors as the SH DC band) and random higher SH bands of
    ``sh_degree``."""
    means, kw = bench_scene(seed=seed, p=p, height=1, width=1, device=device)
    rest = np.random.RandomState(seed).normal(
        scale=0.3, size=(p, num_sh_coeffs(sh_degree), 3))
    sh = torch.as_tensor(rest.astype(np.float32), device=device)
    sh[:, 0] = rgb_to_sh0(kw["colors_precomp"])
    op = kw["opacities"]
    return GaussianModel(
        means, torch.log(kw["scales"]), kw["rotations"],
        torch.log(op / (1.0 - op)), sh,
        torch.ones(p, dtype=torch.bool, device=device))


def orbit_view(angle_deg: float, device="cuda"):
    """A view matrix (row-vector convention) rotated by ``angle_deg`` about
    the y axis around the point (0, 0, 3.4), the scene's center."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    rot = torch.tensor([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]],
                       dtype=torch.float32, device=device)
    center = torch.tensor([0.0, 0.0, 3.4], dtype=torch.float32, device=device)
    # p_view = (p - center) @ rot + center
    v = torch.eye(4, dtype=torch.float32, device=device)
    v[:3, :3] = rot
    v[3, :3] = center - center @ rot
    return v


def mapping_model(seed=0, p=MAPPING_P, device="cuda") -> GaussianModel:
    """The mapping benchmark's model: the bench scene's box, SH degree 0
    colors in [0.1, 0.9], log-uniform scales in [0.01, 0.05], opacities
    uniform in [0.2, 0.95] (drawn in ``bench_tracking.make_model``'s
    order, in float64, then cast)."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-2, 2, (p, 3))
    means[:, 2] = rng.uniform(0.8, 6.0, p)
    quats = rng.normal(size=(p, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    sh = rng.uniform(0.1, 0.9, (p, 1, 3)) / 0.28209479177387814
    scales_log = rng.uniform(np.log(0.01), np.log(0.05), (p, 3))
    opac_logit = np.log(
        1.0 / np.clip(rng.uniform(0.2, 0.95, (p, 1)), 1e-5, 1) - 1.0) * -1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GaussianModel(t(means), t(scales_log), t(quats), t(opac_logit),
                         t(sh), torch.ones(p, dtype=torch.bool, device=device))


def small_scene(p=64, h=32, w=40, seed=0, sh_degree=None, device="cuda"):
    """``(means3D, kwargs, camera)`` of the JAX package's test scene
    (``tests/scenes.py::make_scene``): P Gaussians in front of an identity
    camera with tan(fov/2) = tan(0.5) x tan(0.4), deliberately unnormalized
    quaternions; ``kwargs`` holds scales, rotations, opacities, bg,
    gt_depth and colors_precomp, or shs and sh_degree."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1.0, 1.0, (p, 3))
    means[:, 2] = rng.uniform(1.0, 4.0, p)
    scales = rng.uniform(0.05, 0.25, (p, 3))
    quats = rng.normal(size=(p, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    quats *= rng.uniform(0.7, 1.3, (p, 1))
    opac = rng.uniform(0.2, 0.95, (p, 1))
    colors = rng.uniform(0.0, 1.0, (p, 3))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    cam = Camera(viewmatrix=torch.eye(4, dtype=torch.float32, device=device),
                 tanfovx=float(np.tan(0.5)), tanfovy=float(np.tan(0.4)),
                 height=h, width=w)
    kw = dict(scales=t(scales), rotations=t(quats), opacities=t(opac),
              colors_precomp=t(colors), bg=t(rng.uniform(0, 1, 3)),
              gt_depth=t(rng.uniform(1.0, 4.0, (h, w))))
    if sh_degree is not None:
        sh = rng.normal(scale=0.3, size=(p, num_sh_coeffs(sh_degree), 3))
        sh = t(sh)
        sh[:, 0] = rgb_to_sh0(t(colors))
        kw["shs"], kw["sh_degree"] = sh, sh_degree
        del kw["colors_precomp"]
    return t(means), kw, cam


# bench_tracking.py's start pose: this twist applied to the identity view
TRACKING_XI = (0.01, -0.008, 0.006, 0.004, -0.003, 0.005)


class TrackingScene(NamedTuple):
    model: GaussianModel
    camera: Camera        # the target's camera (identity pose)
    cfg: RasterConfig     # 32x32 tiles, budget 1.1x the target's count
    frame: Frame          # the model rendered at the identity pose
    view0: torch.Tensor   # the start pose
    tcfg: TrackingConfig  # the record configuration


def tracking_frame(seed=0, p=BENCH_P, height=BENCH_H, width=BENCH_W,
                   device="cuda") -> TrackingScene:
    """The JAX package's tracking benchmark (``bench_tracking.py``): the
    model of :func:`mapping_model` with ``p`` Gaussians, the target frame
    rendered at the identity pose, the instance budget 1.1x its instance
    count (rounded up to 1024), the start pose ``apply_twist(I,
    TRACKING_XI)``, and the record configuration (Gauss-Newton, 2
    full-resolution and 3 half-resolution iterations, frozen binning with a
    2 px margin, deferred accept)."""
    model = mapping_model(seed=seed, p=p, device=device)
    cam = bench_camera(height=height, width=width, device=device)
    cfg = RasterConfig(tile_h=32, tile_w=32)
    with torch.no_grad():
        gt = render_model(model, cam, cfg)
    cfg = cfg.replace(max_instances=int(
        -(-int(gt.num_rendered) * 1.1 // 1024) * 1024))
    view0 = apply_twist(cam.viewmatrix, torch.tensor(
        TRACKING_XI, dtype=torch.float32, device=device))
    tcfg = TrackingConfig(method="gn", iters=2, freeze_binning=True,
                          bin_margin_px=2.0, line_search=False, pyramid=2,
                          coarse_iters=3)
    return TrackingScene(model, cam, cfg, Frame(gt.color, gt.depth[0]),
                         view0, tcfg)
