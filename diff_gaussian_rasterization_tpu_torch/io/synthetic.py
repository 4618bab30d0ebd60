"""Synthetic RGB-D sequences for tests and benchmarks (PyTorch port of the
JAX package's ``io/synthetic.py``).

A ground-truth Gaussian scene is rendered along a smooth camera trajectory,
which gives exact poses and depths without any data on disk.  The scenes
and trajectories are built on the host in numpy, with the JAX version's
``np.random.RandomState`` draws in the same order, and then moved to the
device, so they are the same on every device:

- the models' means, colors (as SH DC), rotations, opacities and active
  masks are bit-equal to the JAX package's; ``scales_log`` is the
  correctly rounded float32 log of the float32 scale (XLA:CPU's float32
  log, which the JAX package uses, is not correctly rounded: about one
  value in ten differs from it by one ulp);
- the trajectories are :func:`camera.look_at`'s on the CPU in float32;
  XLA:CPU fuses multiply-adds in the JAX package's ``look_at``, so a few
  entries differ from its trajectories by an ulp.

``render_sequence`` renders through the port's ``render_model`` on the
model's device; its sensor noise is numpy's, as in the JAX version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera, look_at
from ..config import RasterConfig
from ..convert import gaussian_model_from_numpy
from ..models.gaussians import GaussianModel, _logit
from ..models.slam import Frame, render_model
from ..ops.sh import SH_C0

_F32 = np.float32


def _views(views, dtype, device):
    return torch.stack(views).to(dtype=dtype, device=device)


def _model(capacity, means, colors, scales, opacity, rotations=None,
           device="cuda", dtype=torch.float32) -> GaussianModel:
    """``init_model(capacity, sh_degree=0, means=, colors=, scales=,
    opacity=)`` of the JAX package, built in numpy float32."""
    n = means.shape[0]
    f = lambda a: np.asarray(a, _F32)
    fields = dict(
        means3D=np.zeros((capacity, 3), _F32),
        scales_log=np.full((capacity, 3), -5.0, _F32),
        rotations=np.tile(np.asarray([1, 0, 0, 0], _F32), (capacity, 1)),
        opacities_logit=np.full((capacity, 1), _logit(opacity), _F32),
        sh=np.zeros((capacity, 1, 3), _F32),
        active=np.arange(capacity) < n)
    fields["means3D"][:n] = f(means)
    fields["sh"][:n, 0] = (f(colors) - _F32(0.5)) / _F32(SH_C0)
    fields["scales_log"][:n] = np.log(
        f(scales).astype(np.float64)).astype(_F32)
    if rotations is not None:
        fields["rotations"][:n] = f(rotations)
    return gaussian_model_from_numpy(fields, device=device, dtype=dtype)


def random_room_model(capacity=4096, n=2048, seed=0, extent=2.0,
                      dtype=torch.float32, device="cuda") -> GaussianModel:
    """A box 'room' of Gaussians around the origin."""
    rng = np.random.RandomState(seed)
    # points on the walls of a box plus interior clutter
    walls = rng.uniform(-extent, extent, (n, 3))
    face = rng.randint(0, 6, n)
    axis = face // 2
    sign = (face % 2) * 2 - 1
    walls[np.arange(n), axis] = sign * extent
    clutter = rng.uniform(-extent * 0.7, extent * 0.7, (n // 4, 3))
    pts = np.concatenate([walls[: n - n // 4], clutter])
    colors = rng.uniform(0.1, 0.9, (n, 3))
    scales = np.exp(rng.uniform(np.log(0.05), np.log(0.18), (n, 3)))
    rot = rng.normal(size=(n, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return _model(capacity, pts, colors, scales, 0.8, rotations=rot,
                  device=device, dtype=dtype)


def orbit_trajectory(n_frames: int, radius=0.8, height=0.1,
                     dtype=torch.float32, device="cuda"):
    """Smooth orbit inside the room, looking at the +z wall region:
    [n_frames, 4, 4]."""
    views = []
    for i in range(n_frames):
        a = 0.35 * np.sin(2 * np.pi * i / max(n_frames, 1) * 0.5)
        eye = (radius * np.sin(a), height * np.cos(a * 2.0), -0.5 + 0.2 * a)
        target = (0.3 * np.sin(a * 0.7), 0.0, 2.0)
        views.append(look_at(eye, target, device="cpu"))
    return _views(views, dtype, device)


def replica_like_model(capacity=None, seed=0, extent=(2.0, 1.5, 2.5),
                       wall_res=56, n_boxes=6, dtype=torch.float32,
                       device="cuda") -> GaussianModel:
    """A Replica-class procedural room: textured walls/floor/ceiling plus
    furniture boxes for occlusion (regular grids with jitter, splat size
    ~ grid spacing so surfaces are watertight, multi-frequency color
    textures)."""
    rng = np.random.RandomState(seed)
    ex, ey, ez = extent
    pts, cols, scls = [], [], []

    def textured_plane(origin, u_vec, v_vec, nu, nv, base_color, fr):
        """Grid of splats spanning origin + [0,1]^2 * (u_vec, v_vec)."""
        uu, vv = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
        uu, vv = uu.ravel(), vv.ravel()
        ju = (rng.uniform(-0.3, 0.3, uu.shape)) / nu
        jv = (rng.uniform(-0.3, 0.3, vv.shape)) / nv
        p = (np.asarray(origin)[None]
             + (uu + ju)[:, None] * np.asarray(u_vec)[None]
             + (vv + jv)[:, None] * np.asarray(v_vec)[None])
        t = (0.30 * np.sin(2 * np.pi * fr[0] * uu + fr[2])
             * np.cos(2 * np.pi * fr[1] * vv + fr[3])
             + 0.18 * np.sin(2 * np.pi * 3.7 * fr[0] * uu + 1.3)
             + 0.12 * np.cos(2 * np.pi * 4.3 * fr[1] * vv + 0.7))
        c = np.clip(np.asarray(base_color)[None]
                    * (0.65 + 0.35 * t[:, None])
                    + rng.normal(scale=0.02, size=(len(uu), 3)), 0.02, 0.98)
        spacing = max(np.linalg.norm(u_vec) / nu,
                      np.linalg.norm(v_vec) / nv)
        s = np.full((len(uu), 3), spacing * 0.62)
        pts.append(p)
        cols.append(c)
        scls.append(s)

    wr = wall_res
    hr = max(8, int(wr * ey / max(ex, ez)) * 2)
    # floor (y = +ey) and ceiling (y = -ey)
    textured_plane([-ex, ey, -ez], [2 * ex, 0, 0], [0, 0, 2 * ez],
                   wr, wr, [0.55, 0.45, 0.35], rng.uniform(1, 4, 4))
    textured_plane([-ex, -ey, -ez], [2 * ex, 0, 0], [0, 0, 2 * ez],
                   wr, wr, [0.75, 0.75, 0.72], rng.uniform(1, 3, 4))
    # four walls
    textured_plane([-ex, -ey, ez], [2 * ex, 0, 0], [0, 2 * ey, 0],
                   wr, hr, [0.70, 0.62, 0.50], rng.uniform(2, 5, 4))
    textured_plane([-ex, -ey, -ez], [2 * ex, 0, 0], [0, 2 * ey, 0],
                   wr, hr, [0.52, 0.60, 0.68], rng.uniform(2, 5, 4))
    textured_plane([-ex, -ey, -ez], [0, 0, 2 * ez], [0, 2 * ey, 0],
                   wr, hr, [0.62, 0.55, 0.60], rng.uniform(2, 5, 4))
    textured_plane([ex, -ey, -ez], [0, 0, 2 * ez], [0, 2 * ey, 0],
                   wr, hr, [0.58, 0.66, 0.55], rng.uniform(2, 5, 4))

    # furniture: axis-aligned boxes on the floor (occluders)
    br = max(10, wr // 4)
    for _ in range(n_boxes):
        cx = rng.uniform(-ex * 0.6, ex * 0.6)
        cz = rng.uniform(-ez * 0.6, ez * 0.6)
        w2 = rng.uniform(0.15, 0.45)
        d2 = rng.uniform(0.15, 0.45)
        h = rng.uniform(0.4, 1.4)
        base = rng.uniform(0.15, 0.85, 3)
        fr = rng.uniform(2, 8, 4)
        y0, y1 = ey, ey - h  # sits on the floor
        # top + 4 sides
        textured_plane([cx - w2, y1, cz - d2], [2 * w2, 0, 0],
                       [0, 0, 2 * d2], br, br, base, fr)
        textured_plane([cx - w2, y1, cz - d2], [2 * w2, 0, 0],
                       [0, y0 - y1, 0], br, br, base * 0.9, fr)
        textured_plane([cx - w2, y1, cz + d2], [2 * w2, 0, 0],
                       [0, y0 - y1, 0], br, br, base * 0.8, fr)
        textured_plane([cx - w2, y1, cz - d2], [0, 0, 2 * d2],
                       [0, y0 - y1, 0], br, br, base * 0.85, fr)
        textured_plane([cx + w2, y1, cz - d2], [0, 0, 2 * d2],
                       [0, y0 - y1, 0], br, br, base * 0.75, fr)

    p = np.concatenate(pts)
    n = p.shape[0]
    if capacity is None:
        capacity = int(-(-n // 1024) * 1024)
    assert capacity >= n, (capacity, n)
    return _model(capacity, p, np.concatenate(cols), np.concatenate(scls),
                  0.92, device=device, dtype=dtype)


def walkthrough_trajectory(n_frames: int, seed=0, extent=(2.0, 1.5, 2.5),
                           rot_heavy=True, close_loop=False,
                           dtype=torch.float32, device="cuda"):
    """A SLAM-style walkthrough inside the room: smooth translation arcs
    interleaved with rotation-dominant pan segments (eye frozen, gaze
    moving).  ``close_loop=True`` scales the orbit speed so the eye
    completes one circuit within ``n_frames``.  [n_frames, 4, 4]."""
    rng = np.random.RandomState(seed)
    ex, ey, ez = extent
    # constant-angular-speed arc (~0.02 m/frame, a full loop in ~250
    # frames); the orbit angle advances only on non-pan frames
    orbit_rate = 2 * np.pi / 250.0
    pan = np.zeros(n_frames, bool)
    gaze_rate = np.zeros(n_frames)
    i = 0
    while i < n_frames:
        seg = rng.randint(12, 28)
        if rot_heavy and rng.uniform() < 0.4:
            pan[i:i + seg] = True
            gaze_rate[i:i + seg] = (rng.uniform(0.02, 0.04)
                                    * rng.choice([-1, 1]))
        else:
            gaze_rate[i:i + seg] = (rng.uniform(0.004, 0.012)
                                    * rng.choice([-1, 1]))
        i += seg
    if close_loop:
        n_move = max(int((~pan).sum()), 1)
        orbit_rate = 2 * np.pi / n_move
    theta = np.cumsum(np.where(pan, 0.0, orbit_rate))
    eyes = np.stack([0.45 * ex * np.cos(theta),
                     0.1 * ey * np.sin(2 * theta),
                     0.45 * ez * np.sin(theta)], -1)
    gaze_a = rng.uniform(0, 2 * np.pi) + np.cumsum(gaze_rate)
    views = []
    for k in range(n_frames):
        eye = eyes[k]
        target = eye + np.asarray([np.sin(gaze_a[k]),
                                   0.15 * np.sin(gaze_a[k] * 0.7),
                                   np.cos(gaze_a[k])])
        views.append(look_at(tuple(eye), tuple(target), device="cpu"))
    return _views(views, dtype, device)


def render_sequence(model: GaussianModel, views, cam_template: Camera,
                    cfg: RasterConfig, rgb_noise: float = 0.0,
                    depth_noise: float = 0.0, seed: int = 0):
    """Ground-truth RGB-D frames for every pose of ``views`` [N, 4, 4],
    rendered on the model's device.  ``rgb_noise`` / ``depth_noise`` add
    per-pixel sensor noise (std, in color units / relative to depth)."""
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(views.shape[0]):
        cam = Camera(viewmatrix=views[i], tanfovx=cam_template.tanfovx,
                     tanfovy=cam_template.tanfovy,
                     height=cam_template.height, width=cam_template.width)
        with torch.no_grad():
            out = render_model(model, cam, cfg)
        sil = out.opacity_map[0]
        # geometric depth: alpha-weighted mean depth / silhouette
        depth = out.depth[0] / torch.clamp_min(sil, 1e-6)
        depth = torch.where(sil > 0.5, depth, torch.zeros_like(depth))
        rgb = out.color
        noise = lambda scale, shape: torch.as_tensor(
            rng.normal(scale=scale, size=shape), dtype=rgb.dtype,
            device=rgb.device)
        if rgb_noise:
            rgb = torch.clamp(rgb + noise(rgb_noise, rgb.shape), 0.0, 1.0)
        if depth_noise:
            depth = torch.where(
                depth > 0, depth + noise(depth_noise, depth.shape) * depth,
                torch.zeros_like(depth))
        frames.append(Frame(rgb=rgb, depth=depth))
    return frames
