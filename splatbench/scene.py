"""The benchmark's scenes and camera paths, made from the seed.

A frozen copy, rewritten for the device, of the Replica-class procedural
room and the SLAM-style walkthrough that the program's synthetic data uses:
textured walls, floor and ceiling plus furniture boxes as jittered grids of
isotropic splats (size ~ grid spacing, so surfaces are watertight), and a
camera that moves on a slow orbit with rotation-heavy pans.

What sets the amount of work (the room's layout: its boxes, their sizes and
the texture frequencies; the camera path) comes from the configuration's
``layout_seed``, so every ``--seed`` renders the same sizes; ``--seed``
draws the jitter, the colours, the map's departure from the scene and the
sensor noise on the device, in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import SH_C0


def _plane_specs(wall_res: int, n_boxes: int, extent, rng):
    """(origin, u, v, nu, nv, base colour, frequencies) of every textured
    plane of the room, in the program's order."""
    ex, ey, ez = extent
    wr = wall_res
    hr = max(8, int(wr * ey / max(ex, ez)) * 2)
    specs = [
        ([-ex, ey, -ez], [2 * ex, 0, 0], [0, 0, 2 * ez], wr, wr,
         [0.55, 0.45, 0.35], rng.uniform(1, 4, 4)),
        ([-ex, -ey, -ez], [2 * ex, 0, 0], [0, 0, 2 * ez], wr, wr,
         [0.75, 0.75, 0.72], rng.uniform(1, 3, 4)),
        ([-ex, -ey, ez], [2 * ex, 0, 0], [0, 2 * ey, 0], wr, hr,
         [0.70, 0.62, 0.50], rng.uniform(2, 5, 4)),
        ([-ex, -ey, -ez], [2 * ex, 0, 0], [0, 2 * ey, 0], wr, hr,
         [0.52, 0.60, 0.68], rng.uniform(2, 5, 4)),
        ([-ex, -ey, -ez], [0, 0, 2 * ez], [0, 2 * ey, 0], wr, hr,
         [0.62, 0.55, 0.60], rng.uniform(2, 5, 4)),
        ([ex, -ey, -ez], [0, 0, 2 * ez], [0, 2 * ey, 0], wr, hr,
         [0.58, 0.66, 0.55], rng.uniform(2, 5, 4)),
    ]
    br = max(10, wr // 4)
    for _ in range(n_boxes):
        cx = rng.uniform(-ex * 0.6, ex * 0.6)
        cz = rng.uniform(-ez * 0.6, ez * 0.6)
        w2 = rng.uniform(0.15, 0.45)
        d2 = rng.uniform(0.15, 0.45)
        h = rng.uniform(0.4, 1.4)
        base = rng.uniform(0.15, 0.85, 3)
        fr = rng.uniform(2, 8, 4)
        y0, y1 = ey, ey - h
        specs += [
            ([cx - w2, y1, cz - d2], [2 * w2, 0, 0], [0, 0, 2 * d2], br, br,
             base, fr),
            ([cx - w2, y1, cz - d2], [2 * w2, 0, 0], [0, y0 - y1, 0], br, br,
             base * 0.9, fr),
            ([cx - w2, y1, cz + d2], [2 * w2, 0, 0], [0, y0 - y1, 0], br, br,
             base * 0.8, fr),
            ([cx - w2, y1, cz - d2], [0, 0, 2 * d2], [0, y0 - y1, 0], br, br,
             base * 0.85, fr),
            ([cx + w2, y1, cz - d2], [0, 0, 2 * d2], [0, y0 - y1, 0], br, br,
             base * 0.75, fr),
        ]
    return specs


def room_size(scene: dict) -> int:
    """The number of Gaussians the room of ``scene`` holds."""
    rng = np.random.default_rng(scene["layout_seed"])
    return sum(s[3] * s[4] for s in _plane_specs(
        scene["wall_res"], scene["n_boxes"], scene["extent"], rng))


def room(scene: dict, seed: int, device) -> dict:
    """The room's Gaussians as map fields (``means3D``, ``scales_log``,
    ``rotations``, ``opacities_logit``, ``sh`` degree 0, ``active``),
    ``capacity`` slots with the room in the first ones."""
    rng = np.random.default_rng(scene["layout_seed"])
    specs = _plane_specs(scene["wall_res"], scene["n_boxes"],
                         scene["extent"], rng)
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    counts = [s[3] * s[4] for s in specs]
    n = sum(counts)
    plane = torch.repeat_interleave(torch.arange(len(specs), device=device),
                                    torch.tensor(counts, device=device))
    tab = lambda k: torch.tensor(np.asarray([np.asarray(s[k], np.float64)
                                             for s in specs]), **f32)[plane]
    origin, u_vec, v_vec, base, fr = tab(0), tab(1), tab(2), tab(5), tab(6)
    nu = torch.tensor([s[3] for s in specs], **f32)[plane]
    nv = torch.tensor([s[4] for s in specs], **f32)[plane]
    first = torch.tensor(np.cumsum([0] + counts[:-1]), device=device)[plane]
    k = torch.arange(n, device=device) - first
    iu = (k % nu.long()).to(torch.float32)
    iv = torch.div(k, nu.long(), rounding_mode="floor").to(torch.float32)
    uu = iu / torch.clamp_min(nu - 1, 1)
    vv = iv / torch.clamp_min(nv - 1, 1)
    jit = torch.rand((n, 2), generator=gen, **f32) * 0.6 - 0.3
    p = origin + (uu + jit[:, 0] / nu)[:, None] * u_vec \
        + (vv + jit[:, 1] / nv)[:, None] * v_vec
    two_pi = 2 * math.pi
    tex = (0.30 * torch.sin(two_pi * fr[:, 0] * uu + fr[:, 2])
           * torch.cos(two_pi * fr[:, 1] * vv + fr[:, 3])
           + 0.18 * torch.sin(two_pi * 3.7 * fr[:, 0] * uu + 1.3)
           + 0.12 * torch.cos(two_pi * 4.3 * fr[:, 1] * vv + 0.7))
    col = torch.clamp(base * (0.65 + 0.35 * tex[:, None])
                      + 0.02 * torch.randn((n, 3), generator=gen, **f32),
                      0.02, 0.98)
    spacing = torch.maximum(torch.linalg.norm(u_vec, dim=1) / nu,
                            torch.linalg.norm(v_vec, dim=1) / nv)
    cap = scene.get("capacity") or int(-(-n // 1024) * 1024)
    if cap < n:
        raise ValueError(f"capacity {cap} is below the room's {n} Gaussians")
    out = dict(
        means3D=torch.zeros((cap, 3), **f32),
        scales_log=torch.full((cap, 3), -5.0, **f32),
        rotations=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(cap, 1),
        opacities_logit=torch.full((cap, 1), math.log(0.92 / 0.08), **f32),
        sh=torch.zeros((cap, 1, 3), **f32),
        active=torch.arange(cap, device=device) < n)
    out["means3D"][:n] = p
    out["scales_log"][:n] = torch.log(spacing * 0.62)[:, None]
    out["sh"][:n, 0] = (col - 0.5) / SH_C0
    return out


def perturbed(fields: dict, scene: dict, seed: int) -> dict:
    """A map that departs from the scene as a map in the middle of
    mapping does: positions, sizes, orientations, opacities and colours
    moved by seeded noise (``scene["map_noise"]``), so every field has a
    gradient."""
    dev = fields["means3D"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    nz = scene["map_noise"]
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    act = fields["active"][:, None].float()
    spacing = torch.exp(fields["scales_log"][:, :1]) / 0.62
    out = dict(fields)
    out["means3D"] = fields["means3D"] + act * nz["position"] * spacing \
        * rnd(fields["means3D"].shape)
    out["scales_log"] = fields["scales_log"] + act * nz["log_scale"] \
        * rnd(fields["scales_log"].shape)
    rot = fields["rotations"] + act * nz["rotation"] \
        * rnd(fields["rotations"].shape)
    out["rotations"] = rot / torch.linalg.norm(rot, dim=1, keepdim=True)
    out["opacities_logit"] = fields["opacities_logit"] + act \
        * nz["opacity_logit"] * rnd(fields["opacities_logit"].shape)
    out["sh"] = fields["sh"] + act[:, :, None] * nz["color"] / SH_C0 \
        * rnd(fields["sh"].shape)
    return out


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera matrix, row-vector convention, float64."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    cup = np.cross(fwd, right)
    rot = np.stack([right, cup, fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ eye
    return w2c.T


def walkthrough(n_frames: int, layout_seed: int, extent) -> np.ndarray:
    """[n_frames, 4, 4] float64 camera path inside the room: a slow orbit
    (a full circuit in ~250 moving frames, ~0.02 m a frame) interleaved
    with rotation-dominant pans (eye fixed, gaze turning 0.02-0.04 rad a
    frame), segments of 12-27 frames."""
    rng = np.random.default_rng(layout_seed)
    ex, ey, ez = extent
    orbit_rate = 2 * np.pi / 250.0
    pan = np.zeros(n_frames, bool)
    gaze_rate = np.zeros(n_frames)
    i = 0
    while i < n_frames:
        seg = int(rng.integers(12, 28))
        if rng.uniform() < 0.4:
            pan[i:i + seg] = True
            gaze_rate[i:i + seg] = rng.uniform(0.02, 0.04) * rng.choice(
                [-1, 1])
        else:
            gaze_rate[i:i + seg] = rng.uniform(0.004, 0.012) * rng.choice(
                [-1, 1])
        i += seg
    theta = np.cumsum(np.where(pan, 0.0, orbit_rate))
    eyes = np.stack([0.45 * ex * np.cos(theta), 0.1 * ey * np.sin(2 * theta),
                     0.45 * ez * np.sin(theta)], -1)
    gaze = rng.uniform(0, 2 * np.pi) + np.cumsum(gaze_rate)
    return np.stack([look_at(eyes[k], eyes[k] + np.asarray(
        [np.sin(gaze[k]), 0.15 * np.sin(gaze[k] * 0.7), np.cos(gaze[k])]))
        for k in range(n_frames)])


def predicted(prev2: np.ndarray, prev1: np.ndarray) -> np.ndarray:
    """The constant-velocity prediction ``X1 X2^-1 X1`` (row convention)
    with its rotation projected back onto SO(3)."""
    x = prev1 @ np.linalg.inv(prev2) @ prev1
    u, _, vt = np.linalg.svd(x[:3, :3].T)
    r = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    x[:3, :3] = r.T
    return x
