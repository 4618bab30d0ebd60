"""Replica RGB-D dataset reader and trajectory metrics (PyTorch port of
the JAX package's ``io/replica.py``).

Layout (Replica as distributed for NICE-SLAM/CG-SLAM evaluation)::

    <scene>/results/frame000000.jpg   RGB frames
    <scene>/results/depth000000.png   16-bit depth (depth_scale 6553.5)
    <scene>/traj.txt                  one flattened 4x4 c2w matrix per line

Camera intrinsics come from the dataset's ``cam_params.json`` or the caller.
Poses are numpy row-convention view matrices (w2c transposed); frames are
the port's ``Frame`` of tensors on the device the caller names.  PIL is
imported only when a frame is decoded.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Iterator

import numpy as np
import torch

from ..camera import Camera
from ..models.slam import Frame


def _decode(rgb_path, depth_path, depth_scale, device) -> Frame:
    """An RGB image and a 16-bit depth PNG as a ``Frame`` on ``device``."""
    from PIL import Image
    rgb = np.asarray(Image.open(rgb_path), np.float32) / 255.0
    depth = np.asarray(Image.open(depth_path), np.float32) / depth_scale
    return Frame(rgb=torch.as_tensor(rgb.transpose(2, 0, 1).copy(),
                                     device=device),
                 depth=torch.as_tensor(depth, device=device))


def _template(fx, fy, height, width, viewmatrix, device) -> Camera:
    if viewmatrix is None:
        viewmatrix = torch.eye(4, dtype=torch.float32, device=device)
    return Camera.from_intrinsics(viewmatrix, fx=fx, fy=fy, height=height,
                                  width=width)


@dataclasses.dataclass
class ReplicaDataset:
    root: str
    depth_scale: float = 6553.5
    fx: float = 600.0
    fy: float = 600.0
    cx: float = 599.5
    cy: float = 339.5
    height: int = 680
    width: int = 1200
    stride: int = 1
    device: str = "cuda"  # where frame() and iteration put the frames

    def __post_init__(self):
        self.rgb_paths = sorted(
            glob.glob(os.path.join(self.root, "results", "frame*.jpg"))
        )[:: self.stride]
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.root, "results", "depth*.png"))
        )[:: self.stride]
        traj = np.loadtxt(os.path.join(self.root, "traj.txt"))
        self.c2w = traj.reshape(-1, 4, 4)[:: self.stride]
        cam_json = os.path.join(self.root, "..", "cam_params.json")
        if os.path.exists(cam_json):
            with open(cam_json) as f:
                c = json.load(f)["camera"]
            self.fx, self.fy = c["fx"], c["fy"]
            self.cx, self.cy = c["cx"], c["cy"]
            self.height, self.width = c["h"], c["w"]
            self.depth_scale = c.get("scale", self.depth_scale)

    def __len__(self):
        return len(self.rgb_paths)

    def camera_template(self, viewmatrix=None) -> Camera:
        return _template(self.fx, self.fy, self.height, self.width,
                         viewmatrix, self.device)

    def pose(self, i) -> np.ndarray:
        """Ground-truth w2c view matrix, row convention."""
        w2c = np.linalg.inv(self.c2w[i])
        return w2c.T.astype(np.float32)

    def frame(self, i) -> Frame:
        return _decode(self.rgb_paths[i], self.depth_paths[i],
                       self.depth_scale, self.device)

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self.pose(i), self.frame(i)


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _centers(views) -> np.ndarray:
    """Camera centers from row-convention w2c view matrices:
    c = -R^{-1} t with R = V[:3,:3]^T (so R^{-1} = V[:3,:3])."""
    out = []
    for v in views:
        v = _numpy(v)
        out.append(-(v[:3, :3] @ v[3, :3]))
    return np.stack(out)


def ate_rmse(est_views, gt_views) -> float:
    """Absolute trajectory error: RMSE of the camera centers, with no
    alignment (SLAM with a known first pose)."""
    err = _centers(est_views) - _centers(gt_views)
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def ate_rmse_aligned(est_views, gt_views) -> float:
    """ATE RMSE after the closed-form SE(3) (Umeyama, no scale) alignment
    of the estimated trajectory to ground truth (the evo / TUM-benchmark
    convention)."""
    est = _centers(est_views)
    gt = _centers(gt_views)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    cov = (gt - mu_g).T @ (est - mu_e) / len(est)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    rot = u @ s @ vt
    err = (est - mu_e) @ rot.T + mu_g - gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))
