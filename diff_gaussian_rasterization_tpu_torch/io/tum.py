"""TUM RGB-D dataset reader with timestamp association (PyTorch port of
the JAX package's ``io/tum.py``).

Layout: ``<scene>/rgb.txt``, ``depth.txt``, ``groundtruth.txt`` (timestamp,
then a file or a pose).  Depth is 16-bit PNG scaled by 5000; ground-truth
poses are tx ty tz qx qy qz qw (c2w).  Association is the standard
nearest-timestamp rule with a largest difference of 0.02 s.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from ..camera import Camera
from ..models.slam import Frame
from .replica import _decode, _template

# freiburg1 / freiburg2 / freiburg3 default pinhole intrinsics
TUM_INTRINSICS = {
    1: dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3),
    2: dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7),
    3: dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6),
}


def _read_list(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def _associate(a, b, max_dt=0.02):
    """Nearest-timestamp association (TUM associate.py semantics)."""
    bi = 0
    pairs = []
    bts = [t for t, _ in b]
    for i, (ta, _) in enumerate(a):
        while bi + 1 < len(bts) and abs(bts[bi + 1] - ta) <= abs(bts[bi] - ta):
            bi += 1
        if abs(bts[bi] - ta) <= max_dt:
            pairs.append((i, bi))
    return pairs


def quat_to_mat(qx, qy, qz, qw):
    r, x, y, z = qw, qx, qy, qz
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
    ])


@dataclasses.dataclass
class TUMDataset:
    root: str
    freiburg: int = 1
    depth_scale: float = 5000.0
    height: int = 480
    width: int = 640
    stride: int = 1
    max_dt: float = 0.02
    fx: float = None  # override the freiburg defaults (e.g. test fixtures)
    fy: float = None
    # cx/cy are kept but do not affect rendering: the projection is
    # principal-point-centered, like the reference's ndc2Pix
    cx: float = None
    cy: float = None
    device: str = "cuda"  # where frame() and iteration put the frames

    def __post_init__(self):
        rgb = _read_list(os.path.join(self.root, "rgb.txt"))
        depth = _read_list(os.path.join(self.root, "depth.txt"))
        gt = _read_list(os.path.join(self.root, "groundtruth.txt"))
        rd = _associate(rgb, depth, self.max_dt)
        rg = dict(_associate(rgb, gt, self.max_dt))
        self.items: List[Tuple[str, str, np.ndarray]] = []
        for ri, di in rd:
            if ri not in rg:
                continue
            tx, ty, tz, qx, qy, qz, qw = map(float, gt[rg[ri]][1][:7])
            c2w = np.eye(4)
            c2w[:3, :3] = quat_to_mat(qx, qy, qz, qw)
            c2w[:3, 3] = (tx, ty, tz)
            self.items.append((
                os.path.join(self.root, rgb[ri][1][0]),
                os.path.join(self.root, depth[di][1][0]),
                c2w,
            ))
        self.items = self.items[:: self.stride]
        intr = TUM_INTRINSICS[self.freiburg]
        self.fx = self.fx if self.fx is not None else intr["fx"]
        self.fy = self.fy if self.fy is not None else intr["fy"]
        self.cx = self.cx if self.cx is not None else intr["cx"]
        self.cy = self.cy if self.cy is not None else intr["cy"]

    def __len__(self):
        return len(self.items)

    def camera_template(self, viewmatrix=None) -> Camera:
        return _template(self.fx, self.fy, self.height, self.width,
                         viewmatrix, self.device)

    def pose(self, i) -> np.ndarray:
        _, _, c2w = self.items[i]
        return np.linalg.inv(c2w).T.astype(np.float32)

    def frame(self, i) -> Frame:
        rgb_p, depth_p, _ = self.items[i]
        return _decode(rgb_p, depth_p, self.depth_scale, self.device)

    def __iter__(self):
        for i in range(len(self)):
            yield self.pose(i), self.frame(i)
