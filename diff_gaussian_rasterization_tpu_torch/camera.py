"""Camera model (PyTorch port of the JAX package's ``camera.py``).

One dataclass carries the world-to-camera ``viewmatrix`` and the static
intrinsics; the perspective and full projection matrices are derived from
them, so autograd through the projection reaches the view matrix.

Matrix convention: every 4x4 matrix is the *transpose* of the usual
column-vector transform, i.e. points transform as row vectors::

    p_view = [p, 1] @ viewmatrix
    p_hom  = [p, 1] @ projmatrix
    projmatrix = viewmatrix @ perspective
"""

from __future__ import annotations

import dataclasses

import torch


def perspective_matrix(tanfovx, tanfovy, znear=0.01, zfar=100.0,
                       dtype=torch.float32, device="cuda"):
    """3DGS-style symmetric perspective matrix, row-vector convention."""
    p = torch.zeros((4, 4), dtype=dtype, device=device)
    p[0, 0] = 1.0 / tanfovx
    p[1, 1] = 1.0 / tanfovy
    # column-vector K[2,2], K[2,3], K[3,2] transposed into row convention
    p[2, 2] = zfar / (zfar - znear)
    p[3, 2] = -(zfar * znear) / (zfar - znear)
    p[2, 3] = 1.0
    return p


def look_at(eye, target, up=(0.0, 1.0, 0.0), dtype=torch.float32,
            device="cuda"):
    """World-to-camera matrix (row-vector convention) from eye to target."""
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    eye, target, up = as_t(eye), as_t(target), as_t(up)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    cup = torch.linalg.cross(fwd, right)
    rot = torch.stack([right, cup, fwd])  # (3,3): camera axes in world
    w2c = torch.eye(4, dtype=dtype, device=device)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ eye
    return w2c.T.contiguous()  # row-vector convention


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera.  ``viewmatrix`` is the only differentiable field."""

    viewmatrix: torch.Tensor  # (4,4) w2c in row-vector convention
    tanfovx: float
    tanfovy: float
    height: int
    width: int
    znear: float = 0.01
    zfar: float = 100.0

    @classmethod
    def from_intrinsics(cls, viewmatrix, fx, fy, height, width, **kw):
        return cls(viewmatrix=viewmatrix, tanfovx=width / (2.0 * fx),
                   tanfovy=height / (2.0 * fy), height=height, width=width,
                   **kw)

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tanfovy)

    @property
    def perspective(self):
        return perspective_matrix(self.tanfovx, self.tanfovy, self.znear,
                                  self.zfar, dtype=self.viewmatrix.dtype,
                                  device=self.viewmatrix.device)

    @property
    def projmatrix(self):
        """Full view*projection product, computed from the live view."""
        return self.viewmatrix @ self.perspective

    @property
    def campos(self):
        """Camera center in world coordinates."""
        v = self.viewmatrix
        return -v[:3, :3] @ v[3, :3]
