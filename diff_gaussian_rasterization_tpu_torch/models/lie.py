"""SE(3) utilities for pose optimization (PyTorch port of the JAX package's
``models/lie.py``).

A pose update is a twist ``xi = (v, w)`` in R^6 applied to a base pose,
``w2c(xi) = exp(xi^) @ w2c_0``; tracking optimizes ``xi``.  Every function
is written without in-place writes, so ``torch.func.jacfwd`` and
``torch.func.vmap`` go through it: the twist basis of the view matrix is
``jacfwd(lambda x: apply_twist(view0, x))(xi)``, [4, 4, 6], which the
tracker takes in closed form
(``ops/kernels/gauss_newton.py::twist_tangents``).

All public functions speak the package's row-vector convention (matrices
are transposed w2c transforms; see ``camera.py``).
"""

from __future__ import annotations

import torch


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], -1),
        torch.stack([wz, zeros, -wx], -1),
        torch.stack([-wy, wx, zeros], -1),
    ], -2)


def _rot_coeffs(w):
    """Taylor-safe (a, b, c) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3).

    Differentiable at w = 0: the double-``where`` guard never takes the
    square root of a (near-)zero ``t2 = |w|^2`` (its derivative there is
    infinite and 0/0 slopes give NaN), and routes the small case through
    polynomials in ``t2`` instead.
    """
    t2 = (w * w).sum()
    small = t2 < 1e-12
    t2s = torch.where(small, torch.ones_like(t2), t2)  # safe sqrt argument
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    return a, b, c


def exp_so3(w):
    """Rodrigues: (3,) rotation vector -> (3, 3) rotation matrix."""
    a, b, _ = _rot_coeffs(w)
    k = hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * k + b * (k @ k)


def exp_se3(xi):
    """(6,) twist (v, w) -> (4, 4) rigid transform (column-vector
    convention)."""
    v, w = xi[:3], xi[3:]
    k = hat(w)
    rot = exp_so3(w)
    _, b, c = _rot_coeffs(w)
    vmat = torch.eye(3, dtype=xi.dtype, device=xi.device) + b * k + c * (k @ k)
    top = torch.cat([rot, (vmat @ v)[:, None]], 1)
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype,
                        device=xi.device)
    return torch.cat([top, last], 0)


def apply_twist(viewmatrix, xi):
    """Left-apply a twist to a row-convention view matrix:
    ``w2c' = exp(xi) @ w2c``, so ``V' = V @ exp(xi)^T``."""
    return viewmatrix @ exp_se3(xi).T


def quat_mul(a, b):
    """Hamilton product of (..., 4) quaternions in (r, x, y, z) order."""
    ar, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    br, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        ar * br - ax * bx - ay * by - az * bz,
        ar * bx + ax * br + ay * bz - az * by,
        ar * by - ax * bz + ay * br + az * bx,
        ar * bz + ax * by - ay * bx + az * br,
    ], -1)


def quat_from_rotmat(m):
    """(..., 3, 3) rotation matrix -> (..., 4) unit quaternion (r, x, y, z).

    Branch-free Shepperd selection: one candidate quaternion per dominant
    component (each valid when its pivot is the largest), the candidate of
    the largest pivot taken, so it vectorizes over leading axes.
    """
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qr = torch.stack([1.0 + tr,
                      m[..., 2, 1] - m[..., 1, 2],
                      m[..., 0, 2] - m[..., 2, 0],
                      m[..., 1, 0] - m[..., 0, 1]], -1)
    qx = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                      1.0 + m00 - m11 - m22,
                      m[..., 0, 1] + m[..., 1, 0],
                      m[..., 0, 2] + m[..., 2, 0]], -1)
    qy = torch.stack([m[..., 0, 2] - m[..., 2, 0],
                      m[..., 0, 1] + m[..., 1, 0],
                      1.0 - m00 + m11 - m22,
                      m[..., 1, 2] + m[..., 2, 1]], -1)
    qz = torch.stack([m[..., 1, 0] - m[..., 0, 1],
                      m[..., 0, 2] + m[..., 2, 0],
                      m[..., 1, 2] + m[..., 2, 1],
                      1.0 - m00 - m11 + m22], -1)
    pivots = torch.stack([tr, m00, m11, m22], -1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.stack([qr, qx, qy, qz], -2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(q, -2, idx)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def orthonormalize_view(viewmatrix):
    """Project the rotation block of a row-convention view matrix back onto
    SO(3) (for direct-matrix optimization, which drifts off the
    manifold)."""
    r = viewmatrix[:3, :3].T  # the actual w2c rotation
    u, _, vt = torch.linalg.svd(r)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    r_on = u @ torch.diag(torch.stack([one, one, det])) @ vt
    top = torch.cat([r_on.T, viewmatrix[:3, 3:]], 1)
    return torch.cat([top, viewmatrix[3:]], 0)
