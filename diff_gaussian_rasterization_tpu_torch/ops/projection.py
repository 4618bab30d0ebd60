"""Per-Gaussian preprocessing: culling, projection, covariance, footprint.

PyTorch port of the JAX package's ``ops/projection.py``: one vectorized,
masked computation over the whole Gaussian set.  Its backward is plain
autograd, as the JAX version's is autodiff; the light-vs-full pose-branch
split is ``detach()`` on the view matrix in the branches the light variant
drops (2D covariance, SH view direction).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from ..config import RasterConfig
from . import sh as sh_mod


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all shape (P, ...))."""

    mask: torch.Tensor          # (P,) bool: survives culling, has footprint
    depth: torch.Tensor         # (P,) view-space z (mean & pose gradient)
    depth_sgview: torch.Tensor  # (P,) same value, pose gradient stopped
    xy: torch.Tensor            # (P, 2) pixel-space center
    conic: torch.Tensor         # (P, 3) inverse 2D covariance (A, B, C)
    color: torch.Tensor         # (P, 3) RGB (from SH or precomputed)
    opacity: torch.Tensor       # (P,) raw opacity
    radius: torch.Tensor        # (P,) int32 pixel radius (0 where masked)
    rect_min: torch.Tensor      # (P, 2) int32 (tx, ty) inclusive tile bounds
    rect_max: torch.Tensor      # (P, 2) int32 exclusive tile bounds
    tiles_touched: torch.Tensor  # (P,) int32


def quat_to_rotmat(q):
    """(P,4) quaternion (r,x,y,z) -> (P,3,3) rotation matrix (unnormalized
    quaternions are used as given)."""
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack(
        [
            torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
                         2.0 * (x * z + r * y)], -1),
            torch.stack([2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
                         2.0 * (y * z - r * x)], -1),
            torch.stack([2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
                         1.0 - 2.0 * (x * x + y * y)], -1),
        ],
        -2,
    )


def compute_cov3d(scales, quats, scale_modifier, normalize_quaternions=False):
    """(P,3) scales + (P,4) quats -> (P,6) packed world covariance
    Sigma = R diag(s^2) R^T as (xx, xy, xz, yy, yz, zz)."""
    if normalize_quaternions:
        quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    s = scales * scale_modifier
    m = quat_to_rotmat(quats) * s[:, None, :]  # R @ diag(s)
    sigma = m @ m.transpose(-1, -2)
    return torch.stack(
        [sigma[:, 0, 0], sigma[:, 0, 1], sigma[:, 0, 2],
         sigma[:, 1, 1], sigma[:, 1, 2], sigma[:, 2, 2]], -1)


def unpack_cov3d(cov6):
    """(P,6) packed -> (P,3,3) symmetric."""
    xx, xy, xz, yy, yz, zz = (cov6[:, i] for i in range(6))
    return torch.stack(
        [torch.stack([xx, xy, xz], -1),
         torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)], -2)


def compute_cov2d(means, cov3d_packed, viewmatrix, focal_x, focal_y,
                  tanfovx, tanfovy, cfg: RasterConfig, valid=None):
    """EWA projection of the 3D covariance to screen space: view-space point
    clamped to ``fov_clamp * tanfov``, cov2D = J W Sigma W^T J^T plus the
    low-pass on the diagonal.  Returns (P,3) packed (a, b, c).  Culled
    Gaussians (``valid`` False) get view depth 1 so no inf/NaN reaches
    their gradients."""
    t = means @ viewmatrix[:3, :3] + viewmatrix[3, :3]
    tz = t[:, 2]
    if valid is not None:
        tz = torch.where(valid, tz, torch.ones_like(tz))
    limx = cfg.fov_clamp * tanfovx
    limy = cfg.fov_clamp * tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    zero = torch.zeros_like(tz)
    j0 = torch.stack([focal_x * inv_tz, zero, -focal_x * tx * inv_tz2], -1)
    j1 = torch.stack([zero, focal_y * inv_tz, -focal_y * ty * inv_tz2], -1)

    w = viewmatrix[:3, :3].T  # the actual w2c rotation
    m0 = j0 @ w
    m1 = j1 @ w

    sigma = unpack_cov3d(cov3d_packed)
    s_m0 = torch.einsum("pij,pj->pi", sigma, m0)
    s_m1 = torch.einsum("pij,pj->pi", sigma, m1)
    a = torch.einsum("pi,pi->p", m0, s_m0) + cfg.lowpass
    b = torch.einsum("pi,pi->p", m0, s_m1)
    c = torch.einsum("pi,pi->p", m1, s_m1) + cfg.lowpass
    return torch.stack([a, b, c], -1)


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def tile_rect(xy, radius_x, tiles_x, tiles_y, tile_w, tile_h, radius_y=None):
    """Tile-aligned bounding rectangle of a splat: inclusive min, exclusive
    max = floor(v / t) + 1 (the tile of the last covered pixel)."""
    if radius_y is None:
        radius_y = radius_x
    i32 = torch.int32
    rmin_x = torch.clamp(torch.floor((xy[:, 0] - radius_x) / tile_w),
                         0, tiles_x).to(i32)
    rmin_y = torch.clamp(torch.floor((xy[:, 1] - radius_y) / tile_h),
                         0, tiles_y).to(i32)
    rmax_x = torch.clamp(torch.floor((xy[:, 0] + radius_x) / tile_w) + 1,
                         0, tiles_x).to(i32)
    rmax_y = torch.clamp(torch.floor((xy[:, 1] + radius_y) / tile_h) + 1,
                         0, tiles_y).to(i32)
    return torch.stack([rmin_x, rmin_y], -1), torch.stack([rmax_x, rmax_y], -1)


def preprocess(means3D, camera: Camera, cfg: RasterConfig, *, opacities,
               scales=None, rotations=None, cov3D_precomp=None, shs=None,
               sh_degree: int = 0, colors_precomp=None,
               scale_modifier: float = 1.0, means2D=None) -> Preprocessed:
    """Vectorized per-Gaussian preprocessing.

    ``means2D`` is an optional (P, 2) offset in NDC units added to the
    projected centers; pass zeros to read screen-space position gradients
    from it (the densification signal).
    """
    view = camera.viewmatrix
    sg = view.detach()
    view_depth = view if cfg.pose_depth_branch else sg
    view_cov = view if cfg.pose_cov2d_branch else sg
    view_ndc = view if cfg.pose_ndc_branch else sg
    cam_ndc = camera.replace(viewmatrix=view_ndc)

    p_view_z = means3D @ view_depth[:3, 2] + view_depth[3, 2]
    p_view_z_sg = means3D @ sg[:3, 2] + sg[3, 2]
    visible = p_view_z > cfg.near

    # homogeneous divide, guarded for culled Gaussians
    pm = cam_ndc.projmatrix
    hom = means3D @ pm[:3, :] + pm[3, :]
    hom_w = torch.where(visible, hom[:, 3], torch.ones_like(hom[:, 3]))
    ndc = hom[:, :3] / (hom_w + cfg.w_eps)[:, None]

    if cov3D_precomp is not None:
        cov3d = cov3D_precomp
    else:
        cov3d = compute_cov3d(scales, rotations, scale_modifier,
                              cfg.normalize_quaternions)

    cov2d = compute_cov2d(means3D, cov3d, view_cov, camera.focal_x,
                          camera.focal_y, camera.tanfovx, camera.tanfovy,
                          cfg, valid=visible)
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, cfg.eig_clamp))
    radius = torch.ceil(cfg.radius_sigma * torch.sqrt(lam))

    if cfg.opacity_cull:
        # Bin with the exact alpha_min footprint: pixels where
        # opac * exp(power) < alpha_min can never contribute, so the
        # binning extents are the axis-aligned extents of that level
        # ellipse, cut * sqrt(cov_xx) and cut * sqrt(cov_yy) with
        # cut = sqrt(2 ln(opac / alpha_min)).  Rendered output is unchanged.
        op = opacities.detach().reshape(-1)
        ratio = op / cfg.alpha_min
        cut = torch.sqrt(2.0 * torch.log(torch.clamp_min(ratio, 1.0)))
        cut = torch.clamp_max(cut, cfg.radius_sigma)
        live = ratio > 1.0
        zero = torch.zeros_like(cut)
        # +1e-3 px guards the f32 extent rounding at the level set
        rx_bin = torch.where(live, torch.ceil(
            cut * torch.sqrt(torch.clamp_min(a, 0.0)) + 1e-3), zero)
        ry_bin = torch.where(live, torch.ceil(
            cut * torch.sqrt(torch.clamp_min(c, 0.0)) + 1e-3), zero)
    else:
        rx_bin = ry_bin = radius

    if cfg.bin_margin_px:
        # dilate live footprints only
        m = float(cfg.bin_margin_px)
        rx_bin = torch.where(rx_bin > 0, rx_bin + m, rx_bin)
        ry_bin = torch.where(ry_bin > 0, ry_bin + m, ry_bin)

    ndc_xy = ndc[:, :2] if means2D is None else ndc[:, :2] + means2D
    xy = torch.stack([ndc2pix(ndc_xy[:, 0], camera.width),
                      ndc2pix(ndc_xy[:, 1], camera.height)], -1)

    tiles_x = -(-camera.width // cfg.tile_w)
    tiles_y = -(-camera.height // cfg.tile_h)
    rect_min, rect_max = tile_rect(xy, rx_bin, tiles_x, tiles_y, cfg.tile_w,
                                   cfg.tile_h, radius_y=ry_bin)
    ext = rect_max - rect_min
    tiles_touched = ext[:, 0] * ext[:, 1]

    mask = visible & det_ok & (tiles_touched > 0)

    if colors_precomp is not None:
        color = colors_precomp
    else:
        campos = camera.campos if cfg.pose_sh_branch else \
            camera.campos.detach()
        color = sh_mod.eval_sh(shs, means3D - campos[None, :], sh_degree)

    tiles_touched = torch.where(mask, tiles_touched,
                                torch.zeros_like(tiles_touched))
    radius = torch.where(mask, radius, torch.zeros_like(radius)).to(
        torch.int32)

    return Preprocessed(
        mask=mask,
        depth=p_view_z,
        depth_sgview=p_view_z_sg,
        xy=xy,
        conic=conic,
        color=color,
        opacity=opacities.reshape(-1),
        radius=radius,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles_touched,
    )


def mark_visible(positions, viewmatrix, near=0.2):
    """Frustum-culling predicate: the near-plane-only test."""
    z = positions @ viewmatrix[:3, 2] + viewmatrix[3, 2]
    return z > near
