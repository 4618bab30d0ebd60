"""The render op's preprocess as one kernel pair: the projection forward and
its closed-form backward.

:func:`preprocess_table` computes what ``ops/projection.py::preprocess``
(the composite: vectorized torch, its backward plain autograd) computes,
and the render core's feature table ``[P, 11]`` with it, inside one
``torch.autograd.Function``:

- on CUDA tensors (float32) the kernels of ``csrc/preprocess.cu``:
  ``preprocess_fwd`` (one thread a Gaussian, in the composite's formulas)
  writes the table, the integer footprint and the mask;
  ``preprocess_bwd`` recomputes the forward's intermediates from the
  inputs and writes the closed-form gradients of every input that needs
  one, the view matrix's as per-block partial sums reduced in a fixed
  order (no float atomics: bit-reproducible);
- on CPU tensors (any float dtype) the plain versions: the composite
  under ``no_grad`` forward, and :func:`preprocess_bwd_reference`, the
  same closed form in plain torch.

It replaces no TPU kernel: the JAX package left the preprocess to XLA's
fusion.  The view matrix's gradient follows the composite's routing
under the four branch flags (``pose_depth_branch``, ``pose_ndc_branch``
through the projection matrix, ``pose_cov2d_branch``, ``pose_sh_branch``
through the camera position); the depth copy in column 10 never reaches
it.

:func:`preprocess_tangents` is the forward mode of the same composite
along K view-matrix directions, the per-Gaussian columns of the dual
render's tangent table (``rasterize.pose_jvp_tables``): on CUDA tensors
the ``preprocess_tangents`` kernel, on CPU tensors its plain version
:func:`preprocess_tangents_reference`, the same closed form in torch,
which the tests hold to the composite's ``torch.func`` forward mode.  The
Function itself has no forward-mode rule.

The wrappers here are where the render op chooses between a kernel and
its plain version, from the tensors' device; their callers never do.
``launches`` counts the kernels' launches, only where they launch.
"""

from __future__ import annotations

import ctypes

import torch

from ...camera import Camera
from ...config import RasterConfig
from .. import projection
from .. import sh as sh_mod
from .render import _check_cuda, tangent_columns

# the feature table's columns (``render.FEAT`` of them)
FEAT_COLUMNS = ("x", "y", "A", "B", "C", "opacity", "r", "g", "b", "depth",
                "depth_sgview")
# the integer footprint a Gaussian: radius, rect_min (x, y), rect_max (x,
# y), tiles_touched
INTS = 6
THREADS = 256  # threads of a preprocess block (csrc/preprocess.cu kThreads)
VIEW = 16      # floats of a block's partial view-matrix gradient

# flag bits of the kernels' integer parameters (csrc/preprocess.cu)
NORMALIZE_Q, OPACITY_CULL, COV_PRE, COL_PRE, MEANS2D = 1, 2, 4, 8, 16
POSE_DEPTH, POSE_NDC, POSE_COV, POSE_SH, WANT_VIEW = 32, 64, 128, 256, 512

launches = {"preprocess_fwd": 0, "preprocess_bwd": 0,
            "preprocess_tangents": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def feature_table(prep):
    """The per-Gaussian feature table [P, 11] the render core gathers."""
    return torch.cat(
        [prep.xy, prep.conic, prep.opacity[:, None], prep.color,
         prep.depth[:, None], prep.depth_sgview[:, None]], dim=1)


def unpack(feat, ints, mask) -> projection.Preprocessed:
    """The ``Preprocessed`` fields as views of the table [P, 11] and of the
    integer footprint [P, 6]."""
    return projection.Preprocessed(
        mask=mask, depth=feat[:, 9], depth_sgview=feat[:, 10],
        xy=feat[:, 0:2], conic=feat[:, 2:5], color=feat[:, 6:9],
        opacity=feat[:, 5], radius=ints[:, 0], rect_min=ints[:, 1:3],
        rect_max=ints[:, 3:5], tiles_touched=ints[:, 5])


def color_branch(cfg: RasterConfig, shs=None, sh_degree: int = 0,
                 colors_precomp=None, **_unused) -> bool:
    """Whether the pose tangents carry the SH colour branch: with
    ``cfg.pose_sh_branch``, colors from SH of degree 1 or more."""
    return bool(cfg.pose_sh_branch and colors_precomp is None
                and shs is not None and sh_degree >= 1)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def preprocess_fwd_reference(means3D, camera: Camera, cfg: RasterConfig,
                             **prep_kw):
    """Plain version of ``preprocess_fwd``: the composite under
    ``no_grad``; returns the table [P, 11], the integer footprint [P, 6]
    (int32) and the mask [P]."""
    with torch.no_grad():
        p = projection.preprocess(means3D, camera, cfg, **prep_kw)
        ints = torch.stack([p.radius, p.rect_min[:, 0], p.rect_min[:, 1],
                            p.rect_max[:, 0], p.rect_max[:, 1],
                            p.tiles_touched], 1).to(torch.int32)
        return feature_table(p), ints, p.mask


def _sh_basis(d, degree: int):
    """The real SH basis of ``sh.eval_sh`` at unit directions ``d`` [P, 3]:
    its values and their derivatives by x, y and z, lists of [P] tensors
    ((degree + 1)**2 of each)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    c0, c1, c2, c3 = sh_mod.SH_C0, sh_mod.SH_C1, sh_mod.SH_C2, sh_mod.SH_C3
    b = [(c0 * one, zero, zero, zero)]
    if degree > 0:
        b += [(-c1 * y, zero, -c1 * one, zero), (c1 * z, zero, zero, c1 * one),
              (-c1 * x, -c1 * one, zero, zero)]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        b += [(c2[0] * x * y, c2[0] * y, c2[0] * x, zero),
              (c2[1] * y * z, zero, c2[1] * z, c2[1] * y),
              (c2[2] * (2.0 * zz - xx - yy), -2.0 * c2[2] * x,
               -2.0 * c2[2] * y, 4.0 * c2[2] * z),
              (c2[3] * x * z, c2[3] * z, zero, c2[3] * x),
              (c2[4] * (xx - yy), 2.0 * c2[4] * x, -2.0 * c2[4] * y, zero)]
    if degree > 2:
        b += [(c3[0] * y * (3.0 * xx - yy), 6.0 * c3[0] * x * y,
               3.0 * c3[0] * (xx - yy), zero),
              (c3[1] * x * y * z, c3[1] * y * z, c3[1] * x * z,
               c3[1] * x * y),
              (c3[2] * y * (4.0 * zz - xx - yy), -2.0 * c3[2] * x * y,
               c3[2] * (4.0 * zz - xx - 3.0 * yy), 8.0 * c3[2] * y * z),
              (c3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
               -6.0 * c3[3] * x * z, -6.0 * c3[3] * y * z,
               c3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
              (c3[4] * x * (4.0 * zz - xx - yy),
               c3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * c3[4] * x * y,
               8.0 * c3[4] * x * z),
              (c3[5] * z * (xx - yy), 2.0 * c3[5] * x * z,
               -2.0 * c3[5] * y * z, c3[5] * (xx - yy)),
              (c3[6] * x * (xx - 3.0 * yy), 3.0 * c3[6] * (xx - yy),
               -6.0 * c3[6] * x * y, zero)]
    return b


def _sh_bwd(g, shs, dirs, degree: int):
    """``sh.eval_sh``'s VJP: the cotangent ``g`` [P, 3] of the colours to
    the coefficients [P, M, 3] and to the unnormalised directions [P, 3]."""
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    pos = norm > 0
    den = torch.where(pos, norm, torch.ones_like(norm))
    d = dirs / den
    basis = _sh_basis(d, degree)
    result = sum(bk[:, None] * shs[:, k] for k, (bk, *_) in enumerate(basis))
    g = torch.where(result + 0.5 >= 0, g, torch.zeros_like(g))
    d_sh = torch.zeros_like(shs)
    dd = torch.zeros_like(d)
    for k, (bk, bx, by, bz) in enumerate(basis):
        d_sh[:, k] = bk[:, None] * g
        dbk = (shs[:, k] * g).sum(-1)
        dd = dd + dbk[:, None] * torch.stack([bx, by, bz], -1)
    d_dirs = torch.where(pos, (dd - d * (d * dd).sum(-1, keepdim=True)) / den,
                         dd)
    return d_sh, d_dirs


def _cov3d_bwd(d_cov, scales, quats, scale_modifier: float,
               normalize: bool):
    """``projection.compute_cov3d``'s VJP: the packed covariance's
    cotangent [P, 6] to the scales [P, 3] and the quaternions [P, 4]."""
    q = quats
    if normalize:
        n = torch.linalg.norm(quats, dim=-1, keepdim=True)
        q = quats / n
    s = scales * scale_modifier
    rot = projection.quat_to_rotmat(q)
    m = rot * s[:, None, :]
    d0, d1, d2, d3, d4, d5 = d_cov.unbind(1)
    # Sigma = M M^T read at its upper triangle: dM = (dS + dS^T) M
    g = torch.stack([torch.stack([2.0 * d0, d1, d2], -1),
                     torch.stack([d1, 2.0 * d3, d4], -1),
                     torch.stack([d2, d4, 2.0 * d5], -1)], -2)
    dm = g @ m
    d_s = (dm * rot).sum(1)
    dr = dm * s[:, None, :]
    r, x, y, z = q.unbind(1)
    (r00, r01, r02), (r10, r11, r12), (r20, r21, r22) = (
        dr[:, i].unbind(1) for i in range(3))
    dq = 2.0 * torch.stack([
        -z * r01 + y * r02 + z * r10 - x * r12 - y * r20 + x * r21,
        y * r01 + z * r02 + y * r10 - 2.0 * x * r11 - r * r12 + z * r20
        + r * r21 - 2.0 * x * r22,
        -2.0 * y * r00 + x * r01 + r * r02 + x * r10 + z * r12 - r * r20
        + z * r21 - 2.0 * y * r22,
        -2.0 * z * r00 - r * r01 + x * r02 + r * r10 - 2.0 * z * r11
        + y * r12 + x * r20 + y * r21], 1)
    if normalize:
        dq = (dq - q * (q * dq).sum(1, keepdim=True)) / n
    return d_s * scale_modifier, dq


def preprocess_bwd_reference(d_feat, means3D, camera: Camera,
                             cfg: RasterConfig, *, scales=None,
                             rotations=None, cov3D_precomp=None, shs=None,
                             sh_degree: int = 0, colors_precomp=None,
                             scale_modifier: float = 1.0,
                             want_view: bool = True) -> dict:
    """Plain version of ``preprocess_bwd``: the table's cotangent
    ``d_feat`` [P, 11] to every input of the composite, in closed form
    (the reference's ``preprocessCUDA``, ``computeCov2DCUDA`` and
    ``computeCov3DCUDA`` backward, with the pose extension's routes to the
    view matrix), any float dtype.  Returns {input name: gradient}:
    ``means3D``, ``opacities`` [P], ``means2D`` [P, 2] (the NDC offset's),
    ``scales`` and ``rotations`` or ``cov3D_precomp``, ``shs`` or
    ``colors_precomp``, and ``view`` [4, 4] with ``want_view``."""
    v = camera.viewmatrix.detach()
    m = means3D.detach()
    g = d_feat
    dt_, dev = m.dtype, m.device
    zero = torch.zeros_like(g[:, 0])
    d_view = torch.zeros((4, 4), dtype=dt_, device=dev)
    out = {}

    # depth and its pose-stopped copy
    z = m @ v[:3, 2] + v[3, 2]
    visible = z > cfg.near
    d_m = (g[:, 9] + g[:, 10])[:, None] * v[:3, 2]
    if want_view and cfg.pose_depth_branch:
        d_view[:3, 2] += m.T @ g[:, 9]
        d_view[3, 2] += g[:, 9].sum()

    # screen position: xy = ndc2pix(hom[:2] / (hom_w + w_eps) + means2D)
    persp = camera.perspective
    pm = v @ persp
    hom = m @ pm[:3, :] + pm[3, :]
    hom_w = torch.where(visible, hom[:, 3], torch.ones_like(zero))
    den = hom_w + cfg.w_eps
    d_ndc = torch.stack([g[:, 0] * 0.5 * camera.width,
                         g[:, 1] * 0.5 * camera.height], 1)
    out["means2D"] = d_ndc
    d_den = -(d_ndc * hom[:, :2]).sum(1) / (den * den)
    d_hom = torch.stack([d_ndc[:, 0] / den, d_ndc[:, 1] / den, zero,
                         torch.where(visible, d_den, zero)], 1)
    d_m = d_m + d_hom @ pm[:3, :].T
    if want_view and cfg.pose_ndc_branch:
        mh = torch.cat([m, torch.ones_like(m[:, :1])], 1)
        d_view += (mh.T @ d_hom) @ persp.T

    # the 3D covariance
    if cov3D_precomp is not None:
        cov6 = cov3D_precomp.detach()
    else:
        cov6 = projection.compute_cov3d(scales.detach(), rotations.detach(),
                                        scale_modifier,
                                        cfg.normalize_quaternions)
    sig = projection.unpack_cov3d(cov6)

    # the EWA 2D covariance's forward values
    w3 = v[:3, :3]
    t = m @ w3 + v[3, :3]
    tz = torch.where(visible, t[:, 2], torch.ones_like(zero))
    limx = cfg.fov_clamp * camera.tanfovx
    limy = cfg.fov_clamp * camera.tanfovy
    u0, u1 = t[:, 0] / tz, t[:, 1] / tz
    uc0, uc1 = torch.clamp(u0, -limx, limx), torch.clamp(u1, -limy, limy)
    tx, ty = uc0 * tz, uc1 * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    fx, fy = camera.focal_x, camera.focal_y
    j00, j02 = fx * inv_tz, -fx * tx * inv_tz2
    j11, j12 = fy * inv_tz, -fy * ty * inv_tz2
    # m0 = j0 @ W, m1 = j1 @ W with W = V[:3, :3]^T
    m0 = j00[:, None] * w3[:, 0] + j02[:, None] * w3[:, 2]
    m1 = j11[:, None] * w3[:, 1] + j12[:, None] * w3[:, 2]
    sm0 = torch.einsum("pij,pj->pi", sig, m0)
    sm1 = torch.einsum("pij,pj->pi", sig, m1)
    a = (m0 * sm0).sum(1) + cfg.lowpass
    b = (m0 * sm1).sum(1)
    c = (m1 * sm1).sum(1) + cfg.lowpass

    # conic = (c, -b, a) / det
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    d_inv = g[:, 2] * c - g[:, 3] * b + g[:, 4] * a
    d_det = torch.where(det_ok, -d_inv * inv_det * inv_det, zero)
    da = g[:, 4] * inv_det + c * d_det
    db = -g[:, 3] * inv_det - 2.0 * b * d_det
    dc = g[:, 2] * inv_det + a * d_det

    # a = m0.S m0 + lowpass, b = m0.S m1, c = m1.S m1 + lowpass
    d_m0 = 2.0 * da[:, None] * sm0 + db[:, None] * sm1
    d_m1 = db[:, None] * sm0 + 2.0 * dc[:, None] * sm1
    outer = lambda u, w: u[:, :, None] * w[:, None, :]
    ds = (da[:, None, None] * outer(m0, m0) + db[:, None, None]
          * outer(m0, m1) + dc[:, None, None] * outer(m1, m1))
    d_cov = torch.stack([ds[:, 0, 0], ds[:, 0, 1] + ds[:, 1, 0],
                         ds[:, 0, 2] + ds[:, 2, 0], ds[:, 1, 1],
                         ds[:, 1, 2] + ds[:, 2, 1], ds[:, 2, 2]], 1)
    dj00 = (d_m0 * w3[:, 0]).sum(1)
    dj02 = (d_m0 * w3[:, 2]).sum(1)
    dj11 = (d_m1 * w3[:, 1]).sum(1)
    dj12 = (d_m1 * w3[:, 2]).sum(1)
    pose_cov = want_view and cfg.pose_cov2d_branch
    if pose_cov:
        d_view[:3, 0] += d_m0.T @ j00
        d_view[:3, 1] += d_m1.T @ j11
        d_view[:3, 2] += d_m0.T @ j02 + d_m1.T @ j12
    d_tx = -fx * inv_tz2 * dj02
    d_ty = -fy * inv_tz2 * dj12
    d_inv_tz = (fx * dj00 + fy * dj11
                + 2.0 * inv_tz * (-fx * tx * dj02 - fy * ty * dj12))
    du0 = torch.where((u0 >= -limx) & (u0 <= limx), tz * d_tx, zero)
    du1 = torch.where((u1 >= -limy) & (u1 <= limy), tz * d_ty, zero)
    d_tz = (-inv_tz * inv_tz * d_inv_tz + uc0 * d_tx + uc1 * d_ty
            - (du0 * t[:, 0] + du1 * t[:, 1]) / (tz * tz))
    d_t = torch.stack([du0 / tz, du1 / tz,
                       torch.where(visible, d_tz, zero)], 1)
    d_m = d_m + d_t @ w3.T
    if pose_cov:
        d_view[:3, :3] += m.T @ d_t
        d_view[3, :3] += d_t.sum(0)

    if cov3D_precomp is not None:
        out["cov3D_precomp"] = d_cov
    else:
        out["scales"], out["rotations"] = _cov3d_bwd(
            d_cov, scales.detach(), rotations.detach(), scale_modifier,
            cfg.normalize_quaternions)

    # colour
    if colors_precomp is not None:
        out["colors_precomp"] = g[:, 6:9]
    else:
        campos = -w3 @ v[3, :3]
        out["shs"], d_dirs = _sh_bwd(g[:, 6:9], shs.detach(),
                                     m - campos[None, :], sh_degree)
        d_m = d_m + d_dirs
        if want_view and cfg.pose_sh_branch:
            d_campos = -d_dirs.sum(0)
            d_view[:3, :3] -= d_campos[:, None] * v[3, :3][None, :]
            d_view[3, :3] -= d_campos @ w3

    out["means3D"] = d_m
    out["opacities"] = g[:, 5]
    if want_view:
        out["view"] = d_view
    return out


def preprocess_tangents_reference(means3D, camera: Camera, cfg: RasterConfig,
                                  view_tangents, *, scales=None,
                                  rotations=None, cov3D_precomp=None,
                                  shs=None, sh_degree: int = 0,
                                  colors_precomp=None,
                                  scale_modifier: float = 1.0, **_unused):
    """Plain version of ``preprocess_tangents``: the forward mode of the
    composite ``projection.preprocess`` along ``view_tangents`` [K, 4, 4]
    at ``camera.viewmatrix``, in closed form, any float dtype.  Returns
    [P, per_k * K]: per tangent dx, dy, ddepth; then dA, dB, dC with
    ``cfg.pose_cov2d_branch``; then dr, dg, db with the colour branch
    (:func:`color_branch`), after conic columns that are zeros without
    ``pose_cov2d_branch``.  The branch flags route the view as the
    composite's detached copies do; ``means2D`` and the opacities carry no
    tangent."""
    v = camera.viewmatrix.detach()
    m = means3D.detach()
    dv = view_tangents.detach().to(m.dtype)                 # [K, 4, 4]
    full = bool(cfg.pose_cov2d_branch)
    color = color_branch(cfg, shs=shs, sh_degree=sh_degree,
                         colors_precomp=colors_precomp)
    p, k_t = m.shape[0], dv.shape[0]
    mh = torch.cat([m, torch.ones_like(m[:, :1])], 1)
    # [m, 1] X[:, c] for each tangent X: [K, P, 4]
    lin = lambda x: torch.einsum("pr,krc->kpc", mh, x)
    zero = m.new_zeros((k_t, p))
    cols = []

    # depth: z = [m, 1] V[:, 2]
    z = mh @ v[:, 2]
    vis = z > cfg.near
    ldv = lin(dv)
    dz = ldv[..., 2] if cfg.pose_depth_branch else zero

    # screen position: xy = ndc2pix(hom[:2] / (hom_w + w_eps))
    if cfg.pose_ndc_branch:
        persp = camera.perspective
        hom = mh @ (v @ persp)
        den = torch.where(vis, hom[:, 3], torch.ones_like(z)) + cfg.w_eps
        dhom = lin(dv @ persp)
        dw = torch.where(vis, dhom[..., 3], zero)
        dx = (dhom[..., 0] - hom[:, 0] / den * dw) / den * (
            0.5 * camera.width)
        dy = (dhom[..., 1] - hom[:, 1] / den * dw) / den * (
            0.5 * camera.height)
    else:
        dx = dy = zero
    cols += [dx, dy, dz]

    # the conic through the EWA 2D covariance
    if full:
        if cov3D_precomp is not None:
            cov6 = cov3D_precomp.detach()
        else:
            cov6 = projection.compute_cov3d(
                scales.detach(), rotations.detach(), scale_modifier,
                cfg.normalize_quaternions)
        sig = projection.unpack_cov3d(cov6)
        w3 = v[:3, :3]
        t = m @ w3 + v[3, :3]
        tz = torch.where(vis, t[:, 2], torch.ones_like(z))
        dtz = torch.where(vis, ldv[..., 2], zero)
        limx = cfg.fov_clamp * camera.tanfovx
        limy = cfg.fov_clamp * camera.tanfovy
        fx, fy = camera.focal_x, camera.focal_y
        # each product's tangent in the composite's order: d(u v) = du v +
        # u dv, and d(1 / u) = -du (1 / u)^2
        inv = 1.0 / tz
        inv2 = inv * inv
        dinv = -dtz * inv2
        dinv2 = 2.0 * (inv * dinv)

        def jac(tc, dtc, lim, f):
            # the clamped coordinate's Jacobian entries j_diag = f / tz and
            # j_z = -f tc_clamped / tz^2, and their tangents
            u = tc / tz
            du = torch.where((u >= -lim) & (u <= lim),
                             (dtc - u * dtz) / tz, zero)
            uc = torch.clamp(u, -lim, lim)
            tcl, dtcl = uc * tz, du * tz + uc * dtz
            return (f * inv, f * dinv, -f * tcl * inv2,
                    (-f * dtcl) * inv2 + (-f * tcl) * dinv2)

        j00, dj00, j02, dj02 = jac(t[:, 0], ldv[..., 0], limx, fx)
        j11, dj11, j12, dj12 = jac(t[:, 1], ldv[..., 1], limy, fy)
        # m0[b] = j00 V[b, 0] + j02 V[b, 2], m1[b] = j11 V[b, 1] + j12 V[b, 2]
        m0 = j00[:, None] * w3[:, 0] + j02[:, None] * w3[:, 2]
        m1 = j11[:, None] * w3[:, 1] + j12[:, None] * w3[:, 2]
        dvw = dv[:, None, :3, :3]                            # [K, 1, 3, 3]
        dm0 = ((dj00[..., None] * w3[:, 0] + dj02[..., None] * w3[:, 2])
               + (j00[:, None] * dvw[..., 0] + j02[:, None] * dvw[..., 2]))
        dm1 = ((dj11[..., None] * w3[:, 1] + dj12[..., None] * w3[:, 2])
               + (j11[:, None] * dvw[..., 1] + j12[:, None] * dvw[..., 2]))
        sm0 = torch.einsum("pij,pj->pi", sig, m0)
        sm1 = torch.einsum("pij,pj->pi", sig, m1)
        dsm0 = torch.einsum("pij,kpj->kpi", sig, dm0)
        dsm1 = torch.einsum("pij,kpj->kpi", sig, dm1)
        a = (m0 * sm0).sum(1) + cfg.lowpass
        b = (m0 * sm1).sum(1)
        c = (m1 * sm1).sum(1) + cfg.lowpass
        da = (dm0 * sm0).sum(-1) + (m0 * dsm0).sum(-1)
        db = (dm0 * sm1).sum(-1) + (m0 * dsm1).sum(-1)
        dc = (dm1 * sm1).sum(-1) + (m1 * dsm1).sum(-1)
        det = a * c - b * b
        ok = det != 0.0
        inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
        ddet = torch.where(ok, (dc * a + da * c) - (db * b + db * b), zero)
        dinv_det = -ddet * (inv_det * inv_det)
        cols += [dc * inv_det + c * dinv_det, -(db * inv_det + b * dinv_det),
                 da * inv_det + a * dinv_det]
    elif color:
        cols += [zero, zero, zero]

    # the SH colour through the camera position -V[:3, :3] V[3, :3]
    if color:
        w3 = v[:3, :3]
        dirs = m + w3 @ v[3, :3]
        n = torch.linalg.norm(dirs, dim=-1, keepdim=True)
        pos = n > 0
        den = torch.where(pos, n, torch.ones_like(n))
        d = dirs / den
        ddirs = (dv[:, :3, :3] @ v[3, :3] + dv[:, 3, :3] @ w3.T)[:, None]
        dd = torch.where(pos, (ddirs - d * (d * ddirs).sum(-1, keepdim=True))
                         / den, ddirs)                      # [K, P, 3]
        shs = shs.detach()
        basis = _sh_basis(d, sh_degree)
        result = sum(bk[:, None] * shs[:, k]
                     for k, (bk, *_) in enumerate(basis))
        dres = sum((bx * dd[..., 0] + by * dd[..., 1] + bz * dd[..., 2])
                   [..., None] * shs[:, k]
                   for k, (_, bx, by, bz) in enumerate(basis))
        dcol = torch.where(result + 0.5 >= 0, dres, torch.zeros_like(dres))
        cols += list(dcol.unbind(-1))

    # [K, P, per_k] -> [P, K * per_k]
    return torch.stack(cols, -1).movedim(0, 1).reshape(p, -1)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _params(camera: Camera, cfg: RasterConfig, p: int, sh_coeffs: int,
            sh_degree: int, scale_modifier: float, flags: int):
    """The kernels' float and integer parameters (csrc/preprocess.cu's
    ``Params``, in its order) as ctypes arrays."""
    fpar = (ctypes.c_float * 14)(
        scale_modifier, camera.focal_x, camera.focal_y,
        cfg.fov_clamp * camera.tanfovx, cfg.fov_clamp * camera.tanfovy,
        1.0 / camera.tanfovx, 1.0 / camera.tanfovy, cfg.near, cfg.w_eps, cfg.lowpass, cfg.eig_clamp, cfg.radius_sigma,
        cfg.alpha_min, float(cfg.bin_margin_px))
    tiles_x = -(-camera.width // cfg.tile_w)
    tiles_y = -(-camera.height // cfg.tile_h)
    ipar = (ctypes.c_int * 10)(
        p, camera.width, camera.height, cfg.tile_w, cfg.tile_h, tiles_x,
        tiles_y, sh_coeffs, sh_degree, flags)
    return fpar, ipar


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _flags(cfg: RasterConfig, cov3D_precomp, colors_precomp, means2D):
    return ((NORMALIZE_Q if cfg.normalize_quaternions else 0)
            | (OPACITY_CULL if cfg.opacity_cull else 0)
            | (COV_PRE if cov3D_precomp is not None else 0)
            | (COL_PRE if colors_precomp is not None else 0)
            | (MEANS2D if means2D is not None else 0)
            | (POSE_DEPTH if cfg.pose_depth_branch else 0)
            | (POSE_NDC if cfg.pose_ndc_branch else 0)
            | (POSE_COV if cfg.pose_cov2d_branch else 0)
            | (POSE_SH if cfg.pose_sh_branch else 0))


def _kernel_inputs(means3D, view, opacities, scales, rotations,
                   cov3D_precomp, shs, sh_degree, colors_precomp, means2D):
    """The kernels' inputs, checked: float32 CUDA tensors of the documented
    shapes on one device, made contiguous (views where they are)."""
    p = means3D.shape[0]
    c = lambda x: None if x is None else x.detach().contiguous()
    ins = dict(means=c(means3D), view=c(view),
               opac=c(opacities).reshape(-1), scales=None, rots=None,
               cov=c(cov3D_precomp), shs=None, col=c(colors_precomp),
               m2d=c(means2D))
    if cov3D_precomp is None:
        ins["scales"], ins["rots"] = c(scales), c(rotations)
    if colors_precomp is None:
        ins["shs"] = c(shs)
    shapes = dict(means=(p, 3), view=(4, 4), opac=(p,), scales=(p, 3),
                  rots=(p, 4), cov=(p, 6), col=(p, 3), m2d=(p, 2))
    for name, x in ins.items():
        if x is None:
            continue
        _check_cuda(x, torch.float32, name)
        if x.device != ins["means"].device:
            raise ValueError("every preprocess input must be on one device")
        want = shapes.get(name)
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(x.shape)}")
    if ins["shs"] is not None:
        x = ins["shs"]
        if (x.dim() != 3 or x.shape[0] != p or x.shape[2] != 3
                or x.shape[1] < (sh_degree + 1) ** 2 or not 0 <= sh_degree
                <= 3):
            raise ValueError(f"shs must be [P, M >= {(sh_degree + 1) ** 2}, "
                             f"3] with sh_degree 0..3, got "
                             f"{tuple(x.shape)}, degree {sh_degree}")
    return ins


def launch_preprocess_fwd(ins, camera: Camera, cfg: RasterConfig,
                          sh_degree: int, scale_modifier: float):
    """``preprocess_fwd`` on checked inputs (:func:`_kernel_inputs`);
    returns the table [P, 11], the integer footprint [P, 6] and the mask
    [P]."""
    from ._build import load
    means = ins["means"]
    p, dev = means.shape[0], means.device
    feat = torch.empty((p, len(FEAT_COLUMNS)), dtype=torch.float32,
                       device=dev)
    ints = torch.empty((p, INTS), dtype=torch.int32, device=dev)
    mask = torch.empty(p, dtype=torch.bool, device=dev)
    m = 0 if ins["shs"] is None else ins["shs"].shape[1]
    fpar, ipar = _params(camera, cfg, p, m, sh_degree, scale_modifier,
                         _flags(cfg, ins["cov"], ins["col"], ins["m2d"]))
    if p:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = load("preprocess").preprocess_fwd(
                *(_ptr(ins[k]) for k in ("means", "scales", "rots", "opac",
                                         "shs", "cov", "col", "m2d",
                                         "view")),
                ctypes.addressof(fpar), ctypes.addressof(ipar),
                feat.data_ptr(), ints.data_ptr(), mask.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"preprocess_fwd launch failed: CUDA error "
                               f"{rc}")
        launches["preprocess_fwd"] += 1
    return feat, ints, mask


def launch_preprocess_bwd(ins, d_feat, camera: Camera, cfg: RasterConfig,
                          sh_degree: int, scale_modifier: float, need: dict):
    """``preprocess_bwd`` on checked inputs: the gradients named in
    ``need`` (as :func:`preprocess_bwd_reference` names them), each written
    whole, none other computed to memory."""
    from ._build import load
    _check_cuda(d_feat, torch.float32, "d_feat")
    means = ins["means"]
    p, dev = means.shape[0], means.device
    if d_feat.shape != (p, len(FEAT_COLUMNS)):
        raise ValueError(f"d_feat must be [P, {len(FEAT_COLUMNS)}]")
    shapes = dict(means3D=(p, 3), opacities=(p,), means2D=(p, 2),
                  scales=(p, 3), rotations=(p, 4), cov3D_precomp=(p, 6),
                  colors_precomp=(p, 3), view=(4, 4))
    if ins["shs"] is not None:
        shapes["shs"] = tuple(ins["shs"].shape)
    out = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
           for k, on in need.items() if on and k in shapes}
    flags = _flags(cfg, ins["cov"], ins["col"], ins["m2d"])
    nblocks = -(-p // THREADS)
    part = None
    if "view" in out:
        flags |= WANT_VIEW
        part = torch.empty((max(nblocks, 1), VIEW), dtype=torch.float32,
                           device=dev)
    m = 0 if ins["shs"] is None else ins["shs"].shape[1]
    fpar, ipar = _params(camera, cfg, p, m, sh_degree, scale_modifier, flags)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("preprocess").preprocess_bwd(
            *(_ptr(ins[k]) for k in ("means", "scales", "rots", "shs",
                                     "cov", "view")),
            ctypes.addressof(fpar), ctypes.addressof(ipar),
            d_feat.data_ptr(),
            *(_ptr(out.get(k)) for k in ("means3D", "scales", "rotations",
                                         "opacities", "shs",
                                         "cov3D_precomp", "colors_precomp",
                                         "means2D")),
            _ptr(part), _ptr(out.get("view")), stream)
    if rc != 0:
        raise RuntimeError(f"preprocess_bwd launch failed: CUDA error {rc}")
    launches["preprocess_bwd"] += 1
    return out


def preprocess_tangents(means3D, camera: Camera, cfg: RasterConfig,
                        view_tangents, *, opacities, scales=None,
                        rotations=None, cov3D_precomp=None, shs=None,
                        sh_degree: int = 0, colors_precomp=None,
                        scale_modifier: float = 1.0):
    """The forward mode of the render op's preprocess along
    ``view_tangents`` [K, 4, 4] at ``camera.viewmatrix``: [P, per_k * K],
    the columns of :func:`preprocess_tangents_reference` (the arguments of
    ``preprocess_table`` but ``means2D``).  On CUDA tensors (float32) the
    ``preprocess_tangents`` kernel, on CPU tensors the plain version.  The
    kernel is instantiated on the columns wanted and the SH degree: without
    the conic or colour branch it reads only the means."""
    kw = dict(scales=scales, rotations=rotations, cov3D_precomp=cov3D_precomp,
              shs=shs, sh_degree=sh_degree, colors_precomp=colors_precomp,
              scale_modifier=scale_modifier)
    if means3D.device.type == "cpu":
        return preprocess_tangents_reference(means3D, camera, cfg,
                                             view_tangents, **kw)
    from ._build import load
    ins = _kernel_inputs(means3D, camera.viewmatrix, opacities, scales,
                         rotations, cov3D_precomp, shs, sh_degree,
                         colors_precomp, None)
    dview = view_tangents.detach().contiguous()
    _check_cuda(dview, torch.float32, "view_tangents")
    if dview.device != ins["means"].device:
        raise ValueError("view_tangents must be on the Gaussians' device")
    if dview.dim() != 3 or dview.shape[1:] != (4, 4) or dview.shape[0] < 1:
        raise ValueError(f"view_tangents must be [K >= 1, 4, 4], got "
                         f"{tuple(dview.shape)}")
    p, k_t = ins["means"].shape[0], dview.shape[0]
    per_k = tangent_columns(bool(cfg.pose_cov2d_branch),
                            color_branch(cfg, **kw))
    out = torch.empty((p, per_k * k_t), dtype=torch.float32,
                      device=dview.device)
    if p == 0:
        return out
    m = 0 if ins["shs"] is None else ins["shs"].shape[1]
    fpar, ipar = _params(camera, cfg, p, m, sh_degree, scale_modifier,
                         _flags(cfg, ins["cov"], ins["col"], ins["m2d"]))
    with torch.cuda.device(dview.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("preprocess").preprocess_tangents(
            *(_ptr(ins[k]) for k in ("means", "scales", "rots", "shs", "cov",
                                     "view")),
            dview.data_ptr(), ctypes.addressof(fpar), ctypes.addressof(ipar),
            k_t, per_k, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"preprocess_tangents launch failed: CUDA error "
                           f"{rc}")
    launches["preprocess_tangents"] += 1
    return out


# --------------------------------------------------------------------------
# the op
# --------------------------------------------------------------------------

# the Function's differentiable inputs, in order
_INPUTS = ("means3D", "view", "opacities", "scales", "rotations",
           "cov3D_precomp", "shs", "colors_precomp", "means2D")


class _Preprocess(torch.autograd.Function):
    """Table, integer footprint and mask from the Gaussians and the view;
    the backward returns the gradient of every differentiable input from
    d ``feat`` alone (the footprint and the mask are constants)."""

    @staticmethod
    def forward(ctx, means3D, view, opacities, scales, rotations,
                cov3D_precomp, shs, colors_precomp, means2D, static):
        camera, cfg, sh_degree, scale_modifier = static
        camera = camera.replace(viewmatrix=view)
        if means3D.device.type == "cpu":
            feat, ints, mask = preprocess_fwd_reference(
                means3D, camera, cfg, opacities=opacities, scales=scales,
                rotations=rotations, cov3D_precomp=cov3D_precomp, shs=shs,
                sh_degree=sh_degree, colors_precomp=colors_precomp,
                scale_modifier=scale_modifier, means2D=means2D)
            ins = None
        else:
            ins = _kernel_inputs(means3D, view, opacities, scales, rotations,
                                 cov3D_precomp, shs, sh_degree,
                                 colors_precomp, means2D)
            feat, ints, mask = launch_preprocess_fwd(
                ins, camera, cfg, sh_degree, scale_modifier)
        ctx.mark_non_differentiable(ints, mask)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3D, view, opacities, scales, rotations,
                              cov3D_precomp, shs, colors_precomp, means2D)
        ctx.static = (camera.replace(viewmatrix=None), cfg, sh_degree,
                      scale_modifier)
        return feat, ints, mask

    @staticmethod
    def backward(ctx, d_feat, _d_ints, _d_mask):
        n = len(_INPUTS)
        if d_feat is None:
            return (None,) * (n + 1)
        saved = dict(zip(_INPUTS, ctx.saved_tensors))
        camera, cfg, sh_degree, scale_modifier = ctx.static
        camera = camera.replace(viewmatrix=saved["view"].detach())
        need = dict(zip(_INPUTS, ctx.needs_input_grad))
        if d_feat.device.type == "cpu":
            g = preprocess_bwd_reference(
                d_feat, saved["means3D"], camera, cfg,
                scales=saved["scales"], rotations=saved["rotations"],
                cov3D_precomp=saved["cov3D_precomp"], shs=saved["shs"],
                sh_degree=sh_degree, colors_precomp=saved["colors_precomp"],
                scale_modifier=scale_modifier, want_view=need["view"])
        else:
            ins = _kernel_inputs(
                saved["means3D"], saved["view"], saved["opacities"],
                saved["scales"], saved["rotations"], saved["cov3D_precomp"],
                saved["shs"], sh_degree, saved["colors_precomp"],
                saved["means2D"])
            g = launch_preprocess_bwd(ins, d_feat.contiguous(), camera, cfg,
                                      sh_degree, scale_modifier, need)
        grads = []
        for k in _INPUTS:
            x = g.get(k) if need[k] else None
            if x is not None:
                x = x.reshape(saved[k].shape)
            grads.append(x)
        return (*grads, None)


def preprocess_table(means3D, camera: Camera, cfg: RasterConfig, *,
                     opacities, scales=None, rotations=None,
                     cov3D_precomp=None, shs=None, sh_degree: int = 0,
                     colors_precomp=None, scale_modifier: float = 1.0,
                     means2D=None):
    """The render op's preprocess: ``(prep, feat)``, the ``Preprocessed``
    of ``projection.preprocess`` (same arguments, same values) and the
    feature table [P, 11] its float fields are views of; differentiable in
    reverse mode through ``feat`` to every Gaussian input, ``means2D`` and
    the view matrix.  ``preprocess_fwd``/``_bwd`` on CUDA tensors, the
    plain versions on CPU tensors (see the module docstring)."""
    static = (camera.replace(viewmatrix=None), cfg, int(sh_degree),
              float(scale_modifier))
    feat, ints, mask = _Preprocess.apply(
        means3D, camera.viewmatrix, opacities, scales, rotations,
        cov3D_precomp, shs, colors_precomp, means2D, static)
    return unpack(feat, ints, mask), feat
