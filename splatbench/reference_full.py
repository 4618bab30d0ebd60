"""The plain reference of the Full variant's tracker: the dual render and
Gauss-Newton of ``reference.py`` with the complete pose chain, on maps
whose Gaussians carry spherical-harmonic colour of degree 0 to 3.

Nothing here imports the program.  It reuses ``reference.py`` (projection,
binning, blend, the Gauss-Newton loop) and changes two things of its
tracker level (:class:`_FullLevel`, a subclass of ``reference._Level``):

- colour is SH evaluated as 3D Gaussian splatting evaluates it (its
  constants, the view direction from the camera centre to the mean,
  normalised, the ``+0.5`` offset and the clamp at zero), with the camera
  centre ``-V[:3, :3] V[3, :3]`` of the view being differentiated, so the
  colour carries the pose (the SH colour branch, ``sh_branch``);
- the 2D covariance's view is that view too, not a detached copy (the
  EWA branch, ``cov_branch``).

The pose tangents come from ``torch.autograd.forward_ad`` over that whole
forward: the exact derivative by construction, with nothing detached but
what a branch turned off detaches.  Float32, TF32 off unless ``tf32``
asks for the control.

Departures from the published description (hjr37/diff-gaussian-
rasterization, the ``full`` package): its pose kernel drops the Σ2D term
from its final sum; here both branches are summed, as their derivation
has them.  Its forward blend stops a pixel after accumulating the pair
that takes the transmittance under 1e-4; here, as in ``reference.py``
and the light package, before it.  Nothing else departs.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad as fwAD

from . import reference as ref

SH_C0 = ref.SH_C0
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def sh_degree(sh) -> int:
    """The degree of a coefficient tensor [P, (d + 1)^2, 3]."""
    d = int(round(sh.shape[1] ** 0.5)) - 1
    if (d + 1) ** 2 != sh.shape[1] or not 0 <= d <= 3:
        raise ValueError(f"SH of {sh.shape[1]} coefficients is no degree "
                         "0..3")
    return d


def eval_sh(sh, dirs):
    """3DGS's ``computeColorFromSH``: coefficients [P, M, 3] and view
    directions [P, 3] (normalised here) -> colour [P, 3], offset by 0.5
    and clamped at zero."""
    deg = sh_degree(sh)
    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = SH_C0 * sh[:, 0]
    if deg > 0:
        c = c - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
             + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        c = (c + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
             + SH_C3[1] * xy * z * sh[:, 10]
             + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
             + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14]
             + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(c + 0.5, 0.0)


def campos(view, tf32: bool = False):
    """The camera centre in world coordinates of a view matrix in the
    row-vector convention: ``-V[:3, :3] V[3, :3]``."""
    return -ref.mm(view[:3, :3], view[3, :3, None], tf32)[:, 0]


def gaussian_fields(means, scales_log, rotations, opacities_logit, sh,
                    active):
    """The activated fields of a map with its SH coefficients: ``(means,
    scales, rotations, opacities, sh)``, opacities 0 where inactive."""
    m, s, r, op, _ = ref.gaussian_fields(means, scales_log, rotations,
                                         opacities_logit, sh[:, :1], active)
    return m, s, r, op, sh


def colors(fields, view, tf32: bool = False):
    """Each Gaussian's colour seen from ``view``."""
    return eval_sh(fields[4], fields[0] - campos(view, tf32)[None])


class _FullLevel(ref._Level):
    """A pyramid level of the tracker with the full pose chain: its
    binning as ``reference._Level``'s (on the colour at the start view,
    which binning never reads), its image with the branches on."""

    def __init__(self, fields, view0, rgb, depth, cam, R, tcfg, tf32, chunk,
                 cov_branch=True, sh_branch=True):
        self.full = fields
        self.cov_branch, self.sh_branch = cov_branch, sh_branch
        base = fields[:4] + (colors(fields, view0, tf32),)
        super().__init__(base, view0, rgb, depth, cam, R, tcfg, tf32, chunk)

    def image(self, xi):
        view = ref.apply_twist(self.view0, xi)
        fixed = lambda on: view if on else view.detach()
        f = self.full[:4] + (colors(self.full, fixed(self.sh_branch),
                                    self.tf32),)
        sp = ref.project(f, view, self.cam, self.R,
                         view_cov=fixed(self.cov_branch), tf32=self.tf32)
        bins = self.bins if self.bins is not None else \
            ref.bin_pairs(sp, self.cam, self.R)
        q = self.R.tile_h * self.R.tile_w
        parts = [ref.blend_tiles(sp, bins, t, self.cam, self.R, self.chunk)
                 for t in ref.tile_batches(bins, q, self.chunk)]
        tiles = torch.cat([p.tiles for p in parts])
        img = lambda k: ref.untile(torch.cat([getattr(p, k) for p in parts]),
                                   tiles, self.cam, self.R)
        return img("color"), img("depth"), img("weight")


def track(fields, view0, rgb, depth, cam: ref.Cam, R: ref.Raster,
          tcfg: dict, tf32: bool = False, chunk: int = 64,
          cov_branch: bool = True, sh_branch: bool = True):
    """``reference.track`` with the full pose chain: Gauss-Newton on the
    twist, coarse to fine, over :class:`_FullLevel` levels."""
    fields = tuple(f.detach() for f in fields)
    view = view0.detach()
    levels = [2 ** lv for lv in range(max(tcfg["pyramid"], 1) - 1, 0, -1)
              if not (cam.height % 2 ** lv or cam.width % 2 ** lv)]
    with torch.no_grad():
        for s in levels + [1]:
            t = dict(tcfg)
            if s > 1:
                t["iters"] = tcfg["coarse_iters"]
                r, d = ref.downsample(rgb, depth, s)
            else:
                r, d = rgb, depth
            lv = _FullLevel(fields, view, r, d, cam.scaled(s), R, t, tf32,
                            chunk, cov_branch, sh_branch)
            view = ref.apply_twist(view, ref._gn(lv))
    return view


def dual_render(fields, view0, cam: ref.Cam, R: ref.Raster,
                tf32: bool = False, chunk: int = 64, cov_branch: bool = True,
                sh_branch: bool = True):
    """The render at ``view0`` and its derivatives along the six twist
    directions, with the full pose chain: ``(primal [n], tangents [6,
    n])``, each the colour, depth and silhouette images flattened one
    after another (``reference.dual_render``'s layout)."""
    fields = tuple(f.detach() for f in fields)
    lv = _FullLevel(fields, view0.detach(), None, None, cam, R,
                    dict(freeze_binning=False), tf32, chunk, cov_branch,
                    sh_branch)
    xi = torch.zeros(6, dtype=view0.dtype, device=view0.device)
    flat = lambda imgs: torch.cat([x.reshape(-1) for x in imgs])
    prim, tans = None, []
    with torch.no_grad():
        for k in range(6):
            with fwAD.dual_level():
                tan = torch.zeros_like(xi)
                tan[k] = 1.0
                out = [fwAD.unpack_dual(x)
                       for x in lv.image(fwAD.make_dual(xi, tan))]
                if prim is None:
                    prim = flat([o.primal for o in out])
                tans.append(flat([o.tangent for o in out]))
    return prim, torch.stack(tans)
