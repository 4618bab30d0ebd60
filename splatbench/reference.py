"""The plain reference: what the rasterizer, the mapping step and the
tracker compute, written out in plain PyTorch.

Nothing here imports the program.  It follows the published semantics of a
3D Gaussian-splatting rasterizer as CG-SLAM's CUDA rasterizer defines them
(EWA projection with the low-pass, front-to-back alpha blending with the
alpha cap, the alpha floor and the transmittance stop) and the program's
documented mapping step (grouped Adam on an RGB-D L1 loss) and tracker
(Gauss-Newton / Levenberg-Marquardt on the pose twist with Huber weights,
coarse to fine, deferred accept or a line search).  Gradients come from
autograd, pose Jacobians from forward-mode autodiff; the blend is a dense
per-pixel loop over each tile's depth-sorted Gaussians, in chunks, so it
fits in memory at 1200x680 and 500,000 Gaussians.

``tf32=True`` computes every matrix product of the projection with its
operands rounded to TF32 (10 mantissa bits, float32 accumulation): the
control, one precision below the float32 the configurations state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd import forward_ad as fwAD

SH_C0 = 0.28209479177387814


class Raster(NamedTuple):
    """The rasterizer constants a configuration states."""

    tile_h: int = 32
    tile_w: int = 32
    alpha_cap: float = 0.99
    alpha_min: float = 15.0 / 255.0
    t_terminate: float = 1e-4
    lowpass: float = 0.3
    eig_clamp: float = 0.1
    near: float = 0.2
    fov_clamp: float = 1.3
    w_eps: float = 1e-7

    @classmethod
    def of(cls, d: dict) -> "Raster":
        return cls(**{k: d[k] for k in cls._fields if k in d})


class Cam(NamedTuple):
    height: int
    width: int
    tanfovx: float
    tanfovy: float

    def scaled(self, s: int) -> "Cam":
        return Cam(self.height // s, self.width // s, self.tanfovx,
                   self.tanfovy)


def tf32_round(x):
    """Round float32 values to TF32 (10 explicit mantissa bits, to
    nearest); the rounding passes no gradient or tangent of its own."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach()).detach() if x.requires_grad or \
        fwAD.unpack_dual(x).tangent is not None else r


def mm(a, b, tf32: bool):
    """``a @ b`` in float32, or with TF32 operands."""
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


# --------------------------------------------------------------------------
# projection
# --------------------------------------------------------------------------


def quat_rot(q):
    """(P, 4) quaternions (r, x, y, z), used as given -> (P, 3, 3)."""
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


class Splats(NamedTuple):
    """Screen-space splats (all (P, ...))."""

    xy: torch.Tensor
    conic: torch.Tensor
    opac: torch.Tensor
    color: torch.Tensor
    depth: torch.Tensor
    live: torch.Tensor     # bool: in front of the near plane, invertible,
                           # opaque enough to pass the alpha floor
    ext: torch.Tensor      # (P, 2) half extents (px) of the alpha-floor
                           # ellipse


def gaussian_fields(means, scales_log, rotations, opacities_logit, sh,
                    active):
    """The activated fields of a map: scales, opacities (0 where inactive)
    and degree-0 colors."""
    op = torch.sigmoid(opacities_logit.reshape(-1))
    op = torch.where(active, op, torch.zeros_like(op))
    color = torch.clamp_min(SH_C0 * sh[:, 0] + 0.5, 0.0)
    return means, torch.exp(scales_log), rotations, op, color


def project(fields, view, cam: Cam, R: Raster, view_cov=None,
            tf32: bool = False) -> Splats:
    """EWA projection of Gaussians seen through ``view`` (a world-to-camera
    matrix in the row-vector convention, ``[p, 1] @ view``).  ``view_cov``
    is the view of the 2D covariance (default ``view``): the light pose
    Jacobian takes it constant."""
    means, scales, rots, op, color = fields
    view_cov = view if view_cov is None else view_cov
    t = mm(means, view[:3, :3], tf32) + view[3, :3]
    tz = t[:, 2]
    live = tz.detach() > R.near
    tzs = torch.where(live, tz, torch.ones_like(tz))
    x_ndc = t[:, 0] / cam.tanfovx / (tzs + R.w_eps)
    y_ndc = t[:, 1] / cam.tanfovy / (tzs + R.w_eps)
    xy = torch.stack([((x_ndc + 1.0) * cam.width - 1.0) * 0.5,
                      ((y_ndc + 1.0) * cam.height - 1.0) * 0.5], -1)

    m = quat_rot(rots) * scales[:, None, :]
    sigma = mm(m, m.transpose(-1, -2), tf32)
    tc = mm(means, view_cov[:3, :3], tf32) + view_cov[3, :3]
    tcz = torch.where(live, tc[:, 2], torch.ones_like(tc[:, 2]))
    fx = cam.width / (2.0 * cam.tanfovx)
    fy = cam.height / (2.0 * cam.tanfovy)
    limx, limy = R.fov_clamp * cam.tanfovx, R.fov_clamp * cam.tanfovy
    txc = torch.clamp(tc[:, 0] / tcz, -limx, limx) * tcz
    tyc = torch.clamp(tc[:, 1] / tcz, -limy, limy) * tcz
    zero = torch.zeros_like(tcz)
    jac = torch.stack([
        torch.stack([fx / tcz, zero, -fx * txc / (tcz * tcz)], -1),
        torch.stack([zero, fy / tcz, -fy * tyc / (tcz * tcz)], -1)], -2)
    mj = mm(jac, view_cov[:3, :3].T, tf32)                     # (P, 2, 3)
    cov = mm(mm(mj, sigma, tf32), mj.transpose(-1, -2), tf32)  # (P, 2, 2)
    a = cov[:, 0, 0] + R.lowpass
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + R.lowpass
    det = a * c - b * b
    ok = det.detach() != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    ratio = op.detach() / R.alpha_min
    live = live & ok & (ratio > 1.0)
    cut = torch.sqrt(2.0 * torch.log(torch.clamp_min(ratio, 1.0)))
    ext = torch.stack([cut * torch.sqrt(torch.clamp_min(a.detach(), 0.0)),
                       cut * torch.sqrt(torch.clamp_min(c.detach(), 0.0))],
                      -1)
    return Splats(xy, conic, op, color, tz, live, ext)


# --------------------------------------------------------------------------
# binning: which Gaussians each tile blends, front to back
# --------------------------------------------------------------------------


class Bins(NamedTuple):
    gid: torch.Tensor     # (I,) Gaussian of each pair, sorted by
                          # (tile, depth, Gaussian)
    start: torch.Tensor   # (T,) segment of each tile
    stop: torch.Tensor


def grid(cam: Cam, R: Raster):
    return -(-cam.width // R.tile_w), -(-cam.height // R.tile_h)


def bin_pairs(sp: Splats, cam: Cam, R: Raster, margin: float = 1.0,
              exact_margin: float = None) -> Bins:
    """Every (Gaussian, tile) pair whose alpha-floor ellipse, widened by
    ``margin`` pixels, reaches the tile, sorted front to back by the
    Gaussians' depths here (ties in Gaussian order).

    ``exact_margin`` keeps a pair only where the ellipse widened by that
    many pixels reaches the tile's pixel-centre box, the test a frozen
    tracking binning uses to decide what later poses may blend."""
    tx, ty = grid(cam, R)
    dev = sp.xy.device
    xy, ext = sp.xy.detach(), sp.ext
    g = torch.nonzero(sp.live).reshape(-1)
    lo_x = torch.clamp(torch.floor((xy[g, 0] - ext[g, 0] - margin)
                                   / R.tile_w), 0, tx).long()
    hi_x = torch.clamp(torch.floor((xy[g, 0] + ext[g, 0] + margin)
                                   / R.tile_w) + 1, 0, tx).long()
    lo_y = torch.clamp(torch.floor((xy[g, 1] - ext[g, 1] - margin)
                                   / R.tile_h), 0, ty).long()
    hi_y = torch.clamp(torch.floor((xy[g, 1] + ext[g, 1] + margin)
                                   / R.tile_h) + 1, 0, ty).long()
    w = hi_x - lo_x
    n = w * (hi_y - lo_y)
    keep = n > 0
    g, lo_x, lo_y, w, n = g[keep], lo_x[keep], lo_y[keep], w[keep], n[keep]
    pg = torch.repeat_interleave(torch.arange(g.numel(), device=dev), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(pg.numel(), device=dev) - first[pg]
    ptx = lo_x[pg] + k % w[pg]
    pty = lo_y[pg] + torch.div(k, w[pg], rounding_mode="floor")
    gid = g[pg]
    if exact_margin is not None:
        keep = _ellipse_meets_tile(sp, gid, ptx, pty, R, exact_margin)
        gid, ptx, pty = gid[keep], ptx[keep], pty[keep]
    tile = pty * tx + ptx
    o = torch.sort(sp.depth.detach()[gid], stable=True).indices
    o = o[torch.sort(tile[o], stable=True).indices]
    gid, tile = gid[o], tile[o]
    ids = torch.arange(tx * ty, device=dev)
    return Bins(gid, torch.searchsorted(tile, ids),
                torch.searchsorted(tile, ids, right=True))


def _ellipse_meets_tile(sp: Splats, gid, ptx, pty, R: Raster, m: float):
    """Whether the splat's power over the tile's pixel-centre box widened
    by ``m`` reaches the alpha-floor level (the box's best point: the
    centre when inside, else the best of the four edges)."""
    conic = sp.conic.detach()[gid]
    xy = sp.xy.detach()[gid]
    lvl = torch.log(torch.clamp_min(sp.opac.detach()[gid], 1e-12)
                    / R.alpha_min)
    ca, cb, cc = conic.unbind(-1)
    dx0 = ptx.float() * R.tile_w - xy[:, 0] - m
    dx1 = dx0 + (R.tile_w - 1) + 2.0 * m
    dy0 = pty.float() * R.tile_h - xy[:, 1] - m
    dy1 = dy0 + (R.tile_h - 1) + 2.0 * m
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    sa, sc = torch.clamp_min(ca, 1e-12), torch.clamp_min(cc, 1e-12)

    def at_x(a):
        yy = torch.minimum(torch.maximum(-cb * a / sc, dy0), dy1)
        return -0.5 * (ca * a * a + cc * yy * yy) - cb * a * yy

    def at_y(b):
        xx = torch.minimum(torch.maximum(-cb * b / sa, dx0), dx1)
        return -0.5 * (ca * xx * xx + cc * b * b) - cb * xx * b

    best = torch.maximum(torch.maximum(at_x(dx0), at_x(dx1)),
                         torch.maximum(at_y(dy0), at_y(dy1)))
    return inside | (best >= -lvl - 1e-4)


# --------------------------------------------------------------------------
# the blend
# --------------------------------------------------------------------------

PAIR_BUDGET = 1 << 24     # elements of one [tiles, chunk, pixels] tensor
PAIR_LIMIT = 1 << 27      # padded pairs of one batch of tiles


class Image(NamedTuple):
    """Tile-major outputs [T', Q] of the tiles ``tiles`` (and counts)."""

    tiles: torch.Tensor
    color: torch.Tensor    # [T', 3, Q]
    depth: torch.Tensor
    weight: torch.Tensor
    inside: torch.Tensor   # [T', Q] bool: the pixel lies in the image
    contrib: int           # contributing pairs


def tile_batches(bins: Bins, q: int, chunk: int):
    """Tiles in batches of similar segment length: each batch's
    [tiles, chunk, pixels] within ``PAIR_BUDGET`` and its padded pairs
    within ``PAIR_LIMIT`` (what a differentiated batch keeps)."""
    n = (bins.stop - bins.start)
    order = torch.sort(n, stable=True).indices
    lens = n[order].tolist()
    per = max(1, PAIR_BUDGET // (chunk * q))
    out, i = [], 0
    while i < len(lens):
        j = i + 1
        while (j < len(lens) and j - i < per
               and (j + 1 - i) * max(lens[j], chunk) * q <= PAIR_LIMIT):
            j += 1
        out.append(order[i:j])
        i = j
    return out


def blend_tiles(sp: Splats, bins: Bins, tiles, cam: Cam, R: Raster,
                chunk: int = 64, count: bool = False) -> Image:
    """Blend the tiles ``tiles`` front to back, ``chunk`` pairs at a
    time, until every pixel's transmittance has dropped under the stop."""
    dev = sp.xy.device
    tx, _ = grid(cam, R)
    q = R.tile_h * R.tile_w
    lq = torch.arange(q, device=dev)
    px = (tiles[:, None] % tx) * R.tile_w + lq[None] % R.tile_w
    py = torch.div(tiles[:, None], tx, rounding_mode="floor") * R.tile_h \
        + torch.div(lq[None], R.tile_w, rounding_mode="floor")
    inside = (px < cam.width) & (py < cam.height)
    px, py = px.float(), py.float()
    start, stop = bins.start[tiles], bins.stop[tiles]
    b = tiles.numel()
    prod = torch.ones((b, q), dtype=sp.xy.dtype, device=dev)
    color = sp.xy.new_zeros((b, 3, q))
    depth = sp.xy.new_zeros((b, q))
    weight = sp.xy.new_zeros((b, q))
    contrib_n = 0
    longest = int((stop - start).max()) if b else 0
    ar = torch.arange(chunk, device=dev)
    for k0 in range(0, longest, chunk):
        if not bool(((prod.detach() >= R.t_terminate) & inside).any()):
            break
        idx = start[:, None] + k0 + ar[None]
        ok_i = idx < stop[:, None]
        gi = bins.gid[torch.clamp(torch.where(ok_i, idx, start[:, None]), 0,
                                  max(bins.gid.numel() - 1, 0))]
        xy, cn = sp.xy[gi], sp.conic[gi]
        dx = xy[..., 0:1] - px[:, None, :]
        dy = xy[..., 1:2] - py[:, None, :]
        power = -0.5 * (cn[..., 0:1] * dx * dx + cn[..., 2:3] * dy * dy) \
            - cn[..., 1:2] * dx * dy
        alpha = torch.clamp_max(sp.opac[gi][..., None] * torch.exp(power),
                                R.alpha_cap)
        ok = ((power <= 0) & (alpha >= R.alpha_min) & ok_i[..., None]
              & inside[:, None, :]).detach()
        a_eff = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
        p_incl = prod[:, None, :] * torch.cumprod(a_eff, 1)
        t_excl = torch.cat([prod[:, None, :], p_incl[:, :-1]], 1)
        contrib = ok & (p_incl.detach() >= R.t_terminate)
        w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
        color = color + torch.einsum("bgq,bgc->bcq", w, sp.color[gi])
        depth = depth + torch.einsum("bgq,bg->bq", w, sp.depth[gi])
        weight = weight + w.sum(1)
        prod = p_incl[:, -1]
        if count:
            contrib_n += int(contrib.sum())
    return Image(tiles, color, depth, weight, inside, contrib_n)


def untile(x, tiles, cam: Cam, R: Raster):
    """Scatter tile-major [T', ..., Q] rows into an image [..., H, W]."""
    tx, ty = grid(cam, R)
    full = x.new_zeros((tx * ty,) + tuple(x.shape[1:]))
    full[tiles] = x
    lead = tuple(x.shape[1:-1])
    n = len(lead)
    img = full.reshape((ty, tx) + lead + (R.tile_h, R.tile_w))
    # (ty, tx, lead..., th, tw) -> (lead..., ty, th, tx, tw)
    img = img.permute(*range(2, 2 + n), 0, 2 + n, 1, 3 + n)
    img = img.reshape(lead + (ty * R.tile_h, tx * R.tile_w))
    return img[..., :cam.height, :cam.width]


def to_tiles(img, tiles, cam: Cam, R: Raster):
    """[..., H, W] -> tile-major [T', ..., Q] rows of ``tiles``."""
    tx, ty = grid(cam, R)
    lead = tuple(img.shape[:-2])
    pad = torch.nn.functional.pad(
        img, (0, tx * R.tile_w - cam.width, 0, ty * R.tile_h - cam.height))
    x = pad.reshape(lead + (ty, R.tile_h, tx, R.tile_w))
    x = x.movedim(-3, -2).reshape(lead + (ty * tx, R.tile_h * R.tile_w))
    return x.movedim(-2, 0)[tiles]


def render(fields, view, cam: Cam, R: Raster, bins: Bins = None,
           chunk: int = 64, tf32: bool = False, count: bool = False):
    """The whole image: ``(color [3, H, W], depth [H, W], weight [H, W],
    contributing pairs, pairs binned)``."""
    sp = project(fields, view, cam, R, tf32=tf32)
    bins = bin_pairs(sp, cam, R) if bins is None else bins
    q = R.tile_h * R.tile_w
    parts = [blend_tiles(sp, bins, t, cam, R, chunk, count)
             for t in tile_batches(bins, q, chunk)]
    tiles = torch.cat([p.tiles for p in parts])
    img = lambda k: untile(torch.cat([getattr(p, k) for p in parts]), tiles,
                           cam, R)
    return (img("color"), img("depth"), img("weight"),
            sum(p.contrib for p in parts), bins.gid.numel())


def target_frame(fields, view, cam: Cam, R: Raster, rgb_noise: float,
                 depth_noise: float, gen: torch.Generator):
    """A sensor frame of the scene: the render, its geometric depth
    (depth / silhouette where the silhouette passes 0.5, else 0) and
    Gaussian sensor noise drawn from ``gen``."""
    with torch.no_grad():
        color, depth, weight, _, _ = render(fields, view, cam, R)
        d = torch.where(weight > 0.5, depth / torch.clamp_min(weight, 1e-6),
                        torch.zeros_like(depth))
        rgb = torch.clamp(color + rgb_noise * torch.randn(
            color.shape, generator=gen, device=color.device), 0.0, 1.0)
        d = torch.where(d > 0, d + depth_noise * d * torch.randn(
            d.shape, generator=gen, device=d.device), torch.zeros_like(d))
    return rgb, d


# --------------------------------------------------------------------------
# the mapping step
# --------------------------------------------------------------------------

FIELDS = ("means3D", "scales_log", "rotations", "opacities_logit", "sh")


def map_loss_and_grads(params: dict, active, views, rgbs, depths, wts,
                       cam: Cam, R: Raster, w_color: float, w_depth: float,
                       chunk: int = 64, tf32: bool = False):
    """The mapping loss over a keyframe window and its gradient in every
    field: for each keyframe ``wt * (w_color * mean |color - rgb| +
    w_depth * masked mean |depth / max(silhouette, 0.5) - gt|)``, summed
    and divided by the weights' sum.  The loss is a sum over pixels, so
    each batch of tiles is differentiated on its own and the gradients
    add up.  Returns ``(loss, {field: grad})``."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    q = R.tile_h * R.tile_w
    wsum = float(torch.clamp_min(wts.sum(), 1e-9))
    total = 0.0
    for i in range(views.shape[0]):
        wt = float(wts[i]) / wsum
        if wt == 0.0:
            continue
        nc = 3 * cam.height * cam.width
        nd = max(int((depths[i] > 0).sum()), 1)
        with torch.no_grad():
            sp0 = project(gaussian_fields(*[leaves[k] for k in FIELDS],
                                          active), views[i], cam, R,
                          tf32=tf32)
            bins = bin_pairs(sp0, cam, R)
        for t in tile_batches(bins, q, chunk):
            sp = project(gaussian_fields(*[leaves[k] for k in FIELDS],
                                         active), views[i], cam, R,
                         tf32=tf32)
            im = blend_tiles(sp, bins, t, cam, R, chunk)
            rgb = to_tiles(rgbs[i], t, cam, R)
            gt = to_tiles(depths[i], t, cam, R)
            ins = im.inside
            lc = (torch.abs(im.color - rgb) * ins[:, None]).sum() / nc
            dv = (gt > 0) & ins
            dest = im.depth / torch.clamp_min(im.weight, 0.5)
            ld = (torch.abs(dest - gt) * dv).sum() / nd
            loss = wt * (w_color * lc + w_depth * ld)
            loss.backward()
            total += float(loss.detach())
    return total, {k: leaves[k].grad.detach() for k in FIELDS}


def adam_update(param, grad, m, v, step: int, lr: float,
                betas=(0.9, 0.999), eps: float = 1e-8):
    """One Adam step from moments ``m``, ``v`` after ``step - 1`` steps:
    ``(new param, new m, new v)``."""
    b1, b2 = betas
    m = b1 * m + (1 - b1) * grad
    v = b2 * v + (1 - b2) * grad * grad
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    denom = torch.sqrt(v) / math.sqrt(bc2) + eps
    return param - (lr / bc1) * m / denom, m, v


def map_lrs(mcfg: dict, step: int) -> dict:
    """Each field's learning rate at optimizer step ``step`` (1-based):
    the geometry fields decay as ``max(decay ** ((step - 1) / steps),
    floor)``."""
    base = dict(means3D=mcfg["lr_means"], scales_log=mcfg["lr_scales"],
                rotations=mcfg["lr_rotations"],
                opacities_logit=mcfg["lr_opacities"], sh=mcfg["lr_sh"])
    decay = mcfg.get("lr_decay", 1.0)
    if decay >= 1.0:
        return base
    f = max(decay ** ((step - 1) / mcfg.get("lr_decay_steps", 500)),
            mcfg.get("lr_decay_floor", 0.1))
    return {k: lr * f if k in FIELDS[:3] else lr for k, lr in base.items()}


# --------------------------------------------------------------------------
# tracking
# --------------------------------------------------------------------------


def hat(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_se3(xi):
    """(6,) twist (v, w) -> (4, 4) rigid transform, column convention."""
    v, w = xi[:3], xi[3:]
    t2 = (w * w).sum()
    small = t2 < 1e-12
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1 - t2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(th)) / t2s)
    c = torch.where(small, 1 / 6 - t2 / 120, (th - torch.sin(th)) / (t2s * th))
    k = hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    rot = eye + a * k + b * (k @ k)
    vm = eye + b * k + c * (k @ k)
    top = torch.cat([rot, (vm @ v)[:, None]], 1)
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype,
                        device=xi.device)
    return torch.cat([top, last], 0)


def apply_twist(view, xi):
    """``w2c' = exp(xi) @ w2c`` in the row-vector convention."""
    return view @ exp_se3(xi).T


def downsample(rgb, depth, s: int):
    """Mean-pool RGB by ``s``; depth pools over valid (> 0) pixels."""
    c, h, w = rgb.shape
    rgb = rgb.reshape(c, h // s, s, w // s, s).mean((2, 4))
    d = depth.reshape(h // s, s, w // s, s)
    v = (d > 0).to(d.dtype)
    nv = v.sum((1, 3))
    return rgb, torch.where(nv > 0, (d * v).sum((1, 3))
                            / torch.clamp_min(nv, 1), torch.zeros_like(nv))


class _Level:
    """One pyramid level of the tracker: the map, the target and the
    camera, and (frozen binning) the pairs binned at the level's start."""

    def __init__(self, fields, view0, rgb, depth, cam, R, tcfg, tf32,
                 chunk):
        self.fields, self.view0 = fields, view0
        self.rgb, self.depth, self.cam, self.R = rgb, depth, cam, R
        self.t, self.tf32, self.chunk = tcfg, tf32, chunk
        self.bins = None
        if tcfg["freeze_binning"]:
            m = float(tcfg["bin_margin_px"])
            sp = project(fields, view0, cam, R, tf32=tf32)
            self.bins = bin_pairs(sp, cam, R, margin=m + 1.0,
                                  exact_margin=m)

    def image(self, xi):
        view = apply_twist(self.view0, xi)
        sp = project(self.fields, view, self.cam, self.R,
                     view_cov=view.detach(), tf32=self.tf32)
        bins = self.bins if self.bins is not None else \
            bin_pairs(sp, self.cam, self.R)
        q = self.R.tile_h * self.R.tile_w
        parts = [blend_tiles(sp, bins, t, self.cam, self.R, self.chunk)
                 for t in tile_batches(bins, q, self.chunk)]
        tiles = torch.cat([p.tiles for p in parts])
        img = lambda k: untile(torch.cat([getattr(p, k) for p in parts]),
                               tiles, self.cam, self.R)
        return img("color"), img("depth"), img("weight")

    def residuals(self, color, depth, sil, m):
        rc = ((color - self.rgb) * m[None]).reshape(-1)
        rd = ((depth / torch.clamp_min(sil, 1e-6) - self.depth)
              * m).reshape(-1)
        return torch.cat([math.sqrt(self.t["w_color"]) * rc,
                          math.sqrt(self.t["w_depth"]) * rd])

    def mask(self, sil):
        return ((sil > self.t["sil_threshold"])
                & (self.depth > 0)).to(self.rgb.dtype)

    def huber(self, r):
        w = 1.0 / torch.sqrt(1.0 + (r / self.t["huber"]) ** 2)
        return 0.5 * (w * r * r).sum(), w

    def cost(self, xi):
        color, depth, sil = self.image(xi)
        return self.huber(self.residuals(color, depth, sil,
                                         self.mask(sil)))[0]

    def normal_eqs(self, xi):
        """``(J^T W J, J^T W r, cost)`` at ``xi``: the Jacobian one column
        a forward-mode pass."""
        cols, r = [], None
        for k in range(6):
            with fwAD.dual_level():
                tan = torch.zeros(6, dtype=xi.dtype, device=xi.device)
                tan[k] = 1.0
                color, depth, sil = self.image(fwAD.make_dual(xi, tan))
                cp, ct = fwAD.unpack_dual(color)
                dp, dt = fwAD.unpack_dual(depth)
                sp_, st = fwAD.unpack_dual(sil)
                m = self.mask(sp_)
                if r is None:
                    r = self.residuals(cp, dp, sp_, m)
                silc = torch.clamp_min(sp_, 1e-6)
                dsil = torch.where(sp_ > 1e-6, st, torch.zeros_like(st))
                jc = (ct * m[None]).reshape(-1)
                jd = ((dt * silc - dp * dsil) / (silc * silc) * m).reshape(-1)
                cols.append(torch.cat([math.sqrt(self.t["w_color"]) * jc,
                                       math.sqrt(self.t["w_depth"]) * jd]))
        jac = torch.stack(cols)
        cost, w = self.huber(r)
        jw = jac * w[None]
        return jw @ jac.T, jw @ r, cost


def _lm_solve(h, g, lam):
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    a = h + lam * torch.diag(torch.diag(h)) + 1e-9 * eye
    return torch.linalg.solve_ex(a, -g)[0]


def _damping(accept, lam):
    return torch.where(accept, torch.clamp_min(lam / 3.0, 1e-7),
                       torch.clamp_max(lam * 5.0, 1e3))


def _gn(lv: _Level):
    t = lv.t
    dev, dt = lv.view0.device, lv.view0.dtype
    zero = torch.zeros(6, dtype=dt, device=dev)
    inf = torch.full((), math.inf, dtype=dt, device=dev)
    lam = torch.full((), t["lam0"], dtype=dt, device=dev)
    best_xi, best_cost = zero, inf
    if t["line_search"]:
        xi = zero
        for _ in range(t["iters"]):
            h, g, cost = lv.normal_eqs(xi)
            better = cost < best_cost
            best_xi = torch.where(better, xi, best_xi)
            best_cost = torch.where(better, cost, best_cost)
            dx = _lm_solve(h, g, lam)
            xi2 = xi + dx
            accept = (lv.cost(xi2) < cost) & torch.isfinite(dx).all()
            xi = torch.where(accept, xi2, xi)
            lam = _damping(accept, lam)
        final = lv.cost(xi)
        better = final < best_cost
        return torch.where(better, xi, best_xi)
    anchor, dx, cost_anchor = zero, zero, inf
    for _ in range(t["iters"]):
        xi_try = anchor + dx
        h, g, cost = lv.normal_eqs(xi_try)
        better = cost < best_cost
        best_xi = torch.where(better, xi_try, best_xi)
        best_cost = torch.where(better, cost, best_cost)
        accept = cost < cost_anchor
        lam = _damping(accept, lam)
        dx_new = _lm_solve(h, g, lam)
        ok = torch.isfinite(dx_new).all()
        dx = torch.where(accept & ok, dx_new, 0.5 * dx)
        anchor = torch.where(accept, xi_try, anchor)
        cost_anchor = torch.where(accept, cost, cost_anchor)
    return best_xi


def track(fields, view0, rgb, depth, cam: Cam, R: Raster, tcfg: dict,
          tf32: bool = False, chunk: int = 64):
    """The pose of a frame against a frozen map by Gauss-Newton on the
    twist, coarse to fine: ``pyramid - 1`` mean-pooled levels of
    ``coarse_iters`` iterations, then ``iters`` at full resolution."""
    fields = tuple(f.detach() for f in fields)
    view = view0.detach()
    levels = [2 ** lv for lv in range(max(tcfg["pyramid"], 1) - 1, 0, -1)
              if not (cam.height % 2 ** lv or cam.width % 2 ** lv)]
    with torch.no_grad():
        for s in levels + [1]:
            t = dict(tcfg)
            if s > 1:
                t["iters"] = tcfg["coarse_iters"]
                r, d = downsample(rgb, depth, s)
            else:
                r, d = rgb, depth
            lv = _Level(fields, view, r, d, cam.scaled(s), R, t, tf32, chunk)
            view = apply_twist(view, _gn(lv))
    return view


def dual_render(fields, view0, cam: Cam, R: Raster, tf32: bool = False,
                chunk: int = 64):
    """The render at ``view0`` and its derivatives along the six twist
    directions of the pose (``apply_twist(view0, xi)`` at ``xi = 0``), the
    light pose Jacobian: ``(primal [n], tangents [6, n])``, each the
    colour, depth and silhouette images flattened one after another."""
    fields = tuple(f.detach() for f in fields)
    lv = _Level(fields, view0.detach(), None, None, cam, R,
                dict(freeze_binning=False), tf32, chunk)
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

