"""SLAM-level helpers (PyTorch port of the JAX package's ``models/slam.py``):
the render wrapper, the RGB-D loss, single-device tracking and the
single-device mapping step.

Tracking (CG-SLAM's tracking step) fits the 6-DoF pose of a new frame
against the map, the Gaussians frozen: ``track_frame`` with exact
Gauss-Newton / Levenberg-Marquardt on the pose JVP (``"gn"``, one dual
render per iteration), Gauss-Newton on central differences of the forward
(``"gn_fd"``), or Adam on the twist (``"adam"``).  The iterations are a
Python loop whose accept/reject decisions stay on the device
(``torch.where``), so no iteration waits on the host.

Mapping (CG-SLAM's mapping step) is Adam on the Gaussian parameters over a
window of keyframes, each rendered with ``track_off=True``, with one
parameter group per field.  The optimizers are PyTorch's and carry their
own state, in place of the JAX version's optax state.  ``mapping_round``
runs a window's steps with densify and uncertainty pruning.

Every function takes an optional ``mesh`` (a ``torch.distributed``
DeviceMesh; every rank calls with the same inputs and keeps the same
replicated model, optimizer state and poses): renders shard their tiles
over ``tile_axis`` when it has more than one rank; ``map_axis`` shards the
map, each frame rendering the visible subset gathered from every rank's
rows (``parallel.sharded.gather_visible``); mapping shards a keyframe
window over ``kf_axis``, the two composed in one step when both have
more than one rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from ..camera import Camera
from ..config import RasterConfig
from ..ops.binning import default_max_instances
from ..ops.rasterize import bin_for_view, rasterize, rasterize_with_pose_jvp
from ..parallel import sharded
from ..parallel.mesh import (all_reduce, axis_group, axis_size, check_mesh,
                             has_axis)
from ..utils import profiling as prof
from . import lie
from .gaussians import (PARAM_FIELDS, DensifyState, GaussianModel,
                        densify_and_prune, prune_by_uncertainty, split_noise)

GEOMETRY_FIELDS = ("means3D", "scales_log", "rotations")


class Frame(NamedTuple):
    rgb: Any    # (3, H, W) in [0, 1]
    depth: Any  # (H, W) metric depth; 0 = invalid


def render_model(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                 gt_depth=None, means2D=None, sh_degree: int = None, **kw):
    """Render a :class:`GaussianModel` from ``camera``; ``sh_degree`` caps
    the SH degree (default: all the model's bands)."""
    return rasterize(model.means3D, camera, cfg, gt_depth=gt_depth,
                     means2D=means2D, **model.raster_kwargs(sh_degree), **kw)


def _mesh_kw(mesh, tile_axis) -> dict:
    """``rasterize``'s keywords for tile-sharded rendering, when the mesh
    has ``tile_axis`` with more than one rank."""
    if has_axis(mesh, tile_axis):
        return dict(mesh=mesh, tile_axis=tile_axis)
    return {}


class FieldModel(NamedTuple):
    """A model given by its field tensors: the visible subset of a
    map-sharded model gathered on every rank
    (``parallel.sharded.gather_visible``, ``active`` cleared on the padding
    slots), or differentiable copies of a model's fields.  Renders as a
    :class:`GaussianModel` does."""

    means3D: torch.Tensor
    scales_log: torch.Tensor
    rotations: torch.Tensor
    opacities_logit: torch.Tensor
    sh: torch.Tensor
    active: torch.Tensor

    def raster_kwargs(self, sh_degree: int = None):
        op = torch.sigmoid(self.opacities_logit)
        m = self.sh.shape[1]
        deg = int(round(m ** 0.5)) - 1 if sh_degree is None else sh_degree
        return dict(opacities=torch.where(self.active[:, None], op,
                                          torch.zeros_like(op)),
                    scales=torch.exp(self.scales_log),
                    rotations=self.rotations, shs=self.sh, sh_degree=deg)


def _gathered(g: dict, valid) -> FieldModel:
    return FieldModel(**{k: g[k] for k in PARAM_FIELDS},
                      active=g["active"] & valid)


def _map_budget(model, mesh, map_axis, map_budget: int) -> int:
    return map_budget or model.capacity // axis_size(mesh, map_axis)


def _maybe_gather(model, view, mesh, map_axis, map_budget: int):
    """Gaussian-map sharding: the visible subset (frozen at ``view``) of the
    model's rows of every rank of ``map_axis``, gathered into a working
    model; the model itself without a ``map_axis``."""
    if mesh is None or not map_axis:
        return model
    prm = {k: getattr(model, k) for k in PARAM_FIELDS}
    prm["active"] = model.active
    g, valid, _ = sharded.gather_visible(
        prm, view, mesh, map_axis,
        budget_per_shard=_map_budget(model, mesh, map_axis, map_budget))
    return _gathered(g, valid)


def rgbd_loss(out, frame: Frame, w_color: float = 1.0, w_depth: float = 0.5,
              sil_threshold: float = 0.99, tracking: bool = False):
    """L1 color + masked L1 depth.

    Depth is compared as expected depth: the accumulated depth over the
    silhouette, floored at 0.5 so that a barely covered pixel does not scale
    its gradient by ~1/silhouette.  For tracking, the loss covers only the
    pixels whose silhouette exceeds ``sil_threshold``, and is +inf when there
    are none.
    """
    depth_valid = frame.depth > 0
    dtype, dev = out.color.dtype, out.color.device
    if tracking:
        sil = out.opacity_map[0].detach() > sil_threshold
        depth_valid = depth_valid & sil
        color_mask = sil[None].to(dtype)
        nc = torch.clamp_min(color_mask.sum() * 3, 1.0)
    else:
        color_mask = torch.ones((1, 1, 1), dtype=dtype, device=dev)
        nc = out.color.numel()
    l_color = (torch.abs(out.color - frame.rgb) * color_mask).sum() / nc
    nd = torch.clamp_min(depth_valid.sum(), 1)
    depth_est = out.depth[0] / torch.clamp_min(out.opacity_map[0], 0.5)
    l_depth = (torch.abs(depth_est - frame.depth) * depth_valid).sum() / nd
    loss = w_color * l_color + w_depth * l_depth
    if tracking:
        loss = torch.where(color_mask.sum() > 0, loss,
                           torch.full_like(loss, float("inf")))
    return loss


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """The JAX package's ``TrackingConfig``, field for field."""

    iters: int = 12
    method: str = "gn"      # "gn" (exact forward-mode Jacobian)
                            # | "gn_fd" (central-difference Jacobian on the
                            #   forward path) | "adam" (first order)
    lr: float = 2e-3        # adam only
    huber: float = 0.05     # gn robust-loss scale
    lam0: float = 1e-4      # gn initial LM damping
    fd_eps: float = 2e-3    # gn_fd twist perturbation (rad / m)
    # color-led weighting: the depth residual divides by the silhouette,
    # whose Jacobian is noisy at splat edges, so it stays a mild regularizer
    w_color: float = 1.0
    w_depth: float = 0.25
    sil_threshold: float = 0.99
    # coarse to fine: track at 1/2^(L-1) ... 1/2, then full resolution;
    # a coarse level's basin covers 2^l times the image motion.  1 = off.
    pyramid: int = 1
    coarse_iters: int = 5   # iterations per coarse level
    # bin once per pyramid level (at its start pose, with bin_margin_px of
    # footprint slack) and reuse that binning in every GN iteration
    freeze_binning: bool = False
    bin_margin_px: float = 8.0
    # True: every GN step is validated by a residual render before it is
    # accepted (2 renders an iteration).  False: deferred accept, the next
    # iteration's dual render evaluates the previous trial step (a
    # rejected step is halved), 1 dual render an iteration.
    line_search: bool = False


def frozen_budget(cfg: RasterConfig, p: int, margin_px: float) -> int:
    """The instance budget of a frozen binning with ``margin_px`` of slack:
    the margin grows the instance count by about (1 + m/tw)(1 + m/th), so
    the render budget is scaled by that (rounded up to 1024), or the margin
    binning overflows and drops real instances."""
    mi = cfg.max_instances or default_max_instances(p,
                                                    cfg.instance_multiplier)
    scale = (1.0 + margin_px / cfg.tile_w) * (1.0 + margin_px / cfg.tile_h)
    return int(-(-int(mi * scale) // 1024) * 1024)


def _huber_cost(r, huber: float):
    """0.5 sum w r^2 with the Huber IRLS weights w, and w."""
    w = 1.0 / torch.sqrt(1.0 + (r / huber) ** 2)
    return 0.5 * (w * r * r).sum(), w


def _lm_solve(h, g, lam):
    """The damped normal equations' step; ``solve_ex`` does not wait on
    the host to check the factorization (a failed one gives non-finite
    entries, which the callers test)."""
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    a = h + lam * torch.diag(torch.diag(h)) + 1e-9 * eye
    return torch.linalg.solve_ex(a, -g)[0]


def _stacked(costs, tr):
    """The per-iteration costs as one tensor (empty for 0 iterations)."""
    return torch.stack(costs) if costs else tr.zero.new_zeros(0)


def _lm_damping(accept, lam):
    return torch.where(accept, torch.clamp_min(lam / 3.0, 1e-7),
                       torch.clamp_max(lam * 5.0, 1e3))


class _Tracker:
    """What the three tracking methods share at one pyramid level: the
    frozen model, the camera of a twist, and the residuals."""

    def __init__(self, model: GaussianModel, view0, rgb, depth,
                 cfg: RasterConfig, tcfg: TrackingConfig, height: int,
                 width: int, tanfovx: float, tanfovy: float, mk=None):
        self.means = model.means3D.detach()
        self.kw = {k: (v.detach() if torch.is_tensor(v) else v)
                   for k, v in model.raster_kwargs().items()}
        self.view0, self.frame = view0.detach(), Frame(rgb, depth)
        self.cfg, self.tcfg = cfg, tcfg
        self.geometry = (tanfovx, tanfovy, height, width)
        self.sqc, self.sqd = math.sqrt(tcfg.w_color), math.sqrt(tcfg.w_depth)
        self.zero = torch.zeros(6, dtype=view0.dtype, device=view0.device)
        self.inf = torch.full((), math.inf, dtype=view0.dtype,
                              device=view0.device)
        self.mk = mk or {}   # tile sharding (_mesh_kw)

    def camera(self, view) -> Camera:
        tanfovx, tanfovy, height, width = self.geometry
        return Camera(viewmatrix=view, tanfovx=tanfovx, tanfovy=tanfovy,
                      height=height, width=width)

    def render(self, xi, **kw):
        return rasterize(self.means, self.camera(lie.apply_twist(
            self.view0, xi)), self.cfg, gt_depth=self.frame.depth,
            **self.kw, **self.mk, **kw)

    def mask(self, out):
        return ((out.opacity_map[0] > self.tcfg.sil_threshold)
                & (self.frame.depth > 0)).to(self.frame.rgb.dtype)

    def residuals(self, out, m):
        sil = out.opacity_map[0]
        rc = ((out.color - self.frame.rgb) * m[None]).reshape(-1)
        depth_est = out.depth[0] / torch.clamp_min(sil, 1e-6)
        rd = ((depth_est - self.frame.depth) * m).reshape(-1)
        return torch.cat([self.sqc * rc, self.sqd * rd])


def _count_trial(accept):
    """A Gauss-Newton trial step and its accept decision (a device bool,
    copied without a wait)."""
    if prof.tracing():
        prof.count("track.gn_trials", 1)
        prof.count("track.gn_accepts", accept)


def _track_gn(tr: _Tracker, binnings=None):
    """Exact Gauss-Newton / Levenberg-Marquardt on the pose twist.

    The (N x 6) residual Jacobian comes from one ``rasterize_with_pose_jvp``
    (the render and its 6 twist-basis tangents in one dual pass) per
    evaluation.  With ``freeze_binning`` the level bins once, at its start
    pose with ``bin_margin_px`` of slack and a budget scaled to the margin,
    and every render reuses that binning (appended to ``binnings`` when a
    list is given)."""
    cfg, tcfg = tr.cfg, tr.tcfg
    bkw = {}
    if tcfg.freeze_binning:
        m = tcfg.bin_margin_px
        with prof.span("track.bin"):
            bkw["binn"] = bin_for_view(
                tr.means, tr.camera(tr.view0), cfg.replace(bin_margin_px=m),
                max_instances=frozen_budget(cfg, tr.means.shape[0], m),
                **tr.kw)
        if binnings is not None:
            binnings.append(bkw["binn"])

    def gn_eval(xi):
        with prof.span("track.gn_eval"):
            view = lie.apply_twist(tr.view0, xi)
            # twist-basis tangents of the view matrix at xi: [4, 4, 6]
            tw = torch.func.jacfwd(lambda x: lie.apply_twist(tr.view0, x))(xi)
            j = rasterize_with_pose_jvp(
                tr.means, tr.camera(view), cfg, tw.movedim(-1, 0),
                gt_depth=tr.frame.depth, **tr.kw, **tr.mk, **bkw)
            out = j.out
            m = tr.mask(out)
            r = tr.residuals(out, m)
            sil = out.opacity_map[0]
            silc = torch.clamp_min(sil, 1e-6)
            dsil = torch.where(sil > 1e-6, j.opacity_map,
                               torch.zeros_like(j.opacity_map))  # [6, H, W]
            jc = (j.color * m[None, None]).reshape(6, -1)
            jd = ((j.depth * silc[None] - out.depth[0][None] * dsil)
                  / (silc * silc)[None] * m[None]).reshape(6, -1)
            jac = torch.cat([tr.sqc * jc, tr.sqd * jd], 1)      # [6, N]
            cost, w = _huber_cost(r, tcfg.huber)
            jw = jac * w[None, :]
            return jw @ jac.T, jw @ r, cost

    def cost_at(xi):
        with prof.span("track.cost"):
            out = tr.render(xi, map_off=True, track_off=True, **bkw)
            return _huber_cost(tr.residuals(out, tr.mask(out)),
                               tcfg.huber)[0]

    lam = torch.full((), tcfg.lam0, dtype=tr.zero.dtype,
                     device=tr.zero.device)
    best_xi, best_cost, costs = tr.zero, tr.inf, []
    if tcfg.line_search:
        xi = tr.zero
        for _ in range(tcfg.iters):
            h, g, cost = gn_eval(xi)
            better = cost < best_cost
            best_xi = torch.where(better, xi, best_xi)
            best_cost = torch.where(better, cost, best_cost)
            dx = _lm_solve(h, g, lam)
            xi2 = xi + dx
            accept = (cost_at(xi2) < cost) & torch.isfinite(dx).all()
            _count_trial(accept)
            xi = torch.where(accept, xi2, xi)
            lam = _lm_damping(accept, lam)
            costs.append(cost)
        final = cost_at(xi)
        better = final < best_cost
        return (torch.where(better, xi, best_xi),
                torch.where(better, final, best_cost), _stacked(costs, tr))

    # deferred accept: anchor = last accepted point, dx = pending trial
    # step; a rejected trial keeps the anchor and retries half the step
    # with more damping.  best_* tracks every evaluated point.
    anchor, dx, cost_anchor = tr.zero, tr.zero, tr.inf
    for _ in range(tcfg.iters):
        xi_try = anchor + dx
        h, g, cost = gn_eval(xi_try)
        better = cost < best_cost
        best_xi = torch.where(better, xi_try, best_xi)
        best_cost = torch.where(better, cost, best_cost)
        accept = cost < cost_anchor
        _count_trial(accept)
        lam = _lm_damping(accept, lam)
        dx_new = _lm_solve(h, g, lam)
        ok = torch.isfinite(dx_new).all()
        dx = torch.where(accept & ok, dx_new, 0.5 * dx)
        anchor = torch.where(accept, xi_try, anchor)
        cost_anchor = torch.where(accept, cost, cost_anchor)
        costs.append(cost)
    return best_xi, best_cost, _stacked(costs, tr)


def _track_gn_fd(tr: _Tracker, binnings=None):
    """Gauss-Newton / LM with the residual Jacobian from central
    differences of the forward render (12 renders an iteration); the Huber
    weights and the mask are frozen at the iteration's base pose, so every
    column differentiates the same residual."""
    tcfg = tr.tcfg
    eps = tcfg.fd_eps

    def render_out(xi):
        return tr.render(xi, map_off=True, track_off=True)

    def base_eval(xi):
        out = render_out(xi)
        m = tr.mask(out)
        return tr.residuals(out, m), m

    lam = torch.full((), tcfg.lam0, dtype=tr.zero.dtype,
                     device=tr.zero.device)
    xi, best_xi, best_cost, costs = tr.zero, tr.zero, tr.inf, []
    basis = torch.eye(6, dtype=xi.dtype, device=xi.device) * eps
    for _ in range(tcfg.iters):
        r0, m = base_eval(xi)
        cost, w = _huber_cost(r0, tcfg.huber)
        better = cost < best_cost
        best_xi = torch.where(better, xi, best_xi)
        best_cost = torch.where(better, cost, best_cost)
        # central differences: the secant bias is O(eps^2)
        jac = torch.stack([
            (tr.residuals(render_out(xi + e), m)
             - tr.residuals(render_out(xi - e), m)) / (2.0 * eps)
            for e in basis])                                    # [6, N]
        jw = jac * w[None, :]
        dx = _lm_solve(jw @ jac.T, jw @ r0, lam)
        xi2 = xi + dx
        accept = ((_huber_cost(base_eval(xi2)[0], tcfg.huber)[0] < cost)
                  & torch.isfinite(dx).all())
        xi = torch.where(accept, xi2, xi)
        lam = _lm_damping(accept, lam)
        costs.append(cost)
    final = _huber_cost(base_eval(xi)[0], tcfg.huber)[0]
    better = final < best_cost
    return (torch.where(better, xi, best_xi),
            torch.where(better, final, best_cost), _stacked(costs, tr))


def _track_adam(tr: _Tracker, binnings=None):
    """First-order tracking: Adam on the twist through the render's
    backward (pose gradients only, ``map_off``)."""
    tcfg = tr.tcfg

    def loss_at(xi):
        out = tr.render(xi, map_off=True)
        return rgbd_loss(out, tr.frame, tcfg.w_color, tcfg.w_depth,
                         tcfg.sil_threshold, tracking=True)

    with torch.enable_grad():
        xi = tr.zero.clone().requires_grad_(True)
        opt = torch.optim.Adam([xi], lr=tcfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        best_xi, best_loss, losses = tr.zero, tr.inf, []
        for _ in range(tcfg.iters):
            opt.zero_grad(set_to_none=True)
            loss = loss_at(xi)
            loss.backward()
            loss = loss.detach()
            better = loss < best_loss
            best_xi = torch.where(better, xi.detach(), best_xi)
            best_loss = torch.where(better, loss, best_loss)
            opt.step()
            losses.append(loss)
    with torch.no_grad():
        final = loss_at(xi.detach())
    better = final < best_loss
    return (torch.where(better, xi.detach(), best_xi),
            torch.where(better, final, best_loss), _stacked(losses, tr))


def downsample_frame(frame: Frame, s: int) -> Frame:
    """Mean-pool RGB by ``s``; depth pools only over valid (> 0) pixels so
    sensor holes do not bleed zeros into the pooled depth."""
    c, h, w = frame.rgb.shape
    rgb = frame.rgb.reshape(c, h // s, s, w // s, s).mean((2, 4))
    d = frame.depth.reshape(h // s, s, w // s, s)
    v = (d > 0).to(d.dtype)
    nv = v.sum((1, 3))
    depth = torch.where(nv > 0, (d * v).sum((1, 3)) / torch.clamp_min(nv, 1),
                        torch.zeros_like(nv))
    return Frame(rgb=rgb, depth=depth)


def track_frame(model: GaussianModel, view0, frame: Frame,
                cfg: RasterConfig, tcfg: TrackingConfig,
                camera_template: Camera, mesh=None, tile_axis="tile",
                map_axis=None, map_budget: int = 0, binnings=None):
    """Pose-only optimization of one frame against the frozen model
    (CG-SLAM's tracking step).  Returns ``(view, best_cost, costs)``: the
    best view found, its cost, and the cost of every iteration at the
    finest level.

    With ``tcfg.pyramid > 1`` the pose is first converged on mean-pooled
    half/quarter-resolution copies of the frame (same field of view), then
    polished at full resolution; levels the pooling cannot divide are
    skipped.  ``binnings``, when a list, receives each frozen binning
    (``"gn"`` with ``freeze_binning``), one per level.

    With a ``mesh``: renders shard their tiles over ``tile_axis`` (when
    it has more than one rank) and, with ``map_axis``, each level first
    gathers the visible subset of the map-sharded model (visibility
    frozen at the level's start pose).
    """
    check_mesh(mesh)
    mk = _mesh_kw(mesh, tile_axis)
    impl = {"gn": _track_gn, "gn_fd": _track_gn_fd}.get(tcfg.method,
                                                        _track_adam)
    h, w = camera_template.height, camera_template.width
    fov = (camera_template.tanfovx, camera_template.tanfovy)
    view = view0.detach()
    levels = [(2 ** lvl, dataclasses.replace(tcfg, pyramid=1,
                                             iters=tcfg.coarse_iters))
              for lvl in range(max(tcfg.pyramid, 1) - 1, 0, -1)
              if not (h % 2 ** lvl or w % 2 ** lvl)]
    with torch.no_grad(), prof.span("track.frame"):
        prof.count_true("track.active", model.active)
        for s, tcfg_l in levels + [(1, tcfg)]:
            with prof.span("track.level"):
                fl = frame if s == 1 else downsample_frame(frame, s)
                work = _maybe_gather(model, view, mesh, map_axis, map_budget)
                tr = _Tracker(work, view, fl.rgb, fl.depth, cfg, tcfg_l,
                              h // s, w // s, *fov, mk=mk)
                xi, cost, costs = impl(tr, binnings)
                view = lie.apply_twist(tr.view0, xi)
    return view, cost, costs


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """The JAX package's ``MappingConfig``, field for field."""

    iters: int = 40
    lr_means: float = 1e-4
    lr_scales: float = 5e-3
    lr_rotations: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh: float = 2.5e-3
    w_color: float = 1.0
    w_depth: float = 0.5
    densify_grad_threshold: float = 2e-4
    uncertainty_prune: float = 0.0  # 0 disables
    # Exponential decay of the geometry learning rates (means, scales,
    # rotations): x lr_decay every lr_decay_steps map steps, continuously,
    # floored at lr_decay_floor of the initial rate.  1.0 = off.
    lr_decay: float = 1.0
    lr_decay_steps: int = 500
    lr_decay_floor: float = 0.1


def model_params(model: GaussianModel) -> dict:
    """The differentiable leaves of the model (excludes the active mask)."""
    return {k: getattr(model, k) for k in PARAM_FIELDS}


class MapOptimizer(NamedTuple):
    """Adam with one parameter group per field (in ``PARAM_FIELDS`` order),
    and the learning-rate schedule of the geometry groups (None when
    ``lr_decay`` is 1)."""

    adam: torch.optim.Adam
    schedule: Optional[torch.optim.lr_scheduler.LambdaLR]

    def step(self):
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()


def make_map_optimizer(model: GaussianModel,
                       mcfg: MappingConfig) -> MapOptimizer:
    """Per-field learning rates like 3DGS's grouped Adam.  With
    ``lr_decay < 1`` the geometry groups' rate at step k is
    ``lr * max(lr_decay ** (k / lr_decay_steps), lr_decay_floor)``: optax's
    continuous ``exponential_decay`` with ``end_value``, not
    ``ExponentialLR``."""
    lrs = dict(means3D=mcfg.lr_means, scales_log=mcfg.lr_scales,
               rotations=mcfg.lr_rotations, opacities_logit=mcfg.lr_opacities,
               sh=mcfg.lr_sh)
    adam = torch.optim.Adam(
        [dict(params=[v], lr=lrs[k], name=k)
         for k, v in model_params(model).items()], betas=(0.9, 0.999),
        eps=1e-8)
    if mcfg.lr_decay >= 1.0:
        return MapOptimizer(adam, None)

    def decay(k):
        return max(mcfg.lr_decay ** (k / mcfg.lr_decay_steps),
                   mcfg.lr_decay_floor)

    keep = lambda k: 1.0
    schedule = torch.optim.lr_scheduler.LambdaLR(
        adam, [decay if f in GEOMETRY_FIELDS else keep for f in PARAM_FIELDS])
    return MapOptimizer(adam, schedule)


@prof.spanned("map.step")
def map_step(model: GaussianModel, opt: MapOptimizer, dstate: DensifyState,
             views, rgbs, depths, wts, cfg: RasterConfig,
             mcfg: MappingConfig, height: int, width: int, tanfovx: float,
             tanfovy: float, n_frames: int, mesh=None, kf_axis="kf",
             tile_axis="tile", map_axis=None, map_budget: int = 0):
    """One mapping gradient step over a window of ``n_frames`` keyframes
    (``views`` [K, 4, 4], ``rgbs`` [K, 3, H, W], ``depths`` [K, H, W]).

    ``wts`` [K] weights each keyframe (0 = padding); the loss divides by
    their sum, so padding a window never changes the objective.  Updates
    the model's parameters in place and returns ``(loss, dstate,
    (gau_u, gau_np))``: the loss before the step, the densification
    statistics updated with the screen-space gradient of the Gaussians
    visible in a live keyframe, and the window-summed per-Gaussian
    uncertainty statistics (None with ``map_axis`` unless
    ``mcfg.uncertainty_prune`` asks for them).

    Distribution, driven by ``mesh`` (every rank calls with the same
    inputs and ends with the same model): keyframes split over ``kf_axis``
    (``sharded_value_and_grad``, the gradients all-reduced); tile-sharded
    renders over ``tile_axis``; the map sharded over ``map_axis``, each
    frame rendering the visible subset gathered from every rank's rows
    and the gradients all-reduced over it (each row from its one rank);
    keyframes x map composed in one step when both axes have more than
    one rank (``sharded_kf_map_value_and_grad``).  With a map axis the
    visibility proxy of the densification statistics is a nonzero screen
    gradient, as in the JAX package.
    """
    check_mesh(mesh)
    if map_axis is not None and mesh is None:
        raise ValueError("map_axis shards the map over a mesh: pass mesh")
    kf_sharded = has_axis(mesh, kf_axis)
    map_sharded = map_axis is not None and has_axis(mesh, map_axis)
    mk = _mesh_kw(mesh, tile_axis)
    want_stats = mcfg.uncertainty_prune > 0
    opt.adam.zero_grad(set_to_none=True)
    params = model_params(model)
    zeros2d = torch.zeros_like(model.means3D[:, :2].detach())

    def cam_of(view):
        return Camera(viewmatrix=view, tanfovx=tanfovx, tanfovy=tanfovy,
                      height=height, width=width)

    def frame_loss(out, wt, rgb, depth):
        return wt * rgbd_loss(out, Frame(rgb, depth), mcfg.w_color,
                              mcfg.w_depth)

    if kf_sharded and map_sharded:
        def loss_one_g(g, valid, view, rgb, depth, wt):
            out = rasterize(g["means3D"], cam_of(view), cfg, gt_depth=depth,
                            means2D=g["__means2d"], track_off=True,
                            **_gathered(g, valid).raster_kwargs())
            loss = frame_loss(out, wt, rgb, depth)
            if not want_stats:
                return loss
            # stats of the gathered set; the wrapper routes them back to
            # the map's rows; padding frames (wt == 0) excluded
            live = wt > 0
            return loss, (out.gau_uncertainty * live.to(torch.float32),
                          out.gau_related_pixels * live.to(torch.int32))

        vag = sharded.sharded_kf_map_value_and_grad(
            loss_one_g, mesh, kf_axis, map_axis,
            budget_per_shard=_map_budget(model, mesh, map_axis, map_budget),
            near=cfg.near, gau_stats=want_stats)
        res = vag({**params, "__means2d": zeros2d}, {"active": model.active},
                  views, rgbs, depths, wts)
        loss, grads = res[0], res[1]
        gau_u, gau_np = res[3] if want_stats else (None, None)
        g2d = grads.pop("__means2d")
        visible = g2d.abs().sum(-1) > 0
    elif kf_sharded:
        def loss_one(p, view, rgb, depth, wt):
            # no tile sharding inside the keyframe split: with a kf x tile
            # mesh each rank renders its keyframes whole (as in the JAX
            # package)
            m = FieldModel(**{k: p[k] for k in PARAM_FIELDS},
                           active=model.active)
            out = rasterize(p["means3D"], cam_of(view), cfg, gt_depth=depth,
                            means2D=p["__means2d"], track_off=True,
                            **m.raster_kwargs())
            # window-summed stats, padding frames (wt == 0) excluded, so
            # pruning and densify decisions stay mesh-invariant
            live = wt > 0
            aux = ((out.radii > 0).to(torch.int32) * live.to(torch.int32),
                   out.gau_uncertainty * live.to(torch.float32),
                   out.gau_related_pixels * live.to(torch.int32))
            return frame_loss(out, wt, rgb, depth), aux

        vag = sharded.sharded_value_and_grad(
            loss_one, mesh, kf_axis, has_aux=True, n_extra=1, weighted=True)
        loss, grads, (vis, gau_u, gau_np) = vag(
            {**params, "__means2d": zeros2d}, views, rgbs, depths, wts)
        g2d = grads.pop("__means2d")
        visible = vis > 0
    else:
        means2d = zeros2d.clone().requires_grad_(True)
        total = 0.0
        vis = gau_u = gau_np = None
        if map_axis is None and prof.tracing():
            # the active slots against the slots the renders preprocess
            prof.count_true("map.active", model.active, times=n_frames)
            prof.count("map.gaussians", n_frames * model.capacity)
        for i in range(n_frames):
            with prof.span("map.render"):
                if map_axis is not None:
                    prm = {**params, "__means2d": means2d,
                           "active": model.active}
                    g, valid, _, order = sharded.gather_visible(
                        prm, views[i], mesh, map_axis,
                        budget_per_shard=_map_budget(model, mesh, map_axis,
                                                     map_budget),
                        with_order=True)
                    means, m2d = g["means3D"], g["__means2d"]
                    kw = _gathered(g, valid).raster_kwargs()
                else:
                    means, m2d = model.means3D, means2d
                    kw = model.raster_kwargs()
                out = rasterize(means, cam_of(views[i]), cfg,
                                gt_depth=depths[i], means2D=m2d,
                                track_off=True, **kw, **mk)
                total = total + frame_loss(out, wts[i], rgbs[i], depths[i])
                # window-summed per-Gaussian stats; padding frames excluded
                live = wts[i] > 0
                u_i = out.gau_uncertainty * live.to(
                    out.gau_uncertainty.dtype)
                n_i = out.gau_related_pixels * live.to(torch.int32)
                if map_axis is None:
                    v_i = (out.radii > 0) & live
                    vis = v_i if vis is None else vis | v_i
                elif want_stats:
                    # stats of the gathered set, routed back to the map's
                    # rows
                    route = lambda st: sharded.scatter_gathered_stats(
                        st, order, valid, mesh, map_axis,
                        p_global=model.capacity)
                    u_i, n_i = route(u_i), route(n_i)
                else:
                    u_i = n_i = None
                if u_i is not None:
                    gau_u = u_i if gau_u is None else gau_u + u_i
                    gau_np = n_i if gau_np is None else gau_np + n_i
        loss = total / torch.clamp_min(wts.sum(), 1e-9)
        with prof.span("map.backward"):
            loss.backward()
        loss = loss.detach()
        g2d = means2d.grad
        if map_axis is not None:
            # each rank's gradient holds its own rows only: one all-reduce
            # adds each row's one nonzero term to zeros
            group = axis_group(mesh, map_axis)[0]
            for v in params.values():
                v.grad = all_reduce(v.grad, group)
            g2d = all_reduce(g2d, group)
            visible = g2d.abs().sum(-1) > 0
        else:
            visible = vis
        grads = None
    if grads is not None:
        for k, v in params.items():
            v.grad = grads[k]
    with prof.span("map.adam"):
        opt.step()
    # densification statistics: the screen-space (NDC) position gradient
    dstate = dstate.update(g2d, visible=visible)
    return loss, dstate, (gau_u, gau_np)


def mapping_round(model: GaussianModel, opt: MapOptimizer,
                  dstate: DensifyState, keyframes, cfg: RasterConfig,
                  mcfg: MappingConfig, cam_t: Camera, generator=None,
                  densify_every: int = 0, mesh=None, kf_axis="kf",
                  tile_axis="tile", map_axis=None, map_budget: int = 0):
    """``mcfg.iters`` map steps over one keyframe window, ``keyframes`` =
    (views [K, 4, 4], rgbs [K, 3, H, W], depths [K, H, W]).

    Every ``densify_every`` steps (0 = never) it densifies; the split
    noise is drawn once a round from ``generator`` (as the JAX version
    reuses its key within a round).  With ``mcfg.uncertainty_prune > 0``
    the last step's window-summed statistics prune by uncertainty at the
    end.  The model and ``opt`` are updated in place; returns
    ``(dstate, loss)`` with the last step's loss (None when ``iters`` is
    0).  With a mesh whose ``kf_axis`` has more than one rank, the window
    is padded to a multiple of the axis with weight-0 copies of its last
    keyframe (see :func:`map_step` for the rest of the distribution).
    """
    views, rgbs, depths = keyframes
    n = views.shape[0]
    wts = torch.ones(n, dtype=views.dtype, device=views.device)
    if has_axis(mesh, kf_axis):
        pad = -n % axis_size(mesh, kf_axis)
        if pad:
            rep = lambda a: torch.cat([a] + [a[-1:]] * pad, 0)
            views, rgbs, depths = rep(views), rep(rgbs), rep(depths)
            wts = torch.cat([wts, wts.new_zeros(pad)])
            n += pad
    loss = stats = noise = None
    for it in range(mcfg.iters):
        loss, dstate, stats = map_step(
            model, opt, dstate, views, rgbs, depths, wts, cfg, mcfg,
            cam_t.height, cam_t.width, cam_t.tanfovx, cam_t.tanfovy, n,
            mesh=mesh, kf_axis=kf_axis, tile_axis=tile_axis,
            map_axis=map_axis, map_budget=map_budget)
        if densify_every and (it + 1) % densify_every == 0:
            if noise is None:
                noise = split_noise(generator, model.capacity // 8,
                                    model.means3D.dtype,
                                    model.means3D.device)
            dstate, _ = densify_and_prune(
                model, dstate, grad_threshold=mcfg.densify_grad_threshold,
                noise=noise)
    if (mcfg.uncertainty_prune > 0 and stats is not None
            and stats[0] is not None):
        prune_by_uncertainty(model, stats[0], stats[1],
                             mcfg.uncertainty_prune)
    return dstate, loss
