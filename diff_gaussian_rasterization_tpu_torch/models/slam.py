"""SLAM-level helpers (PyTorch port of the JAX package's ``models/slam.py``):
the render wrapper, the RGB-D loss, and the single-device mapping step.

Mapping (CG-SLAM's mapping step) is Adam on the Gaussian parameters over a
window of keyframes, each rendered with ``track_off=True``, with one
parameter group per field.  The optimizer is PyTorch's and carries its own
state, in place of the JAX version's optax state.  Tracking, densify/prune,
``mapping_round`` and the meshed (multi-device) mapping are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..camera import Camera
from ..config import RasterConfig
from ..ops.rasterize import rasterize
from .gaussians import PARAM_FIELDS, DensifyState, GaussianModel

GEOMETRY_FIELDS = ("means3D", "scales_log", "rotations")


class Frame(NamedTuple):
    rgb: Any    # (3, H, W) in [0, 1]
    depth: Any  # (H, W) metric depth; 0 = invalid


def render_model(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                 gt_depth=None, means2D=None, **kw):
    """Render a :class:`GaussianModel` from ``camera``."""
    return rasterize(model.means3D, camera, cfg, gt_depth=gt_depth,
                     means2D=means2D, **model.raster_kwargs(), **kw)


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
class MappingConfig:
    """The fields of the JAX package's ``MappingConfig`` that ``map_step``
    and ``make_map_optimizer`` read (the iteration count and the densify
    and prune thresholds belong to ``mapping_round`` and densify)."""

    lr_means: float = 1e-4
    lr_scales: float = 5e-3
    lr_rotations: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh: float = 2.5e-3
    w_color: float = 1.0
    w_depth: float = 0.5
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


def map_step(model: GaussianModel, opt: MapOptimizer, dstate: DensifyState,
             views, rgbs, depths, wts, cfg: RasterConfig,
             mcfg: MappingConfig, height: int, width: int, tanfovx: float,
             tanfovy: float, n_frames: int, mesh=None, map_axis=None):
    """One mapping gradient step over a window of ``n_frames`` keyframes
    (``views`` [K, 4, 4], ``rgbs`` [K, 3, H, W], ``depths`` [K, H, W]).

    ``wts`` [K] weights each keyframe (0 = padding); the loss divides by
    their sum, so padding a window never changes the objective.  Updates
    the model's parameters in place and returns ``(loss, dstate,
    (gau_u, gau_np))``: the loss before the step, the densification
    statistics updated with the screen-space gradient of the Gaussians
    visible in a live keyframe, and the window-summed per-Gaussian
    uncertainty statistics.
    """
    if mesh is not None or map_axis is not None:
        raise NotImplementedError(
            "meshed mapping (keyframe, tile or map sharding) is not ported: "
            "map_step runs on one device")
    opt.adam.zero_grad(set_to_none=True)
    means2d = torch.zeros_like(model.means3D[:, :2].detach(),
                               requires_grad=True)
    total = 0.0
    vis = gau_u = gau_np = None
    for i in range(n_frames):
        cam = Camera(viewmatrix=views[i], tanfovx=tanfovx, tanfovy=tanfovy,
                     height=height, width=width)
        out = render_model(model, cam, cfg, gt_depth=depths[i],
                           means2D=means2d, track_off=True)
        total = total + wts[i] * rgbd_loss(
            out, Frame(rgbs[i], depths[i]), mcfg.w_color, mcfg.w_depth)
        # window-summed per-Gaussian stats; padding frames excluded
        live = wts[i] > 0
        v_i = (out.radii > 0) & live
        u_i = out.gau_uncertainty * live.to(out.gau_uncertainty.dtype)
        n_i = out.gau_related_pixels * live.to(torch.int32)
        vis = v_i if vis is None else vis | v_i
        gau_u = u_i if gau_u is None else gau_u + u_i
        gau_np = n_i if gau_np is None else gau_np + n_i
    loss = total / torch.clamp_min(wts.sum(), 1e-9)
    loss.backward()
    opt.step()
    # densification statistics: the screen-space (NDC) position gradient
    dstate = dstate.update(means2d.grad, visible=vis)
    return loss.detach(), dstate, (gau_u, gau_np)
