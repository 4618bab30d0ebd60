"""The render op, forward (PyTorch port of the JAX package's
``ops/rasterize.py``).

Pipeline::

  preprocess          per-Gaussian projection, plain autograd-capable torch
  -> bin_gaussians    instance expansion + stable (tile, depth) sort
  -> render core      one row gather of the sorted feature table, then the
                      forward blend (the CUDA kernel on the card, the plain
                      version on the CPU), inside a torch.autograd.Function
  -> image assembly   background composite, tile -> image layout, and the
                      deterministic per-Gaussian uncertainty sums

The render core's backward is not ported yet: a gradient request through
the core raises ``NotImplementedError`` instead of returning wrong
gradients.  ``track_off``/``map_off`` detach the view matrix or the Gaussian
parameters, as the JAX version stops their gradients.
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..config import RasterConfig
from .binning import bin_gaussians, default_max_instances
from .kernels.render import CoreOutputs, core_fwd, scatter_sum
from .oracle import RenderOutputs
from .projection import preprocess
from .tiling import grid_dims, img_to_tiles, tiles_to_img

BACKWARD_MISSING = (
    "the render core's backward is not ported yet: it comes with the "
    "backward slice of the port (the counterparts of the TPU kernels "
    "render_pallas._bwd_kernel and segment_sum._kernel)")


class _RenderCore(torch.autograd.Function):
    """Sorted-order row gather + forward blend over the per-Gaussian feature
    table ``feat`` [P, 11] (xy, conic, opacity, color, depth,
    depth_sgview)."""

    @staticmethod
    def forward(ctx, feat, gauss_sorted, tile_start, tile_stop, gt_tiles,
                cfg, tiles_x, height, width):
        table = feat[gauss_sorted].contiguous()            # [cap, 11]
        out = core_fwd(table, tile_start, tile_stop, gt_tiles, cfg=cfg,
                       tiles_x=tiles_x, height=height, width=width)
        ctx.mark_non_differentiable(out.n_contrib, out.n_valid, out.midx,
                                    out.npix_inst)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_MISSING)


def count_instances(means3D, camera: Camera, cfg: RasterConfig = None, *,
                    opacities, scales=None, rotations=None,
                    cov3D_precomp=None, shs=None, sh_degree: int = 0,
                    colors_precomp=None, scale_modifier: float = 1.0,
                    **_unused):
    """True (uncapped) tile-instance count for this scene and view, the way
    to size ``max_instances``.  Accepts and ignores the rest of
    :func:`rasterize`'s keywords."""
    cfg = RasterConfig() if cfg is None else cfg
    prep = preprocess(
        means3D, camera, cfg, opacities=opacities, scales=scales,
        rotations=rotations, cov3D_precomp=cov3D_precomp, shs=shs,
        sh_degree=sh_degree, colors_precomp=colors_precomp,
        scale_modifier=scale_modifier)
    return prep.tiles_touched.to(torch.int64).sum()


def prepare(means3D, camera: Camera, cfg: RasterConfig, max_instances: int,
            gt_depth, **prep_kw):
    """The stages before the render core: preprocess, binning, the
    per-Gaussian feature table ``feat`` [P, 11] and the tile-major
    ground-truth depth.  Returns ``(prep, binn, feat, gt_tiles)``."""
    h, w = camera.height, camera.width
    prep = preprocess(means3D, camera, cfg, **prep_kw)
    tiles_x, tiles_y = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    binn = bin_gaussians(prep, tiles_x, tiles_y, max_instances,
                         tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                         alpha_min=cfg.alpha_min, margin_px=cfg.bin_margin_px)
    feat = torch.cat(
        [prep.xy, prep.conic, prep.opacity[:, None], prep.color,
         prep.depth[:, None], prep.depth_sgview[:, None]], dim=1)
    gt_tiles = img_to_tiles(gt_depth, cfg.tile_h, cfg.tile_w).contiguous()
    return prep, binn, feat, gt_tiles


def rasterize(means3D, camera: Camera, cfg: RasterConfig = None, *,
              opacities, scales=None, rotations=None, cov3D_precomp=None,
              shs=None, sh_degree: int = 0, colors_precomp=None,
              scale_modifier: float = 1.0, bg=None, gt_depth=None,
              means2D=None, track_off: bool = False, map_off: bool = False,
              max_instances=None) -> RenderOutputs:
    """Render Gaussians (forward).

    Runs where the tensors are: the render core launches the CUDA kernel on
    CUDA tensors and the plain version on CPU tensors.  ``max_instances``
    defaults to ``cfg.max_instances`` or ``P * cfg.instance_multiplier``;
    when the true count exceeds it, ``overflow`` is set (see
    ``ops.binning`` for what is dropped).
    """
    cfg = RasterConfig() if cfg is None else cfg
    if cfg.splat_basis_power:
        raise NotImplementedError(
            "splat_basis_power=True is not ported: the port evaluates the "
            "splat exponent in its direct form only")
    h, w = camera.height, camera.width
    dtype, dev = means3D.dtype, means3D.device
    if bg is None:
        bg = torch.zeros(3, dtype=dtype, device=dev)
    if gt_depth is None:
        gt_depth = torch.zeros((h, w), dtype=dtype, device=dev)
    gt_depth = gt_depth.detach().reshape(h, w)

    if track_off:
        camera = camera.replace(viewmatrix=camera.viewmatrix.detach())
    if map_off:
        det = lambda x: None if x is None else x.detach()
        means3D, means2D, opacities = det(means3D), det(means2D), \
            det(opacities)
        scales, rotations = det(scales), det(rotations)
        cov3D_precomp, shs = det(cov3D_precomp), det(shs)
        colors_precomp = det(colors_precomp)

    p = means3D.shape[0]
    if max_instances is None:
        max_instances = cfg.max_instances or default_max_instances(
            p, cfg.instance_multiplier)
    prep, binn, feat, gt_tiles = prepare(
        means3D, camera, cfg, max_instances, gt_depth, opacities=opacities,
        scales=scales, rotations=rotations, cov3D_precomp=cov3D_precomp,
        shs=shs, sh_degree=sh_degree, colors_precomp=colors_precomp,
        scale_modifier=scale_modifier, means2D=means2D)
    tiles_x, _ = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    out = CoreOutputs(*_RenderCore.apply(
        feat, binn.gauss_id, binn.tile_start, binn.tile_stop, gt_tiles, cfg,
        tiles_x, h, w))

    color_tiles = out.color + out.t_final[:, None, :] * bg[None, :, None]
    color_img = tiles_to_img(color_tiles.movedim(1, 0), h, w, cfg.tile_h,
                             cfg.tile_w)
    to_img = lambda x: tiles_to_img(x, h, w, cfg.tile_h, cfg.tile_w)

    var_tiles = out.var
    if cfg.ref_depth_var:
        # value 0 like the reference forward; its gradient is the true
        # variance's, like the reference backward
        var_tiles = var_tiles - var_tiles.detach()

    # the budget's unused tail maps to the last Gaussian; dropping its keys
    # keeps that Gaussian's segment short (its values are zeros anyway)
    keys = torch.where(binn.valid, binn.gauss_id,
                       torch.full_like(binn.gauss_id, -1))
    gau_u, gau_npix = scatter_sum(keys, out.u_inst.detach(), out.npix_inst, p)

    return RenderOutputs(
        color=color_img,
        radii=prep.radius,
        depth=to_img(out.depth)[None],
        depth_median=to_img(out.median)[None],
        depth_var=to_img(var_tiles)[None],
        opacity_map=to_img(out.weight)[None],
        gau_uncertainty=gau_u[:, None],
        gau_related_pixels=gau_npix[:, None],
        n_contrib=to_img(out.n_contrib),
        n_valid=to_img(out.n_valid),
        num_rendered=binn.num_rendered,
        overflow=binn.overflow,
    )
