"""The render op, forward and backward (PyTorch port of the JAX package's
``ops/rasterize.py``).

Pipeline::

  preprocess          per-Gaussian projection, plain autograd-capable torch
  -> bin_gaussians    instance expansion + stable (tile, depth) sort
  -> render core      one row gather of the sorted feature table, then the
                      forward blend (the CUDA kernel on the card, the plain
                      version on the CPU), inside a torch.autograd.Function
  -> image assembly   background composite, tile -> image layout, and the
                      deterministic per-Gaussian uncertainty sums
                      (``segment_sum_rows`` over the binning's runs)

The render core's backward is analytic: the backward blend writes one
gradient row per instance and ``segment_sum_rows`` reduces them, in order,
onto the Gaussians (both CUDA kernels on the card, their plain versions on
the CPU); no float atomics, so gradients are bit-reproducible.  Every other
gradient (conic -> covariance -> scale/rotation/mean, the screen position
-> mean and view matrix, SH -> color) is autograd through ``preprocess``.
Median depth and the variance's direct term read the pose-stopped depth
copy (column 10 of the feature table), so they move the means but never
the pose.  ``track_off``/``map_off`` detach the view matrix or the Gaussian
parameters, as the JAX version stops their gradients.

``rasterize_with_pose_jvp`` is the forward-mode companion used by
Gauss-Newton tracking: one dual render gives the image and its derivatives
along K view-matrix directions (the ``render_jvp`` kernel on the card).
``bin_for_view`` computes a binning once so that later renders at nearby
poses reuse it (``binn=``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from ..config import RasterConfig
from .binning import Binned, bin_gaussians, default_max_instances
from .kernels.render import (FEAT, CoreOutputs, core_bwd, core_fwd,
                             core_fwd_jvp)
from .kernels.segment_sum import segment_sum_rows
from .oracle import RenderOutputs
from .projection import preprocess
from .tiling import grid_dims, img_to_tiles, tiles_to_img


class _RenderCore(torch.autograd.Function):
    """Sorted-order row gather + blend over the per-Gaussian feature table
    ``feat`` [P, 11] (xy, conic, opacity, color, depth, depth_sgview).

    The backward returns d ``feat`` itself, from the backward core's rows
    reduced per Gaussian over its pre-sort run (``inv``, ``gauss_start``,
    ``gauss_stop`` of the binning); autograd's own backward of the gather
    (a scatter with atomics on the card) is never used.  An output the loss
    never touches arrives as ``None``: the median and variance streams are
    then skipped (``want_med``/``want_var``), and any other is a zero.
    """

    @staticmethod
    def forward(ctx, feat, gauss_sorted, tile_start, tile_stop, gt_tiles,
                inv, gauss_start, gauss_stop, cfg, tiles_x, height, width):
        table = feat[gauss_sorted].contiguous()            # [cap, 11]
        out = core_fwd(table, tile_start, tile_stop, gt_tiles, cfg=cfg,
                       tiles_x=tiles_x, height=height, width=width)
        ctx.mark_non_differentiable(out.n_contrib, out.n_valid, out.midx,
                                    out.npix_inst)
        ctx.set_materialize_grads(False)
        # out.var is the true variance, before any ref_depth_var zeroing
        ctx.save_for_backward(table, tile_start, tile_stop, gt_tiles,
                              out.color, out.depth, out.weight, out.var,
                              out.t_final, inv, gauss_start, gauss_stop)
        ctx.geometry = (cfg, tiles_x, height, width)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_color, d_depth, d_weight, d_median, d_var, d_tfinal,
                 *_unused):
        (table, tile_start, tile_stop, gt_tiles, color, depth, weight, var,
         t_final, inv, gauss_start, gauss_stop) = ctx.saved_tensors
        cfg, tiles_x, height, width = ctx.geometry
        cots = (d_color, d_depth, d_weight, d_var, d_median, d_tfinal)
        nones = (None,) * 11
        if all(c is None for c in cots):
            return (None,) + nones
        zero = lambda c, like: torch.zeros_like(like) if c is None \
            else c.contiguous()
        rows = core_bwd(
            table, tile_start, tile_stop, gt_tiles,
            (color, depth, weight, var, t_final),
            (zero(d_color, color), zero(d_depth, depth),
             zero(d_weight, weight), zero(d_var, var),
             zero(d_median, depth), zero(d_tfinal, t_final)),
            cfg=cfg, tiles_x=tiles_x, height=height, width=width,
            want_med=d_median is not None, want_var=d_var is not None)
        g = segment_sum_rows(rows, inv, gauss_start, gauss_stop)  # [P, 12]
        # the median and variance rows both belong to depth_sgview
        d_feat = torch.cat([g[:, :10], (g[:, 10] + g[:, 11])[:, None]], 1)
        return (d_feat,) + nones


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


def _bin(prep, camera: Camera, cfg: RasterConfig, max_instances: int):
    tiles_x, tiles_y = grid_dims(camera.height, camera.width, cfg.tile_h,
                                 cfg.tile_w)
    return bin_gaussians(prep, tiles_x, tiles_y, max_instances,
                         tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                         alpha_min=cfg.alpha_min, margin_px=cfg.bin_margin_px)


def bin_for_view(means3D, camera: Camera, cfg: RasterConfig = None, *,
                 opacities, scales=None, rotations=None, cov3D_precomp=None,
                 shs=None, sh_degree: int = 0, colors_precomp=None,
                 scale_modifier: float = 1.0, max_instances=None,
                 **_unused) -> Binned:
    """The binning of this view (expansion, sort, ranges), for reuse by
    ``rasterize(..., binn=...)`` and ``rasterize_with_pose_jvp``.

    ``cfg.bin_margin_px`` sets the image motion the reuse must survive:
    tracking bins once per frame at its start pose with a margin and
    renders every iteration against that frozen instance assignment.
    Accepts and ignores the rest of :func:`rasterize`'s keywords.
    """
    cfg = RasterConfig() if cfg is None else cfg
    if max_instances is None:
        max_instances = cfg.max_instances or default_max_instances(
            means3D.shape[0], cfg.instance_multiplier)
    with torch.no_grad():
        prep = preprocess(
            means3D, camera, cfg, opacities=opacities, scales=scales,
            rotations=rotations, cov3D_precomp=cov3D_precomp, shs=shs,
            sh_degree=sh_degree, colors_precomp=colors_precomp,
            scale_modifier=scale_modifier)
        return _bin(prep, camera, cfg, max_instances)


def prepare(means3D, camera: Camera, cfg: RasterConfig, max_instances: int,
            gt_depth, binn: Binned = None, **prep_kw):
    """The stages before the render core: preprocess, binning (unless
    ``binn`` is given), the per-Gaussian feature table ``feat`` [P, 11] and
    the tile-major ground-truth depth.  Returns
    ``(prep, binn, feat, gt_tiles)``."""
    prep = preprocess(means3D, camera, cfg, **prep_kw)
    if binn is None:
        binn = _bin(prep, camera, cfg, max_instances)
    feat = torch.cat(
        [prep.xy, prep.conic, prep.opacity[:, None], prep.color,
         prep.depth[:, None], prep.depth_sgview[:, None]], dim=1)
    gt_tiles = img_to_tiles(gt_depth, cfg.tile_h, cfg.tile_w).contiguous()
    return prep, binn, feat, gt_tiles


def _outputs(out: CoreOutputs, prep, binn: Binned, bg, cfg: RasterConfig,
             h: int, w: int) -> RenderOutputs:
    """Image assembly: the background composite, tile -> image layout, and
    the deterministic per-Gaussian uncertainty sums."""
    color_tiles = out.color + out.t_final[:, None, :] * bg[None, :, None]
    color_img = tiles_to_img(color_tiles.movedim(1, 0), h, w, cfg.tile_h,
                             cfg.tile_w)
    to_img = lambda x: tiles_to_img(x, h, w, cfg.tile_h, cfg.tile_w)

    var_tiles = out.var
    if cfg.ref_depth_var:
        # value 0 like the reference forward; its gradient is the true
        # variance's, like the reference backward
        var_tiles = var_tiles - var_tiles.detach()

    # each Gaussian's instances summed over its pre-sort run, in run order:
    # the order of their sorted positions too (one Gaussian's instances
    # sort by tile), and culled instances add zeros.  The pixel counts ride
    # along as floats, exact below 2**24.
    stats = torch.stack([out.u_inst.detach(),
                         out.npix_inst.to(out.u_inst.dtype)], 1)
    gau = segment_sum_rows(stats, binn.inv, binn.gauss_start,
                           binn.gauss_stop)
    gau_u, gau_npix = gau[:, 0], gau[:, 1].to(torch.int32)

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


def _defaults(means3D, h: int, w: int, bg, gt_depth):
    dtype, dev = means3D.dtype, means3D.device
    if bg is None:
        bg = torch.zeros(3, dtype=dtype, device=dev)
    if gt_depth is None:
        gt_depth = torch.zeros((h, w), dtype=dtype, device=dev)
    return bg, gt_depth.detach().reshape(h, w)


def _check_direct(cfg: RasterConfig):
    if cfg.splat_basis_power:
        raise NotImplementedError(
            "splat_basis_power=True is not ported: the port evaluates the "
            "splat exponent in its direct form only")


def rasterize(means3D, camera: Camera, cfg: RasterConfig = None, *,
              opacities, scales=None, rotations=None, cov3D_precomp=None,
              shs=None, sh_degree: int = 0, colors_precomp=None,
              scale_modifier: float = 1.0, bg=None, gt_depth=None,
              means2D=None, track_off: bool = False, map_off: bool = False,
              max_instances=None, binn: Binned = None) -> RenderOutputs:
    """Render Gaussians; differentiable w.r.t. every Gaussian parameter,
    ``means2D`` and the view matrix.

    Runs where the tensors are: the render core launches the CUDA kernels
    on CUDA tensors and the plain versions on CPU tensors.  ``max_instances``
    defaults to ``cfg.max_instances`` or ``P * cfg.instance_multiplier``;
    when the true count exceeds it, ``overflow`` is set (see
    ``ops.binning`` for what is dropped).

    ``binn``: a binning from :func:`bin_for_view` to reuse.  Its instance
    assignment, sort order and tile ranges are taken as given, while the
    per-instance features come from this call's preprocess.  It is valid
    while the binning pose's footprints (widened by its margin) cover this
    call's; the blend's per-pair test skips instances that no longer reach
    a pixel, so at the binning pose the render is the fresh one's.
    """
    cfg = RasterConfig() if cfg is None else cfg
    _check_direct(cfg)
    h, w = camera.height, camera.width
    bg, gt_depth = _defaults(means3D, h, w, bg, gt_depth)

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
        means3D, camera, cfg, max_instances, gt_depth, binn=binn,
        opacities=opacities, scales=scales, rotations=rotations,
        cov3D_precomp=cov3D_precomp, shs=shs, sh_degree=sh_degree,
        colors_precomp=colors_precomp, scale_modifier=scale_modifier,
        means2D=means2D)
    tiles_x, _ = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    out = CoreOutputs(*_RenderCore.apply(
        feat, binn.gauss_id, binn.tile_start, binn.tile_stop, gt_tiles,
        binn.inv, binn.gauss_start, binn.gauss_stop, cfg, tiles_x, h, w))
    return _outputs(out, prep, binn, bg, cfg, h, w)


class PoseJvpOutputs(NamedTuple):
    """A render and K exact pose-directional derivatives of its images.

    Derivatives flow through the splat centers and depths (and, with
    ``cfg.pose_cov2d_branch``, the 2D covariances); the binning and the
    termination and median selections are frozen, and colors carry no
    pose term.
    """

    out: RenderOutputs
    color: torch.Tensor         # [K, C, H, W]
    depth: torch.Tensor         # [K, H, W]
    opacity_map: torch.Tensor   # [K, H, W]
    depth_median: torch.Tensor  # [K, H, W], zeros (pose-detached depth)


def pose_jvp_tables(means3D, camera: Camera, cfg: RasterConfig,
                    view_tangents, max_instances, gt_depth, binn=None,
                    **prep_kw):
    """The stages of :func:`rasterize_with_pose_jvp` before its render
    core: ``(prep, binn, table, tans, gt_tiles)`` with the sorted feature
    table [I, 11] and the sorted tangent table [I, per_k * K] (per tangent
    dx, dy, ddepth and, with ``cfg.pose_cov2d_branch``, dA, dB, dC), both
    from one row gather."""
    full = bool(cfg.pose_cov2d_branch)
    p = means3D.shape[0]

    def feats_of_view(vm):
        pv = preprocess(means3D, camera.replace(viewmatrix=vm), cfg,
                        **prep_kw)
        return (pv.xy, pv.depth) + ((pv.conic,) if full else ())

    view = camera.viewmatrix
    # all K directions in one batched forward-mode pass: [K, P, ...]
    tans = torch.func.vmap(lambda t: torch.func.jvp(
        feats_of_view, (view,), (t,))[1])(view_tangents.to(view.dtype))
    tan_feat = torch.cat([tans[0], tans[1][..., None], *tans[2:]], -1)
    tan_feat = tan_feat.movedim(0, 1).reshape(p, -1)  # [P, per_k * K]
    if max_instances is None:
        max_instances = cfg.max_instances or default_max_instances(
            p, cfg.instance_multiplier)
    prep, binn, feat, gt_tiles = prepare(means3D, camera, cfg, max_instances,
                                         gt_depth, binn=binn, **prep_kw)
    rows = torch.cat([feat, tan_feat], 1)[binn.gauss_id]
    return (prep, binn, rows[:, :FEAT].contiguous(),
            rows[:, FEAT:].contiguous(), gt_tiles)


def rasterize_with_pose_jvp(means3D, camera: Camera, cfg: RasterConfig,
                            view_tangents, *, opacities, scales=None,
                            rotations=None, cov3D_precomp=None,
                            colors_precomp=None, shs=None, sh_degree: int = 0,
                            scale_modifier: float = 1.0, bg=None,
                            gt_depth=None, max_instances=None, mesh=None,
                            binn: Binned = None) -> PoseJvpOutputs:
    """Render plus K exact pose-tangent images in one dual pass.

    ``view_tangents`` [K, 4, 4] are directions in view-matrix space, e.g.
    the twist basis ``jacfwd(lambda x: lie.apply_twist(view, x))(xi)``
    moved to the front.  The per-Gaussian tangents of (xy, depth) and,
    with ``cfg.pose_cov2d_branch`` (the full variant), of the conic come
    from one batched forward-mode pass over the preprocess
    (``torch.func.vmap`` of ``torch.func.jvp``); the preprocess's detached
    copies of the view make the light variant's conic tangent and the
    median's tangent zero.  The render core is the ``render_jvp`` kernel on
    CUDA tensors and its plain version on CPU tensors.  Forward mode only:
    nothing here records a reverse-mode graph.  ``binn`` reuses a binning
    as in :func:`rasterize`; ``mesh`` (tile sharding) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "tile-sharded rendering is not ported: rasterize_with_pose_jvp "
            "runs on one device")
    _check_direct(cfg)
    h, w = camera.height, camera.width
    bg, gt_depth = _defaults(means3D, h, w, bg, gt_depth)
    full = bool(cfg.pose_cov2d_branch)
    prep_kw = dict(opacities=opacities, scales=scales, rotations=rotations,
                   cov3D_precomp=cov3D_precomp, shs=shs, sh_degree=sh_degree,
                   colors_precomp=colors_precomp,
                   scale_modifier=scale_modifier)
    with torch.no_grad():
        prep, binn, table, tans, gt_tiles = pose_jvp_tables(
            means3D, camera, cfg, view_tangents, max_instances, gt_depth,
            binn=binn, **prep_kw)
        tiles_x, _ = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
        out, tano = core_fwd_jvp(
            table, tans, binn.tile_start, binn.tile_stop, gt_tiles, cfg=cfg,
            tiles_x=tiles_x, height=h, width=w, full=full)
        primal = _outputs(out, prep, binn, bg, cfg, h, w)
        to_img = lambda x: tiles_to_img(x.movedim(0, -2), h, w, cfg.tile_h,
                                        cfg.tile_w)
        dcolor = to_img(tano.color + tano.t_final[:, :, None, :]
                        * bg[None, None, :, None])     # [K, C, H, W]
    return PoseJvpOutputs(out=primal, color=dcolor, depth=to_img(tano.depth),
                          opacity_map=to_img(tano.weight),
                          depth_median=to_img(tano.median))
