"""The render op, forward and backward (PyTorch port of the JAX package's
``ops/rasterize.py``).

Every stage runs where the tensors are.  The modules of ``ops/kernels/``
make that choice, each for its own stage: on CUDA tensors the stage's
CUDA kernel, on CPU tensors its plain version, which the kernel is held
to.  This module never looks at the device.

Pipeline::

  preprocess          per-Gaussian projection and the feature table, one
                      torch.autograd.Function (``kernels/preprocess.py``:
                      ``preprocess_fwd`` / ``_bwd``)
  -> bin_gaussians    instance expansion + stable (tile, depth) sort
  -> render core      one row gather of the sorted feature table, then the
                      forward blend (``kernels/render.py``: ``render_fwd``),
                      inside a torch.autograd.Function
  -> image assembly   background composite, tile -> image layout, and the
                      deterministic per-Gaussian uncertainty sums
                      (``segment_sum_rows`` over the binning's runs)

The render core's backward is analytic: the backward blend
(``render_bwd``) writes one gradient row per instance and
``segment_sum_rows`` reduces them, in order, onto the Gaussians; no float
atomics, so gradients are bit-reproducible.  Every other gradient (conic
-> covariance -> scale/rotation/mean, the screen position -> mean and view
matrix, SH -> color) is the preprocess's closed-form backward,
bit-reproducible too.
Median depth and the variance's direct term read the pose-stopped depth
copy (column 10 of the feature table), so they move the means but never
the pose.  ``track_off``/``map_off`` detach the view matrix or the Gaussian
parameters, as the JAX version stops their gradients.

``rasterize_with_pose_jvp`` is the forward-mode companion used by
Gauss-Newton tracking: one dual render gives the image and its derivatives
along K view-matrix directions (``preprocess_tangents`` for the
per-Gaussian tangents, ``render_jvp`` for the blend).
``bin_for_view`` computes a binning once so that later renders at nearby
poses reuse it (``binn=``).

Each stage runs inside a span of ``utils.profiling`` (``render``,
``render.jvp``, ``render.preprocess``, ``render.binning``,
``render.tangents``, ``render.core_fwd``/``_bwd``/``_jvp``,
``render.assemble``) and a render counts its instances and slots (a dual
render also its colour tangents and the floats of its tangent table);
both are off, one check each, unless tracing is on.

With ``mesh=`` (a ``torch.distributed`` DeviceMesh) both renders shard the
tile grid over ``tile_axis`` (``parallel/sharded.py``): every rank calls
with the same inputs, renders its run of tiles, and gets back the whole
render, bit-equal to the unsharded one, gradients included.
``shard_binning=True`` also shards the binning (``parallel/shard_bin.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from ..config import RasterConfig
from ..parallel import shard_bin, sharded
from ..parallel.mesh import axis_size, check_mesh
from ..utils import profiling as prof
from . import blend
from .binning import Binned, bin_gaussians, default_max_instances
from .kernels.preprocess import (color_branch, preprocess_table,
                                 preprocess_tangents)
from .kernels.render import (FEAT, CoreOutputs, core_bwd, core_fwd,
                             core_fwd_jvp, tangent_columns)
from .kernels.segment_sum import segment_sum_rows
from .oracle import RenderOutputs
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
                inv, gauss_start, gauss_stop, cfg, tiles_x, height, width,
                shard):
        core_kw = dict(cfg=cfg, tiles_x=tiles_x, height=height, width=width)
        with prof.span("render.core_fwd"):
            table = feat[gauss_sorted].contiguous()        # [cap, 11]
            if shard is None:
                out = local = core_fwd(table, tile_start, tile_stop,
                                       gt_tiles, **core_kw)
            else:
                out, local = sharded.core_fwd_sharded(
                    table, tile_start, tile_stop, gt_tiles, shard,
                    **core_kw)
        ctx.mark_non_differentiable(out.n_contrib, out.n_valid, out.midx,
                                    out.npix_inst)
        ctx.set_materialize_grads(False)
        # out.var is the true variance, before any ref_depth_var zeroing;
        # n_contrib stops the backward's pixels at their last contributor.
        # A tile-sharded render keeps this rank's tiles for its backward.
        ctx.save_for_backward(table, tile_start, tile_stop, gt_tiles,
                              local.color, local.depth, local.weight,
                              local.var, local.t_final, local.n_contrib, inv,
                              gauss_start, gauss_stop)
        ctx.geometry = (core_kw, shard)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_color, d_depth, d_weight, d_median, d_var, d_tfinal,
                 *_unused):
        (table, tile_start, tile_stop, gt_tiles, color, depth, weight, var,
         t_final, n_contrib, inv, gauss_start, gauss_stop) = ctx.saved_tensors
        core_kw, shard = ctx.geometry
        cots = (d_color, d_depth, d_weight, d_var, d_median, d_tfinal)
        nones = (None,) * 12
        if all(c is None for c in cots):
            return (None,) + nones
        with prof.span("render.core_bwd"):
            # a missing cotangent is a zero of the global (tile-sharded: of
            # this rank's slice) shape, which its totals have here
            t = tile_start.shape[0]
            zero = lambda c, like: torch.zeros(
                (t,) + tuple(like.shape[1:]), dtype=like.dtype,
                device=like.device) if c is None else c.contiguous()
            cots = (zero(d_color, color), zero(d_depth, depth),
                    zero(d_weight, weight), zero(d_var, var),
                    zero(d_median, depth), zero(d_tfinal, t_final))
            kw = dict(want_med=d_median is not None,
                      want_var=d_var is not None, n_contrib=n_contrib,
                      **core_kw)
            totals = (color, depth, weight, var, t_final)
            if shard is None:
                rows = core_bwd(table, tile_start, tile_stop, gt_tiles,
                                totals, cots, **kw)
            else:
                rows = sharded.core_bwd_sharded(
                    table, tile_start, tile_stop, gt_tiles, totals, cots,
                    shard, **kw)
            g = segment_sum_rows(rows, inv, gauss_start,
                                 gauss_stop)                    # [P, 12]
            # the median and variance rows both belong to depth_sgview
            d_feat = torch.cat([g[:, :10], (g[:, 10] + g[:, 11])[:, None]],
                               1)
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
    with torch.no_grad():
        prep, _ = preprocess_table(
            means3D, camera, cfg, opacities=opacities, scales=scales,
            rotations=rotations, cov3D_precomp=cov3D_precomp, shs=shs,
            sh_degree=sh_degree, colors_precomp=colors_precomp,
            scale_modifier=scale_modifier)
    return prep.tiles_touched.to(torch.int64).sum()


def _preprocess(means3D, camera: Camera, cfg: RasterConfig, **prep_kw):
    """``preprocess_table`` inside its span, counting the slots it projects
    (``render.gaussians``).  Returns ``(prep, feat)``."""
    if prof.tracing():
        prof.count("render.gaussians", means3D.shape[0])
    with prof.span("render.preprocess"):
        return preprocess_table(means3D, camera, cfg, **prep_kw)


def _bin(prep, camera: Camera, cfg: RasterConfig, max_instances: int):
    tiles_x, tiles_y = grid_dims(camera.height, camera.width, cfg.tile_h,
                                 cfg.tile_w)
    with prof.span("render.binning"):
        return bin_gaussians(prep, tiles_x, tiles_y, max_instances,
                             tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                             alpha_min=cfg.alpha_min,
                             margin_px=cfg.bin_margin_px)


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
        prep, _ = _preprocess(
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
    prep, feat = _preprocess(means3D, camera, cfg, **prep_kw)
    if binn is None:
        binn = _bin(prep, camera, cfg, max_instances)
    if prof.tracing():
        # the true instance count, the instances that fit the slots sorted
        # and walked, the slots, the overflow flag (device values copied
        # to the host without a wait)
        slots = binn.gauss_id.shape[0]
        prof.count("render.instances", binn.num_rendered)
        prof.count("render.filled", binn.num_rendered, cap=slots)
        prof.count("render.slots", slots)
        prof.count("render.overflows", binn.overflow)
    gt_tiles = img_to_tiles(gt_depth, cfg.tile_h, cfg.tile_w).contiguous()
    return prep, binn, feat, gt_tiles


def _gaussian_sums(out: CoreOutputs, binn: Binned) -> CoreOutputs:
    """``out`` with ``u_inst`` / ``npix_inst`` summed per Gaussian [P]:
    each Gaussian's instances over its pre-sort run, in run order (the
    order of their sorted positions too: one Gaussian's instances sort by
    tile), culled instances adding zeros.  The pixel counts ride along as
    floats, exact below 2**24."""
    stats = torch.stack([out.u_inst.detach(),
                         out.npix_inst.to(out.u_inst.dtype)], 1)
    gau = segment_sum_rows(stats, binn.inv, binn.gauss_start,
                           binn.gauss_stop)
    return out._replace(u_inst=gau[:, 0], npix_inst=gau[:, 1].to(torch.int32))


def _outputs(out: CoreOutputs, prep, num_rendered, overflow, bg,
             cfg: RasterConfig, h: int, w: int) -> RenderOutputs:
    """Image assembly: the background composite and tile -> image layout;
    ``out``'s ``u_inst`` / ``npix_inst`` are per Gaussian
    (:func:`_gaussian_sums`)."""
    color_tiles = out.color + out.t_final[:, None, :] * bg[None, :, None]
    color_img = tiles_to_img(color_tiles.movedim(1, 0), h, w, cfg.tile_h,
                             cfg.tile_w)
    to_img = lambda x: tiles_to_img(x, h, w, cfg.tile_h, cfg.tile_w)

    var_tiles = out.var
    if cfg.ref_depth_var:
        # value 0 like the reference forward; its gradient is the true
        # variance's, like the reference backward
        var_tiles = var_tiles - var_tiles.detach()

    return RenderOutputs(
        color=color_img,
        radii=prep.radius,
        depth=to_img(out.depth)[None],
        depth_median=to_img(out.median)[None],
        depth_var=to_img(var_tiles)[None],
        opacity_map=to_img(out.weight)[None],
        gau_uncertainty=out.u_inst.detach()[:, None],
        gau_related_pixels=out.npix_inst[:, None],
        n_contrib=to_img(out.n_contrib),
        n_valid=to_img(out.n_valid),
        num_rendered=num_rendered,
        overflow=overflow,
    )


def _defaults(means3D, h: int, w: int, bg, gt_depth):
    dtype, dev = means3D.dtype, means3D.device
    if bg is None:
        bg = torch.zeros(3, dtype=dtype, device=dev)
    if gt_depth is None:
        gt_depth = torch.zeros((h, w), dtype=dtype, device=dev)
    return bg, gt_depth.detach().reshape(h, w)


def rasterize(means3D, camera: Camera, cfg: RasterConfig = None, *,
              opacities, scales=None, rotations=None, cov3D_precomp=None,
              shs=None, sh_degree: int = 0, colors_precomp=None,
              scale_modifier: float = 1.0, bg=None, gt_depth=None,
              means2D=None, track_off: bool = False, map_off: bool = False,
              max_instances=None, binn: Binned = None, mesh=None,
              tile_axis: str = "tile", shard_binning: bool = False,
              max_instances_per_shard: int = None) -> RenderOutputs:
    """Render Gaussians; differentiable w.r.t. every Gaussian parameter,
    ``means2D`` and the view matrix.

    Runs where the tensors are (the module docstring).  ``max_instances``
    defaults to ``cfg.max_instances`` or ``P * cfg.instance_multiplier``;
    when the true count exceeds it, ``overflow`` is set (see
    ``ops.binning`` for what is dropped).

    ``binn``: a binning from :func:`bin_for_view` to reuse.  Its instance
    assignment, sort order and tile ranges are taken as given, while the
    per-instance features come from this call's preprocess.  It is valid
    while the binning pose's footprints (widened by its margin) cover this
    call's; the blend's per-pair test skips instances that no longer reach
    a pixel, so at the binning pose the render is the fresh one's.

    ``mesh`` (a ``torch.distributed`` DeviceMesh; every rank calls with the
    same inputs): the tile grid is sharded over ``tile_axis``, each rank
    renders its run of tiles, and every rank gets the whole render and
    gradients, bit-equal to the unsharded ones.  ``shard_binning`` (with
    ``mesh``): each rank also bins only its band of tile rows
    (``parallel.shard_bin``), under ``max_instances_per_shard`` instances
    (default ``shard_bin.default_cap_per_shard``; size it from
    ``shard_bin.band_instance_counts``); ``overflow`` is then any shard's.
    """
    cfg = RasterConfig() if cfg is None else cfg
    check_mesh(mesh)
    if mesh is not None and shard_binning and binn is not None:
        raise ValueError(
            "shard_binning bins on each rank for its own band; a "
            "precomputed single-device binning cannot be reused: drop "
            "binn= or shard_binning")
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
    prep_kw = dict(
        opacities=opacities, scales=scales, rotations=rotations,
        cov3D_precomp=cov3D_precomp, shs=shs, sh_degree=sh_degree,
        colors_precomp=colors_precomp, scale_modifier=scale_modifier,
        means2D=means2D)
    tiles_x, tiles_y = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    if mesh is not None and shard_binning:
        return _shard_binned(means3D, camera, cfg, mesh, tile_axis,
                             max_instances, max_instances_per_shard, bg,
                             gt_depth, prep_kw)
    with prof.span("render"):
        prep, binn, feat, gt_tiles = prepare(
            means3D, camera, cfg, max_instances, gt_depth, binn=binn,
            **prep_kw)
        shard = None if mesh is None else sharded.tile_shard(mesh,
                                                             tile_axis)
        out = CoreOutputs(*_RenderCore.apply(
            feat, binn.gauss_id, binn.tile_start, binn.tile_stop, gt_tiles,
            binn.inv, binn.gauss_start, binn.gauss_stop, cfg, tiles_x, h, w,
            shard))
        with prof.span("render.assemble"):
            return _outputs(_gaussian_sums(out, binn), prep,
                            binn.num_rendered, binn.overflow, bg, cfg, h, w)


def _shard_binned(means3D, camera: Camera, cfg: RasterConfig, mesh,
                  tile_axis: str, max_instances: int, cap_per_shard, bg,
                  gt_depth, prep_kw) -> RenderOutputs:
    """``rasterize`` with the binning sharded over ``tile_axis``."""
    h, w = camera.height, camera.width
    tiles_x, tiles_y = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    if cap_per_shard is None:
        cap_per_shard = shard_bin.default_cap_per_shard(
            max_instances, axis_size(mesh, tile_axis))
    prep, feat = preprocess_table(means3D, camera, cfg, **prep_kw)
    gt_tiles = img_to_tiles(gt_depth, cfg.tile_h, cfg.tile_w).contiguous()
    sb = shard_bin.make_shard_binned_core(
        mesh, tile_axis, prep, gt_tiles, cfg=cfg, tiles_x=tiles_x,
        tiles_y=tiles_y, cap_per_shard=cap_per_shard, height=h,
        width=w)(feat)
    return _outputs(sb.core, prep, sb.num_rendered, sb.overflow, bg, cfg, h,
                    w)


class PoseJvpOutputs(NamedTuple):
    """A render and K exact pose-directional derivatives of its images.

    Derivatives flow through the splat centers and depths, with
    ``cfg.pose_cov2d_branch`` through the 2D covariances, and with
    ``cfg.pose_sh_branch`` through the colors that SH of degree 1 or more
    give (their view direction from the camera center; precomputed colors
    and degree 0 carry no pose term).  The binning and the termination and
    median selections are frozen.
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
    table [I, 11] and the sorted tangent table [I, per_k * K], both from
    one row gather.  Per tangent the table holds dx, dy, ddepth; then dA,
    dB, dC with ``cfg.pose_cov2d_branch``; then dr, dg, db with the colour
    branch (:func:`color_branch`), after conic columns that are zeros
    without ``pose_cov2d_branch`` (``render.tangent_columns``).  The
    primal table comes from the preprocess (:func:`prepare`), the tangents
    from ``preprocess_tangents``, the closed-form forward mode of the
    preprocess, one pass for all K.

    Tracing on, it counts the Gaussians x directions given a colour
    tangent (``render.color_tangents``) and the floats of the sorted
    tangent table (``render.tangent_floats``)."""
    full = bool(cfg.pose_cov2d_branch)
    color = color_branch(cfg, **prep_kw)
    p = means3D.shape[0]
    k_t = view_tangents.shape[0]
    if prof.tracing():
        prof.count("render.gaussians", p)
    with prof.span("render.tangents"):
        tan_feat = preprocess_tangents(
            means3D, camera, cfg,
            view_tangents.to(camera.viewmatrix.dtype), **prep_kw)
    if max_instances is None:
        max_instances = cfg.max_instances or default_max_instances(
            p, cfg.instance_multiplier)
    prep, binn, feat, gt_tiles = prepare(means3D, camera, cfg, max_instances,
                                         gt_depth, binn=binn, **prep_kw)
    rows = torch.cat([feat, tan_feat], 1)[binn.gauss_id]
    if prof.tracing():
        prof.count("render.tangent_floats",
                   rows.shape[0] * tangent_columns(full, color) * k_t)
        if color:
            prof.count("render.color_tangents", p * k_t)
    return (prep, binn, rows[:, :FEAT].contiguous(),
            rows[:, FEAT:].contiguous(), gt_tiles)


def rasterize_with_pose_jvp(means3D, camera: Camera, cfg: RasterConfig,
                            view_tangents, *, opacities, scales=None,
                            rotations=None, cov3D_precomp=None,
                            colors_precomp=None, shs=None, sh_degree: int = 0,
                            scale_modifier: float = 1.0, bg=None,
                            gt_depth=None, max_instances=None, mesh=None,
                            tile_axis: str = "tile",
                            binn: Binned = None) -> PoseJvpOutputs:
    """Render plus K exact pose-tangent images in one dual pass.

    ``view_tangents`` [K, 4, 4] are directions in view-matrix space, e.g.
    the twist basis ``jacfwd(lambda x: lie.apply_twist(view, x))(xi)``
    moved to the front.  The per-Gaussian tangents of (xy, depth), with
    ``cfg.pose_cov2d_branch`` of the conic, and with ``cfg.pose_sh_branch``
    and SH of degree 1 or more of the colour (the full variant carries
    both) come from one forward-mode pass of the preprocess
    (:func:`pose_jvp_tables`); the branch flags route the view as the
    composite ``projection.preprocess``'s detached copies do, which makes
    the light variant's conic tangent and the median's tangent zero.  The
    render core is ``render_jvp``.  Forward mode only: nothing here records
    a reverse-mode graph.  ``binn`` reuses a binning as in
    :func:`rasterize`.  ``mesh`` shards the tile grid over ``tile_axis`` as
    :func:`rasterize` does (the light variant only, as in the JAX package:
    no conic or colour tangents), bit-equal to the unsharded render.

    The tangents differentiate the direct form of the splat exponent:
    ``cfg.splat_basis_power`` raises ``ValueError`` ("pose-jvp requires the
    direct splat path", the JAX package's assertion).
    """
    blend.check_direct_for_jvp(cfg)
    check_mesh(mesh)
    prep_kw = dict(opacities=opacities, scales=scales, rotations=rotations,
                   cov3D_precomp=cov3D_precomp, shs=shs, sh_degree=sh_degree,
                   colors_precomp=colors_precomp,
                   scale_modifier=scale_modifier)
    full = bool(cfg.pose_cov2d_branch)
    color = color_branch(cfg, **prep_kw)
    if (full or color) and mesh is not None:
        raise ValueError(
            "the full variant's pose tangents (pose_cov2d_branch, "
            "pose_sh_branch with SH colors) run on one device only; the "
            "tile-sharded dual render carries the light variant's")
    h, w = camera.height, camera.width
    bg, gt_depth = _defaults(means3D, h, w, bg, gt_depth)
    with torch.no_grad(), prof.span("render.jvp"):
        prep, binn, table, tans, gt_tiles = pose_jvp_tables(
            means3D, camera, cfg, view_tangents, max_instances, gt_depth,
            binn=binn, **prep_kw)
        tiles_x, _ = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
        core_kw = dict(cfg=cfg, tiles_x=tiles_x, height=h, width=w,
                       full=full, color=color)
        with prof.span("render.core_jvp"):
            if mesh is None:
                out, tano = core_fwd_jvp(table, tans, binn.tile_start,
                                         binn.tile_stop, gt_tiles, **core_kw)
            else:
                out, tano = sharded.core_fwd_jvp_sharded(
                    table, tans, binn.tile_start, binn.tile_stop, gt_tiles,
                    sharded.tile_shard(mesh, tile_axis), **core_kw)
        with prof.span("render.assemble"):
            primal = _outputs(_gaussian_sums(out, binn), prep,
                              binn.num_rendered, binn.overflow, bg, cfg, h, w)
            to_img = lambda x: tiles_to_img(x.movedim(0, -2), h, w,
                                            cfg.tile_h, cfg.tile_w)
            dcolor = to_img(tano.color + tano.t_final[:, :, None, :]
                            * bg[None, None, :, None])     # [K, C, H, W]
            return PoseJvpOutputs(
                out=primal, color=dcolor, depth=to_img(tano.depth),
                opacity_map=to_img(tano.weight),
                depth_median=to_img(tano.median))
