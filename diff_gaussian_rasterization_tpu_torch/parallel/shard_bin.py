"""Sharded binning: each rank of a tile-sharded render bins and renders
only its band of tile rows (PyTorch port of the JAX package's
``parallel/shard_bin.py``).

The tile-sharded core of ``parallel/sharded.py`` leaves the binning
(expansion, sort, ranges) replicated: every rank bins the whole frame.
Here the whole pipeline after the per-Gaussian preprocess moves inside
the shard:

- the tile grid splits into contiguous bands of ``band_rows`` tile rows,
  one a rank;
- each rank runs ``ops.binning.bin_gaussians_band``: its splats' rects are
  clipped to the band, so its expansion and sort see about 1/n of the
  instances, under its own budget ``cap_per_shard``;
- each rank gathers its own instance table and runs the render kernels on
  its own tiles (``tile0`` = the band's first tile);
- per-Gaussian quantities (the uncertainty sums forward, the feature
  gradient backward) are reduced on each rank by ``segment_sum_rows`` over
  its band's runs and then all-reduced, and the tile-major outputs are
  all-gathered.

Each tile's instance segment is bit-identical to the full-grid binning's,
so the images equal the unsharded render; the per-Gaussian sums of a
splat that spans bands add their bands' partial sums, in another order
than the unsharded run (hence a tolerance, not bit-equality, there).
Overflow is per shard and always reported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterConfig
from ..ops.binning import INSTANCE_ALIGN, bin_gaussians_band
from ..ops.kernels.render import CoreOutputs, core_bwd, core_fwd
from ..ops.kernels.segment_sum import segment_sum_rows
from ..ops.projection import Preprocessed
from .mesh import all_gather, all_reduce, axis_group
from .sharded import local_tiles


def band_instance_counts(prep: Preprocessed, n_bands: int,
                         band_rows: int):
    """Each band's true instance count, [n_bands] int64: the rects' rows
    clipped to the band times their width (what ``bin_gaussians_band``
    enumerates before its budget).  Sizes ``max_instances_per_shard`` and
    shows the skew between bands (the deepest band bounds a shard)."""
    d = torch.arange(n_bands, device=prep.rect_min.device)[:, None]
    rmin_y = prep.rect_min[:, 1].to(torch.int64)[None]
    rmax_y = prep.rect_max[:, 1].to(torch.int64)[None]
    width = (prep.rect_max[:, 0] - prep.rect_min[:, 0]).to(torch.int64)
    y0 = torch.minimum(torch.maximum(rmin_y, d * band_rows),
                       (d + 1) * band_rows)
    y1 = torch.minimum(torch.maximum(rmax_y, d * band_rows),
                       (d + 1) * band_rows)
    rows = torch.clamp_min(y1 - y0, 0)
    live = (prep.tiles_touched > 0)[None]
    return torch.where(live, rows * width, torch.zeros_like(rows)).sum(1)


class ShardBinnedOut(NamedTuple):
    core: CoreOutputs       # tile-major fields global [T, ...]; u_inst /
                            # npix_inst per Gaussian [P]
    num_rendered: torch.Tensor  # () int64: the true global instance count
    overflow: torch.Tensor      # () bool: any shard over its budget


class _ShardBinnedCore(torch.autograd.Function):
    """One rank's render of its band, over the per-Gaussian feature table
    ``feat`` [P, 11]; the backward reduces its band's gradient rows per
    Gaussian and all-reduces them."""

    @staticmethod
    def forward(ctx, feat, gauss_id, tile_start, tile_stop, inv, gstart,
                gstop, gt_local, group, n, tile0, n_tiles, core_kw):
        table = feat[gauss_id].contiguous()
        out = core_fwd(table, tile_start, tile_stop, gt_local, tile0=tile0,
                       **core_kw)
        stats = torch.stack([out.u_inst.detach(),
                             out.npix_inst.to(out.u_inst.dtype)], 1)
        stats = all_reduce(segment_sum_rows(stats, inv, gstart, gstop), group)
        tiles = [all_gather(x, group, n)[:n_tiles] for x in out[:9]]
        npix = stats[:, 1].to(torch.int32)
        ctx.mark_non_differentiable(*tiles[6:9], npix)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(table, tile_start, tile_stop, gt_local,
                              out.color, out.depth, out.weight, out.var,
                              out.t_final, out.n_contrib, inv, gstart, gstop)
        ctx.geometry = (group, tile0, n_tiles, core_kw)
        return (*tiles, stats[:, 0], npix)

    @staticmethod
    def backward(ctx, d_color, d_depth, d_weight, d_median, d_var, d_tfinal,
                 *_unused):
        (table, tile_start, tile_stop, gt_local, color, depth, weight, var,
         t_final, n_contrib, inv, gstart, gstop) = ctx.saved_tensors
        group, tile0, n_tiles, core_kw = ctx.geometry
        nones = (None,) * 12
        cots = (d_color, d_depth, d_weight, d_var, d_median, d_tfinal)
        if all(c is None for c in cots):
            return (None,) + nones
        count = tile_start.shape[0]
        local = lambda c, like: torch.zeros_like(like) if c is None \
            else local_tiles(c, tile0, count)
        rows = core_bwd(
            table, tile_start, tile_stop, gt_local,
            (color, depth, weight, var, t_final),
            (local(d_color, color), local(d_depth, depth),
             local(d_weight, weight), local(d_var, var),
             local(d_median, depth), local(d_tfinal, t_final)),
            want_med=d_median is not None, want_var=d_var is not None,
            n_contrib=n_contrib, tile0=tile0, **core_kw)
        g = all_reduce(segment_sum_rows(rows, inv, gstart, gstop), group)
        d_feat = torch.cat([g[:, :10], (g[:, 10] + g[:, 11])[:, None]], 1)
        return (d_feat,) + nones


def make_shard_binned_core(mesh, axis: str, prep: Preprocessed, gt_tiles, *,
                           cfg: RasterConfig, tiles_x: int, tiles_y: int,
                           cap_per_shard: int, height: int, width: int):
    """``core(feat) -> ShardBinnedOut`` with the binning sharded over
    ``axis``: this rank bins its band of ``ceil(tiles_y / n)`` tile rows of
    ``prep`` (a constant of differentiation, like the binning of the
    unsharded render) under ``cap_per_shard`` instances and renders it.
    ``feat`` [P, 11] is the per-Gaussian feature table (xy, conic,
    opacity, color, depth, depth_sgview), the only differentiable
    operand; ``gt_tiles`` [T, Q] the tile-major ground-truth depth."""
    group, rank, n = axis_group(mesh, axis)
    band_rows = -(-tiles_y // n)
    t_local = band_rows * tiles_x
    tile0 = rank * t_local
    with torch.no_grad():
        binn = bin_gaussians_band(
            prep, tiles_x, rank * band_rows, band_rows, cap_per_shard,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h, alpha_min=cfg.alpha_min,
            margin_px=cfg.bin_margin_px)
        # overflow and the instance count come from every band's count,
        # the same on every rank
        counts = band_instance_counts(prep, n, band_rows)
    gt_local = local_tiles(gt_tiles, tile0, t_local)
    core_kw = dict(cfg=cfg, tiles_x=tiles_x, height=height, width=width)
    n_tiles = tiles_x * tiles_y

    def call(feat) -> ShardBinnedOut:
        out = CoreOutputs(*_ShardBinnedCore.apply(
            feat, binn.gauss_id, binn.tile_start, binn.tile_stop, binn.inv,
            binn.gauss_start, binn.gauss_stop, gt_local, group, n, tile0,
            n_tiles, core_kw))
        return ShardBinnedOut(core=out, num_rendered=counts.sum(),
                              overflow=(counts > cap_per_shard).any())

    return call


def default_cap_per_shard(max_instances: int, n: int,
                          skew: float = 2.0) -> int:
    """A shard's instance budget: ``max_instances / n`` with slack
    ``skew`` for bands that hold more than their share, at least
    ``INSTANCE_ALIGN``, rounded up to a multiple of 1024 (the JAX
    package's rule).  Size it from :func:`band_instance_counts` where the
    scene is known."""
    cap = max(int(max_instances * skew) // max(n, 1), INSTANCE_ALIGN)
    return -(-cap // 1024) * 1024
