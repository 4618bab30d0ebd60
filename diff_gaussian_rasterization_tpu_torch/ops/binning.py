"""Tile binning: instance expansion, depth sort, per-tile ranges.

PyTorch port of the JAX package's ``ops/binning.py`` in its unaligned form
(``align=1``): every live (Gaussian, tile) pair becomes one instance, the
instances are sorted by (tile, depth) with a stable sort, and each tile's
instances form one contiguous segment ``[tile_start, tile_stop)``.

Everything is static-shape: ``max_instances`` is the length of the instance
arrays whatever the scene, and the true count is reported next to an
``overflow`` flag.

For the backward, binning also returns the map from the pre-sort
(Gaussian-major) enumeration to sorted positions, ``inv``, and each
Gaussian's contiguous run ``[gauss_start, gauss_stop)`` in that
enumeration: the per-Gaussian gradient is the sum of the gradient rows at
``inv[j]`` over the run (``kernels/segment_sum.py``).  The JAX package's
128-aligned slots, which exist for the TPU's DMA blocks, are not ported:
gradient rows live at sorted positions.

**Overflow rule.**  Instances are enumerated Gaussian by Gaussian (in index
order) and, within one Gaussian, row-major over its tile rectangle.  When
the true count exceeds ``max_instances``, the instances past the budget *in
that enumeration order* are dropped: the tail of the highest-index
Gaussians, whatever their depth.  Nothing is dropped by depth.

``bin_gaussians_band`` bins only a band of tile rows, for sharded binning
(``parallel/shard_bin.py``): each rank of a tile-sharded render bins its
own band, with segments bit-identical to that band's slice of the
full-grid binning.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import Preprocessed


class Binned(NamedTuple):
    gauss_id: torch.Tensor    # (I,) int64 source Gaussian, sorted order
    tile_id: torch.Tensor     # (I,) int32 sorted; num_tiles if invalid
    valid: torch.Tensor       # (I,) bool
    tile_start: torch.Tensor  # (T,) int32 [start, stop) into the instances
    tile_stop: torch.Tensor   # (T,) int32
    num_rendered: torch.Tensor  # () int64: true (uncapped) instance count
    overflow: torch.Tensor    # () bool
    inv: torch.Tensor         # (I,) int32 pre-sort instance -> sorted position
    gauss_start: torch.Tensor  # (P,) int32 pre-sort run of each Gaussian,
    gauss_stop: torch.Tensor   # (P,) int32 clipped to the budget


# The JAX package aligns every tile's segment to its Pallas kernels' DMA
# block of 128 instances.  The port's segments are unaligned; the constant
# remains only so that ``parallel.shard_bin.default_cap_per_shard`` rounds
# per-shard budgets as the JAX package does, and its budgets and overflow
# flags match.
INSTANCE_ALIGN = 128


class Expanded(NamedTuple):
    """Binning's expansion: every instance slot of the budget, unsorted."""
    g: torch.Tensor       # (I,) int64 source Gaussian of each slot
    tile: torch.Tensor    # (I,) int64 tile id; num_tiles if not live
    depth: torch.Tensor   # (I,) the Gaussian's depth (detached)
    starts: torch.Tensor  # (P,) int64 exclusive prefix sum of tiles_touched
    ends: torch.Tensor    # (P,) int64 inclusive prefix sum
    total: torch.Tensor   # () int64 true instance count


def bin_gaussians(prep: Preprocessed, tiles_x: int, tiles_y: int,
                  max_instances: int, tile_w: int = 0, tile_h: int = 0,
                  alpha_min: float = 15.0 / 255.0,
                  margin_px: float = 0.0, row_offset: int = 0) -> Binned:
    """Bin splats into per-tile depth-sorted instance segments.

    ``tile_w``/``tile_h`` (pixels) enable the exact ellipse-tile overlap
    cull; 0 disables it (rectangle only).  ``alpha_min`` must match the
    blend's skip threshold for the cull to leave the image unchanged, and
    ``margin_px`` must match the margin that dilated the preprocess rects.
    ``row_offset`` (tile rows) places the grid's first row in the image,
    for a band whose rects were clipped and shifted to local rows
    (:func:`bin_gaussians_band`): the cull then evaluates the splat at its
    global pixel rows, adding the integer offset before the float
    conversion, so the test is the full grid's bit for bit.
    See the module docstring for what overflow drops.

    Its stages, which ``examples/prof_bin.py`` times one by one:
    :func:`expand`, :func:`sort_order`, :func:`tile_ranges` and
    :func:`inverse_permutation`.
    """
    num_tiles = tiles_x * tiles_y
    cap = max_instances
    ex = expand(prep, tiles_x, tiles_y, cap, tile_w=tile_w, tile_h=tile_h,
                alpha_min=alpha_min, margin_px=margin_px,
                row_offset=row_offset)
    order = sort_order(ex.tile, ex.depth)
    tile_s = ex.tile[order].to(torch.int32)
    tile_start, tile_stop = tile_ranges(tile_s, num_tiles)
    return Binned(
        gauss_id=ex.g[order],
        tile_id=tile_s,
        valid=tile_s < num_tiles,
        tile_start=tile_start,
        tile_stop=tile_stop,
        num_rendered=ex.total,
        overflow=ex.total > cap,
        inv=inverse_permutation(order),
        gauss_start=torch.clamp_max(ex.starts, cap).to(torch.int32),
        gauss_stop=torch.clamp_max(ex.ends, cap).to(torch.int32),
    )


def expand(prep: Preprocessed, tiles_x: int, tiles_y: int,
           max_instances: int, tile_w: int = 0, tile_h: int = 0,
           alpha_min: float = 15.0 / 255.0, margin_px: float = 0.0,
           row_offset: int = 0) -> Expanded:
    """Binning's expansion: the prefix sum of the tiles each Gaussian
    touches, each instance slot's Gaussian (``searchsorted``) and tile in
    its rect, and the exact ellipse-tile cull (arguments as
    :func:`bin_gaussians`'s)."""
    dev = prep.tiles_touched.device
    p = prep.tiles_touched.shape[0]
    num_tiles = tiles_x * tiles_y
    cap = max_instances
    tt = prep.tiles_touched.to(torch.int64)
    ends = torch.cumsum(tt, 0)                 # inclusive prefix sum
    starts = ends - tt                         # exclusive
    total = ends[-1]

    i = torch.arange(cap, dtype=torch.int64, device=dev)
    valid = i < torch.clamp_max(total, cap)

    # Instance i belongs to the Gaussian whose [start, end) covers it:
    # the number of ends <= i.  Past the true total every instance maps to
    # the last Gaussian, as the JAX expansion does.
    g = torch.clamp_max(torch.searchsorted(ends, i, right=True), p - 1)
    local = i - starts[g]
    rect_min = prep.rect_min[g].to(torch.int64)
    rw = torch.clamp_min(prep.rect_max[g, 0].to(torch.int64) - rect_min[:, 0],
                         1)
    dy = torch.div(local, rw, rounding_mode="floor")
    dx = local - dy * rw
    tx = rect_min[:, 0] + dx
    ty = rect_min[:, 1] + dy
    depth = prep.depth.detach()[g]

    # Exact ellipse-tile overlap: a tile is live iff the maximum of the
    # concave quadratic ``power`` over the tile's pixel-center box reaches
    # the alpha_min level -L, L = ln(opac / alpha_min): 0 when the center
    # lies inside the box, else the best of the four box edges, where the
    # 1-D maximizer along an edge is the clamped critical point.
    if tile_w > 0 and tile_h > 0:
        conic = prep.conic.detach()[g]
        xy = prep.xy.detach()[g]
        op = prep.opacity.detach().reshape(-1)
        lvl = torch.log(torch.clamp_min(op, 1e-12) / alpha_min)[g]
        ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
        f32 = torch.float32
        dx0 = tx.to(f32) * tile_w - xy[:, 0] - margin_px
        dx1 = dx0 + (tile_w - 1) + 2.0 * margin_px
        dy0 = (ty + row_offset).to(f32) * tile_h - xy[:, 1] - margin_px
        dy1 = dy0 + (tile_h - 1) + 2.0 * margin_px
        inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
        safe_a = torch.clamp_min(ca, 1e-12)
        safe_c = torch.clamp_min(cc, 1e-12)

        def edge_pow_x(a):  # max over dy in [dy0, dy1] at fixed dx = a
            yy = torch.minimum(torch.maximum(-cb * a / safe_c, dy0), dy1)
            return -0.5 * (ca * a * a + cc * yy * yy) - cb * a * yy

        def edge_pow_y(b):  # max over dx in [dx0, dx1] at fixed dy = b
            xx = torch.minimum(torch.maximum(-cb * b / safe_a, dx0), dx1)
            return -0.5 * (ca * xx * xx + cc * b * b) - cb * xx * b

        maxpow = torch.maximum(
            torch.maximum(edge_pow_x(dx0), edge_pow_x(dx1)),
            torch.maximum(edge_pow_y(dy0), edge_pow_y(dy1)))
        live = valid & (inside | (maxpow >= -lvl - 1e-4))
    else:
        live = valid
    tile = torch.where(live, ty * tiles_x + tx,
                       torch.full_like(tx, num_tiles))
    return Expanded(g, tile, depth, starts, ends, total)


def sort_order(tile, depth):
    """The permutation that sorts the instances by (tile, depth), stable:
    by the minor key first, then stably by the major key, so ties keep
    instance order.  Invalid instances carry the tile sentinel and sort
    last."""
    o1 = torch.sort(depth, stable=True).indices
    o2 = torch.sort(tile[o1], stable=True).indices
    return o1[o2]


def tile_ranges(tile_s, num_tiles: int):
    """Each tile's segment ``[tile_start, tile_stop)`` (int32) in the sorted
    tile ids."""
    t = torch.arange(num_tiles, dtype=torch.int32, device=tile_s.device)
    return (torch.searchsorted(tile_s, t, out_int32=True),
            torch.searchsorted(tile_s, t, right=True, out_int32=True))


def inverse_permutation(order):
    """``inv[order[k]] = k`` (int32): pre-sort instance -> sorted position
    (unique indices: a deterministic scatter)."""
    inv = torch.empty(order.shape[0], dtype=torch.int32, device=order.device)
    inv[order] = torch.arange(order.shape[0], dtype=torch.int32,
                              device=order.device)
    return inv


def bin_gaussians_band(prep: Preprocessed, tiles_x: int, band_y0: int,
                       band_rows: int, max_instances: int, *,
                       tile_w: int = 0, tile_h: int = 0,
                       alpha_min: float = 15.0 / 255.0,
                       margin_px: float = 0.0) -> Binned:
    """Bin only the tiles in rows ``[band_y0, band_y0 + band_rows)``; local
    tile ids span ``[0, band_rows * tiles_x)``.

    Each tile's segment is bit-identical to its slice of the full-grid
    :func:`bin_gaussians`: both enumerate instances Gaussian by Gaussian
    and row-major within a splat's rect, so clipping the rect's rows to the
    band keeps the relative order of every surviving instance, the stable
    (tile, depth) sort sees the same keys, and the ellipse cull evaluates
    at global pixel rows (``row_offset``).  The budget and the overflow
    rule are the band's own.
    """
    rmin, rmax = prep.rect_min, prep.rect_max
    y0 = torch.clamp(rmin[:, 1], band_y0, band_y0 + band_rows)
    y1 = torch.clamp(rmax[:, 1], band_y0, band_y0 + band_rows)
    rows = torch.clamp_min(y1 - y0, 0)
    width = rmax[:, 0] - rmin[:, 0]
    tt = torch.where(prep.tiles_touched > 0, rows * width,
                     torch.zeros_like(rows)).to(prep.tiles_touched.dtype)
    band = prep._replace(
        tiles_touched=tt,
        rect_min=torch.stack([rmin[:, 0], y0 - band_y0], -1).to(
            rmin.dtype))
    return bin_gaussians(band, tiles_x, band_rows, max_instances,
                         tile_w=tile_w, tile_h=tile_h, alpha_min=alpha_min,
                         margin_px=margin_px, row_offset=band_y0)


def default_max_instances(p: int, multiplier: int) -> int:
    """The default instance budget: ``p * multiplier`` rounded up to a
    multiple of 1024 (at least 1024)."""
    n = max(p * multiplier, 1024)
    return -(-n // 1024) * 1024
