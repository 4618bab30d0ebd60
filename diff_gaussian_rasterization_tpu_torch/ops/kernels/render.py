"""The render core, forward and backward: the CUDA kernels and their plain
PyTorch versions.

``core_fwd`` blends every tile's depth-sorted instance segment front to back
and returns the per-pixel outputs (:class:`CoreOutputs`).  It is the port of
the TPU kernel ``render_pallas._fwd_kernel`` (called from ``core_fwd``) of the
JAX package.  On a CUDA tensor it launches the hand-written kernel
``csrc/render_fwd.cu``; on a CPU tensor it runs ``core_fwd_reference``, the
plain version (a chunked prefix-product blend over padded tile segments,
the counterpart of the JAX package's ``tile_xla.core_fwd_xla``).

``core_bwd`` is the blend's VJP: from the forward totals and the per-pixel
cotangents it returns one gradient row per instance, ``[I, 12]`` at sorted
positions with the columns of ``ROW_COLUMNS``; rows of instances no pixel
walked are zeros.  It is the port of ``render_pallas._bwd_kernel``: the
kernel ``csrc/render_bwd.cu`` on CUDA tensors, ``core_bwd_reference`` (the
counterpart of ``tile_xla.core_bwd_xla``) on CPU tensors.  Each instance
belongs to one tile, so every row has one writer and no atomics are needed.

With ``cfg.splat_basis_power`` the splat exponent takes the JAX package's
basis form (``blend.splat_power`` with a pixel basis about each tile's
corner), in the plain versions and in the kernels' basis instantiations
alike, bit for bit; the culling boxes widen for its rounding
(:func:`cull_extent`).  The dual forward refuses it, as the JAX package's
does.

``core_fwd_jvp`` is the dual forward: the forward's outputs plus K pose
tangents per pixel (:class:`PoseTangents`), from a sorted tangent table
``[I, per_k * K]`` gathered by the same rows as the features
(:func:`tangent_columns`: 3, 6 or 9 columns a tangent).  It is the
port of ``render_pallas._jvp_kernel``: the kernel ``csrc/render_jvp.cu`` on
CUDA tensors (its primal outputs bit-equal to ``render_fwd``'s), and
``core_fwd_jvp_reference`` (the counterpart of
``tile_xla.core_fwd_jvp_xla``) on CPU tensors.  It takes any number K of
tangents: the kernel carries at most ``JVP_GROUP`` a launch, so a larger
table is rendered in groups of columns, one launch each, the primal
written by the first.

The per-instance median-crossing statistics ``u_inst``/``npix_inst`` are a
scatter of per-pixel ``(midx, ucross)``.  A pixel's ``midx`` lies in its
own tile's segment, so each tile reduces on its own: on the card the
``tile_scatter_sum`` kernel (``csrc/render_fwd.cu``: per tile, counting
sorts in shared memory over passes of up to 32 instances, each instance
summed in pixel order), bit-equal to ``index_add_`` on the CPU and
bit-reproducible from run to run (a float scatter with atomics is not).  ``scatter_sum`` (a stable
sort by key and the ``segment_sum`` kernel) is left for keys that are not
tile-local, the dense oracle's.

Input layout: ``table`` is the sorted feature table ``[I, 11]`` with
columns x, y, A, B, C, opacity, r, g, b, depth, depth_sgview; ``tile_start``
and ``tile_stop`` ``[T]`` int32 bound each tile's segment; ``gt_tiles`` is
the ground-truth depth in tile-major layout ``[T, Q]``.

``launches`` counts the launches of each kernel; only the wrappers here
add to it, and only where they launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import RasterConfig
from .. import blend

FEAT = 11  # columns of the sorted feature table
MAX_TILE_PX = 1024  # 4 pixels per thread (fwd, bwd), 4 blocks a tile (dual)
# columns of the backward's gradient rows
ROW_COLUMNS = ("x", "y", "A", "B", "C", "opacity", "r", "g", "b", "depth",
               "depth_var", "depth_med")
ROW = len(ROW_COLUMNS)
TILE_BATCH = 64  # tiles the plain versions blend at once

JVP_GROUP = 6  # tangents one render_jvp launch carries (the twist basis)
BWD_THREADS = 256  # threads of a render_fwd or render_bwd block
# blend_common.cuh's cull_box: relative slack against float32 rounding, and
# the absolute widening in pixels
CULL_REL = 2e-5
CULL_ABS = 1e-2
# its widening of tau for the exponent's basis form, relative to the sum of
# the magnitudes of the expansion's terms (kBasisRel)
BASIS_REL = 1e-6

launches = {"render_fwd": 0, "tile_scatter_sum": 0, "segment_sum": 0,
            "render_bwd": 0, "segment_sum_rows": 0, "render_jvp": 0}
# segment_sum_rows launches by row width F (2: the uncertainty sums, 12:
# the gradient rows), counted beside launches["segment_sum_rows"]
row_launches: dict = {}


def reset_launches():
    for k in launches:
        launches[k] = 0
    row_launches.clear()


class CoreOutputs(NamedTuple):
    """Tile-major render-core outputs.

    ``color`` excludes the background composite (the caller adds
    ``t_final * bg``); ``var`` is the true sum w*(d-gt)^2, which the caller
    zeroes when ``cfg.ref_depth_var``.
    """

    color: torch.Tensor      # [T, C, Q]
    depth: torch.Tensor      # [T, Q]
    weight: torch.Tensor     # [T, Q]  (silhouette / opacity map)
    median: torch.Tensor     # [T, Q]
    var: torch.Tensor        # [T, Q]
    t_final: torch.Tensor    # [T, Q]
    n_contrib: torch.Tensor  # [T, Q] int32, segment-local, 1-based
    n_valid: torch.Tensor    # [T, Q] int32
    midx: torch.Tensor       # [T, Q] int32: global index of median crossing
    u_inst: torch.Tensor     # [I]
    npix_inst: torch.Tensor  # [I] int32


class PoseTangents(NamedTuple):
    """K pose-tangent streams of the render core, tile-major like
    :class:`CoreOutputs`, the tangents stacked on axis 1.  ``median`` is
    zeros: the median reads the pose-detached depth copy."""

    color: torch.Tensor    # [T, K, C, Q]
    depth: torch.Tensor    # [T, K, Q]
    weight: torch.Tensor   # [T, K, Q]
    median: torch.Tensor   # [T, K, Q]
    t_final: torch.Tensor  # [T, K, Q]


def splat_basis(cfg: RasterConfig, px, py):
    """The keyword arguments of the blend's exponent for tiles of pixel
    coordinates ``px, py`` [T, Q] (from :func:`pixel_coords`): none for the
    direct form; with ``cfg.splat_basis_power``, the basis form about each
    tile's corner, the origin of its first pixel, so that a tile renders
    the same numbers at any ``tile0``."""
    if not cfg.splat_basis_power:
        return {}
    origin = (px[:, 0], py[:, 0])
    return dict(basis=blend.moment_basis(px, py, origin), origin=origin)


def pixel_coords(n_tiles: int, tiles_x: int, th: int, tw: int, height: int,
                 width: int, device, tile0: int = 0):
    """px, py [T, Q] float32 pixel coordinates and the in-image mask of the
    image's tiles ``tile0 .. tile0 + n_tiles - 1``."""
    t = tile0 + torch.arange(n_tiles, device=device)[:, None]
    q = torch.arange(th * tw, device=device)[None, :]
    pxi = (t % tiles_x) * tw + q % tw
    pyi = (t // tiles_x) * th + q // tw
    mask = (pxi < width) & (pyi < height)
    return pxi.to(torch.float32), pyi.to(torch.float32), mask


# --------------------------------------------------------------------------
# deterministic per-key sums
# --------------------------------------------------------------------------


def segment_sum_reference(vals, ivals, bounds):
    """Plain version of the ``segment_sum`` kernel: per segment
    ``[bounds[p], bounds[p+1])`` the sums of ``vals`` and ``ivals``."""
    n = bounds.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(n, device=vals.device),
        (bounds[1:] - bounds[:-1]).to(torch.int64))
    m = seg.shape[0]
    lo = int(bounds[0])
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    out_i = torch.zeros(n, dtype=torch.int32, device=vals.device)
    out.index_add_(0, seg, vals[lo:lo + m])
    out_i.index_add_(0, seg, ivals[lo:lo + m])
    return out, out_i


def segment_sum(vals, ivals, bounds):
    """Per-segment sums of ``vals`` (float32) and ``ivals`` (int32), each
    segment summed in order: the ``segment_sum`` kernel on a CUDA tensor,
    :func:`segment_sum_reference` on a CPU tensor."""
    if vals.device.type == "cpu":
        return segment_sum_reference(vals, ivals, bounds)
    _check_cuda(vals, torch.float32, "vals")
    _check_cuda(ivals, torch.int32, "ivals")
    _check_cuda(bounds, torch.int32, "bounds")
    if ivals.shape != vals.shape or vals.dim() != 1 or bounds.dim() != 1:
        raise ValueError("segment_sum takes 1-D vals/ivals of one length "
                         "and 1-D bounds")
    from ._build import load
    n = bounds.shape[0] - 1
    out = torch.empty(n, dtype=torch.float32, device=vals.device)
    out_i = torch.empty(n, dtype=torch.int32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_fwd").segment_sum(
            vals.data_ptr(), ivals.data_ptr(), bounds.data_ptr(),
            out.data_ptr(), out_i.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    launches["segment_sum"] += 1
    return out, out_i


def scatter_sum_reference(keys, vals, ivals, n: int):
    """``out[k] = sum of vals[keys == k]`` (and of ``ivals``); keys outside
    ``[0, n)`` are dropped.  ``index_add_``: in order on the CPU, with
    atomics (order not fixed) on the card."""
    keys = torch.where((keys >= 0) & (keys < n), keys,
                       torch.full_like(keys, n)).to(torch.int64)
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out_i = torch.zeros(n + 1, dtype=torch.int32, device=vals.device)
    out.index_add_(0, keys, vals)
    out_i.index_add_(0, keys, ivals)
    return out[:n], out_i[:n]


def scatter_sum(keys, vals, ivals, n: int):
    """:func:`scatter_sum_reference` made bit-reproducible on the card: a
    stable sort by key, then :func:`segment_sum` over each key's run, so
    every key sums its values in input order (the CPU's order too)."""
    keys = torch.where((keys >= 0) & (keys < n), keys,
                       torch.full_like(keys, n)).to(torch.int64)
    key_s, order = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(
        key_s, torch.arange(n + 1, device=keys.device), out_int32=True)
    return segment_sum(vals[order].contiguous(), ivals[order].contiguous(),
                       bounds)


def tile_scatter_sum_reference(midx, ucross, tile_start, tile_stop,
                               n_inst: int):
    """Plain version of the ``tile_scatter_sum`` kernel: from per-pixel
    ``midx`` (int32) and ``ucross`` [T, Q] of the render core,
    ``u_inst[i]`` = the sum of ``ucross`` over the pixels whose ``midx`` is
    ``i`` and ``npix_inst[i]`` their count, [n_inst] each.  A ``midx``
    outside its pixel's tile segment ``[tile_start[t], tile_stop[t])``
    (-1: no median crossing) names no instance.  ``index_add_`` in pixel
    order: on the CPU the kernel's order too."""
    start = tile_start.to(torch.int64)[:, None]
    stop = tile_stop.to(torch.int64)[:, None]
    m = midx.to(torch.int64)
    keys = torch.where((m >= start) & (m < stop), m, torch.full_like(m, -1))
    return scatter_sum_reference(keys.reshape(-1), ucross.reshape(-1),
                                 torch.ones_like(midx).reshape(-1), n_inst)


def tile_scatter_sum(midx, ucross, tile_start, tile_stop, n_inst: int):
    """:func:`tile_scatter_sum_reference` as the ``tile_scatter_sum``
    kernel on CUDA tensors (one block per tile; ``midx`` and ``ucross`` may
    be strided views [T, Q] with unit pixel stride, such as the forward's
    ``out_i[:, 2]`` and ``out_f[:, 8]``, and are read in place); the plain
    version on CPU tensors."""
    if midx.device.type == "cpu":
        return tile_scatter_sum_reference(midx, ucross, tile_start,
                                          tile_stop, n_inst)
    _check_cuda(tile_start, torch.int32, "tile_start")
    _check_cuda(tile_stop, torch.int32, "tile_stop")
    n_tiles = tile_start.shape[0]
    for x, dtype, name in ((midx, torch.int32, "midx"),
                           (ucross, torch.float32, "ucross")):
        if x.device != tile_start.device or x.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor on "
                             f"{tile_start.device}")
        if x.dim() != 2 or x.shape[0] != n_tiles or x.stride(1) != 1:
            raise ValueError(f"{name} must be [T, Q] with unit pixel stride")
    q = midx.shape[1]
    if ucross.shape != midx.shape or tile_stop.shape != (n_tiles,):
        raise ValueError("midx and ucross must be [T, Q] and tile_stop [T]")
    if q > MAX_TILE_PX:
        raise ValueError(f"the CUDA kernel takes tiles of at most "
                         f"{MAX_TILE_PX} pixels, got {q}")
    from ._build import load
    u_inst = torch.zeros(n_inst, dtype=torch.float32, device=midx.device)
    npix_inst = torch.zeros(n_inst, dtype=torch.int32, device=midx.device)
    with torch.cuda.device(midx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_fwd").tile_scatter_sum(
            midx.data_ptr(), midx.stride(0), ucross.data_ptr(),
            ucross.stride(0), tile_start.data_ptr(), tile_stop.data_ptr(),
            n_tiles, q, u_inst.data_ptr(), npix_inst.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tile_scatter_sum launch failed: CUDA error {rc}")
    launches["tile_scatter_sum"] += 1
    return u_inst, npix_inst


# --------------------------------------------------------------------------
# the render core
# --------------------------------------------------------------------------


def core_fwd_pixels_reference(table, tile_start, tile_stop, gt_tiles, *,
                              cfg: RasterConfig, tiles_x: int, height: int,
                              width: int, tile0: int = 0):
    """The per-pixel half of :func:`core_fwd_reference`: its first nine
    outputs (color through midx) and the per-pixel ``ucross`` [T, Q], the
    median crossing's depth moment that ``u_inst`` sums.  Tiles in batches
    of ``TILE_BATCH``, each batch's segments padded and blended
    ``cfg.chunk`` instances at a time with :func:`blend.blend_chunk_fwd`; a
    batch stops once every in-image pixel has terminated.  ``tile0`` is the
    image index of the first tile of the arrays (see :func:`core_fwd`)."""
    dev = table.device
    n_inst = table.shape[0]
    t_all = tile_start.shape[0]
    g = max(1, min(cfg.chunk, n_inst))
    px_all, py_all, mask_all = pixel_coords(t_all, tiles_x, cfg.tile_h,
                                            cfg.tile_w, height, width, dev,
                                            tile0)
    ar = torch.arange(g, device=dev)
    outs = []
    for b0 in range(0, t_all, TILE_BATCH):
        sl = slice(b0, min(b0 + TILE_BATCH, t_all))
        start = tile_start[sl].to(torch.int64)
        stop = tile_stop[sl].to(torch.int64)
        px, py, pixmask = px_all[sl], py_all[sl], mask_all[sl]
        splat = splat_basis(cfg, px, py)
        carry = blend.init_carry(px.shape, 3, table.dtype, dev)
        maxcnt = int((stop - start).max()) if start.numel() else 0
        for k0 in range(0, maxcnt, g):
            if not bool(((carry.prod >= cfg.t_terminate) & pixmask).any()):
                break
            idx = start[:, None] + k0 + ar[None, :]              # [B, G]
            v = (idx < stop[:, None])[:, :, None] & pixmask[:, None, :]
            rows = table[idx.clamp(0, max(n_inst - 1, 0))]      # [B, G, 11]
            carry = blend.blend_chunk_fwd(
                carry, rows[..., 0:2], rows[..., 2:5], rows[..., 5],
                rows[..., 6:9], rows[..., 9], rows[..., 10], v, px, py,
                k0, cfg, global_base=(start + k0).to(torch.int32), **splat)
        gt = gt_tiles[sl]
        outs.append((carry.color, carry.depth, carry.weight, carry.median,
                     blend.finish_var(carry, gt), carry.t_final,
                     carry.n_contrib, carry.n_valid, carry.midx,
                     blend.finish_ucross(carry, gt)))
    cat = [torch.cat(x, 0) for x in zip(*outs)]
    return tuple(cat[:9]), cat[9]


def core_fwd_reference(table, tile_start, tile_stop, gt_tiles, *,
                       cfg: RasterConfig, tiles_x: int, height: int,
                       width: int, tile0: int = 0) -> CoreOutputs:
    """Plain PyTorch render core: :func:`core_fwd_pixels_reference`, then
    :func:`tile_scatter_sum_reference` of its ``(midx, ucross)``."""
    pixels, ucross = core_fwd_pixels_reference(
        table, tile_start, tile_stop, gt_tiles, cfg=cfg, tiles_x=tiles_x,
        height=height, width=width, tile0=tile0)
    u_inst, npix_inst = tile_scatter_sum_reference(
        pixels[8], ucross, tile_start, tile_stop, table.shape[0])
    return CoreOutputs(*pixels, u_inst, npix_inst)


def core_bwd_reference(table, tile_start, tile_stop, pix, *,
                       cfg: RasterConfig, tiles_x: int, height: int,
                       width: int, want_med: bool = True,
                       want_var: bool = True, tile0: int = 0):
    """Plain PyTorch backward core: the forward's batching and chunking,
    each chunk through :func:`blend.blend_chunk_bwd`; returns the gradient
    rows [I, 12] (zeros where no pixel walked the instance).  ``pix`` is
    :func:`blend.bwd_pixel_inputs` in tile-major layout [T, 10, Q]."""
    dev = table.device
    n_inst = table.shape[0]
    t_all = tile_start.shape[0]
    g = max(1, min(cfg.chunk, n_inst))
    px_all, py_all, mask_all = pixel_coords(t_all, tiles_x, cfg.tile_h,
                                            cfg.tile_w, height, width, dev,
                                            tile0)
    ar = torch.arange(g, device=dev)
    rows = torch.zeros((n_inst, ROW), dtype=table.dtype, device=dev)
    for b0 in range(0, t_all, TILE_BATCH):
        sl = slice(b0, min(b0 + TILE_BATCH, t_all))
        start = tile_start[sl].to(torch.int64)
        stop = tile_stop[sl].to(torch.int64)
        px, py, pixmask = px_all[sl], py_all[sl], mask_all[sl]
        splat = splat_basis(cfg, px, py)
        carry = blend.init_bwd_carry(px.shape, table.dtype, dev)
        maxcnt = int((stop - start).max()) if start.numel() else 0
        for k0 in range(0, maxcnt, g):
            if not bool(((carry.prod >= cfg.t_terminate) & pixmask).any()):
                break
            idx = start[:, None] + k0 + ar[None, :]              # [B, G]
            inseg = idx < stop[:, None]
            v = inseg[:, :, None] & pixmask[:, None, :]
            f = table[idx.clamp(0, max(n_inst - 1, 0))]         # [B, G, 11]
            carry, r = blend.blend_chunk_bwd(
                carry, f[..., 0:2], f[..., 2:5], f[..., 5], f[..., 6:9],
                f[..., 9], v, px, py, pix[sl], cfg, want_med=want_med,
                want_var=want_var, **splat)
            rows[idx[inseg]] = r[inseg]
    return rows


def _check_cuda(x, dtype, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_core_inputs(table, tile_start, tile_stop, gt_tiles,
                       cfg: RasterConfig):
    """What the forward kernels take: CUDA tensors of the documented
    types and shapes, on one device, tiles of at most MAX_TILE_PX."""
    _check_cuda(table, torch.float32, "table")
    _check_cuda(tile_start, torch.int32, "tile_start")
    _check_cuda(tile_stop, torch.int32, "tile_stop")
    _check_cuda(gt_tiles, torch.float32, "gt_tiles")
    n_tiles, q = tile_start.shape[0], cfg.tile_px
    if table.dim() != 2 or table.shape[1] != FEAT:
        raise ValueError(f"table must be [I, {FEAT}], got {tuple(table.shape)}")
    if tile_stop.shape != (n_tiles,) or gt_tiles.shape != (n_tiles, q):
        raise ValueError("tile_start/tile_stop must be [T] and gt_tiles "
                         f"[T, {q}]")
    if q > MAX_TILE_PX:
        raise ValueError(f"the CUDA kernel takes tiles of at most "
                         f"{MAX_TILE_PX} pixels, got {q}")
    if not (table.device == tile_start.device == tile_stop.device
            == gt_tiles.device):
        raise ValueError("all inputs must be on one device")


def launch_render_fwd(table, tile_start, tile_stop, gt_tiles, out_f, out_i,
                      *, cfg: RasterConfig, tiles_x: int, height: int,
                      width: int, pairs=None, tile0: int = 0):
    """One launch of the ``render_fwd`` kernel into preallocated
    ``out_f`` [T, 9, Q] float32 and ``out_i`` [T, 3, Q] int32 (inputs
    checked by :func:`core_fwd`), its basis-form instantiation when
    ``cfg.splat_basis_power``.  ``pairs``, a CUDA int64 [1] tensor, if
    given, gets the (instance, pixel) pairs the kernel tested added to
    it."""
    from ._build import load
    pairs_ptr = None if pairs is None else pairs.data_ptr()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_fwd").render_fwd(
            table.data_ptr(), tile_start.data_ptr(), tile_stop.data_ptr(),
            gt_tiles.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            tile_start.shape[0], tiles_x, tile0, cfg.tile_w, cfg.tile_h,
            width, height, cfg.alpha_cap, cfg.alpha_min, cfg.t_terminate,
            int(cfg.splat_basis_power), pairs_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"render_fwd launch failed: CUDA error {rc}")
    launches["render_fwd"] += 1


def core_fwd(table, tile_start, tile_stop, gt_tiles, *, cfg: RasterConfig,
             tiles_x: int, height: int, width: int,
             tile0: int = 0) -> CoreOutputs:
    """The render core: the ``render_fwd`` kernel on CUDA tensors, the plain
    version on CPU tensors.  See the module docstring for the layout.

    The tile-major arrays may cover a contiguous run of the image's tiles,
    ``tile0 .. tile0 + T - 1`` (a rank's share of a tile-sharded render):
    ``tile0`` places their pixels in the image, and nothing else changes."""
    if table.device.type == "cpu":
        return core_fwd_reference(table, tile_start, tile_stop, gt_tiles,
                                  cfg=cfg, tiles_x=tiles_x, height=height,
                                  width=width, tile0=tile0)
    _check_core_inputs(table, tile_start, tile_stop, gt_tiles, cfg)
    n_tiles, q, dev = tile_start.shape[0], cfg.tile_px, table.device
    out_f = torch.empty((n_tiles, 9, q), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
    launch_render_fwd(table, tile_start, tile_stop, gt_tiles, out_f, out_i,
                      cfg=cfg, tiles_x=tiles_x, height=height, width=width,
                      tile0=tile0)
    midx = out_i[:, 2]
    u_inst, npix_inst = tile_scatter_sum(midx, out_f[:, 8], tile_start,
                                         tile_stop, table.shape[0])
    return CoreOutputs(out_f[:, 0:3], out_f[:, 3], out_f[:, 4], out_f[:, 5],
                       out_f[:, 6], out_f[:, 7], out_i[:, 0], out_i[:, 1],
                       midx, u_inst, npix_inst)


def bwd_pixel_map(tile_h: int, tile_w: int, device="cpu"):
    """The tile pixel of each thread of ``render_fwd`` and ``render_bwd``
    (one map, ``blend_common.cuh``'s ``patch_pixel``), [BWD_THREADS, PPT]
    int64 (``tile_h * tile_w`` where it has none): PPT = 1, 2 or 4 pixels a
    thread by the tile's size; lane l of warp w owns pixel (l % 8, l // 8)
    of each of its PPT 8x4 patches (a 2x2 block of patches with four pixels
    a thread and an even number of patches across and down, else the PPT
    consecutive patches w * PPT + k), or, where the tile does not divide
    into 8x4 patches, pixel ``thread + k * 256``.  On the CPU this mirror of
    ``patch_pixel``; on a CUDA device that function's own map (one launch
    of a ``render_bwd.cu`` kernel that runs only it).  The checks hold each
    pixel of the tile owned exactly once."""
    q = tile_h * tile_w
    if q > MAX_TILE_PX:
        raise ValueError(f"render_bwd takes tiles of at most {MAX_TILE_PX} "
                         f"pixels, got {q}")
    ppt = 1 if q <= BWD_THREADS else 2 if q <= 2 * BWD_THREADS else 4
    if torch.device(device).type == "cuda":
        from ._build import load
        out = torch.empty((BWD_THREADS, ppt), dtype=torch.int32,
                          device=device)
        with torch.cuda.device(out.device):
            rc = load("render_bwd").render_bwd_pixel_map(
                tile_w, tile_h, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"render_bwd_pixel_map launch failed: CUDA "
                               f"error {rc}")
        return out.to(torch.int64)
    thread = torch.arange(BWD_THREADS)[:, None]
    k = torch.arange(ppt)[None, :]
    if tile_w % 8 or tile_h % 4:
        qi = thread + k * BWD_THREADS
        return torch.where(qi < q, qi, torch.full_like(qi, q))
    warp, lane = thread // 32, thread % 32
    across, down = tile_w // 8, tile_h // 4
    if ppt == 4 and across % 2 == 0 and down % 2 == 0:
        half = across // 2
        pxp = 2 * (warp % half) + (k & 1)
        pyp = 2 * (warp // half) + (k >> 1)
    else:
        patch = warp * ppt + k
        pxp, pyp = patch % across, patch // across
    qi = (pyp * 4 + lane // 8) * tile_w + pxp * 8 + lane % 8
    return torch.where(pyp < down, qi, torch.full_like(qi, q))


def launch_render_bwd(table, tile_start, tile_stop, pix, rows, *,
                      cfg: RasterConfig, tiles_x: int, height: int,
                      width: int, want_med: bool = True,
                      want_var: bool = True, n_contrib, pairs=None,
                      tile0: int = 0):
    """One launch of the ``render_bwd`` kernel into ``rows`` [I, 12], which
    the caller zero-fills (inputs checked by :func:`core_bwd`), its
    basis-form instantiation when ``cfg.splat_basis_power``.
    ``n_contrib`` [T, Q] int32 (unit pixel stride; the forward's
    ``out_i[:, 0]`` is read in place) stops each pixel after its last
    contributor.  ``pairs``, a CUDA int64 [1] tensor, if given, gets the
    (instance, pixel) pairs the kernel tested added to it."""
    from ._build import load
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    pairs_ptr = None if pairs is None else pairs.data_ptr()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_bwd").render_bwd(
            table.data_ptr(), tile_start.data_ptr(), tile_stop.data_ptr(),
            pix.data_ptr(), n_contrib.data_ptr(), n_contrib.stride(0),
            rows.data_ptr(),
            tile_start.shape[0], tiles_x, tile0, cfg.tile_w, cfg.tile_h,
            width, height, cfg.alpha_cap, cfg.alpha_min, cfg.t_terminate,
            int(want_med), int(want_var), int(cfg.splat_basis_power),
            pairs_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"render_bwd launch failed: CUDA error {rc}")
    launches["render_bwd"] += 1


def core_bwd(table, tile_start, tile_stop, gt_tiles, totals, cots, *,
             cfg: RasterConfig, tiles_x: int, height: int, width: int,
             want_med: bool = True, want_var: bool = True, n_contrib,
             tile0: int = 0):
    """The backward core: gradient rows [I, 12] at sorted positions.

    ``totals`` are the forward's (color [T, 3, Q], depth, weight, var,
    t_final), ``cots`` the cotangents of (color, depth, weight, var,
    median, t_final), all tile-major; ``n_contrib``, the forward's [T, Q],
    lets the kernel stop each pixel after its last contributor, which
    changes no row.  The ``render_bwd`` kernel on CUDA tensors,
    :func:`core_bwd_reference` (which needs no ``n_contrib``) on CPU
    tensors.  ``tile0`` as in :func:`core_fwd`."""
    pix = blend.bwd_pixel_inputs(gt_tiles, *totals, *cots).contiguous()
    kw = dict(cfg=cfg, tiles_x=tiles_x, height=height, width=width,
              want_med=want_med, want_var=want_var, tile0=tile0)
    if table.device.type == "cpu":
        return core_bwd_reference(table, tile_start, tile_stop, pix, **kw)
    _check_cuda(table, torch.float32, "table")
    _check_cuda(tile_start, torch.int32, "tile_start")
    _check_cuda(tile_stop, torch.int32, "tile_stop")
    _check_cuda(pix, torch.float32, "pixel inputs")
    n_tiles, q = tile_start.shape[0], cfg.tile_px
    if table.dim() != 2 or table.shape[1] != FEAT:
        raise ValueError(f"table must be [I, {FEAT}], "
                         f"got {tuple(table.shape)}")
    if tile_stop.shape != (n_tiles,) or pix.shape != (n_tiles,
                                                      blend.PIX_ROWS, q):
        raise ValueError("tile_stop must be [T] and the totals and "
                         f"cotangents tile-major [T, (3,) {q}]")
    if q > MAX_TILE_PX:
        raise ValueError(f"the CUDA kernel takes tiles of at most "
                         f"{MAX_TILE_PX} pixels, got {q}")
    if not (table.device == tile_start.device == tile_stop.device
            == pix.device):
        raise ValueError("all inputs must be on one device")
    if (n_contrib.device != table.device or n_contrib.dtype != torch.int32
            or n_contrib.shape != (n_tiles, q) or n_contrib.stride(1) != 1):
        raise ValueError(f"n_contrib must be [T, {q}] int32 on "
                         f"{table.device} with unit pixel stride")
    rows = torch.zeros((table.shape[0], ROW), dtype=torch.float32,
                       device=table.device)
    launch_render_bwd(table, tile_start, tile_stop, pix, rows,
                      n_contrib=n_contrib, **kw)
    return rows


# --------------------------------------------------------------------------
# the dual forward: the render core plus K pose tangents
# --------------------------------------------------------------------------


def tangent_columns(full: bool, color: bool = False) -> int:
    """The columns of one tangent in the sorted tangent table: dx, dy,
    ddepth of the splat; dA, dB, dC of its conic when ``full`` (the 2D
    covariance branch); and dr, dg, db of its colour when ``color`` (the SH
    colour branch), after conic columns that are zeros without ``full``.
    So 3, 6 or 9."""
    return 9 if color else 6 if full else 3


def _tangent_count(tans, full: bool, color: bool = False) -> int:
    per_k = tangent_columns(full, color)
    if tans.dim() != 2 or tans.shape[1] % per_k or tans.shape[1] == 0:
        raise ValueError(f"tans must be [I, {per_k} * K], got "
                         f"{tuple(tans.shape)}")
    return tans.shape[1] // per_k


def core_fwd_jvp_reference(table, tans, tile_start, tile_stop, gt_tiles, *,
                           cfg: RasterConfig, tiles_x: int, height: int,
                           width: int, full: bool = False,
                           color: bool = False, tile0: int = 0):
    """Plain PyTorch dual render core: :func:`core_fwd_reference`'s tile
    batches, chunks and termination, each chunk through
    :func:`blend.blend_chunk_fwd_jvp`.  ``tans`` [I, per_k * K] holds per
    tangent k the columns of :func:`tangent_columns` (``full``,
    ``color``).  Returns (CoreOutputs, PoseTangents)."""
    dev = table.device
    n_inst = table.shape[0]
    t_all = tile_start.shape[0]
    k_t = _tangent_count(tans, full, color)
    per_k = tangent_columns(full, color)
    g = max(1, min(cfg.chunk, n_inst))
    px_all, py_all, mask_all = pixel_coords(t_all, tiles_x, cfg.tile_h,
                                            cfg.tile_w, height, width, dev,
                                            tile0)
    ar = torch.arange(g, device=dev)
    outs = []
    for b0 in range(0, t_all, TILE_BATCH):
        sl = slice(b0, min(b0 + TILE_BATCH, t_all))
        start = tile_start[sl].to(torch.int64)
        stop = tile_stop[sl].to(torch.int64)
        px, py, pixmask = px_all[sl], py_all[sl], mask_all[sl]
        carry = blend.init_jvp_carry(px.shape, k_t, 3, table.dtype, dev)
        maxcnt = int((stop - start).max()) if start.numel() else 0
        for k0 in range(0, maxcnt, g):
            if not bool(((carry.primal.prod >= cfg.t_terminate)
                         & pixmask).any()):
                break
            idx = start[:, None] + k0 + ar[None, :]              # [B, G]
            v = (idx < stop[:, None])[:, :, None] & pixmask[:, None, :]
            idxc = idx.clamp(0, max(n_inst - 1, 0))
            rows = table[idxc]                                  # [B, G, 11]
            trows = tans[idxc].reshape(*idx.shape, k_t, per_k).movedim(
                -2, -3)                                         # [B, K, G, pk]
            carry = blend.blend_chunk_fwd_jvp(
                carry, rows[..., 0:2], rows[..., 2:5], rows[..., 5],
                rows[..., 6:9], rows[..., 9], rows[..., 10], trows[..., 0:2],
                trows[..., 2], v, px, py, k0, cfg,
                global_base=(start + k0).to(torch.int32),
                tan_conic=trows[..., 3:6] if per_k >= 6 else None,
                tan_color=trows[..., 6:9] if color else None)
        gt = gt_tiles[sl]
        pc = carry.primal
        outs.append((pc.color, pc.depth, pc.weight, pc.median,
                     blend.finish_var(pc, gt), pc.t_final, pc.n_contrib,
                     pc.n_valid, pc.midx, blend.finish_ucross(pc, gt),
                     carry.color, carry.depth, carry.weight, carry.median,
                     blend.finish_t_final_tangent(carry)))
    cat = [torch.cat(x, 0) for x in zip(*outs)]
    u_inst, npix_inst = tile_scatter_sum_reference(cat[8], cat[9],
                                                   tile_start, tile_stop,
                                                   n_inst)
    return (CoreOutputs(*cat[:9], u_inst, npix_inst),
            PoseTangents(*cat[10:]))


def cull_extent(conic, opacity, alpha_min: float, xy=None, origin=None,
                tile=None):
    """The half-extents (rx, ry) [N] of ``blend_common.cuh``'s
    ``cull_box``, in its float32 expressions: outside ``|dx| <= rx,
    |dy| <= ry`` a splat's alpha is below ``alpha_min`` at every pixel.
    ``-inf`` (an empty box) where the opacity is below ``alpha_min``,
    ``inf`` where the conic is not positive definite.  ``render_fwd``,
    ``render_bwd`` and ``render_jvp`` skip the pairs outside the box; the
    tests hold this mirror to the blend's own alpha.

    With ``origin`` (ox, oy [N], the corners of the tiles the splats at
    ``xy`` [N, 2] are tested in) and ``tile`` (tile_h, tile_w): the box of
    the exponent's basis form in that tile (``cull_box_of<true>``), tau
    grown by ``BASIS_REL`` times the sum of the magnitudes of the
    expansion's terms over the tile."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    one = f32(1.0)
    up, down, rel = one + f32(CULL_REL), one - f32(CULL_REL), f32(CULL_REL)
    a_min = f32(alpha_min)
    conic, op = conic.to(torch.float32), opacity.to(torch.float32)
    if origin is None:
        tau2 = 2.0 * torch.log(op / a_min) * up + rel
    else:
        big_x = (xy[:, 0] - origin[0]).abs() + f32(tile[1] - 1)
        big_y = (xy[:, 1] - origin[1]).abs() + f32(tile[0] - 1)
        s = (0.5 * conic[:, 0].abs() * big_x * big_x
             + 0.5 * conic[:, 2].abs() * big_y * big_y
             + conic[:, 1].abs() * big_x * big_y)
        tau2 = 2.0 * (torch.log(op / a_min) + f32(BASIS_REL) * s) * up + rel
    a, c = conic[:, 0] * down, conic[:, 2] * down
    b = conic[:, 1].abs() * up
    det = a * c - b * b
    rx = torch.sqrt(tau2 * c / det) * up + f32(CULL_ABS)
    ry = torch.sqrt(tau2 * a / det) * up + f32(CULL_ABS)
    inf = torch.full_like(rx, float("inf"))
    bounded = (a > 0) & (c > 0) & (det > 0)
    rx, ry = torch.where(bounded, rx, inf), torch.where(bounded, ry, inf)
    empty = op < a_min
    return torch.where(empty, -inf, rx), torch.where(empty, -inf, ry)


def cull_boxes(table, alpha_min: float):
    """The culling box (x0, x1, y0, y1) [I, 4] of each row of a feature
    table [I, 11]: on a CUDA tensor the kernels' own ``cull_box`` (one
    launch of a ``render_jvp.cu`` kernel that runs only that function), on
    a CPU tensor :func:`cull_extent` around the splat's center.  The checks
    hold the first to the second and to the blend's alpha."""
    if table.device.type == "cpu":
        rx, ry = cull_extent(table[:, 2:5], table[:, 5], alpha_min)
        x, y = table[:, 0], table[:, 1]
        return torch.stack([x - rx, x + rx, y - ry, y + ry], 1)
    _check_cuda(table, torch.float32, "table")
    if table.dim() != 2 or table.shape[1] != FEAT:
        raise ValueError(f"table must be [I, {FEAT}], got {tuple(table.shape)}")
    from ._build import load
    boxes = torch.empty((table.shape[0], 4), dtype=torch.float32,
                        device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_jvp").render_jvp_cull_boxes(
            table.data_ptr(), table.shape[0], alpha_min, boxes.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"render_jvp_cull_boxes launch failed: CUDA error "
                           f"{rc}")
    return boxes


def cull_misses(table, tile_start, tile_stop, *, cfg: RasterConfig,
                tiles_x: int, height: int, width: int, tile0: int = 0,
                chunk: int = 8192) -> int:
    """The (instance, in-image pixel) pairs of the binning that the
    kernels' culling box skips although the blend would not: the pixel lies
    outside :func:`cull_extent`'s box of the instance (the basis form's box
    in the instance's tile when ``cfg.splat_basis_power``), yet the
    exponent, in the form ``cfg`` selects, gives ``power <= 0`` and
    ``alpha >= alpha_min``.  0 is what the culling promises.  Plain
    PyTorch on the table's device, ``chunk`` instances at a time."""
    dev = table.device
    th, tw = cfg.tile_h, cfg.tile_w
    seg = (tile_stop - tile_start).to(torch.int64)
    tiles = torch.repeat_interleave(
        torch.arange(tile_start.shape[0], device=dev), seg)
    first = torch.cumsum(seg, 0) - seg
    inst = (tile_start.to(torch.int64)[tiles] - first[tiles]
            + torch.arange(tiles.shape[0], device=dev))
    q = torch.arange(th * tw, device=dev)
    qx, qy = (q % tw).to(torch.float32), (q // tw).to(torch.float32)
    misses = 0
    for c0 in range(0, inst.shape[0], chunk):
        rows = table[inst[c0:c0 + chunk]]
        t = tiles[c0:c0 + chunk] + tile0
        ox = ((t % tiles_x) * tw).to(torch.float32)
        oy = ((t // tiles_x) * th).to(torch.float32)
        px, py = ox[:, None] + qx, oy[:, None] + qy            # [N, Q]
        xy, conic, op = rows[:, 0:2], rows[:, 2:5], rows[:, 5]
        if cfg.splat_basis_power:
            rx, ry = cull_extent(conic, op, cfg.alpha_min, xy, (ox, oy),
                                 (th, tw))
            power = blend.splat_power(
                xy[:, None], conic[:, None], px, py,
                blend.moment_basis(qx, qy, (0.0, 0.0))[None],
                (ox, oy))[:, 0]
        else:
            rx, ry = cull_extent(conic, op, cfg.alpha_min)
            power = blend.splat_power(xy[:, None], conic[:, None], px,
                                      py)[:, 0]
        alpha = torch.clamp_max(op[:, None] * torch.exp(power),
                                cfg.alpha_cap)
        x, y = xy[:, 0:1], xy[:, 1:2]
        rx, ry = rx[:, None], ry[:, None]
        outside = ((x - rx > px) | (x + rx < px) | (y - ry > py)
                   | (y + ry < py))
        live = (power <= 0.0) & (alpha >= cfg.alpha_min) & (px < width) \
            & (py < height)
        misses += int((outside & live).sum())
    return misses


def launch_render_jvp(table, tans, tile_start, tile_stop, gt_tiles, out_f,
                      out_i, out_t, *, cfg: RasterConfig, tiles_x: int,
                      height: int, width: int, full: bool = False,
                      color: bool = False, pairs=None, tile0: int = 0):
    """The ``render_jvp`` kernel into preallocated ``out_f`` [T, 9, Q],
    ``out_i`` [T, 3, Q] (both as ``render_fwd`` writes them) and ``out_t``
    [T, K, 6, Q] (inputs checked by :func:`core_fwd_jvp`): one launch per
    group of at most ``JVP_GROUP`` tangent columns, the first writing the
    primal.  ``pairs``, a CUDA int64 [1] tensor, if given, gets the
    (instance, pixel) pairs the kernel tested added to it."""
    from ._build import load
    per_k = tangent_columns(full, color)
    k_total = tans.shape[1] // per_k
    pairs_ptr = None if pairs is None else pairs.data_ptr()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        for k0 in range(0, k_total, JVP_GROUP):
            rc = load("render_jvp").render_jvp(
                table.data_ptr(), tans.data_ptr(), tile_start.data_ptr(),
                tile_stop.data_ptr(), gt_tiles.data_ptr(), out_f.data_ptr(),
                out_i.data_ptr(), out_t.data_ptr(), tile_start.shape[0],
                tiles_x, tile0, cfg.tile_w, cfg.tile_h, width, height,
                cfg.alpha_cap, cfg.alpha_min, cfg.t_terminate,
                min(JVP_GROUP, k_total - k0), per_k, k0, k_total,
                int(k0 == 0), pairs_ptr, stream)
            if rc != 0:
                raise RuntimeError(
                    f"render_jvp launch failed: CUDA error {rc}")
            launches["render_jvp"] += 1


def core_fwd_jvp(table, tans, tile_start, tile_stop, gt_tiles, *,
                 cfg: RasterConfig, tiles_x: int, height: int, width: int,
                 full: bool = False, color: bool = False, tile0: int = 0):
    """The dual render core, (CoreOutputs, PoseTangents): the ``render_jvp``
    kernel on CUDA tensors, :func:`core_fwd_jvp_reference` on CPU tensors.
    ``tans`` is the sorted tangent table [I, per_k * K] (per_k of
    :func:`tangent_columns`: 3, 6 when ``full``, 9 with ``color``),
    gathered by the same rows as ``table``; ``tile0`` as in
    :func:`core_fwd`."""
    blend.check_direct_for_jvp(cfg)
    kw = dict(cfg=cfg, tiles_x=tiles_x, height=height, width=width,
              full=full, color=color, tile0=tile0)
    if table.device.type == "cpu":
        return core_fwd_jvp_reference(table, tans, tile_start, tile_stop,
                                      gt_tiles, **kw)
    _check_core_inputs(table, tile_start, tile_stop, gt_tiles, cfg)
    _check_cuda(tans, torch.float32, "tans")
    k_t = _tangent_count(tans, full, color)
    if tans.shape[0] != table.shape[0] or tans.device != table.device:
        raise ValueError("tans must have one row per row of table, on its "
                         "device")
    n_tiles, q, dev = tile_start.shape[0], cfg.tile_px, table.device
    out_f = torch.empty((n_tiles, 9, q), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
    out_t = torch.empty((n_tiles, k_t, 6, q), dtype=torch.float32,
                        device=dev)
    launch_render_jvp(table, tans, tile_start, tile_stop, gt_tiles, out_f,
                      out_i, out_t, **kw)
    midx = out_i[:, 2]
    u_inst, npix_inst = tile_scatter_sum(midx, out_f[:, 8], tile_start,
                                         tile_stop, table.shape[0])
    primal = CoreOutputs(out_f[:, 0:3], out_f[:, 3], out_f[:, 4],
                         out_f[:, 5], out_f[:, 6], out_f[:, 7], out_i[:, 0],
                         out_i[:, 1], midx, u_inst, npix_inst)
    depth = out_t[:, :, 3]
    return primal, PoseTangents(out_t[:, :, 0:3], depth, out_t[:, :, 4],
                                torch.zeros_like(depth), out_t[:, :, 5])
