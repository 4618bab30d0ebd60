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

The per-instance median-crossing statistics ``u_inst``/``npix_inst`` are a
scatter of per-pixel ``(midx, ucross)``.  On the card that reduction is a
stable sort by key followed by the ``segment_sum`` kernel, so it is
bit-reproducible from run to run (a float scatter with atomics is not).

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
MAX_TILE_PX = 1024  # the kernels own at most 4 pixels in each of 256 threads
# columns of the backward's gradient rows
ROW_COLUMNS = ("x", "y", "A", "B", "C", "opacity", "r", "g", "b", "depth",
               "depth_var", "depth_med")
ROW = len(ROW_COLUMNS)
TILE_BATCH = 64  # tiles the plain versions blend at once

launches = {"render_fwd": 0, "segment_sum": 0, "render_bwd": 0,
            "segment_sum_rows": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


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


def pixel_coords(n_tiles: int, tiles_x: int, th: int, tw: int, height: int,
                 width: int, device):
    """px, py [T, Q] float32 pixel coordinates and the in-image mask."""
    t = torch.arange(n_tiles, device=device)[:, None]
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


# --------------------------------------------------------------------------
# the render core
# --------------------------------------------------------------------------


def core_fwd_reference(table, tile_start, tile_stop, gt_tiles, *,
                       cfg: RasterConfig, tiles_x: int, height: int,
                       width: int) -> CoreOutputs:
    """Plain PyTorch render core: tiles in batches of ``TILE_BATCH``, each
    batch's segments padded and blended ``cfg.chunk`` instances at a time
    with :func:`blend.blend_chunk_fwd`; a batch stops once every in-image
    pixel has terminated."""
    dev = table.device
    n_inst = table.shape[0]
    t_all = tile_start.shape[0]
    g = max(1, min(cfg.chunk, n_inst))
    px_all, py_all, mask_all = pixel_coords(t_all, tiles_x, cfg.tile_h,
                                            cfg.tile_w, height, width, dev)
    ar = torch.arange(g, device=dev)
    outs = []
    for b0 in range(0, t_all, TILE_BATCH):
        sl = slice(b0, min(b0 + TILE_BATCH, t_all))
        start = tile_start[sl].to(torch.int64)
        stop = tile_stop[sl].to(torch.int64)
        px, py, pixmask = px_all[sl], py_all[sl], mask_all[sl]
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
                k0, cfg, global_base=(start + k0).to(torch.int32))
        gt = gt_tiles[sl]
        outs.append((carry.color, carry.depth, carry.weight, carry.median,
                     blend.finish_var(carry, gt), carry.t_final,
                     carry.n_contrib, carry.n_valid, carry.midx,
                     blend.finish_ucross(carry, gt)))
    cat = [torch.cat(x, 0) for x in zip(*outs)]
    midx, ucross = cat[8], cat[9]
    u_inst, npix_inst = scatter_sum_reference(
        midx.reshape(-1), ucross.reshape(-1),
        torch.ones_like(midx).reshape(-1), n_inst)
    return CoreOutputs(*cat[:9], u_inst, npix_inst)


def core_bwd_reference(table, tile_start, tile_stop, pix, *,
                       cfg: RasterConfig, tiles_x: int, height: int,
                       width: int, want_med: bool = True,
                       want_var: bool = True):
    """Plain PyTorch backward core: the forward's batching and chunking,
    each chunk through :func:`blend.blend_chunk_bwd`; returns the gradient
    rows [I, 12] (zeros where no pixel walked the instance).  ``pix`` is
    :func:`blend.bwd_pixel_inputs` in tile-major layout [T, 10, Q]."""
    dev = table.device
    n_inst = table.shape[0]
    t_all = tile_start.shape[0]
    g = max(1, min(cfg.chunk, n_inst))
    px_all, py_all, mask_all = pixel_coords(t_all, tiles_x, cfg.tile_h,
                                            cfg.tile_w, height, width, dev)
    ar = torch.arange(g, device=dev)
    rows = torch.zeros((n_inst, ROW), dtype=table.dtype, device=dev)
    for b0 in range(0, t_all, TILE_BATCH):
        sl = slice(b0, min(b0 + TILE_BATCH, t_all))
        start = tile_start[sl].to(torch.int64)
        stop = tile_stop[sl].to(torch.int64)
        px, py, pixmask = px_all[sl], py_all[sl], mask_all[sl]
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
                want_var=want_var)
            rows[idx[inseg]] = r[inseg]
    return rows


def _check_cuda(x, dtype, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_render_fwd(table, tile_start, tile_stop, gt_tiles, out_f, out_i,
                      *, cfg: RasterConfig, tiles_x: int, height: int,
                      width: int):
    """One launch of the ``render_fwd`` kernel into preallocated
    ``out_f`` [T, 9, Q] float32 and ``out_i`` [T, 3, Q] int32 (inputs
    checked by :func:`core_fwd`)."""
    from ._build import load
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_fwd").render_fwd(
            table.data_ptr(), tile_start.data_ptr(), tile_stop.data_ptr(),
            gt_tiles.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            tile_start.shape[0], tiles_x, cfg.tile_w, cfg.tile_h, width,
            height, cfg.alpha_cap, cfg.alpha_min, cfg.t_terminate, stream)
    if rc != 0:
        raise RuntimeError(f"render_fwd launch failed: CUDA error {rc}")
    launches["render_fwd"] += 1


def core_fwd(table, tile_start, tile_stop, gt_tiles, *, cfg: RasterConfig,
             tiles_x: int, height: int, width: int) -> CoreOutputs:
    """The render core: the ``render_fwd`` kernel on CUDA tensors, the plain
    version on CPU tensors.  See the module docstring for the layout."""
    if table.device.type == "cpu":
        return core_fwd_reference(table, tile_start, tile_stop, gt_tiles,
                                  cfg=cfg, tiles_x=tiles_x, height=height,
                                  width=width)
    _check_cuda(table, torch.float32, "table")
    _check_cuda(tile_start, torch.int32, "tile_start")
    _check_cuda(tile_stop, torch.int32, "tile_stop")
    _check_cuda(gt_tiles, torch.float32, "gt_tiles")
    n_tiles = tile_start.shape[0]
    q = cfg.tile_px
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
    dev = table.device
    out_f = torch.empty((n_tiles, 9, q), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
    launch_render_fwd(table, tile_start, tile_stop, gt_tiles, out_f, out_i,
                      cfg=cfg, tiles_x=tiles_x, height=height, width=width)
    midx = out_i[:, 2]
    u_inst, npix_inst = scatter_sum(
        midx.reshape(-1), out_f[:, 8].reshape(-1),
        torch.ones((n_tiles * q,), dtype=torch.int32, device=dev),
        table.shape[0])
    return CoreOutputs(out_f[:, 0:3], out_f[:, 3], out_f[:, 4], out_f[:, 5],
                       out_f[:, 6], out_f[:, 7], out_i[:, 0], out_i[:, 1],
                       midx, u_inst, npix_inst)


def launch_render_bwd(table, tile_start, tile_stop, pix, rows, *,
                      cfg: RasterConfig, tiles_x: int, height: int,
                      width: int, want_med: bool = True,
                      want_var: bool = True):
    """One launch of the ``render_bwd`` kernel into ``rows`` [I, 12], which
    the caller zero-fills (inputs checked by :func:`core_bwd`)."""
    from ._build import load
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_bwd").render_bwd(
            table.data_ptr(), tile_start.data_ptr(), tile_stop.data_ptr(),
            pix.data_ptr(), rows.data_ptr(), tile_start.shape[0], tiles_x,
            cfg.tile_w, cfg.tile_h, width, height, cfg.alpha_cap,
            cfg.alpha_min, cfg.t_terminate, int(want_med), int(want_var),
            stream)
    if rc != 0:
        raise RuntimeError(f"render_bwd launch failed: CUDA error {rc}")
    launches["render_bwd"] += 1


def core_bwd(table, tile_start, tile_stop, gt_tiles, totals, cots, *,
             cfg: RasterConfig, tiles_x: int, height: int, width: int,
             want_med: bool = True, want_var: bool = True):
    """The backward core: gradient rows [I, 12] at sorted positions.

    ``totals`` are the forward's (color [T, 3, Q], depth, weight, var,
    t_final), ``cots`` the cotangents of (color, depth, weight, var,
    median, t_final), all tile-major.  The ``render_bwd`` kernel on CUDA
    tensors, :func:`core_bwd_reference` on CPU tensors."""
    pix = blend.bwd_pixel_inputs(gt_tiles, *totals, *cots).contiguous()
    kw = dict(cfg=cfg, tiles_x=tiles_x, height=height, width=width,
              want_med=want_med, want_var=want_var)
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
    rows = torch.zeros((table.shape[0], ROW), dtype=torch.float32,
                       device=table.device)
    launch_render_bwd(table, tile_start, tile_stop, pix, rows, **kw)
    return rows
