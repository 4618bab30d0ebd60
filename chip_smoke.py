#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``diff_gaussian_rasterization_tpu_torch``), never JAX, at
the scale the repository measures: 100,000 Gaussians at 1200x680 with 32x32
tiles for rendering and its gradient, the mapping benchmark's 500,000
Gaussians (``bench_mapping.py`` of the JAX package) for mapping steps, and
the tracking benchmark's frame (``bench_tracking.py``: 100,000 Gaussians,
1200x680, its record configuration) for tracking.  Phases:

1. build every CUDA kernel from ``ops/kernels/csrc`` (one nvcc per source,
   all started together) and print the compiler's register report;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths, and print the largest errors: on the 100k
   bench scene; ``render_jvp`` (light and full) on the tracking frame's
   full-resolution dual render (identity pose, the record configuration's
   frozen margin-2 binning, the 6 twist tangents), its primal bit-equal to
   ``render_fwd``'s and its tangents also against the plain version in
   float64, then with K = 1, 2, 3, 4, 5, 8 and 10 of those tangents, and
   its culling boxes against their mirror ``render.cull_boxes``; and (in
   phase 3, before the mapping steps) on the first mapping step's render
   at 500k, the gradient rows (``render_bwd`` stopped at the forward's
   ``n_contrib``, as the main path runs it) also against the plain version
   in float64; ``tile_scatter_sum`` on the forward's own per-pixel midx
   and ucross and ``segment_sum_rows`` on the gradient rows (F = 12) and
   on the uncertainty statistics (F = 2), bit-equal to their plain
   versions on the CPU; ``segment_sum`` (the dense oracle's reduction) on
   the pixels sorted by midx;
3. drive the main paths through the entry points a user calls, each with
   every launch counter set to 0 just before and read just after: the
   forward (``rasterize`` with precomputed colors, ``render_model`` on an
   SH-3 model from four poses; finite outputs, no overflow, the instance
   count, one ``render_fwd``, ``tile_scatter_sum`` and
   ``segment_sum_rows`` (F = 2) launch and no ``segment_sum`` per render,
   bit-equal repeat renders, the card against the CPU path on a small
   scene); forward + backward ``rasterize`` (one ``render_fwd``,
   ``render_bwd`` and ``tile_scatter_sum`` and two ``segment_sum_rows``
   launches, F = 2 and 12, per step, finite gradients for every leaf and
   the view matrix, bit-equal repeat backwards, the card's gradients
   against the port's dense ``render_oracle`` (whose own path launches
   ``segment_sum`` once) and against the CPU path in float64 on small
   scenes); five ``map_step``s at 500k, whose loss must fall; and
   ``track_frame`` at the record configuration, light and full variant (5
   ``render_jvp``, ``tile_scatter_sum`` and ``segment_sum_rows`` and no
   ``render_fwd`` or ``segment_sum`` launch per tracked frame, no overflow
   in either level's frozen binning, pose error after below 1e-3,
   bit-equal repeats), the dual render's primal bit-equal to
   ``rasterize``'s, the reused binning against a fresh one, and the card's
   tracking costs against the CPU path's on a small scene;
4. time each kernel, its plain version, its bound and the one PyTorch call
   that computes the same function (``tile_scatter_sum`` at 100k and at
   the 500k map step's render against ``index_add_`` of the in-range
   pixels' ucross at their midx and against the sorted scatter it
   replaced, and, checked bit-equal to the CPU, in its worst case, every
   pixel naming its own instance; ``segment_sum``, and ``segment_sum_rows`` at 100k and at 500k
   with F = 12 and at 100k with F = 2, by device time from
   torch.profiler, since their launch from Python outlasts them; the
   uncertainty sums against the sorted scatter they replaced;
   ``render_bwd`` at 100k and at 500k, stopped at ``n_contrib`` and
   walking the whole segment, with the pairs it tests; ``render_jvp`` also
   with the pairs its culled walk tests), the whole forward, forward +
   backward, a mapping step, a dual render and a tracked frame, with CUDA
   events, and list the device time of the forward, of forward + backward
   and of a tracked frame by kernel with torch.profiler.

Prints the card's name and power limit, a ``kernels`` JSON line, and last
the line ``{"ok": true, "device": {...}}``.  Exits non-zero, without that
line, when there is no CUDA device or any phase fails.
"""

import json
import subprocess
import sys
import time

import numpy as np

# The JAX package's count of the bench scene's tile instances (seed 0, 100k
# Gaussians, 1200x680, 32x32 tiles): 234,076 on the TPU (BENCH_r05.json),
# 234,033 on the CPU (tests/test_torch_rasterize.py holds the port to the
# CPU count).  The TPU rounds the preprocess differently (most likely its
# float32 products at reduced default precision), which moves a few
# footprints across tile edges.
JAX_TPU_BENCH_INSTANCES = 234_076
JAX_CPU_BENCH_INSTANCES = 234_033
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Operations per (instance, pixel) pair the blend evaluates: ~16 FP32
# operations for the exponent and the alpha tests plus one expf, counted
# as 8 (the special-function unit runs at 1/8 of the FP32 rate); and ~20
# more for each pair that contributes.  The bounds count the pair test
# only for the pairs that contribute: a pair below alpha_min changes no
# output, and an exact test per instance and pixel patch can skip it
# (render_jvp's culling does), so the function needs no other.
OPS_PER_PAIR = 24
OPS_PER_CONTRIB = 20
# The backward walks the same pairs; for each contributing pair, besides
# the forward's test: w, d^2, the dot product s (11), the prefix (2),
# d_alpha with one reciprocal counted as 8 (~13), e, and the twelve
# per-instance terms (~29): ~58.
OPS_PER_CONTRIB_BWD = 58
# The dual forward adds, per contribution: the shared rate (a division
# counted as 8, a compare, a subtraction) and gx, gy (6), ~16; and per
# tangent dpow (4), dw (3), the running S (2), dcolor (6), ddepth (4) and
# dweight (1), ~20, or ~29 with the full variant's conic terms.
OPS_PER_CONTRIB_JVP = 16
OPS_PER_TANGENT = {3: 20, 6: 29}
# Tangent streams against the plain version: rtol and atol (plus COL_EPS
# times the stream's largest value, below).
JVP_RTOL, JVP_ATOL = 2e-4, 2e-5
# The small tracking scene of the card-vs-CPU comparison.
SMALL_TRACK = dict(p=60_000, height=96, width=160)
# Loss weights of test_rasterize._loss (every differentiable output).
LOSS_W = dict(depth=0.3, opacity_map=0.2, depth_median=0.15, depth_var=0.1)


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters=20):
    """Device time per call of everything ``fn`` runs on the card
    (torch.profiler), without the host's launch overhead: a kernel of a
    few microseconds launched from Python is timed by its host side under
    CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_dev_us(e) for e in _device_events(prof)) / 1e3 / iters


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_events(prof):
    """The profile's device-side events (kernels, copies, fills): the
    operator-level ones repeat their time."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]


def compare_core(k, p, tol_rtol=1e-4, tol_atol=2e-5):
    """Kernel vs plain CoreOutputs: integer-field mismatch fractions, and
    the float fields' largest errors on the pixels whose integer fields
    agree.  Returns (max_abs_err, report dict, ok)."""
    import torch
    agree = ((k.n_contrib == p.n_contrib) & (k.n_valid == p.n_valid)
             & (k.midx == p.midx))
    rep, ok, worst = {}, True, 0.0
    for name in ("n_contrib", "n_valid", "midx"):
        frac = float((getattr(k, name) != getattr(p, name)).float().mean())
        rep[name + "_mismatch"] = frac
        ok &= frac < 5e-3
    for name in ("color", "depth", "weight", "median", "var", "t_final"):
        a, b = getattr(k, name), getattr(p, name)
        m = agree[:, None, :].expand_as(a) if a.dim() == 3 else agree
        a, b = a[m], b[m]
        err = float((a - b).abs().max())
        close = bool(torch.allclose(a, b, rtol=tol_rtol, atol=tol_atol))
        rep[name + "_max_abs_err"] = err
        ok &= close
        worst = max(worst, err)
    frac = float((k.npix_inst != p.npix_inst).float().mean())
    rep["npix_inst_mismatch"] = frac
    ok &= frac < 5e-3
    same = k.npix_inst == p.npix_inst
    a, b = k.u_inst[same], p.u_inst[same]
    rep["u_inst_max_abs_err"] = float((a - b).abs().max())
    ok &= bool(torch.allclose(a, b, rtol=tol_rtol, atol=tol_atol))
    return worst, rep, ok


def render_fwd_bound_ms(out, tile_start, tile_stop, pixmask):
    """The least time the card could take for this run's blend: the
    operations of the pairs that contribute, against the FP32 peak; and the
    bytes (features of the instances in segments, ranges, ground truth,
    outputs), against HBM bandwidth.  Also logs the pairs the pixels'
    segments hold up to their termination (a pixel whose final
    transmittance is >= 1e-2 can never have terminated, so it walked its
    whole segment; any other pixel walked at least to its last contributor
    + 1): the pairs a walk without culling tests."""
    import torch
    seg = (tile_stop - tile_start).to(torch.int64)[:, None]
    walked = torch.where(out.t_final >= 1e-2, seg,
                         torch.minimum(out.n_contrib.to(torch.int64) + 1,
                                       seg))
    pairs = int(torch.where(pixmask, walked, torch.zeros_like(walked)).sum())
    contribs = int(out.n_valid.to(torch.int64).sum())
    ops = contribs * (OPS_PER_PAIR + OPS_PER_CONTRIB)
    t, q = out.depth.shape
    n_inst = int(seg.sum())
    nbytes = n_inst * 11 * 4 + t * 2 * 4 + t * q * 4 + t * q * 12 * 4
    ms_ops, ms_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    info = dict(pairs=pairs, contributions=contribs, ops=ops, bytes=nbytes)
    if ms_ops >= ms_bytes:
        return ms_ops, "operations", info
    return ms_bytes, "bytes", info


def render_bwd_bound_ms(contribs, n_inst, n_tiles, q):
    """The backward's least time: the pair test and the backward's
    operations per contribution over the FP32 peak; the bytes (features,
    ranges, the per-pixel constants, the rows written) over HBM."""
    ops = contribs * (OPS_PER_PAIR + OPS_PER_CONTRIB_BWD)
    nbytes = (n_inst * 11 * 4 + n_tiles * 2 * 4 + n_tiles * q * 10 * 4
              + n_inst * 12 * 4)
    ms_ops, ms_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    info = dict(ops=ops, bytes=nbytes)
    if ms_ops >= ms_bytes:
        return ms_ops, "operations", info
    return ms_bytes, "bytes", info


def render_jvp_bound_ms(contribs, n_inst, n_tiles, q, k_t, per_k):
    """The dual forward's least time: the pair test and the forward's
    operations per contribution plus the tangents', over the FP32 peak; the
    bytes (the feature and tangent rows of the instances in segments, the
    ranges, the ground truth, the forward's 12 rows and K x 6 tangent rows
    per pixel), over HBM."""
    ops = contribs * (OPS_PER_PAIR + OPS_PER_CONTRIB + OPS_PER_CONTRIB_JVP
                      + k_t * OPS_PER_TANGENT[per_k])
    nbytes = (n_inst * (11 + per_k * k_t) * 4 + n_tiles * 2 * 4
              + n_tiles * q * 4 + n_tiles * q * (12 + 6 * k_t) * 4)
    ms_ops, ms_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    info = dict(ops=ops, bytes=nbytes)
    if ms_ops >= ms_bytes:
        return ms_ops, "operations", info
    return ms_bytes, "bytes", info


# Float32 sums of ~10^3 terms carry an absolute error of ~1e-6 of the
# largest value they reach, in the kernel and the plain version alike: the
# conic gradients reach ~6e4 at the bench scale, where atol 2e-4 is under
# one float32 ulp.  So the kernel-vs-plain comparison of the gradient rows
# adds COL_EPS times each column's largest magnitude to its atol, and the
# float64 check of compare_rows holds the kernel to the plain version's
# own float32 error in every column.
COL_EPS = 2e-6
# The float64 check: per column, the kernel's largest error against the
# plain version in float64 is at most F64_RATIO times the plain float32
# version's, or F64_FLOOR of the column's largest magnitude.
F64_RATIO = 2.0
F64_FLOOR = 1e-5


def compare_rows(rows_k, rows_p, rows_d, tile_ok, tile_ok_d, tile_start,
                 tile_stop, rtol=1e-3, atol=2e-4):
    """Kernel vs plain gradient rows on the instances of tiles whose
    ``n_contrib`` agrees on every pixel (``tile_ok``; elsewhere a threshold
    crossed at another instance changes a whole tile's rows), at ``atol +
    COL_EPS * (the column's largest value)``, and both against the plain
    version in float64 (``rows_d``, on ``tile_ok_d``).  Returns
    (max_abs_err, fraction of instance rows left out, per-column report,
    ok, ok of the float64 check)."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels.render import (
        ROW_COLUMNS)
    seg = (tile_stop - tile_start).to(torch.int64)
    first = int(tile_start[0])
    inst = lambda ok: torch.repeat_interleave(ok, seg)
    inst_ok, inst_d = inst(tile_ok), inst(tile_ok_d)
    n = inst_ok.shape[0]
    a, b = rows_k[first:first + n][inst_ok], rows_p[first:first + n][inst_ok]
    err = float((a - b).abs().max())
    ok = bool(((a - b).abs() <= atol + COL_EPS * b.abs().amax(dim=0)
               + rtol * b.abs()).all())
    # the kernel never writes the rows outside every segment (culled
    # instances, the unused tail): they keep the wrapper's zeros
    ok &= bool((rows_k[:first] == 0).all() and (rows_k[first + n:] == 0).all())
    d = rows_d[first:first + n][inst_d]
    kd = rows_k[first:first + n][inst_d].double() - d
    pd = rows_p[first:first + n][inst_d].double() - d
    scale = d.abs().amax(dim=0).clamp_min(1e-30)
    rep = {c: dict(max_abs=float(d[:, i].abs().max()),
                   kernel_vs_f64=float(kd[:, i].abs().max() / scale[i]),
                   plain_vs_f64=float(pd[:, i].abs().max() / scale[i]))
           for i, c in enumerate(ROW_COLUMNS)}
    ok_f64 = all(r["kernel_vs_f64"] <= max(F64_RATIO * r["plain_vs_f64"],
                                           F64_FLOOR) for r in rep.values())
    return err, float((~inst_ok).float().mean()), rep, ok, ok_f64


def check_render_kernels(tag, table, binn, gt_tiles, core_kw, check, seed=0):
    """``render_fwd``, ``render_bwd`` (stopped at the forward's
    ``n_contrib``, as the main path runs it), ``tile_scatter_sum`` and
    ``segment_sum_rows`` against their plain versions on one render's
    sorted table and binning, the backward with standard-normal cotangents
    from a generator seeded with ``seed``.  Returns the largest errors and
    what phase 4 reuses."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops import blend
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        segment_sum as rows_sum)
    dev = table.device
    start, stop = binn.tile_start, binn.tile_stop
    out_k = render.core_fwd(table, start, stop, gt_tiles, **core_kw)
    out_p = render.core_fwd_reference(table, start, stop, gt_tiles,
                                      **core_kw)
    torch.cuda.synchronize()
    err_fwd, rep, ok = compare_core(out_k, out_p)
    log(f"[kernel] {tag}: render_fwd vs plain: " + json.dumps(rep))
    check(ok, f"{tag}: render_fwd matches its plain version (rtol 1e-4, "
              "atol 2e-5 on agreeing pixels; integer mismatch < 5e-3)")

    # render_bwd: the kernel's forward totals and seeded cotangents
    n_tiles, q = gt_tiles.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    cots = tuple(torch.randn(shape, generator=gen, device=dev)
                 for shape in [(n_tiles, 3, q)] + [(n_tiles, q)] * 5)
    totals = (out_k.color, out_k.depth, out_k.weight, out_k.var,
              out_k.t_final)
    pix = blend.bwd_pixel_inputs(gt_tiles, *totals, *cots).contiguous()
    rows_k = render.core_bwd(table, start, stop, gt_tiles, totals, cots,
                             **core_kw, n_contrib=out_k.n_contrib)
    rows_p = render.core_bwd_reference(table, start, stop, pix, **core_kw)
    out_d = render.core_fwd_reference(table.double(), start, stop,
                                      gt_tiles.double(), **core_kw)
    rows_d = render.core_bwd_reference(table.double(), start, stop,
                                       pix.double(), **core_kw)
    torch.cuda.synchronize()
    tile_ok = (out_k.n_contrib == out_p.n_contrib).all(dim=1)
    tile_ok_d = tile_ok & (out_k.n_contrib == out_d.n_contrib).all(dim=1)
    err_bwd, left_out, rep, ok, ok_f64 = compare_rows(
        rows_k, rows_p, rows_d, tile_ok, tile_ok_d, start, stop)
    del out_d, rows_d
    log(f"[kernel] {tag}: render_bwd vs plain: max_abs_err {err_bwd} on the "
        f"rows of tiles whose n_contrib agrees; rows left out {left_out}")
    log(f"[kernel] {tag}: render_bwd per column: largest |value| and the "
        "largest error of the kernel and of the plain version against the "
        "plain version in float64, over that value: " + json.dumps(rep))
    check(ok, f"{tag}: render_bwd matches its plain version (rtol 1e-3, "
              f"atol 2e-4 + {COL_EPS} x the column's largest value; rows "
              "outside every segment zero)")
    check(ok_f64, f"{tag}: render_bwd's error against float64 is within "
                  f"{F64_RATIO} x the plain version's, or {F64_FLOOR} of "
                  "the column's largest value, in every column")
    check(left_out < 5e-3,
          f"{tag}: rows of tiles whose n_contrib disagrees < 5e-3")

    # tile_scatter_sum on the forward kernel's own per-pixel midx and
    # ucross (ucross is no CoreOutputs field: one more raw launch): in pixel
    # order, so bit-equal to the plain version's index_add_ on the CPU, and
    # core_fwd's u_inst / npix_inst are its
    out_f = torch.empty((n_tiles, 9, q), device=dev)
    out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
    render.launch_render_fwd(table, start, stop, gt_tiles, out_f, out_i,
                             **core_kw)
    n_inst = table.shape[0]
    ts_k = render.tile_scatter_sum(out_i[:, 2], out_f[:, 8], start, stop,
                                   n_inst)
    ts_p = render.tile_scatter_sum_reference(out_i[:, 2], out_f[:, 8], start,
                                             stop, n_inst)
    ts_cpu = render.tile_scatter_sum_reference(
        out_i[:, 2].cpu(), out_f[:, 8].cpu(), start.cpu(), stop.cpu(),
        n_inst)
    torch.cuda.synchronize()
    err_ts = float((ts_k[0] - ts_p[0]).abs().max())
    log(f"[kernel] {tag}: tile_scatter_sum: max_abs_err "
        f"{float((ts_k[0].cpu() - ts_cpu[0]).abs().max())} against the plain "
        f"version on the CPU, {err_ts} against it on the card (atomics); "
        f"{int(ts_cpu[1].sum())} pixels name {int((ts_cpu[1] > 0).sum())} "
        f"of {n_inst} instances; longest segment "
        f"{int((stop - start).max())} for {q} pixels a tile")
    check(torch.equal(ts_k[0].cpu(), ts_cpu[0])
          and torch.equal(ts_k[1].cpu(), ts_cpu[1]),
          f"{tag}: tile_scatter_sum equals its plain version on the CPU bit "
          "for bit")
    check(torch.equal(out_k.u_inst, ts_k[0])
          and torch.equal(out_k.npix_inst, ts_k[1]),
          f"{tag}: core_fwd's u_inst and npix_inst are tile_scatter_sum's")

    # segment_sum_rows on those rows: in run order, so bit-equal to the
    # plain version's index_add_ on the CPU (on the card index_add_ adds
    # with atomics, in no fixed order)
    inv, gs, ge = binn.inv, binn.gauss_start, binn.gauss_stop
    g_k = rows_sum.segment_sum_rows(rows_k, inv, gs, ge)
    g_p = rows_sum.segment_sum_rows_reference(rows_k, inv, gs, ge)
    g_cpu = rows_sum.segment_sum_rows_reference(
        rows_k.cpu(), inv.cpu(), gs.cpu(), ge.cpu())
    torch.cuda.synchronize()
    err_rows = float((g_k.cpu() - g_cpu).abs().max())
    log(f"[kernel] {tag}: segment_sum_rows: max_abs_err {err_rows} against "
        f"the plain version on the CPU, {float((g_k - g_p).abs().max())} "
        "against it on the card (atomics)")
    check(torch.equal(g_k.cpu(), g_cpu), f"{tag}: segment_sum_rows equals "
                                         "its plain version on the CPU bit "
                                         "for bit")
    # and on the forward's per-instance uncertainty statistics (F = 2), as
    # rasterize reduces them onto the Gaussians
    stats = torch.stack([out_k.u_inst, out_k.npix_inst.float()], 1)
    u_k = rows_sum.segment_sum_rows(stats, inv, gs, ge)
    u_cpu = rows_sum.segment_sum_rows_reference(
        stats.cpu(), inv.cpu(), gs.cpu(), ge.cpu())
    torch.cuda.synchronize()
    err_u = float((u_k.cpu() - u_cpu).abs().max())
    check(torch.equal(u_k.cpu(), u_cpu),
          f"{tag}: segment_sum_rows (F = 2, the uncertainty sums) equals its "
          "plain version on the CPU bit for bit")
    return dict(out_k=out_k, pix=pix, rows_k=rows_k, binn=binn, stats=stats,
                table=table, gt_tiles=gt_tiles, out_f=out_f, out_i=out_i,
                err_fwd=err_fwd, err_bwd=err_bwd, err_rows=err_rows,
                err_u=err_u, err_ts=err_ts)


def segment_sum_rows_times(tag, rows, binn, card):
    """``segment_sum_rows`` at one render's shapes: the kernel, its plain
    version, its bound by bytes, and the one PyTorch call that computes the
    same function, ``index_add_`` of the valid instances' rows at their
    sorted positions onto their Gaussians (atomics: not reproducible).  The
    kernel and that call by device time (``device_ms``; their CUDA-event
    times, which include the host's launch, are logged beside)."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        segment_sum as rows_sum)
    inv, gs, ge = binn.inv, binn.gauss_start, binn.gauss_stop
    n_gauss, f = gs.shape[0], rows.shape[1]
    kernel = lambda: rows_sum.segment_sum_rows(rows, inv, gs, ge)
    ms, ms_ev = device_ms(kernel), time_ms(kernel, iters=50)
    ms_plain = time_ms(lambda: rows_sum.segment_sum_rows_reference(
        rows, inv, gs, ge), iters=20)
    n_valid = int(binn.valid.sum())
    ids, valid_rows = binn.gauss_id[:n_valid], rows[:n_valid]
    lib = lambda: torch.zeros((n_gauss, f), device=rows.device).index_add_(
        0, ids, valid_rows)
    ms_lib, ms_lib_ev = device_ms(lib), time_ms(lib, iters=50)
    m_runs = int((ge - gs).to(torch.int64).sum())
    nbytes = m_runs * (f * 4 + 4) + n_gauss * (8 + f * 4)
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"[time] {card}: segment_sum_rows ({tag}) kernel {ms:.4f} ms device "
        f"time ({ms_ev:.4f} ms by CUDA events) on {m_runs} rows / {n_gauss} "
        f"Gaussians (bound {bound:.4f} ms by bytes, {nbytes} bytes), plain "
        f"{ms_plain:.4f} ms, index_add_ of the {n_valid} valid rows at sorted "
        f"positions {ms_lib:.4f} ms device time ({ms_lib_ev:.4f} ms)")
    return dict(ms=ms, plain_ms=ms_plain, bound_ms=bound, library_ms=ms_lib)


def tile_scatter_times(tag, st, card):
    """``tile_scatter_sum`` at one render's shapes: the kernel and the one
    PyTorch call that computes its function from the same unsorted input,
    ``index_add_`` of the in-range pixels' ucross at their midx (atomics:
    not reproducible), by device time (``device_ms``; their CUDA-event
    times, which include the host's launch, are logged beside); its plain
    version; its bound by bytes (midx and ucross read once, the ranges
    read once, the two outputs written once); and the whole reduction by
    CUDA events and by device time against the path it replaced on the
    render path (``scatter_sum``: a stable sort of every pixel's key, a
    searchsorted and the ``segment_sum`` kernel)."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    out_f, out_i, binn = st["out_f"], st["out_i"], st["binn"]
    midx, ucross = out_i[:, 2], out_f[:, 8]
    start, stop = binn.tile_start, binn.tile_stop
    n_inst, dev = st["table"].shape[0], midx.device
    n_tiles, q = midx.shape
    kernel = lambda: render.tile_scatter_sum(midx, ucross, start, stop,
                                             n_inst)
    ms, ms_ev = device_ms(kernel), time_ms(kernel, iters=50)
    ms_plain = time_ms(lambda: render.tile_scatter_sum_reference(
        midx, ucross, start, stop, n_inst), iters=20)
    sel = midx.reshape(-1) >= 0
    keys = midx.reshape(-1)[sel].to(torch.int64)
    vals = ucross.reshape(-1)[sel]
    lib = lambda: torch.zeros(n_inst, device=dev).index_add_(0, keys, vals)
    ms_lib, ms_lib_ev = device_ms(lib), time_ms(lib, iters=50)
    ones = torch.ones(n_tiles * q, dtype=torch.int32, device=dev)
    old = lambda: render.scatter_sum(midx.reshape(-1), ucross.reshape(-1),
                                     ones, n_inst)
    ms_old, ms_old_ev = device_ms(old), time_ms(old, iters=50)
    nbytes = n_tiles * q * 8 + n_tiles * 8 + n_inst * 8
    bound = nbytes / PEAK_BYTES * 1e3
    # the most distinct instances a tile names: the kernel's passes are
    # ceil(that / 32)
    named = torch.where((midx >= start[:, None]) & (midx < stop[:, None]),
                        midx, torch.full_like(midx, -1))
    named = torch.sort(named, dim=1)[0]
    distinct = (((named[:, 1:] != named[:, :-1]) & (named[:, 1:] >= 0))
                .sum(1) + (named[:, 0] >= 0))
    most = int(distinct.max())
    log(f"[time] {card}: tile_scatter_sum ({tag}) kernel {ms:.4f} ms device "
        f"time ({ms_ev:.4f} ms by CUDA events) on {n_tiles * q} pixels "
        f"({int(sel.sum())} with a median crossing) / {n_inst} instances, "
        f"at most {most} named by a tile ({-(-most // 32)} passes) "
        f"(bound {bound:.4f} ms by bytes, {nbytes} bytes), plain "
        f"{ms_plain:.4f} ms, index_add_ of the in-range pixels' ucross at "
        f"their midx {ms_lib:.4f} ms device time ({ms_lib_ev:.4f} ms); the "
        f"sorted scatter it replaced (sort, searchsorted, segment_sum) "
        f"{ms_old:.4f} ms device time ({ms_old_ev:.4f} ms by CUDA events)")
    return dict(ms=ms, plain_ms=ms_plain, bound_ms=bound, library_ms=ms_lib)


def tile_scatter_worst_case(st, card, check):
    """``tile_scatter_sum`` where every pixel of the render's tiles names
    an instance of its own (the most distinct instances a tile can name,
    its pixel count: one pass of the counting sort per 32), checked
    bit-equal to its plain version on the CPU and timed by device time
    beside one pass's shapes and ``index_add_``."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    ucross = st["out_f"][:, 8]
    n_tiles, q = ucross.shape
    dev = ucross.device
    start = torch.arange(n_tiles, dtype=torch.int32, device=dev) * q
    stop = start + q
    n_inst = n_tiles * q
    midx = (start[:, None] + torch.arange(q, dtype=torch.int32,
                                          device=dev)).contiguous()
    got = render.tile_scatter_sum(midx, ucross, start, stop, n_inst)
    want = render.tile_scatter_sum_reference(
        midx.cpu(), ucross.cpu(), start.cpu(), stop.cpu(), n_inst)
    check(torch.equal(got[0].cpu(), want[0])
          and torch.equal(got[1].cpu(), want[1]),
          f"tile_scatter_sum with {q} instances a tile ({q // 32} passes) "
          "equals its plain version on the CPU bit for bit")
    ms = device_ms(lambda: render.tile_scatter_sum(midx, ucross, start,
                                                   stop, n_inst))
    keys = midx.reshape(-1).to(torch.int64)
    vals = ucross.reshape(-1)
    ms_lib = device_ms(lambda: torch.zeros(n_inst, device=dev).index_add_(
        0, keys, vals))
    log(f"[time] {card}: tile_scatter_sum worst case, every one of "
        f"{n_tiles} x {q} pixels naming its own instance ({q // 32} passes "
        f"a tile): {ms:.4f} ms device time, index_add_ {ms_lib:.4f} ms")


def render_bwd_times(tag, st, core_kw, card, plain_iters=2):
    """``render_bwd`` at one render's shapes, as the main path launches it
    (each pixel stopped at the forward's n_contrib) and walking the whole
    segment (an n_contrib of INT_MAX), by CUDA events; its plain version; its bound; and
    the (instance, pixel) pairs the forward walks, the pairs up to each
    pixel's last contributor, the pairs the kernel tests (its counter
    build) and the contributions."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    table, binn, pix, out_k = st["table"], st["binn"], st["pix"], st["out_k"]
    start, stop = binn.tile_start, binn.tile_stop
    n_tiles, q = st["gt_tiles"].shape
    rows_buf = torch.zeros_like(st["rows_k"])
    run = lambda ncon: render.launch_render_bwd(
        table, start, stop, pix, rows_buf, **core_kw, n_contrib=ncon)
    ms = time_ms(lambda: run(out_k.n_contrib), iters=20)
    whole = torch.full_like(out_k.n_contrib, torch.iinfo(torch.int32).max)
    ms_walk = time_ms(lambda: run(whole), iters=20)
    ms_plain = time_ms(lambda: render.core_bwd_reference(
        table, start, stop, pix, **core_kw), iters=plain_iters, warmup=1)
    pixmask = render.pixel_coords(n_tiles, core_kw["tiles_x"],
                                  core_kw["cfg"].tile_h,
                                  core_kw["cfg"].tile_w, core_kw["height"],
                                  core_kw["width"], table.device)[2]
    _, _, finfo = render_fwd_bound_ms(out_k, start, stop, pixmask)
    to_last = int(torch.where(pixmask, out_k.n_contrib.to(torch.int64),
                              torch.zeros_like(pixmask, dtype=torch.int64))
                  .sum())
    tested = torch.zeros(1, dtype=torch.int64, device=table.device)
    render.launch_render_bwd(table, start, stop, pix, rows_buf, **core_kw,
                             n_contrib=out_k.n_contrib, pairs=tested)
    n_seg = int((stop - start).sum())
    bound, by, binfo = render_bwd_bound_ms(finfo["contributions"], n_seg,
                                           n_tiles, q)
    log(f"[time] {card}: render_bwd ({tag}) kernel {ms:.4f} ms stopped at "
        f"n_contrib, {ms_walk:.4f} ms walking the whole segment (bound "
        f"{bound:.4f} ms by {by}: {json.dumps(binfo)}), plain version "
        f"{ms_plain:.3f} ms; pairs tested {int(tested)}, "
        f"{to_last} up to each pixel's last contributor, {finfo['pairs']} "
        f"walked by the forward, {finfo['contributions']} contributions")
    return dict(ms=ms, plain_ms=ms_plain, bound_ms=bound, bound_by=by,
                library_ms=None)


def loss_of(out, wc):
    """test_rasterize._loss: every differentiable output of a render."""
    loss = (wc * out.color).sum()
    for name, w in LOSS_W.items():
        loss = loss + w * getattr(out, name).sum()
    return loss


GRAD_LEAVES = ("scales", "rotations", "opacities", "colors_precomp", "shs")


def grads_of(render, means, cam, cfg, kw, wc):
    """Forward + backward of ``loss_of(render(...))``: gradients of the
    means, of the other Gaussian leaves in ``kw`` and of the view matrix."""
    args = dict(kw)
    leaves = {k: args.pop(k) for k in GRAD_LEAVES if k in args}
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves.items()}
    means = means.detach().clone().requires_grad_(True)
    view = cam.viewmatrix.detach().clone().requires_grad_(True)
    out = render(means, cam.replace(viewmatrix=view), cfg, **leaves, **args)
    loss_of(out, wc).backward()
    return {"means3D": means.grad, "view": view.grad,
            **{k: v.grad for k, v in leaves.items()}}


def grads_close(a, b, rtol, atol):
    """Per leaf, the largest ``|a - b| / (atol + rtol |b|)`` (at most 1 where
    ``allclose`` holds); and the largest error over the leaves."""
    err, ratio = 0.0, {}
    for k in a:
        x, y = a[k].detach().cpu().double(), b[k].detach().cpu().double()
        err = max(err, float((x - y).abs().max()))
        ratio[k] = float(((x - y).abs() / (atol + rtol * y.abs())).max())
    return err, ratio


def profile_breakdown(fn, n=3, top=12):
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the host-clock window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(_device_events(prof), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    lines = [f"{_dev_us(e) / 1e3 / n:9.4f} ms/call  x{e.count // n:<4d} "
             f"{e.key[:90]}" for e in rows[:top]]
    return wall_ms / n, busy_ms / n, lines


def compare_tangents(tk, tp, td, tile_ok, tile_ok_d):
    """Kernel vs plain tangent streams (each output's tangent along one
    direction) on the tiles whose ``n_contrib`` agrees on every pixel, at
    rtol JVP_RTOL and atol JVP_ATOL + COL_EPS x the stream's largest value;
    and both against the plain version in float64 (``td``, on
    ``tile_ok_d``): the kernel's largest error at most F64_RATIO x the
    plain float32 version's, or F64_FLOOR of the stream's largest value.
    Returns (max_abs_err, per-stream report, ok, ok of the float64
    check)."""
    rep, ok, ok_f64, worst = {}, True, True, 0.0
    for name in ("color", "depth", "weight", "t_final"):
        a, b, d = getattr(tk, name), getattr(tp, name), getattr(td, name)
        for k in range(a.shape[1]):
            x, y = a[:, k][tile_ok], b[:, k][tile_ok]
            scale = float(y.abs().max())
            err = float((x - y).abs().max())
            ok &= bool(((x - y).abs() <= JVP_ATOL + COL_EPS * scale
                        + JVP_RTOL * y.abs()).all())
            worst = max(worst, err)
            dd = d[:, k][tile_ok_d]
            s64 = max(float(dd.abs().max()), 1e-30)
            kd = float((a[:, k][tile_ok_d].double() - dd).abs().max()) / s64
            pd = float((b[:, k][tile_ok_d].double() - dd).abs().max()) / s64
            ok_f64 &= kd <= max(F64_RATIO * pd, F64_FLOOR)
            rep[f"{name}[{k}]"] = dict(max_abs=scale, err=err,
                                       kernel_vs_f64=kd, plain_vs_f64=pd)
    return worst, rep, ok, ok_f64


def check_jvp_kernel(tag, table, tans, binn, gt_tiles, core_kw, full,
                     check):
    """``render_jvp`` against its plain version (and the plain version in
    float64) on one dual render's sorted tables, and its primal against
    ``render_fwd`` on the same table.  Returns the largest error and the
    kernel's outputs."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    start, stop = binn.tile_start, binn.tile_stop
    kw = dict(core_kw, full=full)
    out_k, tan_k = render.core_fwd_jvp(table, tans, start, stop, gt_tiles,
                                       **kw)
    fwd = render.core_fwd(table, start, stop, gt_tiles, **core_kw)
    out_p, tan_p = render.core_fwd_jvp_reference(table, tans, start, stop,
                                                 gt_tiles, **kw)
    out_d, tan_d = render.core_fwd_jvp_reference(
        table.double(), tans.double(), start, stop, gt_tiles.double(), **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(getattr(out_k, f), getattr(fwd, f))
              for f in out_k._fields),
          f"{tag}: render_jvp's primal outputs are bit-equal to render_fwd's")
    err_p, rep, ok = compare_core(out_k, out_p)
    log(f"[kernel] {tag}: render_jvp primal vs plain: " + json.dumps(rep))
    check(ok, f"{tag}: render_jvp's primal matches its plain version (rtol "
              "1e-4, atol 2e-5 on agreeing pixels; integer mismatch < 5e-3)")
    tile_ok = (out_k.n_contrib == out_p.n_contrib).all(dim=1)
    # float64 also has to pick the same contributors (n_valid): a pair on
    # the alpha_min threshold moves a tangent by a whole term
    tile_ok_d = tile_ok & ((out_k.n_contrib == out_d.n_contrib)
                           & (out_k.n_valid == out_d.n_valid)).all(dim=1)
    left_out = float((~tile_ok).float().mean())
    err_t, trep, ok_t, ok_f64 = compare_tangents(tan_k, tan_p, tan_d,
                                                 tile_ok, tile_ok_d)
    del out_d, tan_d
    log(f"[kernel] {tag}: render_jvp tangents vs plain: max_abs_err {err_t} "
        f"on the tiles whose n_contrib agrees; tiles left out {left_out}")
    log(f"[kernel] {tag}: render_jvp per stream: largest |value|, error vs "
        "plain, and the largest error of the kernel and of the plain "
        "version against the plain version in float64, over that value: "
        + json.dumps(trep))
    check(ok_t, f"{tag}: render_jvp's tangents match the plain version "
                f"(rtol {JVP_RTOL}, atol {JVP_ATOL} + {COL_EPS} x the "
                "stream's largest value)")
    check(ok_f64, f"{tag}: render_jvp's tangent error against float64 is "
                  f"within {F64_RATIO} x the plain version's, or "
                  f"{F64_FLOOR} of the stream's largest value")
    check(left_out < 5e-3, f"{tag}: tiles whose n_contrib disagrees < 5e-3")
    check(float(tan_k.median.abs().max()) == 0.0
          and float(tan_k.color.abs().max()) > 0,
          f"{tag}: median tangent zero, color tangents non-zero")
    return dict(out_k=out_k, err=max(err_p, err_t))


def boxes_agree(k, m, ulps=8):
    """Culling boxes [N, 4] (x0, x1, y0, y1) of the kernel against the
    mirror's: the same infinities, and finite edges within ``ulps`` float32
    ulps of the larger edge of their axis (the kernel's logf and the CPU's
    log may each round differently).  Returns (ok, largest difference in
    those ulps)."""
    import torch
    axis = torch.stack([m[:, 0:2].abs().amax(1), m[:, 2:4].abs().amax(1)], 1)
    unit = axis.repeat_interleave(2, 1) * 2.0 ** -23
    fin = torch.isfinite(m)
    if not (torch.equal(torch.isfinite(k), fin)
            and torch.equal(k[~fin], m[~fin])):
        return False, float("inf")
    diff = ((k - m).abs()[fin] / unit[fin].clamp_min(2.0 ** -126))
    worst = float(diff.max()) if diff.numel() else 0.0
    return worst <= ulps, worst


def twist_basis(view):
    """[6, 4, 4]: the view matrix's derivatives along the twist basis."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models.lie import apply_twist
    tw = torch.func.jacfwd(lambda x: apply_twist(view, x))(
        torch.zeros(6, dtype=view.dtype, device=view.device))
    return tw.movedim(-1, 0)


def tracking_kernels(dev, check):
    """Phase 2 for the tracking path: ``render_jvp`` (light and full)
    against its plain version on the full-resolution dual render of the
    tracking frame, at the identity pose with the record configuration's
    frozen binning and the 6 twist tangents, and with K = 1, 2, 3, 4, 5, 8
    and 10 of them; and the kernel's culling boxes against their mirror."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        frozen_budget)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.scenes import tracking_frame
    ts = tracking_frame(device=dev)
    means = ts.model.means3D.detach()
    with torch.no_grad():
        kwm = ts.model.raster_kwargs()
    margin = ts.tcfg.bin_margin_px
    binn = ras.bin_for_view(
        means, ts.camera, ts.cfg.replace(bin_margin_px=margin),
        max_instances=frozen_budget(ts.cfg, means.shape[0], margin), **kwm)
    tw = twist_basis(ts.camera.viewmatrix)
    core_kw = dict(cfg=ts.cfg, tiles_x=-(-ts.camera.width // ts.cfg.tile_w),
                   height=ts.camera.height, width=ts.camera.width)
    log(f"[track] tracking frame: {int(ts.frame.depth.gt(0).sum())} pixels "
        f"with depth, budget {ts.cfg.max_instances}, frozen binning "
        f"{int(binn.num_rendered)} instances (budget "
        f"{binn.gauss_id.shape[0]}, overflow {bool(binn.overflow)})")
    variants = {}
    for variant, vcfg in (("light", ts.cfg), ("full", ts.cfg.full_variant())):
        with torch.no_grad():
            _, _, table, tans, gt_tiles = ras.pose_jvp_tables(
                means, ts.camera, vcfg, tw, None, ts.frame.depth, binn=binn,
                **kwm)
        res = check_jvp_kernel(f"tracking {variant}", table, tans, binn,
                               gt_tiles, core_kw, variant == "full", check)
        variants[variant] = dict(res, cfg=vcfg, table=table, tans=tans,
                                 gt_tiles=gt_tiles)
        # other K on the same frame: tangent tables of subsets and repeats
        # of the twist directions (K = 8 and 10 take two launches, the
        # second of 2 and of 4 columns)
        per_k = 6 if variant == "full" else 3
        by_k = tans.reshape(tans.shape[0], 6, per_k)
        for pick in ([5], [0, 1], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3, 4],
                     [0, 1, 2, 3, 4, 5, 0, 3],
                     [0, 1, 2, 3, 4, 5, 0, 1, 2, 3]):
            sub = by_k[:, pick].reshape(tans.shape[0], -1).contiguous()
            check_jvp_kernel(f"tracking {variant} K={len(pick)}", table, sub,
                             binn, gt_tiles, core_kw, variant == "full",
                             check)
    # the kernel's own culling boxes on this frame's table against their
    # mirror, which the CPU tests hold to the blend's alpha
    table = variants["light"]["table"]
    box_k = render.cull_boxes(table, ts.cfg.alpha_min)
    box_m = render.cull_boxes(table.cpu(), ts.cfg.alpha_min)
    agree, worst = boxes_agree(box_k.cpu(), box_m)
    log(f"[kernel] tracking: render_jvp's culling boxes of {table.shape[0]} "
        f"rows against render.cull_boxes on the CPU: largest difference "
        f"{worst} float32 ulps of the axis's larger edge")
    check(agree, "render_jvp's culling boxes equal their CPU mirror (the same "
                 "infinities, finite edges within 8 ulps)")
    return dict(ts=ts, means=means, kwm=kwm, binn=binn, tw=tw,
                core_kw=core_kw, variants=variants)


def tracking_path(st, dev, check):
    """Phase 3 for the tracking path: ``track_frame`` at the record
    configuration, light and full, with the launch counts of one tracked
    frame, the frozen binnings, the pose error and a bit-equal repeat; the
    dual render's primal against ``rasterize`` at the same binning; the
    reused binning against a fresh one at the binning pose; and the card
    against the CPU path on a small scene."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        Frame, track_frame)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.scenes import (
        mapping_model, tracking_frame)
    ts, means, kwm, binn = st["ts"], st["means"], st["kwm"], st["binn"]
    eye = ts.camera.viewmatrix
    err_before = float((ts.view0 - eye).abs().max())
    n_dual = ts.tcfg.coarse_iters + ts.tcfg.iters
    want = dict(render_fwd=0, tile_scatter_sum=n_dual, segment_sum=0,
                render_bwd=0, segment_sum_rows=n_dual, render_jvp=n_dual)
    st["counts"], st["pose_err"] = {}, {}
    for variant in ("light", "full"):
        vcfg = st["variants"][variant]["cfg"]
        binns = []
        render.reset_launches()
        v1, c1, cs1 = track_frame(ts.model, ts.view0, ts.frame, vcfg,
                                  ts.tcfg, ts.camera, binnings=binns)
        torch.cuda.synchronize()
        counts, rows = dict(render.launches), dict(render.row_launches)
        v2, _, _ = track_frame(ts.model, ts.view0, ts.frame, vcfg, ts.tcfg,
                               ts.camera)
        err_after = float((v1 - eye).abs().max())
        st["counts"][variant] = counts
        st["pose_err"][variant] = (err_before, err_after)
        log(f"[track] {variant}: one tracked frame, launches {counts}; "
            f"costs {cs1.tolist()}, best {float(c1)}; pose_err_before "
            f"{err_before}, pose_err_after {err_after}; frozen binnings "
            f"{[int(b.num_rendered) for b in binns]} instances, overflow "
            f"{[bool(b.overflow) for b in binns]}")
        check(counts == want and rows == {2: n_dual},
              f"track {variant}: launches per tracked frame {want}, every "
              "segment_sum_rows at F = 2")
        check(len(binns) == ts.tcfg.pyramid
              and not any(bool(b.overflow) for b in binns),
              f"track {variant}: no overflow in either level's frozen "
              "binning")
        check(err_after < 1e-3, f"track {variant}: pose_err_after < 1e-3")
        check(torch.equal(v1, v2), f"track {variant}: two tracked frames "
                                   "give bit-equal views")

    with torch.no_grad():
        j = ras.rasterize_with_pose_jvp(means, ts.camera, ts.cfg, st["tw"],
                                        gt_depth=ts.frame.depth, binn=binn,
                                        **kwm)
        reused = ras.rasterize(means, ts.camera, ts.cfg,
                               gt_depth=ts.frame.depth, binn=binn, **kwm)
        fresh = ras.rasterize(means, ts.camera, ts.cfg,
                              gt_depth=ts.frame.depth, **kwm)
    torch.cuda.synchronize()
    check(all(torch.equal(getattr(j.out, f), getattr(reused, f))
              for f in reused._fields),
          "rasterize_with_pose_jvp's primal is bit-equal to rasterize at the "
          "same pose and binning")
    fields = ("color", "depth", "opacity_map")
    errs = {f: float((getattr(fresh, f) - getattr(reused, f)).abs().max())
            for f in fields}
    bit = all(torch.equal(getattr(fresh, f), getattr(reused, f))
              for f in fields)
    log(f"[track] rasterize(binn=margin binning) vs a fresh rasterize at the "
        f"binning pose: max_abs_err {errs}, bit-equal {bit}")
    check(all(e <= 5e-6 for e in errs.values()),
          "rasterize with the reused margin binning equals a fresh one at the "
          "binning pose (atol 5e-6)")

    # the card against the CPU path on a small scene: the CPU's scene, its
    # frame and start pose moved to the card
    sc = tracking_frame(device="cpu", **SMALL_TRACK)
    v_c, c_c, cs_c = track_frame(sc.model, sc.view0, sc.frame, sc.cfg,
                                 sc.tcfg, sc.camera)
    to = lambda x: x.to(dev)
    v_g, c_g, cs_g = track_frame(
        mapping_model(p=SMALL_TRACK["p"], device=dev), to(sc.view0),
        Frame(to(sc.frame.rgb), to(sc.frame.depth)), sc.cfg, sc.tcfg,
        sc.camera.replace(viewmatrix=to(sc.camera.viewmatrix)))
    log(f"[small] tracking {SMALL_TRACK}: costs on the card {cs_g.tolist()}, "
        f"on the CPU {cs_c.tolist()}; pose_err_after card "
        f"{float((v_g.cpu() - sc.camera.viewmatrix).abs().max())}, CPU "
        f"{float((v_c - sc.camera.viewmatrix).abs().max())}")
    check(torch.allclose(cs_g.cpu(), cs_c, rtol=1e-3, atol=0.0),
          "the card's track_frame agrees with the CPU path's per-iteration "
          "costs on a small scene (rtol 1e-3)")


def tracking_times(st, dev, card):
    """Phase 4 for the tracking path: the ``render_jvp`` kernel (light and
    full) with its plain version and bound, one dual render, ms per
    tracked frame over 5 frames, and a profile of one tracked frame.
    Returns the ``kernels`` line's two entries."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models.slam import track_frame
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    ts, binn, core_kw = st["ts"], st["binn"], st["core_kw"]
    start, stop = binn.tile_start, binn.tile_stop
    n_tiles, q = st["variants"]["light"]["gt_tiles"].shape
    pixmask = render.pixel_coords(n_tiles, core_kw["tiles_x"],
                                  ts.cfg.tile_h, ts.cfg.tile_w,
                                  core_kw["height"], core_kw["width"],
                                  dev)[2]
    entries = []
    for variant in ("light", "full"):
        v = st["variants"][variant]
        full = variant == "full"
        table, tans, gt_tiles = v["table"], v["tans"], v["gt_tiles"]
        k_t = tans.shape[1] // (6 if full else 3)
        out_f = torch.empty((n_tiles, 9, q), device=dev)
        out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
        out_t = torch.empty((n_tiles, k_t, 6, q), device=dev)
        ms = time_ms(lambda: render.launch_render_jvp(
            table, tans, start, stop, gt_tiles, out_f, out_i, out_t,
            full=full, **core_kw), iters=20)
        ms_plain = time_ms(lambda: render.core_fwd_jvp_reference(
            table, tans, start, stop, gt_tiles, full=full, **core_kw),
            iters=2, warmup=1)
        _, _, finfo = render_fwd_bound_ms(v["out_k"], start, stop, pixmask)
        n_seg = int((stop - start).sum())
        bound, by, binfo = render_jvp_bound_ms(
            finfo["contributions"], n_seg, n_tiles, q, k_t, 6 if full else 3)
        # the pairs the culled walk tests, against the pairs each pixel's
        # segment holds up to its termination and the contributions (the
        # bound's count)
        tested = torch.zeros(1, dtype=torch.int64, device=dev)
        render.launch_render_jvp(table, tans, start, stop, gt_tiles, out_f,
                                 out_i, out_t, full=full, pairs=tested,
                                 **core_kw)
        log(f"[time] {card}: render_jvp ({variant}, K={k_t}) kernel "
            f"{ms:.4f} ms (bound {bound:.4f} ms by {by}: "
            f"{json.dumps(dict(finfo, **binfo))}), plain version "
            f"{ms_plain:.3f} ms; pairs tested {int(tested)} of "
            f"{finfo['pairs']} walked, for {finfo['contributions']} "
            "contributions")
        entries.append(dict(
            name="render_jvp" if variant == "light" else "render_jvp_full",
            route="cuda",
            source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                   "render_jvp.cu",
            replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                     "render_pallas.py:440",
            launches=st["counts"][variant]["render_jvp"], max_abs_err=v["err"],
            ms=ms, plain_ms=ms_plain, bound_ms=bound, bound_by=by,
            library_ms=None))

    args = (st["means"], ts.camera, ts.cfg)
    with torch.no_grad():
        ms_dual = time_ms(lambda: ras.rasterize_with_pose_jvp(
            *args, st["tw"], gt_depth=ts.frame.depth, binn=binn,
            **st["kwm"]), iters=10)
        # its stages before the kernel: the preprocess alone, and with the
        # batched forward-mode pass and the row gather
        ms_prep = time_ms(lambda: ras.prepare(
            *args, None, ts.frame.depth, binn=binn, **st["kwm"]), iters=10)
        ms_tables = time_ms(lambda: ras.pose_jvp_tables(
            *args, st["tw"], None, ts.frame.depth, binn=binn, **st["kwm"]),
            iters=10)
    track = lambda cfg: track_frame(ts.model, ts.view0, ts.frame, cfg,
                                    ts.tcfg, ts.camera)
    ms_track = time_ms(lambda: track(ts.cfg), iters=5, warmup=1)
    ms_track_full = time_ms(lambda: track(st["variants"]["full"]["cfg"]),
                            iters=5, warmup=1)
    log(f"[time] {card}: one rasterize_with_pose_jvp (K=6, frozen binning) "
        f"{ms_dual:.3f} ms, of which pose_jvp_tables {ms_tables:.3f} ms "
        f"(its preprocess alone, prepare: {ms_prep:.3f} ms); ms per tracked "
        f"frame at the record "
        f"configuration {ms_track:.3f} (full variant {ms_track_full:.3f}) "
        f"over 5 frames; pose_err_before/after {st['pose_err']}")
    wall, busy, lines = profile_breakdown(lambda: track(ts.cfg))
    if busy > 0:
        log(f"[profile] {card}: one tracked frame {wall:.3f} ms host clock, "
            f"device busy {busy:.3f} ms ({busy / wall:.3f} of the window, "
            f"idle share {1 - busy / wall:.3f}); device time by kernel:")
        for line in lines:
            log(f"[profile]   {line}")
    else:
        log("[profile] torch.profiler saw no device time: not measured")
    return entries


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2

    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        PARAM_FIELDS, DensifyState)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        MappingConfig, make_map_optimizer, map_step, render_model)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import _build
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        segment_sum as rows_sum)
    from diff_gaussian_rasterization_tpu_torch.ops.oracle import render_oracle
    from diff_gaussian_rasterization_tpu_torch.scenes import (
        bench_camera, bench_scene, mapping_model, orbit_view, random_model,
        small_scene)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    failures = []

    def check(cond, what):
        log(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    # ---- 1. build ------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    log(f"[build] {len(logs)} source(s) in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------
    cfg = RasterConfig(tile_h=32, tile_w=32)
    means, kw = bench_scene(device=dev)
    cam = bench_camera(device=dev)
    h, w = cam.height, cam.width
    n_inst = int(ras.count_instances(means, cam, cfg, **kw))
    log(f"[count] count_instances = {n_inst}; the JAX package counts "
        f"{JAX_CPU_BENCH_INSTANCES} on the CPU (difference "
        f"{n_inst - JAX_CPU_BENCH_INSTANCES}) and {JAX_TPU_BENCH_INSTANCES} "
        f"on the TPU (difference {n_inst - JAX_TPU_BENCH_INSTANCES}: the "
        f"TPU rounds the preprocess differently)")
    check(abs(n_inst - JAX_CPU_BENCH_INSTANCES) <= 5,
          "count_instances within 5 of the JAX package's CPU count")
    max_inst = int(-(-n_inst * 1.1 // 1024) * 1024)
    prep_kw = {k: v for k, v in kw.items() if k not in ("bg", "gt_depth")}
    _, binn, feat, gt_tiles = ras.prepare(means, cam, cfg, max_inst,
                                          kw["gt_depth"], **prep_kw)
    table = feat[binn.gauss_id].contiguous()
    tiles_x = -(-w // cfg.tile_w)
    core_kw = dict(cfg=cfg, tiles_x=tiles_x, height=h, width=w)
    bench = check_render_kernels("100k", table, binn, gt_tiles, core_kw,
                                 check)
    out_k, pix, rows_k = bench["out_k"], bench["pix"], bench["rows_k"]

    # segment_sum, the dense oracle's per-Gaussian reduction (the render
    # path no longer runs it), on the forward's pixel-level inputs sorted
    # by midx: the sorted scatter it ran there before tile_scatter_sum
    out_f, out_i = bench["out_f"], bench["out_i"]
    ucross = out_f[:, 8].reshape(-1)
    keys = out_i[:, 2].reshape(-1).to(torch.int64)
    keys = torch.where(keys >= 0, keys, torch.full_like(keys, table.shape[0]))
    key_s, order = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(
        key_s, torch.arange(table.shape[0] + 1, device=dev), out_int32=True)
    seg_vals = ucross[order].contiguous()
    seg_ones = torch.ones_like(seg_vals, dtype=torch.int32)
    s_k = render.segment_sum(seg_vals, seg_ones, bounds)
    s_p = render.segment_sum_reference(seg_vals, seg_ones, bounds)
    torch.cuda.synchronize()
    err_seg = float((s_k[0] - s_p[0]).abs().max())
    log(f"[kernel] segment_sum vs plain: max_abs_err {err_seg}, "
        f"counts equal {bool(torch.equal(s_k[1], s_p[1]))}")
    # the plain version's index_add_ adds with atomics on the card, in no
    # fixed order: sums of up to ~10^3 terms differ by a few ulps
    check(torch.allclose(s_k[0], s_p[0], rtol=1e-5, atol=1e-5)
          and torch.equal(s_k[1], s_p[1]),
          "segment_sum matches its plain version (rtol 1e-5, atol 1e-5; "
          "counts exactly)")
    # render_jvp on the tracking path's full-resolution dual render
    trk = tracking_kernels(dev, check)

    # ---- 3. the main path ----------------------------------------------
    model = random_model(seed=0, sh_degree=3, device=dev)
    views = [orbit_view(a, device=dev) for a in (0.0, 4.0, -4.0, 8.0)]
    renders = 0
    render.reset_launches()
    with torch.no_grad():
        out_a = ras.rasterize(means, cam, cfg, max_instances=max_inst, **kw)
        out_b = ras.rasterize(means, cam, cfg, max_instances=max_inst, **kw)
        renders += 2
        model_outs = []
        for v in views:
            model_outs.append(render_model(
                model, bench_camera(v, device=dev), cfg,
                gt_depth=kw["gt_depth"]))
            renders += 1
    torch.cuda.synchronize()
    counts, rows_fwd = dict(render.launches), dict(render.row_launches)
    log(f"[main] {renders} renders, launches {counts}, segment_sum_rows by "
        f"row width {rows_fwd}")
    check(counts["render_fwd"] == renders,
          "one render_fwd launch per render on the main path")
    check(counts["tile_scatter_sum"] == renders
          and counts["segment_sum"] == 0
          and counts["segment_sum_rows"] == renders
          and rows_fwd == {2: renders},
          "one tile_scatter_sum and one segment_sum_rows (F = 2) launch and "
          "no segment_sum launch per render on the main path")
    for i, o in enumerate([out_a] + model_outs):
        finite = all(bool(torch.isfinite(getattr(o, f).float()).all())
                     for f in ("color", "depth", "depth_median", "depth_var",
                               "opacity_map", "gau_uncertainty"))
        check(finite and tuple(o.color.shape) == (3, h, w),
              f"render {i}: finite outputs of shape (3, {h}, {w})")
        check(not bool(o.overflow),
              f"render {i}: no overflow ({int(o.num_rendered)} instances)")
    check(int(out_a.num_rendered) == n_inst,
          "rasterize's num_rendered equals count_instances")
    check(all(torch.equal(getattr(out_a, f), getattr(out_b, f))
              for f in out_a._fields),
          "two renders of one view are bit-equal in every output")
    cov = float((model_outs[0].opacity_map > 0.5).float().mean())
    log(f"[main] SH-3 model: mean color {model_outs[0].color.mean():.4f}, "
        f"opacity > 0.5 on {cov:.3f} of the pixels")
    check(cov > 0.2, "the SH-3 model covers the image")

    # the card's render against the CPU path on a small scene
    sm, skw = bench_scene(seed=1, p=3000, height=96, width=160, device="cpu")
    scam = bench_camera(height=96, width=160, device="cpu")
    scfg = RasterConfig(tile_h=16, tile_w=16)
    with torch.no_grad():
        o_cpu = ras.rasterize(sm, scam, scfg, **skw)
        o_gpu = ras.rasterize(
            sm.to(dev), bench_camera(height=96, width=160, device=dev), scfg,
            **{k: v.to(dev) for k, v in skw.items()})
    diff = float((o_gpu.color.cpu() - o_cpu.color).abs().max())
    ncm = float((o_gpu.n_contrib.cpu() != o_cpu.n_contrib).float().mean())
    log(f"[small] card vs CPU path: color max_abs_err {diff}, "
        f"n_contrib mismatch {ncm}")
    check(diff < 1e-3 and ncm < 5e-3,
          "the card's rasterize agrees with the CPU path on a small scene")

    # forward + backward at bench scale, twice
    wc = torch.as_tensor(np.random.RandomState(1).uniform(
        0.5, 1, (3, 1, 1)).astype(np.float32), device=dev)
    bench_render = lambda *a, **k: ras.rasterize(*a, max_instances=max_inst,
                                                 **k)
    render.reset_launches()
    g_a = grads_of(bench_render, means, cam, cfg, kw, wc)
    g_b = grads_of(bench_render, means, cam, cfg, kw, wc)
    torch.cuda.synchronize()
    counts_fb, rows_fb = dict(render.launches), dict(render.row_launches)
    log(f"[main] 2 forward + backward steps, launches {counts_fb}, "
        f"segment_sum_rows by row width {rows_fb}")
    check(all(counts_fb[k] == 2 for k in ("render_fwd", "render_bwd",
                                           "tile_scatter_sum"))
          and counts_fb["segment_sum"] == 0
          and counts_fb["segment_sum_rows"] == 4
          and rows_fb == {2: 2, 12: 2},
          "one render_fwd, render_bwd and tile_scatter_sum, two "
          "segment_sum_rows (F = 2 and 12) and no segment_sum launches per "
          "forward + backward step")
    check(all(bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0
              for v in g_a.values()),
          f"finite, non-zero gradients for {sorted(g_a)}")
    check(all(torch.equal(g_a[k], g_b[k]) for k in g_a),
          "two backward passes are bit-equal in every gradient")

    # small scenes: against autograd through the dense oracle, and the
    # card against the CPU path, at test_rasterize.py's gradient tolerance
    ocfg = RasterConfig(tile_h=8, tile_w=8, chunk=16, ref_depth_var=False)
    om, okw, ocam = small_scene(p=72, h=24, w=32, seed=13, sh_degree=1,
                                device=dev)
    g_ras = grads_of(ras.rasterize, om, ocam, ocfg, okw, wc)
    # the oracle's own path: its per-Gaussian sums are the one caller of
    # scatter_sum, and so of the segment_sum kernel
    render.reset_launches()
    g_or = grads_of(render_oracle, om, ocam, ocfg, okw, wc)
    torch.cuda.synchronize()
    counts_or = dict(render.launches)
    log(f"[main] the dense oracle's forward + backward, launches {counts_or}")
    check(counts_or["segment_sum"] == 1 and counts_or["render_fwd"] == 0,
          "one segment_sum launch (its per-Gaussian sums) and no render_fwd "
          "per oracle render")
    err_or, ratio_or = grads_close(g_ras, g_or, 5e-4, 2e-5)
    # the card against the CPU path in float64 (the float32 CPU path and
    # the card each carry their own float32 error, reported beside it)
    cm, ckw, ccam = small_scene(p=200, h=40, w=56, seed=13, sh_degree=1,
                                device="cpu")
    g_cpu = grads_of(ras.rasterize, cm, ccam, ocfg, ckw, wc.cpu())
    f64 = lambda v: v.double() if torch.is_tensor(v) \
        and v.is_floating_point() else v
    g_f64 = grads_of(ras.rasterize, cm.double(),
                     ccam.replace(viewmatrix=ccam.viewmatrix.double()), ocfg,
                     {k: f64(v) for k, v in ckw.items()}, wc.cpu().double())
    to_dev = lambda v: v.to(dev) if torch.is_tensor(v) else v
    g_gpu = grads_of(ras.rasterize, cm.to(dev),
                     ccam.replace(viewmatrix=ccam.viewmatrix.to(dev)), ocfg,
                     {k: to_dev(v) for k, v in ckw.items()}, wc)
    err_f64, ratio_f64 = grads_close(g_gpu, g_f64, 5e-4, 2e-5)
    err_cpu, ratio_cpu = grads_close(g_gpu, g_cpu, 5e-4, 2e-5)
    _, ratio_cpu64 = grads_close(g_cpu, g_f64, 5e-4, 2e-5)
    log(f"[small] gradients, per leaf the largest |error| / (2e-5 + 5e-4 "
        f"|reference|): card rasterize vs card render_oracle "
        f"{json.dumps(ratio_or)} (max_abs_err {err_or}); card vs CPU path "
        f"in float64 {json.dumps(ratio_f64)} (max_abs_err {err_f64}); CPU "
        f"path in float32 vs float64 {json.dumps(ratio_cpu64)}; card vs CPU "
        f"path in float32 {json.dumps(ratio_cpu)} (max_abs_err {err_cpu})")
    check(all(r <= 1 for r in ratio_or.values()), "the card's gradients match the dense "
                                       "oracle's autograd (rtol 5e-4, atol "
                                       "2e-5)")
    check(all(r <= 1 for r in ratio_f64.values()), "the card's gradients match the CPU "
                                        "path's in float64 (rtol 5e-4, atol "
                                        "2e-5)")

    # five mapping steps at bench_mapping.py's configuration: 500k
    # Gaussians, one keyframe whose target is the model's own render with
    # its colors moved, an instance budget of 1.1x the true count
    model = mapping_model(device=dev)
    mcfg = MappingConfig()
    with torch.no_grad():
        probe = render_model(model, cam, cfg)
    map_inst = int(-(-int(probe.num_rendered) * 1.1 // 1024) * 1024)
    map_cfg = cfg.replace(max_instances=map_inst)
    rgbs = torch.clamp(probe.color * 0.9 + 0.05, 0, 1)[None]
    depths = probe.depth[0][None]
    kf_views = cam.viewmatrix[None]
    # the kernels against their plain versions at this path's shapes: the
    # first step's render (its budget, ~5x the bench scene's instances per
    # tile), with seeded cotangents
    with torch.no_grad():
        _, mbinn, mfeat, mgt = ras.prepare(model.means3D, cam, cfg, map_inst,
                                           depths[0], **model.raster_kwargs())
        mapped = check_render_kernels(
            "500k", mfeat[mbinn.gauss_id].contiguous(), mbinn, mgt, core_kw,
            check, seed=1)
    del mfeat, mgt
    wts = torch.ones(1, device=dev)
    opt = make_map_optimizer(model, mcfg)
    dstate = DensifyState.zero(model.means3D.shape[0], device=dev)
    map_args = (kf_views, rgbs, depths, wts, map_cfg, mcfg, h, w, cam.tanfovx,
                cam.tanfovy, 1)
    render.reset_launches()
    losses = []
    for _ in range(5):
        loss, dstate, _ = map_step(model, opt, dstate, *map_args)
        losses.append(float(loss))
    counts_map, rows_map = dict(render.launches), dict(render.row_launches)
    log(f"[map] {int(probe.num_rendered)} instances (budget {map_inst}); "
        f"losses {losses}; launches {counts_map}, segment_sum_rows by row "
        f"width {rows_map}")
    check(all(counts_map[k] == 5 for k in ("render_fwd", "render_bwd",
                                           "tile_scatter_sum"))
          and counts_map["segment_sum"] == 0
          and counts_map["segment_sum_rows"] == 10
          and rows_map == {2: 5, 12: 5},
          "one render_fwd, render_bwd and tile_scatter_sum, two "
          "segment_sum_rows (F = 2 and 12) and no segment_sum launches per "
          "map_step")
    check(losses[-1] < losses[0], "the loss after five map steps is below "
                                  "step 0's")
    check(all(bool(torch.isfinite(getattr(model, f)).all())
              for f in PARAM_FIELDS) and float(dstate.denom.max()) == 5.0,
          "finite parameters and densify statistics after five map steps")
    # tracking: track_frame at bench_tracking.py's record configuration
    tracking_path(trk, dev, check)

    # ---- 4. times ------------------------------------------------------
    render_kw = dict(max_instances=max_inst, **kw)
    ms_fwd = time_ms(lambda: render.launch_render_fwd(
        table, binn.tile_start, binn.tile_stop, gt_tiles, out_f, out_i,
        **core_kw), iters=50)
    ms_plain = time_ms(lambda: render.core_fwd_reference(
        table, binn.tile_start, binn.tile_stop, gt_tiles, **core_kw),
        iters=3, warmup=1)
    bound_fwd, by_fwd, binfo = render_fwd_bound_ms(
        out_k, binn.tile_start, binn.tile_stop,
        render.pixel_coords(gt_tiles.shape[0], tiles_x, cfg.tile_h,
                            cfg.tile_w, h, w, dev)[2])
    seg_kernel = lambda: render.segment_sum(seg_vals, seg_ones, bounds)
    ms_seg, ms_seg_ev = device_ms(seg_kernel), time_ms(seg_kernel, iters=50)
    ms_seg_plain = time_ms(lambda: render.segment_sum_reference(
        seg_vals, seg_ones, bounds), iters=20)
    seg_ids = torch.repeat_interleave(
        torch.arange(table.shape[0], device=dev),
        (bounds[1:] - bounds[:-1]).to(torch.int64))
    lib_in = seg_vals[:seg_ids.shape[0]]
    seg_lib = lambda: torch.zeros(table.shape[0], device=dev).index_add_(
        0, seg_ids, lib_in)
    ms_seg_lib, ms_seg_lib_ev = device_ms(seg_lib), time_ms(seg_lib,
                                                            iters=50)
    n_vals, n_seg = seg_vals.shape[0], bounds.shape[0] - 1
    bound_seg = (n_vals * 8 + (n_seg + 1) * 4 + n_seg * 8) / PEAK_BYTES * 1e3
    with torch.no_grad():
        ms_ras = time_ms(lambda: ras.rasterize(means, cam, cfg, **render_kw),
                         iters=20)
        ms_front = time_ms(lambda: ras.prepare(
            means, cam, cfg, max_inst, kw["gt_depth"], **prep_kw), iters=20)
    log(f"[time] {card}: render_fwd kernel {ms_fwd:.4f} ms "
        f"(bound {bound_fwd:.4f} ms by {by_fwd}: {json.dumps(binfo)}), "
        f"plain version {ms_plain:.3f} ms")
    log(f"[time] {card}: segment_sum kernel {ms_seg:.4f} ms device time "
        f"({ms_seg_ev:.4f} ms by CUDA events) on {n_vals} values / {n_seg} "
        f"segments (bound {bound_seg:.4f} ms by bytes), plain "
        f"{ms_seg_plain:.4f} ms, index_add_ {ms_seg_lib:.4f} ms device time "
        f"({ms_seg_lib_ev:.4f} ms)")
    log(f"[time] {card}: whole forward rasterize {ms_ras:.3f} ms, "
        f"preprocess + binning {ms_front:.3f} ms")

    scatter_t = {"100k": tile_scatter_times("100k", bench, card),
                 "500k": tile_scatter_times("500k", mapped, card)}
    tile_scatter_worst_case(bench, card, check)
    bwd_t = {"100k": render_bwd_times("100k", bench, core_kw, card),
             "500k": render_bwd_times("500k", mapped, core_kw, card,
                                      plain_iters=1)}
    rows_t = {"100k": segment_sum_rows_times("100k", rows_k, binn, card),
              "500k": segment_sum_rows_times(
                  "500k", mapped["rows_k"], mapped["binn"], card),
              "f2": segment_sum_rows_times(
                  "100k, F = 2", bench["stats"], binn, card)}
    # the uncertainty sums of one render as rasterize takes them (the
    # two columns stacked, one segment_sum_rows) against the path it
    # replaced (a stable sort of the instances' Gaussian ids, a
    # searchsorted and a segment_sum): host and device together by CUDA
    # events, and device time
    keys = torch.where(binn.valid, binn.gauss_id,
                       torch.full_like(binn.gauss_id, -1))
    n_gauss = binn.gauss_start.shape[0]
    u_old = lambda: render.scatter_sum(keys, out_k.u_inst, out_k.npix_inst,
                                       n_gauss)
    u_new = lambda: rows_sum.segment_sum_rows(
        torch.stack([out_k.u_inst, out_k.npix_inst.to(torch.float32)], 1),
        binn.inv, binn.gauss_start, binn.gauss_stop)
    log(f"[time] {card}: uncertainty sums of one 100k render: "
        f"segment_sum_rows {time_ms(u_new, iters=50):.4f} ms by CUDA events "
        f"({device_ms(u_new):.4f} ms device time), the sorted scatter it "
        f"replaced {time_ms(u_old, iters=50):.4f} ms "
        f"({device_ms(u_old):.4f} ms device time)")
    fwd_bwd = lambda: grads_of(bench_render, means, cam, cfg, kw, wc)
    ms_fb = time_ms(fwd_bwd, iters=10)
    ms_map = time_ms(lambda: map_step(model, opt, dstate, *map_args),
                     iters=3, warmup=1)
    log(f"[time] {card}: whole forward + backward rasterize at 100k "
        f"{ms_fb:.3f} ms; map_step at 500k {ms_map:.3f} ms")

    with torch.no_grad():
        wall, busy, lines = profile_breakdown(
            lambda: ras.rasterize(means, cam, cfg, **render_kw))
    if busy > 0:
        log(f"[profile] {card}: forward rasterize {wall:.3f} ms host clock, "
            f"device busy {busy:.3f} ms ({busy / wall:.3f} of the window, "
            f"idle share {1 - busy / wall:.3f}); device time by kernel:")
        for line in lines:
            log(f"[profile]   {line}")
    else:
        log("[profile] torch.profiler saw no device time: not measured")
    wall, busy, lines = profile_breakdown(fwd_bwd)
    if busy > 0:
        log(f"[profile] {card}: forward + backward {wall:.3f} ms host clock, "
            f"device busy {busy:.3f} ms ({busy / wall:.3f} of the window, "
            f"idle share {1 - busy / wall:.3f}); device time by kernel:")
        for line in lines:
            log(f"[profile]   {line}")
    else:
        log("[profile] torch.profiler saw no device time: not measured")

    jvp_entries = tracking_times(trk, dev, card)

    # the largest errors over both scales' comparisons
    err_fwd, err_bwd, err_rows, err_u, err_ts = (
        max(bench[k], mapped[k])
        for k in ("err_fwd", "err_bwd", "err_rows", "err_u", "err_ts"))
    kernels = [
        dict(name="render_fwd", route="cuda",
             source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                    "render_fwd.cu",
             replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                      "render_pallas.py:157",
             launches=counts["render_fwd"], max_abs_err=err_fwd,
             ms=ms_fwd, plain_ms=ms_plain, bound_ms=bound_fwd,
             bound_by=by_fwd, library_ms=None),
    ] + [dict(name=name, route="cuda",
              source="diff_gaussian_rasterization_tpu_torch/ops/kernels/"
                     "csrc/render_fwd.cu",
              replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                       "render_pallas.py:390",
              launches=n, max_abs_err=err_ts, bound_by="bytes",
              **scatter_t[tag])
         # the renders of the forward; the map steps' renders
         for name, tag, n in (
             ("tile_scatter_sum", "100k", counts["tile_scatter_sum"]),
             ("tile_scatter_sum_500k", "500k",
              counts_map["tile_scatter_sum"]))
         ] + [
        # the dense oracle's per-Gaussian sums, on its own path
        dict(name="segment_sum", route="cuda",
             source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                    "render_fwd.cu",
             replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                      "render_pallas.py:390",
             launches=counts_or["segment_sum"], max_abs_err=err_seg,
             ms=ms_seg, plain_ms=ms_seg_plain, bound_ms=bound_seg,
             bound_by="bytes", library_ms=ms_seg_lib),
    ] + [dict(name=name, route="cuda",
              source="diff_gaussian_rasterization_tpu_torch/ops/kernels/"
                     "csrc/render_bwd.cu",
              replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                       "render_pallas.py:717",
              launches=n, max_abs_err=err_bwd, **bwd_t[tag])
         # the forward + backward steps; the map steps
         for name, tag, n in (
             ("render_bwd", "100k", counts_fb["render_bwd"]),
             ("render_bwd_500k", "500k", counts_map["render_bwd"]))
         ] + [dict(name=name, route="cuda",
              source="diff_gaussian_rasterization_tpu_torch/ops/kernels/"
                     "csrc/render_bwd.cu",
              replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                       "segment_sum.py:43",
              launches=n, max_abs_err=err, bound_by="bytes", **rows_t[tag])
         # each entry's launches are those of its row width on its path:
         # F = 12 in the forward + backward steps and the map steps, F = 2
         # in the renders of the forward
         for name, tag, n, err in (
             ("segment_sum_rows", "100k", rows_fb.get(12, 0), err_rows),
             ("segment_sum_rows_500k", "500k", rows_map.get(12, 0),
              err_rows),
             ("segment_sum_rows_f2", "f2", rows_fwd.get(2, 0), err_u))
         ] + jvp_entries
    log(json.dumps({"kernels": kernels}))
    if failures:
        log(f"FAILED: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
