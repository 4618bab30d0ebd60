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
   all started together) and print the compiler's register report, one
   line per kernel: registers, spills, stack, shared memory;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths, and print the largest errors: on the 100k
   bench scene, and on the 500k map step's render below, ``render_fwd``
   (two renders bit-equal; ``render_jvp``'s primal, light and full, with
   seeded six-column tangent tables, bit-equal to it; its pair-counting
   build changing no output bit) and the kernels after it;
   ``render_jvp`` (light and full) on the tracking frame's
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
   versions on the CPU; ``scatter_sum`` (the dense oracle's reduction: a
   stable sort by key, then ``segment_sum_rows``) on the forward's pixels
   keyed by midx, bit-equal to the CPU's;
3. drive the main paths through the entry points a user calls, each with
   every launch counter set to 0 just before and read just after: the
   forward (``rasterize`` with precomputed colors, ``render_model`` on an
   SH-3 model from four poses; finite outputs, no overflow, the instance
   count, one ``render_fwd``, ``tile_scatter_sum`` and
   ``segment_sum_rows`` (F = 2) launch per render,
   bit-equal repeat renders, the card against the CPU path on a small
   scene); forward + backward ``rasterize`` (one ``render_fwd``,
   ``render_bwd`` and ``tile_scatter_sum`` and two ``segment_sum_rows``
   launches, F = 2 and 12, per step, finite gradients for every leaf and
   the view matrix, bit-equal repeat backwards, the card's gradients
   against the port's dense ``render_oracle`` (whose own path launches
   ``segment_sum_rows`` once, its ``scatter_sum``) and against the CPU
   path in float64 on small scenes); five ``map_step``s at 500k, whose
   loss must fall; and ``track_frame`` at the record configuration, light
   and full variant (5 ``render_jvp``, ``tile_scatter_sum`` and
   ``segment_sum_rows`` and no ``render_fwd`` launch per tracked frame, no
   overflow in either level's frozen binning, pose error after below 1e-3,
   bit-equal repeats), the dual render's primal bit-equal to
   ``rasterize``'s, the reused binning against a fresh one, and the card's
   tracking costs against the CPU path's on a small scene;
4. time each kernel, its plain version, its bound and the one PyTorch call
   that computes the same function (``tile_scatter_sum`` at 100k and at
   the 500k map step's render against ``index_add_`` of the in-range
   pixels' ucross at their midx and against the sorted scatter it
   replaced, and, checked bit-equal to the CPU, in its worst case, every
   pixel naming its own instance; ``segment_sum_rows`` at 100k and at 500k
   with F = 12 and at 100k with F = 2, by device time from
   torch.profiler, since their launch from Python outlasts them; the
   uncertainty sums against the sorted scatter they replaced;
   ``render_fwd`` at 100k and at 500k, with the pairs it tests;
   ``render_bwd`` at 100k and at 500k, stopped at ``n_contrib`` and
   walking the whole segment, with the pairs it tests; ``render_jvp`` also
   with the pairs its culled walk tests), the whole forward, forward +
   backward, a mapping step, a dual render and a tracked frame, with CUDA
   events, and list the device time of the forward, of forward + backward
   and of a tracked frame by kernel with torch.profiler;
5. the SLAM runner (``models/runner.py``): ``init_slam`` and two
   ``slam_step``s on the card and on the CPU path on a small world where
   tracking moves each pose (the same keyframes and active masks, poses
   within 1e-4, costs within rtol 1e-3, the map's fields within
   ``tests/test_torch_runner.py``'s Adam-step tolerance); then
   ``run_slam`` at ``examples/bench_ate.py``'s record configuration
   (240x320, the Replica-class room at wall resolution 56, sensor noise)
   on the first 24 of its 120 frames (finite poses, ATE below
   SLAM_ATE_MAX_CM and below half the no-tracking ATE, active Gaussians
   left, no runner render over its budget, every kernel of the path
   launched), timed by frame, tracked frame, mapping round and refinement
   (CUDA events, read after the run); the path's kernels against their
   plain versions at its own shapes (8x16 tiles, chunk 32, the run's
   instance budget): ``render_fwd``, ``render_bwd``, ``tile_scatter_sum``
   and ``segment_sum_rows`` (F = 12 and 2) on each keyframe of the last
   mapping window, ``render_jvp`` on the last frame's dual render at both
   pyramid levels; and three more frames, one a keyframe with its mapping
   round, profiled for launches, device busy time and idle share a frame,
   and three more for the host's synchronizing calls a frame (CUDA sync
   debug mode);
6. the reference-style API (``GaussianRasterizer``), the way CG-SLAM calls
   it: at the bench scene (100k, 1200x680, 32x32 tiles), leaves that
   require grad (a zero ``means2D`` [P, 3] and the view matrix among them)
   and phase 3's loss, with ``alpha_grad`` on and off: ``rasterize``'s
   launches per forward + backward (one ``render_fwd``,
   ``tile_scatter_sum`` and ``render_bwd``, two ``segment_sum_rows``),
   finite outputs, no overflow, every output and
   gradient bit-equal to ``rasterize``'s in the same call (without the
   silhouette's term when ``alpha_grad`` is off), a zero third column of
   ``means2D.grad``; the full variant's 4-tuple, silhouette and pose
   gradient bit-equal to ``rasterize(cfg.full_variant())``'s;
   ``track_off`` / ``map_off`` gating the pose / the Gaussians; the host's
   waits (CUDA sync debug mode) in a forward and a forward + backward no
   more than ``rasterize``'s, and both timed beside ``rasterize`` in turns
   (CUDA events, 6 samples of 10 calls each); five CG-SLAM-style Adam
   steps on the 500k mapping model (``track_off``, RGB-D L1 loss,
   ``loss.backward()``), whose loss must fall, with ``rasterize``'s
   launches each step; and the
   three examples in-process: ``render_ply`` on a PLY of phase 3's SH-3
   model (two views at 1200x680, the PNGs equal to the quantized
   ``render_model`` images), ``fit_scene`` for 20 iterations (the loss
   falls), ``run_slam`` on 6 frames (ATE below the static-pose
   baseline's), each launching its kernels;
7. the parallel layer (``parallel/``): MESH_RANKS ranks spawned with
   ``parallel.mesh.spawn`` on a gloo world, all on cuda:0 (NCCL takes one
   rank a card), each checking: the tile-sharded ``rasterize`` at the
   bench scene (tile=2), forward and backward, every output and gradient
   bit-equal to the unsharded render on the same card, and with
   ``shard_binning`` within the bench-scale row rule, the same instance
   count and no overflow; its band's ``render_fwd`` and ``render_bwd`` at
   its ``tile0`` against their plain versions; the tile-sharded
   ``rasterize_with_pose_jvp`` (light, K = 6) at the tracking frame
   bit-equal to the unsharded, and ``render_jvp`` at its ``tile0``
   against its plain version; one ``map_step`` at 500k over two
   keyframes, keyframe-sharded (kf=2) and map-sharded (map=2, a budget of
   half the capacity), against the one-device step (the loss, the
   gradients, the parameters where the gradient is live); and
   ``run_slam`` at the record configuration on kf=2 for MESH_SLAM_FRAMES
   frames (a mapping round a keyframe, a refinement at the end) against
   the one-device run of the same frames (poses within 5e-3, ATE within
   2e-3 m, the same keyframes; both frames/s printed); every rank ending
   bit-identical, every path's kernels launched on every rank, and the
   forward + backward times (unsharded, tile-sharded, and the collectives
   inside it, CUDA events); then a one-rank NCCL world's tile-sharded
   bench render bit-equal to the unsharded.  Two ranks share one card
   and gloo stages through the host: no speedup is expected;
8. the splat exponent's basis form (``RasterConfig.splat_basis_power``):
   ``render_fwd`` and ``render_bwd``'s basis instantiations against their
   plain versions and timed in turns with the direct ones, and the render
   op and a ``map_step`` with the flag;
9. the benchmark drivers (``examples/bench.py``, ``bench_tracking.py``,
   ``bench_mapping.py``), each run as a user runs it (``python -m``, a
   process of its own) at its defaults, the JAX drivers' record
   configurations, and ``bench --ranks 2 --backend gloo`` on the one
   card: exit code 0, exactly one JSON line with the JAX driver's metric
   and unit, a finite positive value, the samples' spread, the card's name
   and power limit (in watts), the driver's guard (no overflow and finite
   gradients; the pose error falls, below 1e-3; the loss falls) and phase
   3's kernel launches a step; each line echoed, its mean and median
   printed beside this script's own time of the same configuration;
10. the profiling tools (``examples/prof*.py``), each run as a user runs
   it (``python -m``, a process of its own) on the bench scene at full
   width, cut to a few steps: exit code 0, JSON lines only on stdout,
   each with the card's name and power limit; ``prof``'s five stages,
   ``prof_bin``'s seven and ``prof_jvp``'s three with finite positive host
   and device times; ``prof_bin``'s last stage bit-equal to
   ``bin_gaussians`` + the gather here on the card; ``prof_trace``'s table
   naming ``render_fwd``, ``tile_scatter_sum``, ``render_bwd`` and
   ``segment_sum_rows`` (F = 2 and 12) with phase 3's launches a step;
   ``prof_jvp``'s dual renders one ``render_jvp`` launch a step;
   ``prof_track``'s table; ``prof_ab`` on ``tile_h=16 tile_w=16``, and its
   refusal of a TPU-only field;
11. the preprocess kernel pair (``preprocess_fwd``, ``preprocess_bwd``)
   against the composite ``ops/projection.py::preprocess`` on the card at
   the mapping cell's 500k room and its first 120,000 slots (the table,
   the integer footprint, the gradients of a map step's leaves and of the
   view), its device times beside its bounds, the plain versions' and the
   composite's autograd backward's, and its launches in a 4-keyframe map
   step and a tracked frame (phase 5 prints them a SLAM frame);
12. the pose tangents' kernel (``preprocess_tangents``) at the 500k room
   and the tum cells' 27k room, K = 6, light, full and SH-3 colour:
   against the composite's forward mode in float64 (each column within
   twice the float32 composite's error), bit-equal repeats, its device
   times beside its byte bound and the composite pass it replaces, in
   turns, its ``ptxas`` lines, and one launch a dual render of the record
   tracked frame (as many as ``render_jvp``'s);
13. tracking's Gauss-Newton kernels (``twist_tangents``, ``gn_reduce``)
   on the record tracking frame's dual render at 1200x680 and at the tum
   cells' 640x480: against their plain versions (``gn_reduce`` full and
   cost only, rtol 1e-5; ``twist_tangents`` against ``jacfwd`` in
   float64), bit-equal repeats, device times by CUDA events over 100
   calls queued behind a sleep, in turns with the plain path (what the
   tracker ran before: ``gn_reduce_reference``; ``apply_twist`` and
   ``torch.func.jacfwd``) and the host's time a call, the byte bound,
   their ``ptxas`` lines, and their launches a record tracked frame.

Prints the card's name and power limit, a ``kernels`` JSON line, a
``slam`` JSON line, a ``mesh`` JSON line, a ``drivers`` JSON line, a
``prof`` JSON line, and last the line ``{"ok": true, "device":
{...}}``.
Exits non-zero, without that line, when there is no CUDA device or any
phase fails.
"""

import json
import subprocess
import sys
import time

import numpy as np

from diff_gaussian_rasterization_tpu_torch.utils.profiling import (
    device_events, device_us, host_syncs, profile_breakdown)

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
# dweight (1), ~20, or ~29 with the full variant's conic terms, ~35 with
# the colour branch's three fused multiply-adds besides.
OPS_PER_CONTRIB_JVP = 16
OPS_PER_TANGENT = {3: 20, 6: 29, 9: 35}
# The SH bands 1-3 of the tracking frame's colour-branch variant, drawn a
# Gaussian each with the replica-full-sh3 configuration's deviation.  That
# configuration draws one set a surface of its room; the tracking frame is
# a random cloud with no surfaces, where the colour branch stays near 1% of
# the colour tangents at any draw.  So check_jvp_kernel shows, besides,
# that the kernel's colour term stands well above the check's tolerance.
SH_REST_STD = 0.25
# ... by at least this factor: the colour term's largest part of the
# colour tangents over the comparison's atol on that stream.
COLOR_SEEN = 10.0
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


def register_report(text):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name and
    template arguments, registers, spills, stack and shared memory."""
    import re
    lines, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z_]+_kernel)((?:I|L[ib]-?\d+E)*)", line)
            name = m.group(1) if m else line.split("'")[1]
            args = re.findall(r"L([ib])(-?\d+)E", m.group(2) if m else "")
            if args:
                name += "<" + ", ".join(
                    v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in args) + ">"
        elif name and "spill" in line:
            spill = line.split(":")[-1].strip()
        elif name and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}; "
                         f"{spill}")
            name, spill = None, ""
    return lines


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
    return sum(device_us(e) for e in device_events(prof)) / 1e3 / iters


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


def render_fwd_bound_ms(out, tile_start, tile_stop, pixmask,
                        ops_per_pair=OPS_PER_PAIR, ops_per_pixel=0):
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
    ops = (contribs * (ops_per_pair + OPS_PER_CONTRIB)
           + ops_per_pixel * int(pixmask.sum()))
    t, q = out.depth.shape
    n_inst = int(seg.sum())
    nbytes = n_inst * 11 * 4 + t * 2 * 4 + t * q * 4 + t * q * 12 * 4
    ms_ops, ms_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    info = dict(pairs=pairs, contributions=contribs, ops=ops, bytes=nbytes)
    if ms_ops >= ms_bytes:
        return ms_ops, "operations", info
    return ms_bytes, "bytes", info


def render_bwd_bound_ms(contribs, n_inst, n_tiles, q,
                        ops_per_pair=OPS_PER_PAIR,
                        ops_per_contrib=OPS_PER_CONTRIB_BWD, pixel_ops=0):
    """The backward's least time: the pair test and the backward's
    operations per contribution (plus ``pixel_ops`` in all, made once a
    pixel) over the FP32 peak; the bytes (features, ranges, the per-pixel
    constants, the rows written) over HBM."""
    ops = contribs * (ops_per_pair + ops_per_contrib) + pixel_ops
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
    again = render.core_fwd(table, start, stop, gt_tiles, **core_kw)
    out_p = render.core_fwd_reference(table, start, stop, gt_tiles,
                                      **core_kw)
    torch.cuda.synchronize()
    err_fwd, rep, ok = compare_core(out_k, out_p)
    log(f"[kernel] {tag}: render_fwd vs plain: " + json.dumps(rep))
    check(ok, f"{tag}: render_fwd matches its plain version (rtol 1e-4, "
              "atol 2e-5 on agreeing pixels; integer mismatch < 5e-3)")
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          f"{tag}: two render_fwd core renders are bit-equal")
    # render_jvp's primal on the same table, with seeded tangent tables of
    # the twist basis's width (K = 6), light and full: the two kernels cull
    # differently but take the same contributing pairs in the same order
    gen = torch.Generator(device=dev).manual_seed(seed)
    for full in (False, True):
        tans = torch.randn(table.shape[0], (6 if full else 3) * 6,
                           generator=gen, device=dev)
        primal, _ = render.core_fwd_jvp(table, tans, start, stop, gt_tiles,
                                        **core_kw, full=full)
        torch.cuda.synchronize()
        check(all(torch.equal(getattr(primal, f), getattr(out_k, f))
                  for f in out_k._fields),
              f"{tag}: render_jvp's primal ({'full' if full else 'light'}) "
              "is bit-equal to render_fwd's")
        del tans, primal

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
    # the counter build: the (instance, pixel) pairs render_fwd tests, and
    # not one output bit changed by counting them
    cnt_f, cnt_i = torch.empty_like(out_f), torch.empty_like(out_i)
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    render.launch_render_fwd(table, start, stop, gt_tiles, cnt_f, cnt_i,
                             **core_kw, pairs=pairs)
    torch.cuda.synchronize()
    check(torch.equal(cnt_f, out_f) and torch.equal(cnt_i, out_i),
          f"{tag}: render_fwd's counter build changes no output bit")
    del cnt_f, cnt_i
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
                fwd_pairs=int(pairs), err_fwd=err_fwd, err_bwd=err_bwd,
                err_rows=err_rows, err_u=err_u, err_ts=err_ts)


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
    searchsorted and a ``segment_sum_rows`` over the sorted runs)."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        segment_sum as rows_sum)
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
    old = lambda: rows_sum.scatter_sum(midx.reshape(-1), ucross.reshape(-1),
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
        f"sorted scatter it replaced (sort, searchsorted, "
        f"segment_sum_rows) "
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


def render_fwd_times(tag, st, core_kw, card, plain_iters=3):
    """``render_fwd`` at one render's shapes, as the main path launches it,
    by CUDA events; its plain version; its bound; the (instance, pixel)
    pairs the pixels' segments hold up to their termination (a walk without
    culling), the pairs the kernel tests (its counter build, in phase 2)
    and the contributions."""
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    table, binn, out_k = st["table"], st["binn"], st["out_k"]
    gt_tiles, out_f, out_i = st["gt_tiles"], st["out_f"], st["out_i"]
    start, stop = binn.tile_start, binn.tile_stop
    n_tiles = gt_tiles.shape[0]
    ms = time_ms(lambda: render.launch_render_fwd(
        table, start, stop, gt_tiles, out_f, out_i, **core_kw), iters=50)
    ms_plain = time_ms(lambda: render.core_fwd_reference(
        table, start, stop, gt_tiles, **core_kw), iters=plain_iters,
        warmup=1)
    pixmask = render.pixel_coords(n_tiles, core_kw["tiles_x"],
                                  core_kw["cfg"].tile_h,
                                  core_kw["cfg"].tile_w, core_kw["height"],
                                  core_kw["width"], table.device)[2]
    bound, by, info = render_fwd_bound_ms(out_k, start, stop, pixmask)
    log(f"[time] {card}: render_fwd ({tag}) kernel {ms:.4f} ms (bound "
        f"{bound:.4f} ms by {by}: {json.dumps(info)}), plain version "
        f"{ms_plain:.3f} ms; pairs tested {st['fwd_pairs']} of "
        f"{info['pairs']} walked, for {info['contributions']} "
        "contributions")
    return dict(ms=ms, plain_ms=ms_plain, bound_ms=bound, bound_by=by,
                library_ms=None)


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
                     check, color=False, color_seen=False):
    """``render_jvp`` against its plain version (and the plain version in
    float64) on one dual render's sorted tables, and its primal against
    ``render_fwd`` on the same table; with ``color_seen``, that the colour
    term moves the colour tangents well above the comparison's tolerance
    (a rotation about the camera centre has no colour term, so only a set
    of directions with translations shows it).  Returns the largest error
    and the kernel's outputs."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    start, stop = binn.tile_start, binn.tile_stop
    kw = dict(core_kw, full=full, color=color)
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
    if color_seen:
        # the colour term's part of the colour tangents: the kernel again
        # with the colour columns zeroed
        bare = tans.reshape(tans.shape[0], -1, 9).clone()
        bare[..., 6:] = 0
        _, tan_0 = render.core_fwd_jvp(table, bare.reshape(tans.shape),
                                       start, stop, gt_tiles, **kw)
        part = float((tan_k.color - tan_0.color)[tile_ok].abs().max())
        atol = JVP_ATOL + COL_EPS * float(tan_p.color[tile_ok].abs().max())
        log(f"[kernel] {tag}: the colour term's largest part of the colour "
            f"tangents {part}, {part / atol:.1f}x the check's atol {atol}")
        check(part > COLOR_SEEN * atol,
              f"{tag}: the colour term stands {COLOR_SEEN}x above the "
              "colour tangents' atol")
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
    """Phase 2 for the tracking path: ``render_jvp`` (light, full, and
    full with the SH colour branch: the tracking frame's map given SH bands
    1-3 of ``SH_REST_STD``, and its frame rendered from that map) against
    its plain version on the full-resolution dual render of the tracking
    frame, at the identity pose with the record configuration's frozen
    binning and the 6 twist tangents, and with K = 1, 2, 3, 4, 5, 8 and 10
    of them; and the kernel's culling boxes against their mirror."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        GaussianModel)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        Frame, frozen_budget, render_model)
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
    gen = torch.Generator(device=dev).manual_seed(3)
    m = ts.model
    rest = SH_REST_STD * torch.randn((m.sh.shape[0], 15, 3), generator=gen,
                                     device=dev)
    model3 = GaussianModel(*(getattr(m, k).detach() for k in (
        "means3D", "scales_log", "rotations", "opacities_logit")),
        torch.cat([m.sh.detach(), rest], 1), m.active)
    with torch.no_grad():
        kwm3 = model3.raster_kwargs()
        gt3 = render_model(model3, ts.camera, ts.cfg)
    frame3 = Frame(gt3.color, gt3.depth[0])
    variants = {}
    for variant, vcfg, model, frame in (
            ("light", ts.cfg, m, ts.frame),
            ("full", ts.cfg.full_variant(), m, ts.frame),
            ("full_sh3", ts.cfg.full_variant(), model3, frame3)):
        full = variant != "light"
        vkw = kwm if model is m else kwm3
        color = ras.color_branch(vcfg, **vkw)
        with torch.no_grad():
            _, _, table, tans, gt_tiles = ras.pose_jvp_tables(
                means, ts.camera, vcfg, tw, None, frame.depth, binn=binn,
                **vkw)
        res = check_jvp_kernel(f"tracking {variant}", table, tans, binn,
                               gt_tiles, core_kw, full, check, color=color,
                               color_seen=color)
        variants[variant] = dict(res, cfg=vcfg, table=table, tans=tans,
                                 gt_tiles=gt_tiles, color=color,
                                 model=model, frame=frame)
        # other K on the same frame: tangent tables of subsets and repeats
        # of the twist directions (K = 8 and 10 take two launches, the
        # second of 2 and of 4 columns)
        per_k = render.tangent_columns(full, color)
        by_k = tans.reshape(tans.shape[0], 6, per_k)
        for pick in ([5], [0, 1], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3, 4],
                     [0, 1, 2, 3, 4, 5, 0, 3],
                     [0, 1, 2, 3, 4, 5, 0, 1, 2, 3]):
            sub = by_k[:, pick].reshape(tans.shape[0], -1).contiguous()
            check_jvp_kernel(f"tracking {variant} K={len(pick)}", table, sub,
                             binn, gt_tiles, core_kw, full, check,
                             color=color)
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
    configuration, light, full, and full on the SH-3 map of phase 2 with
    its frame (the colour branch), with the launch counts of one tracked
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
    want = dict(render_fwd=0, tile_scatter_sum=n_dual, render_bwd=0,
                segment_sum_rows=n_dual, render_jvp=n_dual)
    st["counts"], st["pose_err"] = {}, {}
    for variant in ("light", "full", "full_sh3"):
        v = st["variants"][variant]
        vcfg, model, frame = v["cfg"], v["model"], v["frame"]
        binns = []
        render.reset_launches()
        v1, c1, cs1 = track_frame(model, ts.view0, frame, vcfg, ts.tcfg,
                                  ts.camera, binnings=binns)
        torch.cuda.synchronize()
        counts, rows = dict(render.launches), dict(render.row_launches)
        v2, _, _ = track_frame(model, ts.view0, frame, vcfg, ts.tcfg,
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
    """Phase 4 for the tracking path: the ``render_jvp`` kernel (light,
    full and full with the colour branch) with its plain version and
    bound, one dual render, ms per tracked frame over 5 frames, and a
    profile of one tracked frame.  Returns the ``kernels`` line's three
    entries."""
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
    for variant in ("light", "full", "full_sh3"):
        v = st["variants"][variant]
        full, color = variant != "light", v["color"]
        per_k = render.tangent_columns(full, color)
        table, tans, gt_tiles = v["table"], v["tans"], v["gt_tiles"]
        k_t = tans.shape[1] // per_k
        out_f = torch.empty((n_tiles, 9, q), device=dev)
        out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
        out_t = torch.empty((n_tiles, k_t, 6, q), device=dev)
        ms = time_ms(lambda: render.launch_render_jvp(
            table, tans, start, stop, gt_tiles, out_f, out_i, out_t,
            full=full, color=color, **core_kw), iters=20)
        ms_plain = time_ms(lambda: render.core_fwd_jvp_reference(
            table, tans, start, stop, gt_tiles, full=full, color=color,
            **core_kw), iters=2, warmup=1)
        _, _, finfo = render_fwd_bound_ms(v["out_k"], start, stop, pixmask)
        n_seg = int((stop - start).sum())
        bound, by, binfo = render_jvp_bound_ms(
            finfo["contributions"], n_seg, n_tiles, q, k_t, per_k)
        # the pairs the culled walk tests, against the pairs each pixel's
        # segment holds up to its termination and the contributions (the
        # bound's count)
        tested = torch.zeros(1, dtype=torch.int64, device=dev)
        render.launch_render_jvp(table, tans, start, stop, gt_tiles, out_f,
                                 out_i, out_t, full=full, color=color,
                                 pairs=tested, **core_kw)
        log(f"[time] {card}: render_jvp ({variant}, K={k_t}, "
            f"PER_K={per_k}) kernel {ms:.4f} ms (bound {bound:.4f} ms by "
            f"{by}: "
            f"{json.dumps(dict(finfo, **binfo))}), plain version "
            f"{ms_plain:.3f} ms; pairs tested {int(tested)} of "
            f"{finfo['pairs']} walked, for {finfo['contributions']} "
            "contributions")
        entries.append(dict(
            name={"light": "render_jvp", "full": "render_jvp_full",
                  "full_sh3": "render_jvp_full_sh3"}[variant],
            route="cuda",
            source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                   "render_jvp.cu",
            replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                     "render_pallas.py:440",
            launches=st["counts"][variant]["render_jvp"],
            max_abs_err=v["err"],
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
    st["ms_track"] = ms_track
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


# The SLAM phase: the small world of the card-vs-CPU check
# (tests/test_torch_slam_e2e.py::test_run_slam_tracks_orbit's room, orbit
# and tracking iterations, cut to 24x32 and 3 frames and to fewer mapping
# steps for the CPU path's time), and the record configuration's run, cut
# in depth from 120 frames to SLAM_FRAMES.
SLAM_SMALL = dict(h=24, w=32, n=768, seed=0, orbit=9, frames=3,
                  track_iters=10, map_iters=5, init_iters=20)
SLAM_FRAMES = 24
SLAM_POSE_ATOL = 1e-4   # tests/test_torch_tracking.py's pose tolerance
SLAM_COST_RTOL = 1e-3   # tests/test_torch_runner.py's loss tolerance
# tests/test_torch_runner.py::assert_models: every float field within
# SLAM_FIELD_ATOL + (Adam steps) x lr / 10, rtol 1e-5
SLAM_FIELD_ATOL = 1e-5
# the 24-frame run's unaligned ATE was 0.808 cm on the H100; a wrong kernel
# at the run's shapes moves it by far more than the rounding of a change
SLAM_ATE_MAX_CM = 2.0
# the CUDA functions of the port's kernels, as the profiler names them
SLAM_KERNEL_FNS = ("render_fwd_kernel", "tile_scatter_sum_kernel",
                   "segment_sum_kernel", "render_bwd_kernel",
                   "segment_sum_rows_kernel", "segment_sum_rows_any_kernel",
                   "render_jvp_kernel", "preprocess_fwd_kernel",
                   "preprocess_bwd_kernel", "preprocess_view_kernel")


class _Recorder:
    """Wraps the runner's ``render_model``, ``track_frame``,
    ``mapping_round`` and ``refine_keyframes`` for one block, adding no
    wait on the card: the overflow flag (a device tensor) of every render
    the runner makes itself, and a pair of CUDA events around every tracked
    frame (the refinement's re-tracks apart), mapping round and refinement.
    The runner waits on the card within each frame, so an event pair spans
    the stage's host time too.  Read the flags and times after the
    block."""

    def __init__(self, runner):
        self.runner, self.saved = runner, {}
        self.flags, self.events = [], {}
        self.refining = False

    def _timed(self, name, key):
        import torch
        fn = self.saved[name]

        def wrapped(*a, **k):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*a, **k)
            t1.record()
            self.events.setdefault(key(), []).append((t0, t1))
            return out
        return wrapped

    def __enter__(self):
        r = self.runner
        names = ("render_model", "track_frame", "mapping_round",
                 "refine_keyframes")
        self.saved = {n: getattr(r, n) for n in names}

        def render(*a, **k):
            out = self.saved["render_model"](*a, **k)
            self.flags.append(out.overflow)
            return out

        refine = self._timed("refine_keyframes", lambda: "refine")

        def refine_flagged(*a, **k):
            self.refining = True
            try:
                return refine(*a, **k)
            finally:
                self.refining = False
        r.render_model = render
        r.track_frame = self._timed(
            "track_frame", lambda: "retrack" if self.refining else "track")
        r.mapping_round = self._timed("mapping_round", lambda: "map")
        r.refine_keyframes = refine_flagged
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.runner, k, v)

    def ms(self, key):
        """The milliseconds of each call of one stage (after a sync)."""
        return [a.elapsed_time(b) for a, b in self.events.get(key, [])]

    def overflowed(self):
        """How many of the recorded renders overflowed their budget."""
        import torch
        return int(torch.stack([torch.as_tensor(f).reshape(())
                                for f in self.flags]).sum())


def slam_small(dev, check):
    """Phase 5a: ``init_slam`` and two ``slam_step``s on the card and on the
    CPU path, on the same small world (rendered on the CPU, its frames
    moved to the card): the same keyframes and active masks, each pose
    moved by tracking and within SLAM_POSE_ATOL of the CPU path's, the
    costs within SLAM_COST_RTOL and the map's fields within
    ``tests/test_torch_runner.py``'s Adam-step tolerance."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.io.synthetic import (
        orbit_trajectory, random_room_model, render_sequence)
    from diff_gaussian_rasterization_tpu_torch.models import runner
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        PARAM_FIELDS)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        Frame, MappingConfig, TrackingConfig)
    sw = SLAM_SMALL
    cfg = RasterConfig(tile_h=8, tile_w=8, chunk=16, instance_multiplier=12)
    mcfg = MappingConfig(iters=sw["map_iters"])
    scfg = runner.SLAMConfig(
        raster=cfg, tracking=TrackingConfig(iters=sw["track_iters"],
                                            sil_threshold=0.5),
        mapping=mcfg, capacity=4096, keyframe_every=2, map_every=2,
        window=2, seed_every_px=2, init_iters=sw["init_iters"],
        motion_model=False)
    cam = lambda d: Camera(viewmatrix=torch.eye(4, device=d), tanfovx=0.7,
                           tanfovy=0.55, height=sw["h"], width=sw["w"])
    gt = random_room_model(capacity=sw["n"], n=sw["n"], seed=sw["seed"],
                           device="cpu")
    views = orbit_trajectory(sw["orbit"], device="cpu")[:sw["frames"]]
    frames = render_sequence(gt, views, cam("cpu"), cfg)
    runs = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        fr = [Frame(f.rgb.to(d), f.depth.to(d)) for f in frames]
        st = runner.init_slam(views[0].to(d), fr[0], cam(d), scfg)
        active, costs, moved = [st.model.active.cpu().clone()], [], []
        for i in range(1, sw["frames"]):
            start = st.est_views[-1].cpu().clone()
            st, c = runner.slam_step(st, fr[i], cam(d), scfg, i)
            moved.append(float((st.est_views[-1].cpu() - start).abs().max()))
            active.append(st.model.active.cpu().clone())
            costs.append(c)
        runs[name] = (st, active, costs, moved)
    (sc, ac, cc, mc), (sg, ag, cg, mg) = runs["cpu"], runs["card"]
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(sg.est_views, sc.est_views))
    # Adam steps: the bootstrap's, then a round at each mapped frame
    steps = sw["init_iters"] + mcfg.iters * (len(sg.kf_idx) - 1)
    lrs = dict(means3D=mcfg.lr_means, scales_log=mcfg.lr_scales,
               rotations=mcfg.lr_rotations, opacities_logit=mcfg.lr_opacities,
               sh=mcfg.lr_sh)
    fields_ok, field_err = True, {}
    for f in PARAM_FIELDS:
        a = getattr(sg.model, f).detach().cpu()
        b = getattr(sc.model, f).detach()
        atol = SLAM_FIELD_ATOL + steps * lrs[f] / 10
        field_err[f] = float((a - b).abs().max())
        fields_ok &= bool(torch.allclose(a, b, rtol=1e-5, atol=atol))
    finite = all(bool(torch.isfinite(v).all()) for v in sg.est_views) \
        and all(bool(torch.isfinite(getattr(sg.model, f)).all())
                for f in PARAM_FIELDS) \
        and all(np.isfinite(cg))
    log(f"[slam] small world {sw}: keyframes card {sg.kf_idx}, CPU "
        f"{sc.kf_idx}; active card {[int(a.sum()) for a in ag]}, CPU "
        f"{[int(a.sum()) for a in ac]}; costs card {cg}, CPU {cc}; poses "
        f"moved by tracking card {mg}, CPU {mc}; largest pose difference "
        f"{err}; largest field differences after {steps} Adam steps "
        f"{json.dumps(field_err)}")
    check(sg.kf_idx == sc.kf_idx
          and all(torch.equal(a, b) for a, b in zip(ag, ac)),
          "slam: the card and the CPU path take the same keyframes and keep "
          "the same active masks on the small world")
    check(min(mg) > 10 * SLAM_POSE_ATOL,
          f"slam: tracking moves each pose on the card by more than "
          f"{10 * SLAM_POSE_ATOL}")
    check(err <= SLAM_POSE_ATOL,
          f"slam: the card's poses within {SLAM_POSE_ATOL} of the CPU "
          "path's on the small world")
    check(np.allclose(cg, cc, rtol=SLAM_COST_RTOL, atol=0),
          f"slam: the card's tracking costs within rtol {SLAM_COST_RTOL} of "
          "the CPU path's")
    check(fields_ok, f"slam: the card's map within atol {SLAM_FIELD_ATOL} + "
                     f"{steps} x lr / 10, rtol 1e-5, of the CPU path's")
    check(finite, "slam: finite poses, map and costs on the card")


def slam_kernels(state, scfg, cam_t, frame, check):
    """The path's kernels against their plain versions at the record run's
    own shapes, on its final map at ``state.raster`` (8x16 tiles, chunk 32,
    the run's instance budget): ``render_fwd``, ``render_bwd``,
    ``tile_scatter_sum`` and ``segment_sum_rows`` (F = 12 and 2) on each
    keyframe of the last mapping window, as ``map_step`` renders it; and
    ``render_jvp`` on the dual render of ``frame`` at the last estimated
    pose, at each pyramid level tracking runs.  Returns the largest errors
    by kernel."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models import runner
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        downsample_frame)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    rcfg, model = state.raster, state.model
    means = model.means3D.detach()
    with torch.no_grad():
        kwm = {k: (v.detach() if torch.is_tensor(v) else v)
               for k, v in model.raster_kwargs().items()}
    errs = dict(err_fwd=0.0, err_bwd=0.0, err_rows=0.0, err_u=0.0,
                err_ts=0.0, err_jvp=0.0)
    window = runner._select_window(state, scfg, state.kf_idx[-1])
    h, w = cam_t.height, cam_t.width
    core_kw = dict(cfg=rcfg, tiles_x=-(-w // rcfg.tile_w), height=h, width=w)
    with torch.no_grad():
        for j, i in enumerate(window):
            cam = cam_t.replace(viewmatrix=state.kf_views[i])
            _, binn, feat, gt_tiles = ras.prepare(
                means, cam, rcfg, rcfg.max_instances,
                state.kf_frames[i].depth, **kwm)
            log(f"[slam] keyframe {state.kf_idx[i]}: "
                f"{int(binn.num_rendered)} instances of a budget of "
                f"{rcfg.max_instances}, {gt_tiles.shape[0]} tiles of "
                f"{rcfg.tile_h}x{rcfg.tile_w}")
            res = check_render_kernels(
                f"slam keyframe {state.kf_idx[i]}",
                feat[binn.gauss_id].contiguous(), binn, gt_tiles, core_kw,
                check, seed=j)
            for k in ("err_fwd", "err_bwd", "err_rows", "err_u", "err_ts"):
                errs[k] = max(errs[k], res[k])
        view = state.est_views[-1]
        tw = twist_basis(view)
        levels = [2 ** lvl for lvl in range(scfg.tracking.pyramid - 1, 0, -1)
                  if not (h % 2 ** lvl or w % 2 ** lvl)] + [1]
        for s in levels:
            fl = frame if s == 1 else downsample_frame(frame, s)
            cam = cam_t.replace(viewmatrix=view, height=h // s, width=w // s)
            _, binn, table, tans, gt_tiles = ras.pose_jvp_tables(
                means, cam, rcfg, tw, None, fl.depth, **kwm)
            kw = dict(core_kw, tiles_x=-(-(w // s) // rcfg.tile_w),
                      height=h // s, width=w // s)
            res = check_jvp_kernel(
                f"slam tracking {w // s}x{h // s}", table, tans, binn,
                gt_tiles, kw, bool(rcfg.pose_cov2d_branch), check)
            errs["err_jvp"] = max(errs["err_jvp"], res["err"])
    return errs


def slam_record(dev, check, card):
    """Phase 5b: ``run_slam`` at ``examples/bench_ate.py``'s record
    configuration (240x320, ``replica_like_model(seed=0, wall_res=56)``,
    ``walkthrough_trajectory(120, seed=1)``, sensor noise), on its first
    SLAM_FRAMES frames, with every launch counted; then three more frames
    (one keyframe with its mapping round) profiled for launches and device
    time per frame, and three more counted for the host's waits on the
    card.  Returns the largest errors of ``slam_kernels`` and the ``slam``
    line's object."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diff_gaussian_rasterization_tpu_torch.examples import bench_ate
    from diff_gaussian_rasterization_tpu_torch.io.replica import (
        ate_rmse, ate_rmse_aligned)
    from diff_gaussian_rasterization_tpu_torch.models import runner
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as prep_k)
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    args = bench_ate.parse_args([])
    scfg = bench_ate.slam_config(args)
    n_all = SLAM_FRAMES + 7
    t0 = time.time()
    gt_model, views, frames, cam_t = bench_ate.scene(args, dev)
    views, frames = views[:n_all], frames[:n_all]
    torch.cuda.synchronize()
    log(f"[slam] record scene: {int(gt_model.num_active)} Gaussians, "
        f"{args.frames} frames rendered at {cam_t.width}x{cam_t.height} in "
        f"{time.time() - t0:.1f} s; SLAM on the first {SLAM_FRAMES}")
    data = list(zip(views.cpu().numpy(), frames))
    log(f"[slam] record scene ready at +{time.time() - t0:.1f} s")
    render.reset_launches()
    with _Recorder(runner) as rec:
        t1 = time.perf_counter()
        state, gt_views = runner.run_slam(data[:SLAM_FRAMES], scfg, cam_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    counts = dict(render.launches)
    track_ms, map_ms = rec.ms("track"), rec.ms("map")
    refine_ms, n_retracks = rec.ms("refine"), len(rec.ms("retrack"))
    n_over = rec.overflowed()
    gtv = [np.asarray(v) for v in gt_views]
    ate = ate_rmse(state.est_views, gtv)
    ate_al = ate_rmse_aligned(state.est_views, gtv)
    ate_static = ate_rmse([gtv[0]] * len(gtv), gtv)
    finite = all(bool(torch.isfinite(v).all()) for v in state.est_views)
    n_active, n_kf = int(state.model.num_active), len(state.kf_idx)
    log(f"[slam] {SLAM_FRAMES} frames: ATE {100 * ate:.3f} cm unaligned, "
        f"{100 * ate_al:.3f} cm aligned, no tracking "
        f"{100 * ate_static:.3f} cm; keyframes {state.kf_idx}; active "
        f"{n_active}; budget {state.raster.max_instances}; wall {wall:.2f} "
        f"s; launches {counts}; tracked frames {len(track_ms)} "
        f"({np.mean(track_ms):.1f} ms each), mapping rounds "
        f"{len(map_ms)} ({[round(m, 1) for m in map_ms]} ms, the "
        f"first the bootstrap), refinements {len(refine_ms)} "
        f"({[round(m, 1) for m in refine_ms]} ms, with {n_retracks} "
        f"re-tracks)")
    check(finite and len(state.est_views) == SLAM_FRAMES,
          f"slam record: {SLAM_FRAMES} finite poses")
    check(100 * ate < SLAM_ATE_MAX_CM and ate < 0.5 * ate_static,
          f"slam record: ATE below {SLAM_ATE_MAX_CM} cm and below half the "
          "no-tracking ATE")
    check(n_active > 0, "slam record: the map keeps active Gaussians")
    check(rec.flags and n_over == 0,
          f"slam record: none of the runner's {len(rec.flags)} coverage "
          "and keyframe renders overflowed its instance budget")
    check(all(counts[k] > 0 for k in ("render_fwd", "render_bwd",
                                      "tile_scatter_sum", "segment_sum_rows",
                                      "render_jvp")),
          "slam record: the run launched render_fwd, render_bwd, "
          "tile_scatter_sum, segment_sum_rows and render_jvp")
    errs = slam_kernels(state, scfg, cam_t, frames[SLAM_FRAMES - 1], check)
    # frame SLAM_FRAMES unprofiled, then three frames, the last a keyframe
    # with its mapping round
    i0 = SLAM_FRAMES
    dev_frames = [runner._on_device(f, dev) for f in frames[i0:i0 + 7]]
    t4 = time.perf_counter()
    state, _ = runner.slam_step(state, dev_frames[0], cam_t, scfg, i0)
    torch.cuda.synchronize()
    log(f"[slam] frame {i0} (keyframe, round and refinement) took "
        f"{time.perf_counter() - t4:.1f} s")
    render.reset_launches()
    prep_k.reset_launches()
    # device activity only: with the host's operator events the profile of
    # three SLAM frames holds hundreds of thousands of events, and reading
    # it back takes minutes
    t3 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        for k in range(1, 4):
            state, _ = runner.slam_step(state, dev_frames[k], cam_t, scfg,
                                        i0 + k)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t2) * 1e3
    per_frame = {k: v / 3 for k, v in {**render.launches,
                                       **prep_k.launches}.items()}
    rows = sorted(device_events(prof), key=device_us, reverse=True)
    log(f"[slam] the three profiled frames took {prof_wall / 1e3:.1f} s, "
        f"the profile {time.perf_counter() - t3:.1f} s with its read-back")
    busy = sum(device_us(e) for e in rows) / 1e3
    # the port's kernels' device time a frame, by kernel function
    kernel_ms = {}
    for e in rows:
        name = next((k for k in SLAM_KERNEL_FNS if k in e.key), None)
        if name is not None:
            kernel_ms[name] = kernel_ms.get(name, 0.0) + device_us(e) / 3e3
    log(f"[profile] {card}: SLAM frames {i0 + 1}-{i0 + 3} (the last "
        f"keyframes {state.kf_idx[-2:]}, each with its mapping round): "
        f"{prof_wall / 3:.3f} ms a frame on the host "
        f"clock under the profiler, device busy {busy / 3:.3f} ms a frame "
        f"(idle share {1 - busy / prof_wall:.3f}); launches a frame "
        f"{json.dumps(per_frame)}, segment_sum_rows by row width over the "
        f"three {dict(render.row_launches)}; the port's kernels' device "
        f"time a frame {json.dumps(kernel_ms)} ms; device time by kernel a "
        f"frame:")
    for e in rows[:12]:
        log(f"[profile]   {device_us(e) / 1e3 / 3:9.4f} ms  "
            f"x{e.count / 3:<6.1f} {e.key[:90]}")
    def three_frames():
        st = state
        for k, f in enumerate(dev_frames[4:]):
            st, _ = runner.slam_step(st, f, cam_t, scfg, i0 + 4 + k)

    syncs, sites = host_syncs(three_frames, n=len(dev_frames[4:]))
    log(f"[slam] host syncs a frame over frames {i0 + 4}-{i0 + 6} (the last "
        f"a keyframe with its round): {syncs:.1f}; by call site: "
        f"{json.dumps(sites)}")
    n_rounds = len(map_ms)
    return errs, dict(
        frames=SLAM_FRAMES, of_frames=args.frames,
        res=f"{cam_t.width}x{cam_t.height}",
        ate_cm=100 * ate, ate_aligned_cm=100 * ate_al,
        ate_no_tracking_cm=100 * ate_static,
        keyframes=n_kf, active=n_active, wall_s=wall,
        fps=SLAM_FRAMES / wall,
        ms_per_tracked_frame=float(np.mean(track_ms)),
        tracked_frames=len(track_ms),
        ms_per_mapping_round=float(np.mean(map_ms[1:]))
        if n_rounds > 1 else None,
        ms_bootstrap_mapping=map_ms[0] if map_ms else None,
        mapping_rounds=max(n_rounds - 1, 0),
        ms_per_refinement=float(np.mean(refine_ms))
        if refine_ms else None, refinements=len(refine_ms),
        launches_per_frame=per_frame, kernel_ms_per_frame=kernel_ms,
        host_syncs_per_frame=syncs,
        busy_ms_per_frame=busy / 3,
        idle_share=1 - busy / prof_wall, card=card)


# ---- the reference-style API (phase 6) ----------------------------------
# the leaves phase 6 differentiates, besides the means, a zero means2D
# [P, 3] (the reference's placeholder) and the view matrix
API_LEAVES = ("scales", "rotations", "opacities", "colors_precomp")
API_ITERS = 10


def api_loss(out, wc, w_alpha):
    """``loss_of`` on the API's 8-tuple (every differentiable output), the
    silhouette weighted by ``w_alpha``."""
    loss = (wc * out[0]).sum()
    for i, name in ((2, "depth"), (3, "depth_median"), (4, "depth_var"),
                    (5, "opacity_map")):
        w = w_alpha if name == "opacity_map" else LOSS_W[name]
        loss = loss + w * out[i].sum()
    return loss


def full_loss(out, wc):
    """The full variant's 4-tuple: color, depth and the silhouette."""
    return ((wc * out[0]).sum() + LOSS_W["depth"] * out[2].sum()
            + LOSS_W["opacity_map"] * out[3].sum())


def api_leaves(means, kw, cam):
    import torch
    d = {k: kw[k].detach().clone().requires_grad_(True) for k in API_LEAVES}
    d["means3D"] = means.detach().clone().requires_grad_(True)
    d["means2D"] = torch.zeros((means.shape[0], 3), device=means.device,
                               requires_grad=True)
    d["viewmatrix"] = cam.viewmatrix.detach().clone().requires_grad_(True)
    return d


def api_render(leaves, kw, cam, cfg, variant="light", alpha_grad=False,
               **flags):
    """``GaussianRasterizer`` the way a CG-SLAM-style caller builds it."""
    from diff_gaussian_rasterization_tpu_torch import (
        GaussianRasterizationSettings, GaussianRasterizer)
    s = GaussianRasterizationSettings(
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=kw["bg"], scale_modifier=1.0,
        viewmatrix=leaves["viewmatrix"], **flags)
    return GaussianRasterizer(s, cfg, variant=variant,
                              alpha_grad=alpha_grad)(
        **leaves, gt_depth=kw["gt_depth"])


def ras_render(leaves, kw, cam, cfg):
    """``rasterize`` on the same leaves (``means2D``'s first two
    columns)."""
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    rest = {k: leaves[k] for k in API_LEAVES}
    return ras.rasterize(
        leaves["means3D"], cam.replace(viewmatrix=leaves["viewmatrix"]), cfg,
        means2D=leaves["means2D"][:, :2], bg=kw["bg"],
        gt_depth=kw["gt_depth"], **rest)


def grads_equal(a, b):
    """Every leaf's gradient bit-equal in ``a`` and ``b``, or absent in
    both."""
    import torch
    return all(
        (x.grad is None) == (b[k].grad is None)
        and (x.grad is None or torch.equal(x.grad, b[k].grad))
        for k, x in a.items())


def api_launches_ok(counts, rows, n=1):
    """``rasterize``'s launches for ``n`` forward + backward steps."""
    return (all(counts[k] == n for k in ("render_fwd", "render_bwd",
                                         "tile_scatter_sum"))
            and counts["segment_sum_rows"] == 2 * n
            and rows == {2: n, 12: n})


def api_bench(check, card, means, kw, cam, cfg, wc):
    """Phase 6a: ``GaussianRasterizer`` at the bench scene's full width
    against ``rasterize`` in the same call: launches, bit-equal outputs and
    gradients (light with and without ``alpha_grad``, full), the gates,
    host waits and times."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    for alpha_grad in (True, False):
        a = api_leaves(means, kw, cam)
        render.reset_launches()
        out = api_render(a, kw, cam, cfg, alpha_grad=alpha_grad)
        api_loss(out, wc, LOSS_W["opacity_map"]).backward()
        torch.cuda.synchronize()
        counts, rows = dict(render.launches), dict(render.row_launches)
        b = api_leaves(means, kw, cam)
        ref = ras_render(b, kw, cam, cfg)
        api_loss(ref[:8], wc,
                 LOSS_W["opacity_map"] if alpha_grad else 0.0).backward()
        tag = f"api (alpha_grad={alpha_grad})"
        log(f"[api] {tag}: launches of one forward + backward {counts}, "
            f"segment_sum_rows by row width {rows}; {int(ref.num_rendered)} "
            f"instances; means2D.grad column 2 max "
            f"{float(a['means2D'].grad[:, 2].abs().max())}, columns 0-1 "
            f"max {float(a['means2D'].grad[:, :2].abs().max())}")
        check(api_launches_ok(counts, rows),
              f"{tag}: one render_fwd, render_bwd and tile_scatter_sum, two "
              "segment_sum_rows (F = 2 and 12) and no segment_sum launch "
              "per forward + backward")
        check(all(bool(torch.isfinite(o.float()).all()) for o in out)
              and not bool(ref.overflow),
              f"{tag}: finite outputs, no overflow")
        check(all(torch.equal(x, y) for x, y in zip(out, ref[:8])),
              f"{tag}: the 8 outputs bit-equal to rasterize's")
        check(grads_equal(a, b) and all(a[k].grad is not None for k in a),
              f"{tag}: every gradient (the means, {', '.join(API_LEAVES)}, "
              "means2D, the view matrix) bit-equal to rasterize's on the "
              "same loss" + ("" if alpha_grad else
                             " without its silhouette term"))
        check(not a["means2D"].grad[:, 2].any()
              and bool(a["means2D"].grad[:, :2].any()),
              f"{tag}: means2D.grad [P, 3] has a zero third column and a "
              "nonzero screen gradient")

    # the full variant: the 4-tuple, its silhouette and pose gradient
    a, b = api_leaves(means, kw, cam), api_leaves(means, kw, cam)
    render.reset_launches()
    out = api_render(a, kw, cam, cfg, variant="full", alpha_grad=True)
    full_loss(out, wc).backward()
    torch.cuda.synchronize()
    counts, rows = dict(render.launches), dict(render.row_launches)
    ref = ras_render(b, kw, cam, cfg.full_variant())
    full_loss((ref.color, ref.radii, ref.depth, ref.opacity_map),
              wc).backward()
    log(f"[api] full variant: launches {counts}, by row width {rows}")
    check(len(out) == 4 and api_launches_ok(counts, rows),
          "api (full): a 4-tuple, with rasterize's launches")
    check(torch.equal(out[3], ref.opacity_map)
          and a["viewmatrix"].grad is not None and grads_equal(a, b),
          "api (full): the silhouette, the pose gradient and every other "
          "gradient bit-equal to rasterize(cfg.full_variant())'s")
    for flag, gated in (("track_off", ("viewmatrix",)),
                        ("map_off", ("means3D", "means2D") + API_LEAVES)):
        a = api_leaves(means, kw, cam)
        out = api_render(a, kw, cam, cfg, **{flag: True})
        api_loss(out, wc, LOSS_W["opacity_map"]).backward()
        check(all(a[k].grad is None for k in gated)
              and all(a[k].grad is not None and bool(a[k].grad.any())
                      for k in a if k not in gated),
              f"api ({flag}=True): no gradient for {', '.join(gated)}; a "
              "nonzero one for the rest")

    # the host's waits and the times, beside rasterize's
    def fwd(render_fn):
        leaves = api_leaves(means, kw, cam)

        def run():
            with torch.no_grad():
                render_fn(leaves)
        return run

    def fwd_bwd(render_fn, loss):
        def run():
            leaves = api_leaves(means, kw, cam)
            loss(render_fn(leaves)).backward()
        return run

    api_fn = lambda lv: api_render(lv, kw, cam, cfg)
    ras_fn = lambda lv: ras_render(lv, kw, cam, cfg)[:8]
    loss = lambda o: api_loss(o, wc, LOSS_W["opacity_map"])
    calls = {"forward": (fwd(api_fn), fwd(ras_fn)),
             "forward + backward": (fwd_bwd(api_fn, loss),
                                    fwd_bwd(ras_fn, loss))}
    for name, (api_run, ras_run) in calls.items():
        n_api, sites_api = host_syncs(api_run)
        n_ras, sites_ras = host_syncs(ras_run)
        log(f"[api] host waits in one {name}: GaussianRasterizer {n_api:.0f} "
            f"{json.dumps(sites_api)}, rasterize {n_ras:.0f} "
            f"{json.dumps(sites_ras)}")
        check(n_api <= n_ras, f"api: no more host waits than rasterize in "
                              f"one {name}")
        # in turns, three times: rasterize, API, API, rasterize
        t_ras, t_api = [], []
        for _ in range(3):
            t_ras.append(time_ms(ras_run, iters=API_ITERS))
            t_api += [time_ms(api_run, iters=API_ITERS) for _ in range(2)]
            t_ras.append(time_ms(ras_run, iters=API_ITERS))
        med_ras, med_api = np.median(t_ras), np.median(t_api)
        log(f"[time] {card}: {name} at 100k, {API_ITERS} calls a sample, "
            f"in turns: rasterize {[round(x, 3) for x in t_ras]} ms "
            f"(median {med_ras:.3f}), GaussianRasterizer "
            f"{[round(x, 3) for x in t_api]} ms (median {med_api:.3f}); the "
            f"wrapper's difference of the medians {med_api - med_ras:+.3f} "
            f"ms")


def api_mapping(dev, check, cam, cfg):
    """Phase 6b: five Adam steps on the mapping benchmark's 500k model,
    written the CG-SLAM way: ``GaussianRasterizer`` with ``track_off``, an
    RGB-D L1 loss and ``loss.backward()``."""
    import torch
    from diff_gaussian_rasterization_tpu_torch import (
        GaussianRasterizationSettings, GaussianRasterizer)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        MappingConfig, render_model)
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.scenes import mapping_model
    model = mapping_model(device=dev)
    with torch.no_grad():
        probe = render_model(model, cam, cfg)
    map_cfg = cfg.replace(
        max_instances=int(-(-int(probe.num_rendered) * 1.1 // 1024) * 1024))
    gt_rgb = torch.clamp(probe.color * 0.9 + 0.05, 0, 1)
    gt_depth = probe.depth[0]
    mcfg = MappingConfig()
    opt = torch.optim.Adam([
        dict(params=[model.means3D], lr=mcfg.lr_means),
        dict(params=[model.scales_log], lr=mcfg.lr_scales),
        dict(params=[model.rotations], lr=mcfg.lr_rotations),
        dict(params=[model.opacities_logit], lr=mcfg.lr_opacities),
        dict(params=[model.sh], lr=mcfg.lr_sh)], eps=1e-15)
    settings = GaussianRasterizationSettings(
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.zeros(3, device=dev),
        scale_modifier=1.0, viewmatrix=cam.viewmatrix, sh_degree=0,
        track_off=True)
    rasterizer = GaussianRasterizer(settings, map_cfg)
    valid = gt_depth > 0
    losses = []
    render.reset_launches()
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        means2D = torch.zeros_like(model.means3D, requires_grad=True)
        color, radii, depth, _, _, alpha, _, _ = rasterizer(
            means3D=model.means3D, means2D=means2D, shs=model.sh,
            opacities=model.opacities, scales=model.scales,
            rotations=model.rotations)
        depth_est = depth[0] / torch.clamp_min(alpha[0], 0.5)
        loss = (torch.abs(color - gt_rgb).mean() + 0.5 * (
            torch.abs(depth_est - gt_depth) * valid).sum()
            / torch.clamp_min(valid.sum(), 1))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    counts, rows = dict(render.launches), dict(render.row_launches)
    losses = [float(v) for v in losses]
    log(f"[api] five CG-SLAM-style Adam steps at 500k "
        f"({int(probe.num_rendered)} instances): losses {losses}; launches "
        f"{counts}, by row width {rows}")
    check(api_launches_ok(counts, rows, n=5),
          "api mapping: rasterize's launches in each of five steps")
    check(losses[-1] < losses[0] and all(np.isfinite(losses)),
          "api mapping: the loss after five steps is below step 0's")
    check(not means2D.grad[:, 2].any() and bool(means2D.grad[:, :2].any())
          and bool((radii > 0).any()),
          "api mapping: means2D.grad [P, 3] carries the screen gradient in "
          "columns 0-1 only")


def api_examples(dev, check):
    """Phase 6c: the three examples on the card, small and in-process,
    each with its kernels' launches counted."""
    import os
    import tempfile

    import torch
    from PIL import Image
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    from diff_gaussian_rasterization_tpu_torch.examples import (
        fit_scene, render_ply, run_slam)
    from diff_gaussian_rasterization_tpu_torch.io.ply import (
        load_ply, save_ply)
    from diff_gaussian_rasterization_tpu_torch.io.synthetic import (
        orbit_trajectory)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        render_model)
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.scenes import random_model
    fwd = ("render_fwd", "tile_scatter_sum", "segment_sum_rows")
    with tempfile.TemporaryDirectory() as tmp:
        ply, out_dir = os.path.join(tmp, "sh3.ply"), os.path.join(tmp, "r")
        save_ply(ply, random_model(seed=0, sh_degree=3, device=dev))
        render.reset_launches()
        t0 = time.perf_counter()
        rcfg = render_ply.main([ply, "--out", out_dir, "--res", "680x1200",
                                "--orbit", "2", "--depth"])
        torch.cuda.synchronize()
        counts = dict(render.launches)
        log(f"[api] render_ply, 2 views of the SH-3 model at 1200x680 in "
            f"{time.perf_counter() - t0:.1f} s: launches {counts}")
        check(all(counts[k] >= 2 for k in fwd),
              "render_ply launched render_fwd, tile_scatter_sum and "
              "segment_sum_rows for each view")
        model = load_ply(ply, device=dev)
        same = []
        for i, v in enumerate(orbit_trajectory(2, device=dev)):
            with torch.no_grad():
                want = render_ply.to_uint8(render_model(
                    model, Camera(viewmatrix=v, tanfovx=0.82, tanfovy=0.47,
                                  height=680, width=1200), rcfg).color)
            got = np.asarray(Image.open(
                os.path.join(out_dir, f"view{i:03d}.png")))
            same.append(bool(np.array_equal(got, want))
                        and float(want.std()) > 1)
        check(all(same), "render_ply's PNGs equal the quantized render_model "
                         "images")

        render.reset_launches()
        t0 = time.perf_counter()
        res = fit_scene.main(["--iters", "20",
                              "--out", os.path.join(tmp, "fit.ply")])
        torch.cuda.synchronize()
        counts = dict(render.launches)
        log(f"[api] fit_scene, 20 iterations in "
            f"{time.perf_counter() - t0:.1f} s: loss {res['losses'][0]:.4f} "
            f"-> {res['losses'][-1]:.4f}, holdout PSNR "
            f"{res['holdout_psnr']:.2f} dB; launches {counts}")
        check(res["losses"][-1] < res["losses"][0]
              and all(counts[k] > 0 for k in fwd + ("render_bwd",)),
              "fit_scene lowered its loss, launching render_fwd, "
              "tile_scatter_sum, segment_sum_rows and render_bwd")

    render.reset_launches()
    t0 = time.perf_counter()
    res = run_slam.main(["--frames", "6"])
    torch.cuda.synchronize()
    counts = dict(render.launches)
    log(f"[api] run_slam, 6 frames in {time.perf_counter() - t0:.1f} s: "
        f"ATE {100 * res['ate_m']:.3f} cm, static {100 * res['ate_static_m']:.3f}"
        f" cm; launches {counts}")
    check(np.isfinite(res["ate_m"]) and res["ate_m"] < res["ate_static_m"]
          and all(counts[k] > 0 for k in fwd + ("render_bwd", "render_jvp")),
          "run_slam tracked 6 frames below the static-pose ATE, launching "
          "every kernel of the SLAM path")


# --------------------------------------------------------------------------
# 7. the parallel layer on a mesh of ranks sharing the card
# --------------------------------------------------------------------------

MESH_RANKS = 2          # ranks of phase 7's gloo world, all on cuda:0
MESH_SLAM_FRAMES = 10   # frames of the meshed run_slam (keyframes 0, 3, 6,
                        # 9; a mapping round each; a refinement at the end)
MESH_TIMEOUT = 900      # seconds a spawned world may take
MESH_XI = (0.02, -0.01, 0.015, 0.03, -0.02, 0.01)  # the second keyframe's


def _digest(x) -> str:
    import hashlib
    return hashlib.sha256(x.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _row_rule(a, b, rtol=1e-5, atol=1e-6):
    """``|a - b| <= atol + rtol |b| + COL_EPS * max |b|`` (the bench-scale
    rule: float32 sums carry about 1e-6 of a column's largest value)
    throughout; returns (ok, max_abs_err)."""
    a, b = a.detach().double(), b.detach().double()
    d = (a - b).abs()
    scale = float(b.abs().max()) if b.numel() else 0.0
    ok = bool((d <= atol + rtol * b.abs() + COL_EPS * scale).all())
    return ok, float(d.max()) if d.numel() else 0.0


class _CollectiveTimer:
    """Records CUDA events around every ``all_gather`` / ``all_reduce`` of
    ``parallel.sharded`` and ``parallel.shard_bin`` while active."""

    def __init__(self):
        self.pairs = []

    def __enter__(self):
        import torch
        from diff_gaussian_rasterization_tpu_torch.parallel import (
            shard_bin, sharded)
        self.saved = []
        for mod in (sharded, shard_bin):
            for name in ("all_gather", "all_reduce"):
                fn = getattr(mod, name)

                def timed(*a, _fn=fn, **k):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = _fn(*a, **k)
                    e1.record()
                    self.pairs.append((e0, e1))
                    return out
                self.saved.append((mod, name, fn))
                setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def _render_leaves(means, kw, cam, cfg, wc, **extra):
    """``rasterize`` forward + backward of ``loss_of``: (outputs, grads of
    every leaf and of the view matrix)."""
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    args = dict(kw)
    leaves = {k: args.pop(k).detach().clone().requires_grad_(True)
              for k in GRAD_LEAVES if k in args}
    means = means.detach().clone().requires_grad_(True)
    view = cam.viewmatrix.detach().clone().requires_grad_(True)
    out = ras.rasterize(means, cam.replace(viewmatrix=view), cfg, **leaves,
                        **args, **extra)
    loss_of(out, wc).backward()
    grads = {"means3D": means.grad, "view": view.grad,
             **{k: v.grad for k, v in leaves.items()}}
    return out, grads


def mesh_rank(rank, n, slam_data, device_type="cuda"):
    """Phase 7 on one rank of a gloo world whose ranks share cuda:0.
    Returns the rank's checks, log lines, digests (for bit-identity across
    ranks), launch counts, times and its meshed run_slam."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.models import runner
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        PARAM_FIELDS, DensifyState)
    from diff_gaussian_rasterization_tpu_torch.models.lie import apply_twist
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        Frame, MappingConfig, frozen_budget, make_map_optimizer, map_step,
        render_model)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.parallel import sharded
    from diff_gaussian_rasterization_tpu_torch.parallel.mesh import (
        make_mesh, rank_device)
    from diff_gaussian_rasterization_tpu_torch.scenes import (
        bench_camera, bench_scene, mapping_model, tracking_frame)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(rank, device_type)
    res = dict(checks=[], logs=[], digest={}, counts={}, times={})
    check = lambda ok, what: res["checks"].append((bool(ok), what))
    log_ = res["logs"].append
    tile_mesh = make_mesh((1, n), ("kf", "tile"), backend="gloo",
                          device=device_type)

    # -- 7.1 tile-sharded rasterize at the bench scene --------------------
    cfg = RasterConfig(tile_h=32, tile_w=32)
    means, kw = bench_scene(device=dev)
    cam = bench_camera(device=dev)
    n_inst = int(ras.count_instances(means, cam, cfg, **kw))
    cfg = cfg.replace(max_instances=int(-(-n_inst * 1.1 // 1024) * 1024))
    wc = torch.as_tensor(np.random.RandomState(1).uniform(
        0.5, 1, (3, 1, 1)).astype(np.float32), device=dev)
    out1, g1 = _render_leaves(means, kw, cam, cfg, wc)
    render.reset_launches()
    out2, g2 = _render_leaves(means, kw, cam, cfg, wc, mesh=tile_mesh)
    torch.cuda.synchronize()
    res["counts"]["tile"] = dict(render.launches)
    same = all(torch.equal(getattr(out1, f), getattr(out2, f))
               for f in out1._fields)
    same_g = all(torch.equal(g1[k], g2[k]) for k in g1)
    check(same and same_g, f"mesh: tile-sharded rasterize at 100k (tile="
          f"{n}): every output and gradient bit-equal to the unsharded")
    for f in ("color", "depth", "gau_uncertainty"):
        res["digest"][f"tile/{f}"] = _digest(getattr(out2, f))
    for k in g2:
        res["digest"][f"tile/g_{k}"] = _digest(g2[k])
    render.reset_launches()
    out3, g3 = _render_leaves(means, kw, cam, cfg, wc, mesh=tile_mesh,
                              shard_binning=True)
    torch.cuda.synchronize()
    res["counts"]["shard_binning"] = dict(render.launches)
    oks, worst = [], 0.0
    for f in ("color", "depth", "depth_median", "opacity_map",
              "gau_uncertainty"):
        ok, e = _row_rule(getattr(out3, f), getattr(out1, f), rtol=0,
                          atol=2e-4)
        oks.append(ok)
        worst = max(worst, e)
    for k in g1:
        ok, e = _row_rule(g3[k], g1[k], rtol=1e-3, atol=2e-4)
        oks.append(ok)
        worst = max(worst, e)
    ok_int = (torch.equal(out3.gau_related_pixels, out1.gau_related_pixels)
              and int(out3.num_rendered) == int(out1.num_rendered)
              and not bool(out3.overflow))
    log_(f"[mesh] shard-binned rasterize at 100k: largest difference from "
         f"the unsharded {worst}; instances {int(out3.num_rendered)} "
         f"(unsharded {int(out1.num_rendered)}), overflow "
         f"{bool(out3.overflow)}")
    check(all(oks) and ok_int, "mesh: shard-binned rasterize at 100k within "
          "the bench-scale row rule of the unsharded (atol 2e-4 + 2e-6 x the "
          "column's largest value; gradients also rtol 1e-3), the same "
          "instance count and pixel counts, no overflow")
    # this rank's band: render_fwd and render_bwd at its tile0 against
    # their plain versions
    _, binn, feat, gt_tiles = ras.prepare(
        means, cam, cfg, cfg.max_instances, kw["gt_depth"],
        **{k: v for k, v in kw.items() if k not in ("bg", "gt_depth")})
    table = feat[binn.gauss_id].detach().contiguous()
    core_kw = dict(cfg=cfg, tiles_x=-(-cam.width // cfg.tile_w),
                   height=cam.height, width=cam.width)
    tile0, count = sharded.tile_share(binn.tile_start.shape[0], n, rank)
    band = [sharded.local_tiles(x, tile0, count)
            for x in (binn.tile_start, binn.tile_stop, gt_tiles)]
    k = sharded.core_fwd_local(table, binn.tile_start, binn.tile_stop,
                               gt_tiles, rank, n, **core_kw)
    p = render.core_fwd_reference(table, *band, tile0=tile0, **core_kw)
    err_f, _, ok_f = compare_core(k, p)
    g = torch.Generator().manual_seed(rank)
    cots = tuple(torch.randn(tuple(x.shape), generator=g).to(dev) for x in
                 (k.color, k.depth, k.weight, k.var, k.median, k.t_final))
    totals = (k.color, k.depth, k.weight, k.var, k.t_final)
    rows_k = render.core_bwd(table, *band, totals, cots,
                             n_contrib=k.n_contrib, tile0=tile0, **core_kw)
    pix = render.blend.bwd_pixel_inputs(band[2], *totals, *cots)
    rows_p = render.core_bwd_reference(table, band[0], band[1],
                                       pix.contiguous(), tile0=tile0,
                                       **core_kw)
    tile_ok = (k.n_contrib == p.n_contrib).all(dim=1)
    inst = torch.zeros(rows_k.shape[0], dtype=torch.bool, device=dev)
    for t in torch.nonzero(tile_ok).flatten().tolist():
        inst[int(band[0][t]):int(band[1][t])] = True
    ok_b, err_b = _row_rule(rows_k[inst], rows_p[inst], rtol=1e-3,
                            atol=2e-4)
    log_(f"[mesh] rank {rank}: tiles {tile0}..{tile0 + count - 1} "
         f"(tile0 {tile0}): render_fwd vs plain max_abs_err {err_f}, "
         f"render_bwd vs plain {err_b} on {int(tile_ok.sum())} of {count} "
         f"tiles")
    check(ok_f and ok_b and float((~tile_ok).float().mean()) < 0.05,
          f"mesh: render_fwd and render_bwd at tile0 {tile0} match their "
          f"plain versions on the band (rank {rank})")
    res["errs"] = dict(fwd=err_f, bwd=err_b)
    # times: a forward + backward, unsharded and tile-sharded, and the
    # collectives inside the sharded one (CUDA events)
    step = lambda **m: _render_leaves(means, kw, cam, cfg, wc, **m)
    res["times"]["fwd_bwd_ms"] = time_ms(step, iters=5)
    res["times"]["fwd_bwd_tile_ms"] = time_ms(
        lambda: step(mesh=tile_mesh), iters=5)
    with _CollectiveTimer() as ct:
        for _ in range(5):
            step(mesh=tile_mesh)
        res["times"]["collectives_ms"] = ct.ms() / 5
    del out1, out2, out3, g1, g2, g3, feat, table

    # -- 7.2 the tile-sharded dual render at the tracking frame ----------
    ts = tracking_frame(device=dev)
    tmeans = ts.model.means3D.detach()
    with torch.no_grad():
        kwm = ts.model.raster_kwargs()
    margin = ts.tcfg.bin_margin_px
    tbinn = ras.bin_for_view(
        tmeans, ts.camera, ts.cfg.replace(bin_margin_px=margin),
        max_instances=frozen_budget(ts.cfg, tmeans.shape[0], margin), **kwm)
    tw = twist_basis(ts.camera.viewmatrix)
    dual = lambda **m: ras.rasterize_with_pose_jvp(
        tmeans, ts.camera, ts.cfg, tw, gt_depth=ts.frame.depth, binn=tbinn,
        **kwm, **m)
    j1 = dual()
    render.reset_launches()
    j2 = dual(mesh=tile_mesh)
    torch.cuda.synchronize()
    res["counts"]["dual"] = dict(render.launches)
    same = (all(torch.equal(getattr(j1.out, f), getattr(j2.out, f))
                for f in j1.out._fields)
            and all(torch.equal(getattr(j1, f), getattr(j2, f))
                    for f in ("color", "depth", "opacity_map")))
    check(same, "mesh: tile-sharded rasterize_with_pose_jvp (light, K = 6) "
          "at the tracking frame bit-equal to the unsharded")
    res["digest"]["dual/color"] = _digest(j2.color)
    with torch.no_grad():
        _, _, jtable, jtans, jgt = ras.pose_jvp_tables(
            tmeans, ts.camera, ts.cfg, tw, None, ts.frame.depth, binn=tbinn,
            **kwm)
    jkw = dict(cfg=ts.cfg, tiles_x=-(-ts.camera.width // ts.cfg.tile_w),
               height=ts.camera.height, width=ts.camera.width)
    jt0, jcount = sharded.tile_share(tbinn.tile_start.shape[0], n, rank)
    ko, kt = sharded.core_fwd_jvp_local(jtable, jtans, tbinn.tile_start,
                                        tbinn.tile_stop, jgt, rank, n, **jkw)
    jband = [sharded.local_tiles(x, jt0, jcount)
             for x in (tbinn.tile_start, tbinn.tile_stop, jgt)]
    po, pt = render.core_fwd_jvp_reference(jtable, jtans, *jband, tile0=jt0,
                                           **jkw)
    err_j, _, ok_j = compare_core(ko, po)
    tile_ok = (ko.n_contrib == po.n_contrib).all(dim=1)
    for f in ("color", "depth", "weight", "t_final"):
        ok, e = _row_rule(getattr(kt, f)[tile_ok], getattr(pt, f)[tile_ok],
                          rtol=JVP_RTOL, atol=JVP_ATOL)
        ok_j &= ok
        err_j = max(err_j, e)
    log_(f"[mesh] rank {rank}: render_jvp at tile0 {jt0} vs plain "
         f"max_abs_err {err_j}")
    check(ok_j and float((~tile_ok).float().mean()) < 0.05,
          f"mesh: render_jvp at tile0 {jt0} matches its plain version on "
          f"the band (rank {rank})")
    res["errs"]["jvp"] = err_j
    del ts, tmeans, kwm, tbinn, j1, j2, jtable, jtans

    # -- 7.3 one map step at 500k over two keyframes ----------------------
    base = mapping_model(device=dev)
    views = torch.stack([cam.viewmatrix, apply_twist(cam.viewmatrix,
                         torch.tensor(MESH_XI, device=dev))])
    with torch.no_grad():
        probes = [render_model(base, cam.replace(viewmatrix=v), cfg)
                  for v in views]
    map_cfg = cfg.replace(max_instances=int(-(-max(
        int(pr.num_rendered) for pr in probes) * 1.1 // 1024) * 1024))
    rgbs = torch.stack([torch.clamp(pr.color * 0.9 + 0.05, 0, 1)
                        for pr in probes])
    depths = torch.stack([pr.depth[0] for pr in probes])
    mcfg = MappingConfig()

    def one_step(**m):
        model = mapping_model(device=dev)
        opt = make_map_optimizer(model, mcfg)
        dstate = DensifyState.zero(model.capacity, device=dev)
        loss, _, _ = map_step(model, opt, dstate, views, rgbs, depths,
                              torch.ones(2, device=dev), map_cfg, mcfg,
                              cam.height, cam.width, cam.tanfovx,
                              cam.tanfovy, 2, **m)
        return float(loss), model

    l1, m1 = one_step()
    meshes = {"kf=2": (dict(kf_axis="kf"), (n, 1)),
              "map=2": (dict(map_axis="map",
                             map_budget=base.capacity // n), (1, n))}
    for tag, (akw, shape) in meshes.items():
        mesh = make_mesh(shape, ("kf", "map"), backend="gloo",
                         device=device_type)
        render.reset_launches()
        l2, m2 = one_step(mesh=mesh, **akw)
        torch.cuda.synchronize()
        res["counts"][f"map {tag}"] = dict(render.launches)
        oks, worst_g, worst_p = [], 0.0, 0.0
        lrs = dict(means3D=mcfg.lr_means, scales_log=mcfg.lr_scales,
                   rotations=mcfg.lr_rotations,
                   opacities_logit=mcfg.lr_opacities, sh=mcfg.lr_sh)
        for f in PARAM_FIELDS:
            a, b = getattr(m2, f), getattr(m1, f)
            ok, e = _row_rule(a.grad, b.grad)
            oks.append(ok)
            worst_g = max(worst_g, e)
            # Adam's first step moves an entry by about lr * sign(g): held
            # where the gradient is live, within a tenth of the rate
            live = b.grad.abs() >= 1e-6
            dp = float((a.detach() - b.detach())[live].abs().max())
            oks.append(dp <= lrs[f] / 10)
            worst_p = max(worst_p, dp)
            res["digest"][f"map {tag}/{f}"] = _digest(a)
        ok_l = abs(l2 - l1) <= 1e-5 * max(abs(l1), 1.0)
        log_(f"[mesh] map_step at 500k, 2 keyframes, {tag}: loss {l2!r} "
             f"(one device {l1!r}); largest gradient difference {worst_g}, "
             f"largest parameter difference where the gradient is live "
             f"{worst_p}")
        check(ok_l and all(oks), f"mesh: map_step at 500k on {tag}: the loss "
              f"within 1e-5, the gradients within rtol 1e-5 / atol 1e-6 + "
              f"2e-6 x the field's largest, the parameters within lr / 10 "
              f"where the gradient is live, of the one-device step")
        res["digest"][f"map {tag}/loss"] = repr(l2)
        del m2
    del base, m1, probes

    # -- 7.4 run_slam at the record configuration on kf=2 -----------------
    from diff_gaussian_rasterization_tpu_torch.examples import bench_ate
    views_np, frames_np, cam_kw = slam_data
    scfg = bench_ate.slam_config(bench_ate.parse_args([]))
    scfg.mesh = make_mesh((n, 1), ("kf", "tile"), backend="gloo",
                          device=device_type)
    to = lambda a: torch.as_tensor(a, device=dev)
    data = [(v, Frame(to(r), to(d))) for v, (r, d) in zip(views_np,
                                                          frames_np)]
    cam_t = bench_camera(device=dev).replace(**cam_kw)
    render.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = runner.run_slam(data, scfg, cam_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["counts"]["slam"] = dict(render.launches)
    res["slam"] = dict(est_views=torch.stack(state.est_views),
                       kf_idx=list(state.kf_idx), wall_s=wall)
    res["digest"]["slam/views"] = _digest(torch.stack(state.est_views))
    res["digest"]["slam/means"] = _digest(state.model.means3D)
    return res


def nccl_rank(rank, n):
    """Phase 7's one-rank NCCL world: the tile-sharded bench render and its
    gradients on a one-rank mesh, bit-equal to the unsharded."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh
    from diff_gaussian_rasterization_tpu_torch.scenes import (
        bench_camera, bench_scene)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((1, n), ("kf", "tile"), backend="nccl", device="cuda")
    cfg = RasterConfig(tile_h=32, tile_w=32)
    means, kw = bench_scene(device=dev)
    cam = bench_camera(device=dev)
    wc = torch.as_tensor(np.random.RandomState(1).uniform(
        0.5, 1, (3, 1, 1)).astype(np.float32), device=dev)
    out1, g1 = _render_leaves(means, kw, cam, cfg, wc)
    render.reset_launches()
    out2, g2 = _render_leaves(means, kw, cam, cfg, wc, mesh=mesh)
    torch.cuda.synchronize()
    same = (all(torch.equal(getattr(out1, f), getattr(out2, f))
                for f in out1._fields)
            and all(torch.equal(g1[k], g2[k]) for k in g1))
    return dict(same=same, backend=torch.distributed.get_backend(),
                counts=dict(render.launches))


def mesh_phase(dev, check):
    """Phase 7: the parallel layer (``parallel/``) on a gloo world of
    MESH_RANKS ranks sharing cuda:0 (NCCL takes one rank a card), then a
    one-rank NCCL world."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.examples import bench_ate
    from diff_gaussian_rasterization_tpu_torch.models import runner
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.parallel.mesh import spawn

    # the meshed run_slam's frames: the record scene's first frames, made
    # here once and handed to the ranks
    args = bench_ate.parse_args([])
    _, views, frames, cam_t = bench_ate.scene(args, dev)
    views, frames = views[:MESH_SLAM_FRAMES], frames[:MESH_SLAM_FRAMES]
    data = list(zip(views.cpu().numpy(), frames))
    scfg = bench_ate.slam_config(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one, _ = runner.run_slam(data, scfg, cam_t)
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    slam_data = (views.cpu().numpy(),
                 [(f.rgb.cpu().numpy(), f.depth.cpu().numpy())
                  for f in frames],
                 dict(height=cam_t.height, width=cam_t.width,
                      tanfovx=cam_t.tanfovx, tanfovy=cam_t.tanfovy))
    t0 = time.time()
    ranks = spawn(mesh_rank, MESH_RANKS, (slam_data, dev.type),
                  backend="gloo", device_type=dev.type, timeout=MESH_TIMEOUT)
    log(f"[mesh] {MESH_RANKS} gloo ranks on cuda:0 took "
        f"{time.time() - t0:.1f} s")
    for r, res in enumerate(ranks):
        for line in res["logs"]:
            log(line)
        for ok, what in res["checks"]:
            check(ok, f"{what} [rank {r}]")
        log(f"[mesh] rank {r} launches: {json.dumps(res['counts'])}")
        t = res["times"]
        log(f"[mesh] rank {r}: forward + backward at 100k {t['fwd_bwd_ms']:.2f}"
            f" ms unsharded, {t['fwd_bwd_tile_ms']:.2f} ms tile-sharded over "
            f"{MESH_RANKS} ranks sharing the card, of which the collectives "
            f"(gloo, through the host) {t['collectives_ms']:.2f} ms")
    check(all(r["digest"] == ranks[0]["digest"] for r in ranks),
          "mesh: every rank ends bit-identical (renders, gradients, mapped "
          "models, losses, the SLAM poses and map)")
    for tag, path in (("tile", ("render_fwd", "render_bwd",
                                "tile_scatter_sum", "segment_sum_rows")),
                      ("shard_binning", ("render_fwd", "render_bwd",
                                         "tile_scatter_sum",
                                         "segment_sum_rows")),
                      ("dual", ("render_jvp", "tile_scatter_sum")),
                      ("map kf=2", ("render_fwd", "render_bwd")),
                      ("map map=2", ("render_fwd", "render_bwd")),
                      ("slam", ("render_fwd", "render_bwd", "render_jvp",
                                "tile_scatter_sum", "segment_sum_rows"))):
        counts = [r["counts"][tag] for r in ranks]
        check(all(c[k] >= 1 for c in counts for k in path),
              f"mesh: the {tag} path launched {', '.join(path)} on every "
              f"rank")
    # the meshed run_slam against the one-device run of the same frames
    mv = ranks[0]["slam"]["est_views"]
    dv = np.stack([v.detach().cpu().numpy() for v in one.est_views])
    gt = [np.asarray(v) for v in views.cpu().numpy()]
    from diff_gaussian_rasterization_tpu_torch.io.replica import ate_rmse
    ate_mesh = ate_rmse([torch.as_tensor(v) for v in mv], gt)
    ate_one = ate_rmse(one.est_views, gt)
    wall_mesh = ranks[0]["slam"]["wall_s"]
    pose_err = float(np.abs(mv - dv).max())
    log(f"[mesh] run_slam, record configuration, {MESH_SLAM_FRAMES} frames: "
        f"kf=2 over {MESH_RANKS} ranks {MESH_SLAM_FRAMES / wall_mesh:.3f} "
        f"frames/s, ATE {100 * ate_mesh:.3f} cm, keyframes "
        f"{ranks[0]['slam']['kf_idx']}; one device "
        f"{MESH_SLAM_FRAMES / wall_one:.3f} frames/s, ATE "
        f"{100 * ate_one:.3f} cm, keyframes {list(one.kf_idx)}; largest "
        f"pose difference {pose_err}")
    check(pose_err <= 5e-3 and abs(ate_mesh - ate_one) < 2e-3
          and ranks[0]["slam"]["kf_idx"] == list(one.kf_idx),
          "mesh: run_slam on kf=2 within 5e-3 of the one-device poses, ATE "
          "within 2e-3 m, the same keyframes")
    # NCCL takes one rank a card: a one-rank world
    t0 = time.time()
    nres = spawn(nccl_rank, 1, backend="nccl", device_type="cuda",
                 timeout=MESH_TIMEOUT)[0]
    log(f"[mesh] one-rank NCCL world ({nres['backend']}) took "
        f"{time.time() - t0:.1f} s; launches {nres['counts']}")
    check(nres["same"] and nres["backend"] == "nccl"
          and nres["counts"]["render_fwd"] >= 1,
          "mesh: the tile-sharded bench render and gradients on a one-rank "
          "NCCL mesh bit-equal to the unsharded")
    render.reset_launches()
    return dict(ranks=MESH_RANKS, fwd_bwd=[r["times"] for r in ranks],
                slam_fps_mesh=MESH_SLAM_FRAMES / wall_mesh,
                slam_fps_one=MESH_SLAM_FRAMES / wall_one,
                ate_mesh_m=ate_mesh, ate_one_m=ate_one, pose_err=pose_err)


# The basis form of the splat exponent (phase 8): the pair test's exponent
# as five products and five sums of a splat's coefficients with the
# pixel's basis terms, 10 FP32 operations where the direct form takes ~11.
# The basis terms (qx, qy and their three products) depend on the pixel
# alone: 5 operations a pixel, counted once a pixel.  The backward's
# gradient terms need dx, dy besides, which the direct form's pair test
# makes: 2 more a contribution.  The coefficients, once per instance and
# tile, are not counted.
OPS_PER_PAIR_BASIS = OPS_PER_PAIR - 1
OPS_PER_PIXEL_BASIS = 5
OPS_PER_CONTRIB_BWD_BASIS = OPS_PER_CONTRIB_BWD + 2
def check_basis_kernels(tag, table, binn, gt_tiles, bkw, check, seed=0,
                        band=False):
    """Phase 8's kernel checks at one render's shapes, with the exponent's
    basis form (``bkw``'s cfg): ``render_fwd``'s basis instantiation
    against the plain version with the basis (and bit-equal to a repeat),
    ``render_bwd``'s (stopped at the basis forward's ``n_contrib``) rows
    under the row rule and against float64, the culling boxes against the
    blend over every pair of the binning (``render.cull_misses``), and,
    with ``band``, one band of tiles launched at ``tile0 > 0`` bit-equal to
    the full launch's slice.  Returns what the times reuse."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops import blend
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.parallel import sharded
    dev = table.device
    start, stop = binn.tile_start, binn.tile_stop
    out_k = render.core_fwd(table, start, stop, gt_tiles, **bkw)
    again = render.core_fwd(table, start, stop, gt_tiles, **bkw)
    out_p = render.core_fwd_reference(table, start, stop, gt_tiles, **bkw)
    torch.cuda.synchronize()
    err_fwd, rep, ok = compare_core(out_k, out_p)
    n_px = out_k.n_contrib.numel()
    flips = {f: int((getattr(out_k, f) != getattr(out_p, f)).sum())
             for f in ("n_contrib", "n_valid", "midx")}
    log(f"[basis] {tag}: render_fwd (basis) vs plain: " + json.dumps(rep)
        + f"; pixels whose integer fields differ, of {n_px}: "
        + json.dumps(flips))
    check(ok, f"{tag}: render_fwd (basis) matches its plain version (rtol "
              "1e-4, atol 2e-5 on agreeing pixels; integer mismatch < 5e-3)")
    check(flips["n_contrib"] == 0 and flips["n_valid"] == 0,
          f"{tag}: render_fwd (basis) and its plain version agree on every "
          "pixel's n_contrib and n_valid")
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          f"{tag}: two render_fwd (basis) renders are bit-equal")
    n_tiles, q = gt_tiles.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    cots = tuple(torch.randn(shape, generator=gen, device=dev)
                 for shape in [(n_tiles, 3, q)] + [(n_tiles, q)] * 5)
    totals = (out_k.color, out_k.depth, out_k.weight, out_k.var,
              out_k.t_final)
    pix = blend.bwd_pixel_inputs(gt_tiles, *totals, *cots).contiguous()
    rows_k = render.core_bwd(table, start, stop, gt_tiles, totals, cots,
                             **bkw, n_contrib=out_k.n_contrib)
    rows_p = render.core_bwd_reference(table, start, stop, pix, **bkw)
    out_d = render.core_fwd_reference(table.double(), start, stop,
                                      gt_tiles.double(), **bkw)
    rows_d = render.core_bwd_reference(table.double(), start, stop,
                                       pix.double(), **bkw)
    torch.cuda.synchronize()
    tile_ok = (out_k.n_contrib == out_p.n_contrib).all(dim=1)
    tile_ok_d = tile_ok & (out_k.n_contrib == out_d.n_contrib).all(dim=1)
    err_bwd, left_out, rep, ok, ok_f64 = compare_rows(
        rows_k, rows_p, rows_d, tile_ok, tile_ok_d, start, stop)
    del out_d, rows_d
    log(f"[basis] {tag}: render_bwd (basis) vs plain: max_abs_err {err_bwd} "
        f"on the rows of tiles whose n_contrib agrees; rows left out "
        f"{left_out}; per column against float64: " + json.dumps(rep))
    check(ok, f"{tag}: render_bwd (basis) matches its plain version (rtol "
              f"1e-3, atol 2e-4 + {COL_EPS} x the column's largest value; "
              "rows outside every segment zero)")
    check(ok_f64, f"{tag}: render_bwd (basis)'s error against float64 is "
                  f"within {F64_RATIO} x the plain version's, or "
                  f"{F64_FLOOR} of the column's largest value")
    check(left_out < 5e-3,
          f"{tag}: rows of tiles whose n_contrib disagrees < 5e-3 (basis)")
    geo = {k: bkw[k] for k in ("tiles_x", "height", "width")}
    t0 = time.time()
    misses = {form: render.cull_misses(
        table, start, stop, cfg=bkw["cfg"].replace(splat_basis_power=b),
        **geo, chunk=4096) for form, b in (("basis", True), ("direct", False))}
    n_pairs = int((stop - start).to(torch.int64).sum()) * q
    log(f"[basis] {tag}: pairs of the binning ({n_pairs}) outside their "
        f"culling box that the blend keeps: {json.dumps(misses)} "
        f"({time.time() - t0:.1f} s)")
    check(misses["basis"] == 0 and misses["direct"] == 0,
          f"{tag}: the culling boxes skip no pair the blend keeps (basis "
          "form and direct form, every pair of the binning)")
    if band:
        tile0, count = sharded.tile_share(n_tiles, 2, 1)
        bst, bsp, bgt = (sharded.local_tiles(x, tile0, count)
                         for x in (start, stop, gt_tiles))
        part = render.core_fwd(table, bst, bsp, bgt, tile0=tile0, **bkw)
        bcot = tuple(sharded.local_tiles(c, tile0, count) for c in cots)
        brows = render.core_bwd(
            table, bst, bsp, bgt, (part.color, part.depth, part.weight,
                                   part.var, part.t_final), bcot,
            n_contrib=part.n_contrib, tile0=tile0, **bkw)
        torch.cuda.synchronize()
        # the band's tiles past the grid (its padding) are empty
        real = min(count, n_tiles - tile0)
        sl = slice(tile0, tile0 + real)
        lo, hi = int(start[tile0]), int(stop[tile0 + real - 1])
        same = all(torch.equal(getattr(part, f)[:real], getattr(out_k, f)[sl])
                   for f in render.CoreOutputs._fields[:9])
        same_rows = (torch.equal(brows[lo:hi], rows_k[lo:hi])
                     and not brows[:lo].any() and not brows[hi:].any())
        log(f"[basis] {tag}: tiles {tile0}..{tile0 + real - 1} launched at "
            f"tile0 = {tile0}: outputs equal {same}, rows equal {same_rows}")
        check(tile0 > 0 and same and same_rows,
              f"{tag}: render_fwd and render_bwd (basis) launched at tile0 = "
              f"{tile0} equal the full launch's slice bit for bit")
    out_f = torch.empty((n_tiles, 9, q), device=dev)
    out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
    return dict(out_k=out_k, pix=pix, rows_k=rows_k, binn=binn, table=table,
                gt_tiles=gt_tiles, out_f=out_f, out_i=out_i,
                err_fwd=err_fwd, err_bwd=err_bwd)


def in_turns(fns, iters, warmup=2):
    """CUDA-event times of each of ``fns`` (a dict), in turns: the order,
    then the order reversed (a, b, b, a); each time a list of two."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        out[k].append(time_ms(fns[k], iters=iters, warmup=warmup))
    return out


def basis_kernel_times(tag, st_d, st_b, core_kw, bkw, card, plain_iters=1):
    """``render_fwd`` and ``render_bwd`` in their direct and basis
    instantiations at one render's shapes, in turns (CUDA events; the
    backward stopped at each form's own forward's ``n_contrib``), the
    basis forms' plain versions, and their bounds (the direct form's bytes;
    operations with the basis pair test).  Returns the two entries of the
    kernels line."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    table, binn = st_b["table"], st_b["binn"]
    start, stop = binn.tile_start, binn.tile_stop
    gt = st_b["gt_tiles"]
    n_tiles, q = gt.shape
    fwd = in_turns({
        "direct": lambda: render.launch_render_fwd(
            table, start, stop, gt, st_d["out_f"], st_d["out_i"], **core_kw),
        "basis": lambda: render.launch_render_fwd(
            table, start, stop, gt, st_b["out_f"], st_b["out_i"], **bkw)},
        iters=50)
    rows_d = torch.zeros_like(st_b["rows_k"])
    rows_b = torch.zeros_like(st_b["rows_k"])
    bwd = in_turns({
        "direct": lambda: render.launch_render_bwd(
            table, start, stop, st_d["pix"], rows_d, **core_kw,
            n_contrib=st_d["out_k"].n_contrib),
        "basis": lambda: render.launch_render_bwd(
            table, start, stop, st_b["pix"], rows_b, **bkw,
            n_contrib=st_b["out_k"].n_contrib)}, iters=20)
    plain_fwd = time_ms(lambda: render.core_fwd_reference(
        table, start, stop, gt, **bkw), iters=plain_iters, warmup=1)
    plain_bwd = time_ms(lambda: render.core_bwd_reference(
        table, start, stop, st_b["pix"], **bkw), iters=plain_iters,
        warmup=1)
    pixmask = render.pixel_coords(n_tiles, bkw["tiles_x"], bkw["cfg"].tile_h,
                                  bkw["cfg"].tile_w, bkw["height"],
                                  bkw["width"], table.device)[2]
    bf, byf, finfo = render_fwd_bound_ms(st_b["out_k"], start, stop, pixmask,
                                         OPS_PER_PAIR_BASIS,
                                         OPS_PER_PIXEL_BASIS)
    n_seg = int((stop - start).sum())
    bb, byb, binfo = render_bwd_bound_ms(
        finfo["contributions"], n_seg, n_tiles, q, OPS_PER_PAIR_BASIS,
        OPS_PER_CONTRIB_BWD_BASIS, OPS_PER_PIXEL_BASIS * int(pixmask.sum()))
    log(f"[time] {card}: render_fwd ({tag}) in turns, direct / basis "
        f"{fwd['direct']} / {fwd['basis']} ms (basis bound {bf:.4f} ms by "
        f"{byf}: {json.dumps(finfo)}; plain basis {plain_fwd:.3f} ms)")
    log(f"[time] {card}: render_bwd ({tag}) in turns, direct / basis "
        f"{bwd['direct']} / {bwd['basis']} ms (basis bound {bb:.4f} ms by "
        f"{byb}: {json.dumps(binfo)}; plain basis {plain_bwd:.3f} ms)")
    mean = lambda v: sum(v) / len(v)
    return (dict(ms=mean(fwd["basis"]), plain_ms=plain_fwd, bound_ms=bf,
                 bound_by=byf, library_ms=None,
                 direct_ms=mean(fwd["direct"])),
            dict(ms=mean(bwd["basis"]), plain_ms=plain_bwd, bound_ms=bb,
                 bound_by=byb, library_ms=None,
                 direct_ms=mean(bwd["direct"])))


def basis_phase(dev, check, card, reg_lines, bench, mapped, core_kw,
                means, kw, cam, cfg, max_inst, wc, model, opt, dstate,
                map_args):
    """Phase 8: ``splat_basis_power``.  Its kernels against their plain
    versions at 100k and at the 500k map step's render, the culling boxes'
    safety, one band at ``tile0 > 0``; the path (one forward + backward
    through ``rasterize`` and through ``GaussianRasterizer``, bit-equal,
    and one ``map_step`` at 500k, with the launch counts); times of both
    forms in turns.  Returns the kernels line's two entries."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.models.slam import map_step
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    t_phase = time.time()
    for line in reg_lines:
        if "render_fwd_kernel<" in line or "render_bwd_kernel<" in line:
            log(f"[basis] registers: {line}")
    bcfg = cfg.replace(splat_basis_power=True)
    bkw = dict(core_kw, cfg=bcfg)
    st100 = check_basis_kernels("100k", bench["table"], bench["binn"],
                                bench["gt_tiles"], bkw, check, band=True)
    st500 = check_basis_kernels("500k", mapped["table"], mapped["binn"],
                                mapped["gt_tiles"], bkw, check, seed=1)

    # the path: rasterize and GaussianRasterizer, forward + backward, and
    # a map step, each with every count set to 0 just before
    bench_cfg = bcfg.replace(max_instances=max_inst)
    a, b = api_leaves(means, kw, cam), api_leaves(means, kw, cam)
    render.reset_launches()
    ref = ras_render(b, kw, cam, bench_cfg)
    api_loss(ref[:8], wc, LOSS_W["opacity_map"]).backward()
    torch.cuda.synchronize()
    counts_ras = dict(render.launches)
    rows_ras = dict(render.row_launches)
    render.reset_launches()
    out = api_render(a, kw, cam, bench_cfg, alpha_grad=True)
    api_loss(out, wc, LOSS_W["opacity_map"]).backward()
    torch.cuda.synchronize()
    counts_api = dict(render.launches)
    log(f"[basis] forward + backward with the flag: rasterize launches "
        f"{counts_ras} (by row width {rows_ras}), GaussianRasterizer "
        f"{counts_api}")
    check(api_launches_ok(counts_ras, rows_ras)
          and counts_api == counts_ras,
          "basis: one render_fwd, render_bwd and tile_scatter_sum and two "
          "segment_sum_rows launches per forward + backward, through "
          "rasterize and through GaussianRasterizer")
    check(all(bool(torch.isfinite(o.float()).all()) for o in out)
          and not bool(ref.overflow),
          "basis: finite outputs, no overflow")
    check(all(torch.equal(x, y) for x, y in zip(out, ref[:8]))
          and grads_equal(a, b) and all(a[k].grad is not None for k in a),
          "basis: GaussianRasterizer's 8 outputs and every gradient bit-equal "
          "to rasterize's")
    direct = ras_render(api_leaves(means, kw, cam), kw, cam,
                        cfg.replace(max_instances=max_inst))
    diff = float((direct.color - ref.color).detach().abs().max())
    ncm = int((direct.n_contrib != ref.n_contrib).sum())
    log(f"[basis] the basis render against the direct one at 100k: color "
        f"max_abs_diff {diff}, pixels whose n_contrib differs {ncm}")
    check(0 < diff < 1e-3, "basis: the basis render differs from the direct "
                           "one by rounding only (0 < color diff < 1e-3)")
    b_args = map_args[:4] + (map_args[4].replace(splat_basis_power=True),) \
        + map_args[5:]
    render.reset_launches()
    loss, dstate, _ = map_step(model, opt, dstate, *b_args)
    torch.cuda.synchronize()
    counts_map = dict(render.launches)
    log(f"[basis] map_step at 500k with the flag: loss {float(loss)}, "
        f"launches {counts_map}")
    check(bool(torch.isfinite(loss)) and all(
        counts_map[k] == 1 for k in ("render_fwd", "render_bwd",
                                     "tile_scatter_sum")),
          "basis: map_step at 500k launches render_fwd, render_bwd and "
          "tile_scatter_sum once, finite loss")

    # times: both forms in turns
    st100_d = dict(bench)
    st500_d = dict(mapped)
    f100, b100 = basis_kernel_times("100k", st100_d, st100, core_kw, bkw,
                                    card)
    f500, b500 = basis_kernel_times("500k", st500_d, st500, core_kw, bkw,
                                    card)
    bench_render = lambda *x, **k: ras.rasterize(*x, max_instances=max_inst,
                                                 **k)
    fb = in_turns({
        "direct": lambda: grads_of(bench_render, means, cam, cfg, kw, wc),
        "basis": lambda: grads_of(bench_render, means, cam, bcfg, kw, wc)},
        iters=5, warmup=1)
    mp = in_turns({
        "direct": lambda: map_step(model, opt, dstate, *map_args),
        "basis": lambda: map_step(model, opt, dstate, *b_args)},
        iters=3, warmup=1)
    log(f"[time] {card}: forward + backward rasterize at 100k in turns, "
        f"direct / basis {fb['direct']} / {fb['basis']} ms; map_step at 500k "
        f"{mp['direct']} / {mp['basis']} ms")
    took = time.time() - t_phase
    log(f"[basis] phase 8 took {took:.1f} s")
    entries = []
    for name, tag, n, t, err, src, line in (
            # each scale's own launches: the 100k forward + backward
            # through rasterize, and the 500k map step
            ("render_fwd_basis", "100k", counts_ras["render_fwd"], f100,
             max(st100["err_fwd"], st500["err_fwd"]), "render_fwd.cu", 157),
            ("render_fwd_basis_500k", "500k", counts_map["render_fwd"], f500,
             st500["err_fwd"], "render_fwd.cu", 157),
            ("render_bwd_basis", "100k", counts_ras["render_bwd"], b100,
             max(st100["err_bwd"], st500["err_bwd"]), "render_bwd.cu", 717),
            ("render_bwd_basis_500k", "500k", counts_map["render_bwd"], b500,
             st500["err_bwd"], "render_bwd.cu", 717)):
        t = dict(t)
        t.pop("direct_ms")
        entries.append(dict(
            name=name, route="cuda",
            source=f"diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                   f"{src}",
            replaces=f"diff_gaussian_rasterization_tpu/ops/kernels/"
                     f"render_pallas.py:{line}",
            launches=n, max_abs_err=err, **t))
    return entries


# Phase 9: the benchmark drivers (examples/bench*.py), each run as a user
# runs it, ``python -m`` in a process of its own from the repository's
# root (which frees its memory on exit), at its defaults: the JAX drivers'
# record configurations; and bench tile-sharded over two gloo ranks on the
# one card (NCCL refuses two ranks on one card), cut to 3 samples of 2
# steps.  Each: (tag, module, arguments, the JAX driver's metric, unit).
DRIVERS = (
    ("bench", "bench", (), "fwd_bwd_rasterizations_per_sec_1200x680",
     "renders/s"),
    ("bench_ranks2", "bench", ("--ranks", "2", "--backend", "gloo",
                               "--samples", "3", "--inner", "2"),
     "fwd_bwd_rasterizations_per_sec_1200x680", "renders/s"),
    ("bench_tracking", "bench_tracking", (),
     "tracking_steps_per_sec_1200x680", "tracked frames/s"),
    ("bench_mapping", "bench_mapping", (),
     "mapping_steps_per_sec_1200x680_500k", "map steps/s"),
)
DRIVER_TIMEOUT = 600  # seconds a driver may take


def start_driver(module, argv):
    """``python -m diff_gaussian_rasterization_tpu_torch.examples.<module>
    <argv>`` started from the repository's root, in a session of its own
    (its ranks with it are killed at the time limit): ``(process, start
    time)``."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m",
           f"diff_gaussian_rasterization_tpu_torch.examples.{module}", *argv]
    return subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True), time.time()


def wait_driver(started):
    """A started driver's (exit code, stdout, stderr, seconds), killed
    DRIVER_TIMEOUT seconds after its start."""
    import os
    import signal
    proc, t0 = started
    try:
        out, err = proc.communicate(
            timeout=max(1.0, DRIVER_TIMEOUT - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\n[chip_smoke] killed after {DRIVER_TIMEOUT} s"
    return proc.returncode, out, err, time.time() - t0


def run_driver(module, argv):
    """One driver run to its end: (exit code, stdout, stderr, seconds)."""
    return wait_driver(start_driver(module, argv))


def driver_guard(tag, line, want):
    """The checks of one driver's line beyond its metric and samples: its
    own guard (no error; bench: no overflow; tracking: the pose error
    falls, below 1e-3 as phase 3 checks; mapping: the loss falls), the
    card's name and power limit, and its kernel launches a step as phase
    3 counted them on the same path (``want``; the sharded ranks: one
    render_fwd, render_bwd and tile_scatter_sum a rank a step)."""
    ok = "error" not in line and bool(line.get("card")) \
        and str(line.get("power_limit")).endswith(" W")
    launches = line.get("launches", {})
    if tag == "bench":
        ok &= line["instances"] <= line["max_instances"]
    elif tag == "bench_ranks2":
        ok &= line["devices"] == 2 and len(line["rank_median_ms"]) == 2
        want = {k: 1.0 for k in ("render_fwd", "render_bwd",
                                 "tile_scatter_sum")}
        launches = {k: launches.get(k) for k in want}
    elif tag == "bench_tracking":
        ok &= line["pose_err_after"] < min(line["pose_err_before"], 1e-3)
    elif tag == "bench_mapping":
        ok &= line["loss_step1"] < line["loss_step0"]
    return ok and launches == want


def driver_phase(check, want, own):
    """Phase 9: every driver of DRIVERS run in its own process; its line
    checked (exit code 0, exactly one JSON line on stdout, the JAX
    driver's metric and unit, a finite positive value, the spread, its
    guard) and echoed, its mean and median printed beside this script's
    own time of the same configuration (``own``: a comparison, not a
    check: the timers and the timed work differ).  Returns the lines by
    tag."""
    import math
    lines = {}
    for tag, module, argv, metric, unit in DRIVERS:
        rc, out, err, secs = run_driver(module, argv)
        printed = [x for x in out.splitlines() if x.strip()]
        try:
            line = json.loads(printed[0]) if len(printed) == 1 else None
        except ValueError:
            line = None
        log(f"[driver] {tag}: python -m ...examples.{module} "
            f"{' '.join(argv)} exited {rc} after {secs:.1f} s")
        check(rc == 0, f"driver {tag}: exit code 0")
        check(isinstance(line, dict),
              f"driver {tag}: exactly one JSON line on stdout")
        if rc != 0 or not isinstance(line, dict):
            log(f"[driver] {tag}: stdout {out[-2000:]!r}; stderr tail "
                f"{err[-4000:]}")
            continue
        log(f"[driver] {tag}: {printed[0]}")
        lines[tag] = dict(line, seconds=secs)
        value = line.get("value")
        check(line.get("metric") == metric and line.get("unit") == unit,
              f"driver {tag}: the JAX driver's metric {metric!r} and unit "
              f"{unit!r}")
        check(isinstance(value, (int, float)) and math.isfinite(value)
              and value > 0 and "spread" in line,
              f"driver {tag}: a finite value > 0 and the samples' spread")
        try:
            ok = driver_guard(tag, line, want.get(tag))
        except (KeyError, TypeError) as e:
            ok = False
            log(f"[driver] {tag}: a field is missing: {e!r}")
        check(ok, f"driver {tag}: its guard holds, the card's name and "
                  f"power limit are in its line, and it launched the "
                  f"kernels of its path")
        log(f"[driver] {tag}: mean {line.get('mean_ms')} ms a step, "
            f"median {line.get('median_ms')} "
            f"(min {line.get('min_ms')}, max {line.get('max_ms')}, spread "
            f"{line.get('spread')}, {line.get('samples')} samples, host "
            f"clock); this script's {own[tag]}")
    return lines


# Phase 10: the profiling tools (examples/prof*.py), each in a process of
# its own as phase 9 runs the drivers, all six at once (their times there
# share the card and the host: contended, not comparable with a tool run
# alone, so only checked, never reported), on the bench scene at full
# width, cut to a few steps.  Each: (module, arguments); prof_trace and
# prof_track get a temporary directory for their traces first.
PROF_TOOLS = (
    ("prof", ("--samples", "1", "--inner", "2")),
    ("prof_bin", ("--samples", "1", "--inner", "2")),
    ("prof_jvp", ("--samples", "1", "--inner", "2")),
    ("prof_trace", ("--samples", "1", "--inner", "2")),
    ("prof_track", ("--samples", "1", "--inner", "1")),
    ("prof_ab", ("tile_h=16", "tile_w=16", "--samples", "1", "--inner",
                 "2")),
)


def _finite_pos(x):
    import math
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def prof_tool_ok(tool, lines, stages, want, rows_want):
    """The checks of one tool's lines beyond its exit code: its stage
    count (``stages``, by tool), the card's name and power limit on each line, finite positive
    host and device times and an idle share in [0, 1); prof_trace: the
    port's kernels in its table with phase 3's launches a step (``want``,
    ``rows_want`` by row width); prof_jvp: one render_jvp a dual render;
    prof_ab: the override's tiles."""
    ok = len(lines) == stages[tool] and all(
        x.get("tool") == tool and "error" not in x and bool(x.get("card"))
        and str(x.get("power_limit")).endswith(" W")
        and _finite_pos(x.get("host_ms")) and _finite_pos(x.get("device_ms"))
        and 0 <= x.get("idle_share", -1) < 1 for x in lines)
    if not ok:
        return False
    if tool == "prof_trace":
        k = lines[0]["kernels"]
        got = {name: sum(v["launches"] for n, v in k.items()
                         if n.startswith(name + "_kernel"))
               for name in ("render_fwd", "tile_scatter_sum", "render_bwd")}
        got.update({f"segment_sum_rows<{f}>": k.get(
            f"segment_sum_rows_kernel<{f}>", {}).get("launches")
            for f in rows_want})
        exp = {name: want[name] for name in ("render_fwd",
                                             "tile_scatter_sum",
                                             "render_bwd")}
        exp.update({f"segment_sum_rows<{f}>": n
                    for f, n in rows_want.items()})
        log(f"[prof] prof_trace's kernels a step {got}, phase 3's {exp}")
        return got == exp and lines[0]["launches"] == want
    if tool == "prof_jvp":
        return [x["launches"]["render_jvp"] for x in lines] == [0, 1, 1] \
            and lines[0]["launches"]["render_fwd"] == 1
    if tool == "prof_ab":
        return [x["tile"] for x in lines] == ["32x32", "16x16"]
    if tool == "prof_track":
        return bool(lines[0]["ops"]) and lines[0]["host_syncs"] is not None
    return True


def prof_phase(check, want, rows_want, dev):
    """Phase 10: every tool of PROF_TOOLS in its own process, all at once,
    its lines checked (``prof_tool_ok``); prof_bin's last stage against
    ``bin_gaussians`` + the gather, and prof_ab's refusal of a TPU-only
    field, here.  Returns each tool's verdict and seconds."""
    import shutil
    import tempfile

    import torch
    from diff_gaussian_rasterization_tpu_torch.examples import (
        bench as ex_bench, prof, prof_ab, prof_bin, prof_jvp)
    from diff_gaussian_rasterization_tpu_torch.ops.kernels.preprocess import (
        feature_table)
    from diff_gaussian_rasterization_tpu_torch.ops.projection import (
        preprocess)
    from diff_gaussian_rasterization_tpu_torch.ops.rasterize import _bin
    stages = {"prof": len(prof.STAGES), "prof_bin": len(prof_bin.STAGES),
              "prof_jvp": len(prof_jvp.STAGES),
              "prof_ab": len(prof_ab.CONFIGS), "prof_trace": 1,
              "prof_track": 1}
    traces = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    out = {}
    started = [(tool, argv, start_driver(
        tool, ((traces,) if tool in ("prof_trace", "prof_track") else ())
        + argv)) for tool, argv in PROF_TOOLS]
    for tool, argv, proc in started:
        rc, text, err, secs = wait_driver(proc)
        try:
            lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        except ValueError:
            lines = []
        log(f"[prof] {tool}: python -m ...examples.{tool} {' '.join(argv)} "
            f"exited {rc} after {secs:.1f} s")
        check(rc == 0 and bool(lines),
              f"prof tool {tool}: exit code 0, JSON lines on stdout")
        out[tool] = dict(ok=False, seconds=secs)
        if rc != 0 or not lines:
            log(f"[prof] {tool}: stdout {text[-2000:]!r}; stderr tail "
                f"{err[-4000:]}")
            continue
        for x in lines:
            log(f"[prof] {tool} {x.get('stage', x.get('config', ''))}: "
                f"launches a step "
                f"{ {k: v for k, v in x.get('launches', {}).items() if v} }")
        try:
            ok = prof_tool_ok(tool, lines, stages, want, rows_want)
        except (KeyError, TypeError) as e:
            ok = False
            log(f"[prof] {tool}: a field is missing: {e!r}")
        check(ok, f"prof tool {tool}: its stages with finite positive host "
                  f"and device times, the card's name and power limit, and "
                  f"its path's kernels")
        out[tool]["ok"] = ok
    shutil.rmtree(traces, ignore_errors=True)
    # prof_bin's prefix pipeline against the binning it stands for, over
    # the preprocess it times (the composite, the render op's plain
    # version; the render op itself runs the kernel pair)
    args = ex_bench.parse_args([])
    means, kw, cam, cfg = ex_bench.scene(args, dev)
    with torch.no_grad():
        o = prof_bin.pipelines(kw, cam, cfg)["s6 +gather"](means)
        prep_c = preprocess(means, cam, cfg, **prof.prep_kwargs(kw))
        binn = _bin(prep_c, cam, cfg, cfg.max_instances)
        feat = feature_table(prep_c)
    check(all(torch.equal(a, b) for a, b in (
        (o["table"], feat[binn.gauss_id]), (o["tile_start"], binn.tile_start),
        (o["tile_stop"], binn.tile_stop), (o["inv"], binn.inv))),
        "prof_bin's last stage (table, ranges, inverse) bit-equal to "
        "bin_gaussians + the gather over the composite preprocess at the "
        "bench scene")
    try:
        prof_ab.main(["scan_sum_mm=true", "tile_h=16"])
        refused = False
    except ValueError as e:
        refused = "scan_sum_mm is a TPU-only field" in str(e)
    check(refused, "prof_ab refuses a TPU-only field (scan_sum_mm), naming "
                   "it")
    return out


# The preprocess phase's scenes: the mapping cell's 500k room and its first
# 120,000 slots (tum-slam's capacity), at the Replica camera.
PREP_SIZES = (("500k", None), ("120k", 120_000))
PREP_WALL_RES = 240
# where the kernel and the float32 composite both sit at float32's
# resolution against float64, their ratio is noise (tests/test_torch_cuda.py)
PREP_ERR_FLOOR = 2.0 ** -22


def queued_ms(fn, iters=100, sleep_cycles=200_000_000):
    """Device time a call of ``fn``, by CUDA events over ``iters`` calls
    queued behind a sleep kernel, so that the card runs them back to back
    however long the host takes a call; and whether the host had queued
    them all before the card reached the first (else the time holds the
    host's gaps)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    ahead = not t0.query()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters, ahead


def preprocess_phase(dev, check, card):
    """11. The preprocess kernel pair (``ops/kernels/preprocess.py``) at the
    mapping cell's 500k room and its first 120,000 slots: against the
    composite in float64 on the card, each table column and the gradient
    of each of a map step's leaves and of the Adam tracker's view no
    further off than twice the float32 composite's own error (or 2**-22 of
    the largest entry), and the integer footprint off the float64 one on
    no more Gaussians than the float32 composite's; the device times of the
    forward, the backward of a map step's leaves and of the view alone
    (``queued_ms`` through the wrappers), each beside its bound
    (``splatbench/work.py``'s counts), the plain versions' and the
    composite's autograd backward's (``device_ms``); and the launches of a
    4-keyframe map step and of a tracked frame."""
    import torch
    from splatbench import work
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.io import synthetic
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        DensifyState)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        MappingConfig, make_map_optimizer, map_step, track_frame)
    from diff_gaussian_rasterization_tpu_torch.ops import projection
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    from diff_gaussian_rasterization_tpu_torch.scenes import tracking_frame
    room = synthetic.replica_like_model(seed=0, wall_res=PREP_WALL_RES,
                                        device=dev)
    views = synthetic.walkthrough_trajectory(8, seed=0, device=dev)
    cam = Camera(viewmatrix=views[1], tanfovx=1.0, tanfovy=680 / 1200,
                 height=680, width=1200)
    cfg = RasterConfig(tile_h=32, tile_w=32)

    def composite(*args, **kw):
        prep = projection.preprocess(*args, **kw)
        return prep, kp.feature_table(prep)

    def rel_err(x, ref):
        return float((x.double() - ref).abs().max()
                     / ref.abs().max().clamp_min(1e-300))

    def int_off(prep, ref):
        bad = torch.zeros(ref.mask.shape, dtype=torch.bool, device=dev)
        for f in ("mask", "radius", "rect_min", "rect_max",
                  "tiles_touched"):
            d = getattr(prep, f) != getattr(ref, f)
            bad |= d if d.dim() == 1 else d.any(1)
        return int(bad.sum())

    rows = {}
    for tag, n in PREP_SIZES:
        kw = {k: v.detach()[:n] for k, v in room.raster_kwargs().items()
              if torch.is_tensor(v)}
        means = room.means3D.detach()[:n]
        p = means.shape[0]
        m2d = torch.zeros((p, 2), device=dev)
        d_feat = torch.randn((p, 11), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
        leaves = {"means3D": means, "opacities": kw["opacities"],
                  "scales": kw["scales"], "rotations": kw["rotations"],
                  "shs": kw["shs"], "means2D": m2d}
        rest = lambda d: {k: v for k, v in d.items() if k != "means3D"}

        def run(op, dtype, want_view):
            """``op``'s footprint, table and the gradients of <table,
            d_feat>: of a map step's leaves, or of the view alone."""
            lv = {k: v.to(dtype).clone().requires_grad_(not want_view)
                  for k, v in leaves.items()}
            view = cam.viewmatrix.to(dtype).clone().requires_grad_(want_view)
            prep, feat = op(lv["means3D"], cam.replace(viewmatrix=view), cfg,
                            sh_degree=0, **rest(lv))
            wrt = {"view": view} if want_view else lv
            g = torch.autograd.grad(feat, list(wrt.values()),
                                    d_feat.to(dtype))
            return prep, feat.detach(), dict(zip(wrt, g))

        errs, ok = {}, True
        for want_view in (False, True):
            ref, comp, kern = (run(op, dt, want_view) for op, dt in (
                (composite, torch.float64), (composite, torch.float32),
                (kp.preprocess_table, torch.float32)))
            pairs = {} if want_view else {
                f"table.{c}": (kern[1][:, i], comp[1][:, i], ref[1][:, i])
                for i, c in enumerate(kp.FEAT_COLUMNS)}
            pairs.update({f"d.{k}": (kern[2][k], comp[2][k], ref[2][k])
                          for k in ref[2]})
            for name, (k, c, r) in pairs.items():
                ek, ec = rel_err(k, r), rel_err(c, r)
                # how far the largest entry sits above a typical one
                spread = float(r.abs().max()
                               / r.abs().median().clamp_min(1e-300))
                errs[name] = dict(kernel=ek, composite=ec,
                                  max_over_median=spread)
                ok &= ek <= max(2.0 * ec, PREP_ERR_FLOOR)
                ok &= bool(torch.isfinite(k).all())
            if not want_view:
                ints = dict(kernel=int_off(kern[0], ref[0]),
                            composite=int_off(comp[0], ref[0]),
                            kernel_vs_composite=int_off(kern[0], comp[0]))
                ok &= ints["kernel"] <= ints["composite"]
        log(f"[prep] {tag}: against the float64 composite (largest error "
            f"over the largest entry): {json.dumps(errs)}; integer "
            f"footprints differing: {json.dumps(ints)}")
        check(ok, f"preprocess kernels at {tag}: each table column and "
                  f"gradient within 2x the float32 composite's error against "
                  f"float64 (or 2**-22) and finite, the integer footprint "
                  f"off float64's on no more Gaussians than the composite's")

        ins = kp._kernel_inputs(means, cam.viewmatrix, kw["opacities"],
                                kw["scales"], kw["rotations"], None,
                                kw["shs"], 0, None, m2d)
        need_map = {k: True for k in leaves}

        def fwd():
            with torch.no_grad():
                kp.preprocess_table(means, cam, cfg, sh_degree=0,
                                    **rest(leaves))

        timed = {"fwd": fwd,
                 "bwd": lambda: kp.launch_preprocess_bwd(
                     ins, d_feat, cam, cfg, 0, 1.0, need_map),
                 "bwd_view": lambda: kp.launch_preprocess_bwd(
                     ins, d_feat, cam, cfg, 0, 1.0, {"view": True})}
        ms, ahead = {}, {}
        for k, f in timed.items():
            ms[k], ahead[k] = queued_ms(f)
        check(all(ahead.values()) and all(ms[k] > 0 for k in timed),
              f"preprocess: the kernels' times at {tag} measured with every "
              f"call queued ahead of the card")
        # the plain versions, and the composite's autograd backward (the
        # path the kernels replace)
        ms["plain_fwd"] = device_ms(lambda: kp.preprocess_fwd_reference(
            means, cam, cfg, sh_degree=0, **rest(leaves)), iters=5)
        ms["plain_bwd"] = device_ms(lambda: kp.preprocess_bwd_reference(
            d_feat, means, cam, cfg, scales=kw["scales"],
            rotations=kw["rotations"], shs=kw["shs"], sh_degree=0,
            want_view=False), iters=5)
        lv = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        fc = kp.feature_table(projection.preprocess(
            lv["means3D"], cam, cfg, sh_degree=0, **rest(lv)))
        ms["composite_bwd"] = device_ms(lambda: torch.autograd.grad(
            fc, list(lv.values()), d_feat, retain_graph=True), iters=5)
        bound = {k: work.bound_s(*work.preprocess(p, backward=b)) * 1e3
                 for k, b in (("fwd", False), ("bwd", True))}
        rows[tag] = dict(p=p, ms=ms, bound_ms=bound, errors=errs,
                         ints_differing=ints)
        log(f"[prep] {card}: {tag} ({p} Gaussians) device ms "
            f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}; "
            f"bounds (bytes) {json.dumps({k: round(v, 4) for k, v in bound.items()})} "
            f"ms: forward {ms['fwd'] / bound['fwd']:.1f}x, backward "
            f"{ms['bwd'] / bound['bwd']:.1f}x (the kernels by CUDA events "
            f"over 100 calls queued behind a sleep, the rest by "
            f"torch.profiler)")

    # launches of a 4-keyframe map step at 500k and of a tracked frame
    model = synthetic.replica_like_model(seed=0, wall_res=PREP_WALL_RES,
                                         device=dev)
    mcfg = MappingConfig()
    opt = make_map_optimizer(model, mcfg)
    dstate = DensifyState.zero(model.capacity, device=dev)
    k = 4
    rgbs = torch.zeros((k, 3, 680, 1200), device=dev)
    depths = torch.zeros((k, 680, 1200), device=dev)
    map_args = (views[:k], rgbs, depths, torch.ones(k, device=dev),
                cfg.replace(max_instances=8 << 20), mcfg, 680, 1200, 1.0,
                680 / 1200, k)
    map_step(model, opt, dstate, *map_args)
    torch.cuda.synchronize()
    kp.reset_launches()
    map_step(model, opt, dstate, *map_args)
    torch.cuda.synchronize()
    map_launches = dict(kp.launches)
    ts = tracking_frame(device=dev)
    kp.reset_launches()
    track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg, ts.camera)
    torch.cuda.synchronize()
    track_launches = dict(kp.launches)
    log(f"[prep] launches: a 4-keyframe map step at 500k {map_launches}; a "
        f"tracked frame (record configuration) {track_launches}")
    check(map_launches == {"preprocess_fwd": k, "preprocess_bwd": k,
                           "preprocess_tangents": 0},
          "preprocess: one forward and one backward launch a keyframe of a "
          "map step")
    check(track_launches["preprocess_fwd"] > 0
          and track_launches["preprocess_tangents"] > 0
          and track_launches["preprocess_bwd"] == 0,
          "preprocess: a tracked frame launches the forward and the "
          "tangents, no backward")
    return dict(name="preprocess", route="cuda",
                source="diff_gaussian_rasterization_tpu_torch/ops/kernels/"
                       "csrc/preprocess.cu", replaces=None,
                sizes=rows, launches_map_step=map_launches,
                launches_tracked_frame=track_launches)


# The tangent phase's scenes: the mapping cell's 500k room at the Replica
# camera and the tum cells' 27k room (wall resolution 56) at the TUM
# camera (fx 517.3, fy 516.5, 640x480).
TANGENT_SCENES = (("500k", 240, (1.0, 680 / 1200, 680, 1200)),
                  ("27k", 56, (640 / (2 * 517.3), 480 / (2 * 516.5), 480,
                               640)))


def tangent_bytes(p, k_t, per_k, cov, sh_coeffs):
    """The bytes ``preprocess_tangents`` must move: the means, with the
    conic the scales and rotations, with the colour the SH coefficients
    read, and per_k x K floats written, a Gaussian."""
    floats_in = 3 + (7 if cov else 0) + 3 * sh_coeffs
    return 4 * p * (floats_in + per_k * k_t)


def tangent_phase(dev, check, card, reg_lines):
    """12. The pose tangents' kernel (``preprocess_tangents``) at the
    mapping cell's 500k room and the tum cells' 27k room, K = 6, in its
    light, full (conic) and SH-3 colour instantiations: against the
    composite's forward mode in float64 on the card, each column's error
    over its quantity's largest entry no larger than twice the float32
    composite's (or 2**-22); its device time (``queued_ms``) beside its
    byte bound and the composite pass it replaces (``torch.func.vmap`` of
    ``torch.func.jvp``, ``device_ms``), in turns; its ``ptxas`` lines; and
    on the record tracking frame one launch a dual render, as many as
    ``render_jvp``'s, and ``render.gaussians`` the Gaussians of every
    ``preprocess_fwd`` and ``preprocess_tangents`` launch."""
    import torch
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.io import synthetic
    from diff_gaussian_rasterization_tpu_torch.models.slam import track_frame
    from diff_gaussian_rasterization_tpu_torch.ops import projection
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.scenes import tracking_frame
    from diff_gaussian_rasterization_tpu_torch.utils import profiling

    def composite(means, cam, cfg, tw, kw):
        full = bool(cfg.pose_cov2d_branch)
        color = ras.color_branch(cfg, **kw)

        def feats(vm):
            pv = projection.preprocess(
                means, cam.replace(viewmatrix=vm), cfg, **kw)
            return (pv.xy, pv.depth) \
                + ((pv.conic,) if full or color else ()) \
                + ((pv.color,) if color else ())

        t = torch.func.vmap(lambda d: torch.func.jvp(
            feats, (cam.viewmatrix,), (d,))[1])(tw)
        return torch.cat([t[0], t[1][..., None], *t[2:]], -1).movedim(
            0, 1).reshape(means.shape[0], -1)

    def col_err(x, ref, k_t):
        p = ref.shape[0]
        err = (x.double() - ref).abs().reshape(p, k_t, -1).amax(0)
        scale = ref.abs().reshape(p, k_t, -1).amax((0, 1))
        return err / scale.clamp_min(1e-300)

    tan_lines = [ln for ln in reg_lines if "preprocess_tangent_kernel" in ln]
    for ln in tan_lines:
        log(f"[tangents] {ln}")
    check(len(tan_lines) == 8,
          "preprocess_tangents: its 8 instantiations built")
    k_t = 6
    rows = {}
    for tag, wall_res, (tanx, tany, h, w) in TANGENT_SCENES:
        room = synthetic.replica_like_model(seed=0, wall_res=wall_res,
                                            device=dev)
        view = synthetic.walkthrough_trajectory(4, seed=0, device=dev)[1]
        cam = Camera(viewmatrix=view, tanfovx=tanx, tanfovy=tany, height=h,
                     width=w)
        kw = {k: (v.detach() if torch.is_tensor(v) else v)
              for k, v in room.raster_kwargs().items()}
        means = room.means3D.detach()
        p = means.shape[0]
        sh3 = torch.randn((p, 16, 3), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1)
                          ) * SH_REST_STD
        sh3[:, 0] = kw["shs"][:, 0]
        base = RasterConfig(tile_h=32, tile_w=32)
        variants = {"light": (base, dict(kw, sh_degree=0)),
                    "full": (base.full_variant(), dict(kw, sh_degree=0)),
                    "full_sh3": (base.full_variant(),
                                 dict(kw, shs=sh3, sh_degree=3))}
        tw = twist_basis(view)
        row = {}
        for name, (cfg, vkw) in variants.items():
            color = ras.color_branch(cfg, **vkw)
            full = bool(cfg.pose_cov2d_branch)
            per_k = render.tangent_columns(full, color)
            with torch.no_grad():
                kern = kp.preprocess_tangents(means, cam, cfg, tw, **vkw)
                again = kp.preprocess_tangents(means, cam, cfg, tw, **vkw)
                comp = composite(means, cam, cfg, tw, vkw)
                kw64 = {k: (v.double() if torch.is_tensor(v) else v)
                        for k, v in vkw.items()}
                ref = composite(means.double(),
                                cam.replace(viewmatrix=view.double()), cfg,
                                tw.double(), kw64)
            ek, ec = col_err(kern, ref, k_t), col_err(comp, ref, k_t)
            ratio = float((ek / torch.clamp(2.0 * ec, min=2.0 ** -22)).max())
            del ref
            ok = (ratio <= 1.0 and bool(torch.isfinite(kern).all())
                  and torch.equal(kern, again)
                  and kern.shape == (p, per_k * k_t))
            check(ok, f"preprocess_tangents at {tag} ({name}, per_k "
                      f"{per_k}): every column within 2x the float32 "
                      f"composite's error against float64 (worst "
                      f"{ratio:.3f} of the limit), finite, bit-equal to a "
                      f"repeat")

            def run_kernel():
                kp.preprocess_tangents(means, cam, cfg, tw, **vkw)

            def run_composite():
                with torch.no_grad():
                    composite(means, cam, cfg, tw, vkw)

            ms, ms_comp = [], []
            for _ in range(2):      # in turns
                t, ahead = queued_ms(run_kernel)
                check(ahead, f"preprocess_tangents at {tag} ({name}): "
                             f"every call queued ahead of the card")
                ms.append(t)
                ms_comp.append(device_ms(run_composite, iters=5))
            nbytes = tangent_bytes(p, k_t, per_k, full,
                                   16 if color else 0)
            bound = nbytes / PEAK_BYTES * 1e3
            row[name] = dict(per_k=per_k, ms=ms, composite_ms=ms_comp,
                             bound_ms=bound, mb=nbytes / 1e6,
                             worst_of_limit=ratio,
                             col_err_kernel=float(ek.max()),
                             col_err_composite=float(ec.max()))
            log(f"[tangents] {card}: {tag} ({p} Gaussians) {name}: kernel "
                f"{', '.join(f'{t:.4f}' for t in ms)} ms, bound "
                f"{bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB): "
                f"{min(ms) / bound:.1f}x; the composite pass "
                f"{', '.join(f'{t:.3f}' for t in ms_comp)} ms "
                f"({min(ms_comp) / min(ms):.0f}x the kernel); largest "
                f"column error {float(ek.max()):.3g} (composite "
                f"{float(ec.max()):.3g})")
        rows[tag] = row

    # the record tracking frame: one launch a dual render, and the counter
    ts = tracking_frame(device=dev)
    track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg, ts.camera)
    torch.cuda.synchronize()
    kp.reset_launches()
    render.reset_launches()
    profiling.reset()
    with profiling.recording():
        track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg,
                    ts.camera)
        c = profiling.snapshot()["counters"]
    profiling.reset()
    duals = render.launches["render_jvp"]
    launches = dict(kp.launches)
    preps = launches["preprocess_fwd"] + launches["preprocess_tangents"]
    log(f"[tangents] a tracked frame: {launches}, render_jvp {duals}, "
        f"render.gaussians {c.get('render.gaussians')}")
    check(duals > 0 and launches["preprocess_tangents"] == duals
          and c.get("render.gaussians") == preps * ts.model.means3D.shape[0],
          "preprocess_tangents: one launch a dual render of a tracked frame, "
          "render.gaussians = the Gaussians of every preprocess launch")
    return dict(name="preprocess_tangents", route="cuda",
                source="diff_gaussian_rasterization_tpu_torch/ops/kernels/"
                       "csrc/preprocess.cu", replaces=None, sizes=rows,
                launches_tracked_frame=launches["preprocess_tangents"],
                ptxas=tan_lines)


def gauss_newton_phase(dev, check, card, reg_lines):
    """13. Tracking's Gauss-Newton kernels (``ops/kernels/
    gauss_newton.py``): ``gn_reduce`` (full and cost only) on the record
    tracking frame's dual render at its start pose, at 1200x680 and
    640x480, against ``gn_reduce_reference`` (rtol 1e-5, atol 1e-5 of the
    largest entry) and bit-equal to a repeat; ``twist_tangents`` against
    ``jacfwd`` of ``apply_twist`` in float64; device times (``queued_ms``)
    in turns with the plain path's, the host's microseconds a call, the
    byte bound; the ``ptxas`` lines; the launches of a tracked frame."""
    import math

    import torch
    from diff_gaussian_rasterization_tpu_torch.models import lie
    from diff_gaussian_rasterization_tpu_torch.models.slam import track_frame
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        gauss_newton as gn)
    from diff_gaussian_rasterization_tpu_torch.scenes import tracking_frame

    def host_us(fn, iters=100):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        return t

    def timed(tag, fns):
        """Device ms a call, kernel and plain in turns (k, p, p, k), and
        the host's microseconds a call."""
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            t, ahead = queued_ms(fns[k])
            if k == "kernel":
                check(ahead, f"{tag}: every kernel call queued ahead of the "
                             f"card")
            ms[k].append(t)
        return ms, {k: host_us(f) for k, f in fns.items()}

    gn_lines = [ln for ln in reg_lines if ln.startswith("gauss_newton")]
    for ln in gn_lines:
        log(f"[gn] ptxas {ln}")
    check(len(gn_lines) == 3, "gauss_newton.cu: three kernels built "
                              "(twist_tangents, gn_reduce full and cost)")
    rows = {}
    for tag, (h, w) in (("1200x680", (680, 1200)), ("640x480", (480, 640))):
        ts = tracking_frame(device=dev, height=h, width=w)
        with torch.no_grad():
            kwm = ts.model.raster_kwargs()
        zero = torch.zeros(6, device=dev)
        view, tw = gn.twist_tangents(ts.view0, zero)
        with torch.no_grad():
            j = ras.rasterize_with_pose_jvp(
                ts.model.means3D.detach(), ts.camera.replace(viewmatrix=view),
                ts.cfg, tw, gt_depth=ts.frame.depth, **kwm)
        ims = (j.out.color, j.out.depth[0], j.out.opacity_map[0],
               ts.frame.rgb, ts.frame.depth)
        tans = (j.color, j.depth, j.opacity_map)
        red = dict(sil_threshold=ts.tcfg.sil_threshold,
                   sqc=math.sqrt(ts.tcfg.w_color),
                   sqd=math.sqrt(ts.tcfg.w_depth), huber=ts.tcfg.huber)
        counted = int(((ims[2] > red["sil_threshold"]) & (ims[4] > 0)).sum())
        row = dict(pixels=h * w, counted=counted)
        for name, t in (("full", tans), ("cost", None)):
            got = gn.gn_reduce(*ims, tangents=t, **red)
            again = gn.gn_reduce(*ims, tangents=t, **red)
            want = gn.gn_reduce_reference(*ims, tangents=t, **red)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(got, want) if a is not None]
            ok = all(torch.allclose(a, b, rtol=1e-5,
                                    atol=1e-5 * float(b.abs().max()))
                     for a, b in zip(got, want) if a is not None)
            same = all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None)
            check(ok and same, f"gn_reduce {name} at {tag}: the plain "
                               f"version's within rtol 1e-5, and a repeat "
                               f"bit-equal")
            ms, host = timed(f"gn_reduce {name} at {tag}", {
                "kernel": lambda t=t: gn.gn_reduce(*ims, tangents=t, **red),
                "plain": lambda t=t: gn.gn_reduce_reference(
                    *ims, tangents=t, **red)})
            # bytes each pixel's mask needs (silhouette, target depth), and
            # a counted pixel's the rest: 3 + 1 + 3 primal and target, 30
            # tangent floats (full)
            nbytes = 4 * (2 * h * w + counted * (5 + (30 if t else 0)))
            nbytes_all = 4 * h * w * (9 + (30 if t else 0))
            bound = nbytes / PEAK_BYTES * 1e3
            row[name] = dict(ms=ms, host_us=host, bound_ms=bound,
                             bound_all_ms=nbytes_all / PEAK_BYTES * 1e3,
                             rel_err=errs)
            log(f"[gn] {card}: gn_reduce {name} at {tag} ({counted} of "
                f"{h * w} pixels counted): kernel "
                f"{', '.join(f'{x:.4f}' for x in ms['kernel'])} ms, plain "
                f"{', '.join(f'{x:.4f}' for x in ms['plain'])} ms; bound "
                f"{bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB; every "
                f"pixel's {nbytes_all / 1e6:.1f} MB: "
                f"{nbytes_all / PEAK_BYTES * 1e3:.4f} ms): "
                f"{min(ms['kernel']) / bound:.1f}x; host "
                f"{host['kernel']:.1f} / {host['plain']:.1f} us a call; "
                f"largest error over the largest entry {errs}")
        rows[tag] = row

    # the twist basis at the record frame's start pose and a step away
    ts = tracking_frame(device=dev)
    v0 = ts.view0
    for xi in (torch.zeros(6, device=dev),
               torch.tensor([0.01, -0.02, 0.015, 0.004, -0.003, 0.005],
                            device=dev)):
        view, tan = gn.twist_tangents(v0, xi)
        want = torch.func.jacfwd(lambda x: lie.apply_twist(v0.double(), x))(
            xi.double()).movedim(-1, 0)
        err = float((tan.double() - want).abs().max() / want.abs().max())
        check(err <= 4 * 2.0 ** -24, f"twist_tangents at |xi| "
                                     f"{float(xi.norm()):.3g}: within 4 "
                                     f"float32 ulps of jacfwd in float64 "
                                     f"({err:.3g})")

    def jacfwd_path():
        lie.apply_twist(v0, xi)
        torch.func.jacfwd(lambda x: lie.apply_twist(v0, x))(xi)

    ms, host = timed("twist_tangents", {
        "kernel": lambda: gn.twist_tangents(v0, xi),
        "plain": jacfwd_path})
    rows["twist_tangents"] = dict(ms=ms, host_us=host)
    log(f"[gn] {card}: twist_tangents kernel "
        f"{', '.join(f'{x:.4f}' for x in ms['kernel'])} ms, apply_twist + "
        f"jacfwd {', '.join(f'{x:.4f}' for x in ms['plain'])} ms (with "
        f"their host waits); host {host['kernel']:.1f} / "
        f"{host['plain']:.1f} us a call")

    # launches of a record tracked frame: one twist and one reduction an
    # iteration, and the view at each level's end
    track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg, ts.camera)
    torch.cuda.synchronize()
    gn.reset_launches()
    track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg, ts.camera)
    torch.cuda.synchronize()
    iters = ts.tcfg.coarse_iters + ts.tcfg.iters
    launches = dict(gn.launches)
    log(f"[gn] a record tracked frame ({iters} iterations, "
        f"{ts.tcfg.pyramid} levels): {launches}")
    check(launches == {"twist_tangents": iters + ts.tcfg.pyramid,
                       "gn_reduce": iters},
          "gauss_newton: one twist_tangents and one gn_reduce a Gauss-Newton "
          "iteration, one twist_tangents a level's end")
    return dict(name="gauss_newton", route="cuda",
                source="diff_gaussian_rasterization_tpu_torch/ops/kernels/"
                       "csrc/gauss_newton.cu", replaces=None, sizes=rows,
                launches_tracked_frame=launches, ptxas=gn_lines)


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
    t_main = time.time()

    def check(cond, what):
        log(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    # ---- 1. build ------------------------------------------------------
    log(f"[phase] 1 starts at +{time.time() - t_main:.1f} s")
    t0 = time.time()
    logs = _build.build_all()
    log(f"[build] {len(logs)} source(s) in {time.time() - t0:.1f} s")
    reg_lines = []
    for name, text in logs.items():
        for line in register_report(text):
            log(f"[build] {name}: {line}")
            reg_lines.append(f"{name}: {line}")

    # ---- 2. kernels against their plain versions -----------------------
    log(f"[phase] 2 starts at +{time.time() - t_main:.1f} s")
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

    # scatter_sum, the dense oracle's per-Gaussian reduction (the render
    # path no longer runs it), on the forward's pixel-level inputs keyed
    # by midx: the sorted scatter it ran there before tile_scatter_sum
    out_f, out_i = bench["out_f"], bench["out_i"]
    sc_in = (out_i[:, 2].reshape(-1), out_f[:, 8].reshape(-1),
             torch.ones(out_i[:, 2].numel(), dtype=torch.int32, device=dev))
    s_k = rows_sum.scatter_sum(*sc_in, table.shape[0])
    s_c = rows_sum.scatter_sum(*(x.cpu() for x in sc_in), table.shape[0])
    torch.cuda.synchronize()
    err_seg = float((s_k[0].cpu() - s_c[0]).abs().max())
    log(f"[kernel] scatter_sum card vs CPU: max_abs_err {err_seg}, counts "
        f"equal {bool(torch.equal(s_k[1].cpu(), s_c[1]))}")
    check(torch.equal(s_k[0].cpu(), s_c[0])
          and torch.equal(s_k[1].cpu(), s_c[1]),
          "scatter_sum on the card equals the CPU's bit for bit")
    # render_jvp on the tracking path's full-resolution dual render
    trk = tracking_kernels(dev, check)

    # ---- 3. the main path ----------------------------------------------
    log(f"[phase] 3 starts at +{time.time() - t_main:.1f} s")
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
          and counts["segment_sum_rows"] == renders
          and rows_fwd == {2: renders},
          "one tile_scatter_sum and one segment_sum_rows (F = 2) launch per "
          "render on the main path")
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
          and counts_fb["segment_sum_rows"] == 4
          and rows_fb == {2: 2, 12: 2},
          "one render_fwd, render_bwd and tile_scatter_sum and two "
          "segment_sum_rows (F = 2 and 12) launches per forward + backward "
          "step")
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
    # scatter_sum, one segment_sum_rows launch (F = 2)
    render.reset_launches()
    g_or = grads_of(render_oracle, om, ocam, ocfg, okw, wc)
    torch.cuda.synchronize()
    counts_or, rows_or = dict(render.launches), dict(render.row_launches)
    log(f"[main] the dense oracle's forward + backward, launches {counts_or}")
    check(counts_or["segment_sum_rows"] == 1 and rows_or == {2: 1}
          and counts_or["render_fwd"] == 0,
          "one segment_sum_rows launch (F = 2: its per-Gaussian sums) and no "
          "render_fwd per oracle render")
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
          and counts_map["segment_sum_rows"] == 10
          and rows_map == {2: 5, 12: 5},
          "one render_fwd, render_bwd and tile_scatter_sum and two "
          "segment_sum_rows (F = 2 and 12) launches per map_step")
    check(losses[-1] < losses[0], "the loss after five map steps is below "
                                  "step 0's")
    check(all(bool(torch.isfinite(getattr(model, f)).all())
              for f in PARAM_FIELDS) and float(dstate.denom.max()) == 5.0,
          "finite parameters and densify statistics after five map steps")
    # tracking: track_frame at bench_tracking.py's record configuration
    tracking_path(trk, dev, check)

    # ---- 4. times ------------------------------------------------------
    log(f"[phase] 4 starts at +{time.time() - t_main:.1f} s")
    render_kw = dict(max_instances=max_inst, **kw)
    fwd_t = {"100k": render_fwd_times("100k", bench, core_kw, card),
             "500k": render_fwd_times("500k", mapped, core_kw, card,
                                      plain_iters=1)}
    with torch.no_grad():
        ms_ras = time_ms(lambda: ras.rasterize(means, cam, cfg, **render_kw),
                         iters=20)
        ms_front = time_ms(lambda: ras.prepare(
            means, cam, cfg, max_inst, kw["gt_depth"], **prep_kw), iters=20)
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
    # replaced (scatter_sum: a stable sort of the instances' Gaussian ids,
    # a searchsorted and a segment_sum_rows over the sorted runs): host
    # and device together by CUDA events, and device time; scatter_sum
    # also against the CPU's, bit for bit
    keys = torch.where(binn.valid, binn.gauss_id,
                       torch.full_like(binn.gauss_id, -1))
    n_gauss = binn.gauss_start.shape[0]
    u_in = (keys, out_k.u_inst, out_k.npix_inst)
    u_old = lambda: rows_sum.scatter_sum(*u_in, n_gauss)
    u_new = lambda: rows_sum.segment_sum_rows(
        torch.stack([out_k.u_inst, out_k.npix_inst.to(torch.float32)], 1),
        binn.inv, binn.gauss_start, binn.gauss_stop)
    u_card, u_cpu = u_old(), rows_sum.scatter_sum(
        *(x.cpu() for x in u_in), n_gauss)
    check(torch.equal(u_card[0].cpu(), u_cpu[0])
          and torch.equal(u_card[1].cpu(), u_cpu[1]),
          "scatter_sum of one 100k render's uncertainty sums on the card "
          "equals the CPU's bit for bit")
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

    # ---- 5. the SLAM runner --------------------------------------------
    log(f"[phase] 5 starts at +{time.time() - t_main:.1f} s")
    slam_small(dev, check)
    log(f"[phase] 5b starts at +{time.time() - t_main:.1f} s")
    slam_errs, slam = slam_record(dev, check, card)

    # ---- 6. the reference-style API ------------------------------------
    log(f"[phase] 6 starts at +{time.time() - t_main:.1f} s")
    api_bench(check, card, means, kw, cam,
              cfg.replace(max_instances=max_inst), wc)
    log(f"[phase] 6b starts at +{time.time() - t_main:.1f} s")
    api_mapping(dev, check, cam, cfg)
    log(f"[phase] 6c starts at +{time.time() - t_main:.1f} s")
    api_examples(dev, check)

    # ---- 7. the parallel layer -----------------------------------------
    log(f"[phase] 7 starts at +{time.time() - t_main:.1f} s")
    mesh = mesh_phase(dev, check)

    # ---- 8. the exponent's basis form ----------------------------------
    log(f"[phase] 8 starts at +{time.time() - t_main:.1f} s")
    basis_entries = basis_phase(dev, check, card, reg_lines, bench, mapped,
                                core_kw, means, kw, cam, cfg, max_inst, wc,
                                model, opt, dstate, map_args)

    # ---- 9. the benchmark drivers -------------------------------------
    log(f"[phase] 9 starts at +{time.time() - t_main:.1f} s")
    t9 = time.time()
    per_step = lambda c, n: {k: v / n for k, v in c.items()}
    tile_ms = ", ".join(f"{t['fwd_bwd_tile_ms']:.3f}"
                        for t in mesh["fwd_bwd"])
    drivers = driver_phase(check, want={
        "bench": per_step(counts_fb, 2),
        "bench_tracking": per_step(trk["counts"]["light"], 1),
        "bench_mapping": per_step(counts_map, 5)}, own={
        "bench": f"forward + backward at 100k {ms_fb:.3f} ms (phase 4, "
                  f"CUDA events over 10 calls; phase 3's loss, every leaf's "
                  f"gradient)",
        "bench_ranks2": f"tile-sharded forward + backward a rank "
                        f"{tile_ms} ms (phase 7, CUDA events; binning not "
                        f"sharded)",
        "bench_tracking": f"tracked frame {trk['ms_track']:.3f} ms (phase "
                          f"4, CUDA events over 5 frames)",
        "bench_mapping": f"map_step at 500k {ms_map:.3f} ms (phase 4, CUDA "
                         f"events over 3 steps)"})
    log(f"[phase] 9 took {time.time() - t9:.1f} s")

    # ---- 10. the profiling tools ---------------------------------------
    log(f"[phase] 10 starts at +{time.time() - t_main:.1f} s")
    t10 = time.time()
    profs = prof_phase(check, per_step(counts_fb, 2), per_step(rows_fb, 2),
                       dev)
    log(f"[phase] 10 took {time.time() - t10:.1f} s")

    # ---- 11. the preprocess kernel pair -----------------------------
    log(f"[phase] 11 starts at +{time.time() - t_main:.1f} s")
    prep_entry = preprocess_phase(dev, check, card)

    # ---- 12. the pose tangents' kernel ----------------------------------
    log(f"[phase] 12 starts at +{time.time() - t_main:.1f} s")
    tangent_entry = tangent_phase(dev, check, card, reg_lines)

    # ---- 13. tracking's Gauss-Newton kernels ---------------------------
    log(f"[phase] 13 starts at +{time.time() - t_main:.1f} s")
    gn_entry = gauss_newton_phase(dev, check, card, reg_lines)

    # the largest errors over both scales' comparisons and the SLAM run's
    err_fwd, err_bwd, err_rows, err_u, err_ts = (
        max(bench[k], mapped[k], slam_errs[k])
        for k in ("err_fwd", "err_bwd", "err_rows", "err_u", "err_ts"))
    # the SLAM run tracks with the light variant
    for e in jvp_entries:
        if e["name"] == "render_jvp":
            e["max_abs_err"] = max(e["max_abs_err"], slam_errs["err_jvp"])
    kernels = [dict(name=name, route="cuda",
                    source="diff_gaussian_rasterization_tpu_torch/ops/"
                           "kernels/csrc/render_fwd.cu",
                    replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                             "render_pallas.py:157",
                    launches=n, max_abs_err=err_fwd, **fwd_t[tag])
               # the renders of the forward; the map steps' renders
               for name, tag, n in (
                   ("render_fwd", "100k", counts["render_fwd"]),
                   ("render_fwd_500k", "500k", counts_map["render_fwd"]))
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
         ] + jvp_entries + basis_entries + [prep_entry, tangent_entry,
                                            gn_entry]
    log(f"[phase] done at +{time.time() - t_main:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"slam": slam}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"drivers": {
        tag: {k: d.get(k) for k in ("value", "mean_ms", "median_ms",
                                    "min_ms", "max_ms", "spread", "seconds")}
        for tag, d in drivers.items()}}))
    log(json.dumps({"prof": profs}))
    if failures:
        log(f"FAILED: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
