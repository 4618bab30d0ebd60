#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``diff_gaussian_rasterization_tpu_torch``), never JAX, at
the scale the repository measures: 100,000 Gaussians at 1200x680 with 32x32
tiles for rendering and its gradient, and the mapping benchmark's 500,000
Gaussians (``bench_mapping.py`` of the JAX package) for mapping steps.
Phases:

1. build every CUDA kernel from ``ops/kernels/csrc`` (one nvcc per source,
   all started together) and print the compiler's register report;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, and print the largest errors: on the 100k
   bench scene here, and (in phase 3, before the mapping steps) on the
   first mapping step's render at 500k, the gradient rows also against
   the plain version in float64;
3. drive the main paths through the entry points a user calls, each with
   every launch counter set to 0 just before and read just after: the
   forward (``rasterize`` with precomputed colors, ``render_model`` on an
   SH-3 model from four poses; finite outputs, no overflow, the instance
   count, one ``render_fwd`` launch per render, bit-equal repeat renders,
   the card against the CPU path on a small scene); forward + backward
   ``rasterize`` (one ``render_fwd``, ``render_bwd`` and
   ``segment_sum_rows`` launch per step, finite gradients for every leaf
   and the view matrix, bit-equal repeat backwards, the card's gradients
   against the port's dense ``render_oracle`` and against the CPU path in
   float64 on small scenes); and five ``map_step``s at 500k, whose loss
   must fall;
4. time each kernel, its plain version, its bound and the one PyTorch call
   that computes the same function, the whole forward, forward + backward
   and a mapping step, with CUDA events, and list the device time of the
   forward and of forward + backward by kernel with torch.profiler.

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
# more for each pair that contributes.
OPS_PER_PAIR = 24
OPS_PER_CONTRIB = 20
# The backward walks the same pairs; for each contributing pair, besides
# the forward's test: w, d^2, the dot product s (11), the prefix (2),
# d_alpha with one reciprocal counted as 8 (~13), e, and the twelve
# per-instance terms (~29): ~58.
OPS_PER_CONTRIB_BWD = 58
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
    """The least time the card could take for this run's blend: the pairs
    each pixel must evaluate (a pixel whose final transmittance is >= 1e-2
    can never have terminated, so it walked its whole segment; any other
    pixel walked at least to its last contributor + 1), against the FP32
    peak; and the bytes (features of the instances in segments, ranges,
    ground truth, outputs), against HBM bandwidth."""
    import torch
    seg = (tile_stop - tile_start).to(torch.int64)[:, None]
    walked = torch.where(out.t_final >= 1e-2, seg,
                         torch.minimum(out.n_contrib.to(torch.int64) + 1,
                                       seg))
    pairs = int(torch.where(pixmask, walked, torch.zeros_like(walked)).sum())
    contribs = int(out.n_valid.to(torch.int64).sum())
    ops = pairs * OPS_PER_PAIR + contribs * OPS_PER_CONTRIB
    t, q = out.depth.shape
    n_inst = int(seg.sum())
    nbytes = n_inst * 11 * 4 + t * 2 * 4 + t * q * 4 + t * q * 12 * 4
    ms_ops, ms_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    info = dict(pairs=pairs, contributions=contribs, ops=ops, bytes=nbytes)
    if ms_ops >= ms_bytes:
        return ms_ops, "operations", info
    return ms_bytes, "bytes", info


def render_bwd_bound_ms(pairs, contribs, n_inst, n_tiles, q):
    """The backward's least time: the forward's pairs and the backward's
    operations per contribution over the FP32 peak; the bytes (features,
    ranges, the per-pixel constants, the rows written) over HBM."""
    ops = pairs * OPS_PER_PAIR + contribs * OPS_PER_CONTRIB_BWD
    nbytes = (n_inst * 11 * 4 + n_tiles * 2 * 4 + n_tiles * q * 10 * 4
              + n_inst * 12 * 4)
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
    """``render_fwd``, ``render_bwd`` and ``segment_sum_rows`` against their
    plain versions on one render's sorted table and binning, the backward
    with standard-normal cotangents from a generator seeded with ``seed``.
    Returns the largest errors and what phase 4 reuses."""
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
                             **core_kw)
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
    return dict(out_k=out_k, pix=pix, rows_k=rows_k, err_fwd=err_fwd,
                err_bwd=err_bwd, err_rows=err_rows)


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
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # kernel-level events only: the operator-level ones repeat their time
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    lines = [f"{dev_us(e) / 1e3 / n:9.4f} ms/call  x{e.count // n:<4d} "
             f"{e.key[:90]}" for e in rows[:top]]
    return wall_ms / n, busy_ms / n, lines


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

    # segment_sum on the main path's pixel-level inputs: the per-pixel
    # ucross (not a CoreOutputs field) from one more raw launch
    out_f = torch.empty((gt_tiles.shape[0], 9, cfg.tile_px), device=dev)
    out_i = torch.empty((gt_tiles.shape[0], 3, cfg.tile_px),
                        dtype=torch.int32, device=dev)
    render.launch_render_fwd(table, binn.tile_start, binn.tile_stop,
                             gt_tiles, out_f, out_i, **core_kw)
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
    counts = dict(render.launches)
    log(f"[main] {renders} renders, launches {counts}")
    check(counts["render_fwd"] == renders,
          "one render_fwd launch per render on the main path")
    check(counts["segment_sum"] == 2 * renders,
          "two segment_sum launches per render on the main path")
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
    counts_fb = dict(render.launches)
    log(f"[main] 2 forward + backward steps, launches {counts_fb}")
    check(all(counts_fb[k] == 2 for k in ("render_fwd", "render_bwd",
                                           "segment_sum_rows")),
          "one render_fwd, render_bwd and segment_sum_rows launch per "
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
    g_or = grads_of(render_oracle, om, ocam, ocfg, okw, wc)
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
    del mbinn, mfeat, mgt
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
    counts_map = dict(render.launches)
    log(f"[map] {int(probe.num_rendered)} instances (budget {map_inst}); "
        f"losses {losses}; launches {counts_map}")
    check(all(counts_map[k] == 5 for k in ("render_fwd", "render_bwd",
                                           "segment_sum_rows")),
          "one render_fwd, render_bwd and segment_sum_rows launch per "
          "map_step")
    check(losses[-1] < losses[0], "the loss after five map steps is below "
                                  "step 0's")
    check(all(bool(torch.isfinite(getattr(model, f)).all())
              for f in PARAM_FIELDS) and float(dstate.denom.max()) == 5.0,
          "finite parameters and densify statistics after five map steps")

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
    ms_seg = time_ms(lambda: render.segment_sum(seg_vals, seg_ones, bounds),
                     iters=50)
    ms_seg_plain = time_ms(lambda: render.segment_sum_reference(
        seg_vals, seg_ones, bounds), iters=20)
    seg_ids = torch.repeat_interleave(
        torch.arange(table.shape[0], device=dev),
        (bounds[1:] - bounds[:-1]).to(torch.int64))
    lib_in = seg_vals[:seg_ids.shape[0]]
    ms_seg_lib = time_ms(lambda: torch.zeros(
        table.shape[0], device=dev).index_add_(0, seg_ids, lib_in), iters=50)
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
    log(f"[time] {card}: segment_sum kernel {ms_seg:.4f} ms on "
        f"{n_vals} values / {n_seg} segments (bound {bound_seg:.4f} ms by "
        f"bytes), plain {ms_seg_plain:.4f} ms, index_add_ {ms_seg_lib:.4f} ms")
    log(f"[time] {card}: whole forward rasterize {ms_ras:.3f} ms, "
        f"preprocess + binning {ms_front:.3f} ms")

    rows_buf = torch.zeros_like(rows_k)
    start, stop = binn.tile_start, binn.tile_stop
    inv, gs, ge = binn.inv, binn.gauss_start, binn.gauss_stop
    n_tiles, q = gt_tiles.shape
    ms_bwd = time_ms(lambda: render.launch_render_bwd(
        table, start, stop, pix, rows_buf, **core_kw), iters=20)
    ms_bwd_plain = time_ms(lambda: render.core_bwd_reference(
        table, start, stop, pix, **core_kw), iters=2, warmup=1)
    n_seg_inst = int((stop - start).sum())
    bound_bwd, by_bwd, bbinfo = render_bwd_bound_ms(
        binfo["pairs"], binfo["contributions"], n_seg_inst, n_tiles, q)
    ms_rows = time_ms(lambda: rows_sum.segment_sum_rows(rows_k, inv, gs, ge),
                      iters=50)
    ms_rows_plain = time_ms(lambda: rows_sum.segment_sum_rows_reference(
        rows_k, inv, gs, ge), iters=20)
    run_g, run_j = rows_sum.runs(gs, ge)
    gathered = rows_k[inv.to(torch.int64)[run_j]]
    n_gauss = gs.shape[0]
    ms_rows_lib = time_ms(lambda: torch.zeros(
        (n_gauss, 12), device=dev).index_add_(0, run_g, gathered), iters=50)
    m_runs = run_j.shape[0]
    bound_rows = (m_runs * 12 * 4 + m_runs * 4 + n_gauss * 8
                  + n_gauss * 12 * 4) / PEAK_BYTES * 1e3
    log(f"[time] {card}: render_bwd kernel {ms_bwd:.4f} ms (bound "
        f"{bound_bwd:.4f} ms by {by_bwd}: {json.dumps(bbinfo)}), plain "
        f"version {ms_bwd_plain:.3f} ms")
    log(f"[time] {card}: segment_sum_rows kernel {ms_rows:.4f} ms on "
        f"{m_runs} rows / {n_gauss} Gaussians (bound {bound_rows:.4f} ms by "
        f"bytes), plain {ms_rows_plain:.4f} ms, index_add_ of the gathered "
        f"rows {ms_rows_lib:.4f} ms")
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

    # the largest errors over both scales' comparisons
    err_fwd, err_bwd, err_rows = (max(bench[k], mapped[k]) for k in
                                  ("err_fwd", "err_bwd", "err_rows"))
    kernels = [
        dict(name="render_fwd", route="cuda",
             source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                    "render_fwd.cu",
             replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                      "render_pallas.py:157",
             launches=counts["render_fwd"], max_abs_err=err_fwd,
             ms=ms_fwd, plain_ms=ms_plain, bound_ms=bound_fwd,
             bound_by=by_fwd, library_ms=None),
        dict(name="segment_sum", route="cuda",
             source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                    "render_fwd.cu",
             replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                      "render_pallas.py:390",
             launches=counts["segment_sum"], max_abs_err=err_seg,
             ms=ms_seg, plain_ms=ms_seg_plain, bound_ms=bound_seg,
             bound_by="bytes", library_ms=ms_seg_lib),
        dict(name="render_bwd", route="cuda",
             source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                    "render_bwd.cu",
             replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                      "render_pallas.py:717",
             launches=counts_fb["render_bwd"], max_abs_err=err_bwd,
             ms=ms_bwd, plain_ms=ms_bwd_plain, bound_ms=bound_bwd,
             bound_by=by_bwd, library_ms=None),
        dict(name="segment_sum_rows", route="cuda",
             source="diff_gaussian_rasterization_tpu_torch/ops/kernels/csrc/"
                    "render_bwd.cu",
             replaces="diff_gaussian_rasterization_tpu/ops/kernels/"
                      "segment_sum.py:43",
             launches=counts_fb["segment_sum_rows"], max_abs_err=err_rows,
             ms=ms_rows, plain_ms=ms_rows_plain, bound_ms=bound_rows,
             bound_by="bytes", library_ms=ms_rows_lib),
    ]
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
