#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``diff_gaussian_rasterization_tpu_torch``), never JAX, at
the scale the repository measures: 100,000 Gaussians at 1200x680 with 32x32
tiles.  Phases:

1. build every CUDA kernel from ``ops/kernels/csrc`` (one nvcc per source,
   all started together) and print the compiler's register report;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, and print the largest errors;
3. drive the main path through the entry points a user calls
   (``rasterize`` with precomputed colors, ``render_model`` on an SH-3
   model from four poses), with every launch counter set to 0 just before
   and read just after; check finite outputs, no overflow, the instance
   count, one ``render_fwd`` launch per render and bit-equal repeat
   renders, and the card's render against the CPU path on a small scene;
4. time each kernel, its plain version and its bound, the whole forward
   ``rasterize`` and preprocess + binning, with CUDA events, and list the
   forward's device time by kernel with torch.profiler.

Prints the card's name and power limit, a ``kernels`` JSON line, and last
the line ``{"ok": true, "device": {...}}``.  Exits non-zero, without that
line, when there is no CUDA device or any phase fails.
"""

import json
import subprocess
import sys
import time

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
    from diff_gaussian_rasterization_tpu_torch.models.slam import render_model
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import _build
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
    from diff_gaussian_rasterization_tpu_torch.scenes import (
        bench_camera, bench_scene, orbit_view, random_model)

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
    out_k = render.core_fwd(table, binn.tile_start, binn.tile_stop, gt_tiles,
                            **core_kw)
    out_p = render.core_fwd_reference(table, binn.tile_start, binn.tile_stop,
                                      gt_tiles, **core_kw)
    torch.cuda.synchronize()
    err_fwd, rep, ok = compare_core(out_k, out_p)
    log("[kernel] render_fwd vs plain: " + json.dumps(rep))
    check(ok, "render_fwd matches its plain version (rtol 1e-4, atol 2e-5 "
              "on agreeing pixels; integer mismatch < 5e-3)")

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
