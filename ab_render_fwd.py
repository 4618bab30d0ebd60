#!/usr/bin/env python3
"""A/B the port's ``render_fwd`` kernel against other versions of its source
on one NVIDIA GPU.

    python3 ab_render_fwd.py BASELINE [BASELINE ...]

Each BASELINE is a directory holding a ``render_fwd.cu`` (and the headers
it includes), for example the ``ops/kernels/csrc`` of a ``git archive`` of
an older commit, or a copy of this checkout's with a constant changed.
Every baseline is built with this checkout's nvcc flags (one nvcc per
source, all started together) and its register report printed.  Then, on
the scenes ``chip_smoke.py`` measures -- the bench scene (100,000
Gaussians, 1200x680, 32x32 tiles) and the first map step's render of the
500,000-Gaussian mapping model -- each baseline's outputs are held bit for
bit against this checkout's kernel, and every version is timed by CUDA
events in turns (this checkout, the baselines, then the same in reverse),
beside the card's name and power limit.

An older ``render_fwd`` entry point without the trailing pair-counter
argument is recognised from its source and called without it.  Exits
non-zero when there is no CUDA device or a baseline's outputs differ.
"""

import ctypes
import os
import re
import subprocess
import sys
import time


def entry_signature(src: str):
    """Whether the source's ``render_fwd`` C entry point takes the pair
    counter before the stream, and whether it takes the first tile's
    index ``tile0`` after ``tiles_x`` (16 parameters without either, 17
    with the counter, 18 with both)."""
    m = re.search(r'extern "C" int render_fwd\((.*?)\)', src, re.S)
    if m is None:
        raise ValueError("no render_fwd entry point in the source")
    tile0 = "int tile0" in m.group(1)
    return m.group(1).count(",") + 1 - tile0 == 17, tile0


def main(baselines):
    import torch
    if not torch.cuda.is_available():
        print("ab_render_fwd: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        render_model)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        _build, render)
    from diff_gaussian_rasterization_tpu_torch.scenes import (
        bench_camera, bench_scene, mapping_model)

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"card: {card}")
    for line in cs.register_report(_build.build_all(["render_fwd"])
                                   ["render_fwd"]):
        cs.log(f"[build] this checkout: {line}")
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for i, base in enumerate(baselines):
        src = os.path.join(base, "render_fwd.cu")
        so = os.path.abspath(os.path.join(out_dir, f"base{i}_{os.getpid()}.so"))
        jobs[base] = (so, *entry_signature(open(src).read()),
                      subprocess.Popen(
                          [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           src], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for base, (so, pairs, tile0, proc) in jobs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {base}:\n{log_text}")
        for line in cs.register_report(log_text):
            if line.startswith("render_fwd_kernel"):
                cs.log(f"[build] {base}: {line}")
        lib = ctypes.CDLL(so)
        lib.render_fwd.argtypes = ([P] * 6 + [I] * (7 if tile0 else 6)
                                   + [F] * 3 + [P] * (2 if pairs else 1))
        lib.render_fwd.restype = I
        libs[base] = (lib, pairs, tile0)

    def launcher(base, table, start, stop, gt, out_f, out_i, cfg, tiles_x,
                 height, width):
        lib, pairs, tile0 = libs[base]
        extra = (None,) if pairs else ()
        first = (0,) if tile0 else ()

        def go():
            rc = lib.render_fwd(
                table.data_ptr(), start.data_ptr(), stop.data_ptr(),
                gt.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
                start.shape[0], tiles_x, *first, cfg.tile_w, cfg.tile_h,
                width,
                height, cfg.alpha_cap, cfg.alpha_min, cfg.t_terminate,
                *extra, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{base}: render_fwd launch failed: "
                                   f"CUDA error {rc}")
        return go

    same = True

    def compare(tag, table, start, stop, gt, core_kw):
        nonlocal same
        n_tiles, q = gt.shape
        bufs = lambda: (torch.empty((n_tiles, 9, q), device=dev),
                        torch.empty((n_tiles, 3, q), dtype=torch.int32,
                                    device=dev))
        ref_f, ref_i = bufs()
        fns = {"this checkout": lambda: render.launch_render_fwd(
            table, start, stop, gt, ref_f, ref_i, **core_kw)}
        fns["this checkout"]()
        for base in baselines:
            out_f, out_i = bufs()
            fns[base] = launcher(base, table, start, stop, gt, out_f, out_i,
                                 **core_kw)
            fns[base]()
            torch.cuda.synchronize()
            equal = torch.equal(out_f, ref_f) and torch.equal(out_i, ref_i)
            same &= equal
            cs.log(f"[{tag}] {base}: outputs bit-equal to this checkout's: "
                   f"{equal}")
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k].append(cs.time_ms(fns[k], iters=50))
        for k, v in times.items():
            cs.log(f"[{tag}] {card}: {k}: render_fwd "
                   + ", ".join(f"{x:.4f}" for x in v) + " ms")

    cfg = RasterConfig(tile_h=32, tile_w=32)
    means, kw = bench_scene(device=dev)
    cam = bench_camera(device=dev)
    h, w = cam.height, cam.width
    core_kw = dict(cfg=cfg, tiles_x=-(-w // cfg.tile_w), height=h, width=w)
    n_inst = int(ras.count_instances(means, cam, cfg, **kw))
    prep_kw = {k: v for k, v in kw.items() if k not in ("bg", "gt_depth")}
    _, binn, feat, gt_tiles = ras.prepare(
        means, cam, cfg, int(-(-n_inst * 1.1 // 1024) * 1024),
        kw["gt_depth"], **prep_kw)
    compare("100k", feat[binn.gauss_id].contiguous(), binn.tile_start,
            binn.tile_stop, gt_tiles, core_kw)
    del feat, gt_tiles
    model = mapping_model(device=dev)
    with torch.no_grad():
        probe = render_model(model, cam, cfg)
        budget = int(-(-int(probe.num_rendered) * 1.1 // 1024) * 1024)
        _, mbinn, mfeat, mgt = ras.prepare(
            model.means3D, cam, cfg, budget, probe.depth[0],
            **model.raster_kwargs())
    compare("500k", mfeat[mbinn.gauss_id].contiguous(), mbinn.tile_start,
            mbinn.tile_stop, mgt, core_kw)
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    t0 = time.time()
    rc = main(sys.argv[1:])
    print(f"ab_render_fwd: {time.time() - t0:.1f} s", flush=True)
    sys.exit(rc)
