"""Binning's sub-stages on the card (the PyTorch port of the JAX package's
root ``prof_bin.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.prof_bin \\
        [--samples 3] [--inner 8] [--gaussians 100000] [--height 680] \\
        [--width 1200] [--device cuda | --cpu]

Times prefix pipelines of ``ops/binning.py::bin_gaussians`` on the bench
scene, each through its own stages (``binning.expand``, ``sort_order``,
``tile_ranges``, ``inverse_permutation``), so each stage's cost is the
difference between two successive prefixes:

  s1   preprocess
  s2   + the expansion: the prefix sum, ``searchsorted``, the tile
       coordinates and the exact ellipse cull
  s3   + the two stable sorts, by depth and then by tile
  s3b  s2 + one sort on a packed ``tile << 22 | quantized depth`` key, as
       the JAX tool measures it (off the path: ``bin_gaussians`` sorts by
       the exact depth; s4 follows s3)
  s4   + ``tile_start`` / ``tile_stop``
  s5   + the inverse permutation
  s6   + the feature gather into the kernels' table [I, 11]

The port bins unaligned: the JAX tool's "s5 align scatter", which moved
every tile's segment onto the TPU kernels' 128-instance blocks, and its
"s6b" fused gather into the TPU's planar blocks, have no counterpart.
s6's table and tile ranges are ``bin_gaussians`` + the gather's, bit for
bit.  A sample chains ``--inner`` pipelines, each fed the means moved by
1e-30 times a sum of the last one's newest output, and each stage is timed
as ``examples/prof.py`` times its stages (host clock and device split;
``diff_host_ms`` / ``diff_device_ms`` are the differences to the prefix
before).  One JSON line a stage on stdout.
"""

import argparse
import sys

from .bench import common_args, emit, note, scene
from .prof import prep_kwargs, start, time_stage

# each stage: (name, the prefix it extends)
STAGES = (("s1 preprocess", None), ("s2 +expand", "s1 preprocess"),
          ("s3 +sort (2 stable)", "s2 +expand"),
          ("s3b +sort (packed key)", "s2 +expand"),
          ("s4 +ranges", "s3 +sort (2 stable)"),
          ("s5 +inverse", "s4 +ranges"), ("s6 +gather", "s5 +inverse"))
DEPTH_BITS = 22  # the packed key's quantized depth (the JAX tool's)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=3, inner=8)
    return ap.parse_args(argv)


def pipelines(kw, cam, cfg):
    """Each stage's prefix pipeline, ``means -> outputs`` (a dict whose
    ``"last"`` is the stage's newest output), by name."""
    import torch

    from ..ops import binning
    from ..ops.projection import preprocess
    from ..ops.rasterize import feature_table
    from ..ops.tiling import grid_dims
    prep_kw = prep_kwargs(kw)
    tiles_x, tiles_y = grid_dims(cam.height, cam.width, cfg.tile_h,
                                 cfg.tile_w)
    num_tiles = tiles_x * tiles_y

    def s1(m):
        prep = preprocess(m, cam, cfg, **prep_kw)
        return dict(prep=prep, last=prep.depth)

    def s2(m):
        o = s1(m)
        o["ex"] = binning.expand(
            o["prep"], tiles_x, tiles_y, cfg.max_instances,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h, alpha_min=cfg.alpha_min,
            margin_px=cfg.bin_margin_px)
        o["last"] = o["ex"].tile
        return o

    def s3(m):
        o = s2(m)
        ex = o["ex"]
        o["order"] = binning.sort_order(ex.tile, ex.depth)
        o["tile_s"] = ex.tile[o["order"]].to(torch.int32)
        o["g_s"] = o["last"] = ex.g[o["order"]]
        return o

    def s3b(m):
        o = s2(m)
        ex = o["ex"]
        dq = torch.clamp_max((ex.depth * (float(1 << DEPTH_BITS) / 10.0))
                             .to(torch.int64), (1 << DEPTH_BITS) - 1)
        key_s, idx = torch.sort((ex.tile << DEPTH_BITS) | dq, stable=True)
        o["tile_s"] = (key_s >> DEPTH_BITS).to(torch.int32)
        o["g_s"] = o["last"] = ex.g[idx]
        return o

    def s4(m):
        o = s3(m)
        o["tile_start"], o["tile_stop"] = binning.tile_ranges(o["tile_s"],
                                                              num_tiles)
        o["last"] = o["tile_stop"]
        return o

    def s5(m):
        o = s4(m)
        o["inv"] = o["last"] = binning.inverse_permutation(o["order"])
        return o

    def s6(m):
        o = s5(m)
        o["table"] = o["last"] = feature_table(o["prep"])[o["g_s"]] \
            .contiguous()
        return o

    return dict(zip((name for name, _ in STAGES),
                    (s1, s2, s3, s3b, s4, s5, s6)))


def main(argv=None):
    import torch
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device, fields = start(args)
    means, kw, cam, cfg = scene(args, device)
    note("prof_bin", f"{args.gaussians} gaussians at {args.width}x"
                     f"{args.height}, budget {cfg.max_instances}")
    fns = pipelines(kw, cam, cfg)
    lines = {}
    for name, before in STAGES:
        note("prof_bin", f"{name}: {args.samples} samples of {args.inner}")
        fn = fns[name]
        step = torch.no_grad()(
            lambda m, fn=fn: m + 1e-30 * fn(m)["last"].sum().to(m.dtype))
        t = time_stage(step, means, args, device)
        prev = lines.get(before)
        diff = lambda k: None if prev is None or t[k] is None \
            else t[k] - prev[k]
        lines[name] = dict(tool="prof_bin", stage=name, **t,
                           diff_host_ms=diff("host_ms"),
                           diff_device_ms=diff("device_ms"),
                           max_instances=cfg.max_instances,
                           gaussians=args.gaussians,
                           res=f"{args.width}x{args.height}",
                           inner=args.inner, samples=args.samples, **fields)
        emit(lines[name])
    return list(lines.values())


if __name__ == "__main__":
    main()
