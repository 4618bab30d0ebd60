"""Benchmark: SLAM tracking steps per second at 1200x680 (the PyTorch port
of the JAX package's root ``bench_tracking.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.bench_tracking \\
        [--samples 9] [--inner 1] [--gaussians 100000] \\
        [--device cuda | --cpu]

The tracking benchmark's frame (``scenes.tracking_frame``: the mapping
model with 100,000 Gaussians rendered at the identity pose, 32x32 tiles,
a budget of 1.1x the frame's instance count) tracked by ``track_frame``
from the start pose ``apply_twist(I, TRACKING_XI)`` under the record
``TrackingConfig`` that ``tracking_frame`` returns: Gauss-Newton, 2
full-resolution and 3 half-resolution iterations, frozen binning with a
2 px margin, deferred accept.  The JAX driver's ``DGR_TRACK_*`` A/B
settings have no flags here: an A/B run builds its ``TrackingConfig`` in
code.  A sample is ``--inner`` tracked frames, each from the start pose,
timed as ``bench`` times its samples, after one warm-up frame.

Prints one JSON line on stdout: ``{"metric":
"tracking_steps_per_sec_1200x680", "value": ..., "unit": "tracked
frames/s", ...}`` with the configuration, ``ms_per_tracked_frame`` (the
mean, as ``bench``'s), the samples, and ``pose_err_before`` /
``pose_err_after`` (the largest entry of |view - I| at the start pose and
after the warm-up frame).  Exits non-zero unless tracking reduces the pose error.
"""

import argparse

from .bench import (Stages, build_kernels, common_args, device_fields, emit,
                    launch_counts, note, run_device, sample_ms, summary)

METRIC = "tracking_steps_per_sec_1200x680"
UNIT = "tracked frames/s"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=9, inner=1)
    return ap.parse_args(argv)


def pose_err(view, ref) -> float:
    return float((view - ref).abs().max())


def main(argv=None):
    args = parse_args(argv)
    device = run_device(args)
    stages = Stages()
    build_kernels(device, stages)
    from ..models.slam import track_frame
    from ..ops.kernels import render
    from ..scenes import tracking_frame

    ts = tracking_frame(p=args.gaussians, height=args.height,
                        width=args.width, device=device)
    tcfg = ts.tcfg
    stages("scene_s")
    note("bench_tracking", f"{args.gaussians} gaussians at {args.width}x"
                           f"{args.height}, {tcfg}; warm-up")

    def track():
        return track_frame(ts.model, ts.view0, ts.frame, ts.cfg, tcfg,
                           ts.camera)[0]

    def run():
        for _ in range(args.inner):
            track()

    ref = ts.camera.viewmatrix
    err0, err = pose_err(ts.view0, ref), pose_err(track(), ref)
    stages("warmup_s")
    render.reset_launches()
    ms = sample_ms(run, device, args.samples, args.inner)
    launches = launch_counts(args.samples * args.inner)
    stages("measure_s")
    s = summary(ms)
    line = dict(
        metric=METRIC, value=s.pop("value"), unit=UNIT, method=tcfg.method,
        iters=tcfg.iters, freeze_binning=tcfg.freeze_binning,
        bin_margin_px=tcfg.bin_margin_px, line_search=tcfg.line_search,
        pyramid=tcfg.pyramid, coarse_iters=tcfg.coarse_iters,
        gaussians=args.gaussians, res=f"{args.width}x{args.height}",
        ms_per_tracked_frame=s["mean_ms"], pose_err_before=err0,
        pose_err_after=err, **s, inner=args.inner,
        max_instances=ts.cfg.max_instances, launches=launches,
        stages=dict(stages), **device_fields(device))
    if not err < err0:
        line["error"] = (f"tracking did not reduce the pose error "
                         f"({err0} -> {err})")
    emit(line)
    if "error" in line:
        raise SystemExit(f"bench_tracking: {line['error']}")
    return line


if __name__ == "__main__":
    main()
