"""Per-op device time of a first-order tracked frame on the card (the
PyTorch port of the JAX package's root ``prof_track.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.prof_track \\
        [OUTDIR] [--inner 2] [--samples 1] \\
        [--gaussians 100000] [--height 680] [--width 1200] \\
        [--device cuda | --cpu]

``track_frame`` with ``TrackingConfig(method="adam", iters=24)`` on the
tracking benchmark's frame (``scenes.tracking_frame``: the mapping model
with 100,000 Gaussians rendered at the identity pose, 32x32 tiles, a
budget of 1.1x its instance count), from the start pose that
``prof_track.py:32-33`` tracks from (``scenes.TRACKING_XI``).  A step is
one tracked frame; after one warm-up frame it is timed, profiled (the
trace in ``OUTDIR/prof_track.json``, the program's spans and counters in
``spans``) and its host waits counted as ``prof_trace`` does (the
trace's default directory is ``prof_trace``'s),
and the table's top 30 rows, as the JAX tool prints them, on stderr with
one JSON line on stdout.
"""

import sys

from .bench import emit, note
from .prof import start
from .prof_trace import parse_args as trace_args, profiled

TOP = 30  # the table's rows, as the JAX tool prints them


def parse_args(argv=None):
    return trace_args(argv, inner=2, samples=1)


def main(argv=None):
    from ..models.slam import TrackingConfig, track_frame
    from ..scenes import tracking_frame
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device, fields = start(args)
    ts = tracking_frame(p=args.gaussians, height=args.height,
                        width=args.width, device=device)
    tcfg = TrackingConfig(method="adam", iters=24)

    def step():
        return track_frame(ts.model, ts.view0, ts.frame, ts.cfg, tcfg,
                           ts.camera)

    step()
    note("prof_track", f"{args.gaussians} gaussians at {args.width}x"
                       f"{args.height}, {tcfg}; {args.samples} samples of "
                       f"{args.inner} frames, then {args.inner} profiled")
    line = dict(tool="prof_track", **profiled("prof_track", step, args,
                                              device, "frame", TOP),
                method=tcfg.method, iters=tcfg.iters,
                max_instances=ts.cfg.max_instances, gaussians=args.gaussians,
                res=f"{args.width}x{args.height}", inner=args.inner,
                samples=args.samples, **fields)
    emit(line)
    return line


if __name__ == "__main__":
    main()
