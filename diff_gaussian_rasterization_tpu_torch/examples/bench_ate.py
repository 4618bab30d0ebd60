"""ATE benchmark of the port's SLAM on a Replica-class procedural sequence
(the PyTorch port of the JAX package's ``examples/bench_ate.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.bench_ate

A procedurally generated room at real scale (textured walls and occluding
furniture, ``io.synthetic.replica_like_model``), rendered along a
walkthrough with rotation-dominant pan segments and sensor noise on RGB
and depth, then tracked and mapped by the full SLAM loop (exact
Gauss-Newton tracking through the pose JVP, keyframed mapping,
pose-graph refinement) on ``--device`` (default ``cuda``).  The defaults
are the JAX package's record configuration: 120 frames at 240x320.

Prints progress on stderr and, last, one JSON line:
``{"metric": "ate_rmse_cm", "value": ..., ...}``.
"""

import argparse
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--res", default="240x320")
    ap.add_argument("--wall-res", type=int, default=56)
    ap.add_argument("--method", default="gn",
                    choices=["gn", "gn_fd", "adam"])
    ap.add_argument("--track-iters", type=int, default=10)
    ap.add_argument("--pyramid", type=int, default=2)
    ap.add_argument("--coarse-iters", type=int, default=4)
    ap.add_argument("--map-iters", type=int, default=30)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--refine-every", type=int, default=4)
    ap.add_argument("--refine-cost-gate", type=float, default=0.0)
    ap.add_argument("--kf-every", type=int, default=3)
    ap.add_argument("--track-w-depth", type=float, default=1.5)
    ap.add_argument("--kf-coverage", type=float, default=0.0)
    ap.add_argument("--window-select", default="nearest",
                    choices=["nearest", "random"])
    ap.add_argument("--coverage-map-iters", type=int, default=0)
    ap.add_argument("--kf-cooldown", type=int, default=0,
                    help="cooldown (frames) on the coverage keyframe "
                         "trigger; see SLAMConfig.kf_coverage_cooldown")
    ap.add_argument("--reloc-spike", type=float, default=0.0,
                    help="re-track from nearest keyframes when the GN cost "
                         "spikes past this factor of the recent median")
    ap.add_argument("--reloc-candidates", type=int, default=2)
    ap.add_argument("--lr-decay", type=float, default=0.7,
                    help="geometry LR decay per --lr-decay-steps map steps")
    ap.add_argument("--lr-decay-steps", type=int, default=300)
    ap.add_argument("--freeze-binning", action="store_true",
                    help="bin once per tracked frame, reuse across GN "
                         "iterations (bin-margin px of slack)")
    ap.add_argument("--bin-margin", type=float, default=8.0)
    ap.add_argument("--no-line-search", action="store_true",
                    help="deferred-accept GN: one dual render per iteration")
    ap.add_argument("--capacity", type=int, default=120_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rgb-noise", type=float, default=0.01)
    ap.add_argument("--depth-noise", type=float, default=0.005)
    ap.add_argument("--no-refine", action="store_true")
    ap.add_argument("--final-retrack", type=int, default=0,
                    help="offline polish: re-track every frame against the "
                         "final map with this many exact-GN iterations "
                         "(reports both online and polished ATE)")
    ap.add_argument("--close-loop", action="store_true",
                    help="complete one full circuit within --frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the whole run (cuda or cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    return ap.parse_args(argv)


def slam_config(args):
    """The run's SLAMConfig from the command line."""
    from ..config import RasterConfig
    from ..models.runner import SLAMConfig
    from ..models.slam import MappingConfig, TrackingConfig
    return SLAMConfig(
        raster=RasterConfig(tile_h=8, tile_w=16, chunk=32),
        tracking=TrackingConfig(iters=args.track_iters, method=args.method,
                                sil_threshold=0.85,
                                w_depth=args.track_w_depth,
                                pyramid=args.pyramid,
                                coarse_iters=args.coarse_iters,
                                freeze_binning=args.freeze_binning,
                                bin_margin_px=args.bin_margin,
                                line_search=not args.no_line_search),
        mapping=MappingConfig(iters=args.map_iters,
                              lr_decay=args.lr_decay,
                              lr_decay_steps=args.lr_decay_steps),
        capacity=args.capacity,
        keyframe_every=args.kf_every,
        map_every=args.kf_every,
        window=args.window,
        seed_every_px=3,
        init_iters=120,
        pose_graph_refine=not args.no_refine,
        refine_every=args.refine_every,
        refine_cost_gate=args.refine_cost_gate,
        kf_min_coverage=args.kf_coverage,
        coverage_map_iters=args.coverage_map_iters,
        kf_coverage_cooldown=args.kf_cooldown,
        window_select=args.window_select,
        reloc_spike=args.reloc_spike,
        reloc_candidates=args.reloc_candidates,
        final_retrack_iters=args.final_retrack,
    )


def scene(args, device):
    """(ground-truth model, views, frames, camera template) of the run."""
    from ..camera import Camera
    from ..config import RasterConfig
    from ..io.synthetic import (render_sequence, replica_like_model,
                                walkthrough_trajectory)
    h, w = (int(x) for x in args.res.split("x"))
    gt_model = replica_like_model(seed=args.seed, wall_res=args.wall_res,
                                  device=device)
    views = walkthrough_trajectory(args.frames, seed=args.seed + 1,
                                   close_loop=args.close_loop,
                                   device=device)
    cam_t = Camera(viewmatrix=views[0], tanfovx=0.82, tanfovy=0.62,
                   height=h, width=w)
    # ground-truth rendering tiles need not match the SLAM run's config
    gt_cfg = RasterConfig(tile_h=8, tile_w=16, chunk=32,
                          instance_multiplier=10)
    frames = render_sequence(gt_model, views, cam_t, gt_cfg,
                             rgb_noise=args.rgb_noise,
                             depth_noise=args.depth_noise, seed=args.seed)
    return gt_model, views, frames, cam_t


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else args.device
    import numpy as np

    from ..io.replica import ate_rmse, ate_rmse_aligned
    from ..models.runner import run_slam

    t0 = time.time()
    gt_model, views, frames, cam_t = scene(args, device)
    h, w = cam_t.height, cam_t.width
    print(f"[ate +{time.time() - t0:5.1f}s] scene "
          f"{int(gt_model.num_active)} gaussians, {args.frames} frames at "
          f"{w}x{h} on {device}", file=sys.stderr, flush=True)

    scfg = slam_config(args)
    data = list(zip(views.cpu().numpy(), frames))
    t1 = time.time()
    state, gt_views = run_slam(data, scfg, cam_t, verbose=True)
    dt = time.time() - t1

    gtv = [np.asarray(v) for v in gt_views]
    ate_m = ate_rmse(state.est_views, gtv)
    ate_static = ate_rmse([gtv[0]] * len(gtv), gtv)
    extra = {}
    if state.online_views is not None:
        extra["ate_online_cm"] = round(
            100 * float(ate_rmse(state.online_views, gtv)), 3)
        extra["final_retrack_iters"] = args.final_retrack
    print(json.dumps({
        "metric": "ate_rmse_cm",
        "value": round(100 * float(ate_m), 3),
        "unit": "cm",
        "ate_aligned_cm": round(
            100 * float(ate_rmse_aligned(state.est_views, gtv)), 3),
        "ate_no_tracking_cm": round(100 * float(ate_static), 3),
        **extra,
        "frames": len(gtv),
        "res": f"{w}x{h}",
        "gaussians_gt": int(gt_model.num_active),
        "map_active": int(state.model.num_active),
        "tracking": args.method,
        "pyramid": args.pyramid,
        "kf_coverage": args.kf_coverage,
        "window_select": args.window_select,
        "close_loop": bool(args.close_loop),
        "keyframes": len(state.kf_views),
        "fps": round(len(gtv) / dt, 3),
        "wall_s": round(dt, 1),
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
