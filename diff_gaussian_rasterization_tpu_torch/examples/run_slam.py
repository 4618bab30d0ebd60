"""End-to-end SLAM demo: track and map an RGB-D sequence, report ATE (the
PyTorch port of the JAX package's ``examples/run_slam.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.run_slam \\
        [--frames 32] [--res 120x168] [--gaussians 2000] \\
        [--method gn|gn_fd|adam] [--dataset replica:<dir> | tum:<dir>] \\
        [--window-select nearest|random] [--kf-coverage F] \\
        [--refine-cost-gate F] [--refine] [--device cuda | --cpu]

Runs the whole loop of ``models/runner.py`` on ``--device`` (default
``cuda``): pose-only tracking per frame, keyframe selection, windowed
mapping with densification and, with ``--refine``, the native pose-graph
refinement at the end.  The sequence is a synthetic room rendered along
an orbit, or a Replica or TUM sequence on disk.  Prints the ATE and the
static-pose baseline's; ``main`` returns them (``ate_m``,
``ate_static_m``) with the frame count and the active Gaussians.
``--mesh`` (multi-device SLAM) is not ported yet: it raises
``NotImplementedError``.
"""

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--res", default="120x168", help="height x width")
    ap.add_argument("--gaussians", type=int, default=2000)
    ap.add_argument("--method", default="gn",
                    choices=["gn", "gn_fd", "adam"])
    ap.add_argument("--dataset", default=None,
                    help="replica:<dir> or tum:<dir>: run a real on-disk "
                         "sequence instead of the synthetic orbit")
    ap.add_argument("--mesh", default=None,
                    help="device-mesh axes, e.g. kf=2,tile=4 (not ported "
                         "yet: raises NotImplementedError)")
    ap.add_argument("--window-select", default="nearest",
                    choices=["nearest", "random"])
    ap.add_argument("--kf-coverage", type=float, default=0.0)
    ap.add_argument("--refine-cost-gate", type=float, default=3.0)
    ap.add_argument("--refine", action="store_true",
                    help="measurement-based pose-graph refinement at end")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda or cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    return ap.parse_args(argv)


def sequence(args, device):
    """(data, camera template, RasterConfig) of the run: ``data`` yields
    (ground-truth view, Frame)."""
    import torch

    from ..camera import Camera
    from ..config import RasterConfig
    if args.dataset:
        kind, _, root = args.dataset.partition(":")
        if kind == "replica":
            from ..io.replica import ReplicaDataset
            ds = ReplicaDataset(root, device=device)
        elif kind == "tum":
            from ..io.tum import TUMDataset
            ds = TUMDataset(root, device=device)
        else:
            raise SystemExit(f"unknown dataset kind {kind!r}")
        # 16x16 tiles fit any resolution; init_slam's probe rightsizes the
        # instance budget after the bootstrap
        cfg = RasterConfig(tile_h=16, tile_w=16, chunk=32,
                           instance_multiplier=12)
        return ds, ds.camera_template(), cfg

    from ..io.synthetic import (orbit_trajectory, random_room_model,
                                render_sequence)
    h, w = (int(x) for x in args.res.split("x"))
    cam_t = Camera(viewmatrix=torch.eye(4, device=device), tanfovx=0.7,
                   tanfovy=0.55, height=h, width=w)
    cfg = RasterConfig(tile_h=8, tile_w=16, instance_multiplier=12)
    print(f"rendering ground-truth sequence ({args.frames} frames, "
          f"{h}x{w}, {args.gaussians} blobs) on {device}...")
    gt_model = random_room_model(capacity=args.gaussians, n=args.gaussians,
                                 seed=0, device=device)
    views = orbit_trajectory(args.frames, device=device)
    frames = render_sequence(gt_model, views, cam_t, cfg)
    return list(zip(views.cpu().numpy(), frames)), cam_t, cfg


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: multi-device SLAM (the parallel layer) is not ported "
            "yet; run_slam runs on one device")
    device = "cpu" if args.cpu else args.device
    from ..io.replica import ate_rmse
    from ..models.runner import SLAMConfig, run_slam
    from ..models.slam import MappingConfig, TrackingConfig

    data, cam_t, cfg = sequence(args, device)
    scfg = SLAMConfig(
        raster=cfg,
        tracking=TrackingConfig(iters=10, method=args.method,
                                sil_threshold=0.5),
        mapping=MappingConfig(iters=15),
        capacity=8 * args.gaussians,
        keyframe_every=2, map_every=2, window=3,
        seed_every_px=2, init_iters=60, motion_model=False,
        pose_graph_refine=args.refine,
        window_select=args.window_select,
        kf_min_coverage=args.kf_coverage,
        refine_cost_gate=args.refine_cost_gate,
    )

    t0 = time.time()
    state, gt_views = run_slam(
        data, scfg, cam_t, verbose=True,
        max_frames=args.frames if args.dataset else None)
    dt = time.time() - t0

    ate = ate_rmse(state.est_views, gt_views)
    ate_static = ate_rmse([gt_views[0]] * len(gt_views), gt_views)
    active = int(state.model.num_active)
    print(f"\n{len(gt_views)} frames in {dt:.1f}s "
          f"({len(gt_views) / dt:.2f} fps)")
    print(f"ATE RMSE: {ate:.4f} m   (static-pose baseline: "
          f"{ate_static:.4f} m)")
    print(f"active Gaussians: {active}")
    return dict(ate_m=float(ate), ate_static_m=float(ate_static),
                frames=len(gt_views), active=active)


if __name__ == "__main__":
    main()
