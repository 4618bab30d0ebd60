"""Render a 3DGS PLY from chosen viewpoints and save PNGs (the PyTorch port
of the JAX package's ``examples/render_ply.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.render_ply \\
        model.ply --out renders/ [--res 680x1200] [--fov 0.82x0.47] \\
        [--orbit 8 | --view v00,v01,...,v33] [--sh-degree N] [--depth] \\
        [--device cuda | --cpu]

Models trained anywhere in the 3DGS world (or written by
``examples/fit_scene.py`` / ``io.ply.save_ply``) render on ``--device``
(default ``cuda``).  The instance budget is probed with
``count_instances`` at the first view (1.3x, rounded up to 1024) and
re-probed from ``num_rendered`` when a view overflows it.  Writes
``view%03d.png`` and, with ``--depth``, ``depth%03d.png`` (the
silhouette-normalized depth where the silhouette exceeds 0.5, scaled to
its maximum).  ``main`` returns the ``RasterConfig`` of the last render.
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ply")
    ap.add_argument("--out", default="renders")
    ap.add_argument("--res", default="680x1200", help="height x width")
    ap.add_argument("--fov", default="0.82x0.47", help="tanfovx x tanfovy")
    ap.add_argument("--orbit", type=int, default=8,
                    help="render N poses on the synthetic orbit")
    ap.add_argument("--view", default=None,
                    help="single 4x4 row-convention view matrix, 16 "
                         "comma-separated floats (overrides --orbit)")
    ap.add_argument("--sh-degree", type=int, default=None,
                    help="cap the SH degree (default: whatever the PLY has)")
    ap.add_argument("--depth", action="store_true",
                    help="also save normalized depth maps")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (cuda or cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    return ap.parse_args(argv)


def budget(n_instances: int) -> int:
    """1.3x the instance count, rounded up to a multiple of 1024."""
    return int(-(-n_instances * 1.3 // 1024) * 1024)


def to_uint8(color) -> np.ndarray:
    """A [3, H, W] color image as the [H, W, 3] uint8 the PNG holds."""
    rgb = np.clip(color.detach().cpu().numpy(), 0, 1)
    return (np.moveaxis(rgb, 0, 2) * 255).round().astype(np.uint8)


def depth_to_uint8(out) -> np.ndarray:
    """The silhouette-normalized depth where the silhouette exceeds 0.5,
    scaled to its maximum, as uint8."""
    sil = out.opacity_map[0].detach().cpu().numpy()
    d = out.depth[0].detach().cpu().numpy() / np.maximum(sil, 1e-6)
    d = np.where(sil > 0.5, d, 0.0)
    return (d / max(d.max(), 1e-6) * 255).astype(np.uint8)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else args.device
    import torch

    from ..camera import Camera
    from ..config import RasterConfig
    from PIL import Image

    from ..io.ply import load_ply
    from ..io.synthetic import orbit_trajectory
    from ..models.slam import render_model
    from ..ops.rasterize import count_instances

    h, w = (int(x) for x in args.res.split("x"))
    tfx, tfy = (float(x) for x in args.fov.split("x"))
    model = load_ply(args.ply, device=device)
    print(f"{int(model.num_active)} Gaussians, SH degree "
          f"{int(round(model.sh.shape[1] ** 0.5)) - 1}")
    cfg = RasterConfig(tile_h=16, tile_w=16, instance_multiplier=12)

    if args.view:
        vals = [float(x) for x in args.view.split(",")]
        views = torch.tensor(vals, dtype=torch.float32,
                             device=device).reshape(1, 4, 4)
    else:
        views = orbit_trajectory(args.orbit, device=device)
    cam = lambda v: Camera(viewmatrix=v, tanfovx=tfx, tanfovy=tfy, height=h,
                           width=w)

    with torch.no_grad():
        n_inst = int(count_instances(
            model.means3D, cam(views[0]), cfg,
            **model.raster_kwargs(args.sh_degree)))
        cfg = cfg.replace(max_instances=max(1024, budget(n_inst)))
        os.makedirs(args.out, exist_ok=True)
        for i in range(views.shape[0]):
            out = render_model(model, cam(views[i]), cfg,
                               sh_degree=args.sh_degree)
            if bool(out.overflow):
                print(f"view {i}: instance budget overflowed "
                      f"({int(out.num_rendered)} needed): re-probing")
                cfg = cfg.replace(
                    max_instances=budget(int(out.num_rendered)))
                out = render_model(model, cam(views[i]), cfg,
                                   sh_degree=args.sh_degree)
            Image.fromarray(to_uint8(out.color)).save(
                os.path.join(args.out, f"view{i:03d}.png"))
            if args.depth:
                Image.fromarray(depth_to_uint8(out)).save(
                    os.path.join(args.out, f"depth{i:03d}.png"))
            print(f"view {i}: wrote {args.out}/view{i:03d}.png "
                  f"({int(out.num_rendered)} instances)")
    return cfg


if __name__ == "__main__":
    main()
