"""Fit a Gaussian splat scene to posed RGB-D views, classic 3DGS training
(the PyTorch port of the JAX package's ``examples/fit_scene.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.fit_scene \\
        [--iters 300] [--views 6] [--hw 48 64] [--capacity 4096] \\
        [--densify-every 50] [--out model.ply] [--device cuda | --cpu]

The reference rasterizer family serves two workloads: SLAM
(``examples/run_slam.py``) and plain novel-view-synthesis training.  This
is the latter: Gaussians initialized at random in the scene volume, Adam
(``map_step`` over every training view each step) and densify and prune,
against views of a synthetic room rendered along an orbit, one of them
held out.  Prints the loss and the last training view's PSNR every 50
iterations and the holdout view's PSNR at the end; ``main`` returns them
(``losses``, a float per iteration, ``train_psnr`` and ``holdout_psnr``)
with the fitted ``model``.
"""

import argparse

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--hw", type=int, nargs=2, default=(48, 64))
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--densify-every", type=int, default=50)
    ap.add_argument("--out", type=str, default=None,
                    help="optional .ply to save the fitted model")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda or cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    return ap.parse_args(argv)


def psnr(a, b) -> float:
    return -10.0 * np.log10(float(((a - b) ** 2).mean()) + 1e-12)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else args.device
    import torch

    from ..camera import Camera
    from ..config import RasterConfig
    from ..io.ply import save_ply
    from ..io.synthetic import (orbit_trajectory, random_room_model,
                                render_sequence)
    from ..models.gaussians import DensifyState, densify_and_prune, init_model
    from ..models.slam import (MappingConfig, make_map_optimizer, map_step,
                               render_model)

    h, w = args.hw
    cam_t = Camera(viewmatrix=torch.eye(4, device=device), tanfovx=0.7,
                   tanfovy=0.55, height=h, width=w)
    cfg = RasterConfig(tile_h=8, tile_w=8, chunk=16, instance_multiplier=12)
    cam = lambda v: cam_t.replace(viewmatrix=v)

    # ground truth: a synthetic room rendered from an orbit (+1 holdout)
    gt = random_room_model(capacity=1024, n=1024, seed=0, device=device)
    views = orbit_trajectory(args.views + 1, device=device)
    frames = render_sequence(gt, views, cam_t, cfg)
    train_v, hold_v = views[:-1], views[-1]
    krgbs = torch.stack([f.rgb for f in frames[:-1]])
    kdepths = torch.stack([f.depth for f in frames[:-1]])
    n_train = train_v.shape[0]

    # random init inside the scene volume
    rng = np.random.RandomState(1)
    n0 = 512
    means = rng.uniform(-1.5, 1.5, (n0, 3))
    means[:, 2] = rng.uniform(1.0, 5.0, n0)
    model = init_model(args.capacity, sh_degree=0, means=means,
                       colors=rng.uniform(0.2, 0.8, (n0, 3)),
                       scales=np.full((n0, 3), 0.08), device=device)

    mcfg = MappingConfig(lr_means=2e-3, lr_scales=5e-3, lr_opacities=5e-2,
                         lr_sh=1e-2, w_depth=0.2)
    opt = make_map_optimizer(model, mcfg)
    dstate = DensifyState.zero(args.capacity, device=device)
    generator = torch.Generator().manual_seed(0)
    wts = torch.ones(n_train, device=device)

    losses, train_psnr = [], None
    for it in range(args.iters):
        loss, dstate, _ = map_step(model, opt, dstate, train_v, krgbs,
                                   kdepths, wts, cfg, mcfg, h, w,
                                   cam_t.tanfovx, cam_t.tanfovy, n_train)
        losses.append(loss)
        if args.densify_every and (it + 1) % args.densify_every == 0 \
                and it + 1 < args.iters:
            dstate, _ = densify_and_prune(
                model, dstate, grad_threshold=mcfg.densify_grad_threshold,
                generator=generator)
        if (it + 1) % 50 == 0 or it == 0 or it + 1 == args.iters:
            with torch.no_grad():
                train_psnr = psnr(
                    render_model(model, cam(train_v[-1]), cfg).color,
                    krgbs[-1])
            print(f"iter {it + 1:4d}  loss {float(loss):.4f}  "
                  f"train-view PSNR {train_psnr:5.2f} dB  "
                  f"active {int(model.num_active)}")

    with torch.no_grad():
        holdout = psnr(render_model(model, cam(hold_v), cfg).color,
                       frames[-1].rgb)
    print(f"holdout PSNR: {holdout:5.2f} dB")
    if args.out:
        save_ply(args.out, model)
        print(f"saved {int(model.num_active)} Gaussians to {args.out}")
    return dict(losses=torch.stack(losses).tolist(), train_psnr=train_psnr,
                holdout_psnr=holdout, model=model)


if __name__ == "__main__":
    main()
