"""The dual render's cost against the forward on the card (the PyTorch port
of the JAX package's root ``prof_jvp.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.prof_jvp \\
        [--samples 3] [--inner 10] [--gaussians 100000] [--height 680] \\
        [--width 1200] [--device cuda | --cpu]

On the bench scene, three stages, each timed as ``examples/prof.py``
times its stages (a sample chains ``--inner`` renders, each at the view
moved by 1e-30 times a sum of the last one's images):

  forward     ``rasterize`` with ``track_off`` and ``map_off`` (color, depth)
  jvp6_light  ``rasterize_with_pose_jvp`` with the 6 twist tangents of
              ``lie.apply_twist`` at the identity (one ``render_jvp``
              launch): the Gauss-Newton tracker's Jacobian source
  jvp6_full   the same with the full variant's pose branches
              (``cfg.full_variant()``)

Each dual stage's line carries its ratio to the forward, on the host
clock (``ratio_host``) and in device busy time (``ratio_device``).  One
JSON line a stage on stdout.
"""

import argparse
import sys

from .bench import common_args, emit, note, scene
from .prof import prep_kwargs, start, time_stage

STAGES = ("forward", "jvp6_light", "jvp6_full")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=3, inner=10)
    return ap.parse_args(argv)


def twist_tangents(view):
    """[6, 4, 4]: the view matrix's derivatives along the twist basis at
    the identity twist, ``jacfwd(lambda x: apply_twist(view, x))(0)``."""
    import torch

    from ..models.lie import apply_twist
    tw = torch.func.jacfwd(lambda x: apply_twist(view, x))(
        torch.zeros(6, dtype=view.dtype, device=view.device))
    return tw.movedim(-1, 0)


def main(argv=None):
    import torch

    from ..ops.rasterize import rasterize, rasterize_with_pose_jvp
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device, fields = start(args)
    means, kw, cam, cfg = scene(args, device)
    prep_kw = prep_kwargs(kw)
    tangents = twist_tangents(cam.viewmatrix)
    note("prof_jvp", f"{args.gaussians} gaussians at {args.width}x"
                     f"{args.height}, budget {cfg.max_instances}, K = "
                     f"{tangents.shape[0]}")

    def fwd(v):
        out = rasterize(means, cam.replace(viewmatrix=v), cfg,
                        gt_depth=kw["gt_depth"], track_off=True,
                        map_off=True, **prep_kw)
        return v + 1e-30 * (out.color.sum() + out.depth.sum())

    def dual(vcfg):
        def step(v):
            j = rasterize_with_pose_jvp(means, cam.replace(viewmatrix=v),
                                        vcfg, tangents,
                                        gt_depth=kw["gt_depth"], **prep_kw)
            return v + 1e-30 * (j.out.color.sum() + j.depth.sum()
                                + j.opacity_map.sum())
        return step

    lines = []
    for name, step in zip(STAGES, (fwd, dual(cfg),
                                   dual(cfg.full_variant()))):
        note("prof_jvp", f"{name}: {args.samples} samples of {args.inner}")
        t = time_stage(torch.no_grad()(step), cam.viewmatrix, args, device)
        if lines:
            base = lines[0]
            t["ratio_host"] = t["host_ms"] / base["host_ms"]
            t["ratio_device"] = None if t["device_ms"] is None \
                else t["device_ms"] / base["device_ms"]
        lines.append(dict(tool="prof_jvp", stage=name, **t,
                          tangents=int(tangents.shape[0]),
                          max_instances=cfg.max_instances,
                          gaussians=args.gaussians,
                          res=f"{args.width}x{args.height}",
                          inner=args.inner, samples=args.samples, **fields))
        emit(lines[-1])
    return lines


if __name__ == "__main__":
    main()
