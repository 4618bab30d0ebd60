"""Benchmark: mapping steps per second at 1200x680 with 500,000 Gaussians
(the PyTorch port of the JAX package's root ``bench_mapping.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.bench_mapping \\
        [--samples 9] [--inner 3] [--gaussians 500000] \\
        [--device cuda | --cpu]

The mapping benchmark's model (``scenes.mapping_model``, 500,000
Gaussians) and one keyframe at the identity pose whose target is the
model's own render with its colors moved (``clip(0.9 color + 0.05)``, the
render's depth), 32x32 tiles, a budget of 1.1x the render's instance
count, the default ``MappingConfig``.  A sample is ``--inner`` chained
``map_step``s from the same start state (the parameters, zero Adam moments
and densify statistics, restored in place before each sample, outside its
time), timed as ``bench`` times its samples, after one warm-up sample.

Prints one JSON line on stdout: ``{"metric":
"mapping_steps_per_sec_1200x680_500k", "value": ..., "unit": "map
steps/s", ...}`` with ``ms_per_map_step`` (the mean, as ``bench``'s),
the samples, and ``loss_step0`` / ``loss_step1`` (the losses of the first
two steps).
Exits non-zero unless the loss falls from step 0 to step 1 and every
timed sample's losses equal the warm-up's (each sample starts from the
same state).
"""

import argparse

from .bench import (Stages, build_kernels, common_args, device_fields, emit,
                    instance_budget, launch_counts, note, run_device,
                    sample_ms, summary)

METRIC = "mapping_steps_per_sec_1200x680_500k"
UNIT = "map steps/s"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=500_000, samples=9, inner=3)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = run_device(args)
    stages = Stages()
    build_kernels(device, stages)
    import torch

    from ..config import RasterConfig
    from ..models.gaussians import PARAM_FIELDS, DensifyState
    from ..models.slam import (MappingConfig, make_map_optimizer, map_step,
                               render_model)
    from ..ops.kernels import render
    from ..scenes import bench_camera, mapping_model

    model = mapping_model(p=args.gaussians, device=device)
    cam = bench_camera(height=args.height, width=args.width, device=device)
    cfg = RasterConfig(tile_h=32, tile_w=32)
    with torch.no_grad():
        gt = render_model(model, cam, cfg)
    cfg = cfg.replace(max_instances=instance_budget(gt.num_rendered))
    rgbs = torch.clamp(gt.color * 0.9 + 0.05, 0, 1)[None]
    depths = gt.depth[0][None]
    del gt
    mcfg = MappingConfig()
    opt = make_map_optimizer(model, mcfg)
    dstate = DensifyState.zero(args.gaussians, device=device)
    step_args = (cam.viewmatrix[None], rgbs, depths,
                 torch.ones(1, device=device), cfg, mcfg, args.height,
                 args.width, cam.tanfovx, cam.tanfovy, 1)
    start = {k: getattr(model, k).detach().clone() for k in PARAM_FIELDS}
    stages("scene_s")
    note("bench_mapping", f"{args.gaussians} gaussians at {args.width}x"
                          f"{args.height}, budget {cfg.max_instances}; "
                          f"warm-up")

    def reset():
        """The start state: parameters, zero Adam moments and step counts
        (what a fresh Adam holds before its first step)."""
        with torch.no_grad():
            for k, v in start.items():
                getattr(model, k).copy_(v)
        for state in opt.adam.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    v.zero_()

    def run(n):
        d, losses = dstate, []
        for _ in range(n):
            loss, d, _ = map_step(model, opt, d, *step_args)
            losses.append(loss.detach())
        return losses

    warm = [float(x) for x in run(max(args.inner, 2))]
    stages("warmup_s")
    render.reset_launches()
    timed = []
    ms = sample_ms(lambda: timed.append(run(args.inner)), device,
                   args.samples, args.inner, reset=reset)
    launches = launch_counts(args.samples * args.inner)
    timed = [[float(x) for x in losses] for losses in timed]
    stages("measure_s")
    s = summary(ms)
    line = dict(
        metric=METRIC, value=s.pop("value"), unit=UNIT,
        gaussians=args.gaussians, res=f"{args.width}x{args.height}",
        ms_per_map_step=s["mean_ms"], loss_step0=warm[0],
        loss_step1=warm[1], **s, inner=args.inner,
        max_instances=cfg.max_instances, launches=launches,
        stages=dict(stages), **device_fields(device))
    if not warm[1] < warm[0]:
        line["error"] = (f"the loss did not fall ({warm[0]} -> "
                         f"{warm[1]})")
    elif any(losses != warm[:args.inner] for losses in timed):
        line["error"] = (f"the timed samples' losses {timed} differ from "
                         f"the warm-up's {warm[:args.inner]}: the samples "
                         f"did not start from the same state")
    emit(line)
    if "error" in line:
        raise SystemExit(f"bench_mapping: {line['error']}")
    return line


if __name__ == "__main__":
    main()
