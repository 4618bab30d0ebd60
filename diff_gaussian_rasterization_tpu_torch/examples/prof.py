"""Component split of the bench step on the card (the PyTorch port of the
JAX package's root ``prof.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.prof \\
        [--scene uniform|room] [--samples 3] [--inner 8] \\
        [--gaussians 100000] [--height 680] [--width 1200] \\
        [--device cuda | --cpu]

The bench scene of ``examples/bench.py`` (100,000 Gaussians, 1200x680,
32x32 tiles, a budget of 1.1x the true instance count rounded up to 1024),
or with ``--scene room`` the JAX tool's occlusion-heavy room
(``scenes.bench_scene(kind="room")``), split into five stages:

  front             preprocess + ``bin_gaussians`` + the feature-table
                    gather: everything before ``render.core_fwd``
  core_fwd          ``core_fwd`` alone (``render_fwd`` + ``tile_scatter_sum``)
  core_fwd_bwd      ``core_fwd`` + ``core_bwd`` with the JAX tool's
                    cotangents: ones for color, depth, weight and median
                    depth, zeros for the variance and T
  forward           the whole ``rasterize`` forward
  forward_backward  the whole forward + backward of ``bench``'s loss
                    (color + 0.3 depth + 0.1 median + 0.1 opacity) w.r.t.
                    the means and the view

The JAX tool chained its steps inside one ``lax.scan`` executable; here a
sample chains ``--inner`` steps eagerly with the same data dependence, each
step's input moved by 1e-30 times a sum of the last step's output (the
gradients', ``m + 1e-30 g``, in the backward stages, as ``bench`` chains).
Each stage reports two times a step side by side, since the port's host
launches most of what the device then idles through:

- ``host_ms``: the host clock between two synchronizations, the mean over
  ``--samples`` samples after one warm-up sample (the time a caller waits
  for);
- ``device_ms`` and ``idle_share``: the device's busy time a step from
  ``torch.profiler`` over one more sample, and the share of that sample's
  host-clock window (``profiled_ms``) the device idled.  The CUDA activity
  only; a card whose profile holds none fails the run.  On the CPU both
  are null: not measured.

Prints stage notes on stderr and one JSON line a stage on stdout, with the
scene, its instance count and budget, the stage's kernel launches a step
and the device (on a card its name and power limit as nvidia-smi gives
them).  ``prof_bin``, ``prof_jvp``, ``prof_trace``, ``prof_track`` and
``prof_ab`` share this module's helpers.
"""

import argparse
import sys

from .bench import (Stages, build_kernels, common_args, device_fields, emit,
                    launch_counts, note, run_device, sample_ms, scene)

STAGES = ("front", "core_fwd", "core_fwd_bwd", "forward", "forward_backward")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=3, inner=8)
    ap.add_argument("--scene", default="uniform", choices=["uniform", "room"],
                    help="the bench scene, or the JAX tool's room")
    return ap.parse_args(argv)


def start(args):
    """The run's device (``RuntimeError`` without CUDA unless the CPU was
    named), its kernels built, and the device fields of its lines."""
    device = run_device(args)
    build_kernels(device, Stages())
    return device, device_fields(device)


def chain(step, x0, inner):
    """``inner`` steps, each fed the step before's output."""
    x = x0
    for _ in range(inner):
        x = step(x)
    return x


def device_split(run, steps, device, trace_path=None):
    """Device busy ms a step, the profiled window's host ms a step and the
    idle share, from ``torch.profiler`` over one call of ``run`` (``steps``
    steps), with its device events; null times (not measured) and no
    events off the card."""
    from ..utils.profiling import (device_events, device_us, profile_run,
                                   require_device_events)
    if device.type != "cuda":
        if trace_path is not None:
            profile_run(run, trace_path=trace_path)
        return dict(device_ms=None, profiled_ms=None, idle_share=None), []
    wall_ms, prof = profile_run(run, trace_path=trace_path)
    events = device_events(prof)
    require_device_events(events, device)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    return dict(device_ms=busy_ms / steps, profiled_ms=wall_ms / steps,
                idle_share=1.0 - busy_ms / wall_ms), events


def time_stage(step, x0, args, device):
    """A chained stage's fields: host ms a step (mean and samples), the
    device split, and kernel launches a step."""
    from ..ops.kernels import render

    def run():
        return chain(step, x0, args.inner)

    run()
    render.reset_launches()
    ms = sample_ms(run, device, args.samples, args.inner)
    launches = launch_counts(args.samples * args.inner)
    split, _ = device_split(run, args.inner, device)
    return dict(host_ms=sum(ms) / len(ms), samples_ms=ms, **split,
                launches=launches)


def prep_kwargs(kw):
    """The preprocess's inputs among ``bench.scene``'s keywords."""
    return {k: kw[k] for k in ("opacities", "scales", "rotations",
                               "colors_precomp")}


def core_bwd_rows(table, tile_start, tile_stop, gt_tiles, core_kw):
    """``core_fwd`` then ``core_bwd`` with the JAX tool's cotangents
    (``prof.py:151-165``): the gradient rows [I, 12]."""
    import torch

    from ..ops.kernels.render import core_bwd, core_fwd
    out = core_fwd(table, tile_start, tile_stop, gt_tiles, **core_kw)
    one, zero = torch.ones_like(out.depth), torch.zeros_like(out.depth)
    cots = (torch.ones_like(out.color), one, one, zero, one, zero)
    totals = (out.color, out.depth, out.weight, out.var, out.t_final)
    return core_bwd(table, tile_start, tile_stop, gt_tiles, totals, cots,
                    n_contrib=out.n_contrib, **core_kw)


def front(means, kw, cam, cfg):
    """The first stage: preprocess, ``bin_gaussians`` and the gather of the
    kernels' table: ``(table [I, 11], binning, gt_tiles, core_kw)``."""
    from ..ops.rasterize import prepare
    from ..ops.tiling import grid_dims
    _, binn, feat, gt_tiles = prepare(means, cam, cfg, cfg.max_instances,
                                      kw["gt_depth"], **prep_kwargs(kw))
    tiles_x, _ = grid_dims(cam.height, cam.width, cfg.tile_h, cfg.tile_w)
    core_kw = dict(cfg=cfg, tiles_x=tiles_x, height=cam.height,
                   width=cam.width)
    return feat[binn.gauss_id].contiguous(), binn, gt_tiles, core_kw


def stages(means, kw, cam, cfg):
    """Each stage's ``(step, first input)`` by name (see the module
    docstring), and the instance count."""
    import torch

    from ..ops.kernels.render import core_fwd
    from ..ops.rasterize import rasterize
    from .bench import fwd_bwd
    with torch.no_grad():
        table, binn, gt_tiles, core_kw = front(means, kw, cam, cfg)
    ts, tp = binn.tile_start, binn.tile_stop
    nudge = lambda x, s: x + 1e-30 * s
    no_grad = lambda step: torch.no_grad()(step)

    def backward(mv):
        _, _, gm, gv = fwd_bwd(mv[0], mv[1], cam, cfg, kw)
        return nudge(mv[0], gm), nudge(mv[1], gv)

    steps = {
        "front": (no_grad(lambda m: nudge(m, front(m, kw, cam, cfg)[0]
                                          .sum())), means),
        "core_fwd": (no_grad(lambda t: nudge(t, core_fwd(
            t, ts, tp, gt_tiles, **core_kw).color.sum())), table),
        "core_fwd_bwd": (no_grad(lambda t: nudge(t, core_bwd_rows(
            t, ts, tp, gt_tiles, core_kw).sum())), table),
        "forward": (no_grad(lambda m: nudge(m, rasterize(
            m, cam, cfg, **kw).color.sum())), means),
        "forward_backward": (backward, (means, cam.viewmatrix)),
    }
    return steps, int(binn.num_rendered)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device, fields = start(args)
    means, kw, cam, cfg = scene(args, device, kind=args.scene)
    steps, n_inst = stages(means, kw, cam, cfg)
    note("prof", f"{args.scene} scene, {args.gaussians} gaussians at "
                 f"{args.width}x{args.height}: {n_inst} instances, budget "
                 f"{cfg.max_instances}")
    lines = []
    for name in STAGES:
        note("prof", f"{name}: {args.samples} samples of {args.inner} "
                     f"steps")
        step, x0 = steps[name]
        lines.append(dict(tool="prof", stage=name, **time_stage(
            step, x0, args, device), scene=args.scene, instances=n_inst,
            max_instances=cfg.max_instances, gaussians=args.gaussians,
            res=f"{args.width}x{args.height}", inner=args.inner,
            samples=args.samples, **fields))
        emit(lines[-1])
    return lines


if __name__ == "__main__":
    main()
