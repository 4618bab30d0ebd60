"""A/B of a ``RasterConfig`` override against the baseline on the card (the
PyTorch port of the JAX package's root ``prof_ab.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.prof_ab \\
        key=value [key=value ...] [--samples 2] [--inner 10] \\
        [--gaussians 100000] [--height 680] [--width 1200] \\
        [--device cuda | --cpu]

Times ``bench``'s step (the loss over four outputs of ``rasterize`` on the
bench scene and its gradient w.r.t. the means and the view, ``--inner``
steps chained a sample) under the baseline ``RasterConfig(tile_h=32,
tile_w=32)`` (A) and under the baseline with the overrides (B), in turns
A, B, B, A, ``--samples`` times, after one warm-up sample of each; then
one profiled sample of each gives its device busy time and idle share, as
``examples/prof.py`` times its stages.  Each configuration's budget is 1.1x
its own instance count (the JAX tool sized both from the baseline's, which
overflows an override that changes the tiles).

Values parse as the JAX tool parses them: ``true``/``false`` (any case), a
string of digits as an int, anything else as a float.  A field that steers
only the JAX package's TPU kernels (``config.TPU_ONLY_FIELDS``:
``scan_sum_mm``, ``scan_prod_mm``, ``bwd_scan_*``, ``bwd_chunk``, ...)
raises ``ValueError`` naming it: the port has nothing for it to change.
The JAX tool's baseline also set ``scan_sum_mm`` and ``scan_prod_mm``.

One JSON line a configuration on stdout; B's carries the differences B - A
(``delta_host_ms``, ``delta_device_ms``).  Exits non-zero when a render
overflows its budget or a gradient is not finite.
"""

import argparse
import dataclasses
import sys

from .bench import (common_args, emit, fwd_bwd, guard, instance_budget,
                    launch_counts, note, sample_ms, scene)
from .prof import chain, device_split, start

CONFIGS = ("baseline", "override")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=2, inner=10)
    ap.add_argument("overrides", nargs="*", metavar="key=value",
                    help="RasterConfig fields of B")
    return ap.parse_intermixed_args(argv)


def parse_override(kv: str):
    """``(key, value)`` of ``key=value``, parsed as ``prof_ab.py:66-72``
    parses it."""
    k, v = kv.split("=")
    val = {"true": True, "false": False}.get(v.lower(), None)
    if val is None:
        val = int(v) if v.isdigit() else float(v)
    return k, val


def parse_overrides(items) -> dict:
    """The overrides by field; ``ValueError`` for a field of the TPU only
    or of no ``RasterConfig``."""
    from ..config import TPU_ONLY_FIELDS, RasterConfig
    over = dict(parse_override(kv) for kv in items)
    names = {f.name for f in dataclasses.fields(RasterConfig)}
    for k in over:
        if k in TPU_ONLY_FIELDS:
            raise ValueError(
                f"{k} is a TPU-only field of the JAX package's RasterConfig: "
                f"it changes nothing in the port, so an A/B of it measures "
                f"nothing")
        if k not in names:
            raise ValueError(f"RasterConfig has no field {k!r}")
    return over


def main(argv=None):
    from ..ops.kernels import render
    from ..ops.rasterize import count_instances
    args = parse_args(sys.argv[1:] if argv is None else argv)
    over = parse_overrides(args.overrides)
    device, fields = start(args)
    means, kw, cam, base = scene(args, device)
    cfg_b = base.replace(max_instances=None, **over)
    if cfg_b.max_instances is None:
        cfg_b = cfg_b.replace(max_instances=instance_budget(
            count_instances(means, cam, cfg_b, **kw)))
    cfgs = dict(zip(CONFIGS, (base, cfg_b)))
    note("prof_ab", f"baseline budget {base.max_instances}; override "
                    f"{over}, budget {cfg_b.max_instances}")

    def step_of(cfg):
        def step(mv):
            loss, out, gm, gv = fwd_bwd(mv[0], mv[1], cam, cfg, kw)
            last[cfg] = (loss, out, gm, gv)
            return mv[0] + 1e-30 * gm, mv[1] + 1e-30 * gv
        return lambda: chain(step, (means, cam.viewmatrix), args.inner)

    last = {}
    runs = {name: step_of(cfg) for name, cfg in cfgs.items()}
    for run in runs.values():
        run()
    samples = {name: [] for name in cfgs}
    launches = {name: {} for name in cfgs}
    for _ in range(args.samples):
        for name in ("baseline", "override", "override", "baseline"):
            render.reset_launches()
            samples[name] += sample_ms(runs[name], device, 1, args.inner)
            launches[name] = launch_counts(args.inner)
    lines = {}
    for name, cfg in cfgs.items():
        split, _ = device_split(runs[name], args.inner, device)
        ms = samples[name]
        lines[name] = dict(
            tool="prof_ab", config=name,
            overrides=over if name == "override" else {},
            host_ms=sum(ms) / len(ms), samples_ms=ms, **split,
            launches=launches[name],
            instances=int(last[cfg][1].num_rendered),
            max_instances=cfg.max_instances, tile=f"{cfg.tile_w}x"
                                                 f"{cfg.tile_h}",
            gaussians=args.gaussians, res=f"{args.width}x{args.height}",
            inner=args.inner, samples=args.samples, **fields)
    a, b = lines["baseline"], lines["override"]
    b["delta_host_ms"] = b["host_ms"] - a["host_ms"]
    b["delta_device_ms"] = None if b["device_ms"] is None \
        else b["device_ms"] - a["device_ms"]
    error = "; ".join(f"{name}: {e}" for name, cfg in cfgs.items()
                      if (e := guard(last[cfg])))
    for line in lines.values():
        if error:
            line["error"] = error
        emit(line)
    if error:
        raise SystemExit(f"prof_ab: {error}")
    return list(lines.values())


if __name__ == "__main__":
    main()
