"""Benchmark: forward + backward rasterizations per second at 1200x680
(the PyTorch port of the JAX package's root ``bench.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.bench \\
        [--samples 9] [--inner 10] [--gaussians 100000] [--height 680] \\
        [--width 1200] [--ranks N [--backend gloo|nccl]] \\
        [--device cuda | --cpu]

The bench scene (``scenes.bench_scene``: 100,000 Gaussians, tan(fov/2) =
0.82 x 0.47, 32x32 tiles, an instance budget of 1.1x the true count rounded
up to 1024) rendered by ``rasterize``; a step is the loss over four
outputs and its gradient w.r.t. the means and the view matrix, and a
sample chains ``--inner`` steps through ``m + 1e-30 g`` as the JAX driver's
``lax.scan`` does.  The kernels' build and one warm-up sample come first
and are not timed; then each of ``--samples`` samples is timed on the host
clock between two ``torch.cuda.synchronize()`` calls: the wall time a
caller waits for.

With ``--ranks N`` (default: every CUDA device, 1 with ``--cpu``) above 1
the script spawns N ranks (``parallel.mesh.spawn``; ``--backend`` nccl on
CUDA, gloo on the CPU), each rendering tile-sharded with sharded binning
on a ``("tile",)`` mesh of N, and prints rank 0's line with each rank's
median.

The default rank count follows the host: a run with no ``--ranks`` on a
host of four cards is a four-rank run.  The line says where the count came
from (``ranks_from``: ``--ranks``, ``device_count`` or ``cpu``); a
comparison across hosts names ``--ranks``.

Prints stage notes on stderr and one JSON line on stdout, the JAX driver's
``{"metric": "fwd_bwd_rasterizations_per_sec_1200x680", "value": ...,
"unit": "renders/s", ...}`` with the samples (``samples_ms`` per step,
``mean_ms``, ``median_ms``, ``min_ms``, ``max_ms``, ``spread`` = (max -
min) / median), the sizes run and the device (on a card its name and power
limit as ``nvidia-smi`` gives them).  ``value`` and ``ms_per_fwd_bwd`` are
the JAX driver's: every timed step over every timed second (``mean_ms``),
so a stalled sample counts as the caller waited for it.  Exits non-zero
when a render overflows its budget or a gradient is not finite.
``bench_tracking`` and ``bench_mapping`` share this module's timing.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

METRIC = "fwd_bwd_rasterizations_per_sec_1200x680"
UNIT = "renders/s"
RANKS_TIMEOUT = 1800.0  # seconds the --ranks world may take, start to end


def common_args(ap, gaussians, samples, inner):
    """The flags every driver has: sizes, samples and the device."""
    ap.add_argument("--gaussians", type=int, default=gaussians)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--samples", type=int, default=samples,
                    help="timed samples, after one warm-up sample")
    ap.add_argument("--inner", type=int, default=inner,
                    help="steps in a sample")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda or cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=9, inner=10)
    ap.add_argument("--ranks", type=int, default=None,
                    help="tile-sharded ranks (default: the CUDA device "
                         "count, which follows the host; 1 with --cpu)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend of --ranks (default nccl on "
                         "CUDA, gloo on the CPU)")
    return ap.parse_args(argv)


def run_device(args):
    """The run's torch device; a CUDA one only where CUDA is available
    (``RuntimeError`` otherwise: a driver never falls back to the CPU)."""
    import torch
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return device


def note(tag, msg):
    print(f"[{tag}] {msg}", file=sys.stderr, flush=True)


class Stages(dict):
    """Seconds of each stage before the timed samples (the line's
    ``stages``), each from the end of the one before."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self[name] = now - self._t
        self._t = now


def build_kernels(device, stages):
    """Build the CUDA kernels before anything is timed (a CUDA run)."""
    if device.type == "cuda":
        from ..ops.kernels import _build
        _build.build_all()
    stages("build_s")


def instance_budget(count) -> int:
    """bench.py's budget: 1.1x the true instance count, rounded up to a
    multiple of 1024."""
    return int(-(-int(count) * 1.1 // 1024) * 1024)


def _sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def sample_ms(run, device, samples, inner, reset=None):
    """Wall ms per step of ``samples`` calls of ``run`` (``inner`` steps
    each), the device synchronized at both ends of each; ``reset`` runs
    before each sample, outside its time."""
    out = []
    for _ in range(samples):
        if reset is not None:
            reset()
        _sync(device)
        t0 = time.perf_counter()
        run()
        _sync(device)
        out.append((time.perf_counter() - t0) * 1e3 / inner)
    return out


def summary(ms) -> dict:
    """The line's sample fields.  ``mean_ms`` is every timed step over
    every timed second (the samples hold equal step counts), the JAX
    drivers' ``timeit`` total over its count, and ``value`` its rate; the
    median, the extremes and ``spread`` describe the samples."""
    mean, med = sum(ms) / len(ms), statistics.median(ms)
    return dict(value=1e3 / mean, samples_ms=list(ms), mean_ms=mean,
                median_ms=med, min_ms=min(ms), max_ms=max(ms),
                spread=(max(ms) - min(ms)) / med, samples=len(ms))


def card_fields(smi: str, uuid, name: str) -> dict:
    """``card`` and ``power_limit`` from the rows of ``nvidia-smi
    --query-gpu=uuid,name,power.limit --format=csv,noheader``: the row of
    the device's UUID (``uuid``, torch's, without nvidia-smi's ``GPU-``)
    or, where no row has it, the rows of its ``name``.  nvidia-smi numbers
    the cards apart from ``CUDA_VISIBLE_DEVICES``, so a row is never picked
    by the torch index.  ``ValueError`` when no row matches or the matching
    rows disagree."""
    rows = []
    for row in smi.strip().splitlines():
        u, rest = row.split(",", 1)
        n, limit = rest.rsplit(",", 1)
        rows.append((u.strip().lower().removeprefix("gpu-"), n.strip(),
                     limit.strip()))
    key = str(uuid).lower() if uuid else None
    hits = {r[1:] for r in rows if key and r[0] == key} \
        or {r[1:] for r in rows if r[1] == name}
    if len(hits) != 1:
        raise ValueError(f"nvidia-smi gives {len(hits)} rows for the card "
                         f"{name!r} ({uuid}): {smi!r}")
    (card, limit), = hits
    return {"card": card, "power_limit": limit}


def device_fields(device) -> dict:
    """``device``, and on a card its name and power limit as nvidia-smi
    gives them (its failure is the run's: a card's line carries both)."""
    if device.type != "cuda":
        return {"device": str(device)}
    import torch
    props = torch.cuda.get_device_properties(device.index or 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return {"device": str(device),
            **card_fields(smi, getattr(props, "uuid", None), props.name)}


def launch_counts(steps) -> dict:
    """Kernel launches a step since the last ``render.reset_launches()``."""
    from ..ops.kernels import render
    return {k: v / steps for k, v in render.launches.items()}


def emit(line: dict):
    """Print the line: one JSON object on stdout."""
    print(json.dumps(line), flush=True)


def scene(args, device, kind="uniform"):
    """``(means3D, kwargs, camera, cfg)`` of the run: the bench scene (or
    ``scenes.bench_scene``'s other ``kind``) and ``cfg.max_instances`` from
    its true instance count."""
    from ..config import RasterConfig
    from ..ops.rasterize import count_instances
    from ..scenes import bench_camera, bench_scene
    means, kw = bench_scene(p=args.gaussians, height=args.height,
                            width=args.width, device=device, kind=kind)
    cam = bench_camera(height=args.height, width=args.width, device=device)
    cfg = RasterConfig(tile_h=32, tile_w=32)
    n_inst = int(count_instances(means, cam, cfg, **kw))
    return means, kw, cam, cfg.replace(max_instances=instance_budget(n_inst))


def loss_of(out):
    """bench.py's loss: every output the step differentiates."""
    return (out.color.sum() + 0.3 * out.depth.sum()
            + 0.1 * out.depth_median.sum() + 0.1 * out.opacity_map.sum())


def fwd_bwd(means, view, cam, cfg, kw, **mesh_kw):
    """One step: ``(loss, outputs, d loss / d means3D, d loss / d view)``
    of one render of ``means`` at ``view``."""
    import torch

    from ..ops.rasterize import rasterize
    m = means.detach().requires_grad_(True)
    v = view.detach().requires_grad_(True)
    out = rasterize(m, cam.replace(viewmatrix=v), cfg, **kw, **mesh_kw)
    loss = loss_of(out)
    gm, gv = torch.autograd.grad(loss, (m, v))
    return loss.detach(), out, gm, gv


def guard(step) -> str:
    """The JAX driver's guard on a step: no overflow, finite gradients
    (an empty string when it holds)."""
    import torch
    loss, out, gm, gv = step
    if bool(out.overflow):
        return (f"the render overflowed its budget ({int(out.num_rendered)} "
                f"instances)")
    if not all(bool(torch.isfinite(x).all()) for x in (loss, gm, gv)):
        return "a loss or gradient that is not finite"
    return ""


def measure(args, device, mesh=None, stages=None, log=note):
    """The timed run on ``device`` (one rank's share with ``mesh``): the
    line's fields but the device's."""
    from ..ops.kernels import render
    stages = Stages() if stages is None else stages
    means, kw, cam, cfg = scene(args, device)
    mesh_kw = {} if mesh is None else dict(mesh=mesh, shard_binning=True)
    stages("probe_s")
    log("bench", f"{args.gaussians} gaussians at {args.width}x"
                 f"{args.height}, budget {cfg.max_instances}; warm-up")

    def chain():
        m, v = means, cam.viewmatrix
        for _ in range(args.inner):
            step = fwd_bwd(m, v, cam, cfg, kw, **mesh_kw)
            m, v = m + 1e-30 * step[2], v + 1e-30 * step[3]
        return step

    error = guard(chain())
    _sync(device)
    stages("warmup_s")
    log("bench", f"timing {args.samples} samples of {args.inner} steps")
    render.reset_launches()
    last = {}

    def run():
        last["step"] = chain()

    ms = sample_ms(run, device, args.samples, args.inner)
    launches = launch_counts(args.samples * args.inner)
    error = error or guard(last["step"])
    stages("measure_s")
    return dict(**summary(ms), instances=int(last["step"][1].num_rendered),
                max_instances=cfg.max_instances, launches=launches,
                stages=dict(stages), error=error)


def _rank(rank, world, argv, backend):
    """One rank of ``--ranks``: the run tile-sharded on this rank's
    device."""
    from ..parallel.mesh import make_mesh, rank_device
    args = parse_args(argv)
    dev_type = run_device(args).type
    mesh = make_mesh((world,), ("tile",), backend=backend, device=dev_type)
    quiet = lambda *a, **k: None
    return measure(args, rank_device(rank, dev_type), mesh=mesh,
                   log=note if rank == 0 else quiet)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    device = run_device(args)
    stages = Stages()
    build_kernels(device, stages)
    import torch
    ranks_from = ("--ranks" if args.ranks else
                  "device_count" if device.type == "cuda" else "cpu")
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    line = dict(metric=METRIC, value=None, unit=UNIT)
    if ranks == 1:
        res = measure(args, device, stages=stages)
    else:
        from ..parallel.mesh import spawn
        backend = args.backend or ("nccl" if device.type == "cuda"
                                   else "gloo")
        note("bench", f"spawning {ranks} ranks ({backend})")
        results = spawn(_rank, ranks, (argv, backend), backend=backend,
                        device_type=device.type, timeout=RANKS_TIMEOUT)
        res = results[0]
        res["stages"] = dict(stages, **res["stages"])
        line.update(backend=backend,
                    rank_median_ms=[r["median_ms"] for r in results])
        res["error"] = next((f"rank {i}: {r['error']}"
                             for i, r in enumerate(results) if r["error"]),
                            "")
    error = res.pop("error")
    line.update(res, ms_per_fwd_bwd=res["mean_ms"],
                gaussians=args.gaussians, res=f"{args.width}x{args.height}",
                inner=args.inner, devices=ranks, ranks_from=ranks_from,
                **device_fields(device))
    if error:
        line["error"] = error
    emit(line)
    if error:
        raise SystemExit(f"bench: {error}")
    return line


if __name__ == "__main__":
    main()
