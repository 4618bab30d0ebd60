"""Per-op device time of one forward + backward on the card, from a
profiler trace (the PyTorch port of the JAX package's root
``prof_trace.py``).

    python -m diff_gaussian_rasterization_tpu_torch.examples.prof_trace \\
        [OUTDIR] [--inner 3] [--samples 3] \\
        [--gaussians 100000] [--height 680] [--width 1200] \\
        [--device cuda | --cpu]

One step is ``bench``'s: the loss over four outputs of ``rasterize`` on the
bench scene and its gradient w.r.t. the means and the view.  After one
warm-up step and ``--samples`` host-timed samples of ``--inner`` steps,
``torch.profiler`` records ``--inner`` more steps (the host's and the
card's activity) and writes the Chrome trace to
``OUTDIR/prof_trace.json`` (default: the temporary directory,
``tempfile.gettempdir()``).  From the card's events (the CUDA activity
only: a card whose profile holds none fails the run; the host's events are
never read in their place) it prints the per-op table: device ms and
launches a step by kernel name, the longest first, the top TOP of them,
with the total device time a step,
the idle share of the profiled window, and the port's own kernels by name
and template arguments (``kernels``).  The program's own spans and
counters over the profiled steps (``utils/profiling.py``: on while the
profiler records) follow, a step each (``spans``: calls, host and stream
ms, inclusive and self, by span; the counters).  Then one more step in
CUDA's sync debug mode counts the host's waits on the card
(``host_syncs``) and their ten busiest call sites.  On the CPU the device
numbers and the stream times are null (not measured).

Prints the table on stderr and one JSON line on stdout.
"""

import argparse
import sys
import tempfile
from pathlib import Path

from .bench import (common_args, emit, fwd_bwd, guard, launch_counts, note,
                    sample_ms, scene)
from .prof import device_split, start

TOP = 40  # the table's rows, as the JAX tool prints them


def parse_args(argv=None, inner=3, samples=3):
    ap = argparse.ArgumentParser()
    common_args(ap, gaussians=100_000, samples=samples, inner=inner)
    ap.add_argument("outdir", nargs="?", default=tempfile.gettempdir(),
                    help="the directory of the trace file")
    return ap.parse_args(argv)


def profiled(tool, step, args, device, unit, top):
    """``step`` timed and profiled: ``--samples`` host-clock samples of
    ``--inner`` steps, a profile of ``--inner`` more (its trace written to
    ``OUTDIR/<tool>.json``), the per-op table's ``top`` rows (printed on
    stderr), and the host's waits in one more step; the line's fields."""
    from ..ops.kernels import render
    from ..utils import profiling

    def run():
        for _ in range(args.inner):
            step()

    ms = sample_ms(run, device, args.samples, args.inner)
    trace = Path(args.outdir) / f"{tool}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    render.reset_launches()
    profiling.reset()
    split, events = device_split(run, args.inner, device, trace_path=trace)
    table = span_table(profiling.snapshot(), args.inner)
    profiling.reset()
    launches = launch_counts(args.inner)
    rows, total = profiling.op_table(events, args.inner)
    syncs, sites = profiling.host_syncs(step) if device.type == "cuda" \
        else (None, None)
    if device.type == "cuda":
        note(tool, f"device time {total:.4f} ms a {unit} (idle share "
                   f"{split['idle_share']:.3f} of {split['profiled_ms']:.3f}"
                   f" ms), by kernel:")
        for r in rows[:top]:
            note(tool, f"{r['ms']:9.4f} ms a {unit}  x{r['launches']:<7.1f} "
                       f"{r['name'][:100]}")
        note(tool, f"host waits a {unit}: {syncs}; by call site {sites}")
    note_spans(tool, table, unit)
    return dict(host_ms=sum(ms) / len(ms), samples_ms=ms, **split,
                launches=launches, kernels=profiling.port_kernels(rows),
                ops=rows[:top], spans=table, host_syncs=syncs,
                sync_sites=sites, trace=str(trace))


def span_table(snap, n):
    """The program's records (``profiling.snapshot()``) a step of ``n``:
    ``{"spans": {name: {calls, host_ms, host_self_ms, stream_ms,
    stream_self_ms}}, "counters": {name: value}}``, the longest span
    first; stream times null where not measured."""
    ms = lambda s: None if s is None else 1e3 * s / n
    rows = sorted(snap["spans"].items(), key=lambda kv: -kv[1]["host_s"])
    return dict(
        spans={k: dict(calls=s["calls"] / n, host_ms=ms(s["host_s"]),
                       host_self_ms=ms(s["host_self_s"]),
                       stream_ms=ms(s["stream_s"]),
                       stream_self_ms=ms(s["stream_self_s"]))
               for k, s in rows},
        counters={k: v / n for k, v in sorted(snap["counters"].items())})


def note_spans(tool, table, unit):
    """The span table and the counters on stderr."""
    f = lambda x: "       —" if x is None else f"{x:8.3f}"
    note(tool, f"spans a {unit} (ms: host, host self, stream, stream "
               f"self; calls):")
    for k, s in table["spans"].items():
        note(tool, f"{f(s['host_ms'])} {f(s['host_self_ms'])} "
                   f"{f(s['stream_ms'])} {f(s['stream_self_ms'])}  "
                   f"x{s['calls']:<6.1f} {k}")
    note(tool, f"counters a {unit}: {table['counters']}")


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device, fields = start(args)
    means, kw, cam, cfg = scene(args, device)

    def step():
        return fwd_bwd(means, cam.viewmatrix, cam, cfg, kw)

    first = step()
    note("prof_trace", f"{int(first[1].num_rendered)} instances, budget "
                       f"{cfg.max_instances}; {args.samples} samples of "
                       f"{args.inner} steps, then {args.inner} profiled")
    line = dict(tool="prof_trace", **profiled("prof_trace", step, args,
                                              device, "step", TOP),
                instances=int(first[1].num_rendered),
                max_instances=cfg.max_instances, gaussians=args.gaussians,
                res=f"{args.width}x{args.height}", inner=args.inner,
                samples=args.samples, **fields)
    error = guard(first)
    if error:
        line["error"] = error
    emit(line)
    if error:
        raise SystemExit(f"prof_trace: {error}")
    return line


if __name__ == "__main__":
    main()
